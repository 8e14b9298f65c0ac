"""BENCHMARK.json against the contract's form, and every file a cell, a
configuration or a metric names found by its name."""

import importlib
import json
import os
import re

import pytest

from harness import cell, numbers

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')

with open(os.path.join(cell.ROOT, 'BENCHMARK.json')) as f:
    BENCH = json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_keys_and_limits():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert isinstance(BENCH['run_seconds'], int)
    assert 1 <= len(BENCH['paths']) <= 16
    assert all(PATH.match(p) and not p.startswith('/') and '..' not in p
               for p in BENCH['paths'])
    assert len(BENCH['command']) <= 32 and all(_line(w)
                                               for w in BENCH['command'])
    assert os.path.getsize(os.path.join(cell.ROOT, 'BENCHMARK.json')) \
        <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH['run_seconds'] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        ns = [x['name'] for x in BENCH[k]]
        assert len(ns) == len(set(ns))
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert _line(c['source']) and _line(c['why'])
        assert len(c['reduced']) <= 16 and all(NAME.match(k)
                                               for k in c['reduced'])
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and _line(w['why'])
        assert NAME.match(w['traffic'])
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert _line(m['layer'])


@pytest.mark.parametrize('w', [w['name'] for w in BENCH['workloads']])
def test_cell_files_found_by_name(w):
    spec = cell.load_spec(w, BENCH)
    assert (spec['traffic']['path'], spec['traffic']['targets']) in \
        cell.PATHS
    conf = {c['name']: c for c in BENCH['configs']}[spec['cell']['config']]
    assert conf['file'].startswith('benchmark/')
    assert spec['config']['name'] == conf['name']
    assert sorted(spec['config']['reduced']) == sorted(conf['reduced'])
    assert spec['limits'] and set(spec['limits']) <= set(numbers.NAMES)


def _reported(metric, w):
    return metric.get('workloads') is None or w in metric['workloads']


@pytest.mark.parametrize('m', [m['name'] for m in BENCH['per_layer']])
def test_metric_module_and_moves(m):
    metric = {x['name']: x for x in BENCH['per_layer']}[m]
    assert callable(importlib.import_module('metrics.' + m).read)
    moves = {x['name']: x for x in BENCH['end_to_end']}[metric['moves']]
    for w in BENCH['workloads']:
        if _reported(metric, w['name']):
            assert _reported(moves, w['name'])


def test_every_cell_reports_enough():
    for w in BENCH['workloads']:
        e2e = [m['name'] for m in BENCH['end_to_end']
               if _reported(m, w['name'])]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert any(_reported(m, w['name']) for m in BENCH['per_layer'])
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
