"""What the benchmark loads: neither JAX nor the JAX package anywhere,
and nothing of the program in the reference, top-level names compared
whole."""

import os
import subprocess
import sys

from harness import cell

CHECK = '''
import sys
sys.path[:0] = [%r, %r]
%s
names = sorted({m.split('.')[0] for m in sys.modules})
print(' '.join(names))
'''


def _top_names(code):
    bench = os.path.join(cell.ROOT, 'benchmark')
    out = subprocess.run([sys.executable, '-c', CHECK % (bench, cell.ROOT,
                                                         code)],
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_reference_and_metrics_load_no_jax():
    metrics = sorted(f[:-3] for f in os.listdir(
        os.path.join(cell.ROOT, 'benchmark', 'metrics'))
        if f.endswith('.py') and f != '__init__.py')
    code = ('import run, control\nfrom reference import follow\n'
            'follow.load("nvdiffrecmc_tpu_torch")\nfollow.plain()\n'
            + ''.join('import metrics.%s\n' % m for m in metrics))
    names = _top_names(code)
    assert not names & {'jax', 'jaxlib', 'flax', 'nvdiffrecmc_tpu'}
    assert 'nvdiffrecmc_tpu_torch' in names


def test_reference_loads_nothing_of_the_program():
    code = ('from reference import follow\nfollow.plain()\n'
            'import reference.port_plain.render.texture\n'
            'import reference.port_plain.ops.pallas_raster\n')
    names = _top_names(code)
    assert 'nvdiffrecmc_tpu_torch' not in names
    assert not names & {'jax', 'jaxlib', 'flax', 'nvdiffrecmc_tpu'}


def test_forbidden_names_compared_whole():
    import run
    sys.modules.setdefault('nvdiffrecmc_tpu_torch_x', sys)
    try:
        assert 'nvdiffrecmc_tpu_torch_x' not in run.forbidden_modules()
    finally:
        del sys.modules['nvdiffrecmc_tpu_torch_x']
