"""The port's pass-2 program against the JAX package's: the flags
(parse_flags on every configs/*.json, CLI over config by presence in argv,
strtobool, the refusals of unknown keys), the batch
order of batch_iterator, and train.main on the CPU at a small size (the
octasphere at 16x16, 32x32 textures, n_samples 2, no probe, no
validation): a run stopped after its checkpoint and resumed equals the
uninterrupted run bit for bit, a truncated checkpoint raises with its
path; without base_mesh, main runs both passes (DMTet grid 8) and a run
stopped in pass 1 and resumed equals the uninterrupted one bit for bit."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from nvdiffrecmc_tpu import config as j_config
from nvdiffrecmc_tpu.dataset import dataset as j_dataset
from nvdiffrecmc_tpu_torch import config, convert, train
from nvdiffrecmc_tpu_torch.dataset import dataset as t_dataset
from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import SPOT256_PROBE
from nvdiffrecmc_tpu_torch.render import obj as t_obj
from nvdiffrecmc_tpu_torch.render import texture as t_texture

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs',
    '*.json')))
# configs whose values the port refuses: none (transparency, which
# nerfactor drums and ficus set, is honoured)
REFUSED = set()


@pytest.fixture(autouse=True)
def _one_thread():
    """Small renders of many PyTorch ops: one intra-op thread keeps the
    parallel test workers off each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _name(path):
    return os.path.splitext(os.path.basename(path))[0]


def _agree(port, jax_flags):
    for k, v in port.items():
        if k != 'data_root':
            assert jax_flags[k] == v, (k, v, jax_flags[k])


@pytest.mark.parametrize('path', CONFIGS, ids=_name)
def test_parse_flags_matches_jax(path):
    """Each reference config with explicit overrides: -i 20, and --validate
    true over the configs that say false; every key the port reads (the
    derived schedule constants among them) as JAX parses it, apart from
    data_root.  The configs the port refuses raise NotImplementedError;
    the nerf_spot_synth configs (micro_batch 1 of batch 8, pre_load) parse
    and split each step into 8 micro-steps."""
    argv = ['--config', path, '-i', '20', '--validate', 'true']
    want = j_config.parse_flags(argv)
    if _name(path) in REFUSED:
        with pytest.raises(NotImplementedError):
            config.parse_flags(argv)
        return
    got = config.parse_flags(argv)
    assert got['iter'] == 20 and got['validate'] is True
    assert set(got) >= set(config.DEFAULTS)
    _agree(got, want)
    if _name(path).startswith('nerf_spot_synth'):
        assert (got['micro_batch'], got['batch'], got['pre_load']) == \
            (1, 8, True)
        assert config.micro_slices(got) == 8


@pytest.mark.parametrize('argv', [
    [], ['-b', '4', '-r', '64', '32', '--resume', 'off', '-o', 'x'],
    ['--config', os.path.join(os.path.dirname(CONFIGS[0]), 'spot.json'),
     '--scale-schedules=false', '--validate=1', '-lr', '0.02']])
def test_parse_flags_cli_matches_jax(argv):
    """Without a config, with flags only, and with flags given as
    --flag=value over a config."""
    _agree(config.parse_flags(argv), j_config.parse_flags(argv))


def test_strtobool_matches_jax():
    for s in ('1', 'true', 'T', ' yes ', 'y', 'On', '0', 'false', 'F', 'no',
              'N', 'off'):
        assert config.strtobool(s) == j_config.strtobool(s)
    for s in ('2', 'maybe', '', 'truee', 'nope'):
        for fn in (config.strtobool, j_config.strtobool):
            with pytest.raises(Exception, match='expected a boolean'):
                fn(s)


# the ids are the cases' names from when decorrelated, denoiser_demodulate
# false and custom_mip raised NotImplementedError
@pytest.mark.parametrize('extra, error', [
    ({'transparency': True}, None),
    ({'decorrelated': True}, None),
    ({'denoiser_demodulate': False}, None),
    ({'batch': 4, 'micro_batch': 3}, ValueError),
    ({'custom_mip': True}, None),
    ({'lock_geometry': True}, KeyError),
], ids=['extra0-None', 'extra1-NotImplementedError',
        'extra2-NotImplementedError', 'extra3-ValueError',
        'extra4-NotImplementedError', 'extra5-KeyError'])
def test_parse_flags_refuses(tmp_path, extra, error):
    """A key the port does not know raises, and so does a micro_batch
    that does not divide batch; transparency, decorrelated, custom_mip and
    denoiser_demodulate false (error None) parse and keep their values;
    the pass-1 keys and random_textures pass, and micro_batch is honoured
    from the config and from the command line."""
    fn = str(tmp_path / 'c.json')
    with open(fn, 'w') as f:
        json.dump(dict({'dmtet_grid': 32, 'sdf_init': 'sphere',
                        'random_textures': True}, **extra), f)
    if error is None:
        got = config.parse_flags(['--config', fn])
        for k, v in extra.items():
            assert got[k] is v, (k, got[k])
    else:
        with pytest.raises(error):
            config.parse_flags(['--config', fn])
    with open(fn, 'w') as f:
        json.dump({'dmtet_grid': 32, 'random_textures': True}, f)
    assert config.parse_flags(['--config', fn])['dmtet_grid'] == 32
    got = config.parse_flags(['--micro-batch', '1', '-b', '4'])
    assert got['micro_batch'] == 1 and config.micro_slices(got) == 4


@pytest.mark.parametrize('batch, micro, slices', [
    (8, 1, 8), (8, 2, 4), (4, 4, 1), (2, 4, 1), (4, 0, 1), (1, 1, 1)])
def test_micro_batch_is_honoured(batch, micro, slices):
    """micro_batch splits a step into batch / micro_batch slices when it is
    set and below batch, as the JAX package's use_micro does; otherwise
    one slice."""
    got = config.make_flags(batch=batch, micro_batch=micro)
    assert got['micro_batch'] == micro
    assert config.micro_slices(got) == slices


class _Indices:
    """A dataset whose batches are their indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i

    def collate(self, batch):
        return list(batch)


@pytest.mark.parametrize('n, batch, shuffle', [(10, 3, True), (12, 4, True),
                                               (7, 2, False)])
def test_batch_iterator_matches_jax(n, batch, shuffle):
    """The first three epochs of batches at seed 0 as JAX's
    batch_iterator gives them, and a copy restored
    from the iterator's state mid-way continues as it does."""
    steps = 3 * (n // batch)
    want = j_dataset.batch_iterator(_Indices(n), batch, shuffle=shuffle)
    it = t_dataset.BatchIterator(_Indices(n), batch, shuffle=shuffle)
    got = [next(it) for _ in range(steps)]
    assert got == [next(want) for _ in range(steps)]
    copy = t_dataset.BatchIterator(_Indices(n), batch, shuffle=shuffle,
                                   seed=5)
    copy.load_state_dict(it.state_dict())
    assert [next(copy) for _ in range(steps)] == \
        [next(it) for _ in range(steps)]


def write_scene(folder):
    """The octasphere of __graft_entry__._make_scene written with the
    port's write_obj twice: ref/ under seeded kd and ks textures, base/
    under a constant kd 0.5 and ks (0, 0.5, 0).  Returns the two OBJ
    paths."""
    m = convert.mesh(ge._make_scene(res=16, n_samples=2)[0], device='cpu')
    rng = np.random.RandomState(3)
    ks = np.stack([np.zeros((32, 32)), np.full((32, 32), 0.5),
                   rng.uniform(0.0, 1.0, (32, 32))], -1)[None]
    mats = {'ref': (rng.uniform(0.1, 0.9, (1, 32, 32, 3)), ks),
            'base': (np.full((1, 32, 32, 3), 0.5),
                     np.tile([0.0, 0.5, 0.0], (1, 32, 32, 1)))}
    paths = []
    for name, (kd, ks) in mats.items():
        m.material = {'bsdf': 'pbr'}
        for k, v in (('kd', kd), ('ks', ks)):
            m.material[k] = t_texture.Texture2D(
                data=torch.as_tensor(v.astype(np.float32)))
        os.makedirs(os.path.join(folder, name))
        t_obj.write_obj(os.path.join(folder, name), m)
        paths.append(os.path.join(folder, name, 'mesh.obj'))
    return paths


def program_argv(folder, out_dir, *extra):
    """A config after configs/spot.json (batch 4 aside) at 16x16, 32x32
    textures, n_samples 2, a 16x16 trainable light, over the scene of
    write_scene."""
    ref, base = write_scene(folder)
    cfg = {'ref_mesh': ref, 'base_mesh': base, 'random_textures': True,
           'envlight': SPOT256_PROBE, 'iter': 4, 'save_interval': 0,
           'texture_res': [32, 32], 'train_res': [16, 16], 'batch': 2,
           'learning_rate': [0.03, 0.01], 'ks_min': [0, 0.1, 0.0],
           'ks_max': [0, 1.0, 1.0], 'validate': False, 'lock_pos': True,
           'display': [{'latlong': True}], 'background': 'white',
           'denoiser': 'bilateral', 'n_samples': 2, 'probe_res': 16,
           'out_root': folder, 'out_dir': out_dir}
    fn = os.path.join(folder, 'config.json')
    with open(fn, 'w') as f:
        json.dump(cfg, f)
    return ['--config', fn] + list(extra)


class _Stop(Exception):
    pass


def test_main_resume_is_bitwise(tmp_path, monkeypatch):
    """4 iterations with a checkpoint every 2, and the same run stopped
    right after its checkpoint at iteration 2 then resumed (iteration 3
    only): every trained parameter equal bit for bit."""
    whole = train.main(program_argv(str(tmp_path / 'a'), 'run',
                                    '--checkpoint-interval', '2'),
                       device='cpu')
    argv = program_argv(str(tmp_path / 'b'), 'run',
                        '--checkpoint-interval', '2')
    save = train.save_checkpoint

    def save_then_stop(path, it, **state):
        save(path, it, **state)
        raise _Stop(it)
    monkeypatch.setattr(train, 'save_checkpoint', save_then_stop)
    with pytest.raises(_Stop):
        train.main(argv, device='cpu')
    monkeypatch.setattr(train, 'save_checkpoint', save)
    resumed = train.main(argv, device='cpu')
    for group in ('geo', 'mat'):
        for k, v in whole[group].items():
            assert torch.equal(v, resumed[group][k]), (group, k)
    assert torch.equal(whole['light'], resumed['light'])
    assert not torch.equal(whole['mat']['kd'],
                           torch.full_like(whole['mat']['kd'], 0.5))


def test_main_truncated_checkpoint_raises(tmp_path):
    """A checkpoint that is present but unreadable stops the run with its
    path, instead of starting afresh."""
    argv = program_argv(str(tmp_path), 'run')
    path = os.path.join(str(tmp_path), 'run', 'checkpoint_mesh_pass.pkl')
    os.makedirs(os.path.dirname(path))
    torch.save({'iteration': 3, 'params': torch.zeros(1000)}, path)
    with open(path, 'rb') as f:
        head = f.read()[:300]
    with open(path, 'wb') as f:
        f.write(head)
    with pytest.raises(RuntimeError, match='checkpoint_mesh_pass.pkl'):
        train.main(argv, device='cpu')


def _two_pass_argv(folder, *extra):
    """program_argv without base_mesh: pass 1 on the DMTet grid 8 (24 x 8^2
    triangle slots) with the default hash grid, then pass 2 on the baked
    mesh."""
    argv = program_argv(folder, 'run', *extra)
    with open(argv[1]) as f:
        cfg = json.load(f)
    del cfg['base_mesh']
    cfg.update(dmtet_grid=8, sdf_init='sphere')
    with open(argv[1], 'w') as f:
        json.dump(cfg, f)
    return argv


def test_main_without_base_mesh_refuses_pass_1(tmp_path):
    """main without base_mesh no longer refuses pass 1: it runs pass 1
    (DMTet and the neural material), the pass boundary and pass 2 on the
    baked mesh, and writes dmtet_mesh/ and mesh/, each an OBJ with its MTL,
    three textures and the probe; pass 2's mesh is the baked one (lock_pos)
    and its textures are the bake's, trained further."""
    params = train.main(_two_pass_argv(str(tmp_path)), device='cpu')
    out = os.path.join(str(tmp_path), 'run')
    for d in ('dmtet_mesh', 'mesh'):
        assert sorted(os.listdir(os.path.join(out, d))) == [
            'mesh.mtl', 'mesh.obj', 'probe.hdr', 'texture_kd.png',
            'texture_ks.png', 'texture_n.png'], d
    baked = t_obj.load_obj(os.path.join(out, 'dmtet_mesh', 'mesh.obj'),
                           device='cpu')
    final = t_obj.load_obj(os.path.join(out, 'mesh', 'mesh.obj'),
                           device='cpu')
    assert baked.t_pos_idx.shape[0] > 0
    assert torch.equal(baked.t_pos_idx, final.t_pos_idx)
    assert torch.equal(params['geo']['v_pos'], torch.as_tensor(
        baked.v_pos))
    assert set(params['mat']) == {'kd', 'ks', 'normal'}
    assert sorted(f for f in os.listdir(out) if f.endswith('.pkl')) == []


def test_main_two_pass_resume_is_bitwise(tmp_path, monkeypatch):
    """Both passes with a checkpoint every 2 iterations, and the same run
    stopped right after pass 1's checkpoint at iteration 2 then resumed
    (pass 1 from iteration 3, then the boundary and pass 2): pass 2's
    parameters and the baked OBJ equal bit for bit."""
    whole = train.main(_two_pass_argv(str(tmp_path / 'a'),
                                      '--checkpoint-interval', '2'),
                       device='cpu')
    argv = _two_pass_argv(str(tmp_path / 'b'), '--checkpoint-interval', '2')
    save = train.save_checkpoint

    def save_then_stop(path, it, **state):
        save(path, it, **state)
        if 'dmtet_pass1' in path:
            raise _Stop(it)
    monkeypatch.setattr(train, 'save_checkpoint', save_then_stop)
    with pytest.raises(_Stop):
        train.main(argv, device='cpu')
    monkeypatch.setattr(train, 'save_checkpoint', save)
    resumed = train.main(argv, device='cpu')
    for group in ('geo', 'mat'):
        for k, v in whole[group].items():
            assert torch.equal(v, resumed[group][k]), (group, k)
    assert torch.equal(whole['light'], resumed['light'])
    objs = [open(os.path.join(str(tmp_path / d), 'run', 'dmtet_mesh',
                              'mesh.obj')).read() for d in 'ab']
    assert objs[0] == objs[1]
    ckpt = torch.load(os.path.join(str(tmp_path / 'b'), 'run',
                                   'checkpoint_dmtet_pass1.pkl'),
                      weights_only=True)
    assert set(ckpt['params']['geo']) == {'sdf', 'deform'}
    assert set(ckpt['params']['mat']) == {'table', 'w0', 'w1', 'w2'}


@pytest.mark.parametrize('lr, want', [
    (0.01, (0.01, 0.01, 0.03)),
    ([0.03, 0.01], (0.03, 0.03, 0.09)),
    ([[0.02, 0.005], 0.5], (0.02, 0.005, 0.015)),
    ([[0.02, 0.005, 0.1], 0.5], (0.02, 0.005, 0.1))])
def test_make_optimizers_rates_and_warmup(lr, want):
    """The base rates of optimize_mesh (train.py:418-425): a list holds
    one entry per pass (pass 0 here), an entry is a number or [pos, mat(,
    light)], the light's 3x the material's by default; and the schedule of
    train.py:432-437: a linear warm-up over warmup_iter steps, then
    10^(-(count - warmup_iter) * lr_decay_rate)."""
    m = convert.mesh(ge._make_scene(res=16, n_samples=2)[0], device='cpu')
    FLAGS = config.make_flags(learning_rate=lr, iter=500)
    params = {'geo': {'v_pos': m.v_pos.clone().requires_grad_()},
              'mat': {'kd': torch.zeros(1, 4, 4, 3, requires_grad=True)},
              'light': torch.zeros(4, 4, 3, requires_grad=True)}
    opts = train.make_optimizers(params, FLAGS, warmup_iter=4)
    for name, base in zip(('geo', 'mat', 'light'), want):
        opt, sched = opts[name]
        lrs = []
        for _ in range(7):
            lrs.append(opt.param_groups[0]['lr'])
            opt.step()
            sched.step()
        rate = FLAGS['lr_decay_rate']
        np.testing.assert_allclose(
            lrs, [base * c / 4 for c in range(4)]
            + [base * 10.0 ** (-c * rate) for c in range(3)], rtol=1e-12)
