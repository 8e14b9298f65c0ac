"""Flags of the port: the command line and JSON configs of
nvdiffrecmc_tpu/config.py, as a plain dict.  Every key of DEFAULTS is one
the port reads; the keys of UNREAD (the reference configs'
random_textures, the TPU BVH's leaf_size) are accepted and ignored; any
other key is refused."""

import argparse
import copy
import json
import os
import sys

DEFAULTS = dict(
    iter=5000,
    batch=1,
    spp=1,
    layers=1,
    train_res=[512, 512],
    display_res=None,
    texture_res=[1024, 1024],
    display_interval=0,
    save_interval=1000,
    learning_rate=0.01,
    custom_mip=False,
    background='checker',
    loss='logl1',
    out_dir=None,
    out_root='out',
    config=None,
    ref_mesh=None,
    base_mesh=None,
    validate=True,
    n_samples=4,
    bsdf='pbr',
    denoiser='bilateral',
    denoiser_demodulate=True,
    mtl_override=None,
    envlight=None,
    data_root='.',
    env_scale=1.0,
    probe_res=256,
    learn_lighting=True,
    display=None,
    transparency=False,
    lock_light=False,
    lock_pos=False,
    laplace='relative',
    laplace_scale=3000.0,
    no_perturbed_nrm=False,
    decorrelated=False,
    kd_min=[0.0, 0.0, 0.0, 0.0],
    kd_max=[1.0, 1.0, 1.0, 1.0],
    ks_min=[0.0, 0.08, 0.0],
    ks_max=[0.0, 1.0, 1.0],
    nrm_min=[-1.0, -1.0, 0.0],
    nrm_max=[1.0, 1.0, 1.0],
    clip_max_norm=0.0,
    cam_near_far=[0.1, 1000.0],
    lambda_kd=0.1,
    lambda_ks=0.05,
    lambda_nrm=0.025,
    lambda_nrm2=0.25,
    lambda_chroma=0.0,
    lambda_diffuse=0.15,
    lambda_specular=0.0025,
    resume=True,
    checkpoint_interval=0,
    # scale the lr decay (and pass 1's shadow ramp) with iter / 5000, as
    # the JAX package does; at iter 5000 the reference's constants
    scale_schedules=True,
    # split each step into batch / micro_batch slices whose gradients are
    # averaged (0: one slice), which bounds the step's device memory
    micro_batch=0,
    # the NeRF / LLFF datasets decode every image once, at start-up
    pre_load=True,
    # pass 1 (DMTet + hash-grid material): the JAX package's values
    dmtet_grid=64,
    mesh_scale=2.1,
    sdf_regularizer=0.2,
    max_tris=None,          # None: 24 * dmtet_grid^2 triangle slots
    sdf_init='random',      # or 'sphere'
    # at the pass boundary, drop connected components with fewer than
    # this fraction of the faces (0: keep all)
    prune_components=0.01,
)

# read by nothing
UNREAD = frozenset(('random_textures', 'leaf_size'))

REFERENCE_BUDGET = 5000         # the iteration count the schedules assume
REFERENCE_SHADOW_RAMP = 1750.0
REFERENCE_LR_DECAY = 0.0002     # lr = 10^(-rate * it)


def strtobool(s):
    """Strict bool for command-line flags: the usual spellings, anything
    else refused (so `--resume 0` turns resume off)."""
    v = str(s).strip().lower()
    if v in ('1', 'true', 't', 'yes', 'y', 'on'):
        return True
    if v in ('0', 'false', 'f', 'no', 'n', 'off'):
        return False
    raise argparse.ArgumentTypeError('expected a boolean, got %r' % s)


def _parser():
    p = argparse.ArgumentParser(description='nvdiffrecmc_tpu_torch',
                                allow_abbrev=False)
    p.add_argument('-i', '--iter', type=int, default=5000)
    p.add_argument('-b', '--batch', type=int, default=1)
    p.add_argument('-s', '--spp', type=int, default=1)
    p.add_argument('-l', '--layers', type=int, default=1)
    p.add_argument('-r', '--train-res', nargs=2, type=int, default=[512, 512])
    p.add_argument('-dr', '--display-res', type=int, default=None)
    p.add_argument('-tr', '--texture-res', nargs=2, type=int,
                   default=[1024, 1024])
    p.add_argument('-di', '--display-interval', type=int, default=0)
    p.add_argument('-si', '--save-interval', type=int, default=1000)
    p.add_argument('-lr', '--learning-rate', type=float, default=0.01)
    p.add_argument('-mip', '--custom-mip', action='store_true', default=False)
    p.add_argument('-bg', '--background', default='checker',
                   choices=['black', 'white', 'checker', 'reference'])
    p.add_argument('--loss', default='logl1',
                   choices=['logl1', 'logl2', 'mse', 'smape', 'relativel2',
                            'n2n'])
    p.add_argument('-o', '--out-dir', type=str, default=None)
    p.add_argument('--config', type=str, default=None)
    p.add_argument('-rm', '--ref_mesh', type=str)
    p.add_argument('-bm', '--base-mesh', type=str, default=None)
    p.add_argument('--validate', type=strtobool, default=True)
    p.add_argument('--n_samples', type=int, default=4)
    p.add_argument('--bsdf', type=str, default='pbr',
                   choices=['pbr', 'diffuse', 'white'])
    p.add_argument('--denoiser', default='bilateral',
                   choices=['none', 'bilateral'])
    p.add_argument('--denoiser_demodulate', type=bool, default=True)
    p.add_argument('--data-root', type=str, default=DEFAULTS['data_root'])
    p.add_argument('--micro-batch', type=int, default=0)
    p.add_argument('--checkpoint-interval', type=int, default=0)
    p.add_argument('--resume', type=strtobool, default=True,
                   help='resume from <out_dir>/checkpoint_mesh_pass.pkl when '
                        'present (default on); the checkpoint holds the RNG '
                        'and data-iterator state, so a resumed run continues '
                        'the interrupted one exactly')
    p.add_argument('--scale-schedules', type=strtobool, default=True)
    p.add_argument('--sdf-init', choices=['random', 'sphere'],
                   default='random')
    p.add_argument('--prune-components', type=float, default=0.01)
    return p


def parse_flags(argv=None):
    """The JAX package's parse_flags: argparse, then the --config JSON over
    it, then every flag given explicitly in argv (by its presence, not its
    value) over the config; out_dir joined under out_root.  Raises on keys
    outside DEFAULTS and UNREAD."""
    parser = _parser()
    args = parser.parse_args(argv)
    FLAGS = copy.deepcopy(DEFAULTS)
    FLAGS.update(vars(args))
    if FLAGS['config'] is not None:
        with open(FLAGS['config'], 'r') as f:
            FLAGS.update(json.load(f))
        opt_to_dest = {opt: a.dest for a in parser._actions
                       for opt in a.option_strings}
        argv_eff = sys.argv[1:] if argv is None else argv
        for tok in argv_eff:
            dest = opt_to_dest.get(tok.split('=', 1)[0])
            if dest is not None:
                FLAGS[dest] = getattr(args, dest)
    _refuse_unknown(FLAGS, DEFAULTS.keys() | UNREAD)
    return _derive(FLAGS)


def make_flags(**overrides):
    """DEFAULTS updated with overrides, derived as parse_flags derives
    them.  Raises on a key that is not in DEFAULTS."""
    _refuse_unknown(overrides, DEFAULTS.keys())
    FLAGS = copy.deepcopy(DEFAULTS)
    FLAGS.update(overrides)
    return _derive(FLAGS)


def _refuse_unknown(keys, known):
    unknown = sorted(set(keys) - set(known))
    if unknown:
        raise KeyError('keys the port does not read: %s' % unknown)


def micro_slices(FLAGS):
    """The slices a step's batch is split into: batch / micro_batch when
    micro_batch is set and below batch, else 1.  Raises ValueError when
    such a micro_batch does not divide batch."""
    micro, batch = int(FLAGS.get('micro_batch') or 0), FLAGS['batch']
    if not 0 < micro < batch:
        return 1
    if batch % micro:
        raise ValueError('micro_batch %d does not divide batch %d'
                         % (micro, batch))
    return batch // micro


def _derive(FLAGS):
    micro_slices(FLAGS)
    apply_schedule_scaling(FLAGS)
    if FLAGS['display_res'] is None:
        FLAGS['display_res'] = FLAGS['train_res']
    if FLAGS['out_dir'] is None:
        FLAGS['out_dir'] = os.path.join(FLAGS['out_root'],
                                        'cube_%d' % FLAGS['train_res'][0])
    else:
        FLAGS['out_dir'] = os.path.join(FLAGS['out_root'], FLAGS['out_dir'])
    return FLAGS


def apply_schedule_scaling(FLAGS):
    """shadow_ramp_iters and lr_decay_rate for this budget: with
    scale_schedules both scale with iter / 5000 (a 300-iteration run
    decays its rate as the reference's 5000 do); without, the reference's
    constants."""
    if FLAGS.get('scale_schedules', True):
        s = max(FLAGS['iter'], 1) / float(REFERENCE_BUDGET)
    else:
        s = 1.0
    FLAGS['shadow_ramp_iters'] = REFERENCE_SHADOW_RAMP * s
    FLAGS['lr_decay_rate'] = REFERENCE_LR_DECAY / s
    return FLAGS


def resolve_path(FLAGS, p):
    """A config-relative asset path, resolved against data_root when it
    does not exist as given."""
    if p is None or os.path.isabs(p) or os.path.exists(p):
        return p
    cand = os.path.join(FLAGS['data_root'], p)
    return cand if os.path.exists(cand) else p
