"""Training defaults of the port (the pass-2 and validation settings of
nvdiffrecmc_tpu/config.py, as a plain dict; the command line is not
ported yet).  Every key is one the port reads; make_flags refuses others."""

import copy

DEFAULTS = dict(
    iter=5000,
    batch=1,
    spp=1,
    layers=1,
    train_res=[512, 512],
    display_res=None,
    texture_res=[1024, 1024],
    learning_rate=0.01,
    background='checker',
    loss='logl1',
    n_samples=4,
    bsdf='pbr',
    denoiser='bilateral',
    denoiser_demodulate=True,
    envlight=None,
    data_root='.',
    env_scale=1.0,
    probe_res=256,
    learn_lighting=True,
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
)

REFERENCE_BUDGET = 5000         # the iteration count the schedule assumes
REFERENCE_LR_DECAY = 0.0002     # lr = 10^(-rate * it)


def make_flags(**overrides):
    """DEFAULTS updated with overrides; display_res defaults to train_res;
    lr_decay_rate scaled with 5000 / iter, as the JAX package scales its
    schedules.  Raises on a key that is not in DEFAULTS."""
    unknown = sorted(set(overrides) - set(DEFAULTS))
    if unknown:
        raise KeyError('keys the port does not read: %s' % unknown)
    FLAGS = copy.deepcopy(DEFAULTS)
    FLAGS.update(overrides)
    if FLAGS['display_res'] is None:
        FLAGS['display_res'] = FLAGS['train_res']
    FLAGS['lr_decay_rate'] = REFERENCE_LR_DECAY / (
        max(FLAGS['iter'], 1) / float(REFERENCE_BUDGET))
    return FLAGS
