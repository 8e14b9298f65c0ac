"""The port's bench, pass-1 keys, on the CPU at a tiny size: bench_pass1
(DMTetGeometry at grid 8, 16x16, 1 timed step after a warm-up, the plain
versions of the kernels) from the random init and from the sphere gives a
finite, positive rate for each, and the JSON line's pass-1 keys exist.  It
times nothing that is reported: the rates are measured on the card."""

import math

from nvdiffrecmc_tpu_torch import bench


def test_bench_pass1_keys_on_the_cpu():
    extra = bench.pass1_extra(iters=1, res=16, grid=8, device='cpu')
    for k in ('pass1_dmtet_hashgrid_iters_per_sec',
              'pass1_annealed_iters_per_sec', 'pass1_note'):
        assert k in extra, k
    for k in ('pass1_dmtet_hashgrid_iters_per_sec',
              'pass1_annealed_iters_per_sec'):
        assert math.isfinite(extra[k]) and extra[k] > 0, (k, extra[k])
    # the sphere's surface is a closed shell, the random init's a foam
    assert 0 < extra['pass1_annealed_init_surface_triangles'] \
        < extra['pass1_init_surface_triangles']
