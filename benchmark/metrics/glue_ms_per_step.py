"""Device milliseconds a step in kernels that are not the port's own
(PyTorch's ATen kernels: autograd, gathers, scatters, Adam and the rest
of the glue).  The port's kernels are the __global__ functions of
nvdiffrecmc_tpu_torch/csrc at commit 33f28f5, listed here; a name is
matched on its identifier, without return type, template arguments or
parameters."""

import re

PORT_KERNELS = frozenset((
    'raster_kernel', 'setup_kernel', 'unpack_kernel',        # resolve.cu
    'guide_kernel', 'sample_kernel',                          # sample.cu
    'shade_trace_kernel', 'shade_kernel',                     # shade.cu
    'shade_bwd_kernel', 'light_scatter_kernel',
    'denoise_kernel', 'scatter_add_kernel', 'scatter_add_c2',
    'scatter_add_generic', 'trace_kernel', 'mask_kernel'))


def base_name(name):
    m = re.match(r'^(?:void\s+)?([A-Za-z_][A-Za-z0-9_:]*)', name)
    return m.group(1).split('::')[-1] if m else name


def read(ctx):
    us = sum(t - s for n, s, t in ctx['trace']['kernels']
             if base_name(n) not in PORT_KERNELS)
    return us / 1e3 / ctx['steps']
