"""Build and load the hand-written CUDA kernels of the port (their launch
counts are tracing.LAUNCHES, here as LAUNCHES).

The sources under ``csrc/`` have a plain C interface (one ``extern "C"``
entry per kernel, returning the ``cudaError_t`` of its launch) and are
compiled by ``nvcc`` for ``sm_90a`` into one shared library, loaded with
``ctypes``.  The library is built at first use and rebuilt whenever a source
is newer than it, into ``build/nvdiffrecmc_tpu_torch/`` beside the package.

Nothing here runs at import time: importing the port on a machine without
``nvcc`` or a GPU is always safe; only a launch on a CUDA tensor builds.
"""

import ctypes
import glob
import os
import shutil
import subprocess
import time

# Launches per kernel: the registry lives in tracing; each wrapper adds one
# to kernels.LAUNCHES (the same dict) where it launches its kernel.
from .tracing import LAUNCHES, reset_launches  # noqa: F401

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'nvdiffrecmc_tpu_torch')
LIB_PATH = os.path.join(BUILD_DIR, 'libkernels.so')

# --fmad=false: no multiply-add contraction, so each kernel rounds exactly
# like its plain PyTorch version, whose elementwise ops are never fused.
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-Xcompiler', '-fPIC']

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# argtypes of each C entry point (every pointer and the stream are void*)
_SIGNATURES = {
    'nvk_resolve': [_VP] * 11 + [_I, _I, _I, _I, _I, _VP],
    'nvk_sample_guide': [_VP, _VP, _VP, _I, _I, _VP],
    'nvk_sample': [_VP] * 8 + [_I] * 6 + [_VP],
    'nvk_sample_info': [_I, _VP],
    'nvk_trace_shade': [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                        _VP, _I, _I, _I, _I, _I, _I, _I, _F, _VP],
    'nvk_denoise': [_VP, _VP, _VP, _VP, _I, _I, _I, _F, _I, _VP],
    'nvk_denoise_one': [_VP, _VP, _VP, _VP, _I, _I, _I, _F, _I, _VP],
    'nvk_shade_bwd': [_VP] * 6 + [_I] * 3 + [_F, _VP],
    'nvk_shade_bwd_info': [_VP],
    'nvk_light_scatter': [_VP, _VP, _I, _I, _I, _VP],
    'nvk_scatter_add': [_VP, _VP, _VP, _LL, _I, _LL, _I, _VP],
    'nvk_trace': [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                  _I, _I, _I, _F, _VP],
    'nvk_mask': [_VP, _VP, _VP, _VP, _I, _I, _I, _F, _F, _VP],
    'nvk_mask_info': [_VP],
}

_lib = None


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or PATH); the CUDA '
                           'kernels of nvdiffrecmc_tpu_torch cannot be built')
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu')))


def _stale():
    if not os.path.exists(LIB_PATH):
        return True
    newest = max(os.path.getmtime(p) for p in
                 _sources() + glob.glob(os.path.join(CSRC_DIR, '*.cuh')))
    return newest > os.path.getmtime(LIB_PATH)


def build(verbose=False):
    """Compile every csrc/*.cu (in parallel) and link libkernels.so when the
    library is missing or older than a source.  Returns the seconds spent
    (0.0 when the library was current)."""
    if not _stale():
        return 0.0
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ['-Xptxas', '-v'] if verbose else []
    procs = []
    objs = []
    for src in _sources():
        # per-process object names: concurrent builds never share a file
        obj = os.path.join(BUILD_DIR, '%s.%d.o' % (os.path.basename(src)[:-3],
                                                   os.getpid()))
        objs.append(obj)
        cmd = [nvcc] + NVCC_FLAGS + extra + ['-I', CSRC_DIR, '-c', src,
                                             '-o', obj]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT)))
    failed = []
    for src, p in procs:
        out = p.communicate()[0].decode(errors='replace')
        if verbose and out:
            print(out, flush=True)
        if p.returncode != 0:
            failed.append('%s:\n%s' % (src, out))
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    tmp = LIB_PATH + '.tmp%d' % os.getpid()
    subprocess.run([nvcc, '-shared'] + NVCC_FLAGS[:2] + ['-o', tmp] + objs,
                   check=True)
    os.replace(tmp, LIB_PATH)
    for obj in objs:
        os.remove(obj)
    return time.perf_counter() - t0


def lib():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        build()
        handle = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.nvk_error_string.argtypes = [ctypes.c_int]
        handle.nvk_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(rc, name):
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        msg = lib().nvk_error_string(rc).decode(errors='replace')
        raise RuntimeError('%s: CUDA error %d (%s)' % (name, rc, msg))


def occupancy(entry, *args):
    """Registers and local (spill) bytes per thread, blocks per SM and
    shared bytes per block of a kernel, from its C entry `entry` (an
    nvk_*_info taking args and an int[4])."""
    info = (ctypes.c_int * 4)()
    check(getattr(lib(), entry)(*args, info), entry)
    return dict(regs=info[0], local_bytes=info[1], blocks_per_sm=info[2],
                smem_bytes=info[3])


def stream_ptr(t):
    """Raw handle of PyTorch's current stream on t's device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name, dtype, shape=None, device=None):
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, contiguity."""
    import torch
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError('%s must be a CUDA tensor' % name)
    if device is not None and t.device != device:
        raise ValueError('%s is on %s, expected %s' % (name, t.device, device))
    if t.dtype != dtype:
        raise ValueError('%s must be %s, got %s' % (name, dtype, t.dtype))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError('%s must have shape %s, got %s'
                         % (name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError('%s must be contiguous' % name)
    return t
