"""The UV atlas of the pass boundary: the chart-grown unwrapper of the JAX
package (normal-cone chart growing, an orthographic projection per chart,
shelf packing), in the port's copy of its C++ source, csrc/uv_unwrap.cpp.

The library is built with g++ at first use (hostlib.load) into
build/nvdiffrecmc_tpu_torch/libuv_unwrap.so and loaded with ctypes.
Where it cannot be built or the unwrap fails, `uv_unwrap` raises: the
JAX package's quiet fallback to the per-tet atlas is not carried over."""

import ctypes

import numpy as np

from . import hostlib

_lib = None


def lib():
    """The loaded unwrapper (built first when missing or stale)."""
    global _lib
    if _lib is None:
        handle = hostlib.load('uv_unwrap.cpp', 'libuv_unwrap.so')
        P = ctypes.POINTER
        handle.uv_unwrap.restype = ctypes.c_int
        handle.uv_unwrap.argtypes = [
            P(ctypes.c_float), ctypes.c_int, P(ctypes.c_int), ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_float, P(ctypes.c_float),
            P(ctypes.c_int), P(ctypes.c_int)]
        _lib = handle
    return _lib


def uv_unwrap(v_pos, t_pos_idx, cone_cos=0.5, max_faces=10000,
              gutter=0.004):
    """v_pos [V, 3], t_pos_idx [T, 3] (numpy-convertible).  Returns (uvs
    [Vn, 2] float32, t_tex_idx [T, 3] int32), numpy; vertices are split
    per chart, so seams lie only at chart boundaries."""
    v = np.ascontiguousarray(v_pos, np.float32)
    t = np.ascontiguousarray(t_pos_idx, np.int32)
    T = t.shape[0]
    out_uv = np.empty((3 * T, 2), np.float32)
    out_tidx = np.empty((T, 3), np.int32)
    out_n = ctypes.c_int(0)

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))
    rc = lib().uv_unwrap(ptr(v, ctypes.c_float), v.shape[0],
                         ptr(t, ctypes.c_int), T, ctypes.c_float(cone_cos),
                         int(max_faces), ctypes.c_float(gutter),
                         ptr(out_uv, ctypes.c_float),
                         ptr(out_tidx, ctypes.c_int), ctypes.byref(out_n))
    if rc != 0:
        raise RuntimeError('uv_unwrap failed (code %d) on %d vertices, %d '
                           'triangles' % (rc, v.shape[0], T))
    return out_uv[:out_n.value].copy(), out_tidx
