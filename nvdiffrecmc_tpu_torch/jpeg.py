"""The port's JPEG decoder: the counterpart of the imageio.v2.imread calls
through which the JAX package reads 8-bit JPEG images (textures, NeRF
frames, LLFF images and masks).  The card's machine has neither imageio
nor PIL, so the port decodes with its own C++ source,
csrc/jpeg_decode.cpp, built with g++ at first use (hostlib.load) into
build/nvdiffrecmc_tpu_torch/libjpeg_decode.so and loaded with ctypes.

It reads baseline sequential Huffman-coded JPEG: 8-bit, 1 or 3
components, sampling factors of 1 or 2 on each axis (4:4:4, 4:2:2, 4:2:0,
4:4:0), restart intervals, tables in any order before each scan.  It
computes as libjpeg(-turbo)'s defaults do (the islow integer IDCT, fancy
chroma upsampling, the integer YCbCr -> RGB tables), so it gives
imageio's pixels; like imageio it ignores EXIF orientation.  Anything
else (progressive, arithmetic-coded, lossless, 12-bit, CMYK, truncated or
corrupt data) raises ValueError naming the file: there is no fallback to
another decoder.  The images are decoded once at start-up on the host, as
the JAX package decodes them."""

import ctypes

import numpy as np

from . import hostlib

_lib = None


def lib():
    """The loaded decoder (built first when missing or stale)."""
    global _lib
    if _lib is None:
        handle = hostlib.load('jpeg_decode.cpp', 'libjpeg_decode.so')
        P = ctypes.POINTER
        handle.jpeg_info.restype = ctypes.c_int
        handle.jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_long, P(ctypes.c_int), P(ctypes.c_int),
            P(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        handle.jpeg_decode.restype = ctypes.c_int
        handle.jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_int]
        _lib = handle
    return _lib


def decode_jpeg(data, name='<bytes>'):
    """JPEG bytes as uint8 [H, W, C]: C = 1 for a grayscale file, 3 (RGB)
    otherwise.  Raises ValueError naming `name` on any file it does not
    read."""
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    handle = lib()
    if handle.jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c), err, len(err)) == 0:
        out = np.empty((h.value, w.value, c.value), np.uint8)
        if handle.jpeg_decode(data, len(data), out.ctypes.data, out.size,
                              err, len(err)) == 0:
            return out
    raise ValueError('%s: %s' % (name, err.value.decode(errors='replace')))
