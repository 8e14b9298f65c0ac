"""Host-side C++ libraries of the port (the uv unwrapper, the JPEG
decoder): each source under csrc/ is built with `g++ -O2 -shared -fPIC`
at first use, and again whenever the source is newer, into the build
directory beside the package, and loaded with ctypes.  A failed build
raises with g++'s stderr."""

import ctypes
import os
import subprocess

from .kernels import BUILD_DIR, CSRC_DIR


def load(source, lib_name):
    """ctypes.CDLL of csrc/<source>, built into BUILD_DIR/<lib_name>
    when missing or older than the source."""
    src = os.path.join(CSRC_DIR, source)
    path = os.path.join(BUILD_DIR, lib_name)
    if (not os.path.exists(path)
            or os.path.getmtime(path) < os.path.getmtime(src)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = path + '.tmp%d' % os.getpid()
        proc = subprocess.run(['g++', '-O2', '-shared', '-fPIC', '-o', tmp,
                               src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('g++ failed to build %s:\n%s'
                               % (src, proc.stderr))
        os.replace(tmp, path)
    return ctypes.CDLL(path)
