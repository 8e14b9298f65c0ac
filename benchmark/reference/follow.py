"""The plain reference follows a cell's first steps: step.Reference (the
reference's own step over the frozen plain renderer of port_plain/),
from the same inputs and seeds as the program, in float32 with TF32 off.
With tf32 it is the control: the same reference with its matrix
products in TF32, the precision a later change would be tempted to take
(on the CPU, which has no TF32, each product's operands are rounded to
TF32's 10 mantissa bits)."""

import contextlib
import importlib

import torch
from torch.overrides import TorchFunctionMode

from reference import step

SUBMODULES = ('config', 'train', 'geometry', 'dataset', 'dataset.dataset_mesh',
              'ops.envshade', 'ops.bvh', 'ops.tracer')
PLAIN_SUBMODULES = ('config', 'dataset', 'dataset.dataset_mesh',
                    'ops.envshade', 'ops.bvh', 'ops.tracer', 'render.light',
                    'render.render', 'render.texture')


def load(name, submodules=SUBMODULES):
    """The package `name` with the submodules the harness reads."""
    pkg = importlib.import_module(name)
    for sub in submodules:
        importlib.import_module(name + '.' + sub)
    return pkg


def plain():
    """The frozen plain copy: the renderer, the kernels' plain twins, the
    datasets and the configuration's defaults."""
    return load('reference.port_plain', PLAIN_SUBMODULES)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, nearest even)."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


_PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.Tensor.matmul,
             torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.nn.functional.linear, torch.einsum}


class _TF32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _PRODUCTS:
            args = tuple(_tf32(a) for a in args)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def precision(device, tf32):
    """TF32 off (the reference) or on (the control) for matrix products."""
    dev = torch.device(device)
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    mode = _TF32Products() if tf32 and dev.type == 'cpu' else \
        contextlib.nullcontext()
    try:
        with mode:
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def follow(spec, seed, device, steps, overrides=None, tf32=False,
           fault=None):
    """The reference's readings (Reference.first_steps) over `steps`
    steps; fault: one of step.FAULTS planted in its step, or None."""
    with precision(device, tf32):
        ref = step.Reference(plain(), spec, seed, device, overrides, fault)
        return ref.first_steps(steps)
