"""The plain reference follows a cell's first steps: step.Reference (the
reference's own step over the frozen plain renderer of port_plain/),
from the same inputs and seeds as the program, in float32 with TF32 off.
With tf32 it is the control: the same reference with its matrix
products in TF32, the precision a later change would be tempted to take.
On every device each product's operands are rounded to TF32's 10
mantissa bits, and the gradient that reaches its output too, so that the
products of the backward round as well: the CPU has no TF32, and on the
card cuBLAS may leave a small product (the transforms' K = 4, the MLP's
K = 32) in float32 even with TF32 allowed."""

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


def _round(x):
    """x rounded to TF32 (10 mantissa bits, nearest even)."""
    b = x.detach().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _Operand(torch.autograd.Function):
    """An operand rounded to TF32; its gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """A product's output as it is; the gradient reaching it rounded to
    TF32, the operand of the backward's products."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


def _float32(x):
    return torch.is_tensor(x) and x.dtype == torch.float32


def _tf32(x):
    """x rounded to TF32 where it is a float32 tensor, differentiably."""
    return _Operand.apply(x) if _float32(x) else x


_PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.Tensor.matmul,
             torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.nn.functional.linear, torch.einsum}


class _TF32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func not in _PRODUCTS:
            return func(*args, **(kwargs or {}))
        y = func(*(_tf32(a) for a in args), **(kwargs or {}))
        return _Output.apply(y) if _float32(y) and y.requires_grad else y


@contextlib.contextmanager
def precision(tf32):
    """TF32 off (the reference) or on (the control) for matrix products,
    whatever the device."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    mode = _TF32Products() if tf32 else contextlib.nullcontext()
    try:
        with mode:
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def follow(spec, seed, device, steps, overrides=None, tf32=False,
           fault=None):
    """The reference's readings (Reference.first_steps) over `steps`
    steps; fault: one of step.faults(path) planted in its step, or
    None."""
    with precision(tf32):
        ref = step.Reference(plain(), spec, seed, device, overrides, fault)
        return ref.first_steps(steps)
