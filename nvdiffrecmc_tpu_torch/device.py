"""Where the port's entry points put their tensors: on the card unless the
caller asks for another device.  There is no quiet fallback to the CPU.

Host data reach the card without blocking the host: `upload` copies them
asynchronously from pinned memory, and `constant` makes a constant table
once and keeps it.  (`torch.tensor(..., device='cuda')` and
`torch.as_tensor(array, device='cuda')` copy from pageable memory and
then wait for the stream, so the host stops until the card has run
everything queued before them.)"""

import numpy as np
import torch

_CONSTANTS = {}     # (shape, numpy dtype, bytes, dtype, device) -> tensor


def resolve(device=None):
    """`device` as a torch.device; None means the CUDA card, and raises when
    there is none (pass device='cpu' to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device('cuda')


def upload(data, device, dtype=None):
    """`torch.as_tensor(data, dtype=dtype, device=device)` without a wait
    for host data (an array, numbers, nested lists, a CPU tensor): to a
    CUDA device they are copied into pinned memory and go up by an
    asynchronous copy on the current stream (PyTorch's caching host
    allocator keeps the pinned block until that copy has run).  To any
    other device, and for a tensor already on the card, it is
    `torch.as_tensor`."""
    device = torch.device(device)
    if device.type != 'cuda' or torch.is_tensor(data) and data.is_cuda:
        return torch.as_tensor(data, dtype=dtype, device=device)
    return torch.as_tensor(data, dtype=dtype).pin_memory().to(
        device, non_blocking=True)


def constant(values, dtype, device):
    """The tensor of `values` (numbers, nested lists or an array) as
    `dtype` on `device`: uploaded on the first call with these values,
    dtype and device, the same tensor on every later call.  Callers only
    read it (views and `expand` included), never write to it."""
    a = np.array(values)
    device = torch.device(device)
    key = (a.shape, a.dtype.str, a.tobytes(), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = upload(a, device, dtype)
    return t
