"""Where the port's entry points put their tensors: on the card unless the
caller asks for another device.  There is no quiet fallback to the CPU."""

import torch


def resolve(device=None):
    """`device` as a torch.device; None means the CUDA card, and raises when
    there is none (pass device='cpu' to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device('cuda')
