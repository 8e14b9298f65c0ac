"""nvdiffrecmc_tpu_torch: the PyTorch + CUDA port of nvdiffrecmc_tpu.

Same subpackages, modules and function names as the JAX package
(nvdiffrecmc_tpu/), which stays the reference.  Plain tensor code is
PyTorch; every Pallas kernel of the JAX package on the ported path is a
hand-written CUDA kernel for Hopper (csrc/, built by kernels.py) with a
plain PyTorch version beside it, used for CPU tensors and as the kernel's
reference on the card."""

__version__ = "0.1.0"
