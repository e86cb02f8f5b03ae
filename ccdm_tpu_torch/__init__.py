"""ccdm_tpu_torch — the PyTorch/CUDA port of ccdm_tpu, for one NVIDIA H100.

It mirrors ccdm_tpu's layout and names (ops/, embedding/, models/,
diffusion/, training/, serve.py, opts.py, main.py) and is held against it by
the tests in tests/test_torch_*.py. It imports torch and never JAX or
ccdm_tpu. The TPU's Pallas kernels become CUDA kernels written for Hopper
(csrc/), built with nvcc at first use; everything else is plain PyTorch.
Entry points run on "cuda" unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

import torch as _torch  # noqa: E402

# PyTorch runs its CPU exp, log, sin, tanh, ... through the MKL it bundles
# (VML). The first such call of a process, when it runs on two or more
# threads, can compute the worker threads' share at a lower accuracy
# (relative errors near 1e-4 where they are ~3e-8 otherwise). One call on a
# single element, which runs on the calling thread alone, sets MKL up first.
_torch.tanh(_torch.zeros(1))
