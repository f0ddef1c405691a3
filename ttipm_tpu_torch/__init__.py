"""ttipm_tpu_torch — the TT interior-point method on PyTorch and CUDA.

A port of ``ttipm_tpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper.  A TT is a list of ``torch.Tensor`` cores;
every function runs on the device of the tensors it is given (``cpu`` or
``cuda``), and the random draws are numpy's, so one seed gives the same
instance and the same solve as the JAX package.  On CPU tensors the four
kernels run their plain PyTorch versions; on CUDA tensors they run the
kernels built from ``ttipm_tpu_torch/csrc`` (see ``ops/kernels.py``).

This package imports torch, numpy and scipy, never jax.
"""

from ttipm_tpu_torch import config as config  # noqa: F401

from ttipm_tpu_torch.ops.tt import *  # noqa: F401,F403
from ttipm_tpu_torch.ops.rounding import *  # noqa: F401,F403
from ttipm_tpu_torch.ops.products import *  # noqa: F401,F403
from ttipm_tpu_torch.ops.random import *  # noqa: F401,F403

__version__ = "0.1.0"
