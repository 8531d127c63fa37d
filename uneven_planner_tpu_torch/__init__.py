"""uneven_planner_tpu_torch — the PyTorch/CUDA port of uneven_planner_tpu.

Same layout as the JAX package (`terrain/`, `minco/`, `solver/`), written in
PyTorch's idiom: plain functions on `[B, ...]` tensors with the lane batch
written out, an explicit device, and hand-written CUDA kernels for Hopper
(`csrc/`) behind `torch.autograd.Function`s.  The package imports torch and
numpy only; it never imports JAX or the JAX package.

Entry points take `device=None`, which means CUDA, and raise when CUDA is
absent.  Pass `device="cpu"` to run the plain PyTorch versions of the
kernels (the tests do).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device.  Raises when CUDA is requested but
    absent; never falls back to the CPU.  On CUDA, pins full-fp32 matmuls
    (the JAX package's `Precision.HIGHEST`): no TF32 anywhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return dev
