"""K5 `tanh_affine` (`csrc/elementwise.cu`): wrapper, plain PyTorch twin and
launch counter.

    tanh_affine(x, a, b)    out = tanh(x) * a + b, elementwise, float32

It ports the JAX package's TPU probe A (`experiments/e31_pallas.py:39`,
`tanh(x) * 2 + 1`), a toolchain sanity check that no path of either package
calls.  The wrapper runs its twin only for a tensor that lies on the CPU;
for a CUDA tensor it launches the kernel on PyTorch's current stream or
raises, and never falls back.  No gradient.

`launches` counts kernel launches by name; only the wrapper adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from uneven_planner_tpu_torch.kernels.build import CudaLibrary

launches = {"tanh_affine": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _declare(lib):
    p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.tanh_affine.argtypes = [p, p, ll, f, f, p]
    lib.tanh_affine.restype = ctypes.c_int
    lib.elementwise_error_string.argtypes = [ctypes.c_int]
    lib.elementwise_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("elementwise", _declare)


def tanh_affine_twin(x: torch.Tensor, a: float = 2.0,
                     b: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K5."""
    return torch.tanh(x) * a + b


def tanh_affine(x: torch.Tensor, a: float = 2.0, b: float = 1.0
                ) -> torch.Tensor:
    """K5: `tanh(x) * a + b` of a contiguous float32 tensor of any shape."""
    if x.device.type == "cpu":
        return tanh_affine_twin(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"tanh_affine: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"tanh_affine: the kernel takes float32, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("tanh_affine: x must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tanh_affine(x.data_ptr(), out.data_ptr(), x.numel(), float(a),
                          float(b), stream)
    if err != 0:
        msg = lib.elementwise_error_string(err).decode()
        raise RuntimeError(f"tanh_affine launch failed: {msg} ({err})")
    launches["tanh_affine"] += 1
    return out
