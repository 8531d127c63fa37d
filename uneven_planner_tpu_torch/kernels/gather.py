"""The gather kernels K3 `gather_rows` and K4 `gather_along`
(`csrc/gather.cu`): wrappers, plain PyTorch twins and launch counters.

    gather_rows(table, idx)      out[i, :] = table[clip(idx[i], 0, N-1), :]
    gather_along(x, idx, axis)   out[b, k] = x[b, clip(idx[b, k], 0, N-1)]
                                 (axis 1), out[i, j] = x[idx[i, j], j] (axis 0)

Indices are clipped as `jnp.take(..., mode="clip")` clips them (PyTorch
would wrap a negative index; the twins clamp first).  A wrapper runs its
twin only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel on PyTorch's current stream or raises, and never falls back.  The
kernels take bool/uint8 and 4-byte tables (K3) and 4-byte elements (K4);
float64 exists on the CPU path only.  Neither has a gradient: the search
that uses them is not differentiated.

`launches` counts kernel launches by name; only the wrappers add to it, one
per launch.
"""

from __future__ import annotations

import ctypes

import torch

from uneven_planner_tpu_torch.kernels.build import CudaLibrary

launches = {"gather_rows": 0, "gather_along": 0}

_IDX_TYPES = (torch.int32, torch.int64)


def reset_launches():
    for k in launches:
        launches[k] = 0


def _declare(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gather_rows.argtypes = [p, p, p, ll, ll, i, i, i, p]
    lib.gather_rows.restype = i
    lib.gather_along.argtypes = [p, p, p, ll, i, ll, ll, ll, ll, i, p]
    lib.gather_along.restype = i
    lib.gather_error_string.argtypes = [i]
    lib.gather_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("gather", _declare)


def _raise_on(lib, err, name):
    if err != 0:
        msg = lib.gather_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _check_index(idx, like, name):
    if idx.dtype not in _IDX_TYPES:
        raise TypeError(f"{name}: idx must be int32 or int64, got {idx.dtype}")
    if idx.device != like.device:
        raise ValueError(f"{name}: idx on {idx.device}, data on {like.device}")


# ---------------------------------------------------------------------------
# K3 gather_rows
# ---------------------------------------------------------------------------

def gather_rows_twin(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K3: rows of `table` ([N] or [N, W], contiguous) at `idx` ([M] int32 or
    int64), clipped into the table: [M] or [M, W]."""
    if table.dim() not in (1, 2) or idx.dim() != 1:
        raise ValueError("gather_rows: table must be [N] or [N, W] and idx "
                         f"[M], got {tuple(table.shape)}, {tuple(idx.shape)}")
    if table.shape[0] == 0 or table.numel() == 0:
        raise ValueError("gather_rows: empty table")
    _check_index(idx, table, "gather_rows")
    if table.device.type == "cpu":
        return gather_rows_twin(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for device {table.device}")
    elem = table.element_size()
    if elem not in (1, 4):
        raise TypeError("gather_rows: the kernel takes 1-byte and 4-byte "
                        f"elements, got {table.dtype}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("gather_rows: table and idx must be contiguous")
    M, N = idx.shape[0], table.shape[0]
    out = torch.empty((M,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    if M == 0:
        return out
    row_bytes = elem * (table.shape[1] if table.dim() == 2 else 1)
    word = elem
    if row_bytes % 16 == 0 and table.data_ptr() % 16 == 0 \
            and out.data_ptr() % 16 == 0:
        word = 16
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          M, N, row_bytes, word,
                          int(idx.dtype == torch.int64), stream)
    _raise_on(lib, err, "gather_rows")
    launches["gather_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# K4 gather_along
# ---------------------------------------------------------------------------

def gather_along_twin(x: torch.Tensor, idx: torch.Tensor,
                      axis: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K4."""
    return torch.gather(x, axis, idx.long().clamp(0, x.shape[axis] - 1))


def gather_along(x: torch.Tensor, idx: torch.Tensor,
                 axis: int = 1) -> torch.Tensor:
    """K4: `take_along_axis(x, idx, axis)` on 2-D tensors with clipped
    indices.  axis 1: x [B, N], idx [B, K] -> [B, K]; axis 0: x [N, C],
    idx [K, C] -> [K, C]."""
    if axis not in (0, 1):
        raise ValueError(f"gather_along: axis must be 0 or 1, got {axis}")
    if x.dim() != 2 or idx.dim() != 2 \
            or x.shape[1 - axis] != idx.shape[1 - axis]:
        raise ValueError("gather_along: x and idx must be 2-D and agree on "
                         f"the other axis, got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}, axis {axis}")
    if x.shape[axis] == 0:
        raise ValueError("gather_along: nothing to gather from")
    _check_index(idx, x, "gather_along")
    if x.device.type == "cpu":
        return gather_along_twin(x, idx, axis)
    if x.device.type != "cuda":
        raise ValueError(f"gather_along: no kernel for device {x.device}")
    if x.element_size() != 4:
        raise TypeError("gather_along: the kernel takes 4-byte elements, "
                        f"got {x.dtype}")
    if not x.is_contiguous() or not idx.is_contiguous():
        raise ValueError("gather_along: x and idx must be contiguous")
    rows, cols = idx.shape
    if cols >= 2 ** 31:
        raise ValueError("gather_along: at most 2^31-1 columns")
    out = torch.empty((rows, cols), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    N = x.shape[axis]
    strides = (x.shape[1], 0, 1) if axis == 1 else (0, 1, x.shape[1])
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gather_along(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                           rows, cols, N, *strides,
                           int(idx.dtype == torch.int64), stream)
    _raise_on(lib, err, "gather_along")
    launches["gather_along"] += 1
    return out
