"""K7 `ruiz_equilibrate` (`csrc/ruiz.cu`): OSQP's modified Ruiz
equilibration of a batch of QPs in one launch, with its launch counter.

    ruiz_equilibrate(P, q, A, l, u, iters=10, min_scale=1e-4,
                     max_scale=1e4) -> (Pb, qb, Ab, lb, ub, D, E, c)

computes on CUDA tensors what `solver/admm_qp.py:ruiz_equilibrate_twin`, its
plain PyTorch twin, computes: every output bit for bit, except where a mean
of column maxima is summed in another order (the cost scale g and what it
multiplies; see the source's note).  `solver/admm_qp.py:ruiz_equilibrate`
takes the twin for CPU tensors and this launcher for CUDA tensors, which
launches the kernel on PyTorch's current stream or raises, and never falls
back.  One thread block per lane.  `instantiation(n, m, dtype)` says where
a lane's P and A live during the ten iterations, decided by shape and dtype
before the launch:
- "shared": in the block's shared memory, when they fit there beside the
  lane's vectors (`shared_bytes`): the condensed tracking QP (n = 60,
  m = 118) in float32 and float64 and the full one (n = 150, m = 208) in
  float32;
- "global": in place on the output buffers in device memory, for the rest,
  such as the full tracking QP in float64.
The arithmetic is the same in both.  Inputs may be broadcast over the lanes
(a lane stride of 0, as `expand` gives: the tracker's constant P, A, l, u);
each lane's matrix or vector must be row-major.  No gradient.

`launches` counts kernel launches: "ruiz_equilibrate" every launch of K7,
"ruiz_equilibrate_shared" and "ruiz_equilibrate_global" those of each
instantiation among them; only the launcher adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from uneven_planner_tpu_torch.kernels.build import CudaLibrary

launches = {"ruiz_equilibrate": 0, "ruiz_equilibrate_shared": 0,
            "ruiz_equilibrate_global": 0}

# bytes of shared memory one thread block can have on sm_90
MAX_SHARED_BYTES = 232448


def reset_launches():
    for k in launches:
        launches[k] = 0


def _round16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def shared_bytes(n: int, m: int, dtype) -> tuple:
    """(bytes, resident) of a lane of an (n, m) QP, as `csrc/ruiz.cu` lays
    it out: P and A, each from a 16-byte boundary, when all of it
    fits in MAX_SHARED_BYTES (resident), and the vectors: two sets of keys
    of P's and A's column maxima and A's row maxima, four words for the keys
    of max |q|, q, the column and row scales and their products (7 n + 4 m +
    4 elements).  bytes is 0 when not even the vectors fit."""
    elt = torch.tensor([], dtype=dtype).element_size()
    vec = elt * (7 * n + 4 * m + 4)
    mat = _round16(elt * n * n) + _round16(elt * m * n)
    if mat + vec <= MAX_SHARED_BYTES:
        return mat + vec, True
    return (vec if vec <= MAX_SHARED_BYTES else 0), False


def instantiation(n: int, m: int, dtype) -> str:
    """Where K7 keeps a lane of an (n, m) QP of `dtype`: "shared" or
    "global" (see the module's docstring).  Raises TypeError for a dtype
    other than float32 and float64, ValueError for a shape whose vectors do
    not fit in a block's shared memory."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ruiz_equilibrate: no kernel for {dtype}; float32 "
                        "and float64 are served")
    nbytes, resident = shared_bytes(n, m, dtype)
    if nbytes == 0:
        raise ValueError(f"ruiz_equilibrate: the vectors of an (n={n}, "
                         f"m={m}) QP do not fit in the {MAX_SHARED_BYTES} "
                         "bytes of a block's shared memory")
    return "shared" if resident else "global"


def _declare(lib):
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    lib.ruiz_equilibrate.argtypes = [p] * 5 + [ll] * 5 + [p] * 8 \
        + [i, i, i, i, i, i, d, d, p]
    lib.ruiz_equilibrate.restype = i
    lib.ruiz_error_string.argtypes = [i]
    lib.ruiz_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ruiz", _declare)


def _lane_stride(t, name, shape, dtype, device) -> int:
    """The lane stride of `t` in elements, after checking its device, dtype,
    shape and that each lane is row-major."""
    if t.device != device:
        raise ValueError(f"ruiz_equilibrate: {name} on {t.device}, q on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"ruiz_equilibrate: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"ruiz_equilibrate: {name} must be "
                         f"{list(shape)}, got {list(t.shape)}")
    want = 1
    for size, stride in reversed(list(zip(shape[1:], t.stride()[1:]))):
        if size > 1 and stride != want:
            raise ValueError(f"ruiz_equilibrate: each lane of {name} must be "
                             f"row-major, got strides {list(t.stride())}")
        want *= size
    return t.stride(0) if shape[0] > 1 else 0


def ruiz_equilibrate(P, q, A, l, u, iters: int = 10,
                     min_scale: float = 1e-4, max_scale: float = 1e4):
    """K7 on CUDA tensors: P [B, n, n], q [B, n], A [B, m, n], l, u [B, m],
    one dtype, float32 or float64.  Returns new contiguous tensors (Pb, qb,
    Ab, lb, ub, D, E, c); the inputs are left as they are.  A batch of no
    lanes launches nothing."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"ruiz_equilibrate: no kernel for device {dev}")
    if P.dim() != 3 or A.dim() != 3 or q.dim() != 2:
        raise ValueError("ruiz_equilibrate: P must be [B, n, n], q [B, n] "
                         "and A [B, m, n]")
    B, n = q.shape
    m = A.shape[1]
    if n == 0 or m == 0:
        raise ValueError(f"ruiz_equilibrate: no kernel for n={n}, m={m}")
    dtype = q.dtype
    which = instantiation(n, m, dtype)
    strides = [_lane_stride(t, name, shape, dtype, dev) for name, t, shape in
               (("P", P, (B, n, n)), ("q", q, (B, n)), ("A", A, (B, m, n)),
                ("l", l, (B, m)), ("u", u, (B, m)))]
    if iters < 0:
        raise ValueError(f"ruiz_equilibrate: iters must be >= 0, got {iters}")
    empty = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    out = (empty(B, n, n), empty(B, n), empty(B, m, n), empty(B, m),
           empty(B, m), empty(B, n), empty(B, m), empty(B))
    if B == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ruiz_equilibrate(
        *[t.data_ptr() for t in (P, q, A, l, u)], *strides,
        *[t.data_ptr() for t in out], B, n, m, int(iters),
        int(dtype == torch.float64), int(which == "shared"), float(min_scale),
        float(max_scale), stream)
    if err != 0:
        msg = lib.ruiz_error_string(err).decode()
        raise RuntimeError(f"ruiz_equilibrate launch failed: {msg} ({err})")
    launches["ruiz_equilibrate"] += 1
    launches[f"ruiz_equilibrate_{which}"] += 1
    return out
