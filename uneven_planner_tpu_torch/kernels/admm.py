"""K6 `admm_iterations` (`csrc/admm_qp.cu`): the iteration loop of the
batched ADMM QP solver, with its plain PyTorch twin and launch counter.

    admm_iterations(data, state, sigma=, alpha=, eps_abs=, eps_rel=,
                    max_iter=, n_iters=) -> state

runs, for every lane (one QP) that is not done, at most `n_iters` further
iterations of the loop body of the JAX package's `solve_qp`
(`solver/admm_qp.py:295-348`, adaptive rho off) and freezes a lane once its
termination test holds or its count reaches `max_iter`.  The kernel is one
thread block per lane with the loop inside; the twin is the same arithmetic
as batched tensor operations with a `done` mask.  The wrapper runs the twin
only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel on PyTorch's current stream or raises, and never falls back.

The kernel has four instantiations, and `variant(n, m, dtype, nnz)` picks
one by shape, dtype and the lanes' nonzero counts before the launch:
- "fixed": float32 at n = 60, m = 118 (the condensed tracking QP), compiled
  for its shape, P, A and the inverse in shared memory;
- "runtime": the same design for the other float32 shapes whose lane fits
  in a block's shared memory (`shared_bytes(n, m) <= MAX_SHARED_BYTES`; the
  largest condensed shape, n = 116, m = 230, does);
- "sparse": every other float32 QP and every float64 QP whose lane fits in
  a block's shared memory with P and A compressed to their entries that are
  not exactly zero (`sparse_shared_bytes`), such as the full tracking QP
  (n = 150, m = 208: A 531 nonzeros, P 266) and the condensed QP in
  float64; the inverse stays dense in shared memory;
- "global": the rest, such as a dense QP of the full QP's shape; P and A
  are read dense from device memory on every iteration, the inverse is in
  shared memory when it fits (`global_shared_bytes`).
Where the shape and dtype alone do not decide (neither "fixed" nor
"runtime"), `admm_iterations` counts the nonzeros of every lane on the
device and reads the largest counts back (`nonzero_counts`): one host read
per launch.
No gradient: nothing differentiates through the QP.

`launches` counts kernel launches: "admm_iterations" every launch of K6,
whichever instantiation, and "admm_iterations_<instantiation>" the launches
of each among them; only the wrapper adds to it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from uneven_planner_tpu_torch.kernels.build import CudaLibrary
from uneven_planner_tpu_torch.utils.profiling import read_host, span

# "admm_iterations" counts every launch of K6, "admm_iterations_fixed",
# "_runtime", "_sparse" and "_global" the launches of each instantiation
# among them
launches = {"admm_iterations": 0, "admm_iterations_fixed": 0,
            "admm_iterations_runtime": 0, "admm_iterations_sparse": 0,
            "admm_iterations_global": 0}

# bytes of shared memory one thread block can have on sm_90
MAX_SHARED_BYTES = 232448
_THREADS = 256
_WARPS = _THREADS // 32
# (n, m) of the condensed tracking QP, for which the kernel is compiled
# with its shape fixed (kFixedN, kFixedM of csrc/admm_qp.cu)
FIXED_SHAPE = (60, 118)


def reset_launches():
    for k in launches:
        launches[k] = 0


class ADMMData(NamedTuple):
    """One scaled QP per lane and what undoes the scaling."""
    P: torch.Tensor        # [B, n, n]
    q: torch.Tensor        # [B, n]
    A: torch.Tensor        # [B, m, n]
    l: torch.Tensor        # [B, m]
    u: torch.Tensor        # [B, m]
    rho_vec: torch.Tensor  # [B, m]
    minv: torch.Tensor     # [B, n, n] inverse of P + sigma I + A' diag(rho) A
    Dinv: torch.Tensor     # [B, n]
    Einv: torch.Tensor     # [B, m]
    cinv: torch.Tensor     # [B]


class ADMMState(NamedTuple):
    x: torch.Tensor          # [B, n]
    z: torch.Tensor          # [B, m]
    y: torch.Tensor          # [B, m]
    it: torch.Tensor         # [B] int32
    r_prim: torch.Tensor     # [B] residuals of the last iteration
    r_dual: torch.Tensor
    prim_norm: torch.Tensor  # [B] the norms its tolerances scale with
    dual_norm: torch.Tensor
    done: torch.Tensor       # [B] bool


def initial_state(x, z, y) -> ADMMState:
    B = x.shape[0]
    inf = x.new_full((B,), float("inf"))
    zero = x.new_zeros((B,))
    return ADMMState(x=x, z=z, y=y,
                     it=torch.zeros((B,), dtype=torch.int32, device=x.device),
                     r_prim=inf, r_dual=inf.clone(), prim_norm=zero,
                     dual_norm=zero.clone(),
                     done=torch.zeros((B,), dtype=torch.bool,
                                      device=x.device))


def shared_bytes(n: int, m: int) -> int:
    """Shared memory a lane of an (n, m) QP takes in the kernel: the three
    matrices and three n-vectors at the row stride (n words at the shape
    the kernel is compiled for, n | 1 otherwise), three more n-vectors,
    7 m-vectors and the reduction scratch (`shared_words` of
    `csrc/admm_qp.cu`)."""
    ld = n if (n, m) == FIXED_SHAPE else n | 1
    return 4 * ((2 * n + m) * ld + 3 * ld + 3 * n + 7 * m + 4 * _WARPS)


def global_shared_bytes(n: int, m: int, dtype) -> tuple:
    """(bytes, minv_resident) of a lane in the global variant: the
    reduction scratch, seven n-vectors and seven m-vectors, with the
    inverse when all of it fits in MAX_SHARED_BYTES
    (`global_shared_bytes` of `csrc/admm_qp.cu`).  bytes is 0 when not even
    the vectors fit."""
    elt = torch.tensor([], dtype=dtype).element_size()
    vec = elt * (4 * _WARPS + 7 * n + 7 * m)
    if vec + elt * n * n <= MAX_SHARED_BYTES:
        return vec + elt * n * n, True
    return (vec if vec <= MAX_SHARED_BYTES else 0), False


def sparse_shared_bytes(n: int, m: int, nnz_a: int, nnz_p: int,
                        dtype) -> int:
    """Shared memory a lane of an (n, m) QP with nnz_a entries of A and
    nnz_p of P that are not zero takes in the sparse variant, or 0 when
    such a lane does not fit (`admm_sparse_shared_bytes` of
    `csrc/admm_qp.cu`): the reduction scratch; Minv and rhs at a row stride
    of n rounded up to an odd count of 16-byte words; five more n-vectors
    and seven m-vectors; the values of A by rows, A by columns and P by
    rows; their starts (m + 1, n + 1, n + 1 int32), A's n column cursors
    and their 16-bit indices.
    A lane fits when that is at most MAX_SHARED_BYTES, n is at most a
    block's 256 threads and m at most 65,536."""
    elt = torch.tensor([], dtype=dtype).element_size()
    per = 16 // elt
    words = -(-n // per)
    ld = per * (words + 1 - words % 2)
    nbytes = elt * (4 * _WARPS + n * ld + ld + 5 * n + 7 * m + 2 * nnz_a
                    + nnz_p) + 4 * (m + 3 * n + 3) + 2 * (2 * nnz_a + nnz_p)
    fits = n <= _THREADS and m <= 65536 and nbytes <= MAX_SHARED_BYTES
    return nbytes if fits else 0


def variant(n: int, m: int, dtype, nnz=None) -> str:
    """The instantiation of K6 that serves an (n, m) QP of `dtype` on the
    card: "fixed", "runtime", "sparse" or "global" (see the module's
    docstring).  `nnz` is (nnz_a, nnz_p), the largest counts over the lanes
    of A's and P's entries that are not zero; without it only the shape
    and dtype decide, and a QP that neither shared-memory kernel takes is
    "global".  Raises TypeError for a dtype other than float32 and
    float64."""
    if dtype == torch.float32:
        if (n, m) == FIXED_SHAPE:
            return "fixed"
        if shared_bytes(n, m) <= MAX_SHARED_BYTES:
            return "runtime"
    elif dtype != torch.float64:
        raise TypeError(f"admm_iterations: no kernel for {dtype}; float32 "
                        "and float64 are served")
    if nnz is not None and sparse_shared_bytes(n, m, *nnz, dtype) > 0:
        return "sparse"
    return "global"


def nonzero_counts(d: ADMMData) -> tuple:
    """(nnz_a, nnz_p): the largest count over the lanes of A's and of P's
    entries that are not exactly zero (a NaN counts), as the sparse variant
    compresses them.  Counted on the device in the span `up.qp.nnz`; one
    host read, under "nonzero_counts" of `utils.profiling.host_reads`."""
    if d.A.shape[0] == 0:
        return 0, 0
    with span("up.qp.nnz"):
        counts = torch.stack([(d.A != 0).sum((1, 2)).amax(),
                              (d.P != 0).sum((1, 2)).amax()])
        nnz_a, nnz_p = read_host("nonzero_counts", counts)
    return int(nnz_a), int(nnz_p)


def _declare(lib):
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_double
    lib.admm_iterations.argtypes = [p] * 28 + [i, i, i, f, f, f, f, f, i, i,
                                               p]
    lib.admm_iterations.restype = i
    lib.admm_shared_bytes.argtypes = [i, i]
    lib.admm_shared_bytes.restype = ctypes.c_longlong
    lib.admm_iterations_global.argtypes = [p] * 28 + [i, i, i, i, d, d, d,
                                                      d, d, i, i, p]
    lib.admm_iterations_global.restype = i
    lib.admm_global_shared_bytes.argtypes = [i, i, i,
                                             ctypes.POINTER(ctypes.c_int)]
    lib.admm_global_shared_bytes.restype = ctypes.c_longlong
    lib.admm_iterations_sparse.argtypes = [p] * 28 + [i, i, i, i, i, i, d,
                                                      d, d, d, d, i, i, p]
    lib.admm_iterations_sparse.restype = i
    lib.admm_sparse_shared_bytes.argtypes = [i, i, i, i, i]
    lib.admm_sparse_shared_bytes.restype = ctypes.c_longlong
    lib.admm_error_string.argtypes = [i]
    lib.admm_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("admm_qp", _declare)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _mv(M, v):
    return torch.matmul(M, v[..., None])[..., 0]


def admm_iterations_twin(d: ADMMData, s: ADMMState, *, sigma: float,
                         alpha: float, eps_abs: float, eps_rel: float,
                         max_iter: int, n_iters: int) -> ADMMState:
    """Plain PyTorch version of K6, any float dtype.  On the CPU it stops
    once every lane is done (the remaining iterations would change
    nothing)."""
    At = d.A.transpose(1, 2)
    cd = d.cinv[:, None] * d.Dinv
    q_u = cd * d.q
    on_cpu = s.x.device.type == "cpu"
    for _ in range(n_iters):
        if on_cpu and bool(s.done.all()):
            break
        rhs = sigma * s.x - d.q + _mv(At, d.rho_vec * s.z - s.y)
        x_t = _mv(d.minv, rhs)
        z_t = _mv(d.A, x_t)
        x_new = alpha * x_t + (1 - alpha) * s.x
        z_relax = alpha * z_t + (1 - alpha) * s.z
        z_new = torch.clamp(z_relax + s.y / d.rho_vec, d.l, d.u)
        y_new = s.y + d.rho_vec * (z_relax - z_new)

        # unscaled residuals (OSQP terminates on unscaled data)
        Ax_u = d.Einv * _mv(d.A, x_new)
        z_u = d.Einv * z_new
        r_prim = (Ax_u - z_u).abs().amax(-1)
        Px_u = cd * _mv(d.P, x_new)
        Aty_u = cd * _mv(At, y_new)
        r_dual = (Px_u + q_u + Aty_u).abs().amax(-1)
        prim_norm = torch.maximum(Ax_u.abs().amax(-1), z_u.abs().amax(-1))
        dual_norm = torch.maximum(
            torch.maximum(Px_u.abs().amax(-1), Aty_u.abs().amax(-1)),
            q_u.abs().amax(-1))
        converged = (r_prim < eps_abs + eps_rel * prim_norm) \
            & (r_dual < eps_abs + eps_rel * dual_norm)
        it = s.it + 1
        new = ADMMState(x=x_new, z=z_new, y=y_new, it=it, r_prim=r_prim,
                        r_dual=r_dual, prim_norm=prim_norm,
                        dual_norm=dual_norm,
                        done=converged | (it >= max_iter))
        frozen = s.done
        s = ADMMState(*[
            torch.where(frozen[:, None] if old.dim() == 2 else frozen, old,
                        nxt) for old, nxt in zip(s, new)])
    return s


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check(t, name, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"admm_iterations: {name} on {t.device}, P on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"admm_iterations: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"admm_iterations: {name} must be a contiguous "
                         f"{list(shape)} tensor, got {list(t.shape)}")


def admm_iterations(d: ADMMData, s: ADMMState, *, sigma: float, alpha: float,
                    eps_abs: float, eps_rel: float, max_iter: int,
                    n_iters: int) -> ADMMState:
    """K6: advance every lane that is not done by at most `n_iters` ADMM
    iterations.  Returns a new state; `d` and `s` are left as they are."""
    kw = dict(sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
              max_iter=max_iter, n_iters=n_iters)
    if d.P.device.type == "cpu":
        return admm_iterations_twin(d, s, **kw)
    if d.P.dim() != 3 or d.A.dim() != 3:
        raise ValueError("admm_iterations: P must be [B, n, n] and A "
                         "[B, m, n]")
    n, m, dtype = d.P.shape[1], d.A.shape[1], d.P.dtype
    # the nonzeros are counted only where the shape does not decide
    nnz = nonzero_counts(d) if variant(n, m, dtype) == "global" else None
    return launch_variant(variant(n, m, dtype, nnz), d, s, nnz=nnz, **kw)


def launch_variant(which: str, d: ADMMData, s: ADMMState, *, sigma: float,
                   alpha: float, eps_abs: float, eps_rel: float,
                   max_iter: int, n_iters: int, nnz=None) -> ADMMState:
    """Launch the named instantiation of K6 on CUDA tensors
    (`admm_iterations` names the one `variant` picks; the card tests and
    `chip_smoke.py` name the sparse and global ones at shapes another one
    serves, to hold them to the twin and time them there).  "sparse" is
    sized for `nnz` (`nonzero_counts(d)` when None; a caller that captures
    the launch in a CUDA graph passes it, since counting reads back to the
    host).  Raises where that instantiation does not take the QP."""
    dev = d.P.device
    if dev.type != "cuda":
        raise ValueError(f"admm_iterations: no kernel for device {dev}")
    if d.P.dim() != 3 or d.A.dim() != 3:
        raise ValueError("admm_iterations: P must be [B, n, n] and A "
                         "[B, m, n]")
    B, n, m = d.P.shape[0], d.P.shape[1], d.A.shape[1]
    dtype = d.P.dtype
    for name, t, shape in [
            ("P", d.P, (B, n, n)), ("q", d.q, (B, n)), ("A", d.A, (B, m, n)),
            ("l", d.l, (B, m)), ("u", d.u, (B, m)),
            ("rho_vec", d.rho_vec, (B, m)), ("minv", d.minv, (B, n, n)),
            ("Dinv", d.Dinv, (B, n)), ("Einv", d.Einv, (B, m)),
            ("cinv", d.cinv, (B,)), ("x", s.x, (B, n)), ("z", s.z, (B, m)),
            ("y", s.y, (B, m)), ("r_prim", s.r_prim, (B,)),
            ("r_dual", s.r_dual, (B,)), ("prim_norm", s.prim_norm, (B,)),
            ("dual_norm", s.dual_norm, (B,))]:
        _check(t, name, shape, dtype, dev)
    _check(s.it, "it", (B,), torch.int32, dev)
    _check(s.done, "done", (B,), torch.bool, dev)
    if which == "sparse":
        nnz = nonzero_counts(d) if nnz is None else tuple(nnz)
        if sparse_shared_bytes(n, m, *nnz, dtype) == 0:
            raise ValueError(
                f"admm_iterations: an (n={n}, m={m}) {dtype} QP with "
                f"{nnz[0]} nonzeros in A and {nnz[1]} in P does not fit in "
                f"the {MAX_SHARED_BYTES} bytes of a block's shared memory "
                "compressed")
    # the global variant takes every shape the others take
    elif which not in (variant(n, m, dtype), "global"):
        raise ValueError(f"admm_iterations: the {which!r} kernel does not "
                         f"take an (n={n}, m={m}) {dtype} QP")
    if which == "global" and global_shared_bytes(n, m, dtype)[0] == 0:
        raise ValueError(
            f"admm_iterations: the vectors of an (n={n}, m={m}) QP do not "
            f"fit in the {MAX_SHARED_BYTES} bytes of a block's shared "
            "memory")
    if B == 0:
        return s
    out = ADMMState(*[torch.empty_like(t) for t in s])
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*d, *s, *out)]
    dbl = int(dtype == torch.float64)
    scalars = (float(sigma), float(alpha), float(1 - alpha), float(eps_abs),
               float(eps_rel), int(max_iter), int(n_iters), stream)
    if which == "global":
        err = lib.admm_iterations_global(*ptrs, B, n, m, dbl, *scalars)
    elif which == "sparse":
        err = lib.admm_iterations_sparse(*ptrs, B, n, m, *nnz, dbl,
                                         *scalars)
    else:
        err = lib.admm_iterations(*ptrs, B, n, m, *scalars)
    if err != 0:
        msg = lib.admm_error_string(err).decode()
        raise RuntimeError(f"admm_iterations launch failed: {msg} ({err})")
    launches["admm_iterations"] += 1
    launches[f"admm_iterations_{which}"] += 1
    return out
