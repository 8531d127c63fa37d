"""The gather kernels K3 `gather_rows` and K4 `gather_along`
(`csrc/gather.cu`): wrappers, plain PyTorch twins and launch counters.

    gather_rows(table, idx)      out[i, :] = table[clip(idx[i], 0, N-1), :]
    gather_along(x, idx, axis)   out[b, k] = x[b, clip(idx[b, k], 0, N-1)]
                                 (axis 1), out[i, j] = x[idx[i, j], j] (axis 0)
    gather_along_many(xs, idx)   [gather_along(x, idx) for x in xs], one
                                 launch for up to 8 arrays of one shape
    walk_parents(parent, start, steps)
                                 the search's walk back through its parent
                                 arena, one launch for all the steps

Indices are clipped as `jnp.take(..., mode="clip")` clips them (PyTorch
would wrap a negative index; the twins clamp first).  A wrapper runs its
twin only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel on PyTorch's current stream or raises, and never falls back.  The
kernels copy bits, so they care only for an element's width: K3 takes 1-,
4- and 8-byte tables (a byte table of at most SMEM_TABLE_BYTES rows is read
from shared memory by a kernel of its own; other rows move as the widest
words that fit, `row_word_bytes`), K4 4- and 8-byte elements, so
float64 and int64 run on the card as float32 and int32 do.  Neither has a
gradient: the search and the reference sampling that use them are not
differentiated.

`launches` counts kernel launches by name; only the wrappers add to it, one
per launch.
"""

from __future__ import annotations

import ctypes
import torch

from uneven_planner_tpu_torch.kernels.build import CudaLibrary

# "gather_rows" counts every K3 launch, and the two below it those of each
# of its kernels: the shared-memory byte table and the word path
launches = {"gather_rows": 0, "gather_rows_shared": 0, "gather_rows_words": 0,
            "gather_along": 0, "gather_along_many": 0, "walk_parents": 0}

_IDX_TYPES = (torch.int32, torch.int64)
# the largest byte table K3 copies into shared memory (kSmemTable of
# csrc/gather.cu); a larger one goes through the generic kernel
SMEM_TABLE_BYTES = 48 * 1024
# element widths, in bytes, each kernel is compiled for
ROWS_ELEMENT_BYTES = (1, 4, 8)
# the words K3 moves a row in, widest first (else the element's width), and
# how far its word offsets may pass beyond M * W or N * W (kOffSlack of
# csrc/gather.cu: kRowsUnroll * kMaxGridX * kThreads)
ROWS_WORDS = (16, 8, 4)
ROWS_OFF_SLACK = 2 * 2 ** 16 * 256
ALONG_ELEMENT_BYTES = (4, 8)
# arrays one K4 launch reads at one index (kMaxArrays), and the indices a
# thread takes (kAlongVec)
MAX_ARRAYS = 8
ALONG_VEC = 4


def reset_launches():
    for k in launches:
        launches[k] = 0


def _declare(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gather_rows.argtypes = [p, p, p, ll, ll, i, i, i, i, p]
    lib.gather_rows.restype = i
    lib.gather_rows_bytes_smem.argtypes = [p, p, p, ll, i, ll, i, p]
    lib.gather_rows_bytes_smem.restype = i
    lib.gather_along.argtypes = [p, p, i, p, ll, ll, ll, ll, ll, ll, i, i,
                                 i, i, p]
    lib.gather_along.restype = i
    lib.walk_parents.argtypes = [p, p, p, p, i, ll, i, p]
    lib.walk_parents.restype = i
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


def check_element_size(t: torch.Tensor, sizes, name):
    """Raise TypeError unless the kernel `name` is compiled for the width
    of t's elements (`sizes`, in bytes)."""
    if t.element_size() not in sizes:
        raise TypeError(f"{name}: the kernel takes elements of "
                        f"{'/'.join(map(str, sizes))} bytes, got {t.dtype}")


# ---------------------------------------------------------------------------
# K3 gather_rows
# ---------------------------------------------------------------------------

def row_word_bytes(elem: int, row_bytes: int, align: int) -> int:
    """The word K3 moves a table row in: the widest of ROWS_WORDS that
    divides both the row's length and `align` (the alignment, in bytes,
    that table and output share), else the element's own width."""
    for word in ROWS_WORDS:
        if row_bytes % word == 0 and align % word == 0:
            return word
    return elem


def alignment(*ptrs: int) -> int:
    """The largest power of two up to 16 that divides every address."""
    align = 16
    while align > 1 and any(p % align for p in ptrs):
        align //= 2
    return align


def rows_word(row_bytes: int, elem: int, table_ptr: int, out_ptr: int) -> int:
    """K3's route for rows that are not a shared-memory byte table: the
    word path, in the word `row_word_bytes` gives rows of `row_bytes`
    (elements of `elem` bytes) from the table at `table_ptr` into the
    output at `out_ptr`."""
    return row_word_bytes(elem, row_bytes, alignment(table_ptr, out_ptr))


def gather_rows_twin(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def uses_shared_table(table: torch.Tensor) -> bool:
    """Whether K3 reads `table` from shared memory: one byte per row and at
    most SMEM_TABLE_BYTES rows (the occupancy table of the search)."""
    return table.element_size() == 1 and table.numel() == table.shape[0] \
        and table.shape[0] <= SMEM_TABLE_BYTES


def _vector_head(idx: torch.Tensor, out: torch.Tensor) -> int:
    """For the shared-table kernel: the indices before idx's first 16-byte
    boundary, or M (all scalar) when the output bytes after them are not
    aligned for one store per 16 bytes of indices."""
    M, size = idx.shape[0], idx.element_size()
    per_vec = 16 // size
    head = (-(idx.data_ptr() // size)) % per_vec
    if idx.data_ptr() % size or (out.data_ptr() + head) % per_vec:
        return M
    return min(head, M)


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
    check_element_size(table, ROWS_ELEMENT_BYTES, "gather_rows")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("gather_rows: table and idx must be contiguous")
    out = torch.empty((idx.shape[0],) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=table.device)
    return _launch_rows(table, idx, out)


def _launch_rows(table, idx, out, *, off32=None):
    """K3 on CUDA tensors the wrapper has checked, into `out` (contiguous,
    [M] + table.shape[1:], table's dtype; the card tests pass views off
    alignment).  The offset width comes from the sizes unless named (the
    card tests name each instantiation)."""
    M, N = idx.shape[0], table.shape[0]
    if M == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    idx64 = int(idx.dtype == torch.int64)
    if uses_shared_table(table):
        err = lib.gather_rows_bytes_smem(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), M, N,
            _vector_head(idx, out), idx64, stream)
        route = "gather_rows_shared"
    else:
        elem = table.element_size()
        row_bytes = elem * (table.shape[1] if table.dim() == 2 else 1)
        word = rows_word(row_bytes, elem, table.data_ptr(), out.data_ptr())
        if off32 is None:   # every offset, with the loop's last step
            off32 = max(M, N) * (row_bytes // word) + ROWS_OFF_SLACK \
                < 2 ** 31
        err = lib.gather_rows(table.data_ptr(), idx.data_ptr(),
                              out.data_ptr(), M, N, row_bytes, word, idx64,
                              int(off32), stream)
        route = "gather_rows_words"
    _raise_on(lib, err, "gather_rows")
    launches["gather_rows"] += 1
    launches[route] += 1
    return out


# ---------------------------------------------------------------------------
# K4 gather_along, gather_along_many, walk_parents
# ---------------------------------------------------------------------------

def gather_along_twin(x: torch.Tensor, idx: torch.Tensor,
                      axis: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K4."""
    return torch.gather(x, axis, idx.long().clamp(0, x.shape[axis] - 1))


def gather_along_many_twin(xs, idx: torch.Tensor, axis: int = 1) -> list:
    """Plain PyTorch version of `gather_along_many`: one
    `gather_along_twin` per array."""
    return [gather_along_twin(x, idx, axis) for x in xs]


def _check_along(xs, idx, axis, name):
    """Shape, device, index and element-width checks shared by K4's
    wrappers; raises on what the kernel does not take."""
    if axis not in (0, 1):
        raise ValueError(f"{name}: axis must be 0 or 1, got {axis}")
    if not 1 <= len(xs) <= MAX_ARRAYS:
        raise ValueError(f"{name}: 1 to {MAX_ARRAYS} arrays, got {len(xs)}")
    x = xs[0]
    if x.dim() != 2 or idx.dim() != 2 \
            or x.shape[1 - axis] != idx.shape[1 - axis]:
        raise ValueError(f"{name}: x and idx must be 2-D and agree on "
                         f"the other axis, got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}, axis {axis}")
    if x.shape[axis] == 0:
        raise ValueError(f"{name}: nothing to gather from")
    for y in xs[1:]:
        if y.shape != x.shape or y.device != x.device:
            raise ValueError(f"{name}: the arrays must share shape and "
                             "device")
        if y.element_size() != x.element_size():
            raise TypeError(f"{name}: the arrays must share one element "
                            f"width, got {x.dtype} and {y.dtype}")
    _check_index(idx, x, name)


def _launch_along(xs, idx, axis, name, *, off32=None, vec=None):
    """K4 on CUDA tensors: one launch reads every array of `xs` at `idx`.
    The offset width and the vector path come from the sizes and the
    alignment unless named (the card tests name each instantiation)."""
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    check_element_size(x, ALONG_ELEMENT_BYTES, name)
    if not all(y.is_contiguous() for y in xs) or not idx.is_contiguous():
        raise ValueError(f"{name}: the arrays and idx must be contiguous")
    rows, cols = idx.shape
    outs = [torch.empty((rows, cols), dtype=y.dtype, device=y.device)
            for y in xs]
    if idx.numel() == 0:
        return outs
    if off32 is None:   # every element of the arrays and idx fits an int
        off32 = max(x.numel(), idx.numel()) < 2 ** 31
    if vec is None:
        vec = cols % ALONG_VEC == 0 and all(
            t.data_ptr() % 16 == 0 for t in [idx, *outs])
    N = x.shape[axis]
    strides = (x.shape[1], 0, 1) if axis == 1 else (0, 1, x.shape[1])
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gather_along(ptrs(xs), ptrs(outs), len(xs), idx.data_ptr(),
                           rows, cols, N, *strides, x.element_size(),
                           int(idx.dtype == torch.int64), int(off32),
                           int(vec), stream)
    _raise_on(lib, err, name)
    launches[name] += 1
    return outs


def gather_along(x: torch.Tensor, idx: torch.Tensor,
                 axis: int = 1) -> torch.Tensor:
    """K4: `take_along_axis(x, idx, axis)` on 2-D tensors with clipped
    indices.  axis 1: x [B, N], idx [B, K] -> [B, K]; axis 0: x [N, C],
    idx [K, C] -> [K, C]."""
    _check_along([x], idx, axis, "gather_along")
    if x.device.type == "cpu":
        return gather_along_twin(x, idx, axis)
    return _launch_along([x], idx, axis, "gather_along")[0]


def gather_along_many(xs, idx: torch.Tensor, axis: int = 1) -> list:
    """K4 on 1 to MAX_ARRAYS arrays of one shape and one element width
    (float32 and int32 mix, as float64 and int64 do: the kernel copies
    words), all read at `idx` in one launch that loads the index once:
    `[gather_along(x, idx, axis) for x in xs]`."""
    xs = list(xs)
    _check_along(xs, idx, axis, "gather_along_many")
    if xs[0].device.type == "cpu":
        return gather_along_many_twin(xs, idx, axis)
    return _launch_along(xs, idx, axis, "gather_along_many")


def walk_parents_twin(parent: torch.Tensor, start: torch.Tensor,
                      steps: int):
    """Plain PyTorch version of `walk_parents`: the walk as a loop of
    `steps` gathers."""
    node = start
    chain, valid = [], []
    for _ in range(steps):
        nid = node.clamp(min=0)
        ok = node >= 0
        chain.append(nid)
        valid.append(ok)
        node = torch.where(ok, gather_along_twin(parent, nid[:, None])[:, 0],
                           -1)
    if not chain:
        empty = lambda dt: torch.empty((start.shape[0], 0), dtype=dt,
                                       device=start.device)
        return empty(torch.int32), empty(torch.bool)
    return torch.stack(chain, dim=1), torch.stack(valid, dim=1)


def walk_parents(parent: torch.Tensor, start: torch.Tensor, steps: int):
    """K4's walk back through a parent arena (retrievePath,
    kino_astar.h:273-292, for B scenarios at once): parent [B, A] int32
    (arena id of each node's parent, -1 at a root), start [B] int32 ->
    (rev_ids [B, steps] int32, rev_valid [B, steps] bool).  Step s holds
    max(node, 0) and node >= 0, then node = parent[b, clip(node)] while
    node >= 0, else -1."""
    if parent.dim() != 2 or start.shape != (parent.shape[0],):
        raise ValueError("walk_parents: parent must be [B, A] and start "
                         f"[B], got {tuple(parent.shape)}, "
                         f"{tuple(start.shape)}")
    if parent.dtype != torch.int32 or start.dtype != torch.int32:
        raise TypeError("walk_parents: parent and start must be int32, got "
                        f"{parent.dtype}, {start.dtype}")
    if parent.shape[1] == 0 or steps < 0:
        raise ValueError("walk_parents: an empty arena or negative steps")
    if start.device != parent.device:
        raise ValueError(f"walk_parents: start on {start.device}, parent "
                         f"on {parent.device}")
    if parent.device.type == "cpu":
        return walk_parents_twin(parent, start, steps)
    if parent.device.type != "cuda":
        raise ValueError(f"walk_parents: no kernel for device "
                         f"{parent.device}")
    if not parent.is_contiguous() or not start.is_contiguous():
        raise ValueError("walk_parents: parent and start must be "
                         "contiguous")
    B = parent.shape[0]
    rev_ids = torch.empty((B, steps), dtype=torch.int32,
                          device=parent.device)
    rev_valid = torch.empty((B, steps), dtype=torch.bool,
                            device=parent.device)
    if B == 0 or steps == 0:
        return rev_ids, rev_valid
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(parent.device).cuda_stream
    err = lib.walk_parents(parent.data_ptr(), start.data_ptr(),
                           rev_ids.data_ptr(), rev_valid.data_ptr(), B,
                           parent.shape[1], steps, stream)
    _raise_on(lib, err, "walk_parents")
    launches["walk_parents"] += 1
    return rev_ids, rev_valid
