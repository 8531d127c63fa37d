#!/usr/bin/env python3
"""Where K3's word path (`gather_rows` on every table but a shared-memory
byte table) spends its time, on one GPU: the kernel rebuilt with one part
of its design changed at a time, beside the kernel before the redesign
(`chip_studies/k3_before.cu`, one thread per output word and a 64-bit
division each), at the shapes the TPU probes and the main paths give them.

    python3 chip_studies/k3_ablation.py [--variants full,before,...]
                                        [--shapes TEXT,...] [--rounds N]

Shapes: the map build's two reads with the indices of its first dispatch
on the build phase's hill cloud; and uniform random rows, with
out-of-range and negative indices mixed in as `chip_smoke._edge_indices`
makes them: e1 C2 ([131,072] f32 by
2,785,280 int32; also over a [4096] f32 table and with the indices
sorted), e1 C ([32,768, 8] f32), e31 C ([1024, 128] f32 by
184,320), the split-bf16 items ([2,560,000, 12] int32 by 737,280), the
map build's cloud rows ([291,993, 4] f32 by 385,968) and bucket rows
([72,000, 140] int32 by 26,400), the bare grid's corner rows
([2,560,000, 4] f32 by 2,097,152), the tracking rows ([4096, 12] and
[4096, 6] f32 by 7,680 int64), a 24-byte row at e1 C2's count, and e1
C2 into views one element off 16-byte alignment (index and output, the
output alone).  `--shapes` keeps the shapes whose name holds one of the
texts, `--variants` the named variants, and `--rounds N` times each
selected variant N times in turn (one line a reading, with its round).

Variants (text edits of `uneven_planner_tpu_torch/csrc/gather.cu`, or
arguments of its C entry): `full`; `u1`, `u4`, `u8` (words a thread at
once on a large launch, in place of 2: `u1` is a word a thread on every
launch); `no_spread` (small launches too take 2 words a thread, a block
for every 2 * 256 words, in place of a word a thread);
`fill` (a persistent grid, no more blocks than fit on the card at once);
`carve_l1` (the kernel asks for the whole of L1, no shared memory);
`stream_idx` (index loads that do not allocate in L1, streaming output
stores); `l2_128` (the table read with an L2 prefetch of 128 bytes);
`l1_last` (the table read marked evict-last in L1); `off64` (64-bit
offsets); `warp_rows` (the design this one replaced: a warp takes a chunk
of up to 32 rows, lane l loads row l's index once and the lanes copying
that row's words take its offset with __shfl_sync); `before` (the kernel
before the redesign with its word rule: 16 bytes or the element's
width); `before_new_word` (the same kernel with the word rule of
`kernels.gather.row_word_bytes`); on e1 C2's shapes `cluster<C>x<T>`, a
table of 4-byte words spread over the shared memory of a thread-block
cluster of C blocks of T threads and read through distributed shared
memory.  A variant that does not compile is reported and left out.
Every variant is held to the plain twin bit for bit.  Prints the card,
the registers `nvcc -Xptxas -v` reports for each K3 function, the launch
floor (an empty kernel of 1 to 264 blocks, timed as the gathers are), and
one JSON line per variant and shape (`device_ms`, the median of
CUDA-graph replays, with the bound and the sector floor as
`chip_smoke.py` counts them).
"""

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the table word loaded through inline PTX with cache qualifiers `{q}`
LOAD_PTX = r'''template <typename T>
__device__ __forceinline__ T load_word(const T* p) {
  T v;
  if constexpr (sizeof(T) == 16) {
    uint4 r;
    asm("ld.global.nc{q}.v4.u32 {%0,%1,%2,%3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
    memcpy(&v, &r, 16);
  } else if constexpr (sizeof(T) == 8) {
    uint2 r;
    asm("ld.global.nc{q}.v2.u32 {%0,%1}, [%2];"
        : "=r"(r.x), "=r"(r.y) : "l"(p));
    memcpy(&v, &r, 8);
  } else if constexpr (sizeof(T) == 4) {
    uint32_t r;
    asm("ld.global.nc{q}.u32 %0, [%1];" : "=r"(r) : "l"(p));
    memcpy(&v, &r, 4);
  } else {
    unsigned short r;
    asm("ld.global.nc{q}.u8 %0, [%1];" : "=h"(r) : "l"(p));
    v = (T)r;
  }
  return v;
}
'''
LOAD_ANCHOR = """template <typename T>
__device__ __forceinline__ T load_word(const T* p) {
  return __ldg(p);
}
"""
# index loads that do not allocate in L1 (kept for the table) and output
# stores marked streaming
NO_ALLOC = r'''__device__ __forceinline__ int4 ldg_na(const int4* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0,%1,%2,%3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}
__device__ __forceinline__ longlong2 ldg_na(const longlong2* p) {
  longlong2 r;
  asm("ld.global.nc.L1::no_allocate.v2.s64 {%0,%1}, [%2];"
      : "=l"(r.x), "=l"(r.y) : "l"(p));
  return r;
}
__device__ __forceinline__ int32_t ldg_na(const int32_t* p) {
  int32_t r;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ int64_t ldg_na(const int64_t* p) {
  long long r;
  asm("ld.global.nc.L1::no_allocate.s64 %0, [%1];" : "=l"(r) : "l"(p));
  return r;
}
'''
STREAM = [(LOAD_ANCHOR, NO_ALLOC + LOAD_ANCHOR),
          ("clip_offset<Off>(__ldg(idx + r), n)",
           "clip_offset<Off>(ldg_na(idx + r), n)"),
          ("if (u * stride < total - t) out[t + u * stride] = x[u];",
           "if (u * stride < total - t) __stcs(out + t + u * stride, x[u]);")]
KERNEL = "(const void*)gather_rows_words_kernel<T, IdxT, Off, kRowsUnroll>"
LAUNCH = "  gather_rows_words_kernel<T, IdxT, Off, kRowsUnroll>\n      <<<"
CARVE_L1 = [(LAUNCH, f"  cudaFuncSetAttribute({KERNEL}, "
             "cudaFuncAttributePreferredSharedMemoryCarveout, 0);\n" + LAUNCH)]
# a persistent grid: no more blocks than fit on the card at once
FILL = [("  if (blocks > kMaxGridX) blocks = kMaxGridX;",
         "  int per_sm = 0;\n"
         "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, "
         f"{KERNEL}, kThreads, 0);\n"
         "  const long long fill = (long long)sms * "
         "(per_sm > 0 ? per_sm : 1);\n"
         "  if (blocks > fill) blocks = fill;")]
ptx = lambda q: [(LOAD_ANCHOR, LOAD_PTX.replace("{q}", q))]
unroll = lambda name, k: [(f"constexpr int {name} = ",
                           f"constexpr int {name} = {k};  // ")]

# The design the shipped kernel replaced: a warp takes a chunk of R rows
# (at most 32, or 32 * kRowsUnroll of one word; fewer where that gives the
# card kSpreadBlocks blocks an SM); lane l loads row l's index once and the
# lanes copying that row's words take its offset with __shfl_sync.
WARP_KERNEL = r"""template <typename T, typename IdxT, typename Off>
__global__ void __launch_bounds__(kThreads)
    gather_rows_words_kernel(const T* __restrict__ table,
                             const IdxT* __restrict__ idx,
                             T* __restrict__ out, Off m, Off n, int wv,
                             int R) {
  constexpr int U = kRowsUnroll;
  const int lane = threadIdx.x & 31;
  const Off warp = ((Off)blockIdx.x * kThreads + (Off)threadIdx.x) >> 5;
  const Off warps = ((Off)gridDim.x * kThreads) >> 5;
  if (wv == 1) {
    for (Off r0 = warp * R; r0 < m; r0 += warps * R) {
      const Off left = m - r0;
      const int rows = left < R ? (int)left : R;
      Off s[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = u * 32 + lane < rows;
        s[u] = ok[u] ? clip_offset<Off>(__ldg(idx + r0 + u * 32 + lane), n)
                     : Off(0);
      }
      T x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) x[u] = load_word(table + s[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) out[r0 + u * 32 + lane] = x[u];
      if (left <= warps * R) break;
    }
    return;
  }
  const int dq = 32 / wv, dr = 32 - dq * wv;
  const int r_lane = lane / wv, w_lane = lane - r_lane * wv;
  for (Off r0 = warp * R; r0 < m; r0 += warps * R) {
    const Off left = m - r0;
    Off src = 0;
    if (lane < R && lane < left)
      src = clip_offset<Off>(__ldg(idx + r0 + lane), n) * wv;
    const int words = (left < R ? (int)left : R) * wv;
    T* dst = out + r0 * wv;
    int r = r_lane, w = w_lane;
    for (int t0 = 0; t0 < words; t0 += 32 * U) {
      Off sp[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sp[u] = __shfl_sync(0xffffffffu, src, r & 31) + w;
        w += dr;
        r += dq;
        if (w >= wv) {
          w -= wv;
          ++r;
        }
      }
      T x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t0 + u * 32 + lane < words) x[u] = load_word(table + sp[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t0 + u * 32 + lane < words) dst[t0 + u * 32 + lane] = x[u];
    }
    if (left <= warps * R) break;
  }
}

"""
WARP_LAUNCH = r"""template <typename T, typename IdxT, typename Off>
int launch_rows(const void* table, const void* idx, void* out, long long m,
                long long n, int wv, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)kSpreadBlocks * sms * (kThreads / 32);
  long long rows = (m + warps - 1) / warps;
  const int most = wv == 1 ? 32 * kRowsUnroll : 32;
  rows = rows < most ? rows : most;
  const long long per_block = rows * (kThreads / 32);
  const long long need = (m + per_block - 1) / per_block;
  const unsigned blocks = (unsigned)(need < kMaxGridX ? need : kMaxGridX);
  gather_rows_words_kernel<T, IdxT, Off><<<blocks, kThreads, 0, stream>>>(
      (const T*)table, (const IdxT*)idx, (T*)out, (Off)m, (Off)n, wv,
      (int)rows);
  return (int)cudaGetLastError();
}

"""


def between(src, start, end):
    """The text of src from the first `start` up to (not with) the `end`
    after it."""
    a = src.index(start)
    return src[a:src.index(end, a)]


def warp_rows(src):
    kernel = between(src, "// out[i, :] = table[clip(idx[i]), :] for rows of "
                     "wv words T", "// Four (int32)")
    launch = between(src, "// K3's word path.  A small launch",
                     "template <typename T>\nint launch_rows_word")
    return [(kernel, WARP_KERNEL), (launch, WARP_LAUNCH)]


EDITS = {
    "full": [],
    "u1": unroll("kRowsUnroll", 1),
    "u4": unroll("kRowsUnroll", 4),
    "u8": unroll("kRowsUnroll", 8),
    "no_spread": [("  if (one <= spread) {", "  if (false) {"),
                  ("  if (blocks < spread) blocks = spread;\n", "")],
    "fill": FILL,
    "carve_l1": CARVE_L1,
    "stream_idx": STREAM,
    "l2_128": ptx(".L2::128B"),
    "l1_last": ptx(".L1::evict_last"),
    "warp_rows": warp_rows,
}
# variants run through an argument of the C entry rather than an edit
CALLS = {"off64": dict(off32=False)}

# A table of 4-byte words held in the shared memory of a thread block
# cluster, 2^k words a block, read through distributed shared memory
# (rows of e1 C2 only: int32 indices, 16-byte aligned, M a multiple of 4)
CLUSTER_SRC = r'''#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ int clip32(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__global__ void __launch_bounds__(1024)
    cluster_gather_kernel(const uint32_t* __restrict__ table,
                          const int* __restrict__ idx,
                          uint32_t* __restrict__ out, long long m, int n,
                          int slice_log2) {
  extern __shared__ __align__(16) uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = 1 << slice_log2;
  const int base = (int)cluster.block_rank() * S;
  for (int w = threadIdx.x; w < S; w += blockDim.x) {
    const int g = base + w;
    s[w] = g < n ? __ldg(table + g) : 0u;
  }
  cluster.sync();
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = m / 4;
  const int4* vin = reinterpret_cast<const int4*>(idx);
  uint4* vout = reinterpret_cast<uint4*>(out);
  const int mask = S - 1;
  for (long long v = g; v < nvec; v += stride) {
    const int4 r = __ldg(vin + v);
    const int a[4] = {clip32(r.x, n), clip32(r.y, n), clip32(r.z, n),
                      clip32(r.w, n)};
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = cluster.map_shared_rank(s, a[k] >> slice_log2)[a[k] & mask];
    vout[v] = make_uint4(o[0], o[1], o[2], o[3]);
  }
  for (long long i = nvec * 4 + g; i < m; i += stride) {
    const int a = clip32(idx[i], n);
    out[i] = cluster.map_shared_rank(s, a >> slice_log2)[a & mask];
  }
  cluster.sync();
}

}  // namespace

extern "C" int cluster_gather(const void* table, const void* idx, void* out,
                              long long m, int n, int csize, int threads,
                              void* stream) {
  int slice_log2 = 0;
  while (((long long)csize << slice_log2) < n) ++slice_log2;
  const size_t smem = sizeof(uint32_t) << slice_log2;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (csize > 8) {
    err = cudaFuncSetAttribute(cluster_gather_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, cluster_gather_kernel,
                                       &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(clusters * csize, 1, 1);
  err = cudaLaunchKernelEx(&cfg, cluster_gather_kernel,
                           (const uint32_t*)table, (const int*)idx,
                           (uint32_t*)out, m, n, slice_log2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
'''
# The launch floor: an empty kernel of `blocks` blocks of 256 threads.
FLOOR_SRC = r"""#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int launch_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
FLOOR_BLOCKS = (1, 12, 48, 96, 132, 264)


def declare_floor(lib):
    import ctypes
    lib.launch_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.launch_empty.restype = ctypes.c_int


# (cluster size, threads a block)
CLUSTERS = [(4, 1024), (4, 512), (8, 1024), (8, 512), (16, 512)]


def declare_cluster(lib):
    import ctypes
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cluster_gather.argtypes = [p, p, p, ll, i, i, i, p]
    lib.cluster_gather.restype = i


def registers(log: str) -> list:
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and "gather_rows" in name:
            out.append(dict(function=name, registers=int(m.group(1))))
            name = None
    return out


def main():
    import argparse
    import tempfile
    import torch
    import chip_smoke as cs
    from k1_ablation import edited
    from uneven_planner_tpu_torch.config import scene_config
    from uneven_planner_tpu_torch.terrain import io, mesh
    from k6_iterations import build_variants
    from uneven_planner_tpu_torch.kernels import gather
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    keep = lambda name: not args.variants or name in args.variants.split(",")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    src = open(os.path.join(ROOT, "uneven_planner_tpu_torch/csrc/gather.cu")
               ).read()
    sources = {name: edited(src, edits(src) if callable(edits) else edits)
               for name, edits in EDITS.items()}
    out_dir = os.path.join(ROOT, "uneven_planner_tpu_torch/_build/studies")
    logs, libs = {}, {}
    try:
        libs = build_variants(sources, out_dir, declare=gather._declare,
                              logs=logs)
    except RuntimeError as e:      # build them one by one, skipping failures
        print(json.dumps(dict(build_failed=str(e)[:3000])), flush=True)
        for name, text in sources.items():
            try:
                libs.update(build_variants({name: text}, out_dir,
                                           declare=gather._declare,
                                           logs=logs))
            except RuntimeError as e1:
                print(json.dumps(dict(variant=name,
                                      build_failed=str(e1)[-1500:])),
                      flush=True)
    libs.update(build_variants(
        {"k3_before": open(os.path.join(ROOT, "chip_studies/k3_before.cu"))
         .read()}, out_dir,
        declare=lambda lib: cs.before_library("k3_before")._declare(lib)))
    libs.update(build_variants({"floor": FLOOR_SRC}, out_dir,
                               declare=declare_floor))
    try:
        libs.update(build_variants({"cluster": CLUSTER_SRC}, out_dir,
                                   declare=declare_cluster))
    except RuntimeError as e:
        print(json.dumps(dict(variant="cluster",
                              build_failed=str(e)[-3000:])), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    for r in registers(logs["full"]):
        print(json.dumps(r), flush=True)

    dev = torch.device("cuda")

    def empty_out(table, idx, oo):
        """An output for idx's rows, `oo` elements into its buffer."""
        M = idx.shape[0]
        return torch.empty((M + oo,) + tuple(table.shape[1:]),
                           dtype=table.dtype, device=dev)[oo:]

    def rows(lib, table, idx, off32=True, oo=0):
        """K3's word path of `lib`, in the word the wrapper picks."""
        out = empty_out(table, idx, oo)
        elem = table.element_size()
        row = elem * (table.shape[1] if table.dim() == 2 else 1)
        word = gather.rows_word(row, elem, table.data_ptr(), out.data_ptr())
        err = lib.gather_rows(table.data_ptr(), idx.data_ptr(),
                              out.data_ptr(), idx.shape[0], table.shape[0],
                              row, word, int(idx.dtype == torch.int64),
                              int(off32),
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return out

    def before(table, idx, oo=0, new_word=False):
        """The kernel before the redesign, in its own word rule (16 bytes
        where row, table and output allow, else the element's) or in the
        word `rows_word` picks."""
        out = empty_out(table, idx, oo)
        elem = table.element_size()
        row = elem * (table.shape[1] if table.dim() == 2 else 1)
        if new_word:
            word = gather.rows_word(row, elem, table.data_ptr(),
                                    out.data_ptr())
        else:
            word = 16 if row % 16 == 0 and table.data_ptr() % 16 == 0 \
                and out.data_ptr() % 16 == 0 else elem
        err = libs["k3_before"].gather_rows(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            table.shape[0], row, word, int(idx.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return out

    stream = lambda: torch.cuda.current_stream().cuda_stream
    for blocks in FLOOR_BLOCKS if keep("floor") else ():
        def empty(blocks=blocks):
            err = libs["floor"].launch_empty(blocks, stream())
            if err:
                raise RuntimeError(f"empty launch failed ({err})")
        print(json.dumps(dict(floor_blocks=blocks,
                              device_ms=cs.device_ms(empty))), flush=True)

    gen = torch.Generator(device="cpu").manual_seed(5)
    rand = lambda shape: torch.randn(shape, generator=gen).to(dev)
    i32, i64 = torch.int32, torch.int64
    # the map build's two reads of its first dispatch, on the build phase's
    # hill cloud (its real indices: 1,440 distinct bucket rows)
    with tempfile.TemporaryDirectory() as tmp:
        mesh.save_pcd(os.path.join(tmp, "hillcloud.pcd"), cs.build_cloud()[0])
        points = io.load_scene_cloud("hillcloud", tmp)
    real = cs._build_k3_reads(points, scene_config("hill").map, dev)
    shapes = [
        ("build bucket rows (real): [72000, 140] int32", real[0][0],
         real[0][1]),
        ("build cloud rows (real): [291993, 4] f32", real[1][0], real[1][1]),
        ("e1 C2: [131072] f32", rand((131072,)), 2785280, i32),
        # two readings of what holds e1 C2: the same indices over a table
        # that the L1 holds (4096 words), and sorted (consecutive lanes on
        # neighbouring words)
        ("e1 C2 over a [4096] f32 table", rand((4096,)), 2785280, i32),
        ("e1 C2 sorted: [131072] f32", rand((131072,)), 2785280, i32),
        ("e1 C: [32768, 8] f32", rand((32768, 8)), 2785280, i32),
        ("e31 C: [1024, 128] f32", rand((1024, 128)), 184320, i32),
        ("split-bf16 items: [2560000, 12] int32",
         (rand((2560000, 12)) * 1e3).to(i32), 737280, i32),
        ("cloud rows: [291993, 4] f32", rand((291993, 4)), 385968, i32),
        ("bucket rows: [72000, 140] int32", (rand((72000, 140)) * 1e3)
         .to(i32), 26400, i32),
        ("corner rows: [2560000, 4] f32", rand((2560000, 4)), 2097152, i32),
        ("tracking rows: [4096, 12] f32", rand((4096, 12)), 7680, i64),
        ("tracking rows: [4096, 6] f32", rand((4096, 6)), 7680, i64),
        ("24-byte rows: [131072, 6] f32", rand((131072, 6)), 2785280, i32),
        ("e1 C2, index and output one element in: [131072] f32",
         rand((131072,)), 2785280, i32, (1, 1)),
        ("e1 C2, output one element in: [131072] f32", rand((131072,)),
         2785280, i32, (0, 1)),
    ]
    if args.shapes:
        shapes = [t for t in shapes
                  if any(k in t[0] for k in args.shapes.split(","))]
    for shape, table, *spec in shapes:
        N = table.shape[0]
        io = oo = 0
        if len(spec) == 1:
            idx, = spec
            M = idx.shape[0]
        else:
            M, idt, *offsets = spec
            io, oo = offsets[0] if offsets else (0, 0)
            idx = cs._edge_indices(N, (M + io,), 11, idt, dev)[io:]
        if "sorted" in shape:
            idx = idx.sort().values
        clipped = idx.long().clamp(0, N - 1)
        row = table.element_size() * (table.shape[1] if table.dim() == 2
                                      else 1)
        bound = (M * (idx.element_size() + row) + min(N, M) * row) \
            / cs.PEAK_BYTES * 1e3
        floor, _ = cs.k3_sector_floor_ms(clipped, row, idx.element_size())
        want = gather.gather_rows_twin(table, idx)
        runs = {"before": lambda: before(table, idx, oo),
                "before_new_word": lambda: before(table, idx, oo, True)}
        for name in EDITS:
            if name in libs:
                runs[name] = lambda lib=libs[name]: rows(lib, table, idx,
                                                         oo=oo)
        for name, kw in CALLS.items():
            runs[name] = lambda kw=kw: rows(libs["full"], table, idx, oo=oo,
                                            **kw)
        if shape.startswith("e1 C2") and not oo and "cluster" in libs:
            for csize, threads in CLUSTERS:
                def clustered(csize=csize, threads=threads):
                    out = torch.empty_like(want)
                    err = libs["cluster"].cluster_gather(
                        table.data_ptr(), idx.data_ptr(), out.data_ptr(), M,
                        N, csize, threads,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"cluster launch failed ({err})")
                    return out
                runs[f"cluster{csize}x{threads}"] = clustered
        runs = {name: run for name, run in runs.items()
                if keep(name) or (name.startswith("cluster")
                                  and keep("cluster"))}
        for name, run in list(runs.items()):
            try:
                got = run()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(json.dumps(dict(variant=name, shape=shape,
                                      failed=str(e))), flush=True)
                del runs[name]
                continue
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} on {shape} differs from the twin")
        for rnd in range(args.rounds):
            for name, run in runs.items():
                print(json.dumps(dict(variant=name, shape=shape, round=rnd,
                                      device_ms=cs.device_ms(run),
                                      bound_ms=bound, sector_floor_ms=floor)),
                      flush=True)
        del table, idx, clipped, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
