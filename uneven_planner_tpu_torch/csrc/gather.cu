// Index gathers of the planning front end, hand-written for Hopper (sm_90a).
//
// K3 gather_rows replaces the JAX package's TPU row-gather probes
//   experiments/e1_gather.py:exp_C_pallas_gather      (table [N, 8] f32),
//   experiments/e1_gather.py:exp_C2_pallas_gather_1d  (table [N] f32),
//   experiments/e31_pallas.py probe B (in-kernel jnp.take, [1024, 128] f32),
//   experiments/e31_pallas.py probe C (one-hot matrix product, same result),
//   all of which compute out[i, :] = table[idx[i], :].  The TPU could not
//   lower a gather inside a kernel, so the JAX package left these reads to
//   XLA (jnp.take(..., mode="clip") in terrain/grid.py:380, :433, :649).  In
//   the port it is the table read of is_occupancy_xy_batch, of the bare-grid
//   branch of terrain_sigma_cm, of get_terrain_batch and of the piece lookup
//   of minco.eval_traj.
// K4 gather_along replaces experiments/e5_dyngather.py:bench, i.e.
//   take_along_axis(x, idx, axis) on a 2-D array: what every a[idx] of
//   frontend/kino_init.py:plan becomes under a batch of scenarios.  The
//   same kernel reads up to kMaxArrays arrays of one shape at one index in
//   one launch (gather_along_many: the search's pool fields, its two dedup
//   tables at `cells`, the arena's x, y and yaw), and walk_parents_kernel
//   does the search's walk back through its arena in one launch.
//
// Both clip the index into [0, N-1], as jnp.take(mode="clip") does.  Both
// copy bits, so only an element's width matters: K3 moves a row as words
// of 1, 4, 8 or 16 bytes (an 8-byte table, float64 or int64, as 8- or
// 16-byte words), K4 is compiled for 4- and 8-byte elements.
//
// What bounds them: bytes.  Neither does arithmetic beyond the address; the
// least traffic is every index in once, every output element out once, and
// each table row that is touched in once.  A scattered row read from device
// memory moves whole 32-byte sectors, so where rows scatter over a table
// beyond the L2 the floor is the sectors the rows touch (a 4-byte row costs
// a sector; a 48-byte row at a 16-byte offset two).  Nothing is rounded:
// results equal the plain PyTorch versions bit for bit.
//
// K3's design.  A row moves as words of the widest width (16, 8 or 4
// bytes; else the element's) that divides both the row and the alignment
// of table and output, so a 24-byte row moves as three 8-byte words.
// gather_rows_words_kernel is a thread a word of the output, consecutive
// threads on consecutive words, so index loads and stores coalesce and
// only the table read scatters; the lanes of one row load the same index,
// which the warp serves as one request.  On a large launch a thread takes
// kRowsUnroll words a grid's stride apart and starts their table reads
// before its first store.  It divides once, in 32 bits where every offset
// fits (a 64-bit instantiation beside it), and steps its row and word by
// the stride's quotient and remainder, which the launcher divides: no
// division in the loop.  A small launch (a word a thread in at most
// kSpreadBlocks blocks an SM) takes a word a thread: it waits on two
// dependent reads, and further steps only lengthen its chain.
// What the card shows (PERF.md, chip_studies/k3_ablation.py): two words a
// thread run rows from a table the L1 holds, sorted rows and 24-byte rows
// 1.25-2x faster than one thread a word with a 64-bit division; rows that
// miss the L1 cost an L2 sector or a DRAM sector each, whose rate sets the
// time of every variant within 2% (four words a thread, a persistent
// grid, cache hints, all of L1, a warp sharing a row's index by shuffle;
// a table over a cluster's distributed shared memory was 2x slower).

// K4's design.  Most of the search's K4 launches read small pools at the
// launch floor, so the first gain is fewer launches: one for every array
// read at one index (21 launches a round become 6) and one for the walk
// that was a loop of ~800 small launches.  The one large read, the
// [B, 440,000] dedup tables at [B, 10,240] cells, gathers from tables far
// beyond the L2; a round's real cells repeat and cluster (~90,000 distinct
// of 2.6 M), so most reads hit the L2 and the cost is in issuing them.  A
// thread takes kAlongVec consecutive indices in one vector load and issues
// all their table reads (for every array) before its first store; the row
// comes from the grid's y dimension, so there is no 64-bit division;
// offsets are 32-bit where the arrays have fewer than 2^31 elements (a
// 64-bit instantiation beside it).  On the card (PERF.md,
// chip_studies/k4_ablation.py) four indices a thread halve the time of one
// on real cells; on uniform random cells, where every read is a DRAM
// sector, one index a thread is ~10% faster.  Evict-first hints on the
// index and output streams slowed one of the two large reads of a round as
// much as they sped up the other, and are not used.
//
// K3 on a byte table that fits in shared memory (one byte per row, at most
// kSmemTable bytes: the 40,000-byte occupancy table of the search) takes its
// own kernel, gather_bytes_smem_kernel: read from the L2, every 1-byte
// table read would cost a 32-byte sector.  Here a persistent grid (as many
// blocks as fit on the card at once) copies the table into each block's
// shared memory once,
// then walks the indices in grid-stride steps: a thread loads 16 bytes of
// indices (4 int32 or 2 int64), clips them, reads the table from shared
// memory and writes its 4 (or 2) output bytes as one store, with kUnroll such
// steps' loads in flight.  A scalar loop covers the head before the first
// 16-byte-aligned index, the tail, and the whole range when the output would
// be misaligned for the vector store (the caller says which).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

template <typename IdxT>
__device__ __forceinline__ long long clip_index(IdxT v, long long n) {
  const long long i = (long long)v;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

constexpr int kSmemTable = 48 * 1024;  // bytes of table the byte path takes
constexpr int kUnroll = 4;
// words a thread of K3's word path takes at once on a large launch, and
// the blocks an SM below which a launch is small: a word a thread
constexpr int kRowsUnroll = 2;
constexpr int kSpreadBlocks = 2;

// clip(v, 0, n - 1) as an offset: compared in the wider of the two types,
// so an int64 index outside 32 bits clips before it is narrowed
template <typename Off, typename IdxT>
__device__ __forceinline__ Off clip_offset(IdxT v, Off n) {
  using W = decltype(IdxT(0) + Off(0));
  const W w = (W)v;
  return w < 0 ? Off(0) : (w >= (W)n ? n - 1 : (Off)w);
}

// A word of the table: through the read-only data path.
template <typename T>
__device__ __forceinline__ T load_word(const T* p) {
  return __ldg(p);
}

// out[i, :] = table[clip(idx[i]), :] for rows of wv words T, as the total =
// m * wv words of the output: thread g takes words g + k * stride, k =
// 0, 1, ..., U of them at a time.  Word t is word w = t % wv of row r =
// t / wv; a thread divides once and steps (r, w) by the stride's quotient
// and remainder (q, s), which the launcher divides.  Off: int where every
// offset, and the last step beyond them, fits (the caller's promise), else
// long long.
template <typename T, typename IdxT, typename Off, int U>
__global__ void __launch_bounds__(kThreads)
    gather_rows_words_kernel(const T* __restrict__ table,
                             const IdxT* __restrict__ idx,
                             T* __restrict__ out, Off total, Off n, int wv,
                             Off q, int s) {
  const Off stride = (Off)gridDim.x * kThreads;
  Off t = (Off)blockIdx.x * kThreads + (Off)threadIdx.x;
  Off r = t / wv;
  int w = (int)(t - r * wv);
  // t + u * stride is compared as u * stride < total - t, and t advances
  // only while a word is left, so no offset passes total by a step
  for (; t < total; t += U * stride) {
    Off src[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      src[u] = u * stride < total - t
                   ? clip_offset<Off>(__ldg(idx + r), n) * wv + w
                   : Off(0);
      r += q;
      w += s;
      if (w >= wv) {
        w -= wv;
        ++r;
      }
    }
    T x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u * stride < total - t) x[u] = load_word(table + src[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u * stride < total - t) out[t + u * stride] = x[u];
    if (total - t <= U * stride) break;
  }
}

// Four (int32) or two (int64) clipped table bytes packed in index order into
// one little-endian word.
__device__ __forceinline__ uint32_t pack_bytes(const uint8_t* t, int4 v,
                                               long long n) {
  return (uint32_t)t[clip_index(v.x, n)] |
         ((uint32_t)t[clip_index(v.y, n)] << 8) |
         ((uint32_t)t[clip_index(v.z, n)] << 16) |
         ((uint32_t)t[clip_index(v.w, n)] << 24);
}

__device__ __forceinline__ uint16_t pack_bytes(const uint8_t* t, longlong2 v,
                                               long long n) {
  return (uint16_t)(t[clip_index(v.x, n)] |
                    ((uint32_t)t[clip_index(v.y, n)] << 8));
}

template <typename IdxT> struct ByteVec;
template <> struct ByteVec<int32_t> { using In = int4; using Out = uint32_t; };
template <> struct ByteVec<int64_t> {
  using In = longlong2;
  using Out = uint16_t;
};

// out[i] = table[clip(idx[i])] for a byte table of n <= kSmemTable bytes.
// Indices [0, head) and the tail after the last whole vector go one by one;
// the vectors start at idx + head, which the caller found 16-byte aligned,
// with out + head aligned to the vector's output word (head = m: no vector).
template <typename IdxT>
__global__ void __launch_bounds__(kThreads)
    gather_bytes_smem_kernel(const uint8_t* __restrict__ table,
                             const IdxT* __restrict__ idx,
                             uint8_t* __restrict__ out, long long m, int n,
                             long long head) {
  using In = typename ByteVec<IdxT>::In;
  using Out = typename ByteVec<IdxT>::Out;
  constexpr int K = 16 / sizeof(IdxT);  // indices per vector
  extern __shared__ __align__(16) uint8_t s_table[];
  const int tid = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(table) & 15) == 0) {
    const int words = n / 16;
    for (int w = tid; w < words; w += kThreads)
      reinterpret_cast<uint4*>(s_table)[w] =
          reinterpret_cast<const uint4*>(table)[w];
    for (int b = words * 16 + tid; b < n; b += kThreads) s_table[b] = table[b];
  } else {
    for (int b = tid; b < n; b += kThreads) s_table[b] = table[b];
  }
  __syncthreads();

  const long long g = blockIdx.x * (long long)kThreads + tid;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nvec = (m - head) / K;
  const long long tail = head + nvec * K;
  for (long long i = g; i < head; i += stride)
    out[i] = s_table[clip_index(idx[i], n)];
  for (long long i = tail + g; i < m; i += stride)
    out[i] = s_table[clip_index(idx[i], n)];

  const In* vin = reinterpret_cast<const In*>(idx + head);
  Out* vout = reinterpret_cast<Out*>(out + head);
  long long v = g;
  for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
    In r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(vin + v + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      vout[v + u * stride] = pack_bytes(s_table, r[u], n);
  }
  for (; v < nvec; v += stride) vout[v] = pack_bytes(s_table, vin[v], n);
}

template <typename IdxT>
int launch_bytes_smem(const void* table, const void* idx, void* out,
                      long long m, int n, long long head,
                      cudaStream_t stream) {
  const void* fn = (const void*)gather_bytes_smem_kernel<IdxT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      (size_t)n);
  if (err != cudaSuccess) return (int)err;
  // enough blocks to fill the card once, but no more than the work needs
  const long long need = (m + 4LL * kThreads - 1) / (4LL * kThreads);
  const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(need < fill ? need : fill);
  gather_bytes_smem_kernel<IdxT><<<blocks, kThreads, (size_t)n, stream>>>(
      (const uint8_t*)table, (const IdxT*)idx, (uint8_t*)out, m, n, head);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4: gather_along, gather_along_many and walk_parents
// ---------------------------------------------------------------------------

constexpr int kAlongThreads = 128;
constexpr int kAlongVec = 4;      // consecutive indices a thread takes
constexpr int kMaxArrays = 8;     // arrays one launch reads at one index
constexpr int kMaxGridY = 65535;

struct AlongArrays {
  const void* x[kMaxArrays];
  void* out[kMaxArrays];
};

// rows and cols of idx and of every out; x's length along the gathered
// axis and its strides (see gather_along_kernel)
struct AlongShape {
  long long rows, cols, n, s_row, s_col, s_gather;
};

// the kAlongVec indices at idx + base, all loads in flight: one 16-byte
// load of four int32, two of four int64 (VEC), else one load each for
// those before `cols` (the others read 0)
template <typename IdxT, bool VEC, typename Off>
__device__ __forceinline__ void load_indices(const IdxT* __restrict__ idx,
                                             Off base, Off c0, Off cols,
                                             IdxT (&v)[kAlongVec]) {
  if constexpr (VEC) {
    if constexpr (sizeof(IdxT) == 4) {
      const int4 q = *reinterpret_cast<const int4*>(idx + base);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      const longlong2* p = reinterpret_cast<const longlong2*>(idx + base);
      const longlong2 a = p[0], b = p[1];
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kAlongVec; ++k)
      v[k] = c0 + k < cols ? idx[base + k] : IdxT(0);
  }
}

// out_a[r, c] = x_a[r * s_row + c * s_col + clip(idx[r, c]) * s_gather] for
// the n_arrays arrays a: axis 1 of x [R, N] is (s_row, s_col, s_gather) =
// (N, 0, 1); axis 0 of x [N, C] is (0, 1, C).  idx and every out are
// contiguous [rows, cols].  The row r comes from the block's and the
// grid's y dimensions (a loop over rows beyond the grid's limit), the
// column from x: no division.  A block is kAlongThreads threads, as wide
// in x as a row needs (at least a warp) and as many rows high as that
// leaves, so short rows share a block.
// Each thread takes kAlongVec consecutive indices, loads them at once,
// issues every array's table reads, and only then stores.  T is a 4- or
// 8-byte word; Off is int where every offset fits (the wrapper's promise),
// long long otherwise.  VEC: cols is a multiple of kAlongVec and idx and
// the outputs are 16-byte aligned, so indices and outputs move as vectors.
template <typename T, typename IdxT, typename Off, bool VEC>
__global__ void __launch_bounds__(kAlongThreads)
    gather_along_kernel(AlongArrays a, int n_arrays,
                        const IdxT* __restrict__ idx, Off rows, Off cols,
                        Off n, Off s_row, Off s_col, Off s_gather) {
  const Off c0 = ((Off)blockIdx.x * blockDim.x + (Off)threadIdx.x) *
                 kAlongVec;
  if (c0 >= cols) return;
  for (Off r = (Off)blockIdx.y * blockDim.y + threadIdx.y; r < rows;
       r += (Off)gridDim.y * blockDim.y) {
    const Off base = r * cols + c0;
    IdxT raw[kAlongVec];
    load_indices<IdxT, VEC, Off>(idx, base, c0, cols, raw);
    Off src[kAlongVec];
#pragma unroll
    for (int k = 0; k < kAlongVec; ++k)
      src[k] = r * s_row + (c0 + k) * s_col + clip_offset<Off>(raw[k], n) *
                                                  s_gather;
    T v[kMaxArrays][kAlongVec];
#pragma unroll
    for (int j = 0; j < kMaxArrays; ++j) {
      if (j >= n_arrays) break;
      const T* x = static_cast<const T*>(a.x[j]);
#pragma unroll
      for (int k = 0; k < kAlongVec; ++k)
        if (VEC || c0 + k < cols) v[j][k] = __ldg(x + src[k]);
    }
#pragma unroll
    for (int j = 0; j < kMaxArrays; ++j) {
      if (j >= n_arrays) break;
      T* out = static_cast<T*>(a.out[j]) + base;
      if constexpr (VEC && sizeof(T) == 4) {
        *reinterpret_cast<uint4*>(out) =
            make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]);
      } else if constexpr (VEC) {
        ulonglong2* o = reinterpret_cast<ulonglong2*>(out);
        o[0] = make_ulonglong2(v[j][0], v[j][1]);
        o[1] = make_ulonglong2(v[j][2], v[j][3]);
      } else {
#pragma unroll
        for (int k = 0; k < kAlongVec; ++k)
          if (c0 + k < cols) out[k] = v[j][k];
      }
    }
  }
}

template <typename T, typename IdxT, typename Off, bool VEC>
int launch_along(const AlongArrays& a, int n_arrays, const void* idx,
                 const AlongShape& sh, cudaStream_t stream) {
  int tx = kAlongThreads;  // threads along a row: the fewest that cover it
  while (tx > 32 && (long long)(tx / 2) * kAlongVec >= sh.cols) tx /= 2;
  const int ty = kAlongThreads / tx;
  const long long bx = (sh.cols + (long long)tx * kAlongVec - 1) /
                       ((long long)tx * kAlongVec);
  const long long by = (sh.rows + ty - 1) / ty;
  if (bx > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bx, (unsigned)(by < kMaxGridY ? by : kMaxGridY));
  const dim3 block((unsigned)tx, (unsigned)ty);
  gather_along_kernel<T, IdxT, Off, VEC><<<grid, block, 0, stream>>>(
      a, n_arrays, (const IdxT*)idx, (Off)sh.rows, (Off)sh.cols, (Off)sh.n,
      (Off)sh.s_row, (Off)sh.s_col, (Off)sh.s_gather);
  return (int)cudaGetLastError();
}

template <typename T, typename IdxT>
int launch_along_off(const AlongArrays& a, int n_arrays, const void* idx,
                     const AlongShape& sh, bool off32, bool vec,
                     cudaStream_t s) {
  if (off32)
    return vec ? launch_along<T, IdxT, int, true>(a, n_arrays, idx, sh, s)
               : launch_along<T, IdxT, int, false>(a, n_arrays, idx, sh, s);
  return vec ? launch_along<T, IdxT, long long, true>(a, n_arrays, idx, sh, s)
             : launch_along<T, IdxT, long long, false>(a, n_arrays, idx, sh,
                                                       s);
}

// The walk back through the search's arena (kino_init.py: retrievePath):
// for s < steps, rev_ids[b, s] = max(node, 0) and rev_valid[b, s] =
// node >= 0, then node = parent[b, clip(node)] while node >= 0, else -1.
// The walk is a chain of dependent loads, as long as the path.  A warp per
// scenario: every lane walks the same chain (one load a step, broadcast to
// the warp), lane l keeps the node of step base + l, and every 32 steps the
// warp stores 32 consecutive ids and flags at once.  Once node < 0 the
// rest of the row is (0, false), stored 32 at a time without loads.  (A
// thread per scenario spent its time on the row's scattered one-element
// stores, on two SMs: chip_studies/k4_ablation.py.)
constexpr int kWalkWarps = kAlongThreads / 32;

__global__ void __launch_bounds__(kAlongThreads)
    walk_parents_kernel(const int* __restrict__ parent,
                        const int* __restrict__ start,
                        int* __restrict__ rev_ids,
                        uint8_t* __restrict__ rev_valid, int batch,
                        long long arena, int steps) {
  const int b = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= batch) return;
  const int* row = parent + (long long)b * arena;
  int* ids = rev_ids + (long long)b * steps;
  uint8_t* valid = rev_valid + (long long)b * steps;
  int node = __ldg(start + b);
  for (int base = 0; base < steps; base += 32) {
    int mine = 0;
    bool ok = false;
    for (int k = 0; k < 32 && node >= 0; ++k) {
      const int s = base + k;
      if (s >= steps) break;
      if (lane == k) {
        mine = node;
        ok = true;
      }
      node = s + 1 < steps ? __ldg(row + (node < arena ? node : arena - 1))
                           : -1;
    }
    if (base + lane < steps) {
      ids[base + lane] = mine;
      valid[base + lane] = ok;
    }
  }
}

// the most blocks a K3 launch takes; its loop strides over the rest
constexpr long long kMaxGridX = 1LL << 16;
// How far K3's word offsets may pass beyond m * wv or n * wv: a row
// advanced by the last step, at most kRowsUnroll strides of the grid
constexpr long long kOffSlack = kRowsUnroll * kMaxGridX * kThreads;

// K3's word path.  A small launch, a word a thread in at most
// kSpreadBlocks blocks an SM, takes U = 1: it waits on its index and table
// reads, and the shortest chain is the fastest.  A larger one takes U =
// kRowsUnroll words a thread, a block for every U * kThreads words but at
// least kSpreadBlocks an SM, at most kMaxGridX, the loop striding over the
// rest.
template <typename T, typename IdxT, typename Off>
int launch_rows(const void* table, const void* idx, void* out, long long m,
                long long n, int wv, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long total = m * wv;
  const long long one = (total + kThreads - 1) / kThreads;
  const long long spread = (long long)kSpreadBlocks * sms;
  if (one <= spread) {
    const long long stride = one * kThreads;
    gather_rows_words_kernel<T, IdxT, Off, 1>
        <<<(unsigned)one, kThreads, 0, stream>>>(
            (const T*)table, (const IdxT*)idx, (T*)out, (Off)total, (Off)n,
            wv, (Off)(stride / wv), (int)(stride % wv));
    return (int)cudaGetLastError();
  }
  long long blocks = (one + kRowsUnroll - 1) / kRowsUnroll;
  if (blocks < spread) blocks = spread;
  if (blocks > kMaxGridX) blocks = kMaxGridX;
  const long long stride = blocks * kThreads;
  gather_rows_words_kernel<T, IdxT, Off, kRowsUnroll>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          (const T*)table, (const IdxT*)idx, (T*)out, (Off)total, (Off)n,
          wv, (Off)(stride / wv), (int)(stride % wv));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows_word(const void* table, const void* idx, void* out,
                     long long m, long long n, int wv, int idx64, int off32,
                     cudaStream_t s) {
  if (idx64)
    return off32 ? launch_rows<T, int64_t, int>(table, idx, out, m, n, wv, s)
                 : launch_rows<T, int64_t, long long>(table, idx, out, m, n,
                                                      wv, s);
  return off32 ? launch_rows<T, int32_t, int>(table, idx, out, m, n, wv, s)
               : launch_rows<T, int32_t, long long>(table, idx, out, m, n,
                                                    wv, s);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers; the
// caller checks device, dtype, shape and contiguity.

// K3.  table [n, row_bytes] bytes, idx [m] (int32, or int64 when idx64),
// out [m, row_bytes], m >= 1.  word_bytes (16, 8, 4 or 1) divides row_bytes
// and the alignment of table and out.  off32: 32-bit offsets (refused
// where an offset would not fit).
int gather_rows(const void* table, const void* idx, void* out, long long m,
                long long n, int row_bytes, int word_bytes, int idx64,
                int off32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int wv = word_bytes > 0 ? row_bytes / word_bytes : 0;
  if (m <= 0 || n <= 0 || wv <= 0 || word_bytes * wv != row_bytes)
    return (int)cudaErrorInvalidValue;
  if (off32 && (m > n ? m : n) * wv + kOffSlack > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  switch (word_bytes) {
    case 16:
      return launch_rows_word<uint4>(table, idx, out, m, n, wv, idx64, off32,
                                     s);
    case 8:
      return launch_rows_word<uint2>(table, idx, out, m, n, wv, idx64, off32,
                                     s);
    case 4:
      return launch_rows_word<uint32_t>(table, idx, out, m, n, wv, idx64,
                                        off32, s);
    case 1:
      return launch_rows_word<uint8_t>(table, idx, out, m, n, wv, idx64,
                                       off32, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K3 on a byte table of n <= gather_smem_table_bytes() bytes, one byte per
// row: idx [m] (int32, or int64 when idx64), out [m] bytes.  head is the
// count of indices before idx + head is 16-byte aligned, with out + head
// aligned to 4 bytes (int32) or 2 (int64); head = m sends every index
// through the scalar loop.
int gather_rows_bytes_smem(const void* table, const void* idx, void* out,
                           long long m, int n, long long head, int idx64,
                           void* stream) {
  if (n <= 0 || n > kSmemTable || head < 0 || head > m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return idx64 ? launch_bytes_smem<int64_t>(table, idx, out, m, n, head, s)
               : launch_bytes_smem<int32_t>(table, idx, out, m, n, head, s);
}

// K4.  n_arrays (1 to kMaxArrays) arrays xs of elem_bytes-byte elements
// (4 or 8), one shape, read at one index array idx [rows, cols] (int32, or
// int64 when idx64) into outs, each contiguous [rows, cols].  off32: every
// offset into x, idx and out fits in an int (the caller's promise, from the
// sizes); vec: cols % 4 == 0 and idx and outs 16-byte aligned.
int gather_along(const void* const* xs, void* const* outs, int n_arrays,
                 const void* idx, long long rows, long long cols, long long n,
                 long long s_row, long long s_col, long long s_gather,
                 int elem_bytes, int idx64, int off32, int vec,
                 void* stream) {
  if (n_arrays < 1 || n_arrays > kMaxArrays || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  if (vec && cols % kAlongVec) return (int)cudaErrorInvalidValue;
  AlongArrays a = {};
  for (int j = 0; j < n_arrays; ++j) {
    a.x[j] = xs[j];
    a.out[j] = outs[j];
  }
  const AlongShape sh = {rows, cols, n, s_row, s_col, s_gather};
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 8:
      return idx64 ? launch_along_off<unsigned long long, long long>(
                         a, n_arrays, idx, sh, off32, vec, s)
                   : launch_along_off<unsigned long long, int>(
                         a, n_arrays, idx, sh, off32, vec, s);
    case 4:
      return idx64 ? launch_along_off<unsigned int, long long>(
                         a, n_arrays, idx, sh, off32, vec, s)
                   : launch_along_off<unsigned int, int>(a, n_arrays, idx,
                                                         sh, off32, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K4's walk: parent [batch, arena] int32, start [batch] int32, rev_ids
// [batch, steps] int32, rev_valid [batch, steps] bytes (0 or 1).
int walk_parents(const void* parent, const void* start, void* rev_ids,
                 void* rev_valid, int batch, long long arena, int steps,
                 void* stream) {
  if (batch <= 0 || arena <= 0 || steps <= 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((batch + kWalkWarps - 1) /
                                     kWalkWarps);
  walk_parents_kernel<<<blocks, kAlongThreads, 0, (cudaStream_t)stream>>>(
      (const int*)parent, (const int*)start, (int*)rev_ids,
      (uint8_t*)rev_valid, batch, arena, steps);
  return (int)cudaGetLastError();
}

const char* gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
