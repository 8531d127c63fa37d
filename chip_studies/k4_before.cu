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
//   frontend/kino_init.py:plan becomes under a batch of scenarios.
//
// Both clip the index into [0, N-1], as jnp.take(mode="clip") does.  Both
// copy bits, so only an element's width matters: K3 moves a row as words
// of 1, 4, 8 or 16 bytes (an 8-byte table, float64 or int64, as 8- or
// 16-byte words), K4 is compiled for 4- and 8-byte elements.
//
// What bounds them: bytes.  Neither does arithmetic beyond the address; the
// least traffic is every index in once, every output element out once, and
// each table row that is touched in once.  Design: one thread per output
// word, consecutive threads on consecutive words of an output row, so index
// loads and stores coalesce and only the table read is scattered; rows whose
// byte length is a multiple of 16 move as 16-byte words.  The tables of the
// front end
// (40 KB of occupancy, 1.8 MB per scenario of dedup cells) stay in the 50 MB
// L2 across a launch, so the scattered reads are mostly L2 hits.  Nothing is
// rounded: results equal the plain PyTorch versions bit for bit.
//
// K3 on a byte table that fits in shared memory (one byte per row, at most
// kSmemTable bytes: the 40,000-byte occupancy table of the search) takes its
// own kernel, gather_bytes_smem_kernel.  With one thread per output byte the
// generic kernel spends a 32-byte L2 sector on every 1-byte table read and a
// 1-byte store per index.  Here a persistent grid (as many blocks as fit on
// the card at once) copies the table into each block's shared memory once,
// then walks the indices in grid-stride steps: a thread loads 16 bytes of
// indices (4 int32 or 2 int64), clips them, reads the table from shared
// memory and writes its 4 (or 2) output bytes as one store, with kUnroll such
// steps' loads in flight.  A scalar loop covers the head before the first
// 16-byte-aligned index, the tail, and the whole range when the output would
// be misaligned for the vector store (the caller says which).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename IdxT>
__device__ __forceinline__ long long clip_index(IdxT v, long long n) {
  const long long i = (long long)v;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// out[i, w] = table[clip(idx[i]), w], rows of `wv` words of type T.
template <typename T, typename IdxT>
__global__ void gather_rows_kernel(const T* __restrict__ table,
                                   const IdxT* __restrict__ idx,
                                   T* __restrict__ out, long long total,
                                   long long n, int wv) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long i = t / wv;
  const int w = (int)(t - i * wv);
  out[t] = table[clip_index(idx[i], n) * wv + w];
}

constexpr int kSmemTable = 48 * 1024;  // bytes of table the byte path takes
constexpr int kUnroll = 4;

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

// out[r, c] = x[r * s_row + c * s_col + clip(idx[r, c]) * s_gather]:
// axis 1 of x [R, N] is (s_row, s_col, s_gather) = (N, 0, 1);
// axis 0 of x [N, C] is (0, 1, C).  T is a 4- or 8-byte word.
template <typename T, typename IdxT>
__global__ void gather_along_kernel(const T* __restrict__ x,
                                    const IdxT* __restrict__ idx,
                                    T* __restrict__ out,
                                    long long total, int cols, long long n,
                                    long long s_row, long long s_col,
                                    long long s_gather) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long r = t / cols;
  const long long c = t - r * cols;
  out[t] = x[r * s_row + c * s_col + clip_index(idx[t], n) * s_gather];
}

template <typename T, typename IdxT>
int launch_along(const void* x, const void* idx, void* out, long long total,
                 int cols, long long n, long long s_row, long long s_col,
                 long long s_gather, cudaStream_t stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  gather_along_kernel<T, IdxT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, (const IdxT*)idx, (T*)out, total, cols, n, s_row, s_col,
      s_gather);
  return (int)cudaGetLastError();
}

template <typename T, typename IdxT>
int launch_rows(const void* table, const void* idx, void* out, long long m,
                long long n, int wv, cudaStream_t stream) {
  const long long total = m * wv;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  gather_rows_kernel<T, IdxT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)table, (const IdxT*)idx, (T*)out, total, n, wv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers; the
// caller checks device, dtype, shape and contiguity.

// K3.  table [n, row_bytes] bytes, idx [m] (int32, or int64 when idx64),
// out [m, row_bytes].  word_bytes is the widest word (1, 4, 8 or 16) that
// divides row_bytes and to which the caller found table and out aligned.
int gather_rows(const void* table, const void* idx, void* out, long long m,
                long long n, int row_bytes, int word_bytes, int idx64,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int wv = row_bytes / word_bytes;
  if (word_bytes * wv != row_bytes) return (int)cudaErrorInvalidValue;
  switch (word_bytes) {
    case 16:
      return idx64 ? launch_rows<uint4, int64_t>(table, idx, out, m, n, wv, s)
                   : launch_rows<uint4, int32_t>(table, idx, out, m, n, wv, s);
    case 8:
      return idx64 ? launch_rows<uint2, int64_t>(table, idx, out, m, n, wv, s)
                   : launch_rows<uint2, int32_t>(table, idx, out, m, n, wv, s);
    case 4:
      return idx64
                 ? launch_rows<uint32_t, int64_t>(table, idx, out, m, n, wv, s)
                 : launch_rows<uint32_t, int32_t>(table, idx, out, m, n, wv,
                                                  s);
    case 1:
      return idx64
                 ? launch_rows<uint8_t, int64_t>(table, idx, out, m, n, wv, s)
                 : launch_rows<uint8_t, int32_t>(table, idx, out, m, n, wv, s);
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

// K4.  x holds elem_bytes-byte elements (4 or 8); idx and out are
// contiguous [rows, cols].
int gather_along(const void* x, const void* idx, void* out, long long rows,
                 int cols, long long n, long long s_row, long long s_col,
                 long long s_gather, int elem_bytes, int idx64,
                 void* stream) {
  const long long total = rows * cols;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 8:
      return idx64 ? launch_along<uint64_t, int64_t>(x, idx, out, total, cols,
                                                     n, s_row, s_col,
                                                     s_gather, s)
                   : launch_along<uint64_t, int32_t>(x, idx, out, total, cols,
                                                     n, s_row, s_col,
                                                     s_gather, s);
    case 4:
      return idx64 ? launch_along<uint32_t, int64_t>(x, idx, out, total, cols,
                                                     n, s_row, s_col,
                                                     s_gather, s)
                   : launch_along<uint32_t, int32_t>(x, idx, out, total, cols,
                                                     n, s_row, s_col,
                                                     s_gather, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
