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
// Both clip the index into [0, N-1], as jnp.take(mode="clip") does.
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

// out[r, c] = x[r * s_row + c * s_col + clip(idx[r, c]) * s_gather]:
// axis 1 of x [R, N] is (s_row, s_col, s_gather) = (N, 0, 1);
// axis 0 of x [N, C] is (0, 1, C).
template <typename IdxT>
__global__ void gather_along_kernel(const uint32_t* __restrict__ x,
                                    const IdxT* __restrict__ idx,
                                    uint32_t* __restrict__ out,
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
// out [m, row_bytes].  word_bytes is the widest word (1, 4 or 16) that
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

// K4.  x holds 4-byte elements; idx and out are contiguous [rows, cols].
int gather_along(const void* x, const void* idx, void* out, long long rows,
                 int cols, long long n, long long s_row, long long s_col,
                 long long s_gather, int idx64, void* stream) {
  const long long total = rows * cols;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64) {
    gather_along_kernel<int64_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint32_t*)x, (const int64_t*)idx, (uint32_t*)out, total, cols,
        n, s_row, s_col, s_gather);
  } else {
    gather_along_kernel<int32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint32_t*)x, (const int32_t*)idx, (uint32_t*)out, total, cols,
        n, s_row, s_col, s_gather);
  }
  return (int)cudaGetLastError();
}

const char* gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
