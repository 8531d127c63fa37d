// K3's word path as it was before its Hopper redesign: the generic row
// gather of csrc/gather.cu at the commit before the redesign, kept verbatim
// (this kernel, its launcher and its C entry only) so that chip_smoke.py
// and chip_studies/k3_ablation.py can time it beside the redesigned kernels
// in the same call.  On no path of the package.
//
// Design: one thread per output word, consecutive threads on consecutive
// words of an output row, so index loads and stores coalesce and only the
// table read is scattered; rows whose byte length is a multiple of 16 move
// as 16-byte words.

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

const char* gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
