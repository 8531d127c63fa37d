// K5 tanh_affine: out = tanh(x) * a + b, elementwise, f32, hand-written for
// Hopper (sm_90a).
//
// Replaces the JAX package's TPU probe A, experiments/e31_pallas.py:39 (the
// pl.pallas_call of `kern` at :35, tanh(x) * 2 + 1 on [256, 512] f32), the
// toolchain sanity check of that experiment.  It is on no path of either
// package.
//
// What bounds it: bytes.  One tanhf per 8 bytes moved is far below the
// card's arithmetic rate, so the least time is 2 * 4 * numel bytes over the
// DRAM rate.  Design: each thread moves 16-byte words (float4 in, float4
// out) in a grid-stride loop, consecutive threads on consecutive words; a
// scalar tail serves what is left when numel is not a multiple of 4 or the
// pointers are not 16-byte aligned.  tanhf is the accurate library function
// (no fast-math), and the multiply and the add round separately
// (-fmad=false), as torch.tanh(x) * a + b rounds them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void tanh_affine_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, long long n_vec,
                                   long long n, float a, float b) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* ov = reinterpret_cast<float4*>(out);
  for (long long i = t0; i < n_vec; i += stride) {
    float4 v = xv[i];
    v.x = tanhf(v.x) * a + b;
    v.y = tanhf(v.y) * a + b;
    v.z = tanhf(v.z) * a + b;
    v.w = tanhf(v.w) * a + b;
    ov[i] = v;
  }
  for (long long i = 4 * n_vec + t0; i < n; i += stride)
    out[i] = tanhf(x[i]) * a + b;
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream` and returns cudaGetLastError() (0 =
// launched).  x and out are device pointers to n contiguous floats.
int tanh_affine(const void* x, void* out, long long n, float a, float b,
                void* stream) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long n_vec = aligned ? n / 4 : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  // a few resident blocks per SM suffice for a grid-stride loop
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  tanh_affine_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n_vec, n, a, b);
  return (int)cudaGetLastError();
}

const char* elementwise_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
