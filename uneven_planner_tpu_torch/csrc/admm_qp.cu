// K6 admm_iterations: the iteration loop of the batched dense ADMM QP solver
// (OSQP's operator splitting), hand-written for Hopper (sm_90a).
//
// It stands where the JAX package did its kernel-level work on the tracking
// path, uneven_planner_tpu/solver/admm_qp.py:295-370: the loop body of
// solve_qp (with adaptive rho off) under the fixed-trip masked scan, for
// which that package wrote a pure-JAX Cholesky and an explicit SPD inverse
// (:29-121) so that one iteration is six dense products and a few vector
// updates.  Per lane (one QP), from the state (x, z, y, it):
//
//   rhs  = sigma x - q + A'(rho z - y)       x~ = Minv rhs       z~ = A x~
//   x+   = alpha x~ + (1 - alpha) x          zr = alpha z~ + (1 - alpha) z
//   z+   = clip(zr + y / rho, l, u)          y+ = y + rho (zr - z+)
//   r_prim = max|Einv (A x+ - z+)|
//   r_dual = max|cinv Dinv (P x+ + q + A'y+)|
//   done   = (r_prim < eps_abs + eps_rel prim_norm
//             and r_dual < eps_abs + eps_rel dual_norm) or it >= max_iter
//
// repeated for at most n_iters further iterations or until done.
//
// What bounds it: operations, and of those the latency of a dependent chain,
// not the card's arithmetic rate: 2 (4 m n + 2 n^2) flops per iteration on
// 2 n^2 + m n resident words, with six products that each wait for the one
// before.  The one-off traffic (the lane's three matrices in, the state in
// and out) is small beside 400 iterations.  Design: one thread block per
// lane; Minv, P and A are staged once into shared memory (row stride padded
// to an odd number of words, so a thread per row reads without bank
// conflicts, and a thread per column reads consecutive words); every
// product gives one thread one output row; the three products of the
// residuals run side by side on disjoint threads; the four max-reductions
// are warp shuffles and one pass over the warps' partial results; the loop,
// the termination test and the per-lane freeze are inside the kernel, so a
// QP pass is one launch whatever the iteration count.  At n = 60, m = 118
// (the condensed tracking QP) a lane takes 64,368 bytes of shared memory,
// above the 48 KB default, so the launcher opts in to the size it needs and
// refuses a shape beyond the 227 KB a block can have.
//
// Sums run in index order in f32 with separate multiply and add
// (-fmad=false); a library product sums in another order, so the plain
// PyTorch version agrees to rounding, not bit for bit.  max and clip
// propagate NaN, as jnp.max and jnp.clip do: a lane with a non-finite
// factorisation runs to its limit and returns NaN, which the caller detects.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShared = 232448;  // bytes a block can have on sm_90

struct AdmmArgs {
  // per-lane data, contiguous: P, minv [n, n]; A [m, n]; q, dinv [n];
  // l, u, rho, einv [m]; cinv scalar
  const float *P, *q, *A, *l, *u, *rho, *minv, *dinv, *einv, *cinv;
  // state in and out: x [n], z, y [m], it, residuals, norms, done
  const float *x_in, *z_in, *y_in;
  const int* it_in;
  const float *rp_in, *rd_in, *pn_in, *dn_in;
  const unsigned char* done_in;
  float *x, *z, *y;
  int* it;
  float *rp, *rd, *pn, *dn;
  unsigned char* done;
  int n, m, ld;
  float sigma, alpha, one_minus_alpha, eps_abs, eps_rel;
  int max_iter, n_iters;
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Words of shared memory a lane needs: the three matrices at row stride ld,
// eight n-vectors, nine m-vectors and the reduction scratch (the carve-up at
// the top of the kernel).
__host__ __device__ inline long long shared_words(int n, int m, int ld) {
  return 2LL * n * ld + (long long)m * ld + 8LL * n + 9LL * m + 4 * kWarps;
}

__global__ void __launch_bounds__(kThreads) admm_kernel(AdmmArgs a) {
  extern __shared__ float sm[];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int n = a.n, m = a.m, ld = a.ld;
  const long long on = (long long)lane * n, om = (long long)lane * m;

  int it = a.it_in[lane];
  bool done = a.done_in[lane] != 0;
  float r_prim = a.rp_in[lane], r_dual = a.rd_in[lane];
  float prim_norm = a.pn_in[lane], dual_norm = a.dn_in[lane];

  if (done || a.n_iters <= 0) {  // a frozen lane passes through unchanged
    for (int j = tid; j < n; j += kThreads) a.x[on + j] = a.x_in[on + j];
    for (int i = tid; i < m; i += kThreads) {
      a.z[om + i] = a.z_in[om + i];
      a.y[om + i] = a.y_in[om + i];
    }
    if (tid == 0) {
      a.it[lane] = it;
      a.rp[lane] = r_prim;
      a.rd[lane] = r_dual;
      a.pn[lane] = prim_norm;
      a.dn[lane] = dual_norm;
      a.done[lane] = done ? 1 : 0;
    }
    return;
  }

  float* s_minv = sm;
  float* s_P = s_minv + n * ld;
  float* s_A = s_P + n * ld;
  float* s_q = s_A + m * ld;
  float* s_x = s_q + n;
  float* s_rhs = s_x + n;
  float* s_xt = s_rhs + n;
  float* s_cd = s_xt + n;    // cinv * dinv
  float* s_qu = s_cd + n;    // cinv * dinv * q
  float* s_pxu = s_qu + n;
  float* s_atyu = s_pxu + n;
  float* s_l = s_atyu + n;
  float* s_u = s_l + m;
  float* s_rho = s_u + m;
  float* s_einv = s_rho + m;
  float* s_z = s_einv + m;
  float* s_y = s_z + m;
  float* s_v = s_y + m;
  float* s_axu = s_v + m;
  float* s_zu = s_axu + m;
  float* s_red = s_zu + m;   // [4][kWarps]

  // ---- stage the lane once
  {
    const float* gm = a.minv + on * n;
    const float* gp = a.P + on * n;
    for (int t = tid; t < n * n; t += kThreads) {
      const int r = t / n, c = t - r * n;
      s_minv[r * ld + c] = gm[t];
      s_P[r * ld + c] = gp[t];
    }
    const float* ga = a.A + om * n;
    for (int t = tid; t < m * n; t += kThreads) {
      const int r = t / n, c = t - r * n;
      s_A[r * ld + c] = ga[t];
    }
    const float cinv = a.cinv[lane];
    for (int j = tid; j < n; j += kThreads) {
      const float q = a.q[on + j];
      const float cd = cinv * a.dinv[on + j];
      s_q[j] = q;
      s_cd[j] = cd;
      s_qu[j] = cd * q;
      s_x[j] = a.x_in[on + j];
    }
    for (int i = tid; i < m; i += kThreads) {
      s_l[i] = a.l[om + i];
      s_u[i] = a.u[om + i];
      s_rho[i] = a.rho[om + i];
      s_einv[i] = a.einv[om + i];
      s_z[i] = a.z_in[om + i];
      s_y[i] = a.y_in[om + i];
    }
  }
  __syncthreads();

  const float sigma = a.sigma, alpha = a.alpha, oma = a.one_minus_alpha;
  for (int k = 0; k < a.n_iters && !done; ++k) {
    // v = rho z - y
    for (int i = tid; i < m; i += kThreads)
      s_v[i] = s_rho[i] * s_z[i] - s_y[i];
    __syncthreads();
    // rhs = sigma x - q + A'v  (thread per column of A)
    for (int j = tid; j < n; j += kThreads) {
      float acc = 0.0f;
      for (int i = 0; i < m; ++i) acc += s_A[i * ld + j] * s_v[i];
      s_rhs[j] = (sigma * s_x[j] - s_q[j]) + acc;
    }
    __syncthreads();
    // x~ = Minv rhs  (thread per row)
    for (int j = tid; j < n; j += kThreads) {
      const float* row = s_minv + j * ld;
      float acc = 0.0f;
      for (int c = 0; c < n; ++c) acc += row[c] * s_rhs[c];
      s_xt[j] = acc;
    }
    __syncthreads();
    // z~ = A x~ and the z, y updates (thread per row of A); x update
    for (int i = tid; i < m; i += kThreads) {
      const float* row = s_A + i * ld;
      float acc = 0.0f;
      for (int c = 0; c < n; ++c) acc += row[c] * s_xt[c];
      const float rho = s_rho[i], y = s_y[i];
      const float z_relax = alpha * acc + oma * s_z[i];
      const float z_new =
          nan_min(nan_max(z_relax + y / rho, s_l[i]), s_u[i]);
      s_y[i] = y + rho * (z_relax - z_new);
      s_z[i] = z_new;
      s_zu[i] = s_einv[i] * z_new;
    }
    for (int j = tid; j < n; j += kThreads)
      s_x[j] = alpha * s_xt[j] + oma * s_x[j];
    __syncthreads();
    // unscaled A x+, P x+ and A'y+, side by side on disjoint threads
    for (int t = tid; t < m + 2 * n; t += kThreads) {
      float acc = 0.0f;
      if (t < m) {
        const float* row = s_A + t * ld;
        for (int c = 0; c < n; ++c) acc += row[c] * s_x[c];
        s_axu[t] = s_einv[t] * acc;
      } else if (t < m + n) {
        const int j = t - m;
        const float* row = s_P + j * ld;
        for (int c = 0; c < n; ++c) acc += row[c] * s_x[c];
        s_pxu[j] = s_cd[j] * acc;
      } else {
        const int j = t - m - n;
        for (int i = 0; i < m; ++i) acc += s_A[i * ld + j] * s_y[i];
        s_atyu[j] = s_cd[j] * acc;
      }
    }
    __syncthreads();
    // residuals and norms: block max of four quantities
    float rp = 0.0f, rd = 0.0f, pn = 0.0f, dn = 0.0f;
    for (int i = tid; i < m; i += kThreads) {
      const float ax = s_axu[i], zu = s_zu[i];
      rp = nan_max(rp, fabsf(ax - zu));
      pn = nan_max(pn, nan_max(fabsf(ax), fabsf(zu)));
    }
    for (int j = tid; j < n; j += kThreads) {
      const float px = s_pxu[j], aty = s_atyu[j], qu = s_qu[j];
      rd = nan_max(rd, fabsf((px + qu) + aty));
      dn = nan_max(dn, nan_max(nan_max(fabsf(px), fabsf(aty)), fabsf(qu)));
    }
    rp = warp_max(rp);
    rd = warp_max(rd);
    pn = warp_max(pn);
    dn = warp_max(dn);
    if ((tid & 31) == 0) {
      const int w = tid >> 5;
      s_red[0 * kWarps + w] = rp;
      s_red[1 * kWarps + w] = rd;
      s_red[2 * kWarps + w] = pn;
      s_red[3 * kWarps + w] = dn;
    }
    __syncthreads();
    rp = s_red[0];
    rd = s_red[kWarps];
    pn = s_red[2 * kWarps];
    dn = s_red[3 * kWarps];
    for (int w = 1; w < kWarps; ++w) {
      rp = nan_max(rp, s_red[0 * kWarps + w]);
      rd = nan_max(rd, s_red[1 * kWarps + w]);
      pn = nan_max(pn, s_red[2 * kWarps + w]);
      dn = nan_max(dn, s_red[3 * kWarps + w]);
    }
    r_prim = rp;
    r_dual = rd;
    prim_norm = pn;
    dual_norm = dn;
    const bool converged = (rp < a.eps_abs + a.eps_rel * pn) &&
                           (rd < a.eps_abs + a.eps_rel * dn);
    it += 1;
    done = converged || (it >= a.max_iter);
    // s_red is written again only after the next iteration's barriers
  }

  for (int j = tid; j < n; j += kThreads) a.x[on + j] = s_x[j];
  for (int i = tid; i < m; i += kThreads) {
    a.z[om + i] = s_z[i];
    a.y[om + i] = s_y[i];
  }
  if (tid == 0) {
    a.it[lane] = it;
    a.rp[lane] = r_prim;
    a.rd[lane] = r_dual;
    a.pn[lane] = prim_norm;
    a.dn[lane] = dual_norm;
    a.done[lane] = done ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one lane of an (n, m) QP needs.
long long admm_shared_bytes(int n, int m) {
  return 4LL * shared_words(n, m, n | 1);
}

// Enqueues one kernel on `stream`, one block per lane, and returns the
// first CUDA error (0 = launched).  Pointers are device pointers to
// contiguous f32 (it: int32, done: one byte per lane); the caller checks
// device, dtype, shape and contiguity.  A shape whose lane does not fit in
// a block's shared memory is refused with cudaErrorInvalidValue.
int admm_iterations(const void* P, const void* q, const void* A,
                    const void* l, const void* u, const void* rho,
                    const void* minv, const void* dinv, const void* einv,
                    const void* cinv, const void* x_in, const void* z_in,
                    const void* y_in, const void* it_in, const void* rp_in,
                    const void* rd_in, const void* pn_in, const void* dn_in,
                    const void* done_in, void* x, void* z, void* y, void* it,
                    void* rp, void* rd, void* pn, void* dn, void* done,
                    int batch, int n, int m, float sigma, float alpha,
                    float one_minus_alpha, float eps_abs, float eps_rel,
                    int max_iter, int n_iters, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const long long bytes = admm_shared_bytes(n, m);
  if (bytes > kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  AdmmArgs a;
  a.P = (const float*)P;
  a.q = (const float*)q;
  a.A = (const float*)A;
  a.l = (const float*)l;
  a.u = (const float*)u;
  a.rho = (const float*)rho;
  a.minv = (const float*)minv;
  a.dinv = (const float*)dinv;
  a.einv = (const float*)einv;
  a.cinv = (const float*)cinv;
  a.x_in = (const float*)x_in;
  a.z_in = (const float*)z_in;
  a.y_in = (const float*)y_in;
  a.it_in = (const int*)it_in;
  a.rp_in = (const float*)rp_in;
  a.rd_in = (const float*)rd_in;
  a.pn_in = (const float*)pn_in;
  a.dn_in = (const float*)dn_in;
  a.done_in = (const unsigned char*)done_in;
  a.x = (float*)x;
  a.z = (float*)z;
  a.y = (float*)y;
  a.it = (int*)it;
  a.rp = (float*)rp;
  a.rd = (float*)rd;
  a.pn = (float*)pn;
  a.dn = (float*)dn;
  a.done = (unsigned char*)done;
  a.n = n;
  a.m = m;
  a.ld = n | 1;
  a.sigma = sigma;
  a.alpha = alpha;
  a.one_minus_alpha = one_minus_alpha;
  a.eps_abs = eps_abs;
  a.eps_rel = eps_rel;
  a.max_iter = max_iter;
  a.n_iters = n_iters;
  admm_kernel<<<(unsigned)batch, kThreads, (size_t)bytes,
                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* admm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
