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
// 2 n^2 + m n resident words, with products that each wait for the one
// before.  The one-off traffic (the lane's three matrices in, the state in
// and out) is small beside 400 iterations.  Design: one thread block of 256
// threads per lane, with the loop, the termination test and the per-lane
// freeze inside the kernel, so a QP pass is one launch whatever the
// iteration count.  Minv, P and A are staged once into shared memory.  An
// iteration is two dependent product stages and one reduction:
//
//   B  x~ = Minv rhs and z~ = A x~, then the x, z, y updates and
//      v+ = rho z+ - y+, each on the thread that computed its output;
//   C  side by side: A x+ (a thread per row, which also forms the primal
//      residual of its row), and for each column group (8 threads, 4
//      columns): A'y+ and A'v+ over the rows (a slice of rows per thread,
//      the two sums sharing each read of A), P x+ over its 4 rows (a slice
//      of 16-byte words per thread), combined by a reduce-scatter with
//      __shfl_xor_sync in a fixed order, after which each lane holds one
//      column: its dual residual and the next rhs = sigma x+ - q + A'v+;
//   each warp's maxima of the residuals and norms (one __reduce_max_sync
//   each: they are >= 0 or NaN, so their bit patterns order them) into
//   shared memory.
//
// That is two barriers an iteration where the thread-per-output design had
// six.  The termination test of iteration k (the block maxima, read back
// by every warp) runs while iteration k + 1's first product is formed; the
// product is written only once the test has said to go on.  Where B reads
// W = A Minv (formed once per launch while staging), x~ and z~ are one
// stage: the condensed tracking QP (n = 60, m = 118, both tracking paths)
// is compiled for its shape (every loop unrolled, loads issued ahead of the
// adds), keeps each thread's row of [Minv; W] in registers, and reads A, P
// and the vectors from shared memory as 16-byte words at a row stride of n
// words (n = 4 mod 8: a quarter warp reading eight consecutive rows, or
// eight consecutive words of one row, meets eight different bank groups).
// Every other shape takes the same design compiled for run-time sizes:
// scalar reads at an odd row stride, x~ and z~ in two stages (three
// barriers an iteration), column groups of one column.  At n = 60, m = 118
// a lane takes 61,992 bytes of shared memory, above the 48 KB default, so
// the launcher opts in to the size it needs and refuses a shape beyond the
// 227 KB a block can have.
//
// Sums run in a fixed order (per thread four running sums or one per
// column, then a fixed exchange between lanes), with fused multiply-adds in the products
// (the file's other arithmetic is unfused, as the package's build flags
// make it), so a run of 25 + 375 iterations equals one of 400 bit for bit;
// a library product sums in another order, so the plain PyTorch version
// agrees to rounding, not bit for bit.  max and clip propagate NaN, as
// jnp.max and jnp.clip do: a lane with a non-finite factorisation runs to
// its limit and returns NaN, which the caller detects.
//
// Two more instantiations, further down, are templated on the scalar type
// and serve what the shared-memory design cannot hold: the full tracking QP
// (n = 150, m = 208) and float64.  The sparse one keeps only the nonzeros
// of P and A, compressed into shared memory at staging; the global one
// reads them dense from device memory on every iteration.  The wrapper
// (kernels/admm.py:variant) picks one of the four by shape, dtype and the
// lanes' nonzero counts before the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 8;          // threads of a column group
constexpr int kMaxShared = 232448;  // bytes a block can have on sm_90
// the condensed tracking QP, compiled for its shape
constexpr int kFixedN = 60, kFixedM = 118;

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
  int n, m;
  float sigma, alpha, one_minus_alpha, eps_abs, eps_rel;
  int max_iter, n_iters;
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? NAN : fminf(a, b);
}

// The largest of the warp's v, each >= 0 or NaN (the residuals and norms
// are maxima of absolute values): such floats order as their bit patterns,
// and a NaN with its sign cleared is above +inf, so the result is NaN when
// any v is, as nan_max gives it.
__device__ __forceinline__ float warp_absmax(float v) {
  return __uint_as_float(
      __reduce_max_sync(0xffffffffu, __float_as_uint(v)));
}

__host__ __device__ inline bool is_fixed(int n, int m) {
  return n == kFixedN && m == kFixedM;
}

// Row stride of the shared matrices, in words.
__host__ __device__ inline int row_stride(int n, int m) {
  return is_fixed(n, m) ? n : (n | 1);
}

// Words of shared memory a lane needs: the reduction scratch, Minv, P and A
// at the row stride, three n-vectors at the row stride (x, rhs, x~), three
// of n words (q, cinv dinv, cinv dinv q) and seven m-vectors (the carve-up
// at the top of the kernel).
__host__ __device__ inline long long shared_words(int n, int m) {
  const long long ld = row_stride(n, m);
  return (2LL * n + m) * ld + 3 * ld + 3LL * n + 7LL * m + 4 * kWarps;
}

// sum_c row[c] vec[c] over c < n in a fixed order: four running sums (by
// c mod 4), then (s0 + s1) + (s2 + s3).  NT > 0: n = NT, 16-byte reads.
template <int NT>
__device__ __forceinline__ float row_dot(const float* row, const float* vec,
                                         int n) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  if constexpr (NT > 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(vec);
#pragma unroll
    for (int c = 0; c < NT / 4; ++c) {
      const float4 a = r4[c], b = v4[c];
      s0 = fmaf(a.x, b.x, s0);
      s1 = fmaf(a.y, b.y, s1);
      s2 = fmaf(a.z, b.z, s2);
      s3 = fmaf(a.w, b.w, s3);
    }
  } else {
    int c = 0;
    for (; c + 3 < n; c += 4) {
      s0 = fmaf(row[c], vec[c], s0);
      s1 = fmaf(row[c + 1], vec[c + 1], s1);
      s2 = fmaf(row[c + 2], vec[c + 2], s2);
      s3 = fmaf(row[c + 3], vec[c + 3], s3);
    }
    if (c < n) s0 = fmaf(row[c], vec[c], s0);
    if (c + 1 < n) s1 = fmaf(row[c + 1], vec[c + 1], s1);
    if (c + 2 < n) s2 = fmaf(row[c + 2], vec[c + 2], s2);
  }
  return (s0 + s1) + (s2 + s3);
}

// The same sum with the row in registers.
template <int NT>
__device__ __forceinline__ float reg_dot(const float (&w)[NT],
                                         const float* vec) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  const float4* v4 = reinterpret_cast<const float4*>(vec);
#pragma unroll
  for (int c = 0; c < NT / 4; ++c) {
    const float4 b = v4[c];
    s0 = fmaf(w[4 * c], b.x, s0);
    s1 = fmaf(w[4 * c + 1], b.y, s1);
    s2 = fmaf(w[4 * c + 2], b.z, s2);
    s3 = fmaf(w[4 * c + 3], b.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// One column group: columns j0 .. j0 + CW - 1 on kSlices threads, slice k
// taking rows k, k + 8, ... of A (for A'y and A'v) and words k, k + 8, ...
// of the group's rows of P (16-byte words when CW = 4).  The partial sums
// are combined over the group's lanes (`mask`) in a fixed order: for CW = 4
// a reduce-scatter (lanes exchange the two columns they do not keep, then
// one of the two, then add the last pair), after which lanes k with
// (k >> 1) & 3 == r hold the sums of column j0 + r; for CW = 1 a butterfly.
// Two lanes that hold a column add the same pairs, so they hold the same
// bits.  Returns the lane's column offset r and its three sums.
template <int CW, int NT, int MT>
__device__ __forceinline__ int column_group(
    const float* sA, const float* sP, const float* sx, const float* sy,
    const float* sv, int j0, int k, int n, int m, int ld, unsigned mask,
    float& ay_r, float& av_r, float& px_r) {
  float ay[CW], av[CW], px[CW];
#pragma unroll
  for (int r = 0; r < CW; ++r) ay[r] = av[r] = px[r] = 0.0f;
  if constexpr (CW == 4) {
#pragma unroll
    for (int t = 0; t < (MT + kSlices - 1) / kSlices; ++t) {
      const int i = k + t * kSlices;
      if (i < MT) {
        const float4 a = *reinterpret_cast<const float4*>(sA + i * ld + j0);
        const float yi = sy[i], vi = sv[i];
        ay[0] = fmaf(a.x, yi, ay[0]);
        ay[1] = fmaf(a.y, yi, ay[1]);
        ay[2] = fmaf(a.z, yi, ay[2]);
        ay[3] = fmaf(a.w, yi, ay[3]);
        av[0] = fmaf(a.x, vi, av[0]);
        av[1] = fmaf(a.y, vi, av[1]);
        av[2] = fmaf(a.z, vi, av[2]);
        av[3] = fmaf(a.w, vi, av[3]);
      }
    }
    const float4* x4 = reinterpret_cast<const float4*>(sx);
#pragma unroll
    for (int t = 0; t < (NT / 4 + kSlices - 1) / kSlices; ++t) {
      const int c = k + t * kSlices;
      if (c < NT / 4) {
        const float4 b = x4[c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 p =
              reinterpret_cast<const float4*>(sP + (j0 + r) * ld)[c];
          px[r] = fmaf(p.x, b.x, px[r]);
          px[r] = fmaf(p.y, b.y, px[r]);
          px[r] = fmaf(p.z, b.z, px[r]);
          px[r] = fmaf(p.w, b.w, px[r]);
        }
      }
    }
  } else {
    for (int i = k; i < m; i += kSlices) {
      const float a = sA[i * ld + j0];
      ay[0] = fmaf(a, sy[i], ay[0]);
      av[0] = fmaf(a, sv[i], av[0]);
    }
    for (int c = k; c < n; c += kSlices)
      px[0] = fmaf(sP[j0 * ld + c], sx[c], px[0]);
  }
  if constexpr (CW == 4) {
    static_assert(kSlices == 8, "the reduce-scatter is written for 8 lanes");
    const bool hi4 = (k & 4) != 0, hi2 = (k & 2) != 0;
    float y2[2], v2[2], p2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // keep columns {0, 1} or {2, 3}
      y2[h] = (hi4 ? ay[2 + h] : ay[h]) +
              __shfl_xor_sync(mask, hi4 ? ay[h] : ay[2 + h], 4);
      v2[h] = (hi4 ? av[2 + h] : av[h]) +
              __shfl_xor_sync(mask, hi4 ? av[h] : av[2 + h], 4);
      p2[h] = (hi4 ? px[2 + h] : px[h]) +
              __shfl_xor_sync(mask, hi4 ? px[h] : px[2 + h], 4);
    }
    ay_r = (hi2 ? y2[1] : y2[0]) + __shfl_xor_sync(mask, hi2 ? y2[0] : y2[1], 2);
    av_r = (hi2 ? v2[1] : v2[0]) + __shfl_xor_sync(mask, hi2 ? v2[0] : v2[1], 2);
    px_r = (hi2 ? p2[1] : p2[0]) + __shfl_xor_sync(mask, hi2 ? p2[0] : p2[1], 2);
    ay_r += __shfl_xor_sync(mask, ay_r, 1);
    av_r += __shfl_xor_sync(mask, av_r, 1);
    px_r += __shfl_xor_sync(mask, px_r, 1);
    return (k >> 1) & 3;
  } else {
#pragma unroll
    for (int off = 1; off < kSlices; off <<= 1) {
      ay[0] += __shfl_xor_sync(mask, ay[0], off);
      av[0] += __shfl_xor_sync(mask, av[0], off);
      px[0] += __shfl_xor_sync(mask, px[0], off);
    }
    ay_r = ay[0];
    av_r = av[0];
    px_r = px[0];
    return 0;
  }
}

__device__ __forceinline__ float dual_v(float rho, float z, float y) {
  return rho * z - y;
}

// NT, MT > 0: compiled for n = NT, m = MT (n % 8 == 4); 0: run-time sizes.
template <int NT, int MT>
__global__ void __launch_bounds__(kThreads, 2) admm_kernel(AdmmArgs a) {
  constexpr bool kFixed = NT > 0;
  constexpr int CW = kFixed ? 4 : 1;   // columns of a column group
  static_assert(!kFixed || (NT % 8 == 4 && NT + MT <= kThreads &&
                            MT <= kThreads / 2 &&
                            NT / 4 * kSlices <= kThreads / 2),
                "fixed shape out of the design's range");
  extern __shared__ __align__(16) float sm[];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int n = kFixed ? NT : a.n, m = kFixed ? MT : a.m;
  const int ld = row_stride(n, m);
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

  float4* s_red = reinterpret_cast<float4*>(sm);  // [kWarps] (rp, rd, pn, dn)
  float* s_minv = sm + 4 * kWarps;
  float* s_P = s_minv + n * ld;
  float* s_A = s_P + n * ld;
  float* s_x = s_A + m * ld;
  float* s_rhs = s_x + ld;
  float* s_xt = s_rhs + ld;
  float* s_q = s_xt + ld;
  float* s_cd = s_q + n;     // cinv * dinv
  float* s_qu = s_cd + n;    // cinv * dinv * q
  float* s_z = s_qu + n;
  float* s_y = s_z + m;
  float* s_v = s_y + m;      // rho z - y
  float* s_l = s_v + m;
  float* s_u = s_l + m;
  float* s_rho = s_u + m;
  float* s_einv = s_rho + m;

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
      const float z = a.z_in[om + i], y = a.y_in[om + i];
      const float rho = a.rho[om + i];
      s_l[i] = a.l[om + i];
      s_u[i] = a.u[om + i];
      s_rho[i] = rho;
      s_einv[i] = a.einv[om + i];
      s_z[i] = z;
      s_y[i] = y;
      s_v[i] = dual_v(rho, z, y);
    }
  }
  __syncthreads();

  // The fixed shape: thread t < n + m keeps row t of [Minv; W] (W = A Minv,
  // summed over k in order) in registers for stage B.
  float w[kFixed ? NT : 1];
  if constexpr (kFixed) {
    if (tid < NT) {
#pragma unroll
      for (int c = 0; c < NT / 4; ++c) {
        const float4 v = reinterpret_cast<const float4*>(s_minv + tid * ld)[c];
        w[4 * c] = v.x;
        w[4 * c + 1] = v.y;
        w[4 * c + 2] = v.z;
        w[4 * c + 3] = v.w;
      }
    } else if (tid < NT + MT) {
      const float* arow = s_A + (tid - NT) * ld;
#pragma unroll
      for (int c = 0; c < NT; ++c) w[c] = 0.0f;
#pragma unroll 1
      for (int k = 0; k < NT; ++k) {
        const float ak = arow[k];
        const float4* mk = reinterpret_cast<const float4*>(s_minv + k * ld);
#pragma unroll
        for (int c = 0; c < NT / 4; ++c) {
          const float4 v = mk[c];
          w[4 * c] = fmaf(ak, v.x, w[4 * c]);
          w[4 * c + 1] = fmaf(ak, v.y, w[4 * c + 1]);
          w[4 * c + 2] = fmaf(ak, v.z, w[4 * c + 2]);
          w[4 * c + 3] = fmaf(ak, v.w, w[4 * c + 3]);
        }
      }
    }
  }

  const float sigma = a.sigma, alpha = a.alpha, oma = a.one_minus_alpha;
  const unsigned group_mask = 0xffu << (tid & 24);

  // Stage C: unscaled A x+ (with the primal residual and norm of each row),
  // and per column group P x+, A'y+ (dual residual and norm) and A'v+ (the
  // next rhs).  Fixed shape: rows on threads [0, 128), column groups on
  // [128, 256); otherwise every thread takes both, in turn.
  auto stage_c = [&](float& rp, float& rd, float& pn, float& dn) {
    auto row = [&](int i) {
      const float ax = s_einv[i] * row_dot<NT>(s_A + i * ld, s_x, n);
      const float zu = s_einv[i] * s_z[i];
      rp = nan_max(rp, fabsf(ax - zu));
      pn = nan_max(pn, nan_max(fabsf(ax), fabsf(zu)));
    };
    auto columns = [&](int j0, int k) {
      float ay, av, px;
      const int j = j0 + column_group<CW, NT, MT>(s_A, s_P, s_x, s_y, s_v, j0,
                                                  k, n, m, ld, group_mask, ay,
                                                  av, px);
      const float pxu = s_cd[j] * px, atyu = s_cd[j] * ay;
      const float qu = s_qu[j];
      rd = nan_max(rd, fabsf((pxu + qu) + atyu));
      dn = nan_max(dn, nan_max(nan_max(fabsf(pxu), fabsf(atyu)), fabsf(qu)));
      // one lane of those holding column j writes its rhs
      if ((k & (CW == 4 ? 1 : kSlices - 1)) == 0)
        s_rhs[j] = (sigma * s_x[j] - s_q[j]) + av;
    };
    if constexpr (kFixed) {
      if (tid < kThreads / 2) {
        if (tid < MT) row(tid);
      } else {
        const int g = (tid - kThreads / 2) / kSlices;
        if (g < NT / 4) columns(4 * g, tid & (kSlices - 1));
      }
    } else {
      for (int i = tid; i < m; i += kThreads) row(i);
      for (int j = tid / kSlices; j < n; j += kThreads / kSlices)
        columns(j, tid & (kSlices - 1));
    }
  };

  // the first rhs, from the state as it came in (the same arithmetic as in
  // the loop, so a resumed run continues bit for bit)
  {
    float rp = 0.0f, rd = 0.0f, pn = 0.0f, dn = 0.0f;
    stage_c(rp, rd, pn, dn);
  }
  __syncthreads();

  auto update_z = [&](int i, float zt) {
    const float rho = s_rho[i], y = s_y[i];
    const float z_relax = alpha * zt + oma * s_z[i];
    const float z_new = nan_min(nan_max(z_relax + y / rho, s_l[i]), s_u[i]);
    const float y_new = y + rho * (z_relax - z_new);
    s_z[i] = z_new;
    s_y[i] = y_new;
    s_v[i] = dual_v(rho, z_new, y_new);
  };

  // k iterations of this launch are done at the top of the loop.  The next
  // iteration's first product is formed before the termination test of
  // iteration k is read from the scratch (the two overlap); its results are
  // written only once the test has said to go on.
  for (int k = 0;; ++k) {
    // ---- stage B, the product: x~ = Minv rhs and z~ = W rhs (fixed
    // shape; registers) or x~ = Minv rhs (x~ into scratch)
    float d = 0.0f;
    if constexpr (kFixed) {
      if (tid < NT + MT) d = reg_dot<NT>(w, s_rhs);
    } else {
      for (int j = tid; j < n; j += kThreads)
        s_xt[j] = row_dot<0>(s_minv + j * ld, s_rhs, n);
    }
    // ---- the termination test of iteration k: block maxima of the warps'
    // residuals and norms
    if (k > 0) {
      const int wl = tid & 31;
      const float4 part =
          wl < kWarps ? s_red[wl] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      r_prim = warp_absmax(part.x);
      r_dual = warp_absmax(part.y);
      prim_norm = warp_absmax(part.z);
      dual_norm = warp_absmax(part.w);
      const bool converged =
          (r_prim < a.eps_abs + a.eps_rel * prim_norm) &&
          (r_dual < a.eps_abs + a.eps_rel * dual_norm);
      it += 1;
      done = converged || (it >= a.max_iter);
    }
    if (done || k >= a.n_iters) break;

    // ---- stage B, the updates
    if constexpr (kFixed) {
      if (tid < NT)
        s_x[tid] = alpha * d + oma * s_x[tid];
      else if (tid < NT + MT)
        update_z(tid - NT, d);
      __syncthreads();
    } else {
      for (int j = tid; j < n; j += kThreads)
        s_x[j] = alpha * s_xt[j] + oma * s_x[j];
      __syncthreads();
      for (int i = tid; i < m; i += kThreads)
        update_z(i, row_dot<0>(s_A + i * ld, s_xt, n));
      __syncthreads();
    }

    // ---- stage C and the warps' maxima of the residuals and norms
    float rp = 0.0f, rd = 0.0f, pn = 0.0f, dn = 0.0f;
    stage_c(rp, rd, pn, dn);
    rp = warp_absmax(rp);
    rd = warp_absmax(rd);
    pn = warp_absmax(pn);
    dn = warp_absmax(dn);
    if ((tid & 31) == 0) s_red[tid >> 5] = make_float4(rp, rd, pn, dn);
    __syncthreads();
    // s_red is written again only after the next stage B's barrier, which
    // every thread reaches after reading it
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

template <int NT, int MT>
int launch(const AdmmArgs& a, int batch, long long bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      admm_kernel<NT, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  admm_kernel<NT, MT><<<(unsigned)batch, kThreads, (size_t)bytes, stream>>>(
      a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The global-memory variant: any (n, m), float and double.
//
// It serves what the shared-memory design above cannot hold: the full
// tracking QP (n = 150, m = 208: P and A alone are 215 KB a lane in float)
// and every float64 QP.  The same update sequence, per-lane freeze and
// NaN-propagating maxima; P and A stay in device memory and are read
// through the read-only path on every iteration, Minv is staged into shared
// memory when it fits beside the vectors (float n = 150: 90 KB, double
// n = 150: 180 KB) and is read from device memory otherwise.  What bounds
// it: bytes, two passes over A and one over P a lane and iteration (the
// four products with A share them: A x~ with A x+, and A'y+ with A'v+).
// An iteration is three stages, each closed by a barrier:
//
//   B1 a warp per row j of Minv, lanes across the columns: x~_j, then
//      x+_j = alpha x~_j + (1 - alpha) x_j in place;
//   B3 a warp per row, four rows at a time: row i of A gives z~_i = A_i x~
//      and (A x+)_i from one read (then the z, y, v updates and the primal
//      residual of row i), row j of P gives (P x+)_j;
//   C  a thread per column j of A, the warp reading consecutive columns of
//      one row: A'y+ and A'v+ over the rows, then the dual residual of
//      column j and the next rhs_j; then the warps' maxima.
//
// Sums run in a fixed order (a lane's running sum over columns wl, wl + 32,
// ..., then a butterfly, whose lanes all end on the same bits; a column's
// running sum over the rows in order), so 25 + 375 iterations equal 400
// bit for bit.
// ---------------------------------------------------------------------------

template <typename T>
struct GlobalArgs {
  const T *P, *q, *A, *l, *u, *rho, *minv, *dinv, *einv, *cinv;
  const T *x_in, *z_in, *y_in;
  const int* it_in;
  const T *rp_in, *rd_in, *pn_in, *dn_in;
  const unsigned char* done_in;
  T *x, *z, *y;
  int* it;
  T *rp, *rd, *pn, *dn;
  unsigned char* done;
  int n, m;
  T sigma, alpha, one_minus_alpha, eps_abs, eps_rel;
  int max_iter, n_iters;
  bool minv_resident;
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float abs_t(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_t(double v) { return fabs(v); }
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || b != b) ? (double)NAN : fmax(a, b);
}
__device__ __forceinline__ double nan_min(double a, double b) {
  return (a != a || b != b) ? (double)NAN : fmin(a, b);
}

// rows of A or P a warp reduces at once in the global variant, and the
// running sums of one of its column sums
constexpr int kRows = 4;
constexpr int kSums = 8;

// every lane ends on the same bits: at each step two lanes add the same
// pair, in either order
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_nan_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Words of shared memory: the reduction scratch, seven n-vectors (x, rhs,
// x~, P x+, q, cinv dinv, cinv dinv q), seven m-vectors (z, y, v, l, u,
// rho, einv), and Minv when it fits.
__host__ __device__ inline long long global_vector_words(int n, int m) {
  return 4LL * kWarps + 7LL * n + 7LL * m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) admm_global_kernel(
    GlobalArgs<T> a) {
  extern __shared__ __align__(16) unsigned char sm_raw[];
  T* sm = reinterpret_cast<T*>(sm_raw);
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;
  const int n = a.n, m = a.m;
  const long long on = (long long)lane * n, om = (long long)lane * m;

  int it = a.it_in[lane];
  bool done = a.done_in[lane] != 0;
  T r_prim = a.rp_in[lane], r_dual = a.rd_in[lane];
  T prim_norm = a.pn_in[lane], dual_norm = a.dn_in[lane];

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

  T* s_red = sm;  // [kWarps][4] (rp, rd, pn, dn)
  T* s_x = s_red + 4 * kWarps;
  T* s_rhs = s_x + n;
  T* s_xt = s_rhs + n;
  T* s_px = s_xt + n;
  T* s_q = s_px + n;
  T* s_cd = s_q + n;   // cinv * dinv
  T* s_qu = s_cd + n;  // cinv * dinv * q
  T* s_z = s_qu + n;
  T* s_y = s_z + m;
  T* s_v = s_y + m;    // rho z - y
  T* s_l = s_v + m;
  T* s_u = s_l + m;
  T* s_rho = s_u + m;
  T* s_einv = s_rho + m;
  T* s_minv = s_einv + m;

  const T* __restrict__ gP = a.P + on * n;
  const T* __restrict__ gA = a.A + om * n;
  const T* gminv = a.minv + on * n;

  // ---- stage the vectors (and Minv when it fits)
  if (a.minv_resident)
    for (int t = tid; t < n * n; t += kThreads) s_minv[t] = __ldg(gminv + t);
  const T cinv = a.cinv[lane];
  for (int j = tid; j < n; j += kThreads) {
    const T q = a.q[on + j];
    const T cd = cinv * a.dinv[on + j];
    s_q[j] = q;
    s_cd[j] = cd;
    s_qu[j] = cd * q;
    s_x[j] = a.x_in[on + j];
    s_px[j] = T(0);
  }
  for (int i = tid; i < m; i += kThreads) {
    const T z = a.z_in[om + i], y = a.y_in[om + i];
    const T rho = a.rho[om + i];
    s_l[i] = a.l[om + i];
    s_u[i] = a.u[om + i];
    s_rho[i] = rho;
    s_einv[i] = a.einv[om + i];
    s_z[i] = z;
    s_y[i] = y;
    s_v[i] = rho * z - y;
  }
  __syncthreads();
  const T* minv = a.minv_resident ? s_minv : gminv;

  const T sigma = a.sigma, alpha = a.alpha, oma = a.one_minus_alpha;

  // stage C: A'y+ and A'v+ by columns (kSums running sums over the rows
  // by i mod kSums, then added pairwise: independent chains, and less
  // rounding than one running sum), the dual residual of each column and
  // the next rhs
  auto stage_c = [&](T& rd, T& dn) {
    for (int j = tid; j < n; j += kThreads) {
      T sy[kSums], sv[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) sy[k] = sv[k] = T(0);
      int i = 0;
      for (; i + kSums <= m; i += kSums) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
          const T aij = __ldg(gA + (long long)(i + k) * n + j);
          sy[k] = fma_t(aij, s_y[i + k], sy[k]);
          sv[k] = fma_t(aij, s_v[i + k], sv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kSums; ++k)
        if (i + k < m) {
          const T aij = __ldg(gA + (long long)(i + k) * n + j);
          sy[k] = fma_t(aij, s_y[i + k], sy[k]);
          sv[k] = fma_t(aij, s_v[i + k], sv[k]);
        }
#pragma unroll
      for (int w = kSums / 2; w > 0; w /= 2)
#pragma unroll
        for (int k = 0; k < w; ++k) {
          sy[k] = sy[2 * k] + sy[2 * k + 1];
          sv[k] = sv[2 * k] + sv[2 * k + 1];
        }
      const T ay = sy[0], av = sv[0];
      const T pxu = s_cd[j] * s_px[j], atyu = s_cd[j] * ay;
      const T qu = s_qu[j];
      rd = nan_max(rd, abs_t((pxu + qu) + atyu));
      dn = nan_max(dn, nan_max(nan_max(abs_t(pxu), abs_t(atyu)), abs_t(qu)));
      s_rhs[j] = (sigma * s_x[j] - s_q[j]) + av;
    }
  };

  // the first rhs, from the state as it came in (the same arithmetic as in
  // the loop, so a resumed run continues bit for bit)
  {
    T rd = T(0), dn = T(0);
    stage_c(rd, dn);
  }
  __syncthreads();

  for (int k = 0;; ++k) {
    // ---- the termination test of iteration k: block maxima of the warps'
    // residuals and norms
    if (k > 0) {
      r_prim = r_dual = prim_norm = dual_norm = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        r_prim = nan_max(r_prim, s_red[4 * w]);
        r_dual = nan_max(r_dual, s_red[4 * w + 1]);
        prim_norm = nan_max(prim_norm, s_red[4 * w + 2]);
        dual_norm = nan_max(dual_norm, s_red[4 * w + 3]);
      }
      const bool converged =
          (r_prim < a.eps_abs + a.eps_rel * prim_norm) &&
          (r_dual < a.eps_abs + a.eps_rel * dual_norm);
      it += 1;
      done = converged || (it >= a.max_iter);
    }
    if (done || k >= a.n_iters) break;

    // ---- B1: x~ = Minv rhs, then x+ in place (B1 reads no x)
    for (int j = warp; j < n; j += kWarps) {
      const T* row = minv + (long long)j * n;
      T s = T(0);
      for (int c = wl; c < n; c += 32) s = fma_t(row[c], s_rhs[c], s);
      s = warp_sum(s);
      if (wl == 0) {
        s_xt[j] = s;
        s_x[j] = alpha * s + oma * s_x[j];
      }
    }
    __syncthreads();

    // ---- B3: rows of A (z~, A x+, the z, y, v updates, the primal
    // residual) and rows of P (P x+), kRows rows a warp at a time so that
    // their loads are in flight together
    T rp = T(0), rd = T(0), pn = T(0), dn = T(0);
    for (int r0 = kRows * warp; r0 < m; r0 += kRows * kWarps) {
      T szt[kRows], sax[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) szt[u] = sax[u] = T(0);
      for (int c = wl; c < n; c += 32) {
        const T xt = s_xt[c], xp = s_x[c];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          if (r0 + u < m) {
            const T av = __ldg(gA + (long long)(r0 + u) * n + c);
            szt[u] = fma_t(av, xt, szt[u]);
            sax[u] = fma_t(av, xp, sax[u]);
          }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = r0 + u;  // the same on every lane of the warp
        if (r >= m) break;
        const T zt = warp_sum(szt[u]);
        const T ax = s_einv[r] * warp_sum(sax[u]);
        const T rho = s_rho[r], y = s_y[r];
        const T z_relax = alpha * zt + oma * s_z[r];
        const T z_new = nan_min(nan_max(z_relax + y / rho, s_l[r]), s_u[r]);
        const T y_new = y + rho * (z_relax - z_new);
        const T zu = s_einv[r] * z_new;
        rp = nan_max(rp, abs_t(ax - zu));
        pn = nan_max(pn, nan_max(abs_t(ax), abs_t(zu)));
        __syncwarp();
        if (wl == 0) {
          s_z[r] = z_new;
          s_y[r] = y_new;
          s_v[r] = rho * z_new - y_new;
        }
      }
    }
    for (int j0 = kRows * warp; j0 < n; j0 += kRows * kWarps) {
      T sp[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) sp[u] = T(0);
      for (int c = wl; c < n; c += 32) {
        const T xp = s_x[c];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          if (j0 + u < n)
            sp[u] = fma_t(__ldg(gP + (long long)(j0 + u) * n + c), xp, sp[u]);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (j0 + u >= n) break;
        const T px = warp_sum(sp[u]);
        if (wl == 0) s_px[j0 + u] = px;
      }
    }
    __syncthreads();

    // ---- C and the warps' maxima of the residuals and norms
    stage_c(rd, dn);
    rp = warp_nan_max(rp);
    rd = warp_nan_max(rd);
    pn = warp_nan_max(pn);
    dn = warp_nan_max(dn);
    if (wl == 0) {
      s_red[4 * warp] = rp;
      s_red[4 * warp + 1] = rd;
      s_red[4 * warp + 2] = pn;
      s_red[4 * warp + 3] = dn;
    }
    __syncthreads();
    // s_red is written again only after the next B1's and B3's barriers,
    // which every thread reaches after reading it
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

// Bytes of dynamic shared memory of the global variant, and whether Minv
// is among them; 0 when not even the vectors fit.
long long global_shared_bytes(int n, int m, int elt, bool* minv_resident) {
  const long long vec = (long long)elt * global_vector_words(n, m);
  const long long with_minv = vec + (long long)elt * n * n;
  *minv_resident = with_minv <= kMaxShared;
  if (*minv_resident) return with_minv;
  return vec <= kMaxShared ? vec : 0;
}

// The kernels' arguments from the 28 pointers of the C interface (the
// order of admm_iterations) and the scalars.
template <typename T>
GlobalArgs<T> global_args(const void* const* ptr, int n, int m, double sigma,
                          double alpha, double one_minus_alpha,
                          double eps_abs, double eps_rel, int max_iter,
                          int n_iters) {
  GlobalArgs<T> a;
  const T** in[] = {&a.P,    &a.q,    &a.A,    &a.l,    &a.u,
                    &a.rho,  &a.minv, &a.dinv, &a.einv, &a.cinv,
                    &a.x_in, &a.z_in, &a.y_in};
  for (int k = 0; k < 13; ++k) *in[k] = (const T*)ptr[k];
  a.it_in = (const int*)ptr[13];
  a.rp_in = (const T*)ptr[14];
  a.rd_in = (const T*)ptr[15];
  a.pn_in = (const T*)ptr[16];
  a.dn_in = (const T*)ptr[17];
  a.done_in = (const unsigned char*)ptr[18];
  a.x = (T*)ptr[19];
  a.z = (T*)ptr[20];
  a.y = (T*)ptr[21];
  a.it = (int*)ptr[22];
  a.rp = (T*)ptr[23];
  a.rd = (T*)ptr[24];
  a.pn = (T*)ptr[25];
  a.dn = (T*)ptr[26];
  a.done = (unsigned char*)ptr[27];
  a.n = n;
  a.m = m;
  a.sigma = (T)sigma;
  a.alpha = (T)alpha;
  a.one_minus_alpha = (T)one_minus_alpha;
  a.eps_abs = (T)eps_abs;
  a.eps_rel = (T)eps_rel;
  a.max_iter = max_iter;
  a.n_iters = n_iters;
  a.minv_resident = false;
  return a;
}

template <typename T>
int launch_global(const void* const* ptr, int batch, int n, int m,
                  double sigma, double alpha, double one_minus_alpha,
                  double eps_abs, double eps_rel, int max_iter, int n_iters,
                  cudaStream_t stream) {
  bool resident = false;
  const long long bytes = global_shared_bytes(n, m, sizeof(T), &resident);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  GlobalArgs<T> a = global_args<T>(ptr, n, m, sigma, alpha, one_minus_alpha,
                                   eps_abs, eps_rel, max_iter, n_iters);
  a.minv_resident = resident;
  cudaError_t err = cudaFuncSetAttribute(
      admm_global_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  admm_global_kernel<T><<<(unsigned)batch, kThreads, (size_t)bytes,
                          stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The sparse variant: any (n, m) whose compressed lane fits, float and
// double.
//
// The full tracking QP is almost all zeros: A has 531 nonzeros of 31,200
// (at most 4 a row, 6 a column: the identity of the input box rows, I, -I
// and a few entries of A_j and B_j in the dynamics rows, two entries in the
// rate rows) and P 266 of 22,500 (diagonal on the states, banded on the
// inputs), on every lane alike.  This instantiation computes the update
// sequence of the global one with products that skip the entries of P and A
// that are exactly zero (+0 or -0; a NaN entry is kept).  Skipping one
// changes a sum only where the vector it multiplies is not finite, and then
// the lane is NaN already: x~ is a dense Minv product of the whole rhs, so
// one non-finite entry anywhere reaches every entry of x~ and x+, from
// there every row of A and of P with an entry, and through the
// NaN-propagating maxima the residuals, so the lane returns NaN in x and
// in its residuals as in the dense kernels.  Only z and y of a row of A
// with no entry at all stay finite where a dense product makes them NaN
// (0 x NaN); no row of the tracking QPs is empty.
//
// Staging, once per launch: each block reads its lane's dense P and A from
// device memory twice (a warp per row, all of a row's loads in flight
// together: the counts by ballot, then the entries) and keeps
//   A by rows    (values, 16-bit column indices, row starts) for A x~, A x+,
//   A by columns (values, 16-bit row indices, column starts) for A'y+, A'v+,
//                filled at per-column cursors by shared atomics, then each
//                column sorted into row order,
//   P by rows    (values, 16-bit column indices, row starts) for P x+,
// with Minv dense (the explicit inverse of the JAX package, no sparse
// factorisation) and the vectors.  For the loop, each thread copies the
// first few entries of its row of A, its column of A and its row of P
// into registers (all of them in the tracking QPs), so the sparse products
// wait on one shared read of the vector an entry, not three.  Nothing of the MPC's structure is
// compiled in: any QP whose compressed lane fits in a block's shared memory
// is served (`sparse_shared_bytes`; the launch is sized for the largest
// nonzero counts over the lanes, which the wrapper counts on the device).
// At n = 150, m = 208 with those counts a lane takes 113,788 bytes in float
// (two blocks an SM) and 215,028 in double.
//
// What bounds it: operations, 2 (n^2 + 4 nnz(A) + nnz(P)) flops a lane and
// iteration, and on this card the shared-memory reads of the dense Minv
// product (n^2 words an iteration) and the latency of the chain of
// products; the compressed P and A are read from device memory once per
// launch, not once per iteration.  An iteration is three stages, each
// closed by a barrier:
//
//   B1 a thread per row j of Minv, reading 16-byte words (the row stride
//      puts eight consecutive rows on eight bank groups): x~_j, formed
//      before the termination test of the previous iteration is read and
//      written after it, then x+_j = alpha x~_j + (1 - alpha) x_j;
//   B2 a thread per row i of A: z~_i and (A x+)_i from the row's entries,
//      the z, y, v updates and the primal residual of row i;
//   C  a thread per column j: A'y+ and A'v+ from column j's entries and
//      (P x+)_j from row j of P, the dual residual of column j and the next
//      rhs_j; then the warps' maxima, which the next iteration's test
//      combines on eight lanes of every warp.
//
// Sums run in a fixed order (Minv: four running sums by column mod 4, then
// (s0 + s1) + (s2 + s3); a sparse row or column: one running sum in index
// order), so 25 + 375 iterations equal 400 bit for bit.
// ---------------------------------------------------------------------------

// Writes a lane's state (sparse variant): x, z, y from xs, zs, ys (device or shared
// memory), the scalars by thread 0.
template <typename T>
__device__ __forceinline__ void store_state(const GlobalArgs<T>& a,
                                            int lane, const T* xs,
                                            const T* zs, const T* ys, int it,
                                            T rp, T rd, T pn, T dn,
                                            bool done) {
  const int tid = threadIdx.x;
  const long long on = (long long)lane * a.n, om = (long long)lane * a.m;
  for (int j = tid; j < a.n; j += kThreads) a.x[on + j] = xs[j];
  for (int i = tid; i < a.m; i += kThreads) {
    a.z[om + i] = zs[i];
    a.y[om + i] = ys[i];
  }
  if (tid == 0) {
    a.it[lane] = it;
    a.rp[lane] = rp;
    a.rd[lane] = rd;
    a.pn[lane] = pn;
    a.dn[lane] = dn;
    a.done[lane] = done ? 1 : 0;
  }
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using V = float4; };
template <> struct Vec16<double> { using V = double2; };

// Row stride of Minv in shared memory, in elements: n rounded up to a whole
// odd number of 16-byte words, so rows start 16-byte aligned and eight
// consecutive rows fall on eight different groups of four banks.
__host__ __device__ inline int sparse_minv_stride(int n, int elt) {
  const int per = 16 / elt;
  int words = (n + per - 1) / per;
  if (words % 2 == 0) ++words;
  return words * per;
}

// Bytes of dynamic shared memory of the sparse variant for nnz_a entries of
// A and nnz_p of P: the reduction scratch, Minv at its row stride, rhs at
// that stride, five more n-vectors (x, x~, q, cinv dinv, cinv dinv q),
// seven m-vectors (z, y, v, l, u, rho, einv) and the values of A by rows,
// A by columns and P by rows, then the int starts of A's m rows, A's n
// columns and P's n rows and the n column cursors of A's fill, then the
// 16-bit indices of the three.
long long sparse_shared_bytes(int n, int m, long long nnz_a,
                              long long nnz_p, int elt) {
  const long long ld = sparse_minv_stride(n, elt);
  return (long long)elt * (4LL * kWarps + n * ld + ld + 5LL * n + 7LL * m +
                           2 * nnz_a + nnz_p) +
         4LL * (m + 3LL * n + 3) + 2LL * (2 * nnz_a + nnz_p);
}

// Whether the sparse variant takes an (n, m) QP with these counts: a lane
// fits in a block's shared memory, a thread per row of Minv, indices in 16
// bits.
bool sparse_fits(int n, int m, long long nnz_a, long long nnz_p, int elt) {
  return n <= kThreads && m <= 65536 &&
         sparse_shared_bytes(n, m, nnz_a, nnz_p, elt) <= kMaxShared;
}

// sum_c row[c] vec[c] over `words` 16-byte words, four running sums by
// c mod 4, then (s0 + s1) + (s2 + s3).
__device__ __forceinline__ float minv_dot(const float* row, const float* vec,
                                          int words) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* v4 = reinterpret_cast<const float4*>(vec);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 4
  for (int c = 0; c < words; ++c) {
    const float4 a = r4[c], b = v4[c];
    s0 = fmaf(a.x, b.x, s0);
    s1 = fmaf(a.y, b.y, s1);
    s2 = fmaf(a.z, b.z, s2);
    s3 = fmaf(a.w, b.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

__device__ __forceinline__ double minv_dot(const double* row,
                                           const double* vec, int words) {
  const double2* r2 = reinterpret_cast<const double2*>(row);
  const double2* v2 = reinterpret_cast<const double2*>(vec);
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
  int c = 0;
#pragma unroll 2
  for (; c + 1 < words; c += 2) {
    const double2 a0 = r2[c], a1 = r2[c + 1], b0 = v2[c], b1 = v2[c + 1];
    s0 = fma(a0.x, b0.x, s0);
    s1 = fma(a0.y, b0.y, s1);
    s2 = fma(a1.x, b1.x, s2);
    s3 = fma(a1.y, b1.y, s3);
  }
  if (c < words) {
    const double2 a0 = r2[c], b0 = v2[c];
    s0 = fma(a0.x, b0.x, s0);
    s1 = fma(a0.y, b0.y, s1);
  }
  return (s0 + s1) + (s2 + s3);
}

// counts [len] -> exclusive starts [len + 1], by one warp
__device__ __forceinline__ void warp_exclusive_scan(int* a, int len) {
  const int wl = threadIdx.x & 31;
  int carry = 0;
  for (int b = 0; b < len; b += 32) {
    const int i = b + wl;
    const int v = i < len ? a[i] : 0;
    int inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, off);
      if (wl >= off) inc += t;
    }
    if (i < len) a[i] = carry + inc - v;
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (wl == 0) a[len] = carry;
}

// 32-column chunks of a row of the sparse variant (n <= kThreads)
constexpr int kChunks = kThreads / 32;
// entries a thread keeps in registers for the loop: the first kCacheRow of
// its row of A (B2) and of P (C), the first kCacheCol of its column of A
// (C); further ones are read from shared memory
constexpr int kCacheRow = 4;
constexpr int kCacheCol = 8;

// blocks an SM is to hold: two lanes in float (113 KB each on the full
// QP), one in double
template <typename T> struct SparseBlocks {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};

// The entries [begin, end) of a compressed row or column as one thread
// sees them: the first K in registers, the rest left in shared memory.
template <typename T, int K>
struct Entries {
  T v[K];
  int idx[K];
  int cnt, rest, end;

  __device__ __forceinline__ void load(const T* vals, const uint16_t* ids,
                                       int begin, int end_) {
    cnt = min(end_ - begin, K);
    rest = begin + cnt;
    end = end_;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = k < cnt ? vals[begin + k] : T(0);
      idx[k] = k < cnt ? (int)ids[begin + k] : 0;
    }
  }

  // s1 += sum v x1[idx], s2 += sum v x2[idx] over the entries in order
  __device__ __forceinline__ void dot2(const T* vals, const uint16_t* ids,
                                       const T* x1, const T* x2, T& s1,
                                       T& s2) const {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < cnt) {
        s1 = fma_t(v[k], x1[idx[k]], s1);
        s2 = fma_t(v[k], x2[idx[k]], s2);
      }
    for (int e = rest; e < end; ++e) {
      const int c = ids[e];
      s1 = fma_t(vals[e], x1[c], s1);
      s2 = fma_t(vals[e], x2[c], s2);
    }
  }

  __device__ __forceinline__ T dot(const T* vals, const uint16_t* ids,
                                   const T* x) const {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < cnt) s = fma_t(v[k], x[idx[k]], s);
    for (int e = rest; e < end; ++e) s = fma_t(vals[e], x[ids[e]], s);
    return s;
  }
};

// A row of `n` columns into the warp's registers, chunk k on lane wl being
// column 32 k + wl (zero past n), every load issued before any is used.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int n,
                                         T (&v)[kChunks]) {
  const int wl = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = 32 * k + wl;
    v[k] = c < n ? __ldg(row + c) : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, SparseBlocks<T>::value)
    admm_sparse_kernel(GlobalArgs<T> a, int cap_a, int cap_p) {
  extern __shared__ __align__(16) unsigned char sm_raw[];
  T* sm = reinterpret_cast<T*>(sm_raw);
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;
  const unsigned below = (1u << wl) - 1u;  // lanes before this one
  const int n = a.n, m = a.m;
  const int ld = sparse_minv_stride(n, sizeof(T));
  const int words = ld / (16 / (int)sizeof(T));
  const long long on = (long long)lane * n, om = (long long)lane * m;

  int it = a.it_in[lane];
  bool done = a.done_in[lane] != 0;
  T r_prim = a.rp_in[lane], r_dual = a.rd_in[lane];
  T prim_norm = a.pn_in[lane], dual_norm = a.dn_in[lane];

  if (done || a.n_iters <= 0) {  // a frozen lane passes through unchanged
    store_state(a, lane, a.x_in + on, a.z_in + om, a.y_in + om, it, r_prim,
                r_dual, prim_norm, dual_norm, done);
    return;
  }

  T* s_red = sm;                     // [kWarps][4] (rp, rd, pn, dn)
  T* s_minv = s_red + 4 * kWarps;    // [n][ld], zero past column n
  T* s_rhs = s_minv + n * ld;        // [ld], zero past n
  T* s_x = s_rhs + ld;
  T* s_xt = s_x + n;
  T* s_q = s_xt + n;
  T* s_cd = s_q + n;   // cinv * dinv
  T* s_qu = s_cd + n;  // cinv * dinv * q
  T* s_z = s_qu + n;
  T* s_y = s_z + m;
  T* s_v = s_y + m;    // rho z - y
  T* s_l = s_v + m;
  T* s_u = s_l + m;
  T* s_rho = s_u + m;
  T* s_einv = s_rho + m;
  T* a_rv = s_einv + m;              // A by rows: values [cap_a]
  T* a_cv = a_rv + cap_a;            // A by columns: values [cap_a]
  T* p_v = a_cv + cap_a;             // P by rows: values [cap_p]
  int* a_rp = reinterpret_cast<int*>(p_v + cap_p);  // [m + 1] row starts
  int* a_cp = a_rp + m + 1;          // [n + 1] column starts
  int* p_rp = a_cp + n + 1;          // [n + 1] row starts
  int* a_cur = p_rp + n + 1;         // [n] column cursors of the fill
  uint16_t* a_ci = reinterpret_cast<uint16_t*>(a_cur + n);  // [cap_a]
  uint16_t* a_ri = a_ci + cap_a;     // [cap_a]
  uint16_t* p_ci = a_ri + cap_a;     // [cap_p]

  const T* __restrict__ gP = a.P + on * n;
  const T* __restrict__ gA = a.A + om * n;
  const T* __restrict__ gminv = a.minv + on * n;
  auto row_of = [&](int r) {  // rows of A, then rows of P
    return r < m ? gA + (long long)r * n : gP + (long long)(r - m) * n;
  };

  // ---- stage Minv (a warp per row), the vectors, and zero the counts
  for (int r = warp; r < n; r += kWarps) {
    T v[kChunks];
    load_row(gminv + (long long)r * n, n, v);
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      if (32 * k + wl < n) s_minv[r * ld + 32 * k + wl] = v[k];
  }
  for (int t = tid; t < n * (ld - n); t += kThreads) {
    const int r = t / (ld - n);
    s_minv[r * ld + n + (t - r * (ld - n))] = T(0);
  }
  for (int c = n + tid; c < ld; c += kThreads) s_rhs[c] = T(0);
  const T cinv = a.cinv[lane];
  for (int j = tid; j < n; j += kThreads) {
    const T q = a.q[on + j];
    const T cd = cinv * a.dinv[on + j];
    s_q[j] = q;
    s_cd[j] = cd;
    s_qu[j] = cd * q;
    s_x[j] = a.x_in[on + j];
  }
  for (int i = tid; i < m; i += kThreads) {
    const T z = a.z_in[om + i], y = a.y_in[om + i];
    const T rho = a.rho[om + i];
    s_l[i] = a.l[om + i];
    s_u[i] = a.u[om + i];
    s_rho[i] = rho;
    s_einv[i] = a.einv[om + i];
    s_z[i] = z;
    s_y[i] = y;
    s_v[i] = rho * z - y;
  }
  for (int t = tid; t < m + 2 * n + 3; t += kThreads) a_rp[t] = 0;
  __syncthreads();

  // ---- count: a warp per row of A (its count by ballot, its columns'
  // counts by shared atomics, integers, so in any order) and of P
  for (int r = warp; r < m + n; r += kWarps) {
    T v[kChunks];
    load_row(row_of(r), n, v);
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const bool nz = 32 * k + wl < n && v[k] != T(0);
      cnt += __popc(__ballot_sync(0xffffffffu, nz));
      if (nz && r < m) atomicAdd(a_cp + 32 * k + wl, 1);
    }
    if (wl == 0) {
      if (r < m)
        a_rp[r] = cnt;
      else
        p_rp[r - m] = cnt;
    }
  }
  __syncthreads();
  if (warp == 0) warp_exclusive_scan(a_rp, m);
  if (warp == 1) warp_exclusive_scan(a_cp, n);
  if (warp == 2) warp_exclusive_scan(p_rp, n);
  __syncthreads();
  // The launch is sized for the largest counts over the lanes, taken by the
  // wrapper on the same data, so no lane exceeds them; a lane that did
  // would overrun its arrays, and returns NaN instead.
  if (a_rp[m] > cap_a || p_rp[n] > cap_p) {
    for (int j = tid; j < n; j += kThreads) s_x[j] = T(NAN);
    for (int i = tid; i < m; i += kThreads) s_z[i] = s_y[i] = T(NAN);
    __syncthreads();
    store_state(a, lane, s_x, s_z, s_y, it, T(NAN), T(NAN), T(NAN), T(NAN),
                done);
    return;
  }
  for (int j = tid; j < n; j += kThreads) a_cur[j] = a_cp[j];
  __syncthreads();

  // ---- fill A and P by rows (a warp per row, entries in column order)
  // and A by columns (each entry at its column's cursor, in any order)
  for (int r = warp; r < m + n; r += kWarps) {
    const bool is_a = r < m;
    T* vals = is_a ? a_rv : p_v;
    uint16_t* cols = is_a ? a_ci : p_ci;
    int pos = is_a ? a_rp[r] : p_rp[r - m];
    T v[kChunks];
    load_row(row_of(r), n, v);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = 32 * k + wl;
      const bool nz = c < n && v[k] != T(0);
      const unsigned bal = __ballot_sync(0xffffffffu, nz);
      if (nz) {
        const int e = pos + __popc(bal & below);
        vals[e] = v[k];
        cols[e] = (uint16_t)c;
        if (is_a) {
          const int f = atomicAdd(a_cur + c, 1);
          a_cv[f] = v[k];
          a_ri[f] = (uint16_t)r;
        }
      }
      pos += __popc(bal);
    }
  }
  __syncthreads();
  // ---- each column of A into row order (insertion sort: a few entries)
  for (int j = tid; j < n; j += kThreads) {
    for (int e = a_cp[j] + 1; e < a_cp[j + 1]; ++e) {
      const T v = a_cv[e];
      const uint16_t r = a_ri[e];
      int f = e;
      for (; f > a_cp[j] && a_ri[f - 1] > r; --f) {
        a_cv[f] = a_cv[f - 1];
        a_ri[f] = a_ri[f - 1];
      }
      a_cv[f] = v;
      a_ri[f] = r;
    }
  }
  __syncthreads();

  // this thread's row of A (B2), column of A and row of P (C), as far as
  // they fit in its registers
  Entries<T, kCacheRow> row_a, row_p;
  Entries<T, kCacheCol> col_a;
  if (tid < m) row_a.load(a_rv, a_ci, a_rp[tid], a_rp[tid + 1]);
  if (tid < n) {
    col_a.load(a_cv, a_ri, a_cp[tid], a_cp[tid + 1]);
    row_p.load(p_v, p_ci, p_rp[tid], p_rp[tid + 1]);
  }

  const T sigma = a.sigma, alpha = a.alpha, oma = a.one_minus_alpha;

  // stage C: for column j = tid (n <= kThreads), A'y+ and A'v+ over its
  // entries and P x+ over row j of P, the dual residual of column j and
  // the next rhs
  auto stage_c = [&](T& rd, T& dn) {
    if (tid < n) {
      const int j = tid;
      T ay = T(0), av = T(0);
      col_a.dot2(a_cv, a_ri, s_y, s_v, ay, av);
      const T px = row_p.dot(p_v, p_ci, s_x);
      const T pxu = s_cd[j] * px, atyu = s_cd[j] * ay;
      const T qu = s_qu[j];
      rd = nan_max(rd, abs_t((pxu + qu) + atyu));
      dn = nan_max(dn, nan_max(nan_max(abs_t(pxu), abs_t(atyu)), abs_t(qu)));
      s_rhs[j] = (sigma * s_x[j] - s_q[j]) + av;
    }
  };

  // the first rhs, from the state as it came in (the same arithmetic as in
  // the loop, so a resumed run continues bit for bit)
  {
    T rd = T(0), dn = T(0);
    stage_c(rd, dn);
  }
  __syncthreads();

  for (int k = 0;; ++k) {
    // ---- B1's product, x~_j = (Minv rhs)_j for j = tid
    const T xt = tid < n ? minv_dot(s_minv + tid * ld, s_rhs, words) : T(0);
    // ---- the termination test of iteration k: the block maxima of the
    // warps' residuals and norms, lanes w < kWarps reading warp w's
    if (k > 0) {
      T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0);
      if (wl < kWarps) {
        v0 = s_red[4 * wl];
        v1 = s_red[4 * wl + 1];
        v2 = s_red[4 * wl + 2];
        v3 = s_red[4 * wl + 3];
      }
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) {
        v0 = nan_max(v0, __shfl_xor_sync(0xffffffffu, v0, off));
        v1 = nan_max(v1, __shfl_xor_sync(0xffffffffu, v1, off));
        v2 = nan_max(v2, __shfl_xor_sync(0xffffffffu, v2, off));
        v3 = nan_max(v3, __shfl_xor_sync(0xffffffffu, v3, off));
      }
      r_prim = __shfl_sync(0xffffffffu, v0, 0);
      r_dual = __shfl_sync(0xffffffffu, v1, 0);
      prim_norm = __shfl_sync(0xffffffffu, v2, 0);
      dual_norm = __shfl_sync(0xffffffffu, v3, 0);
      const bool converged =
          (r_prim < a.eps_abs + a.eps_rel * prim_norm) &&
          (r_dual < a.eps_abs + a.eps_rel * dual_norm);
      it += 1;
      done = converged || (it >= a.max_iter);
    }
    if (done || k >= a.n_iters) break;

    // ---- B1's updates: x~ and x+ in place
    if (tid < n) {
      s_xt[tid] = xt;
      s_x[tid] = alpha * xt + oma * s_x[tid];
    }
    __syncthreads();

    // ---- B2: rows of A (z~, A x+, the z, y, v updates, the primal
    // residual); row tid from registers, rows past kThreads from shared
    // memory
    T rp = T(0), rd = T(0), pn = T(0), dn = T(0);
    for (int i = tid; i < m; i += kThreads) {
      T zt = T(0), ax = T(0);
      if (i == tid) {
        row_a.dot2(a_rv, a_ci, s_xt, s_x, zt, ax);
      } else {
        for (int e = a_rp[i]; e < a_rp[i + 1]; ++e) {
          const T v = a_rv[e];
          const int c = a_ci[e];
          zt = fma_t(v, s_xt[c], zt);
          ax = fma_t(v, s_x[c], ax);
        }
      }
      ax = s_einv[i] * ax;
      const T rho = s_rho[i], y = s_y[i];
      const T z_relax = alpha * zt + oma * s_z[i];
      const T z_new = nan_min(nan_max(z_relax + y / rho, s_l[i]), s_u[i]);
      const T y_new = y + rho * (z_relax - z_new);
      const T zu = s_einv[i] * z_new;
      rp = nan_max(rp, abs_t(ax - zu));
      pn = nan_max(pn, nan_max(abs_t(ax), abs_t(zu)));
      s_z[i] = z_new;
      s_y[i] = y_new;
      s_v[i] = rho * z_new - y_new;
    }
    __syncthreads();

    // ---- C and the warps' maxima of the residuals and norms
    stage_c(rd, dn);
    rp = warp_nan_max(rp);
    rd = warp_nan_max(rd);
    pn = warp_nan_max(pn);
    dn = warp_nan_max(dn);
    if (wl == 0) {
      s_red[4 * warp] = rp;
      s_red[4 * warp + 1] = rd;
      s_red[4 * warp + 2] = pn;
      s_red[4 * warp + 3] = dn;
    }
    __syncthreads();
    // s_red is written again only after the next B1's and B2's barriers,
    // which every thread reaches after reading it
  }

  store_state(a, lane, s_x, s_z, s_y, it, r_prim, r_dual, prim_norm,
              dual_norm, done);
}

template <typename T>
int launch_sparse(const void* const* ptr, int batch, int n, int m,
                  int nnz_a, int nnz_p, double sigma, double alpha,
                  double one_minus_alpha, double eps_abs, double eps_rel,
                  int max_iter, int n_iters, cudaStream_t stream) {
  if (nnz_a < 0 || nnz_p < 0 || !sparse_fits(n, m, nnz_a, nnz_p, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const long long bytes = sparse_shared_bytes(n, m, nnz_a, nnz_p, sizeof(T));
  GlobalArgs<T> a = global_args<T>(ptr, n, m, sigma, alpha, one_minus_alpha,
                                   eps_abs, eps_rel, max_iter, n_iters);
  cudaError_t err = cudaFuncSetAttribute(
      admm_sparse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  admm_sparse_kernel<T><<<(unsigned)batch, kThreads, (size_t)bytes,
                          stream>>>(a, nnz_a, nnz_p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one lane of an (n, m) QP needs.
long long admm_shared_bytes(int n, int m) {
  return 4LL * shared_words(n, m);
}
// Enqueues one kernel on `stream`, one block per lane (the instantiation
// compiled for n = 60, m = 118 at that shape, the run-time one otherwise), and returns the
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
  a.sigma = sigma;
  a.alpha = alpha;
  a.one_minus_alpha = one_minus_alpha;
  a.eps_abs = eps_abs;
  a.eps_rel = eps_rel;
  a.max_iter = max_iter;
  a.n_iters = n_iters;
  cudaStream_t s = (cudaStream_t)stream;
  return is_fixed(n, m) ? launch<kFixedN, kFixedM>(a, batch, bytes, s)
                        : launch<0, 0>(a, batch, bytes, s);
}

// The global-memory variant (any n, m; float when dbl == 0, double
// otherwise): bytes of dynamic shared memory a lane takes (0 when not even
// its vectors fit) and, in *minv_resident, whether Minv is among them.
long long admm_global_shared_bytes(int n, int m, int dbl,
                                   int* minv_resident) {
  bool resident = false;
  const long long bytes = global_shared_bytes(
      n, m, dbl ? (int)sizeof(double) : (int)sizeof(float), &resident);
  *minv_resident = resident ? 1 : 0;
  return bytes;
}

// Enqueues the global-memory variant on `stream`, one block per lane: the
// same 28 pointers as admm_iterations, to float or (dbl != 0) double data,
// and the scalars in double (rounded to float for a float batch).  Returns
// the first CUDA error (0 = launched); a shape whose vectors do not fit in
// a block's shared memory is refused with cudaErrorInvalidValue.
int admm_iterations_global(
    const void* P, const void* q, const void* A, const void* l,
    const void* u, const void* rho, const void* minv, const void* dinv,
    const void* einv, const void* cinv, const void* x_in, const void* z_in,
    const void* y_in, const void* it_in, const void* rp_in,
    const void* rd_in, const void* pn_in, const void* dn_in,
    const void* done_in, void* x, void* z, void* y, void* it, void* rp,
    void* rd, void* pn, void* dn, void* done, int batch, int n, int m,
    int dbl, double sigma, double alpha, double one_minus_alpha,
    double eps_abs, double eps_rel, int max_iter, int n_iters,
    void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const void* const ptr[28] = {P,     q,    A,     l,     u,     rho,
                               minv,  dinv, einv,  cinv,  x_in,  z_in,
                               y_in,  it_in, rp_in, rd_in, pn_in, dn_in,
                               done_in, x,  z,     y,     it,    rp,
                               rd,    pn,   dn,    done};
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? launch_global<double>(ptr, batch, n, m, sigma, alpha,
                                     one_minus_alpha, eps_abs, eps_rel,
                                     max_iter, n_iters, s)
             : launch_global<float>(ptr, batch, n, m, sigma, alpha,
                                    one_minus_alpha, eps_abs, eps_rel,
                                    max_iter, n_iters, s);
}

// The sparse variant (float when dbl == 0, double otherwise): bytes of
// dynamic shared memory a lane with nnz_a entries of A and nnz_p of P that
// are not zero takes, or 0 when such a lane does not fit.
long long admm_sparse_shared_bytes(int n, int m, int nnz_a, int nnz_p,
                                   int dbl) {
  const int elt = dbl ? (int)sizeof(double) : (int)sizeof(float);
  return sparse_fits(n, m, nnz_a, nnz_p, elt)
             ? sparse_shared_bytes(n, m, nnz_a, nnz_p, elt)
             : 0;
}

// Enqueues the sparse variant on `stream`, one block per lane: the same
// arguments as admm_iterations_global, and the largest counts over the
// lanes of A's and P's entries that are not zero, for which the shared
// memory is sized.  Returns the first CUDA error (0 = launched); counts
// whose lane does not fit are refused with cudaErrorInvalidValue.
int admm_iterations_sparse(
    const void* P, const void* q, const void* A, const void* l,
    const void* u, const void* rho, const void* minv, const void* dinv,
    const void* einv, const void* cinv, const void* x_in, const void* z_in,
    const void* y_in, const void* it_in, const void* rp_in,
    const void* rd_in, const void* pn_in, const void* dn_in,
    const void* done_in, void* x, void* z, void* y, void* it, void* rp,
    void* rd, void* pn, void* dn, void* done, int batch, int n, int m,
    int nnz_a, int nnz_p, int dbl, double sigma, double alpha,
    double one_minus_alpha, double eps_abs, double eps_rel, int max_iter,
    int n_iters, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const void* const ptr[28] = {P,     q,    A,     l,     u,     rho,
                               minv,  dinv, einv,  cinv,  x_in,  z_in,
                               y_in,  it_in, rp_in, rd_in, pn_in, dn_in,
                               done_in, x,  z,     y,     it,    rp,
                               rd,    pn,   dn,    done};
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? launch_sparse<double>(ptr, batch, n, m, nnz_a, nnz_p, sigma,
                                     alpha, one_minus_alpha, eps_abs,
                                     eps_rel, max_iter, n_iters, s)
             : launch_sparse<float>(ptr, batch, n, m, nnz_a, nnz_p, sigma,
                                    alpha, one_minus_alpha, eps_abs, eps_rel,
                                    max_iter, n_iters, s);
}

const char* admm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
