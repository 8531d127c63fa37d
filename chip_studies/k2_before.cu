// Terrain lookups of the ALM solver, hand-written for Hopper (sm_90a).
//
// K1 terrain_tv_packed16 replaces the JAX package's
//   uneven_planner_tpu/terrain/grid.py:get_terrain_variables_cm_packed16
//   (+ _tv_from_fields), an XLA gather over the f16 packed table; it runs on
//   every solver evaluation (solver/alm.py _sample_kernel, exact=False).
// K2 terrain_tv_pair replaces the exact path of
//   uneven_planner_tpu/terrain/grid.py:get_terrain_variables_cm, an XLA
//   gather over the yaw-pair table; it runs in init_scaling and
//   exact_residuals (exact=True).
//
// Both map M SE(2) samples (px, py, yaw; yaw already wrapped into [-pi, pi))
// to the 7 terrain variables tv [7, M] and, when asked, to their local
// Jacobian J [7, 3, M] = d tv / d(px, py, yaw), written from the same
// registers.  The autograd wrapper forms the backward (sum_k gtv_k J_k) and
// the forward-mode product (J t) from J, so no second launch is needed.
//
// What bounds them: bytes.  Per lookup K1 reads 12 B of pose and 2 (4 in
// exact mode) 32-byte table rows and writes 28 B of tv plus 84 B of J; the
// arithmetic (~200 flops and 5 transcendentals) is two orders of magnitude
// below the H100's f32 rate for those bytes.  Tables are row-major with
// 32-byte rows (one DRAM sector, read as two 16-byte __ldg loads), so each
// corner costs one sector instead of the 6-8 scattered words of the JAX
// channel-major layout; the packed table orders its cells with x fastest,
// so K1's two x corners are neighbouring rows, one or two 64-byte DRAM
// accesses that share a page where rows ny * nyaw apart cost two
// unrelated ones; outputs are channel-major, so a warp's store is one
// contiguous line.
//
// K1's design (K2 keeps one thread per sample):
// - the packed table orders its cells with x fastest (above);
// - the mode is compiled in: exact and want_jac are template parameters,
//   so the solver's hi-only instantiation carries no residual loads;
// - index math is 32-bit when the table has fewer than 2^31 16-byte words
//   (every map the planner builds), 64-bit otherwise: a second
//   instantiation, chosen by the wrapper from the table size;
// - a thread per sample, its pose and row loads issued before its math,
//   while that gives every SM a block or more;
// - fewer samples (the pipeline's solver step): the time is one thread's
//   dependent chain on a few SMs, so a sample is spread over a quad of
//   lanes: lane ch < 3 loads the half-rows of channel ch (words 2ch,
//   2ch + 1) and blends that channel, the quad exchanges the 12 blended
//   values by __shfl_sync, lane k < 3 forms column k of J and lane 3 tv,
//   and each lane stores its share.
// On the card (PERF.md, chip_studies/k1_ablation.py) J's stores and the
// pose-dependent row loads take most of the time at the headline's size
// and the tail's arithmetic at most a thirtieth: bytes, not the chain, set
// it there; the x-fastest order cut the row loads' cost by about a third.
// Resident-grid variants with two samples in flight per thread lost to a
// thread per sample at every size measured.
// Every sample takes the same operations in the same order in both
// layouts, so both equal the plain twin bit for bit.
//
// Semantics follow the JAX functions line by line, in fp32: floor-based
// cell index, clamped xy corners (jnp.take mode="clip"), wrapped yaw index,
// the low-y rule wy = 0 where iyf < 0 (packed path only), the strict in-map
// mask with 1e-4 margins, NaN-propagating maximum(., 1e-12) floors, and
// derivatives that equal JAX autodiff (floor has derivative 0, so2_diff has
// derivative 1 in its first argument, maximum passes no gradient where the
// floor is active).  Build with -fmad=false so that products and sums round
// exactly as the plain PyTorch twin's separate operations do.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct Geom {
  int nx, ny, nyaw;
  long long ncells;
  float res, yres, ox, oy, oyaw, half_res, half_yres;
  float lo_x, hi_x, lo_y, hi_y;  // in-map thresholds (margins folded in)
};

__device__ __forceinline__ float normalize_so2(float y) {
  return y - kTwoPi * floorf((y + kPi) / kTwoPi);
}

__device__ __forceinline__ float so2_diff(float a, float b) {
  const float d = a - b;
  return atan2f(sinf(d), cosf(d));
}

// jnp.maximum(x, lo): NaN propagates (fmaxf would drop it)
__device__ __forceinline__ float floor_at(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename Idx>
__device__ __forceinline__ Idx clamp_to(Idx v, Idx lo, Idx hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// clamp(i, 0, n - 1) and clamp(i + 1, 0, n - 1) without forming i + 1 where
// it could overflow (i saturates at INT_MAX in 32-bit index math)
template <typename Idx>
__device__ __forceinline__ void clamp_pair(Idx i, Idx n, Idx& lo, Idx& hi) {
  lo = clamp_to<Idx>(i, 0, n - 1);
  hi = i < 0 ? Idx(0) : (i >= n - 1 ? n - 1 : i + 1);
}

// floored cell coordinates: all the table rows depend on
struct CellF {
  float ixf, iyf, iwf;
};

template <typename Idx>
struct Cell {
  float wx, wy, wt;
  bool low, inside;
  Idx ix0, ix1, iy0, iy1, iw;
};

// grid.py:571-583 (packed16, low_y_rule) and grid.py:803-815 (pair), in
// three steps so that the table loads can be issued as soon as the indices
// exist: the floored coordinates, the indices, the weights.
__device__ __forceinline__ CellF cell_floor(const Geom& g, float px,
                                            float py, float yaw) {
  CellF f;
  f.ixf = floorf((px - g.half_res - g.ox) / g.res);
  f.iyf = floorf((py - g.half_res - g.oy) / g.res);
  const float ywm = normalize_so2(yaw - g.half_yres);
  f.iwf = floorf((ywm - g.oyaw) / g.yres);
  return f;
}

template <typename Idx>
__device__ __forceinline__ void cell_index(const Geom& g, const CellF& f,
                                           Cell<Idx>& c) {
  // float -> int saturates and maps NaN to 0; the clamps keep every index
  // inside the table whatever the pose
  const Idx ix = __float2int_rz(f.ixf);
  const Idx iy = __float2int_rz(f.iyf);
  const Idx iw = __float2int_rz(f.iwf);
  clamp_pair<Idx>(ix, g.nx, c.ix0, c.ix1);
  clamp_pair<Idx>(iy, g.ny, c.iy0, c.iy1);
  c.iw = ((iw % g.nyaw) + g.nyaw) % g.nyaw;
}

template <typename Idx>
__device__ __forceinline__ void cell_weights(const Geom& g, float px,
                                             float py, float yaw,
                                             const CellF& f, bool low_y_rule,
                                             Cell<Idx>& c) {
  c.wx = (px - ((f.ixf + 0.5f) * g.res + g.ox)) / g.res;
  const float wy = (py - ((f.iyf + 0.5f) * g.res + g.oy)) / g.res;
  c.low = low_y_rule && (f.iyf < 0.f);
  c.wy = c.low ? 0.f : wy;
  c.wt = so2_diff(yaw, (f.iwf + 0.5f) * g.yres + g.oyaw) / g.yres;
  c.inside = (px > g.lo_x) && (px < g.hi_x) && (py > g.lo_y) && (py < g.hi_y);
}

template <typename Idx>
__device__ __forceinline__ Cell<Idx> cell_setup(const Geom& g, float px,
                                                float py, float yaw,
                                                bool low_y_rule) {
  const CellF f = cell_floor(g, px, py, yaw);
  Cell<Idx> c;
  cell_index<Idx>(g, f, c);
  cell_weights<Idx>(g, px, py, yaw, f, low_y_rule, c);
  return c;
}

// _tv_from_fields (grid.py:700-712) and its Jacobian, in parts: what tv and
// every column of J share, tv, and column k of J (the field derivatives
// along coordinate k of (px, py, yaw); yaw also enters directly).
struct Tail {
  float zb0, zb1, q, c, inv_c, cy, sy, t, s, p, sq, inv_sq;
};

__device__ __forceinline__ Tail tail_common(float zb0, float zb1,
                                            float yaw) {
  Tail a;
  a.zb0 = zb0;
  a.zb1 = zb1;
  a.q = 1.f - zb0 * zb0 - zb1 * zb1;
  a.c = sqrtf(floor_at(a.q, 1e-12f));
  a.inv_c = 1.f / a.c;
  a.cy = cosf(yaw);
  a.sy = sinf(yaw);
  a.t = a.cy * zb0 + a.sy * zb1;
  a.s = a.sy * zb0 - a.cy * zb1;
  a.p = 1.f - a.t * a.t;
  a.sq = sqrtf(floor_at(a.p, 1e-12f));
  a.inv_sq = 1.f / a.sq;
  return a;
}

__device__ __forceinline__ void tail_tv(const Tail& a, float sig,
                                        float* tv) {
  tv[0] = a.inv_sq;
  tv[1] = -a.c * a.t * a.inv_sq;
  tv[2] = a.sq * a.inv_c;
  tv[3] = a.s * a.inv_sq;
  tv[4] = a.c;
  tv[5] = a.inv_c;
  tv[6] = sig;
}

// Jk[r] = d tv_r / d coordinate k
__device__ __forceinline__ void tail_jac(const Tail& a, int k, float dsig,
                                         float dzb0, float dzb1, float* Jk) {
  const float dc = (a.q > 1e-12f) ? -(a.zb0 * dzb0 + a.zb1 * dzb1) / a.c
                                  : 0.f;
  const float dt = a.cy * dzb0 + a.sy * dzb1 + (k == 2 ? -a.s : 0.f);
  const float ds = a.sy * dzb0 - a.cy * dzb1 + (k == 2 ? a.t : 0.f);
  const float dsq = (a.p > 1e-12f) ? -a.t * dt / a.sq : 0.f;
  const float dinv_sq = -a.inv_sq * a.inv_sq * dsq;
  const float dinv_c = -a.inv_c * a.inv_c * dc;
  Jk[0] = dinv_sq;
  Jk[1] = -(dc * a.t * a.inv_sq + a.c * dt * a.inv_sq + a.c * a.t * dinv_sq);
  Jk[2] = dsq * a.inv_c + a.sq * dinv_c;
  Jk[3] = ds * a.inv_sq + a.s * dinv_sq;
  Jk[4] = dc;
  Jk[5] = dinv_c;
  Jk[6] = dsig;
}

__device__ __forceinline__ void tv_tail(float sig, float zb0, float zb1,
                                        float yaw, const float* dsig,
                                        const float* dzb0, const float* dzb1,
                                        bool want_jac, float* tv, float* J) {
  const Tail a = tail_common(zb0, zb1, yaw);
  tail_tv(a, sig, tv);
  if (!want_jac) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float Jk[7];
    tail_jac(a, k, dsig[k], dzb0[k], dzb1[k], Jk);
#pragma unroll
    for (int r = 0; r < 7; ++r) J[r * 3 + k] = Jk[r];
  }
}

__device__ __forceinline__ void store(float* __restrict__ tv,
                                      float* __restrict__ jac, int i, int M,
                                      bool want_jac, const float* t,
                                      const float* J) {
#pragma unroll
  for (int k = 0; k < 7; ++k) tv[(long long)k * M + i] = t[k];
  if (!want_jac) return;
#pragma unroll
  for (int k = 0; k < 21; ++k) jac[(long long)k * M + i] = J[k];
}

// f16 pair word -> (value at yaw w, value at yaw w+1); grid.py:548-554
__device__ __forceinline__ void unpack_pair(uint32_t u, float& v_w0,
                                            float& v_w1) {
  v_w0 = __half2float(__ushort_as_half((unsigned short)(u >> 16)));
  v_w1 = __half2float(__ushort_as_half((unsigned short)(u & 0xFFFFu)));
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// row of the packed table of the corner (ix, iy) at yaw index iw: cells
// are ordered with x fastest (terrain/grid.py:packed16_row), so the two x
// corners of a lookup are neighbouring rows
template <typename Idx>
__device__ __forceinline__ Idx packed_row(const Geom& g, Idx ix, Idx iy,
                                          Idx iw) {
  return clamp_to<Idx>((iy * (Idx)g.nyaw + iw) * (Idx)g.nx + ix, 0,
                       (Idx)(2 * g.ncells - 1));
}

// its f16 residual row, at +ncells
template <typename Idx>
__device__ __forceinline__ Idx residual_row(const Geom& g, Idx row) {
  return clamp_to<Idx>(row + (Idx)g.ncells, 0, (Idx)(2 * g.ncells - 1));
}

// The blends of one channel (grid.py:584-608) from its two words: a[cx][yy]
// and b[cx][yy] are word 2 ch + yy of x corner cx at yaw w and w + 1.
struct Chan {
  float val, dx, dy, dw;
};

__device__ __forceinline__ Chan blend_channel(const float (&a)[2][2],
                                              const float (&b)[2][2],
                                              float wx, float wy, float wt,
                                              bool low, bool inside,
                                              const Geom& g) {
  float vw[2][2];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx)
#pragma unroll
    for (int yy = 0; yy < 2; ++yy)
      vw[cx][yy] = a[cx][yy] * (1.f - wt) + b[cx][yy] * wt;
  const float vy0 = vw[0][0] * (1.f - wy) + vw[0][1] * wy;
  const float vy1 = vw[1][0] * (1.f - wy) + vw[1][1] * wy;
  Chan r;
  r.val = vy0 * (1.f - wx) + vy1 * wx;
  r.dx = (vy1 - vy0) / g.res;
  r.dy = low ? 0.f
             : ((vw[0][1] - vw[0][0]) * (1.f - wx) +
                (vw[1][1] - vw[1][0]) * wx) / g.res;
  const float e0 = (b[0][0] - a[0][0]) * (1.f - wy) +
                   (b[0][1] - a[0][1]) * wy;
  const float e1 = (b[1][0] - a[1][0]) * (1.f - wy) +
                   (b[1][1] - a[1][1]) * wy;
  r.dw = (e0 * (1.f - wx) + e1 * wx) / g.yres;
  if (!inside) r.val = r.dx = r.dy = r.dw = 0.f;
  return r;
}

// Many samples: a thread per sample, its pose and row loads issued before
// its math.
template <bool EXACT, bool JAC, typename Idx>
__global__ void __launch_bounds__(256)
tv_packed16_thread(const float* __restrict__ px,
                   const float* __restrict__ py,
                   const float* __restrict__ yaw,
                   const uint4* __restrict__ table, float* __restrict__ tv,
                   float* __restrict__ jac, int M, Geom g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const float x = __ldg(px + i), y = __ldg(py + i), w = __ldg(yaw + i);
  const CellF f = cell_floor(g, x, y, w);
  Cell<Idx> c;
  cell_index<Idx>(g, f, c);
  uint4 raw[2][EXACT ? 4 : 2];  // [x corner]: hi halves, then residual ones
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
    const Idx row = packed_row<Idx>(g, cx ? c.ix1 : c.ix0, c.iy0, c.iw);
    raw[cx][0] = __ldg(table + 2 * row);
    raw[cx][1] = __ldg(table + 2 * row + 1);
    if constexpr (EXACT) {
      const Idx res = residual_row<Idx>(g, row);
      raw[cx][2] = __ldg(table + 2 * res);
      raw[cx][3] = __ldg(table + 2 * res + 1);
    }
  }
  cell_weights<Idx>(g, x, y, w, f, true, c);
  // v0/v1[x corner][word]: values at yaw w / w+1; word = 2*ch + yy
  float v0[2][6], v1[2][6];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
    const uint32_t wd[6] = {raw[cx][0].x, raw[cx][0].y, raw[cx][0].z,
                            raw[cx][0].w, raw[cx][1].x, raw[cx][1].y};
#pragma unroll
    for (int k = 0; k < 6; ++k) unpack_pair(wd[k], v0[cx][k], v1[cx][k]);
    if constexpr (EXACT) {
      const uint4 rlo = raw[cx][2], rhi = raw[cx][3];
      const uint32_t rw[6] = {rlo.x, rlo.y, rlo.z, rlo.w, rhi.x, rhi.y};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float r0, r1;
        unpack_pair(rw[k], r0, r1);
        v0[cx][k] = v0[cx][k] + r0;
        v1[cx][k] = v1[cx][k] + r1;
      }
    }
  }
  Chan ch[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a[2][2] = {{v0[0][2 * k], v0[0][2 * k + 1]},
                           {v0[1][2 * k], v0[1][2 * k + 1]}};
    const float b[2][2] = {{v1[0][2 * k], v1[0][2 * k + 1]},
                           {v1[1][2 * k], v1[1][2 * k + 1]}};
    ch[k] = blend_channel(a, b, c.wx, c.wy, c.wt, c.low, c.inside, g);
  }
  const float dsig[3] = {ch[0].dx, ch[0].dy, ch[0].dw};
  const float dzb0[3] = {ch[1].dx, ch[1].dy, ch[1].dw};
  const float dzb1[3] = {ch[2].dx, ch[2].dy, ch[2].dw};
  float t[7], J[21];
  tv_tail(ch[0].val, ch[1].val, ch[2].val, w, dsig, dzb0, dzb1, JAC, t, J);
  store(tv, jac, i, M, JAC, t, J);
}

// Few samples: a quad of lanes per sample (see the top of the file).  Every
// lane of a warp takes part in the exchange: lanes past the end work on the
// last sample and store nothing.
template <bool EXACT, bool JAC, typename Idx>
__global__ void __launch_bounds__(256)
tv_packed16_quad(const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ yaw,
                 const uint4* __restrict__ table, float* __restrict__ tv,
                 float* __restrict__ jac, int M, Geom g) {
  const long long gi = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int q = threadIdx.x & 3;
  const int lead = (threadIdx.x & 31) & ~3;  // the quad's lane 0
  const bool ok = gi < M;
  const int i = ok ? (int)gi : M - 1;
  const float x = __ldg(px + i), y = __ldg(py + i), w = __ldg(yaw + i);
  const CellF f = cell_floor(g, x, y, w);
  Cell<Idx> c;
  cell_index<Idx>(g, f, c);
  // lane q blends channel q (lane 3 channel 0 again, unused): words 2ch and
  // 2ch + 1, in half `half` of each row
  const int ch = q == 3 ? 0 : q;
  const int half = ch == 2 ? 1 : 0;
  uint4 hv[2], rv[2];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
    const Idx row = packed_row<Idx>(g, cx ? c.ix1 : c.ix0, c.iy0, c.iw);
    hv[cx] = __ldg(table + 2 * row + half);
    if constexpr (EXACT)
      rv[cx] = __ldg(table + 2 * residual_row<Idx>(g, row) + half);
  }
  cell_weights<Idx>(g, x, y, w, f, true, c);
  float a[2][2], b[2][2];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
    const bool zw = ch == 1;  // words 2, 3 are the half's .z, .w
    unpack_pair(zw ? hv[cx].z : hv[cx].x, a[cx][0], b[cx][0]);
    unpack_pair(zw ? hv[cx].w : hv[cx].y, a[cx][1], b[cx][1]);
    if constexpr (EXACT) {
      float r[2][2];
      unpack_pair(zw ? rv[cx].z : rv[cx].x, r[0][0], r[1][0]);
      unpack_pair(zw ? rv[cx].w : rv[cx].y, r[0][1], r[1][1]);
#pragma unroll
      for (int yy = 0; yy < 2; ++yy) {
        a[cx][yy] = a[cx][yy] + r[0][yy];
        b[cx][yy] = b[cx][yy] + r[1][yy];
      }
    }
  }
  const Chan mine = blend_channel(a, b, c.wx, c.wy, c.wt, c.low, c.inside, g);
  // every lane gets the three channels' values, and lane k < 3 their
  // derivatives along coordinate k
  float val[3], dk[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    val[k] = __shfl_sync(0xffffffffu, mine.val, lead + k);
    const float dx = __shfl_sync(0xffffffffu, mine.dx, lead + k);
    const float dy = __shfl_sync(0xffffffffu, mine.dy, lead + k);
    const float dw = __shfl_sync(0xffffffffu, mine.dw, lead + k);
    dk[k] = q == 0 ? dx : (q == 1 ? dy : dw);
  }
  const Tail tl = tail_common(val[1], val[2], w);
  if (!ok) return;
  if (JAC && q < 3) {
    float Jk[7];
    tail_jac(tl, q, dk[0], dk[1], dk[2], Jk);
#pragma unroll
    for (int r = 0; r < 7; ++r) jac[(long long)(3 * r + q) * M + i] = Jk[r];
  } else {
    float t[7];
    tail_tv(tl, val[0], t);
    // with J, lane 3 stores all of tv; without, the quad shares it
#pragma unroll
    for (int r = 0; r < 7; ++r)
      if (JAC || (r & 3) == q) tv[(long long)r * M + i] = t[r];
  }
}

__global__ void __launch_bounds__(256)
tv_pair_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ yaw,
               const float4* __restrict__ table, float* __restrict__ tv,
               float* __restrict__ jac, int M, Geom g, int want_jac) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const float x = px[i], y = py[i], w = yaw[i];
  const Cell<long long> c = cell_setup<long long>(g, x, y, w, false);
  const long long last = g.ncells - 1;
  // corners (x0,y0), (x0,y1), (x1,y0), (x1,y1); row = (z,sig,zb0,zb1) at
  // yaw w, then the same at w+1 (with_pair_table)
  const long long row[4] = {
      clampll((c.ix0 * g.ny + c.iy0) * g.nyaw + c.iw, 0, last),
      clampll((c.ix0 * g.ny + c.iy1) * g.nyaw + c.iw, 0, last),
      clampll((c.ix1 * g.ny + c.iy0) * g.nyaw + c.iw, 0, last),
      clampll((c.ix1 * g.ny + c.iy1) * g.nyaw + c.iw, 0, last)};
  const float wx = c.wx, wy = c.wy, wt = c.wt;
  const float wxy[4] = {(1.f - wx) * (1.f - wy), (1.f - wx) * wy,
                        wx * (1.f - wy), wx * wy};
  const float gx[4] = {-(1.f - wy), -wy, 1.f - wy, wy};
  const float gy[4] = {-(1.f - wx), 1.f - wx, -wx, wx};
  float vy[4][3], dv[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = __ldg(table + 2 * row[k]);
    const float4 b = __ldg(table + 2 * row[k] + 1);
    const float at[3] = {a.y, a.z, a.w};  // (sig, zb0, zb1) at w
    const float bt[3] = {b.y, b.z, b.w};  // at w+1
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      vy[k][ch] = at[ch] * (1.f - wt) + bt[ch] * wt;
      dv[k][ch] = bt[ch] - at[ch];
    }
  }
  float val[3], dx[3], dy[3], dw[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    val[ch] = vy[0][ch] * wxy[0] + vy[1][ch] * wxy[1] + vy[2][ch] * wxy[2] +
              vy[3][ch] * wxy[3];
    dx[ch] = (vy[0][ch] * gx[0] + vy[1][ch] * gx[1] + vy[2][ch] * gx[2] +
              vy[3][ch] * gx[3]) / g.res;
    dy[ch] = (vy[0][ch] * gy[0] + vy[1][ch] * gy[1] + vy[2][ch] * gy[2] +
              vy[3][ch] * gy[3]) / g.res;
    dw[ch] = (dv[0][ch] * wxy[0] + dv[1][ch] * wxy[1] + dv[2][ch] * wxy[2] +
              dv[3][ch] * wxy[3]) / g.yres;
    if (!c.inside) val[ch] = dx[ch] = dy[ch] = dw[ch] = 0.f;
  }
  const float dsig[3] = {dx[0], dy[0], dw[0]};
  const float dzb0[3] = {dx[1], dy[1], dw[1]};
  const float dzb1[3] = {dx[2], dy[2], dw[2]};
  float t[7], J[21];
  tv_tail(val[0], val[1], val[2], w, dsig, dzb0, dzb1, want_jac, t, J);
  store(tv, jac, i, M, want_jac, t, J);
}

Geom make_geom(int nx, int ny, int nyaw, float res, float yres, float ox,
               float oy, float oyaw, float half_res, float half_yres,
               float lo_x, float hi_x, float lo_y, float hi_y) {
  Geom g;
  g.nx = nx;
  g.ny = ny;
  g.nyaw = nyaw;
  g.ncells = (long long)nx * ny * nyaw;
  g.res = res;
  g.yres = yres;
  g.ox = ox;
  g.oy = oy;
  g.oyaw = oyaw;
  g.half_res = half_res;
  g.half_yres = half_yres;
  g.lo_x = lo_x;
  g.hi_x = hi_x;
  g.lo_y = lo_y;
  g.hi_y = hi_y;
  return g;
}

constexpr int kThreads = 256;
// K1's blocks: more, smaller blocks spread a launch below a few waves more
// evenly over the SMs (3-5% at the planning step's 43,520 lookups, even at
// the headline's; chip_studies/k1_ablation.py)
constexpr int kK1Block = 128;

template <bool EXACT, bool JAC, typename Idx>
int launch_packed16(const float* px, const float* py, const float* yaw,
                    const uint4* table, float* tv, float* jac, int M,
                    const Geom& g, bool quad, cudaStream_t stream) {
  const long long threads = quad ? 4LL * M : (long long)M;
  const unsigned blocks = (unsigned)((threads + kK1Block - 1) / kK1Block);
  if (quad)
    tv_packed16_quad<EXACT, JAC, Idx><<<blocks, kK1Block, 0, stream>>>(
        px, py, yaw, table, tv, jac, M, g);
  else
    tv_packed16_thread<EXACT, JAC, Idx><<<blocks, kK1Block, 0, stream>>>(
        px, py, yaw, table, tv, jac, M, g);
  return (int)cudaGetLastError();
}

template <bool EXACT, bool JAC>
int launch_packed16_idx(const float* px, const float* py, const float* yaw,
                        const uint4* table, float* tv, float* jac, int M,
                        const Geom& g, bool idx32, bool quad,
                        cudaStream_t stream) {
  return idx32 ? launch_packed16<EXACT, JAC, int>(px, py, yaw, table, tv,
                                                   jac, M, g, quad, stream)
               : launch_packed16<EXACT, JAC, long long>(
                     px, py, yaw, table, tv, jac, M, g, quad, stream);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers; the
// caller checks device, dtype, shape and contiguity.
//
// K1: `idx32` selects 32-bit index math (the caller's promise that the
// table has fewer than 2^31 16-byte words, refused otherwise), `quad` a
// quad of lanes per sample over a thread per sample.
int terrain_tv_packed16(const float* px, const float* py, const float* yaw,
                        const void* table, float* tv, float* jac, int M,
                        int nx, int ny, int nyaw, float res, float yres,
                        float ox, float oy, float oyaw, float half_res,
                        float half_yres, float lo_x, float hi_x, float lo_y,
                        float hi_y, int exact, int want_jac, int idx32,
                        int quad, void* stream) {
  const Geom g = make_geom(nx, ny, nyaw, res, yres, ox, oy, oyaw, half_res,
                           half_yres, lo_x, hi_x, lo_y, hi_y);
  if (M <= 0) return (int)cudaErrorInvalidValue;
  if (idx32 && 4 * g.ncells >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const uint4* t = (const uint4*)table;
  cudaStream_t s = (cudaStream_t)stream;
  if (exact)
    return want_jac ? launch_packed16_idx<true, true>(px, py, yaw, t, tv, jac,
                                                      M, g, idx32, quad, s)
                    : launch_packed16_idx<true, false>(px, py, yaw, t, tv,
                                                       jac, M, g, idx32, quad,
                                                       s);
  return want_jac ? launch_packed16_idx<false, true>(px, py, yaw, t, tv, jac,
                                                     M, g, idx32, quad, s)
                  : launch_packed16_idx<false, false>(px, py, yaw, t, tv, jac,
                                                      M, g, idx32, quad, s);
}

int terrain_tv_pair(const float* px, const float* py, const float* yaw,
                    const void* table, float* tv, float* jac, int M, int nx,
                    int ny, int nyaw, float res, float yres, float ox,
                    float oy, float oyaw, float half_res, float half_yres,
                    float lo_x, float hi_x, float lo_y, float hi_y,
                    int want_jac, void* stream) {
  const Geom g = make_geom(nx, ny, nyaw, res, yres, ox, oy, oyaw, half_res,
                           half_yres, lo_x, hi_x, lo_y, hi_y);
  const int blocks = (M + kThreads - 1) / kThreads;
  tv_pair_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      px, py, yaw, (const float4*)table, tv, jac, M, g, want_jac);
  return (int)cudaGetLastError();
}

const char* terrain_lookup_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
