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
// channel-major layout; both tables order their cells with x fastest, so
// a lookup's two x corners are neighbouring rows, one or two 64-byte DRAM
// accesses that share a page where rows ny * nyaw apart cost two
// unrelated ones (K2 reads four rows per lookup: two such pairs); outputs
// are channel-major, so a warp's store is one contiguous line.
//
// K1's design, which K2 shares:
// - the tables order their cells with x fastest (above);
// - the mode is compiled in: exact and want_jac are template parameters,
//   so the solver's hi-only instantiation carries no residual loads;
// - index math is 32-bit when the table has fewer than 2^31 16-byte words
//   (every map the planner builds), 64-bit otherwise: a second
//   instantiation, chosen by the wrapper from the table size;
// - a thread per sample, its pose and row loads issued before its math,
//   while that gives every SM a block or more;
// - fewer samples (the pipeline's solver step): the time is one thread's
//   dependent chain on a few SMs, so a sample is spread over a quad of
//   lanes: lane ch < 3 loads the words of channel ch (K1: the half-rows
//   holding words 2ch, 2ch + 1; K2: two words of each of the four rows)
//   and blends that channel, the quad exchanges the 12 blended values by
//   __shfl_sync, lane k < 3 forms column k of J and lane 3 tv, and each
//   lane stores its share (`quad_finish`, one function for both).
// On the card (PERF.md, chip_studies/k1_ablation.py) J's stores and the
// pose-dependent row loads take most of the time at the headline's size
// and the tail's arithmetic at most a thirtieth: bytes, not the chain, set
// it there; the x-fastest order cut K1's row loads' cost by about a third
// and K2's time at the headline by a sixth (chip_studies/k2_ablation.py).
// Resident-grid variants with two samples in flight per thread lost to a
// thread per sample at every size measured.
// Every sample takes the same operations in the same order in both
// layouts, so both equal the plain twin bit for bit.
//
// Both kernels are templated on the element type: float32 for the
// solver's grids, float64 for a float64 grid: K1 then blends its f16 values, widened, with float64 weights (the JAX
// function under x64, grid.py:557-608), and K2 reads a float64 pair table
// of 64-byte rows as four 16-byte words.
//
// Semantics follow the JAX functions line by line: floor-based
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

// The element type T of poses, weights, blends and outputs: float, or double
// for a float64 grid (K1 then widens its f16 values to double before the
// blends, as the JAX function does under x64; K2 reads a float64 pair
// table).  The float constants are the ones the float32 path always had.
template <typename T>
struct Num;
template <>
struct Num<float> {
  static constexpr float pi = 3.14159265358979323846f;
  static constexpr float two_pi = 6.28318530717958647692f;
  static constexpr float tiny = 1e-12f;  // the floors of _tv_from_fields
};
template <>
struct Num<double> {
  static constexpr double pi = 3.14159265358979323846;
  static constexpr double two_pi = 6.28318530717958647692;
  static constexpr double tiny = 1e-12;
};

// correctly rounded (sqrt) or the CUDA math library's functions, as the
// plain PyTorch twin's elementwise operations call them
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float atan2_(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double atan2_(double y, double x) {
  return atan2(y, x);
}
// float -> int saturates and maps NaN to 0, toward zero
__device__ __forceinline__ int to_int_rz(float x) { return __float2int_rz(x); }
__device__ __forceinline__ int to_int_rz(double x) {
  return __double2int_rz(x);
}

template <typename T>
struct Geom {
  int nx, ny, nyaw;
  long long ncells;
  T res, yres, ox, oy, oyaw, half_res, half_yres;
  T lo_x, hi_x, lo_y, hi_y;  // in-map thresholds (margins folded in)
};

template <typename T>
__device__ __forceinline__ T normalize_so2(T y) {
  return y - Num<T>::two_pi * floor_((y + Num<T>::pi) / Num<T>::two_pi);
}

template <typename T>
__device__ __forceinline__ T so2_diff(T a, T b) {
  const T d = a - b;
  return atan2_(sin_(d), cos_(d));
}

// jnp.maximum(x, lo): NaN propagates (fmaxf would drop it)
template <typename T>
__device__ __forceinline__ T floor_at(T x, T lo) {
  return x < lo ? lo : x;
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
template <typename T>
struct CellF {
  T ixf, iyf, iwf;
};

template <typename T, typename Idx>
struct Cell {
  T wx, wy, wt;
  bool low, inside;
  Idx ix0, ix1, iy0, iy1, iw;
};

// grid.py:571-583 (packed16, low_y_rule) and grid.py:803-815 (pair), in
// three steps so that the table loads can be issued as soon as the indices
// exist: the floored coordinates, the indices, the weights.
template <typename T>
__device__ __forceinline__ CellF<T> cell_floor(const Geom<T>& g, T px, T py,
                                               T yaw) {
  CellF<T> f;
  f.ixf = floor_((px - g.half_res - g.ox) / g.res);
  f.iyf = floor_((py - g.half_res - g.oy) / g.res);
  const T ywm = normalize_so2<T>(yaw - g.half_yres);
  f.iwf = floor_((ywm - g.oyaw) / g.yres);
  return f;
}

template <typename T, typename Idx>
__device__ __forceinline__ void cell_index(const Geom<T>& g,
                                           const CellF<T>& f,
                                           Cell<T, Idx>& c) {
  // the clamps keep every index inside the table whatever the pose
  const Idx ix = to_int_rz(f.ixf);
  const Idx iy = to_int_rz(f.iyf);
  const Idx iw = to_int_rz(f.iwf);
  clamp_pair<Idx>(ix, g.nx, c.ix0, c.ix1);
  clamp_pair<Idx>(iy, g.ny, c.iy0, c.iy1);
  c.iw = ((iw % g.nyaw) + g.nyaw) % g.nyaw;
}

template <typename T, typename Idx>
__device__ __forceinline__ void cell_weights(const Geom<T>& g, T px, T py,
                                             T yaw, const CellF<T>& f,
                                             bool low_y_rule,
                                             Cell<T, Idx>& c) {
  c.wx = (px - ((f.ixf + T(0.5)) * g.res + g.ox)) / g.res;
  const T wy = (py - ((f.iyf + T(0.5)) * g.res + g.oy)) / g.res;
  c.low = low_y_rule && (f.iyf < T(0));
  c.wy = c.low ? T(0) : wy;
  c.wt = so2_diff<T>(yaw, (f.iwf + T(0.5)) * g.yres + g.oyaw) / g.yres;
  c.inside = (px > g.lo_x) && (px < g.hi_x) && (py > g.lo_y) && (py < g.hi_y);
}

// _tv_from_fields (grid.py:700-712) and its Jacobian, in parts: what tv and
// every column of J share, tv, and column k of J (the field derivatives
// along coordinate k of (px, py, yaw); yaw also enters directly).
template <typename T>
struct Tail {
  T zb0, zb1, q, c, inv_c, cy, sy, t, s, p, sq, inv_sq;
};

template <typename T>
__device__ __forceinline__ Tail<T> tail_common(T zb0, T zb1, T yaw) {
  Tail<T> a;
  a.zb0 = zb0;
  a.zb1 = zb1;
  a.q = T(1) - zb0 * zb0 - zb1 * zb1;
  a.c = sqrt_(floor_at(a.q, Num<T>::tiny));
  a.inv_c = T(1) / a.c;
  a.cy = cos_(yaw);
  a.sy = sin_(yaw);
  a.t = a.cy * zb0 + a.sy * zb1;
  a.s = a.sy * zb0 - a.cy * zb1;
  a.p = T(1) - a.t * a.t;
  a.sq = sqrt_(floor_at(a.p, Num<T>::tiny));
  a.inv_sq = T(1) / a.sq;
  return a;
}

template <typename T>
__device__ __forceinline__ void tail_tv(const Tail<T>& a, T sig, T* tv) {
  tv[0] = a.inv_sq;
  tv[1] = -a.c * a.t * a.inv_sq;
  tv[2] = a.sq * a.inv_c;
  tv[3] = a.s * a.inv_sq;
  tv[4] = a.c;
  tv[5] = a.inv_c;
  tv[6] = sig;
}

// Jk[r] = d tv_r / d coordinate k
template <typename T>
__device__ __forceinline__ void tail_jac(const Tail<T>& a, int k, T dsig,
                                         T dzb0, T dzb1, T* Jk) {
  const T dc = (a.q > Num<T>::tiny) ? -(a.zb0 * dzb0 + a.zb1 * dzb1) / a.c
                                    : T(0);
  const T dt = a.cy * dzb0 + a.sy * dzb1 + (k == 2 ? -a.s : T(0));
  const T ds = a.sy * dzb0 - a.cy * dzb1 + (k == 2 ? a.t : T(0));
  const T dsq = (a.p > Num<T>::tiny) ? -a.t * dt / a.sq : T(0);
  const T dinv_sq = -a.inv_sq * a.inv_sq * dsq;
  const T dinv_c = -a.inv_c * a.inv_c * dc;
  Jk[0] = dinv_sq;
  Jk[1] = -(dc * a.t * a.inv_sq + a.c * dt * a.inv_sq + a.c * a.t * dinv_sq);
  Jk[2] = dsq * a.inv_c + a.sq * dinv_c;
  Jk[3] = ds * a.inv_sq + a.s * dinv_sq;
  Jk[4] = dc;
  Jk[5] = dinv_c;
  Jk[6] = dsig;
}

template <typename T>
__device__ __forceinline__ void tv_tail(T sig, T zb0, T zb1, T yaw,
                                        const T* dsig, const T* dzb0,
                                        const T* dzb1, bool want_jac, T* tv,
                                        T* J) {
  const Tail<T> a = tail_common<T>(zb0, zb1, yaw);
  tail_tv<T>(a, sig, tv);
  if (!want_jac) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T Jk[7];
    tail_jac<T>(a, k, dsig[k], dzb0[k], dzb1[k], Jk);
#pragma unroll
    for (int r = 0; r < 7; ++r) J[r * 3 + k] = Jk[r];
  }
}

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ tv, T* __restrict__ jac,
                                      int i, int M, bool want_jac,
                                      const T* t, const T* J) {
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
template <typename T, typename Idx>
__device__ __forceinline__ Idx packed_row(const Geom<T>& g, Idx ix, Idx iy,
                                          Idx iw) {
  return clamp_to<Idx>((iy * (Idx)g.nyaw + iw) * (Idx)g.nx + ix, 0,
                       (Idx)(2 * g.ncells - 1));
}

// its f16 residual row, at +ncells
template <typename T, typename Idx>
__device__ __forceinline__ Idx residual_row(const Geom<T>& g, Idx row) {
  return clamp_to<Idx>(row + (Idx)g.ncells, 0, (Idx)(2 * g.ncells - 1));
}

// The blends of one channel (grid.py:584-608) from its two words: a[cx][yy]
// and b[cx][yy] are word 2 ch + yy of x corner cx at yaw w and w + 1.
template <typename T>
struct Chan {
  T val, dx, dy, dw;
};

template <typename T>
__device__ __forceinline__ Chan<T> blend_channel(const T (&a)[2][2],
                                                 const T (&b)[2][2], T wx,
                                                 T wy, T wt, bool low,
                                                 bool inside,
                                                 const Geom<T>& g) {
  T vw[2][2];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx)
#pragma unroll
    for (int yy = 0; yy < 2; ++yy)
      vw[cx][yy] = a[cx][yy] * (T(1) - wt) + b[cx][yy] * wt;
  const T vy0 = vw[0][0] * (T(1) - wy) + vw[0][1] * wy;
  const T vy1 = vw[1][0] * (T(1) - wy) + vw[1][1] * wy;
  Chan<T> r;
  r.val = vy0 * (T(1) - wx) + vy1 * wx;
  r.dx = (vy1 - vy0) / g.res;
  r.dy = low ? T(0)
             : ((vw[0][1] - vw[0][0]) * (T(1) - wx) +
                (vw[1][1] - vw[1][0]) * wx) / g.res;
  const T e0 = (b[0][0] - a[0][0]) * (T(1) - wy) + (b[0][1] - a[0][1]) * wy;
  const T e1 = (b[1][0] - a[1][0]) * (T(1) - wy) + (b[1][1] - a[1][1]) * wy;
  r.dw = (e0 * (T(1) - wx) + e1 * wx) / g.yres;
  if (!inside) r.val = r.dx = r.dy = r.dw = T(0);
  return r;
}

// Many samples: a thread per sample, its pose and row loads issued before
// its math.  The f16 values (hi + residual in float in exact mode, as the
// twin adds them) are widened to T before the blends.
template <typename T, bool EXACT, bool JAC, typename Idx>
__global__ void __launch_bounds__(256)
tv_packed16_thread(const T* __restrict__ px, const T* __restrict__ py,
                   const T* __restrict__ yaw, const uint4* __restrict__ table,
                   T* __restrict__ tv, T* __restrict__ jac, int M,
                   Geom<T> g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const T x = __ldg(px + i), y = __ldg(py + i), w = __ldg(yaw + i);
  const CellF<T> f = cell_floor<T>(g, x, y, w);
  Cell<T, Idx> c;
  cell_index<T, Idx>(g, f, c);
  uint4 raw[2][EXACT ? 4 : 2];  // [x corner]: hi halves, then residual ones
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
    const Idx row = packed_row<T, Idx>(g, cx ? c.ix1 : c.ix0, c.iy0, c.iw);
    raw[cx][0] = __ldg(table + 2 * row);
    raw[cx][1] = __ldg(table + 2 * row + 1);
    if constexpr (EXACT) {
      const Idx res = residual_row<T, Idx>(g, row);
      raw[cx][2] = __ldg(table + 2 * res);
      raw[cx][3] = __ldg(table + 2 * res + 1);
    }
  }
  cell_weights<T, Idx>(g, x, y, w, f, true, c);
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
  Chan<T> ch[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T a[2][2] = {{(T)v0[0][2 * k], (T)v0[0][2 * k + 1]},
                       {(T)v0[1][2 * k], (T)v0[1][2 * k + 1]}};
    const T b[2][2] = {{(T)v1[0][2 * k], (T)v1[0][2 * k + 1]},
                       {(T)v1[1][2 * k], (T)v1[1][2 * k + 1]}};
    ch[k] = blend_channel<T>(a, b, c.wx, c.wy, c.wt, c.low, c.inside, g);
  }
  const T dsig[3] = {ch[0].dx, ch[0].dy, ch[0].dw};
  const T dzb0[3] = {ch[1].dx, ch[1].dy, ch[1].dw};
  const T dzb1[3] = {ch[2].dx, ch[2].dy, ch[2].dw};
  T t[7], J[21];
  tv_tail<T>(ch[0].val, ch[1].val, ch[2].val, w, dsig, dzb0, dzb1, JAC, t, J);
  store<T>(tv, jac, i, M, JAC, t, J);
}

// Few samples: the quad's exchange and tail, shared by K1 and K2.  Lane q
// holds the blends of channel q (lane 3 those of channel 0 again): every
// lane gets the three channels' values, and lane k < 3 their derivatives
// along coordinate k; lane k < 3 then forms column k of J and lane 3 tv
// (without J, the quad shares tv's stores).
template <typename T, bool JAC>
__device__ __forceinline__ void quad_finish(const Chan<T>& mine, T w, int q,
                                            int lead, bool ok, int i, int M,
                                            T* __restrict__ tv,
                                            T* __restrict__ jac) {
  T val[3], dk[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    val[k] = __shfl_sync(0xffffffffu, mine.val, lead + k);
    const T dx = __shfl_sync(0xffffffffu, mine.dx, lead + k);
    const T dy = __shfl_sync(0xffffffffu, mine.dy, lead + k);
    const T dw = __shfl_sync(0xffffffffu, mine.dw, lead + k);
    dk[k] = q == 0 ? dx : (q == 1 ? dy : dw);
  }
  const Tail<T> tl = tail_common<T>(val[1], val[2], w);
  if (!ok) return;
  if (JAC && q < 3) {
    T Jk[7];
    tail_jac<T>(tl, q, dk[0], dk[1], dk[2], Jk);
#pragma unroll
    for (int r = 0; r < 7; ++r) jac[(long long)(3 * r + q) * M + i] = Jk[r];
  } else {
    T t[7];
    tail_tv<T>(tl, val[0], t);
    // with J, lane 3 stores all of tv; without, the quad shares it
#pragma unroll
    for (int r = 0; r < 7; ++r)
      if (JAC || (r & 3) == q) tv[(long long)r * M + i] = t[r];
  }
}

// Few samples: a quad of lanes per sample (see the top of the file).  Every
// lane of a warp takes part in the exchange: lanes past the end work on the
// last sample and store nothing.
template <typename T, bool EXACT, bool JAC, typename Idx>
__global__ void __launch_bounds__(256)
tv_packed16_quad(const T* __restrict__ px, const T* __restrict__ py,
                 const T* __restrict__ yaw, const uint4* __restrict__ table,
                 T* __restrict__ tv, T* __restrict__ jac, int M, Geom<T> g) {
  const long long gi = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int q = threadIdx.x & 3;
  const int lead = (threadIdx.x & 31) & ~3;  // the quad's lane 0
  const bool ok = gi < M;
  const int i = ok ? (int)gi : M - 1;
  const T x = __ldg(px + i), y = __ldg(py + i), w = __ldg(yaw + i);
  const CellF<T> f = cell_floor<T>(g, x, y, w);
  Cell<T, Idx> c;
  cell_index<T, Idx>(g, f, c);
  // lane q blends channel q (lane 3 channel 0 again, unused): words 2ch and
  // 2ch + 1, in half `half` of each row
  const int ch = q == 3 ? 0 : q;
  const int half = ch == 2 ? 1 : 0;
  uint4 hv[2], rv[2];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
    const Idx row = packed_row<T, Idx>(g, cx ? c.ix1 : c.ix0, c.iy0, c.iw);
    hv[cx] = __ldg(table + 2 * row + half);
    if constexpr (EXACT)
      rv[cx] = __ldg(table + 2 * residual_row<T, Idx>(g, row) + half);
  }
  cell_weights<T, Idx>(g, x, y, w, f, true, c);
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
  const T at[2][2] = {{(T)a[0][0], (T)a[0][1]}, {(T)a[1][0], (T)a[1][1]}};
  const T bt[2][2] = {{(T)b[0][0], (T)b[0][1]}, {(T)b[1][0], (T)b[1][1]}};
  const Chan<T> mine =
      blend_channel<T>(at, bt, c.wx, c.wy, c.wt, c.low, c.inside, g);
  quad_finish<T, JAC>(mine, w, q, lead, ok, i, M, tv, jac);
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// A pair-table row is (z, sig, zb0, zb1) at yaw w, then at w + 1: 32 bytes
// in float (two 16-byte words), 64 in double (four).
template <typename T>
struct PairWord;
template <>
struct PairWord<float> {
  using W = float4;
  static constexpr int per_row = 2;
};
template <>
struct PairWord<double> {
  using W = double2;
  static constexpr int per_row = 4;
};

__device__ __forceinline__ void unpack_word(const float4& u, float* v) {
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void unpack_word(const double2& u, double* v) {
  v[0] = u.x;
  v[1] = u.y;
}

// row of the pair table of the corner (ix, iy) at yaw index iw: cells are
// ordered with x fastest (terrain/grid.py:cell_row), as in K1's table
template <typename T, typename Idx>
__device__ __forceinline__ Idx pair_row(const Geom<T>& g, Idx ix, Idx iy,
                                        Idx iw) {
  return clamp_to<Idx>((iy * (Idx)g.nyaw + iw) * (Idx)g.nx + ix, 0,
                       (Idx)(g.ncells - 1));
}

// the four corners in the twin's order (x0,y0), (x0,y1), (x1,y0), (x1,y1)
template <typename T, typename Idx>
__device__ __forceinline__ Idx pair_corner(const Geom<T>& g,
                                           const Cell<T, Idx>& c, int k) {
  return pair_row<T, Idx>(g, k < 2 ? c.ix0 : c.ix1, (k & 1) ? c.iy1 : c.iy0,
                          c.iw);
}

// The blends of one channel (grid.py:817-843) from its values at the four
// corners at yaw w (a) and w + 1 (b).
template <typename T>
__device__ __forceinline__ Chan<T> pair_channel(const T (&a)[4],
                                                const T (&b)[4], T wx, T wy,
                                                T wt, bool inside,
                                                const Geom<T>& g) {
  const T wxy[4] = {(T(1) - wx) * (T(1) - wy), (T(1) - wx) * wy,
                    wx * (T(1) - wy), wx * wy};
  const T gx[4] = {-(T(1) - wy), -wy, T(1) - wy, wy};
  const T gy[4] = {-(T(1) - wx), T(1) - wx, -wx, wx};
  T vy[4], dv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    vy[k] = a[k] * (T(1) - wt) + b[k] * wt;
    dv[k] = b[k] - a[k];
  }
  Chan<T> r;
  r.val = vy[0] * wxy[0] + vy[1] * wxy[1] + vy[2] * wxy[2] + vy[3] * wxy[3];
  r.dx = (vy[0] * gx[0] + vy[1] * gx[1] + vy[2] * gx[2] + vy[3] * gx[3]) /
         g.res;
  r.dy = (vy[0] * gy[0] + vy[1] * gy[1] + vy[2] * gy[2] + vy[3] * gy[3]) /
         g.res;
  r.dw = (dv[0] * wxy[0] + dv[1] * wxy[1] + dv[2] * wxy[2] + dv[3] * wxy[3]) /
         g.yres;
  if (!inside) r.val = r.dx = r.dy = r.dw = T(0);
  return r;
}

// Many samples: a thread per sample, its pose and row loads issued before
// its math.
template <typename T, bool JAC, typename Idx>
__global__ void __launch_bounds__(256)
tv_pair_thread(const T* __restrict__ px, const T* __restrict__ py,
               const T* __restrict__ yaw,
               const typename PairWord<T>::W* __restrict__ table,
               T* __restrict__ tv, T* __restrict__ jac, int M, Geom<T> g) {
  constexpr int kWords = PairWord<T>::per_row;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const T x = __ldg(px + i), y = __ldg(py + i), w = __ldg(yaw + i);
  const CellF<T> f = cell_floor<T>(g, x, y, w);
  Cell<T, Idx> c;
  cell_index<T, Idx>(g, f, c);
  typename PairWord<T>::W raw[4][kWords];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Idx row = pair_corner<T, Idx>(g, c, k);
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      raw[k][j] = __ldg(table + kWords * row + j);
  }
  cell_weights<T, Idx>(g, x, y, w, f, false, c);
  T v[4][8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      unpack_word(raw[k][j], v[k] + 8 / kWords * j);
  Chan<T> ch[3];
#pragma unroll
  for (int cc = 0; cc < 3; ++cc) {
    T a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = v[k][1 + cc];
      b[k] = v[k][5 + cc];
    }
    ch[cc] = pair_channel<T>(a, b, c.wx, c.wy, c.wt, c.inside, g);
  }
  const T dsig[3] = {ch[0].dx, ch[0].dy, ch[0].dw};
  const T dzb0[3] = {ch[1].dx, ch[1].dy, ch[1].dw};
  const T dzb1[3] = {ch[2].dx, ch[2].dy, ch[2].dw};
  T t[7], J[21];
  tv_tail<T>(ch[0].val, ch[1].val, ch[2].val, w, dsig, dzb0, dzb1, JAC, t, J);
  store<T>(tv, jac, i, M, JAC, t, J);
}

// Few samples: a quad of lanes per sample, as K1's: lane ch < 3 loads
// channel ch of the four corners (two values of each row) and blends it.
template <typename T, bool JAC, typename Idx>
__global__ void __launch_bounds__(256)
tv_pair_quad(const T* __restrict__ px, const T* __restrict__ py,
             const T* __restrict__ yaw,
             const typename PairWord<T>::W* __restrict__ table,
             T* __restrict__ tv, T* __restrict__ jac, int M, Geom<T> g) {
  constexpr int kWords = PairWord<T>::per_row;
  const long long gi = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int q = threadIdx.x & 3;
  const int lead = (threadIdx.x & 31) & ~3;  // the quad's lane 0
  const bool ok = gi < M;
  const int i = ok ? (int)gi : M - 1;
  const T x = __ldg(px + i), y = __ldg(py + i), w = __ldg(yaw + i);
  const CellF<T> f = cell_floor<T>(g, x, y, w);
  Cell<T, Idx> c;
  cell_index<T, Idx>(g, f, c);
  const int ch = q == 3 ? 0 : q;
  T a[4], b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T* row = reinterpret_cast<const T*>(
        table + kWords * pair_corner<T, Idx>(g, c, k));
    a[k] = __ldg(row + 1 + ch);
    b[k] = __ldg(row + 5 + ch);
  }
  cell_weights<T, Idx>(g, x, y, w, f, false, c);
  const Chan<T> mine = pair_channel<T>(a, b, c.wx, c.wy, c.wt, c.inside, g);
  quad_finish<T, JAC>(mine, w, q, lead, ok, i, M, tv, jac);
}

template <typename T>
Geom<T> make_geom(int nx, int ny, int nyaw, T res, T yres, T ox, T oy, T oyaw,
                  T half_res, T half_yres, T lo_x, T hi_x, T lo_y, T hi_y) {
  Geom<T> g;
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

// K1's and K2's blocks: more, smaller blocks spread a launch below a few
// waves more evenly over the SMs (K1: 3-5% at the planning step's 43,520
// lookups, even at the headline's; chip_studies/k1_ablation.py)
constexpr int kK1Block = 128;
constexpr int kK2Block = 128;

template <typename T, bool EXACT, bool JAC, typename Idx>
int launch_packed16(const T* px, const T* py, const T* yaw,
                    const uint4* table, T* tv, T* jac, int M,
                    const Geom<T>& g, bool quad, cudaStream_t stream) {
  const long long threads = quad ? 4LL * M : (long long)M;
  const unsigned blocks = (unsigned)((threads + kK1Block - 1) / kK1Block);
  if (quad)
    tv_packed16_quad<T, EXACT, JAC, Idx><<<blocks, kK1Block, 0, stream>>>(
        px, py, yaw, table, tv, jac, M, g);
  else
    tv_packed16_thread<T, EXACT, JAC, Idx><<<blocks, kK1Block, 0, stream>>>(
        px, py, yaw, table, tv, jac, M, g);
  return (int)cudaGetLastError();
}

template <typename T, bool JAC, typename Idx>
int launch_pair(const T* px, const T* py, const T* yaw,
                const typename PairWord<T>::W* table, T* tv, T* jac, int M,
                const Geom<T>& g, bool quad, cudaStream_t stream) {
  const long long threads = quad ? 4LL * M : (long long)M;
  const unsigned blocks = (unsigned)((threads + kK2Block - 1) / kK2Block);
  if (quad)
    tv_pair_quad<T, JAC, Idx><<<blocks, kK2Block, 0, stream>>>(
        px, py, yaw, table, tv, jac, M, g);
  else
    tv_pair_thread<T, JAC, Idx><<<blocks, kK2Block, 0, stream>>>(
        px, py, yaw, table, tv, jac, M, g);
  return (int)cudaGetLastError();
}

template <typename T, bool EXACT, bool JAC>
int launch_packed16_idx(const T* px, const T* py, const T* yaw,
                        const uint4* table, T* tv, T* jac, int M,
                        const Geom<T>& g, bool idx32, bool quad,
                        cudaStream_t stream) {
  return idx32 ? launch_packed16<T, EXACT, JAC, int>(px, py, yaw, table, tv,
                                                      jac, M, g, quad, stream)
               : launch_packed16<T, EXACT, JAC, long long>(
                     px, py, yaw, table, tv, jac, M, g, quad, stream);
}

// K1 in every mode: `idx32` is the caller's promise that the table has
// fewer than 2^31 16-byte words (refused otherwise)
template <typename T>
int run_packed16(const T* px, const T* py, const T* yaw, const void* table,
                 T* tv, T* jac, int M, const Geom<T>& g, int exact,
                 int want_jac, int idx32, int quad, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  if (idx32 && 4 * g.ncells >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const uint4* t = (const uint4*)table;
  cudaStream_t s = (cudaStream_t)stream;
  if (exact)
    return want_jac ? launch_packed16_idx<T, true, true>(
                          px, py, yaw, t, tv, jac, M, g, idx32, quad, s)
                    : launch_packed16_idx<T, true, false>(
                          px, py, yaw, t, tv, jac, M, g, idx32, quad, s);
  return want_jac ? launch_packed16_idx<T, false, true>(
                        px, py, yaw, t, tv, jac, M, g, idx32, quad, s)
                  : launch_packed16_idx<T, false, false>(
                        px, py, yaw, t, tv, jac, M, g, idx32, quad, s);
}

// K2 in every mode, the same promise for its 32- or 64-byte rows
template <typename T>
int run_pair(const T* px, const T* py, const T* yaw, const void* table,
             T* tv, T* jac, int M, const Geom<T>& g, int want_jac, int idx32,
             int quad, void* stream) {
  using W = typename PairWord<T>::W;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  if (idx32 && PairWord<T>::per_row * g.ncells >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const W* t = (const W*)table;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx32)
    return want_jac ? launch_pair<T, true, int>(px, py, yaw, t, tv, jac, M,
                                                 g, quad, s)
                    : launch_pair<T, false, int>(px, py, yaw, t, tv, jac, M,
                                                  g, quad, s);
  return want_jac ? launch_pair<T, true, long long>(px, py, yaw, t, tv, jac,
                                                     M, g, quad, s)
                  : launch_pair<T, false, long long>(px, py, yaw, t, tv, jac,
                                                      M, g, quad, s);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers; the
// caller checks device, dtype, shape and contiguity.
//
// K1 and K2: `idx32` selects 32-bit index math (the caller's promise that
// the table has fewer than 2^31 16-byte words, refused otherwise), `quad` a
// quad of lanes per sample over a thread per sample.  The _f64 entries take
// float64 poses and write float64 outputs; their geometry is in double, as
// the JAX functions use the grid's Python floats.
int terrain_tv_packed16(const float* px, const float* py, const float* yaw,
                        const void* table, float* tv, float* jac, int M,
                        int nx, int ny, int nyaw, float res, float yres,
                        float ox, float oy, float oyaw, float half_res,
                        float half_yres, float lo_x, float hi_x, float lo_y,
                        float hi_y, int exact, int want_jac, int idx32,
                        int quad, void* stream) {
  return run_packed16<float>(
      px, py, yaw, table, tv, jac, M,
      make_geom<float>(nx, ny, nyaw, res, yres, ox, oy, oyaw, half_res,
                       half_yres, lo_x, hi_x, lo_y, hi_y),
      exact, want_jac, idx32, quad, stream);
}

int terrain_tv_packed16_f64(const double* px, const double* py,
                            const double* yaw, const void* table, double* tv,
                            double* jac, int M, int nx, int ny, int nyaw,
                            double res, double yres, double ox, double oy,
                            double oyaw, double half_res, double half_yres,
                            double lo_x, double hi_x, double lo_y,
                            double hi_y, int exact, int want_jac, int idx32,
                            int quad, void* stream) {
  return run_packed16<double>(
      px, py, yaw, table, tv, jac, M,
      make_geom<double>(nx, ny, nyaw, res, yres, ox, oy, oyaw, half_res,
                        half_yres, lo_x, hi_x, lo_y, hi_y),
      exact, want_jac, idx32, quad, stream);
}

int terrain_tv_pair(const float* px, const float* py, const float* yaw,
                    const void* table, float* tv, float* jac, int M, int nx,
                    int ny, int nyaw, float res, float yres, float ox,
                    float oy, float oyaw, float half_res, float half_yres,
                    float lo_x, float hi_x, float lo_y, float hi_y,
                    int want_jac, int idx32, int quad, void* stream) {
  return run_pair<float>(
      px, py, yaw, table, tv, jac, M,
      make_geom<float>(nx, ny, nyaw, res, yres, ox, oy, oyaw, half_res,
                       half_yres, lo_x, hi_x, lo_y, hi_y),
      want_jac, idx32, quad, stream);
}

int terrain_tv_pair_f64(const double* px, const double* py,
                        const double* yaw, const void* table, double* tv,
                        double* jac, int M, int nx, int ny, int nyaw,
                        double res, double yres, double ox, double oy,
                        double oyaw, double half_res, double half_yres,
                        double lo_x, double hi_x, double lo_y, double hi_y,
                        int want_jac, int idx32, int quad, void* stream) {
  return run_pair<double>(
      px, py, yaw, table, tv, jac, M,
      make_geom<double>(nx, ny, nyaw, res, yres, ox, oy, oyaw, half_res,
                        half_yres, lo_x, hi_x, lo_y, hi_y),
      want_jac, idx32, quad, stream);
}

const char* terrain_lookup_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
