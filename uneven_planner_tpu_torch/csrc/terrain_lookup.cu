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
// below the H100's f32 rate for those bytes.  Design: one thread per
// sample; tables are row-major with 32-byte rows (one DRAM sector, read as
// two 16-byte __ldg loads), so each corner costs one sector instead of the
// 6-8 scattered words of the JAX channel-major layout; outputs are
// channel-major, so every store of a warp is one contiguous 128-byte line.
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

struct Cell {
  float wx, wy, wt;
  bool low, inside;
  long long ix0, ix1, iy0, iy1, iw;
};

// grid.py:571-583 (packed16, low_y_rule) and grid.py:803-815 (pair)
__device__ __forceinline__ Cell cell_setup(const Geom& g, float px, float py,
                                           float yaw, bool low_y_rule) {
  Cell c;
  const float ixf = floorf((px - g.half_res - g.ox) / g.res);
  const float iyf = floorf((py - g.half_res - g.oy) / g.res);
  const float ywm = normalize_so2(yaw - g.half_yres);
  const float iwf = floorf((ywm - g.oyaw) / g.yres);
  c.wx = (px - ((ixf + 0.5f) * g.res + g.ox)) / g.res;
  const float wy = (py - ((iyf + 0.5f) * g.res + g.oy)) / g.res;
  c.low = low_y_rule && (iyf < 0.f);
  c.wy = c.low ? 0.f : wy;
  c.wt = so2_diff(yaw, (iwf + 0.5f) * g.yres + g.oyaw) / g.yres;
  // float -> int saturates and maps NaN to 0; the clamps keep every index
  // inside the table whatever the pose
  const long long ix = __float2int_rz(ixf);
  const long long iy = __float2int_rz(iyf);
  const long long iw = __float2int_rz(iwf);
  c.ix0 = clampll(ix, 0, g.nx - 1);
  c.ix1 = clampll(ix + 1, 0, g.nx - 1);
  c.iy0 = clampll(iy, 0, g.ny - 1);
  c.iy1 = clampll(iy + 1, 0, g.ny - 1);
  c.iw = ((iw % g.nyaw) + g.nyaw) % g.nyaw;
  c.inside = (px > g.lo_x) && (px < g.hi_x) && (py > g.lo_y) && (py < g.hi_y);
  return c;
}

// _tv_from_fields (grid.py:700-712) and its Jacobian.  dsig/dzb0/dzb1 are the
// field derivatives along (px, py, yaw); yaw also enters directly.
__device__ __forceinline__ void tv_tail(float sig, float zb0, float zb1,
                                        float yaw, const float* dsig,
                                        const float* dzb0, const float* dzb1,
                                        bool want_jac, float* tv, float* J) {
  const float q = 1.f - zb0 * zb0 - zb1 * zb1;
  const float c = sqrtf(floor_at(q, 1e-12f));
  const float inv_c = 1.f / c;
  const float cy = cosf(yaw), sy = sinf(yaw);
  const float t = cy * zb0 + sy * zb1;
  const float s = sy * zb0 - cy * zb1;
  const float p = 1.f - t * t;
  const float sq = sqrtf(floor_at(p, 1e-12f));
  const float inv_sq = 1.f / sq;
  tv[0] = inv_sq;
  tv[1] = -c * t * inv_sq;
  tv[2] = sq * inv_c;
  tv[3] = s * inv_sq;
  tv[4] = c;
  tv[5] = inv_c;
  tv[6] = sig;
  if (!want_jac) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dc = (q > 1e-12f) ? -(zb0 * dzb0[k] + zb1 * dzb1[k]) / c : 0.f;
    const float dt = cy * dzb0[k] + sy * dzb1[k] + (k == 2 ? -s : 0.f);
    const float ds = sy * dzb0[k] - cy * dzb1[k] + (k == 2 ? t : 0.f);
    const float dsq = (p > 1e-12f) ? -t * dt / sq : 0.f;
    const float dinv_sq = -inv_sq * inv_sq * dsq;
    const float dinv_c = -inv_c * inv_c * dc;
    J[0 * 3 + k] = dinv_sq;
    J[1 * 3 + k] = -(dc * t * inv_sq + c * dt * inv_sq + c * t * dinv_sq);
    J[2 * 3 + k] = dsq * inv_c + sq * dinv_c;
    J[3 * 3 + k] = ds * inv_sq + s * dinv_sq;
    J[4 * 3 + k] = dc;
    J[5 * 3 + k] = dinv_c;
    J[6 * 3 + k] = dsig[k];
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

// one 32-byte row of the packed table: words 0-5 used, 6-7 padding
__device__ __forceinline__ void load_packed_row(const uint4* __restrict__ t,
                                                long long row, float* v_w0,
                                                float* v_w1) {
  const uint4 a = __ldg(t + 2 * row);
  const uint4 b = __ldg(t + 2 * row + 1);
  const uint32_t w[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
#pragma unroll
  for (int k = 0; k < 6; ++k) unpack_pair(w[k], v_w0[k], v_w1[k]);
}

__global__ void __launch_bounds__(256)
tv_packed16_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ yaw,
                   const uint4* __restrict__ table, float* __restrict__ tv,
                   float* __restrict__ jac, int M, Geom g, int exact,
                   int want_jac) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const float x = px[i], y = py[i], w = yaw[i];
  const Cell c = cell_setup(g, x, y, w, true);
  const long long last = 2 * g.ncells - 1;
  const long long row[2] = {
      clampll((c.ix0 * g.ny + c.iy0) * g.nyaw + c.iw, 0, last),
      clampll((c.ix1 * g.ny + c.iy0) * g.nyaw + c.iw, 0, last)};

  // v0/v1[x corner][word]: values at yaw w / w+1; word = 2*ch + yy
  float v0[2][6], v1[2][6];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
    load_packed_row(table, row[cx], v0[cx], v1[cx]);
    if (exact) {  // hi + f16 residual row at +ncells
      float r0[6], r1[6];
      load_packed_row(table, clampll(row[cx] + g.ncells, 0, last), r0, r1);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        v0[cx][k] = v0[cx][k] + r0[k];
        v1[cx][k] = v1[cx][k] + r1[k];
      }
    }
  }

  const float wx = c.wx, wy = c.wy, wt = c.wt;
  float vw[2][6];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx)
#pragma unroll
    for (int k = 0; k < 6; ++k)
      vw[cx][k] = v0[cx][k] * (1.f - wt) + v1[cx][k] * wt;

  float val[3], dx[3], dy[3], dw[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float vy0 = vw[0][2 * ch] * (1.f - wy) + vw[0][2 * ch + 1] * wy;
    const float vy1 = vw[1][2 * ch] * (1.f - wy) + vw[1][2 * ch + 1] * wy;
    val[ch] = vy0 * (1.f - wx) + vy1 * wx;
    dx[ch] = (vy1 - vy0) / g.res;
    dy[ch] = c.low ? 0.f
                   : ((vw[0][2 * ch + 1] - vw[0][2 * ch]) * (1.f - wx) +
                      (vw[1][2 * ch + 1] - vw[1][2 * ch]) * wx) / g.res;
    const float e0 = (v1[0][2 * ch] - v0[0][2 * ch]) * (1.f - wy) +
                     (v1[0][2 * ch + 1] - v0[0][2 * ch + 1]) * wy;
    const float e1 = (v1[1][2 * ch] - v0[1][2 * ch]) * (1.f - wy) +
                     (v1[1][2 * ch + 1] - v0[1][2 * ch + 1]) * wy;
    dw[ch] = (e0 * (1.f - wx) + e1 * wx) / g.yres;
    if (!c.inside) val[ch] = dx[ch] = dy[ch] = dw[ch] = 0.f;
  }
  const float dsig[3] = {dx[0], dy[0], dw[0]};
  const float dzb0[3] = {dx[1], dy[1], dw[1]};
  const float dzb1[3] = {dx[2], dy[2], dw[2]};
  float t[7], J[21];
  tv_tail(val[0], val[1], val[2], w, dsig, dzb0, dzb1, want_jac, t, J);
  store(tv, jac, i, M, want_jac, t, J);
}

__global__ void __launch_bounds__(256)
tv_pair_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ yaw,
               const float4* __restrict__ table, float* __restrict__ tv,
               float* __restrict__ jac, int M, Geom g, int want_jac) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const float x = px[i], y = py[i], w = yaw[i];
  const Cell c = cell_setup(g, x, y, w, false);
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

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers; the
// caller checks device, dtype, shape and contiguity.
int terrain_tv_packed16(const float* px, const float* py, const float* yaw,
                        const void* table, float* tv, float* jac, int M,
                        int nx, int ny, int nyaw, float res, float yres,
                        float ox, float oy, float oyaw, float half_res,
                        float half_yres, float lo_x, float hi_x, float lo_y,
                        float hi_y, int exact, int want_jac, void* stream) {
  const Geom g = make_geom(nx, ny, nyaw, res, yres, ox, oy, oyaw, half_res,
                           half_yres, lo_x, hi_x, lo_y, hi_y);
  const int blocks = (M + kThreads - 1) / kThreads;
  tv_packed16_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      px, py, yaw, (const uint4*)table, tv, jac, M, g, exact, want_jac);
  return (int)cudaGetLastError();
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
