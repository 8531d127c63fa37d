// K7 ruiz_equilibrate: OSQP 5.1's modified Ruiz equilibration of a batch of
// QPs in one launch, hand-written for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package's equilibration
// (uneven_planner_tpu/solver/admm_qp.py:ruiz_equilibrate) is jnp code that
// XLA fuses.  It was added because the port ran the same code as ~345
// PyTorch launches a call, most of them passes over the whole batch of P and
// A (solver/admm_qp.py:ruiz_equilibrate_twin, its plain twin).  Per lane,
// from P [n, n], q [n], A [m, n], l, u [m], ten times:
//
//   dx_j  = 1 / sqrt(clip(max(max_i |P_ij|, max_i |A_ij|), lo, hi))
//   de_i  = 1 / sqrt(clip(max_j |A_ij|, lo, hi))
//   P_ij <- (P_ij dx_i) dx_j    q_j <- q_j dx_j    A_ij <- (A_ij de_i) dx_j
//   D <- D dx    E <- E de
//   g     = 1 / clip(max(mean_j max_i |P_ij|, max_j |q_j|), lo, hi)
//   P <- P g    q <- q g    c <- c g
//
// and lb = E l, ub = E u.  Every product is rounded where the twin rounds
// it, in its order, with no contraction (the library's -fmad=false), and the
// reciprocals and square roots are IEEE (no fast math), so each output
// equals the twin's bit for bit on the same CUDA tensors, except where a
// mean is summed: this kernel sums the column maxima in a fixed order (a
// lane's running sum over columns lane, lane + 32, ..., then a butterfly),
// PyTorch's reduction in its own, so g, and what follows it, agree to a few
// rounding steps a mean.  The maxima propagate NaN as torch.amax,
// torch.maximum and torch.clamp do (absolute values compared as their bit
// patterns: a NaN with its sign cleared is above +inf), so a lane with a NaN
// in P, A or q comes out NaN, and no lane touches another.
//
// What bounds it: bytes.  A few operations an element an iteration against
// P and A read once and Pb and Ab written once; the bound is those bytes
// (each input's storage once: the full tracking QP's P is one matrix
// broadcast to every lane) over the DRAM rate.  Design: one block per lane.
// Where the lane's P and A fit in a block's shared memory beside its
// vectors (`kernels/ruiz.py`: the condensed tracking QP in float32 and
// float64, the full one, n = 150, m = 208, in float32), they are copied in
// once with 16-byte cp.async, all ten iterations run there, Ab goes out
// from the last iteration's pass and Pb from a last pass that applies the
// last g; elsewhere (the full QP in float64) the same loop runs in place on
// the output buffers in device memory after one copy.  An iteration is one
// read-and-write pass over P and one over A, each element scaled by g
// (P only), its row's and its column's factor, with the absolute maxima of
// the results gathered in the same pass: a warp a row, its lanes on
// consecutive columns (conflict-free at any row stride), each lane
// holding its columns' maxima in registers (atomicMax into shared memory
// at the pass's end) and the warp reducing the row's; the loop over a
// lane's columns is compiled for each count, so only the last column can
// be missing.  The deferred g is exact: rounding is monotone, so the column
// maxima of (P g) are the rounded products of P's column maxima with g,
// and g is applied to each element at the next pass.  Every warp works g
// out itself from the same keys in the same order, so an iteration has two
// barriers: after the scales, after the passes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxShared = 232448;  // bytes a block can have on sm_90

// Absolute values as ordered keys: float to uint32, double to uint64, the
// sign cleared, so that +0 < ... < +inf < NaN as unsigned integers.
template <typename T> struct Key;

template <> struct Key<float> {
  using U = unsigned int;
  static __device__ __forceinline__ U of(float v) {
    return __float_as_uint(v) & 0x7fffffffu;
  }
  static __device__ __forceinline__ float value(U k) {
    return __uint_as_float(k);
  }
  static __device__ __forceinline__ U warp_max(U k) {
    return __reduce_max_sync(0xffffffffu, k);
  }
};

template <> struct Key<double> {
  using U = unsigned long long;
  static __device__ __forceinline__ U of(double v) {
    return (U)__double_as_longlong(v) & 0x7fffffffffffffffull;
  }
  static __device__ __forceinline__ double value(U k) {
    return __longlong_as_double((long long)k);
  }
  static __device__ __forceinline__ U warp_max(U k) {
    for (int o = 16; o > 0; o >>= 1) {
      const U x = __shfl_xor_sync(0xffffffffu, k, o);
      k = x > k ? x : k;
    }
    return k;
  }
};

template <typename U>
__device__ __forceinline__ U umax(U a, U b) {
  return a > b ? a : b;
}

// 1 / sqrt(clip(x, lo, hi)) and 1 / clip(x, lo, hi) as the twin rounds
// them; clip passes NaN through, as torch.clamp does.
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x != x ? x : fmin(fmax(x, lo), hi);
}

__device__ __forceinline__ float inv_sqrt(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ double inv_sqrt(double x) { return 1.0 / sqrt(x); }

__host__ __device__ inline long long round16(long long bytes) {
  return (bytes + 15) & ~15LL;
}

// Bytes of P and A in shared memory, each at a 16-byte boundary (counted
// the same way by `kernels/ruiz.py:shared_bytes`, which decides where a
// lane lives).
__host__ __device__ inline long long matrix_bytes(int n, int m, int elt) {
  return round16((long long)n * n * elt) + round16((long long)m * n * elt);
}

// Bytes of the vectors: the keys of the column maxima of P and of A and of
// the row maxima of A, two of each (this iteration's and the next's); three
// keys of max |q| (and one spare word); q, dx, D, de, E.
__host__ __device__ inline long long vector_bytes(int n, int m, int elt) {
  return (long long)elt * (7LL * n + 4LL * m + 4);
}

template <typename T>
struct RuizArgs {
  // inputs: a lane's P, q, A, l, u at lane * its stride (in elements; 0 for
  // one matrix or vector broadcast to every lane), row-major within
  const T *P, *q, *A, *l, *u;
  long long sP, sq, sA, sl, su;
  // outputs, contiguous: Pb [n, n], qb [n], Ab [m, n], lb, ub [m], D [n],
  // E [m], c
  T *Pb, *qb, *Ab, *lb, *ub, *D, *E, *c;
  int n, m, iters;
  T lo, hi;
};

// Copy `count` elements from device memory to 16-byte-aligned shared
// memory: 16-byte cp.async where the source is 16-byte aligned (the tail
// and an unaligned source element by element).  The caller waits with
// cp.async.wait_all and a barrier.
template <typename T>
__device__ __forceinline__ void stage(T* s, const T* g, long long count) {
  long long done = 0;
  if (((uintptr_t)g & 15) == 0) {
    const long long words = count * (long long)sizeof(T) / 16;
    const char* gs = reinterpret_cast<const char*>(g);
    char* ss = reinterpret_cast<char*>(s);
    for (long long w = threadIdx.x; w < words; w += blockDim.x) {
      const unsigned sa =
          (unsigned)__cvta_generic_to_shared(ss + 16 * w);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(gs + 16 * w)
                   : "memory");
    }
    done = words * 16 / (long long)sizeof(T);
  }
  for (long long e = done + threadIdx.x; e < count; e += blockDim.x)
    s[e] = __ldg(g + e);
}

// Row i of a chunk of columns c0 + lane + 32 s, s < NACT, of an r x n
// row-major matrix: the lane's columns of the row read first, then each
// element scaled (with kScale: ((v pre) rf) cf[s], the product with pre
// only with kPre, rounded at each product) and written to dst, its key
// folded into the lane's column maxima cm[s] and, with kRow, into the row's
// maximum, which the warp reduces into row[i] (a row is always the same
// warp's).  The last slot's column exists only where `tail` holds;
// elsewhere the lane reads and writes nothing and folds in 0.
template <typename T, int NACT, bool kScale, bool kPre, bool kRow>
__device__ __forceinline__ void row_step(
    const T* src, T* dst, int i, int n, int c0, int lane, bool tail, T pre,
    const T* rs, const T* cf, typename Key<T>::U* cm,
    typename Key<T>::U* row) {
  using K = Key<T>;
  using U = typename K::U;
  const long long at = (long long)i * n + c0 + lane;
  T v[NACT];
#pragma unroll
  for (int s = 0; s < NACT; ++s)
    v[s] = (s + 1 < NACT || tail) ? src[at + 32 * s] : T(0);
  const T rf = kScale ? rs[i] : T(1);
  U rm = 0;
#pragma unroll
  for (int s = 0; s < NACT; ++s) {
    T x = v[s];
    if (kScale) {
      if (kPre) x = x * pre;
      x = x * rf;
      x = x * cf[s];
      if (s + 1 < NACT || tail) dst[at + 32 * s] = x;
    }
    const U k = K::of(x);
    cm[s] = umax(cm[s], k);
    if (kRow) rm = umax(rm, k);
  }
  if (kRow) {
    rm = K::warp_max(rm);
    if (lane == 0) row[i] = c0 == 0 ? rm : umax(row[i], rm);
  }
}

// One chunk of NACT x 32 columns from c0, every row: a warp a row (rows
// warp, warp + warps, ...), then the lane's column maxima into col by
// atomicMax (col starts at 0).
template <typename T, int NACT, bool kScale, bool kPre, bool kRow>
__device__ __forceinline__ void walk_chunk(const T* src, T* dst, int rows,
                                           int n, int c0, T pre, const T* rs,
                                           const T* cs,
                                           typename Key<T>::U* col,
                                           typename Key<T>::U* row) {
  using U = typename Key<T>::U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool tail = c0 + 32 * (NACT - 1) + lane < n;
  U cm[NACT];
  T cf[NACT];
#pragma unroll
  for (int s = 0; s < NACT; ++s) {
    cm[s] = 0;
    cf[s] = (kScale && (s + 1 < NACT || tail)) ? cs[c0 + 32 * s + lane]
                                                : T(1);
  }
  for (int i = warp; i < rows; i += warps)
    row_step<T, NACT, kScale, kPre, kRow>(src, dst, i, n, c0, lane, tail, pre,
                                          rs, cf, cm, row);
#pragma unroll
  for (int s = 0; s < NACT; ++s)
    if (s + 1 < NACT || tail) atomicMax(col + c0 + 32 * s + lane, cm[s]);
}

// walk_chunk compiled for each count of slots from N down to 1, the count
// chosen at run time.
template <typename T, int N, bool kScale, bool kPre, bool kRow>
struct Chunk {
  static __device__ __forceinline__ void run(
      int nact, const T* src, T* dst, int rows, int n, int c0, T pre,
      const T* rs, const T* cs, typename Key<T>::U* col,
      typename Key<T>::U* row) {
    if (nact == N)
      walk_chunk<T, N, kScale, kPre, kRow>(src, dst, rows, n, c0, pre, rs, cs,
                                           col, row);
    else
      Chunk<T, N - 1, kScale, kPre, kRow>::run(nact, src, dst, rows, n, c0,
                                               pre, rs, cs, col, row);
  }
};

template <typename T, bool kScale, bool kPre, bool kRow>
struct Chunk<T, 0, kScale, kPre, kRow> {
  static __device__ __forceinline__ void run(int, const T*, T*, int, int, int,
                                             T, const T*, const T*,
                                             typename Key<T>::U*,
                                             typename Key<T>::U*) {}
};

// One pass of the block over the rows of an r x n row-major matrix at
// `src` (shared or device memory), in chunks of 32 kSlots columns, each
// lane on columns lane + 32 s of the chunk.  With kScale each element
// becomes ((v pre) rs[i]) cs[j] (the product with pre only with kPre),
// rounded at each product, as the twin's broadcast products round it, and
// is written to dst (src itself, or the output); without it the pass only
// reads.  The key of the largest |element| (after scaling) of each column
// goes into col[j], of each row into row[i] with kRow.
template <typename T, int kSlots, bool kScale, bool kPre, bool kRow>
__device__ __forceinline__ void walk(const T* src, T* dst, int rows, int n,
                                     T pre, const T* rs, const T* cs,
                                     typename Key<T>::U* col,
                                     typename Key<T>::U* row) {
  for (int c0 = 0; c0 < n; c0 += 32 * kSlots) {
    const int nact = min(kSlots, (n - c0 + 31) >> 5);
    Chunk<T, kSlots, kScale, kPre, kRow>::run(nact, src, dst, rows, n, c0,
                                              pre, rs, cs, col, row);
  }
}

// One block per lane.  kResident: P and A in shared memory; otherwise in
// place on Pb and Ab.  kSlots: columns a lane holds in a chunk, 32 kSlots
// columns a chunk: 2 for n <= 64, with 256 threads and registers for four
// blocks an SM (the condensed QP's shared memory allows four); 8 otherwise,
// with 512 threads and registers for one (the full QP's allows one).
template <typename T, bool kResident, int kSlots>
__global__ void __launch_bounds__(kSlots == 2 ? 256 : 512,
                                  kSlots == 2 ? 4 : 1)
    ruiz_kernel(RuizArgs<T> a) {
  using K = Key<T>;
  using U = typename K::U;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const int lane = tid & 31;
  const long long b = blockIdx.x;
  const long long nn = (long long)n * n, mn = (long long)m * n;
  T* outP = a.Pb + b * nn;
  T* outA = a.Ab + b * mn;
  const T* inP = a.P + b * a.sP;
  const T* inA = a.A + b * a.sA;
  T* Pm;
  T* Am;
  unsigned char* vec;
  if (kResident) {
    Pm = reinterpret_cast<T*>(smem);
    Am = reinterpret_cast<T*>(smem + round16(nn * (long long)sizeof(T)));
    vec = smem + matrix_bytes(n, m, (int)sizeof(T));
  } else {
    Pm = outP;
    Am = outA;
    vec = smem;
  }
  U* colP = reinterpret_cast<U*>(vec);  // [2][n]
  U* colA = colP + 2 * n;               // [2][n]
  U* rowA = colA + 2 * n;               // [2][m]
  U* qkey = rowA + 2 * m;               // [3] (and one spare)
  T* qv = reinterpret_cast<T*>(qkey + 4);
  T* dx = qv + n;
  T* D = dx + n;
  T* de = D + n;
  T* E = de + m;

  if (kResident) {
    stage(Pm, inP, nn);
    stage(Am, inA, mn);
  } else {
    for (long long e = tid; e < nn; e += blockDim.x) Pm[e] = __ldg(inP + e);
    for (long long e = tid; e < mn; e += blockDim.x) Am[e] = __ldg(inA + e);
  }
  for (int t = tid; t < n + m; t += blockDim.x) {
    if (t < n) {
      qv[t] = a.q[b * a.sq + t];
      D[t] = T(1);
      colP[t] = colP[n + t] = colA[t] = colA[n + t] = 0;
    } else {
      E[t - n] = T(1);
      rowA[t - n] = rowA[m + t - n] = 0;
    }
  }
  if (tid < 3) qkey[tid] = 0;
  if (kResident) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // the input's maxima: columns of P, columns and rows of A
  walk<T, kSlots, false, false, false>(Pm, nullptr, n, n, T(1), nullptr,
                                       nullptr, colP, nullptr);
  walk<T, kSlots, false, false, true>(Am, nullptr, m, n, T(1), nullptr,
                                      nullptr, colA, rowA);
  __syncthreads();

  // g, the last cost scale, not yet applied to P and q: every warp works it
  // out from the same keys in the same order, so all hold the same bits and
  // no barrier follows it; c is thread 0's
  T g = T(1), c = T(1);
  for (int k = 0; k < a.iters; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    const U* cP = colP + cur * n;
    const U* cA = colA + cur * n;
    const U* rA = rowA + cur * m;
    U* nP = colP + nxt * n;
    U* nA = colA + nxt * n;
    U* nR = rowA + nxt * m;
    // the scales; the column maxima of P g are those of P times g, since
    // rounding is monotone
    U qk = 0;
    for (int t = tid; t < n + m; t += blockDim.x) {
      if (t < n) {
        const T cp = K::value(cP[t]) * g;
        const T v = inv_sqrt(
            clip(K::value(umax(K::of(cp), cA[t])), a.lo, a.hi));
        const T qt = (qv[t] * g) * v;
        dx[t] = v;
        D[t] = D[t] * v;
        qv[t] = qt;
        qk = umax(qk, K::of(qt));
        nP[t] = 0;
        nA[t] = 0;
      } else {
        const int i = t - n;
        const T v = inv_sqrt(clip(K::value(rA[i]), a.lo, a.hi));
        de[i] = v;
        E[i] = E[i] * v;
        nR[i] = 0;
      }
    }
    qk = K::warp_max(qk);
    if (lane == 0 && qk != 0) atomicMax(qkey + k % 3, qk);
    __syncthreads();
    if (tid == 0) qkey[(k + 1) % 3] = 0;
    walk<T, kSlots, true, true, false>(Pm, Pm, n, n, g, dx, dx, nP, nullptr);
    if (kResident && k + 1 == a.iters)
      walk<T, kSlots, true, false, true>(Am, outA, m, n, T(1), de, dx, nA,
                                         nR);
    else
      walk<T, kSlots, true, false, true>(Am, Am, m, n, T(1), de, dx, nA, nR);
    __syncthreads();
    // g = 1 / clip(max(mean of P's column maxima, max |q|))
    T s = T(0);
    for (int j = lane; j < n; j += 32) s = s + K::value(nP[j]);
    for (int o = 16; o > 0; o >>= 1)
      s = s + __shfl_xor_sync(0xffffffffu, s, o);
    const T mean = s * (T(1) / T(n));
    g = T(1) / clip(K::value(umax(K::of(mean), qkey[k % 3])), a.lo, a.hi);
    c = c * g;
  }

  for (long long e = tid; e < nn; e += blockDim.x) outP[e] = Pm[e] * g;
  if (kResident && a.iters == 0)
    for (long long e = tid; e < mn; e += blockDim.x) outA[e] = Am[e];
  for (int t = tid; t < n + m; t += blockDim.x) {
    if (t < n) {
      a.qb[b * n + t] = qv[t] * g;
      a.D[b * n + t] = D[t];
    } else {
      const int i = t - n;
      const T e = E[i];
      a.E[b * m + i] = e;
      a.lb[b * m + i] = e * a.l[b * a.sl + i];
      a.ub[b * m + i] = e * a.u[b * a.su + i];
    }
  }
  if (tid == 0) a.c[b] = c;
}

template <typename T, bool kResident, int kSlots>
int launch(const RuizArgs<T>& a, int batch, long long bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ruiz_kernel<T, kResident, kSlots>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ruiz_kernel<T, kResident, kSlots>
      <<<(unsigned)batch, kSlots == 2 ? 256 : 512, (size_t)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for(const void* const* in, const long long* strides,
               void* const* out, int batch, int n, int m, int iters,
               bool resident, long long bytes, double lo, double hi,
               cudaStream_t stream) {
  RuizArgs<T> a;
  a.P = (const T*)in[0];
  a.q = (const T*)in[1];
  a.A = (const T*)in[2];
  a.l = (const T*)in[3];
  a.u = (const T*)in[4];
  a.sP = strides[0];
  a.sq = strides[1];
  a.sA = strides[2];
  a.sl = strides[3];
  a.su = strides[4];
  a.Pb = (T*)out[0];
  a.qb = (T*)out[1];
  a.Ab = (T*)out[2];
  a.lb = (T*)out[3];
  a.ub = (T*)out[4];
  a.D = (T*)out[5];
  a.E = (T*)out[6];
  a.c = (T*)out[7];
  a.n = n;
  a.m = m;
  a.iters = iters;
  a.lo = (T)lo;
  a.hi = (T)hi;
  const bool small = n <= 64;
  if (resident)
    return small ? launch<T, true, 2>(a, batch, bytes, stream)
                 : launch<T, true, 8>(a, batch, bytes, stream);
  return small ? launch<T, false, 2>(a, batch, bytes, stream)
               : launch<T, false, 8>(a, batch, bytes, stream);
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream`, one block per lane, and returns the first
// CUDA error (0 = launched).  P, q, A, l, u: device pointers to float (dbl
// == 0) or double, a lane at lane * its stride in elements, row-major
// within; Pb, qb, Ab, lb, ub, D, E, c: contiguous outputs of the same type.
// lo and hi are the scales' clip, rounded to the element type.  resident:
// P and A in shared memory (1) or in place on Pb and Ab (0), as the caller
// decides (`kernels/ruiz.py:instantiation`).  The caller checks device,
// dtype, shape and layout.  A lane that does not fit in a block's shared
// memory so placed is refused with cudaErrorInvalidValue.
int ruiz_equilibrate(const void* P, const void* q, const void* A,
                     const void* l, const void* u, long long sP,
                     long long sq, long long sA, long long sl, long long su,
                     void* Pb, void* qb, void* Ab, void* lb, void* ub,
                     void* D, void* E, void* c, int batch, int n, int m,
                     int iters, int dbl, int resident, double lo, double hi,
                     void* stream) {
  const int elt = dbl ? (int)sizeof(double) : (int)sizeof(float);
  const long long bytes = (resident ? matrix_bytes(n, m, elt) : 0) +
                          vector_bytes(n, m, elt);
  if (batch <= 0 || n <= 0 || m <= 0 || iters < 0 || bytes > kMaxShared)
    return (int)cudaErrorInvalidValue;
  const void* const in[5] = {P, q, A, l, u};
  const long long strides[5] = {sP, sq, sA, sl, su};
  void* const out[8] = {Pb, qb, Ab, lb, ub, D, E, c};
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? launch_for<double>(in, strides, out, batch, n, m, iters,
                                  resident != 0, bytes, lo, hi, s)
             : launch_for<float>(in, strides, out, batch, n, m, iters,
                                 resident != 0, bytes, lo, hi, s);
}

const char* ruiz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
