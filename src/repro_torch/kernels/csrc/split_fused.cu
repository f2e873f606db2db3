// Fused k-slice extraction (the Ozaki splitting step, Alg. 3 / Alg. 8 and
// the sign-magnitude digits): the whole split of an operand in ONE launch.
//
// Replaces the TPU kernel repro/kernels/split_fused.py::split_fused
// (body _split_kernel) together with the row-maximum and grid preparation
// the reference's wrapper does around it (repro/kernels/ops.py
// split_fused).  One launch reads a, takes the maximum |a| of each row
// (axis 0) or column (axis 1), derives the row's power-of-two base and
// reciprocal grid, writes the base and the k scales base * 2^(-beta s),
// and emits all k int8 digits of every element.
//
// Grids, from the row maximum M (its bit pattern: exact, and NaN-safe):
//   pow2_floor(M) = 2^floor(log2 M): 1 for 0 and subnormals, 0.5 for inf/NaN
//   pow2_ceil(M)  = 2^ceil(log2 M):  1 for 0, subnormals, inf and NaN
//   bitmask : base = 2 pow2_floor(M),   inv = (1 / base) * 2^beta
//   rn_const: mu = ftz(pow2_ceil(M) 2^(1-beta)), base = mu 2^beta, inv = 1/mu
//   sm      : anchor = 2 pow2_floor(M), base = 2 anchor,
//             inv = (1 / anchor) * 2^(beta-1)
// each an IEEE operation in the order of the plain version (PyTorch's
// scalar / tensor is reciprocal-then-multiply), so base, inv and the
// scales are bit-identical to it, overflow to inf included.  A caller may
// instead pass the reciprocal grid (the Ozaki-II constant-grid modes, whose
// maximum spans a whole batch element): the kernel then skips the maximum.
//
// Digits, the reference's arithmetic in its order:
//   r = a * inv
//   bitmask : d = trunc(r)                     out[s] = d; r = (r - d) * 2^beta
//   rn_const: d = rint(r)   (round half even)  out[s] = d; r = (r - d) * 2^beta
//   sm      : d = floor(r) for the leading digit, then
//             d = min(floor(r), 2^beta - 1), stored mod 2^8
// Every step is exact (power-of-two scaling, exact subtraction), so the
// digits are bit-identical to the plain version.  rint/rintf round half to
// even; CUDA's round() rounds half away from zero and would differ.  The
// float -> int8 store saturates and maps NaN to 0, as XLA's conversion does
// (a row whose grid underflowed has an infinite reciprocal grid).
//
// Subnormals: the reference's XLA arithmetic flushes them (denormals are
// zero, results flush to zero), so every operand of a digit product or
// difference here is flushed, and so is every result (ftz below, explicit:
// nvcc's -ftz would not touch f64).  The maximum does not flush (XLA's max
// and abs do not); mu and the scales flush their results, as the plain
// version does.
//
// Layout and design.  Bound on the H100: bytes (each element reads 4 or 8
// bytes and writes k digit bytes, against a handful of flops a digit), and
// at decode shapes (a few rows of 2048-8192) the launch itself.
//   * Rows (axis 0, the A operand): one block per row, of up to 1024
//     threads at decode (a few rows) and 256 where rows are many.  Pass 1
//     takes the row maximum with 16-byte loads and a shuffle reduction;
//     pass 2 re-reads the row (from L1: a 32 KB f64 row fits) and writes
//     each digit plane with packed 4-byte stores, in the input's layout.
//   * Columns (axis 1, the B operand): one block per (batch element, strip
//     of 32 columns), 32 x 32 threads, reading the input through its
//     strides (the attention's B operands are permuted views of the KV
//     cache; no copy is made).  Pass 1 takes the column maxima over
//     all R rows (eight rows in flight a thread); pass 2 reads the strip
//     again (from L1/L2), 128 rows at a time, the next tile's loads in
//     flight while a tile's digits are made, through a transposing tile in
//     shared memory, and writes the stack K-major, (k, batch, C, R): each
//     column's R contraction digits contiguous, as the group GEMM reads
//     them, with packed 4-byte stores.
// Compiled with --fmad=false: no multiply-add contraction anywhere.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float trunc_t(float x) { return truncf(x); }
__device__ __forceinline__ double trunc_t(double x) { return trunc(x); }
__device__ __forceinline__ float rint_t(float x) { return rintf(x); }
__device__ __forceinline__ double rint_t(double x) { return rint(x); }
__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return floor(x); }
__device__ __forceinline__ float mul_t(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_t(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float recip_t(float a) {
  return __fdiv_rn(1.0f, a);
}
__device__ __forceinline__ double recip_t(double a) {
  return __ddiv_rn(1.0, a);
}

// a subnormal becomes a zero of its sign (NaN and infinities pass)
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ double ftz(double x) {
  return fabs(x) < DBL_MIN ? copysign(0.0, x) : x;
}

// bit-pattern helpers: U holds |x|'s bits; a larger U is a larger |x|, and
// NaN patterns lie above infinity, so an integer maximum of them is the
// maximum |x| with NaN propagating (as PyTorch's amax)
template <typename T> struct Bits;
template <> struct Bits<float> {
  using U = uint32_t;
  static constexpr int MB = 23, BIAS = 127;
  static __device__ __forceinline__ U abs(float x) {
    return __float_as_uint(x) & 0x7FFFFFFFu;
  }
  static __device__ __forceinline__ float from(U u) {
    return __uint_as_float(u);
  }
};
template <> struct Bits<double> {
  using U = unsigned long long;
  static constexpr int MB = 52, BIAS = 1023;
  static __device__ __forceinline__ U abs(double x) {
    return (U)__double_as_longlong(x) & 0x7FFFFFFFFFFFFFFFull;
  }
  static __device__ __forceinline__ double from(U u) {
    return __longlong_as_double((long long)u);
  }
};

// 2^e in T as the conversion of the double 2^e rounds it: subnormal below
// the normal range, zero below that (e <= the largest exponent)
template <typename T>
__device__ __forceinline__ T pow2(int e) {
  using B = Bits<T>;
  using U = typename B::U;
  constexpr int emin = 1 - B::BIAS;
  if (e >= emin) return B::from((U)(e + B::BIAS) << B::MB);
  if (e >= emin - B::MB) return B::from((U)1 << (e - emin + B::MB));
  return T(0);
}

template <typename T>
__device__ __forceinline__ T pow2_floor(typename Bits<T>::U m) {
  using B = Bits<T>;
  const auto expo = m >> B::MB;
  if (expo == (typename B::U)(2 * B::BIAS + 1)) return T(0.5);
  if (expo == 0) return T(1);
  return B::from(expo << B::MB);
}

template <typename T>
__device__ __forceinline__ T pow2_ceil(typename Bits<T>::U m) {
  using B = Bits<T>;
  using U = typename B::U;
  const U expo = m >> B::MB;
  const U frac = (m & (((U)1 << B::MB) - 1)) != 0;
  if (expo == 0 || expo == (U)(2 * B::BIAS + 1)) return T(1);
  return B::from((expo + frac) << B::MB);
}

// base and reciprocal first grid of a row with maximum bits m
template <typename T, int MODE>
__device__ __forceinline__ void grid_of(typename Bits<T>::U m, int beta,
                                        T& base, T& inv) {
  if (MODE == 0) {         // bitmask
    base = mul_t(T(2), pow2_floor<T>(m));
    inv = mul_t(recip_t(base), pow2<T>(beta));
  } else if (MODE == 1) {  // rn_const
    const T mu = ftz(mul_t(pow2_ceil<T>(m), pow2<T>(1 - beta)));
    base = mul_t(mu, pow2<T>(beta));
    inv = recip_t(mu);
  } else {                 // sm
    const T anchor = mul_t(T(2), pow2_floor<T>(m));
    base = mul_t(T(2), anchor);
    inv = mul_t(recip_t(anchor), pow2<T>(beta - 1));
  }
}

template <typename T>
__device__ __forceinline__ int8_t sat_int8(T d) {
  if (d != d) return 0;
  if (d > T(127)) return 127;
  if (d < T(-128)) return -128;
  return static_cast<int8_t>(static_cast<int>(d));
}

// digit s of the residual r (flushed), advancing r to the next digit
template <typename T, int MODE>
__device__ __forceinline__ int8_t step(T& r, int s, T two_beta, T dmax) {
  T d;
  int8_t out;
  if (MODE == 0) {          // bitmask: truncation
    d = trunc_t(r);
    out = sat_int8(d);
  } else if (MODE == 1) {   // rn_const: round half to even
    d = rint_t(r);
    out = sat_int8(d);
  } else if (s == 0) {      // sm: signed leading digit
    d = floor_t(r);
    out = sat_int8(d);
  } else {                  // sm: unsigned clamped trailing digits
    d = floor_t(r);
    d = (d > dmax) ? dmax : d;  // min(d, dmax); NaN stays NaN
    out = sat_int8(d > T(127) ? d - T(256) : d);
  }
  r = ftz(ftz(r - d) * two_beta);
  return out;
}

// the base and the k scales ftz(base * 2^(-beta (s+1))) of one row
template <typename T>
__device__ __forceinline__ void write_scales(T base, int k, int beta,
                                             T* base_out, T* scale_out,
                                             long long idx,
                                             long long plane) {
  base_out[idx] = base;
  for (int s = 0; s < k; ++s)
    scale_out[s * plane + idx] = ftz(mul_t(base, pow2<T>(-beta * (s + 1))));
}

template <int VEC, typename T>
__device__ __forceinline__ void load(const T* p, T (&x)[VEC]) {
  if constexpr (VEC == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (VEC == 4) {
    const double2 v0 = reinterpret_cast<const double2*>(p)[0];
    const double2 v1 = reinterpret_cast<const double2*>(p)[1];
    x[0] = v0.x; x[1] = v0.y; x[2] = v1.x; x[3] = v1.y;
  } else {
    x[0] = p[0];
  }
}

// maximum of v over the block (at most 32 warps)
template <typename U>
__device__ __forceinline__ U block_max(U v) {
  __shared__ unsigned long long part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o; o >>= 1) {
    const U w = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = v > w ? v : w;
  }
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? (U)part[lane] : U(0);
    for (int o = 16; o; o >>= 1) {
      const U w = __shfl_xor_sync(0xFFFFFFFFu, v, o);
      v = v > w ? v : w;
    }
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return (U)part[0];
}

// axis 0: one block per row of the flat (rows, C) input; VEC elements a
// thread per step (VEC = 4: 16-byte loads, packed 4-byte digit stores).
// OWN: derive the grid from the row maximum and write base and scales;
// otherwise read the reciprocal grid inv_in[row].
template <typename T, int MODE, int VEC, bool OWN>
__global__ void __launch_bounds__(1024)
    split_rows(const T* __restrict__ a, const T* __restrict__ inv_in,
               int8_t* __restrict__ out, T* __restrict__ base_out,
               T* __restrict__ scale_out, T* __restrict__ gbase_out,
               long long rows, long long R, long long C, int k, int beta) {
  using U = typename Bits<T>::U;
  const long long row = blockIdx.x;
  const T* arow = a + row * C;
  const long long total = rows * C;  // one digit plane
  const long long stride = (long long)VEC * blockDim.x;
  T inv;
  if (OWN) {
    U m = 0;
#pragma unroll 4
    for (long long c = (long long)VEC * threadIdx.x; c < C; c += stride) {
      T x[VEC];
      load<VEC>(arow + c, x);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const U u = Bits<T>::abs(x[j]);
        m = u > m ? u : m;
      }
    }
    m = block_max(m);
    T base;
    grid_of<T, MODE>(m, beta, base, inv);
    if (threadIdx.x == 0) {
      write_scales(base, k, beta, base_out, scale_out, row, rows);
      if (gbase_out != nullptr && row % R == 0) gbase_out[row / R] = T(2);
    }
  } else {
    inv = inv_in[row];
  }
  inv = ftz(inv);
  const T two_beta = pow2<T>(beta);
  const T dmax = two_beta - T(1);
  for (long long c = (long long)VEC * threadIdx.x; c < C; c += stride) {
    T x[VEC];
    load<VEC>(arow + c, x);
    T r[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) r[j] = ftz(ftz(x[j]) * inv);
    int8_t* dst = out + row * C + c;
    for (int s = 0; s < k; ++s) {
      if constexpr (VEC == 4) {
        uint32_t packed = 0;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          packed |= (uint32_t)(uint8_t)step<T, MODE>(r[j], s, two_beta,
                                                     dmax) << (8 * j);
        *reinterpret_cast<uint32_t*>(dst + s * total) = packed;
      } else {
        dst[s * total] = step<T, MODE>(r[0], s, two_beta, dmax);
      }
    }
  }
}

constexpr int STRIP = 32;              // columns a block
constexpr int TR = 128;                // rows a tile (4 a thread)
constexpr int PITCH = TR + 4;          // tile row pitch in bytes

// Element strides of the (B, R, C) input of the column split: batch
// element b at (b / nb1) s0 + (b % nb1) s1 (two batch dims, e.g. the KV
// cache's batch and head), element (r, c) at r sr + c sc.
struct Strides {
  long long nb1, s0, s1, sr, sc;
};

// axis 1: one block per (batch element, 32-column strip), 32 x 32 threads;
// K-major output (k, B, C, R).  Dynamic shared memory: the digit tile
// [k][STRIP][PITCH], which pass 1 first uses for its [32][33] maxima.
// The input is read through its strides.  KM (the rows are the unit-stride
// dim, as in a KV cache read as (D, L)): each warp reads 32 consecutive
// rows of one column; otherwise 32 consecutive columns of one row.  Either
// way thread (cl, rl) handles column c0 + cl and rows rl, rl + 32, ...
template <typename T, int MODE, bool OWN, bool KM>
__global__ void __launch_bounds__(1024)
    split_cols(const T* __restrict__ a, const T* __restrict__ inv_in,
               int8_t* __restrict__ out, T* __restrict__ base_out,
               T* __restrict__ scale_out, T* __restrict__ gbase_out,
               long long B, int R, int C, Strides st, int k, int beta) {
  using U = typename Bits<T>::U;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ T inv_s[STRIP];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int cl = KM ? ty : tx, rl = KM ? tx : ty;
  const int c0 = blockIdx.x * STRIP;
  const long long b = blockIdx.y;
  const int col = c0 + cl;
  const T* ac = a + (b / st.nb1) * st.s0 + (b % st.nb1) * st.s1 +
                (long long)col * st.sc;   // this thread's column
  const long long sr = st.sr;
  if (OWN) {
    U m = 0;
    if (col < C) {
      int r = rl;
      for (; r + 7 * 32 < R; r += 8 * 32) {     // eight rows in flight
        U u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          u[i] = Bits<T>::abs(ac[(long long)(r + 32 * i) * sr]);
#pragma unroll
        for (int i = 0; i < 8; ++i) m = u[i] > m ? u[i] : m;
      }
      for (; r < R; r += 32) {
        const U u = Bits<T>::abs(ac[(long long)r * sr]);
        m = u > m ? u : m;
      }
    }
    U* red = reinterpret_cast<U*>(smem);  // [32][33]
    red[rl * 33 + cl] = m;
    __syncthreads();
    if (rl == 0) {
      for (int i = 1; i < 32; ++i) {
        const U u = red[i * 33 + cl];
        m = u > m ? u : m;
      }
      T base, inv = T(0);
      if (col < C) {
        grid_of<T, MODE>(m, beta, base, inv);
        write_scales(base, k, beta, base_out, scale_out, b * C + col,
                     B * C);
      }
      inv_s[cl] = ftz(inv);
      if (gbase_out != nullptr && blockIdx.x == 0 && cl == 0)
        gbase_out[b] = T(2);
    }
  } else if (rl == 0) {
    inv_s[cl] = col < C ? ftz(inv_in[b * C + col]) : T(0);
  }
  __syncthreads();
  const T iv = inv_s[cl];
  const T two_beta = pow2<T>(beta);
  const T dmax = two_beta - T(1);
  const long long total = B * R * C;   // one digit plane
  const bool packed_rows = (R % 4) == 0;
  // the next tile's loads are issued before this tile's digits
  T next[TR / 32];
#pragma unroll
  for (int i = 0; i < TR / 32; ++i) {
    const int row = rl + 32 * i;
    next[i] = (row < R && col < C) ? ac[(long long)row * sr] : T(0);
  }
  for (int r0 = 0; r0 < R; r0 += TR) {
    T x[TR / 32];
#pragma unroll
    for (int i = 0; i < TR / 32; ++i) {
      x[i] = next[i];
      const int row = r0 + TR + rl + 32 * i;
      next[i] = (row < R && col < C) ? ac[(long long)row * sr] : T(0);
    }
#pragma unroll
    for (int i = 0; i < TR / 32; ++i) {
      const int rr = rl + 32 * i;
      if (r0 + rr < R && col < C) {
        T r = ftz(ftz(x[i]) * iv);
        for (int s = 0; s < k; ++s)
          smem[(s * STRIP + cl) * PITCH + rr] =
              (uint8_t)step<T, MODE>(r, s, two_beta, dmax);
      }
    }
    __syncthreads();
    // column c0 + ty, rows r0 + 4 tx .. + 3
    const int cw = c0 + ty, rr = 4 * tx, row = r0 + rr;
    if (cw < C && row < R) {
      int8_t* dst = out + (b * C + cw) * R + row;
      const uint8_t* src = smem + ty * PITCH + rr;
      if (packed_rows) {
        for (int s = 0; s < k; ++s)
          *reinterpret_cast<uint32_t*>(dst + s * total) =
              *reinterpret_cast<const uint32_t*>(src + s * STRIP * PITCH);
      } else {
        const int n = R - row < 4 ? R - row : 4;
        for (int s = 0; s < k; ++s)
          for (int j = 0; j < n; ++j)
            dst[s * total + j] = (int8_t)src[s * STRIP * PITCH + j];
      }
    }
    __syncthreads();
  }
}

template <typename T, int MODE, bool OWN>
int run(const T* a, const T* inv, int8_t* out, T* base, T* scale, T* gbase,
        long long B, long long R, long long C, Strides sd, int k, int beta,
        int axis, cudaStream_t st) {
  if (axis == 0) {
    const long long rows = B * R;
    if (rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const bool vec = C % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % (4 * sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
    // a few rows (decode): up to 1024 threads a row, so a row of 8192
    // takes two steps; enough rows to fill the card four times over (the
    // DGEMM's 4096): 256, so more blocks share each SM
    const long long per = vec ? (C + 3) / 4 : C;
    const long long cap = rows >= 4 * 132 ? 256 : 1024;
    const int threads = (int)(per >= cap ? cap : ((per + 31) / 32) * 32);
    if (vec)
      split_rows<T, MODE, 4, OWN><<<(unsigned)rows, threads, 0, st>>>(
          a, inv, out, base, scale, gbase, rows, R, C, k, beta);
    else
      split_rows<T, MODE, 1, OWN><<<(unsigned)rows, threads, 0, st>>>(
          a, inv, out, base, scale, gbase, rows, R, C, k, beta);
  } else {
    const long long tile = (long long)k * STRIP * PITCH;
    const long long red = 32LL * 33 * sizeof(typename Bits<T>::U);
    const long long smem = tile > red ? tile : red;
    if (B > 65535 || R > 0x7FFFFFFFLL || C > 0x7FFFFFFFLL ||
        smem > 200 * 1024)
      return (int)cudaErrorInvalidValue;
    // rows of unit stride (and columns not): warps read down the columns
    auto kern = sd.sr == 1 && sd.sc != 1 ? split_cols<T, MODE, OWN, true>
                                         : split_cols<T, MODE, OWN, false>;
    if (smem > 40 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((unsigned)((C + STRIP - 1) / STRIP), (unsigned)B);
    kern<<<grid, dim3(STRIP, 32), (size_t)smem, st>>>(
        a, inv, out, base, scale, gbase, B, (int)R, (int)C, sd, k, beta);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* inv, void* out, void* base,
           void* scale, void* gbase, long long B, long long R, long long C,
           const long long* strides, int k, int beta, int mode, int axis,
           void* stream) {
  if (B * R * C <= 0 || k <= 0) return 0;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  const Strides sd{strides[0], strides[1], strides[2], strides[3],
                   strides[4]};
  if (sd.nb1 <= 0 || B % sd.nb1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  const T* pi = static_cast<const T*>(inv);
  int8_t* po = static_cast<int8_t*>(out);
  T* pb = static_cast<T*>(base);
  T* ps = static_cast<T*>(scale);
  T* pg = static_cast<T*>(gbase);
#define SPLIT_RUN(M)                                                         \
  return inv == nullptr                                                      \
             ? run<T, M, true>(pa, pi, po, pb, ps, pg, B, R, C, sd, k,       \
                               beta, axis, st)                               \
             : run<T, M, false>(pa, pi, po, pb, ps, pg, B, R, C, sd, k,      \
                                beta, axis, st)
  switch (mode) {
    case 0: SPLIT_RUN(0);
    case 1: SPLIT_RUN(1);
    case 2: SPLIT_RUN(2);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPLIT_RUN
}

}  // namespace

// The whole split.  a: (B, R, C), contiguous for axis 0; for axis 1 read
// through strides = {nb1, s0, s1, sr, sc} (elements; see Strides).  out:
// (k, B, R, C) for axis 0, (k, B, C, R) for axis 1 (K-major); base: (B, R)
// for axis 0, (B, C) for axis 1; scale: (k, *base); gbase: (B,) set to 2
// (the fast2 modes), or null.  mode: 0 bitmask, 1 rn_const, 2 sm.
extern "C" int split_whole_f32(const void* a, void* out, void* base,
                               void* scale, void* gbase, long long B,
                               long long R, long long C,
                               const long long* strides, int k, int beta,
                               int mode, int axis, void* stream) {
  return launch<float>(a, nullptr, out, base, scale, gbase, B, R, C,
                       strides, k, beta, mode, axis, stream);
}

extern "C" int split_whole_f64(const void* a, void* out, void* base,
                               void* scale, void* gbase, long long B,
                               long long R, long long C,
                               const long long* strides, int k, int beta,
                               int mode, int axis, void* stream) {
  return launch<double>(a, nullptr, out, base, scale, gbase, B, R, C,
                        strides, k, beta, mode, axis, stream);
}

// The digits on a given reciprocal grid.  inv: (B, R) for axis 0, (B, C)
// for axis 1; a and out as above.
extern "C" int split_fused_f32(const void* a, const void* inv, void* out,
                               long long B, long long R, long long C,
                               const long long* strides, int k, int beta,
                               int mode, int axis, void* stream) {
  if (inv == nullptr) return (int)cudaErrorInvalidValue;
  return launch<float>(a, inv, out, nullptr, nullptr, nullptr, B, R, C,
                       strides, k, beta, mode, axis, stream);
}

extern "C" int split_fused_f64(const void* a, const void* inv, void* out,
                               long long B, long long R, long long C,
                               const long long* strides, int k, int beta,
                               int mode, int axis, void* stream) {
  if (inv == nullptr) return (int)cudaErrorInvalidValue;
  return launch<double>(a, inv, out, nullptr, nullptr, nullptr, B, R, C,
                        strides, k, beta, mode, axis, stream);
}
