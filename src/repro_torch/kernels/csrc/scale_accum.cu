// Fused convert + scale + add epilogue of the Ozaki scheme (step iv).
//
// Replaces five TPU kernels of repro/kernels/scale_accum.py:
//   * scale_accum       (body _scale_accum_kernel): the df32 accumulator
//       (hi, lo) += srow * float(P32) * scol, compensated;
//   * scale_accum_plain (body _scale_accum_plain_kernel): the plain
//       accumulator c += float(P32) * srow * scol in c's dtype (f32 or f64;
//       Hopper runs the f64 accumulator natively, unlike the TPU);
//   * scale_accum_const (body _scale_accum_const_kernel): the Ozaki-II
//       ladder window in df32, (hi, lo) += s * float(word) with ONE scalar
//       s per batch element (accumulate._oz2_accum_df32);
//   * scale_accum_const_plain (body _scale_accum_const_plain_kernel):
//       c += float(word) * s, word int32 or int64 (the f64 ladder word,
//       exact by its 52-bit budget), c f32 or f64 (_oz2_accum_plain);
//   * unscale (body _unscale_kernel): out = (x * srow) * scol, the exact
//       fast2 power-of-two unscale (accumulate._oz2_unscale); the df32
//       caller launches it once per limb.
// The scalar s stays on the device: the kernel reads it through the batch
// index, so no launch waits for the host.
// The operation order is the reference's exactly (scale_accum.py:68-82 and
// :87-89, i.e. accumulate._scale_accum_df32 / _scale_accum_plain):
//   p_hi = (p >> 8) << 8 (arithmetic shift: written p & ~0xFF), p_lo = p - p_hi
//   x_hi = (float(p_hi) * srow) * scol,  x_lo = (float(p_lo) * srow) * scol
//   (hi, err) = TwoSum(hi, x_hi);  lo = (lo + err) + x_lo;  (hi, lo) = TwoSum(hi, lo)
// Every add and multiply is an explicit round-to-nearest intrinsic
// (__fadd_rn, __fmul_rn, ...), which the compiler never contracts into a
// fused multiply-add, and the file is also compiled with --fmad=false: an
// FMA inside TwoSum would change its rounding and break bit parity.  Each
// also flushes subnormal operands and results to zero (ftz below), as the
// reference's XLA arithmetic does: scale products near the bottom of the
// exponent range then round as the reference's do.
//
// The accumulators are updated IN PLACE.  The wrappers only pass buffers the
// caller owns (the accumulators allocated by the accumulate routines).
//
// Bound on the H100: bytes (an elementwise pass: per element, 4 bytes of
// P32, or 4/8 of the ladder word, plus a read and a write of the
// accumulator, against ~20 flops; unscale reads x and writes out).  The
// design is one fused pass instead of the separate passes of convert,
// scalings and add; threads grid-stride over the flat batch so
// neighbouring threads touch neighbouring addresses.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// a subnormal becomes a zero of its sign (NaN and infinities pass)
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ double ftz(double x) {
  return fabs(x) < DBL_MIN ? copysign(0.0, x) : x;
}

// every operation reads subnormal operands as zero and flushes a subnormal
// result, as the reference's XLA arithmetic does
__device__ __forceinline__ float add_rn(float a, float b) {
  return ftz(__fadd_rn(ftz(a), ftz(b)));
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return ftz(__dadd_rn(ftz(a), ftz(b)));
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return ftz(__fsub_rn(ftz(a), ftz(b)));
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return ftz(__fmul_rn(ftz(a), ftz(b)));
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return ftz(__dmul_rn(ftz(a), ftz(b)));
}
__device__ __forceinline__ float to_t(int v, float) {
  return __int2float_rn(v);
}
__device__ __forceinline__ double to_t(int v, double) {
  return __int2double_rn(v);
}
__device__ __forceinline__ float to_t(long long v, float) {
  return __ll2float_rn(v);
}
__device__ __forceinline__ double to_t(long long v, double) {
  return __ll2double_rn(v);
}

__global__ void scale_accum_kernel(const int32_t* __restrict__ p32,
                                   const float* __restrict__ srow,
                                   const float* __restrict__ scol,
                                   float* __restrict__ hi,
                                   float* __restrict__ lo, long long total,
                                   long long m, long long pc) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const long long col = e % pc;
    const long long brow = e / pc;          // b * m + row
    const long long b = brow / m;
    const float sr = srow[brow];
    const float sc = scol[b * pc + col];
    const int pv = p32[e];
    const int phi = pv & ~0xFF;             // == (pv >> 8) << 8
    const int plo = pv - phi;               // in [0, 255]
    const float xhi = mul_rn(mul_rn(__int2float_rn(phi), sr), sc);
    const float xlo = mul_rn(mul_rn(__int2float_rn(plo), sr), sc);
    // TwoSum(hi, xhi)
    const float a = hi[e];
    const float s = add_rn(a, xhi);
    const float bb = sub_rn(s, a);
    const float err = add_rn(sub_rn(a, sub_rn(s, bb)), sub_rn(xhi, bb));
    const float l = add_rn(add_rn(lo[e], err), xlo);
    // TwoSum(s, l): full renormalisation
    const float s2 = add_rn(s, l);
    const float bb2 = sub_rn(s2, s);
    const float e2 = add_rn(sub_rn(s, sub_rn(s2, bb2)), sub_rn(l, bb2));
    hi[e] = s2;
    lo[e] = e2;
  }
}

template <typename T>
__global__ void scale_accum_plain_kernel(const int32_t* __restrict__ p32,
                                         const T* __restrict__ srow,
                                         const T* __restrict__ scol,
                                         T* __restrict__ c, long long total,
                                         long long m, long long pc) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const long long col = e % pc;
    const long long brow = e / pc;
    const long long b = brow / m;
    const T x = mul_rn(mul_rn(to_t(p32[e], T()), srow[brow]),
                       scol[b * pc + col]);
    c[e] = add_rn(c[e], x);
  }
}

// The df32 ladder window: the same sequence as scale_accum_kernel with one
// multiply by the batch element's scalar instead of srow and scol.
__global__ void scale_accum_const_kernel(const int32_t* __restrict__ word,
                                         const float* __restrict__ scale,
                                         float* __restrict__ hi,
                                         float* __restrict__ lo,
                                         long long total, long long mp) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const float sv = scale[e / mp];
    const int pv = word[e];
    const int phi = pv & ~0xFF;             // == (pv >> 8) << 8
    const int plo = pv - phi;               // in [0, 255]
    const float xhi = mul_rn(__int2float_rn(phi), sv);
    const float xlo = mul_rn(__int2float_rn(plo), sv);
    const float a = hi[e];
    const float s = add_rn(a, xhi);
    const float bb = sub_rn(s, a);
    const float err = add_rn(sub_rn(a, sub_rn(s, bb)), sub_rn(xhi, bb));
    const float l = add_rn(add_rn(lo[e], err), xlo);
    const float s2 = add_rn(s, l);
    const float bb2 = sub_rn(s2, s);
    const float e2 = add_rn(sub_rn(s, sub_rn(s2, bb2)), sub_rn(l, bb2));
    hi[e] = s2;
    lo[e] = e2;
  }
}

template <typename W, typename T>
__global__ void scale_accum_const_plain_kernel(const W* __restrict__ word,
                                               const T* __restrict__ scale,
                                               T* __restrict__ c,
                                               long long total,
                                               long long mp) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    c[e] = add_rn(c[e], mul_rn(to_t(word[e], T()), scale[e / mp]));
  }
}

template <typename T>
__global__ void unscale_kernel(const T* __restrict__ x,
                               const T* __restrict__ srow,
                               const T* __restrict__ scol,
                               T* __restrict__ out, long long total,
                               long long m, long long pc) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const long long col = e % pc;
    const long long brow = e / pc;
    const long long b = brow / m;
    out[e] = mul_rn(mul_rn(x[e], srow[brow]), scol[b * pc + col]);
  }
}

long long blocks_for(long long total) {
  long long blocks = (total + 255) / 256;
  return blocks > 132LL * 32 ? 132LL * 32 : blocks;
}

}  // namespace

// p32 (B, m, p) int32; srow (B, m); scol (B, p); hi, lo (B, m, p) f32.
extern "C" int scale_accum_df32(const void* p32, const void* srow,
                                const void* scol, void* hi, void* lo,
                                long long B, long long m, long long p,
                                void* stream) {
  const long long total = B * m * p;
  if (total <= 0) return 0;
  scale_accum_kernel<<<(int)blocks_for(total), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p32), static_cast<const float*>(srow),
      static_cast<const float*>(scol), static_cast<float*>(hi),
      static_cast<float*>(lo), total, m, p);
  return (int)cudaGetLastError();
}

// c (B, m, p) and the scales in c's dtype: f32 (is_f64 = 0) or f64.
extern "C" int scale_accum_plain(const void* p32, const void* srow,
                                 const void* scol, void* c, long long B,
                                 long long m, long long p, int is_f64,
                                 void* stream) {
  const long long total = B * m * p;
  if (total <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* pp = static_cast<const int32_t*>(p32);
  if (is_f64) {
    scale_accum_plain_kernel<double><<<(int)blocks_for(total), 256, 0, st>>>(
        pp, static_cast<const double*>(srow), static_cast<const double*>(scol),
        static_cast<double*>(c), total, m, p);
  } else {
    scale_accum_plain_kernel<float><<<(int)blocks_for(total), 256, 0, st>>>(
        pp, static_cast<const float*>(srow), static_cast<const float*>(scol),
        static_cast<float*>(c), total, m, p);
  }
  return (int)cudaGetLastError();
}

// word (B, m, p) int32; scale (B,) f32; hi, lo (B, m, p) f32.
extern "C" int scale_accum_const_df32(const void* word, const void* scale,
                                      void* hi, void* lo, long long B,
                                      long long m, long long p,
                                      void* stream) {
  const long long total = B * m * p;
  if (total <= 0) return 0;
  scale_accum_const_kernel<<<(int)blocks_for(total), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(word), static_cast<const float*>(scale),
      static_cast<float*>(hi), static_cast<float*>(lo), total, m * p);
  return (int)cudaGetLastError();
}

template <typename W, typename T>
static void launch_const_plain(const void* word, const void* scale, void* c,
                               long long total, long long mp,
                               cudaStream_t st) {
  scale_accum_const_plain_kernel<W, T><<<(int)blocks_for(total), 256, 0,
                                         st>>>(
      static_cast<const W*>(word), static_cast<const T*>(scale),
      static_cast<T*>(c), total, mp);
}

// word (B, m, p) int32 (word_i64 = 0) or int64; scale (B,) and c (B, m, p)
// in c's dtype, f32 (is_f64 = 0) or f64.
extern "C" int scale_accum_const_plain(const void* word, const void* scale,
                                       void* c, long long B, long long m,
                                       long long p, int word_i64, int is_f64,
                                       void* stream) {
  const long long total = B * m * p;
  if (total <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word_i64) {
    if (is_f64) launch_const_plain<long long, double>(word, scale, c, total,
                                                      m * p, st);
    else launch_const_plain<long long, float>(word, scale, c, total, m * p,
                                              st);
  } else {
    if (is_f64) launch_const_plain<int32_t, double>(word, scale, c, total,
                                                    m * p, st);
    else launch_const_plain<int32_t, float>(word, scale, c, total, m * p,
                                            st);
  }
  return (int)cudaGetLastError();
}

// x, out (B, m, p); srow (B, m); scol (B, p); all f32 (is_f64 = 0) or f64.
extern "C" int unscale(const void* x, const void* srow, const void* scol,
                       void* out, long long B, long long m, long long p,
                       int is_f64, void* stream) {
  const long long total = B * m * p;
  if (total <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    unscale_kernel<double><<<(int)blocks_for(total), 256, 0, st>>>(
        static_cast<const double*>(x), static_cast<const double*>(srow),
        static_cast<const double*>(scol), static_cast<double*>(out), total,
        m, p);
  } else {
    unscale_kernel<float><<<(int)blocks_for(total), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(srow),
        static_cast<const float*>(scol), static_cast<float*>(out), total, m,
        p);
  }
  return (int)cudaGetLastError();
}
