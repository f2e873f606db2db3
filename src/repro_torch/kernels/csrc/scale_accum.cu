// Fused convert + scale + add epilogue of the Ozaki scheme (step iv).
//
// Replaces five TPU kernels of repro/kernels/scale_accum.py:
//   * scale_accum       (body _scale_accum_kernel): the df32 accumulator
//       (hi, lo) += srow * float(P32) * scol, compensated.  On the card
//       one launch runs the whole df32 epilogue of a group-EF contraction
//       (scale_accum_chunks): every chunk product, in the reference's
//       order, from a zero accumulator kept in registers, with the row
//       scale base_a * 2^(-beta g) of each chunk's group g formed in the
//       kernel, and the result written once, as ftz(hi + lo) (the f32
//       DF32.to_float) or as (hi, lo).  The single-chunk entry
//       (scale_accum_df32: the accumulator read in and updated in place)
//       is its C = 1 case;
//   * scale_accum_plain (body _scale_accum_plain_kernel): the plain
//       accumulator c += float(P32) * srow * scol in c's dtype (f32 or f64;
//       Hopper runs the f64 accumulator natively, unlike the TPU);
//   * scale_accum_const (body _scale_accum_const_kernel): the Ozaki-II
//       ladder window in df32, (hi, lo) += s * float(word) with ONE scalar
//       s per batch element (accumulate._oz2_accum_df32).  On the card one
//       launch runs the whole Ozaki-II df32 epilogue of a contraction
//       (scale_accum_const_windows, accumulate.oz2_df32_epilogue): the
//       ladder fold of the chunk products into one int32 word per window,
//       every window's scale and compensated step, and under fast2 the
//       unscale, from a zero accumulator in registers to the result written
//       once (it replaces a launch a window and an unscale launch a limb on
//       serving's main path).  The single-window entry
//       (scale_accum_const_df32: the word and the scale read in, the
//       accumulator updated in place) stays;
//   * scale_accum_const_plain (body _scale_accum_const_plain_kernel):
//       c += float(word) * s, word int32 or int64 (the f64 ladder word,
//       exact by its 52-bit budget), c f32 or f64 (_oz2_accum_plain);
//   * unscale (body _unscale_kernel): out = (x * srow) * scol, the exact
//       fast2 power-of-two unscale (accumulate._oz2_unscale) of the plain
//       f32/f64 accumulators; the df32 one is unscaled inside
//       scale_accum_const_windows.
// The scalar s stays on the device: the kernel reads it through the batch
// index, so no launch waits for the host.
// The operation order is the reference's exactly (scale_accum.py:68-82 and
// :87-89, i.e. accumulate._scale_accum_df32 / _scale_accum_plain):
//   p_hi = (p >> 8) << 8 (arithmetic shift: written p & ~0xFF), p_lo = p - p_hi
//   x_hi = (float(p_hi) * srow) * scol,  x_lo = (float(p_lo) * srow) * scol
//   (hi, err) = TwoSum(hi, x_hi);  lo = (lo + err) + x_lo;  (hi, lo) = TwoSum(hi, lo)
// Every add and multiply is an explicit round-to-nearest operation (the
// f32 sums as PTX add.rn.ftz / sub.rn.ftz, the rest as intrinsics such as
// __fmul_rn), which the compiler never contracts into a fused
// multiply-add, and the file is also compiled with --fmad=false: an FMA
// inside TwoSum would change its rounding and break bit parity.  Each also
// flushes subnormal operands and results to zero (ftz below), as the
// reference's XLA arithmetic does: scale products near the bottom of the
// exponent range then round as the reference's do.
//
// The per-window accumulators are updated IN PLACE.  The wrappers only pass
// buffers the caller owns (the accumulators allocated by the accumulate
// routines).
//
// Bound on the H100: bytes (an elementwise pass: per element, 4 bytes of
// P32, or 4/8 of the ladder word, plus a read and a write of the
// accumulator, against ~20 flops; unscale reads x and writes out).  The
// design is one fused pass instead of the separate passes of convert,
// scalings and add; threads grid-stride over the flat batch so
// neighbouring threads touch neighbouring addresses.  The whole-contraction
// df32 epilogue reads the C chunk products and writes the result once:
// 4 C + 4 bytes an element (20 at C = 4, against 20 C for C single-chunk
// launches plus the zeroing and the final conversion), with 16-byte loads
// and stores of 4 elements a thread where the shapes allow.  The Ozaki-II
// df32 epilogue does the same: 4 C + 4 bytes an element for C chunk
// products (20 at C = 4), against a fold, a 16-byte read-modify-write of
// (hi, lo) per window and two unscale passes as separate launches, plus
// the PyTorch operations that formed the scales and the factors; it forms
// the scales and unscale factors from the batch element's gbases and the
// bases in registers, so its wrapper runs no PyTorch operation.
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
// result, as the reference's XLA arithmetic does.  The f32 add and
// subtract are one PTX instruction each (.ftz does both flushes): the
// exact sum of two normal floats is a multiple of 2^-149, so a sum below
// the normal range is exact before the flush, and add.rn.ftz equals
// ftz(__fadd_rn(ftz(a), ftz(b))) for every input, signs of zero included.
__device__ __forceinline__ float add_rn(float a, float b) {
  float d;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return ftz(__dadd_rn(ftz(a), ftz(b)));
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  float d;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return ftz(__fmul_rn(ftz(a), ftz(b)));
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return ftz(__dmul_rn(ftz(a), ftz(b)));
}
// a product of operands already flushed (or integers): the result's flush
// only.  Products keep the explicit flush: a product can round up to the
// smallest normal from below it, where a hardware flush might differ.
__device__ __forceinline__ float mul_ftz(float a, float b) {
  return ftz(__fmul_rn(a, b));
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

// (hi, lo) += (xhi, xlo): TwoSum(hi, xhi), the low parts added, then the
// full TwoSum renormalisation
__device__ __forceinline__ void df32_add(float& hi, float& lo, float xhi,
                                         float xlo) {
  const float a = hi;
  const float s = add_rn(a, xhi);
  const float bb = sub_rn(s, a);
  const float err = add_rn(sub_rn(a, sub_rn(s, bb)), sub_rn(xhi, bb));
  const float l = add_rn(add_rn(lo, err), xlo);
  const float s2 = add_rn(s, l);
  const float bb2 = sub_rn(s2, s);
  hi = s2;
  lo = add_rn(sub_rn(s, sub_rn(s2, bb2)), sub_rn(l, bb2));
}

// 2^e in f32 as the conversion of the double 2^e rounds it (subnormal
// below the normal range, zero below that; e <= 127)
__device__ __forceinline__ float pow2f(int e) {
  if (e >= -126) return __uint_as_float((uint32_t)(e + 127) << 23);
  if (e >= -149) return __uint_as_float(1u << (e + 149));
  return 0.0f;
}

constexpr int MAX_CHUNKS = 16;   // chunk products a launch

// The chunk products of a contraction with their groups, by value.
struct Chunks {
  const int32_t* p[MAX_CHUNKS];
  int g[MAX_CHUNKS];
  int n;
  int beta;
};

// The whole df32 epilogue of a contraction: for every element, the chunks
// in order, each (hi, lo) += sr_g * float(P) * sc with the exact low-8-bit
// split, where sr_g = ftz(base_a * 2^(-beta g)) and sc = base_b (flushed
// on read).  READ: start from (hi_in, lo_in) instead of +0.  SUM: write
// ftz(hi + lo) to hi_out; else write hi_out and lo_out (in place allowed:
// each element is read and written by one thread).  VEC = 4: four elements
// of one row a thread, 16-byte loads and stores (p % 4 == 0, aligned).
template <int VEC, bool READ, bool SUM>
__global__ void __launch_bounds__(256)
    scale_accum_chunks_kernel(const Chunks ch,
                              const float* __restrict__ base_a,
                              const float* __restrict__ base_b,
                              const float* hi_in, const float* lo_in,
                              float* hi_out, float* lo_out, long long total,
                              long long m, long long pc) {
  const long long step = (long long)gridDim.x * blockDim.x * VEC;
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
       e < total; e += step) {
    const long long col = e % pc;
    const long long brow = e / pc;          // b * m + row
    const long long b = brow / m;
    const float ba = base_a[brow];
    float sc[VEC], hi[VEC], lo[VEC];
    if constexpr (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(base_b + b * pc +
                                                        col);
      sc[0] = v.x; sc[1] = v.y; sc[2] = v.z; sc[3] = v.w;
    } else {
      sc[0] = base_b[b * pc + col];
    }
    // every operand is flushed once here; each result below is flushed by
    // its own operation, so no operand is flushed again
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sc[j] = ftz(sc[j]);
      hi[j] = READ ? ftz(hi_in[e + j]) : 0.0f;
      lo[j] = READ ? ftz(lo_in[e + j]) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < MAX_CHUNKS; ++c) {
      if (c >= ch.n) break;
      const float sr = ftz(__fmul_rn(ba, pow2f(-ch.beta * ch.g[c])));
      int pv[VEC];
      if constexpr (VEC == 4) {
        const int4 v = *reinterpret_cast<const int4*>(ch.p[c] + e);
        pv[0] = v.x; pv[1] = v.y; pv[2] = v.z; pv[3] = v.w;
      } else {
        pv[0] = ch.p[c][e];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int phi = pv[j] & ~0xFF;      // == (pv >> 8) << 8
        const int plo = pv[j] - phi;        // in [0, 255]
        df32_add(hi[j], lo[j],
                 mul_ftz(mul_ftz(__int2float_rn(phi), sr), sc[j]),
                 mul_ftz(mul_ftz(__int2float_rn(plo), sr), sc[j]));
      }
    }
    if constexpr (SUM) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) hi[j] = add_rn(hi[j], lo[j]);
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(hi_out + e) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
      if constexpr (!SUM)
        *reinterpret_cast<float4*>(lo_out + e) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      hi_out[e] = hi[0];
      if constexpr (!SUM) lo_out[e] = lo[0];
    }
  }
}

constexpr int MAX_WORDS = 32;   // chunk products a ladder launch

// The chunk products of an Ozaki-II contraction, by value, in whole ladder
// windows: product c shifts left by shift[c] = beta (g_hi - g) onto its
// window's top group; top[c] is that top group g_hi where c is the last
// product of its window, else 0 (groups start at 2).
struct Windows {
  const int32_t* p[MAX_WORDS];
  int shift[MAX_WORDS];
  int top[MAX_WORDS];
  int n;
  int beta;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) {
  return __double2float_rn(x);
}
__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }
__device__ __forceinline__ float mul_ieee(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_ieee(double a, double b) {
  return __dmul_rn(a, b);
}

// The fast2 unscale factor base / gbase as the plain version forms it: a
// reciprocal, then a multiply, in the bases' dtype S without flushes (the
// consumer flushes), converted to f32, then flushed on use.
template <typename S>
__device__ __forceinline__ float ratio(S base, S inv_gbase) {
  return ftz(to_f32(mul_ieee(base, inv_gbase)));
}

// The whole df32 epilogue of an Ozaki-II contraction (or whole windows of
// it): for every element, the products in order, shift-added into one
// int32 word per ladder window (two's complement: shifted and added as
// uint32, exact within the ladder's 31-bit budget); at each window's last
// product, (hi, lo) += s * float(word) with the exact low-8-bit split,
// where s = ftz(ftz(gA * ftz(2^(-beta (g/2)))) * ftz(gB * ftz(2^(-beta
// (g - g/2))))) is formed here from the batch element's f32 gbases (the
// reference's _oz2_scale).  READ: start from (hi_in, lo_in) instead of +0.
// base_a non-null (the last launch under fast2): then (hi, lo) scale by
// ra = base_a / gbase_a per row and rb = base_b / gbase_b per column,
// (x * ra) * rb.  sum: write ftz(hi + lo) to hi_out; else hi_out and lo_out
// (in place allowed).  VEC = 4: four elements of one row a thread, 16-byte
// loads and stores.
template <int VEC, bool READ, typename S>
__global__ void __launch_bounds__(256)
    scale_accum_windows_kernel(const Windows w, const S* __restrict__ gbase_a,
                               const S* __restrict__ gbase_b,
                               const S* __restrict__ base_a,
                               const S* __restrict__ base_b,
                               const float* hi_in, const float* lo_in,
                               float* hi_out, float* lo_out, int sum,
                               long long total, long long m, long long pc) {
  const long long step = (long long)gridDim.x * blockDim.x * VEC;
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
       e < total; e += step) {
    const long long col = e % pc;
    const long long brow = e / pc;          // b * m + row
    const long long b = brow / m;
    const float ga = to_f32(gbase_a[b]), gb = to_f32(gbase_b[b]);
    float hi[VEC], lo[VEC];
    uint32_t word[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      hi[j] = READ ? ftz(hi_in[e + j]) : 0.0f;
      lo[j] = READ ? ftz(lo_in[e + j]) : 0.0f;
      word[j] = 0u;
    }
#pragma unroll
    for (int c = 0; c < MAX_WORDS; ++c) {
      if (c >= w.n) break;
      int pv[VEC];
      if constexpr (VEC == 4) {
        const int4 v = *reinterpret_cast<const int4*>(w.p[c] + e);
        pv[0] = v.x; pv[1] = v.y; pv[2] = v.z; pv[3] = v.w;
      } else {
        pv[0] = w.p[c][e];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        word[j] += static_cast<uint32_t>(pv[j]) << w.shift[c];
      const int g = w.top[c];
      if (g == 0) continue;
      const float s = mul_rn(mul_rn(ga, pow2f(-w.beta * (g / 2))),
                             mul_rn(gb, pow2f(-w.beta * (g - g / 2))));
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int wv = static_cast<int>(word[j]);
        const int phi = wv & ~0xFF;         // == (wv >> 8) << 8
        const int plo = wv - phi;           // in [0, 255]
        df32_add(hi[j], lo[j], mul_ftz(__int2float_rn(phi), s),
                 mul_ftz(__int2float_rn(plo), s));
        word[j] = 0u;
      }
    }
    if (base_a != nullptr) {
      const float ra = ratio(base_a[brow], rcp_rn(gbase_a[b]));
      const S inv_b = rcp_rn(gbase_b[b]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float rb = ratio(base_b[b * pc + col + j], inv_b);
        hi[j] = mul_ftz(mul_ftz(hi[j], ra), rb);
        lo[j] = mul_ftz(mul_ftz(lo[j], ra), rb);
      }
    }
    if (sum) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) hi[j] = add_rn(hi[j], lo[j]);
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(hi_out + e) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
      if (!sum)
        *reinterpret_cast<float4*>(lo_out + e) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      hi_out[e] = hi[0];
      if (!sum) lo_out[e] = lo[0];
    }
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

// The df32 ladder window: the same sequence as the df32 epilogue with one
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
    float h = hi[e], l = lo[e];
    df32_add(h, l, mul_rn(__int2float_rn(phi), sv),
             mul_rn(__int2float_rn(plo), sv));
    hi[e] = h;
    lo[e] = l;
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

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int VEC>
void launch_chunks(const Chunks& ch, const float* ba, const float* bb,
                   const float* hi_in, const float* lo_in, float* hi_out,
                   float* lo_out, bool sum, long long total, long long m,
                   long long p, cudaStream_t st) {
  const int blocks = (int)blocks_for((total + VEC - 1) / VEC);
  const bool read = hi_in != nullptr;
#define CHUNKS_LAUNCH(R, S)                                                  \
  scale_accum_chunks_kernel<VEC, R, S><<<blocks, 256, 0, st>>>(              \
      ch, ba, bb, hi_in, lo_in, hi_out, lo_out, total, m, p)
  if (read) {
    if (sum) CHUNKS_LAUNCH(true, true);
    else CHUNKS_LAUNCH(true, false);
  } else {
    if (sum) CHUNKS_LAUNCH(false, true);
    else CHUNKS_LAUNCH(false, false);
  }
#undef CHUNKS_LAUNCH
}

int run_chunks(const Chunks& ch, const void* base_a, const void* base_b,
               const void* hi_in, const void* lo_in, void* hi_out,
               void* lo_out, int sum, long long B, long long m, long long p,
               void* stream) {
  const long long total = B * m * p;
  if (total <= 0) return 0;
  if (ch.n < 1 || ch.n > MAX_CHUNKS || (hi_in == nullptr) != (lo_in == nullptr)
      || (!sum && lo_out == nullptr))
    return (int)cudaErrorInvalidValue;
  bool vec = p % 4 == 0 && aligned16(base_b) && aligned16(hi_in) &&
             aligned16(lo_in) && aligned16(hi_out) && aligned16(lo_out);
  for (int c = 0; c < ch.n; ++c) vec = vec && aligned16(ch.p[c]);
  const float* ba = static_cast<const float*>(base_a);
  const float* bb = static_cast<const float*>(base_b);
  const float* hin = static_cast<const float*>(hi_in);
  const float* lin = static_cast<const float*>(lo_in);
  float* hout = static_cast<float*>(hi_out);
  float* lout = static_cast<float*>(lo_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    launch_chunks<4>(ch, ba, bb, hin, lin, hout, lout, sum, total, m, p, st);
  else
    launch_chunks<1>(ch, ba, bb, hin, lin, hout, lout, sum, total, m, p, st);
  return (int)cudaGetLastError();
}

template <int VEC, typename S>
void launch_windows(const Windows& w, const void* gbase_a,
                    const void* gbase_b, const void* base_a,
                    const void* base_b, const float* hi_in,
                    const float* lo_in, float* hi_out, float* lo_out,
                    int sum, long long total, long long m, long long p,
                    cudaStream_t st) {
  const int blocks = (int)blocks_for((total + VEC - 1) / VEC);
  const S* ga = static_cast<const S*>(gbase_a);
  const S* gb = static_cast<const S*>(gbase_b);
  const S* ba = static_cast<const S*>(base_a);
  const S* bb = static_cast<const S*>(base_b);
  if (hi_in != nullptr)
    scale_accum_windows_kernel<VEC, true, S><<<blocks, 256, 0, st>>>(
        w, ga, gb, ba, bb, hi_in, lo_in, hi_out, lo_out, sum, total, m, p);
  else
    scale_accum_windows_kernel<VEC, false, S><<<blocks, 256, 0, st>>>(
        w, ga, gb, ba, bb, hi_in, lo_in, hi_out, lo_out, sum, total, m, p);
}

}  // namespace

// The whole df32 epilogue of a contraction (or n <= 16 of its chunks):
// prods[c] (B, m, p) int32 with group groups[c]; base_a (B, m), base_b
// (B, p) f32; hi_in, lo_in (B, m, p) f32 to start from, or both null for
// zero; sum = 1: hi_out = ftz(hi + lo), lo_out unused; sum = 0: hi_out,
// lo_out = (hi, lo) (may alias hi_in, lo_in).
extern "C" int scale_accum_chunks(const void* const* prods,
                                  const int* groups, int n, int beta,
                                  const void* base_a, const void* base_b,
                                  const void* hi_in, const void* lo_in,
                                  void* hi_out, void* lo_out, int sum,
                                  long long B, long long m, long long p,
                                  void* stream) {
  if (n < 1 || n > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  Chunks ch{};
  for (int c = 0; c < n; ++c) {
    ch.p[c] = static_cast<const int32_t*>(prods[c]);
    ch.g[c] = groups[c];
  }
  ch.n = n;
  ch.beta = beta;
  return run_chunks(ch, base_a, base_b, hi_in, lo_in, hi_out, lo_out, sum,
                    B, m, p, stream);
}

// One chunk into a given accumulator, in place: p32 (B, m, p) int32; srow
// (B, m); scol (B, p); hi, lo (B, m, p) f32.  The C = 1 case of
// scale_accum_chunks with group 0 (row scale srow * 2^0).
extern "C" int scale_accum_df32(const void* p32, const void* srow,
                                const void* scol, void* hi, void* lo,
                                long long B, long long m, long long p,
                                void* stream) {
  Chunks ch{};
  ch.p[0] = static_cast<const int32_t*>(p32);
  ch.g[0] = 0;
  ch.n = 1;
  ch.beta = 0;
  return run_chunks(ch, srow, scol, hi, lo, hi, lo, 0, B, m, p, stream);
}

// The df32 epilogue of an Ozaki-II contraction (or n <= 32 of its chunk
// products, in whole ladder windows): prods[c] (B, m, p) int32, shifted by
// shifts[c] into its window's word; tops[c] the window's top group at its
// last product, else 0; gbase_a, gbase_b (B,); base_a (B, m), base_b
// (B, p), or both null for no unscale; all four f32 (is_f64 = 0) or f64.
// hi_in, lo_in (B, m, p) f32 to start from, or both null for zero; sum = 1:
// hi_out = ftz(hi + lo), lo_out unused; sum = 0: hi_out, lo_out = (hi, lo)
// (may alias hi_in, lo_in).
extern "C" int scale_accum_const_windows(
    const void* const* prods, const int* shifts, const int* tops, int n,
    int beta, const void* gbase_a, const void* gbase_b, const void* base_a,
    const void* base_b, int is_f64, const void* hi_in, const void* lo_in,
    void* hi_out, void* lo_out, int sum, long long B, long long m,
    long long p, void* stream) {
  const long long total = B * m * p;
  if (total <= 0) return 0;
  if (n < 1 || n > MAX_WORDS || tops[n - 1] == 0 ||
      (hi_in == nullptr) != (lo_in == nullptr) ||
      (base_a == nullptr) != (base_b == nullptr) ||
      (!sum && lo_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Windows w{};
  bool vec = p % 4 == 0 && aligned16(hi_in) && aligned16(lo_in) &&
             aligned16(hi_out) && aligned16(lo_out);
  for (int c = 0; c < n; ++c) {
    if (shifts[c] < 0 || shifts[c] > 31) return (int)cudaErrorInvalidValue;
    w.p[c] = static_cast<const int32_t*>(prods[c]);
    w.shift[c] = shifts[c];
    w.top[c] = tops[c];
    vec = vec && aligned16(w.p[c]);
  }
  w.n = n;
  w.beta = beta;
  const float* hin = static_cast<const float*>(hi_in);
  const float* lin = static_cast<const float*>(lo_in);
  float* hout = static_cast<float*>(hi_out);
  float* lout = static_cast<float*>(lo_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WINDOWS_LAUNCH(V, S)                                                 \
  launch_windows<V, S>(w, gbase_a, gbase_b, base_a, base_b, hin, lin, hout,  \
                       lout, sum, total, m, p, st)
  if (vec) {
    if (is_f64) WINDOWS_LAUNCH(4, double);
    else WINDOWS_LAUNCH(4, float);
  } else {
    if (is_f64) WINDOWS_LAUNCH(1, double);
    else WINDOWS_LAUNCH(1, float);
  }
#undef WINDOWS_LAUNCH
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
