// Fused k-slice extraction (the Ozaki splitting step, Alg. 3 / Alg. 8 and
// the sign-magnitude digits), all k int8 digits of an element from ONE read.
//
// Replaces the TPU kernel repro/kernels/split_fused.py::split_fused
// (body _split_kernel).  Same arithmetic, in the same order:
//   r = a * invgrid
//   bitmask : d = trunc(r)                     out[s] = d; r = (r - d) * 2^beta
//   rn_const: d = rint(r)   (round half even)  out[s] = d; r = (r - d) * 2^beta
//   sm      : d = floor(r) for the leading digit, then
//             d = min(floor(r), 2^beta - 1), stored mod 2^8
// Every step is exact (power-of-two scaling, exact subtraction), so the
// digits are bit-identical to the plain version.  rint/rintf round half to
// even; CUDA's round() rounds half away from zero and would differ.  The
// float -> int8 store saturates and maps NaN to 0, as XLA's conversion does
// (a row whose maximum is subnormal has an infinite reciprocal grid).
//
// The reciprocal grid is indexed through three strides, so one kernel
// covers row scales (axis 0: the A operand), column scales (axis 1: the B
// operand, no transpose in or out) and batches: for element e of a
// (batch, R, C) array, inv index = b*sb + row*sr + col*sc.
//
// Bound on the H100: bytes.  Each element reads 4 or 8 bytes and writes k
// digit bytes, with a handful of flops per digit, far below the card's
// 295 flops-per-byte balance point.  The design reads each input once
// (the TPU kernel's point: one pass instead of k) and grid-strides over the
// flat array so neighbouring threads touch neighbouring addresses.
// Compiled with --fmad=false: no multiply-add contraction anywhere.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float trunc_t(float x) { return truncf(x); }
__device__ __forceinline__ double trunc_t(double x) { return trunc(x); }
__device__ __forceinline__ float rint_t(float x) { return rintf(x); }
__device__ __forceinline__ double rint_t(double x) { return rint(x); }
__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return floor(x); }

template <typename T>
__device__ __forceinline__ int8_t sat_int8(T d) {
  if (d != d) return 0;
  if (d > T(127)) return 127;
  if (d < T(-128)) return -128;
  return static_cast<int8_t>(static_cast<int>(d));
}

template <typename T, int MODE>
__global__ void split_kernel(const T* __restrict__ a,
                             const T* __restrict__ inv,
                             int8_t* __restrict__ out, long long total,
                             long long R, long long C, long long sb,
                             long long sr, long long sc, int k, T two_beta,
                             T dmax) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const long long col = e % C;
    const long long row = (e / C) % R;
    const long long b = e / (R * C);
    T r = a[e] * inv[b * sb + row * sr + col * sc];
    if (MODE == 0) {  // bitmask: truncation
      for (int s = 0; s < k; ++s) {
        const T d = trunc_t(r);
        out[s * total + e] = sat_int8(d);
        r = (r - d) * two_beta;
      }
    } else if (MODE == 1) {  // rn_const: round half to even
      for (int s = 0; s < k; ++s) {
        const T d = rint_t(r);
        out[s * total + e] = sat_int8(d);
        r = (r - d) * two_beta;
      }
    } else {  // sm: signed leading digit, unsigned clamped trailing digits
      T d = floor_t(r);
      out[e] = sat_int8(d);
      r = (r - d) * two_beta;
      for (int s = 1; s < k; ++s) {
        d = floor_t(r);
        d = (d > dmax) ? dmax : d;  // min(d, dmax); NaN stays NaN
        out[s * total + e] = sat_int8(d > T(127) ? d - T(256) : d);
        r = (r - d) * two_beta;
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* inv, void* out, long long total,
           long long R, long long C, long long sb, long long sr,
           long long sc, int k, int beta, int mode, void* stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  const T two_beta = T(1 << beta);
  const T dmax = two_beta - T(1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  const T* pi = static_cast<const T*>(inv);
  int8_t* po = static_cast<int8_t*>(out);
  switch (mode) {
    case 0:
      split_kernel<T, 0><<<(int)blocks, threads, 0, st>>>(
          pa, pi, po, total, R, C, sb, sr, sc, k, two_beta, dmax);
      break;
    case 1:
      split_kernel<T, 1><<<(int)blocks, threads, 0, st>>>(
          pa, pi, po, total, R, C, sb, sr, sc, k, two_beta, dmax);
      break;
    case 2:
      split_kernel<T, 2><<<(int)blocks, threads, 0, st>>>(
          pa, pi, po, total, R, C, sb, sr, sc, k, two_beta, dmax);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int split_fused_f32(const void* a, const void* inv, void* out,
                               long long total, long long R, long long C,
                               long long sb, long long sr, long long sc,
                               int k, int beta, int mode, void* stream) {
  return launch<float>(a, inv, out, total, R, C, sb, sr, sc, k, beta, mode,
                       stream);
}

extern "C" int split_fused_f64(const void* a, const void* inv, void* out,
                               long long total, long long R, long long C,
                               long long sb, long long sr, long long sc,
                               int k, int beta, int mode, void* stream) {
  return launch<double>(a, inv, out, total, R, C, sb, sr, sc, k, beta, mode,
                        stream);
}
