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
// (a row whose grid underflowed has an infinite reciprocal grid).
//
// Subnormals: the reference's XLA arithmetic flushes them (denormals are
// zero, results flush to zero), so every operand of a product or difference
// here is flushed, and so is every result (ftz below, explicit: nvcc's
// -ftz would not touch f64).
//
// Row scales (axis 0, the A operand) read the grid per row and write the
// digit stack in the input's layout.  Column scales (axis 1, the B operand)
// write the stack K-major, (k, batch, C, R): each column's R contraction
// digits contiguous, as the group GEMM reads them.  That kernel works on
// 32 x 32 tiles, reading rows of the input and writing rows of the output
// through a transposing tile in shared memory, so both sides stay
// coalesced.
//
// Bound on the H100: bytes.  Each element reads 4 or 8 bytes and writes k
// digit bytes, with a handful of flops per digit, far below the card's
// 295 flops-per-byte balance point.  The design reads each input once
// (the TPU kernel's point: one pass instead of k) and grid-strides over the
// flat array so neighbouring threads touch neighbouring addresses.
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

// a subnormal becomes a zero of its sign (NaN and infinities pass)
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ double ftz(double x) {
  return fabs(x) < DBL_MIN ? copysign(0.0, x) : x;
}

template <typename T>
__device__ __forceinline__ int8_t sat_int8(T d) {
  if (d != d) return 0;
  if (d > T(127)) return 127;
  if (d < T(-128)) return -128;
  return static_cast<int8_t>(static_cast<int>(d));
}

// the k digits of r = a * invgrid (already flushed) into dst[s * stride]
template <typename T, int MODE>
__device__ __forceinline__ void digits(T r, int k, T two_beta, T dmax,
                                       int8_t* dst, long long stride) {
  if (MODE == 0) {  // bitmask: truncation
    for (int s = 0; s < k; ++s) {
      const T d = trunc_t(r);
      dst[s * stride] = sat_int8(d);
      r = ftz(ftz(r - d) * two_beta);
    }
  } else if (MODE == 1) {  // rn_const: round half to even
    for (int s = 0; s < k; ++s) {
      const T d = rint_t(r);
      dst[s * stride] = sat_int8(d);
      r = ftz(ftz(r - d) * two_beta);
    }
  } else {  // sm: signed leading digit, unsigned clamped trailing digits
    T d = floor_t(r);
    dst[0] = sat_int8(d);
    r = ftz(ftz(r - d) * two_beta);
    for (int s = 1; s < k; ++s) {
      d = floor_t(r);
      d = (d > dmax) ? dmax : d;  // min(d, dmax); NaN stays NaN
      dst[s * stride] = sat_int8(d > T(127) ? d - T(256) : d);
      r = ftz(ftz(r - d) * two_beta);
    }
  }
}

// axis 0: grid per row; element e of the flat (batch * R, C) input
template <typename T, int MODE>
__global__ void split_rows(const T* __restrict__ a, const T* __restrict__ inv,
                           int8_t* __restrict__ out, long long total,
                           long long C, int k, T two_beta, T dmax) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const T r = ftz(ftz(a[e]) * ftz(inv[e / C]));
    digits<T, MODE>(r, k, two_beta, dmax, out + e, total);
  }
}

constexpr int TILE = 32, TROWS = 8, TPAD = TILE + 1;

// axis 1: grid per column, K-major output (k, batch, C, R); one 32 x 32
// tile of one batch element per block, 32 x 8 threads
template <typename T, int MODE>
__global__ void split_cols(const T* __restrict__ a, const T* __restrict__ inv,
                           int8_t* __restrict__ out, long long total, int R,
                           int C, int k, T two_beta, T dmax) {
  extern __shared__ int8_t tile[];  // [k][TILE cols][TPAD]
  const int c0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
  const long long b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = c0 + tx;
  const T iv = col < C ? ftz(inv[b * C + col]) : T(0);
  for (int rr = ty; rr < TILE; rr += TROWS) {
    const int row = r0 + rr;
    if (row < R && col < C) {
      const T r = ftz(ftz(a[(b * R + row) * C + col]) * iv);
      digits<T, MODE>(r, k, two_beta, dmax, tile + tx * TPAD + rr,
                      TILE * TPAD);
    }
  }
  __syncthreads();
  for (int cc = ty; cc < TILE; cc += TROWS) {
    const int cw = c0 + cc, row = r0 + tx;
    if (cw < C && row < R) {
      int8_t* dst = out + (b * C + cw) * R + row;
      for (int s = 0; s < k; ++s)
        dst[s * total] = tile[s * TILE * TPAD + cc * TPAD + tx];
    }
  }
}

template <typename T, int MODE>
int run(const T* a, const T* inv, int8_t* out, long long total, long long B,
        long long R, long long C, int k, T two_beta, T dmax, int axis,
        cudaStream_t st) {
  if (axis == 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;
    split_rows<T, MODE><<<(int)blocks, threads, 0, st>>>(
        a, inv, out, total, C, k, two_beta, dmax);
  } else {
    const long long smem = (long long)k * TILE * TPAD;
    if (smem > 48 * 1024 || B > 65535 || (R + TILE - 1) / TILE > 65535)
      return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((C + TILE - 1) / TILE),
              (unsigned)((R + TILE - 1) / TILE), (unsigned)B);
    split_cols<T, MODE><<<grid, dim3(TILE, TROWS), (size_t)smem, st>>>(
        a, inv, out, total, (int)R, (int)C, k, two_beta, dmax);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* inv, void* out, long long B,
           long long R, long long C, int k, int beta, int mode, int axis,
           void* stream) {
  const long long total = B * R * C;
  if (total <= 0 || k <= 0) return 0;
  const T two_beta = T(1 << beta);
  const T dmax = two_beta - T(1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  const T* pi = static_cast<const T*>(inv);
  int8_t* po = static_cast<int8_t*>(out);
  switch (mode) {
    case 0:
      return run<T, 0>(pa, pi, po, total, B, R, C, k, two_beta, dmax, axis,
                       st);
    case 1:
      return run<T, 1>(pa, pi, po, total, B, R, C, k, two_beta, dmax, axis,
                       st);
    case 2:
      return run<T, 2>(pa, pi, po, total, B, R, C, k, two_beta, dmax, axis,
                       st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a: (B, R, C) contiguous; inv: (B, R) for axis 0, (B, C) for axis 1;
// out: (k, B, R, C) for axis 0, (k, B, C, R) for axis 1 (K-major)
extern "C" int split_fused_f32(const void* a, const void* inv, void* out,
                               long long B, long long R, long long C, int k,
                               int beta, int mode, int axis, void* stream) {
  return launch<float>(a, inv, out, B, R, C, k, beta, mode, axis, stream);
}

extern "C" int split_fused_f64(const void* a, const void* inv, void* out,
                               long long B, long long R, long long C, int k,
                               int beta, int mode, int axis, void* stream) {
  return launch<double>(a, inv, out, B, R, C, k, beta, mode, axis, stream);
}
