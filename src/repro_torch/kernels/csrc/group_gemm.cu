// INT8 group GEMM with an INT32 accumulator: the group-wise error-free
// accumulation of Alg. 6/7,
//
//     C[b] = sum_{g < G} A[ia[g], b] @ B[ib[g], b]     (m x n) @ (n x p)
//
// exact in INT32 while G <= r (eq. 12; the caller guarantees it).
//
// Replaces the TPU kernel repro/kernels/group_gemm.py::group_gemm (body
// _group_gemm_kernel).  On the TPU the grid (B, m/bm, p/bp, G, n/bn) runs in
// order and the C tile stays resident in VMEM across the g and n axes.  On
// Hopper blocks run in parallel and in no order, so each block owns one
// (64 x 64) output tile of one batch element and loops over g and n INSIDE
// the block, keeping the 16 sums of each thread in registers: the group sum
// costs no extra pass over device memory, the reference kernel's point.
//
// The slices are read in place: A and B are stacks of digit slices, and the
// byte offset of each pair's slice is passed by value (up to MAX_G pairs),
// so the wrapper gathers nothing.  Each block stages a 64 x 32 A tile and a
// 32 x 64 B tile (B transposed, so 4 consecutive contraction bytes form one
// int) in shared memory and accumulates with __dp4a (four int8 products
// summed into an int32 per instruction).  Ragged m, n and p are masked here
// (zero fill), so the caller pads nothing.
//
// Bound on the H100: at the serving shapes (m = decode slots, a few rows)
// bytes — every weight digit slice of the group is read once; at the DGEMM
// shapes operations, against the 1979 TOP/s of the int8 tensor cores, which
// this simple __dp4a design does not reach (no wgmma, no TMA): making it
// fast is later work.
#include <cstdint>
#include <cuda_runtime.h>

#define BM 64
#define BP 64
#define BK 32
#define MAX_G 32
#define THREADS 256

namespace {

struct Offsets {
  long long a[MAX_G];
  long long b[MAX_G];
};

__global__ void __launch_bounds__(THREADS)
group_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bm,
                  int32_t* __restrict__ Cout, int m, int n, int p, int G,
                  long long a_bs, long long b_bs, Offsets off) {
  // +4 bytes of padding per row: consecutive rows fall in different banks
  __shared__ __align__(16) int8_t sA[BM][BK + 4];
  __shared__ __align__(16) int8_t sB[BP][BK + 4];  // [col][contraction]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BP;
  const long long bidx = blockIdx.z;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int g = 0; g < G; ++g) {
    const int8_t* Ag = A + off.a[g] + bidx * a_bs;
    const int8_t* Bg = Bm + off.b[g] + bidx * b_bs;
    for (int k0 = 0; k0 < n; k0 += BK) {
      // A tile: 64 rows x 32 contraction bytes, 4 bytes per load
      for (int i = tid; i < BM * (BK / 4); i += THREADS) {
        const int r = i / (BK / 4), c4 = (i % (BK / 4)) * 4;
        const int gr = row0 + r, gk = k0 + c4;
        int v = 0;
        if (gr < m) {
          const int8_t* src = Ag + (long long)gr * n + gk;
          if (gk + 3 < n && ((reinterpret_cast<uintptr_t>(src) & 3) == 0)) {
            v = *reinterpret_cast<const int*>(src);
          } else {
            unsigned int packed = 0;
            for (int j = 0; j < 4; ++j)
              if (gk + j < n)
                packed |= (unsigned int)(uint8_t)src[j] << (8 * j);
            v = (int)packed;
          }
        }
        *reinterpret_cast<int*>(&sA[r][c4]) = v;
      }
      // B tile: 32 contraction rows x 64 columns, stored transposed
      for (int i = tid; i < BK * (BP / 4); i += THREADS) {
        const int kr = i / (BP / 4), c4 = (i % (BP / 4)) * 4;
        const int gk = k0 + kr, gc = col0 + c4;
        int8_t v[4] = {0, 0, 0, 0};
        if (gk < n) {
          const int8_t* src = Bg + (long long)gk * p + gc;
          if (gc + 3 < p && ((reinterpret_cast<uintptr_t>(src) & 3) == 0)) {
            const int w = *reinterpret_cast<const int*>(src);
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = (int8_t)(w >> (8 * j));
          } else {
            for (int j = 0; j < 4; ++j)
              if (gc + j < p) v[j] = src[j];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) sB[c4 + j][kr] = v[j];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        int av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const int*>(&sA[ty + 16 * i][kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const int*>(&sB[tx + 16 * j][kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  int32_t* Cb = Cout + bidx * (long long)m * p;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < p) Cb[(long long)r * p + c] = acc[i][j];
    }
  }
}

}  // namespace

// a, b: int8 digit stacks; a_off[g] / b_off[g]: element offset of pair g's
// slice; a_bs / b_bs: batch stride (elements).  c: (B, m, p) int32.
extern "C" int group_gemm_s8(const void* a, const void* b, void* c, int B,
                             int m, int n, int p, int G, long long a_bs,
                             long long b_bs, const long long* a_off,
                             const long long* b_off, void* stream) {
  if (G < 0 || G > MAX_G || B > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || m <= 0 || p <= 0) return 0;
  Offsets off;
  for (int g = 0; g < MAX_G; ++g) {
    off.a[g] = g < G ? a_off[g] : 0;
    off.b[g] = g < G ? b_off[g] : 0;
  }
  dim3 grid((p + BP - 1) / BP, (m + BM - 1) / BM, B);
  group_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(c), m, n, p, G, a_bs, b_bs, off);
  return (int)cudaGetLastError();
}
