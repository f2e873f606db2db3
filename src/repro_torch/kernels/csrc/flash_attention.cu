// Flash attention, forward and recompute-p backward, for GQA in the
// reference's layout: q (BH, Lq, D); k, v (BKV, Lk, D / Dv), BH = BKV * group,
// query head bh reading kv head bh / group (K and V are never expanded).
//
// Replaces the TPU kernels repro/kernels/flash_attention.py::
// flash_attention_fwd (_flash_fwd_kernel) and ::flash_attention_bwd (its two
// pallas_calls, _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel).  On the TPU
// the grid's last axis runs in order and the running max, sum and output
// accumulator stay resident in VMEM across it.  On Hopper blocks run in
// parallel, so each block owns its output tile and loops over the reduction
// axis inside the block, with the online-softmax state in registers:
//
//   forward  one block per (q tile of 64 rows, bh); loops over k tiles.
//   dq       one block per (q tile, bh); loops over k tiles.
//   dk, dv   one block per (k tile of 64 rows, bkv); loops over the q tiles
//            and the group's query heads, summing the group into dk / dv in
//            registers.  No atomics: every output element is written once by
//            one block, so results do not vary from run to run.
//
// Semantics kept from the reference, bit for bit where they decide a value:
//   * masked scores (k >= lk, causal k > q, window k <= q - window) take the
//     FINITE sentinel -1e30, so a row whose every key is masked averages v
//     uniformly over the keys the tensor holds; keys past the tensor's end
//     (the kernel's own ragged tile) are excluded outright;
//   * q is cast to f32 and scaled by D^-1/2 before the score product; the
//     probabilities are rounded to v's dtype before the PV product, with
//     f32 sums (a bf16 x bf16 product is exact in f32);
//   * lse = m + log(l) per row, +inf where l == 0, and the backward
//     recomputes p = exp(s - lse) from it; delta = rowsum(dout * out) comes
//     in precomputed (the reference computes it outside its kernels).
// A k tile (q tile) is skipped where causality or the window masks it for
// every row of the block AND no row of the block is fully masked: such a
// tile adds exp(-1e30 - m) = 0 exactly, so skipping changes no value.  Only
// the summation order differs from the reference.
//
// Bound on the H100: operations (2 L^2 H (D + Dv) flops for the forward,
// halved by causality; 2.5x that for the backward), against 67 TFLOP/s of
// f32 outside the tensor cores, or 989 TFLOP/s of bf16 tensor cores for bf16
// inputs.  This first design computes in f32 FMAs from shared memory (float4
// reads, a 4 x 4 score tile and a 4 x 8 output tile per thread): no wgmma,
// no TMA, which is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#define BQ 64        // query rows per tile
#define BKT 64       // key rows per tile
#define THREADS 256  // 16 x 16: thread (ty, tx) owns rows ty + 16 i
#define DMAX 128     // largest head dimension (4 x 8 output columns/thread)
#define NEG_INF (-1e30f)

namespace {

struct Mask {
  int Lq, Lk, lk, causal, has_window, window, q_offset;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// x rounded to T (the reference's p.astype(v.dtype)) and widened back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows [r0, r0 + rows) of a (L, n) row-major matrix into shared memory with
// row stride ld, times mul (the f32 product rounds as the reference's
// q.astype(f32) * scale); rows past L are zero
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int r0, int rows,
                          int L, int n, float mul) {
  for (int i = threadIdx.x; i < rows * n; i += THREADS) {
    const int r = i / n, c = i - r * n;
    dst[r * ld + c] =
        r0 + r < L ? to_f(src[(long long)(r0 + r) * n + c]) * mul : 0.f;
  }
}

// s[i][j] = A[ty + 16 i, :n] . B[tx + 16 j, :n]  (n a multiple of 4)
__device__ __forceinline__ void tile_dot(const float* A, int lda,
                                         const float* B, int ldb, int n,
                                         int tx, int ty, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < n; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ldb + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        s[i][j] = t;
      }
  }
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// acc[i][4 h + u] += sum_{r < nr} P[ty + 16 i, r] * V[r, 64 h + 4 tx + u]
// for the columns below ncols (a multiple of 4, at most DMAX)
__device__ __forceinline__ void tile_mac(const float* P, int ldp,
                                         const float* V, int ldv, int nr,
                                         int ncols, int tx, int ty,
                                         float (&acc)[4][8]) {
  const bool h0 = 4 * tx < ncols, h1 = 64 + 4 * tx < ncols;
  for (int r = 0; r < nr; r += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * ldp + r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* row = V + (r + u) * ldv + 4 * tx;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 v0 = h0 ? *reinterpret_cast<const float4*>(row) : z;
      const float4 v1 = h1 ? *reinterpret_cast<const float4*>(row + 64) : z;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pu = comp(p[i], u);
        acc[i][0] = fmaf(pu, v0.x, acc[i][0]);
        acc[i][1] = fmaf(pu, v0.y, acc[i][1]);
        acc[i][2] = fmaf(pu, v0.z, acc[i][2]);
        acc[i][3] = fmaf(pu, v0.w, acc[i][3]);
        acc[i][4] = fmaf(pu, v1.x, acc[i][4]);
        acc[i][5] = fmaf(pu, v1.y, acc[i][5]);
        acc[i][6] = fmaf(pu, v1.z, acc[i][6]);
        acc[i][7] = fmaf(pu, v1.w, acc[i][7]);
      }
    }
  }
}

// rows ty + 16 i, columns 64 h + 4 tx + u of a tile into dst (L, n): rows
// past L and columns past n are dropped
template <typename T>
__device__ void store_tile(T* dst, int r0, int L, int n, int tx, int ty,
                           const float (&acc)[4][8], float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= L) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 64 * (c / 4) + 4 * tx + c % 4;
      if (col < n) put(dst + (long long)r * n + col, acc[i][c] * mul);
    }
  }
}

// the score at (query position qp, key index kp) after the reference's
// masks: the sentinel where masked, -inf past the tensor's keys
__device__ __forceinline__ float masked(float s, int qp, int kp,
                                        const Mask& mk) {
  if (kp >= mk.Lk) return -CUDART_INF_F;
  bool ok = kp < mk.lk;
  if (mk.causal) ok = ok && kp <= qp;
  if (mk.has_window) ok = ok && kp > qp - mk.window;
  return ok ? s : NEG_INF;
}

// Over the query rows [q0, q0 + BQ) that exist: whether one of them has no
// unmasked key, and the union [lo, hi] of their unmasked key ranges.
struct Reach {
  bool any_empty;
  int lo, hi;
};

__device__ Reach reach(int q0, const Mask& mk) {
  Reach r{false, 1 << 30, -1};
  const int last = min(q0 + BQ, mk.Lq);
  for (int q = q0; q < last; ++q) {
    const int qp = q + mk.q_offset;
    int hi = min(mk.lk, mk.Lk) - 1;
    if (mk.causal) hi = min(hi, qp);
    const int lo = mk.has_window ? max(0, qp - mk.window + 1) : 0;
    if (lo > hi) {
      r.any_empty = true;
    } else {
      r.lo = min(r.lo, lo);
      r.hi = max(r.hi, hi);
    }
  }
  return r;
}

__device__ __forceinline__ bool tile_needed(const Reach& r, int k0) {
  return r.any_empty || (k0 <= r.hi && k0 + BKT - 1 >= r.lo);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int group, int D, int Dv, Mask mk,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = D + 4, ldv = Dv + 4, ldp = BKT + 4;
  float* sQ = smem;
  float* sK = sQ + BQ * ldq;
  float* sV = sK + BKT * ldq;
  float* sP = sV + BKT * ldv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, bkv = bh / group;
  const T* kh = k + (long long)bkv * mk.Lk * D;
  const T* vh = v + (long long)bkv * mk.Lk * Dv;
  load_tile(sQ, ldq, q + (long long)bh * mk.Lq * D, q0, BQ, mk.Lq, D, scale);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  const Reach rc = reach(q0, mk);
  const int n_k = (mk.Lk + BKT - 1) / BKT;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BKT;
    if (!tile_needed(rc, k0)) continue;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    load_tile(sK, ldq, kh, k0, BKT, mk.Lk, D, 1.f);
    load_tile(sV, ldv, vh, k0, BKT, mk.Lk, Dv, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot(sQ, ldq, sK, ldq, D, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + mk.q_offset;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(s[i][j], qp, k0 + tx + 16 * j, mk);
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mt));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sP[(ty + 16 * i) * ldp + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    tile_mac(sP, ldp, sV, ldv, BKT, Dv, tx, ty, acc);
  }

  T* oh = o + (long long)bh * mk.Lq * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = acc[i][c] / lc;
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < mk.Lq)
      lse[(long long)bh * mk.Lq + r] =
          l[i] > 0.f ? m[i] + logf(lc) : CUDART_INF_F;
  }
  store_tile(oh, q0, mk.Lq, Dv, tx, ty, acc, 1.f);
}

// dq = scale * sum_k ds k,  ds = p (dout . v - delta),  p = exp(s - lse)
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int group, int D, int Dv, Mask mk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = D + 4, ldv = Dv + 4, ldp = BKT + 4;
  float* sQ = smem;
  float* sO = sQ + BQ * ldq;   // dout
  float* sK = sO + BQ * ldv;
  float* sV = sK + BKT * ldq;
  float* sS = sV + BKT * ldv;  // ds
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, bkv = bh / group;
  const T* kh = k + (long long)bkv * mk.Lk * D;
  const T* vh = v + (long long)bkv * mk.Lk * Dv;
  load_tile(sQ, ldq, q + (long long)bh * mk.Lq * D, q0, BQ, mk.Lq, D, scale);
  load_tile(sO, ldv, dout + (long long)bh * mk.Lq * Dv, q0, BQ, mk.Lq, Dv,
            1.f);
  float lse_r[4], delta_r[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const long long at = (long long)bh * mk.Lq + r;
    lse_r[i] = r < mk.Lq ? lse[at] : 0.f;
    delta_r[i] = r < mk.Lq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  const Reach rc = reach(q0, mk);
  const int n_k = (mk.Lk + BKT - 1) / BKT;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BKT;
    if (!tile_needed(rc, k0)) continue;
    __syncthreads();
    load_tile(sK, ldq, kh, k0, BKT, mk.Lk, D, 1.f);
    load_tile(sV, ldv, vh, k0, BKT, mk.Lk, Dv, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(sQ, ldq, sK, ldq, D, tx, ty, s);
    tile_dot(sO, ldv, sV, ldv, Dv, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float sm = masked(s[i][j], r + mk.q_offset, kp, mk);
        const float p = (r < mk.Lq && kp < mk.Lk) ? expf(sm - lse_r[i]) : 0.f;
        sS[(ty + 16 * i) * ldp + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_mac(sS, ldp, sK, ldq, BKT, D, tx, ty, acc);
  }
  store_tile(dq + (long long)bh * mk.Lq * D, q0, mk.Lq, D, tx, ty, acc,
             scale);
}

// per k tile of kv head bkv, summed over the q tiles and the group's heads:
// dv = sum_q p^T dout,  dk = sum_q ds^T (scale q)
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int group, int D, int Dv, Mask mk,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = D + 4, ldv = Dv + 4, ldp = BQ + 4;
  float* sK = smem;
  float* sV = sK + BKT * ldq;
  float* sQ = sV + BKT * ldv;
  float* sO = sQ + BQ * ldq;   // dout
  float* sP = sO + BQ * ldv;   // p^T, then ds^T
  float* sL = sP + BKT * ldp;  // lse of the q tile's rows
  float* sD = sL + BQ;         // delta of the q tile's rows
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BKT, bkv = blockIdx.y;
  load_tile(sK, ldq, k + (long long)bkv * mk.Lk * D, k0, BKT, mk.Lk, D, 1.f);
  load_tile(sV, ldv, v + (long long)bkv * mk.Lk * Dv, k0, BKT, mk.Lk, Dv,
            1.f);
  float adk[4][8], adv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) adk[i][c] = adv[i][c] = 0.f;
  const int n_q = (mk.Lq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    if (!tile_needed(reach(q0, mk), k0)) continue;
    for (int g = 0; g < group; ++g) {
      const int bh = bkv * group + g;
      __syncthreads();  // the previous step's reads of sQ / sO / sP are done
      load_tile(sQ, ldq, q + (long long)bh * mk.Lq * D, q0, BQ, mk.Lq, D,
                scale);
      load_tile(sO, ldv, dout + (long long)bh * mk.Lq * Dv, q0, BQ, mk.Lq,
                Dv, 1.f);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        const bool in = q0 + r < mk.Lq;
        sL[r] = in ? lse[(long long)bh * mk.Lq + q0 + r] : 0.f;
        sD[r] = in ? delta[(long long)bh * mk.Lq + q0 + r] : 0.f;
      }
      __syncthreads();
      // transposed tiles: rows are keys ty + 16 i, columns queries tx + 16 j
      float p[4][4], dp[4][4];
      tile_dot(sK, ldq, sQ, ldq, D, tx, ty, p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const float sm = masked(p[i][j], q0 + qr + mk.q_offset, kp, mk);
          p[i][j] = (q0 + qr < mk.Lq && kp < mk.Lk) ? expf(sm - sL[qr]) : 0.f;
          sP[(ty + 16 * i) * ldp + qr] = p[i][j];
        }
      }
      __syncthreads();
      tile_mac(sP, ldp, sO, ldv, BQ, Dv, tx, ty, adv);
      tile_dot(sV, ldv, sO, ldv, Dv, tx, ty, dp);
      __syncthreads();  // every thread is done reading p^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          sP[(ty + 16 * i) * ldp + qr] = p[i][j] * (dp[i][j] - sD[qr]);
        }
      __syncthreads();
      tile_mac(sP, ldp, sQ, ldq, BQ, D, tx, ty, adk);
    }
  }
  store_tile(dk + (long long)bkv * mk.Lk * D, k0, mk.Lk, D, tx, ty, adk,
             1.f);
  store_tile(dv + (long long)bkv * mk.Lk * Dv, k0, mk.Lk, Dv, tx, ty, adv,
             1.f);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int check_dims(int BH, int group, int D, int Dv) {
  if (BH <= 0 || group <= 0 || BH % group || BH > 65535 || D <= 0 ||
      Dv <= 0 || D > DMAX || Dv > DMAX || D % 4 || Dv % 4)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, int group, int D, int Dv, Mask mk, float scale,
        cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 4) + BKT * (D + 4) + BKT * (Dv + 4) +
                       BQ * (BKT + 4));
  if (int e = set_smem(flash_fwd_kernel<T>, smem)) return e;
  dim3 grid((mk.Lq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      group, D, Dv, mk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int BH, int group,
           int D, int Dv, Mask mk, float scale, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 4) + BQ * (Dv + 4) + BKT * (D + 4) +
                       BKT * (Dv + 4) + BQ * (BKT + 4));
  if (int e = set_smem(flash_bwd_dq_kernel<T>, smem)) return e;
  dim3 grid((mk.Lq + BQ - 1) / BQ, BH);
  flash_bwd_dq_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), group, D, Dv, mk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int BH,
            int group, int D, int Dv, Mask mk, float scale,
            cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (BKT * (D + 4) + BKT * (Dv + 4) + BQ * (D + 4) +
                       BQ * (Dv + 4) + BKT * (BQ + 4) + 2 * BQ);
  if (int e = set_smem(flash_bwd_dkv_kernel<T>, smem)) return e;
  dim3 grid((mk.Lk + BKT - 1) / BKT, BH / group);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), group, D, Dv, mk, scale);
  return (int)cudaGetLastError();
}

Mask make_mask(int Lq, int Lk, int lk, int causal, int has_window,
               int window, int q_offset) {
  return Mask{Lq, Lk, lk, causal, has_window, window, q_offset};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o share it).  q (BH, Lq, D),
// k (BH / group, Lk, D), v (BH / group, Lk, Dv), o (BH, Lq, Dv), lse (BH, Lq)
// f32; all contiguous.  D and Dv: multiples of 4, at most 128.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int dtype, int BH, int group, int Lq,
                                   int Lk, int D, int Dv, int lk, int causal,
                                   int has_window, int window, int q_offset,
                                   float scale, void* stream) {
  if (int e = check_dims(BH, group, D, Dv)) return e;
  if (Lq <= 0) return 0;
  const Mask mk = make_mask(Lq, Lk, lk, causal, has_window, window, q_offset);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd<__nv_bfloat16>(q, k, v, o, lse, BH, group, D, Dv,
                                         mk, scale, st)
                    : fwd<float>(q, k, v, o, lse, BH, group, D, Dv, mk,
                                 scale, st);
}

// The backward's two kernels, launched in order on one stream: dq, then
// dk / dv.  dout as q; delta (BH, Lq) f32; dq, dk, dv as q, k, v.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int dtype,
                                   int BH, int group, int Lq, int Lk, int D,
                                   int Dv, int lk, int causal, int has_window,
                                   int window, int q_offset, float scale,
                                   int which, void* stream) {
  if (int e = check_dims(BH, group, D, Dv)) return e;
  const Mask mk = make_mask(Lq, Lk, lk, causal, has_window, window, q_offset);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    if (Lq <= 0) return 0;
    return dtype == 1
               ? bwd_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH,
                                       group, D, Dv, mk, scale, st)
               : bwd_dq<float>(q, k, v, dout, lse, delta, dq, BH, group, D,
                               Dv, mk, scale, st);
  }
  if (Lk <= 0) return 0;
  return dtype == 1
             ? bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BH,
                                      group, D, Dv, mk, scale, st)
             : bwd_dkv<float>(q, k, v, dout, lse, delta, dk, dv, BH, group,
                              D, Dv, mk, scale, st);
}
