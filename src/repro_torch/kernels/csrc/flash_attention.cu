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
//   forward  one block per (q tile, bh); loops over k tiles.
//   dq       one block per (q tile, bh); loops over k tiles.
//   dk, dv   one block per (k tile, bkv); loops over the q tiles and the
//            group's query heads, summing the group into dk / dv in
//            registers.  No atomics: every output element is written once by
//            one block, so results do not vary from run to run.
// Q tiles are issued longest first (the causal diagonal's short tiles fill
// the tail of the grid); K/V (forward, dq) and Q/dO (dk/dv) tiles stream
// through a ring of shared-memory stages, the next tiles in flight while the
// current one is multiplied: by TMA behind mbarriers on the bf16 route
// where the row strides allow it (see "the stage ring" below), by cp.async
// otherwise.
//
// Semantics kept from the reference, bit for bit where they decide a value:
//   * masked scores (k >= lk, causal k > q, window k <= q - window) take the
//     FINITE sentinel -1e30, so a row whose every key is masked averages v
//     uniformly over the keys the tensor holds; keys past the tensor's end
//     (the kernel's own ragged tile) are excluded outright;
//   * the probabilities are rounded to v's dtype before the PV product,
//     while the row sum l adds the unrounded f32 p;
//   * lse = m + log(l) per row, +inf where l == 0, and the backward
//     recomputes p = exp(s - lse) from it; delta = rowsum(dout * out) comes
//     in precomputed (the reference computes it outside its kernels).
// A k tile (q tile) is skipped where causality or the window masks it for
// every row of the block AND no row of the block is fully masked: such a
// tile adds exp(-1e30 - m) = 0 exactly, so skipping changes no value.
//
// Two routes, by dtype:
//
// * bf16 (wgmma; bound: operations against the 989 TFLOP/s of the bf16
//   tensor cores).  Two consumer warpgroups of 64 rows each.  Every product
//   is a wgmma.mma_async m64nNk16 with f32 accumulators: S = Q K^T from
//   shared memory (both K-major as stored); the scale is applied to S in f32
//   (the reference scales q in f32, which bf16 operands cannot carry); the
//   online softmax runs on the accumulator fragment; P, rounded to bf16 in
//   registers, is the A operand of O += P V, V read MN-major through the
//   transpose bit.  The backward forms S and dP = dO V^T the same way, and
//   dQ += dS K, dV += P^T dO, dK += dS^T Q with the register operand
//   (the dk/dv kernel computes S^T = K Q^T so that P^T and dS^T land in
//   registers).  P is rounded to bf16 as the forward rounds it; dS is
//   carried as two bf16 terms (hi = bf16(dS), lo = bf16(dS - hi)), two
//   wgmmas, since one term misses the reference's bf16 tolerance where
//   fully masked rows give p = 1 on every key.  Tiles live in shared memory
//   in the 128-byte swizzle (rows of 64 bf16, 16-byte unit j of row r at
//   j ^ (r % 8)); head dims pad to 64 or 128 with zeros, and only the
//   16-wide steps that hold data are issued over the contraction.
// * f32 (3xTF32; bound: operations against 495 / 3 TFLOP/s).  Each f32
//   operand is split as hi = cvt.rna.tf32(x), lo = tf32 truncation of
//   x - hi, and each product is hi.hi + hi.lo + lo.hi on mma.sync
//   m16n8k8 with f32 sums, one warp per 16 rows; q is scaled in f32 before
//   its split, as the reference scales it.  The accumulator of one product
//   is the A operand of the next with the contraction index permuted
//   (register pair 2t, 2t+1 read as k = t, t + 4, the B rows likewise).
//   The tensor core truncates its f32 sums, so every product is summed in
//   a fresh register tile, 32 of its contraction at a time, and added to
//   the running sum with round-to-nearest f32 adds (mma_kmajor, mma_pb):
//   one accumulator over all 4096 keys drifted past 2e-4 on rows whose
//   p is 1 on every key.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#define NEG_INF (-1e30f)

namespace {

typedef __nv_bfloat16 bf16;

struct Mask {
  int Lq, Lk, lk, causal, has_window, window, q_offset;
};

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

// Over the query rows [a, b] (b >= a): whether one of them has no unmasked
// key, and the union [lo, hi] of their unmasked key ranges.  Row q's range
// is [lo(q), hi(q)], both non-decreasing in q and growing by at most one a
// row, so the empty rows are a prefix and a suffix of all rows (checking
// the ends suffices) and the ranges of the others join up.
struct Reach {
  bool any_empty;
  int lo, hi;
};

__device__ __forceinline__ int row_lo(int q, const Mask& mk) {
  return mk.has_window ? max(0, q + mk.q_offset - mk.window + 1) : 0;
}
__device__ __forceinline__ int row_hi(int q, const Mask& mk) {
  const int hi = min(mk.lk, mk.Lk) - 1;
  return mk.causal ? min(hi, q + mk.q_offset) : hi;
}
__device__ __forceinline__ Reach reach(int a, int b, const Mask& mk) {
  return Reach{row_lo(a, mk) > row_hi(a, mk) || row_lo(b, mk) > row_hi(b, mk),
               row_lo(a, mk), row_hi(b, mk)};
}
// whether keys [k0, k1] matter to the rows of r
__device__ __forceinline__ bool keys_needed(const Reach& r, int k0, int k1) {
  return r.any_empty || (k0 <= r.hi && k1 >= r.lo);
}
// the k tiles of size bn the query rows [a, b] need, as [t0, t1]
__device__ __forceinline__ void tile_range(int a, int b, int bn,
                                           const Mask& mk, int& t0,
                                           int& t1) {
  const Reach rc = reach(a, b, mk);
  t0 = 0;
  t1 = (mk.Lk + bn - 1) / bn - 1;
  if (!rc.any_empty) {
    t0 = rc.lo / bn;
    t1 = min(t1, rc.hi / bn);
  }
}

// whether every (query, key) pair of rows [qa, qb] and keys [ka, kb] exists
// and is unmasked: then the tile needs no mask arithmetic
__device__ __forceinline__ bool all_live(int qa, int qb, int ka, int kb,
                                         const Mask& mk) {
  return qb < mk.Lq && row_lo(qb, mk) <= ka && row_hi(qa, mk) >= kb;
}

// e^x through the SFU's 2^x (x = -inf gives 0; subnormal results flush)
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(valid)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// n floats from src (zero where i >= valid) into dst, by threads
// [first, first + n); the row statistics lse and delta of a q tile
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int valid, int first, int n) {
  const int i = (int)threadIdx.x - first;
  if (i >= 0 && i < n) cp_async<4>(dst + i, src + (i < valid ? i : 0),
                                   i < valid ? 4 : 0);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// The accumulator fragment both routes share: in a warp's 16 rows, lane
// (g = lane / 4, t = lane % 4) holds f[4 c + 2 h + e] at row g + 8 h,
// column 8 c + 2 t + e (wgmma: warp w of the warpgroup owns rows 16 w ..;
// mma.sync m16n8: c is the n tile).
// ---------------------------------------------------------------------------

// The scores of a fragment (NC column tiles) scaled in place, and masked
// unless live (every pair of the tile exists and is unmasked; the branch is
// taken once, outside the element loops).  Rows are queries and columns
// keys, or the transpose (TRANS): row is this lane's h = 0 row, col0 the
// tile's first column.
template <int NC, bool TRANS>
__device__ __forceinline__ void scale_mask(float (&s)[4 * NC], int row,
                                           int col0, int t4, float scale,
                                           bool live, const Mask& mk) {
  if (live) {
#pragma unroll
    for (int i = 0; i < 4 * NC; ++i) s[i] *= scale;
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row + 8 * h, cl = col0 + 8 * c + 2 * t4 + e;
        float& x = s[4 * c + 2 * h + e];
        x = TRANS ? masked(x * scale, cl + mk.q_offset, r, mk)
                  : masked(x * scale, r + mk.q_offset, cl, mk);
      }
}

// One online-softmax step over a scaled, masked score fragment of NC
// column tiles: running max, p = exp(s - m) in place (f32), l summed from
// that f32 p, and the output accumulator (NA column tiles) rescaled.
template <int NC, int NA>
__device__ __forceinline__ void softmax_step(float (&s)[4 * NC],
                                             float (&acc)[4 * NA],
                                             float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      mx = fmaxf(mx, fmaxf(s[4 * c + 2 * h], s[4 * c + 2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(mx));
    const float corr = exp_sfu(m[h] - mn);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * c + 2 * h + e];
        x = exp_sfu(x - mn);
        sum += x;
      }
    l[h] = l[h] * corr + quad_sum(sum);
    m[h] = mn;
#pragma unroll
    for (int c = 0; c < NA; ++c) {
      acc[4 * c + 2 * h] *= corr;
      acc[4 * c + 2 * h + 1] *= corr;
    }
  }
}

// The backward's p and ds on a scaled, masked fragment, in place:
// s -> p = exp(s - lse), dp -> ds = p (dp - delta).  Rows are queries and
// columns keys (TRANS = false: lse and delta per row, from lse_r /
// delta_r) or the transpose (TRANS = true: rows keys, columns queries, lse
// and delta per column from shared memory sl / sd).  Pairs past the
// tensors' ends get p = 0 (unless live: the tile has none).
template <int NC, bool TRANS>
__device__ __forceinline__ void p_and_ds(float (&s)[4 * NC],
                                         float (&dp)[4 * NC], int row,
                                         int col0, int t4,
                                         const float (&lse_r)[2],
                                         const float (&delta_r)[2],
                                         const float* sl, const float* sd,
                                         bool live, const Mask& mk) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * c + 2 * h + e, cl = 8 * c + 2 * t4 + e;
        const float L = TRANS ? sl[cl] : lse_r[h];
        const float dl = TRANS ? sd[cl] : delta_r[h];
        float p = exp_sfu(s[i] - L);
        if (!live) {
          const int qi = TRANS ? col0 + cl : row + 8 * h;
          const int kp = TRANS ? row + 8 * h : col0 + cl;
          p = (qi < mk.Lq && kp < mk.Lk) ? p : 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - dl);
      }
}

// ===========================================================================
// bf16 route: wgmma
// ===========================================================================
namespace wg {

constexpr int THREADS = 256;  // two warpgroups, 64 rows each

// byte offset of element (r, col) (col a multiple of 4) in a tile of R rows
// stored as 64-column chunks of R rows x 128 bytes, 128-byte swizzle
__device__ __forceinline__ uint32_t sw_off(int r, int col, int R) {
  return (uint32_t)((col >> 6) * R * 128 + r * 128 +
                    ((((col >> 3) & 7) ^ (r & 7)) << 4) + (((col >> 2) & 1) << 3));
}

// rows [r0, r0 + R) of an (L, n) bf16 matrix (row stride n) into a tile of
// R rows and C chunks, zero past row L and past column n.  vec16: n is a
// multiple of 8 (16-byte copies); otherwise 8-byte copies (n % 4 == 0).
template <int C>
__device__ __forceinline__ void load_rows(uint8_t* tile, const bf16* src,
                                          int r0, int R, int L, int n,
                                          bool vec16) {
  if (vec16) {
    constexpr int PER = 8 * C;
    for (int i = threadIdx.x; i < R * PER; i += THREADS) {
      const int r = i / PER, col = (i % PER) * 8;
      const bool live = r0 + r < L && col < n;
      cp_async<16>(tile + sw_off(r, col, R),
                   src + (live ? (long long)(r0 + r) * n + col : 0),
                   live ? 16 : 0);
    }
  } else {
    constexpr int PER = 16 * C;
    for (int i = threadIdx.x; i < R * PER; i += THREADS) {
      const int r = i / PER, col = (i % PER) * 4;
      const bool live = r0 + r < L && col < n;
      cp_async<8>(tile + sw_off(r, col, R),
                  src + (live ? (long long)(r0 + r) * n + col : 0),
                  live ? 8 : 0);
    }
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: 8-row groups 1024
// bytes apart (SBO).  K-major operands (lbo 16, unused): a 16-wide step
// within a chunk adds 32 bytes to the start.  MN-major operands (the
// transpose bit): lbo is the distance between 64-column chunks, and a step
// of 16 contraction rows adds 2048 bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// K-major operand: rows [row, row + 64) (A) or all rows (B) of a tile of R
// rows, contraction step kk (16 columns)
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int R,
                                          int row, int kk) {
  return desc(tile + (kk >> 2) * R * 128 + row * 128 + (kk & 3) * 32, 16);
}
// MN-major B operand: contraction rows [16 kk, 16 kk + 16) of a tile of R
// rows, all columns
__device__ __forceinline__ uint64_t ndesc(const uint8_t* tile, int R,
                                          int kk) {
  return desc(tile + kk * 2048, R * 128);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma, or reusing a register operand's registers before the
// wgmma reading it is done
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define FA_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D16(i) FA_D8(i), FA_D8(i + 8)
#define FA_D32(i) FA_D16(i), FA_D16(i + 16)
#define FA_D64(i) FA_D32(i), FA_D32(i + 32)

// d (64 x 64, f32) += A (64 x 16, smem) B (16 x 64, smem), both K-major
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, "
      "0, 0;"
      "\n}\n"
      : FA_D32(0)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128, f32) += A (64 x 16, smem) B (16 x 128, smem), both K-major
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, "
      "%65, p, 1, 1, 0, 0;"
      "\n}\n"
      : FA_D64(0)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) B (16 x 64, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, "
      "%35}, %36, p, 1, 1, 1;"
      "\n}\n"
      : FA_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) B (16 x 128, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void mma_rs(float (&d)[64],
                                       const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, "
      "%65, %66, %67}, %68, p, 1, 1, 1;"
      "\n}\n"
      : FA_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A operand fragments of a 64 x (16 K) register tile from an accumulator
// fragment f (4 c + 2 h + e layout): chunk kk covers columns 16 kk .. +15
template <int K>
__device__ __forceinline__ void to_a(uint32_t (&a)[K][4],
                                     const float (&f)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack(f[8 * kk + 2 * j], f[8 * kk + 2 * j + 1]);
}

// the same as two bf16 terms: hi = bf16(f), lo = bf16(f - hi)
template <int K>
__device__ __forceinline__ void to_a2(uint32_t (&hi)[K][4],
                                      uint32_t (&lo)[K][4],
                                      const float (&f)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = f[8 * kk + 2 * j], y = f[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][j] = pack(x - __low2float(h), y - __high2float(h));
    }
}

// rows row + 8 h, columns 8 c + 2 t + e of an accumulator fragment into
// dst (L, n) in bf16, times mul; rows past L and columns past n dropped
template <int NC>
__device__ __forceinline__ void store_bf16(bf16* dst, int row, int L, int n,
                                           int t4, const float (&f)[4 * NC],
                                           float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= L) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 8 * c + 2 * t4;
      if (col < n)
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * n + col) =
            __floats2bfloat162_rn(f[4 * c + 2 * h] * mul,
                                  f[4 * c + 2 * h + 1] * mul);
    }
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---- the stage ring: TMA behind mbarriers, or cp.async ---------------------
//
// TMA (head dims multiples of 8: 16-byte row strides): thread 0 (warp 0 in
// the dk/dv kernel) issues each tile's tensor copies, which zero-fill past
// the tensor's edges and complete on the stage's full barrier; each
// warpgroup arrives on the stage's empty barrier once its products have
// read the stage, and the previous tile's stage is refilled with the tile
// STAGES - 1 after it.  The warpgroups never wait for each other within a
// tile, so one's softmax can run beside the other's products.
// cp.async (other head dims): all threads copy the next tile while the
// current one is multiplied, two stages, a block barrier per tile.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
// one arrival on bar once this thread's cp.async copies so far complete
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// wait for the phase of `parity` to complete.  A wait that never ends is a
// fault of the kernel; it traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long long polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls > (1LL << 26)) __trap();
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the tensor maps of q, k, v and dout: (columns, rows, heads), bf16, boxes
// of 64 columns (one 128-byte swizzle row) by the kernel's tile rows
struct Maps {
  CUtensorMap q, k, v, o;
};

// rows [r0, r0 + R) of head `head` behind map into a tile of C chunks
template <int C>
__device__ __forceinline__ void tma_rows(uint8_t* tile, const CUtensorMap* map,
                                         uint64_t* bar, int r0, int R,
                                         int head) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
            smem_u32(tile + c * R * 128)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(64 * c),
        "r"(r0), "r"(head)
        : "memory");
}

// ---- forward: 128 query rows a block, key tiles of 128 -------------------
namespace fwd {
constexpr int BM = 128, BN = 128;
template <bool TMA>
constexpr int STAGES = TMA ? 3 : 2;
template <int C, bool TMA>
constexpr int smem_bytes() {
  return (BM + 2 * STAGES<TMA> * BN) * 128 * C + 1024 + 64;
}
}  // namespace fwd

template <int C, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int group, int D, int Dv, Mask mk,
               float scale, int vq, int vv,
               const __grid_constant__ Maps maps) {
  using namespace fwd;
  constexpr int S = STAGES<TMA>;
  constexpr int N = 64 * C;                      // padded Dv
  constexpr int KB = BN * 128 * C;               // bytes of a K or V tile
  extern __shared__ uint8_t raw[];
  uint8_t* sQ = align1024(raw);
  uint8_t* sK = sQ + BM * 128 * C;               // [S][KB]
  uint8_t* sV = sK + S * KB;                     // [S][KB]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + S * KB);
  uint64_t* full = qbar + 1;                     // [S]
  uint64_t* empty = full + S;                    // [S]
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, bkv = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest first
  const bf16* kh = k + (long long)bkv * mk.Lk * D;
  const bf16* vh = v + (long long)bkv * mk.Lk * Dv;
  int t0, t1;
  tile_range(q0, min(q0 + BM, mk.Lq) - 1, BN, mk, t0, t1);
  const int n = t1 - t0 + 1;

  // the block's i-th k tile into stage i % S
  auto issue = [&](int i) {
    const int st = i % S, r0 = (t0 + i) * BN;
    if constexpr (TMA) {
      mbar_expect_tx(&full[st], 2 * KB);
      tma_rows<C>(sK + st * KB, &maps.k, &full[st], r0, BN, bkv);
      tma_rows<C>(sV + st * KB, &maps.v, &full[st], r0, BN, bkv);
    } else {
      load_rows<C>(sK + st * KB, kh, r0, BN, mk.Lk, D, vq);
      load_rows<C>(sV + st * KB, vh, r0, BN, mk.Lk, Dv, vv);
    }
  };
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      mbar_init(qbar, 1);
      for (int i = 0; i < S; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], 2);  // one arrival per warpgroup
      }
      fence_mbar_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, BM * 128 * C);
      tma_rows<C>(sQ, &maps.q, qbar, q0, BM, bh);
      for (int i = 0; i < min(S, n); ++i) issue(i);
    }
    mbar_wait(qbar, 0);
  } else {
    load_rows<C>(sQ, q + (long long)bh * mk.Lq * D, q0, BM, mk.Lq, D, vq);
    if (n > 0) issue(0);
    cp_async_commit();
  }

  const int row = q0 + wg * 64 + warp * 16 + g8;  // this lane's h = 0 row
  const int wq0 = q0 + wg * 64, wq1 = wq0 + 63;    // this warpgroup's rows
  const int nd = (D + 15) >> 4;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[N / 2];
  zero(acc);
  for (int i = 0; i < n; ++i) {
    const int it = t0 + i, st = i % S;
    if constexpr (TMA) {
      mbar_wait(&full[st], (i / S) & 1);
    } else {
      if (i + 1 < n) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
      fence_async_smem();
      __syncthreads();
    }
    const uint8_t* kt = sK + st * KB;
    const uint8_t* vt = sV + st * KB;

    float s[BN / 2];
    zero(s);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * C; ++kk)
      if (kk < nd) mma_ss(s, kdesc(sQ, BM, wg * 64, kk), kdesc(kt, BN, 0, kk),
                          kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    scale_mask<BN / 8, false>(s, row, it * BN, t4, scale,
                              all_live(wq0, wq1, it * BN, it * BN + BN - 1,
                                       mk),
                              mk);
    softmax_step<BN / 8, N / 8>(s, acc, m, l);
    uint32_t pa[BN / 16][4];
    to_a(pa, s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) mma_rs(acc, pa[kk], ndesc(vt, BN, kk));
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(pa);
    if constexpr (TMA) {
      if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[st]);
      if (threadIdx.x == 0 && i >= 1 && i - 1 + S < n) {
        mbar_wait(&empty[(i - 1) % S], ((i - 1) / S) & 1);
        issue(i - 1 + S);
      }
      __syncwarp();
    } else {
      __syncthreads();  // the stage is read by all before it is refilled
    }
  }
  if constexpr (!TMA) cp_async_wait<0>();

  float lc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lc[h] = fmaxf(l[h], 1e-30f);
    const int r = row + 8 * h;
    if (t4 == 0 && r < mk.Lq)
      lse[(long long)bh * mk.Lq + r] =
          l[h] > 0.f ? m[h] + logf(lc[h]) : CUDART_INF_F;
  }
  // the reference divides by l
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * c + 2 * h] /= lc[h];
      acc[4 * c + 2 * h + 1] /= lc[h];
    }
  store_bf16<N / 8>(o + (long long)bh * mk.Lq * Dv, row, mk.Lq, Dv, t4, acc,
                    1.f);
}

// ---- dq: 128 query rows a block, key tiles of 64 --------------------------
namespace dq {
constexpr int BM = 128, BN = 64;
template <bool TMA>
constexpr int STAGES = TMA ? 3 : 2;
template <int C, bool TMA>
constexpr int smem_bytes() {
  return (2 * BM + 2 * STAGES<TMA> * BN) * 128 * C + 1024 + 64;
}
}  // namespace dq

// dq = scale sum_k ds k,  ds = p (dout . v - delta),  p = exp(s - lse)
template <int C, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dqo, int group, int D, int Dv, Mask mk,
              float scale, int vq, int vv,
              const __grid_constant__ Maps maps) {
  using namespace dq;
  constexpr int S = STAGES<TMA>;
  constexpr int N = 64 * C;
  constexpr int KB = BN * 128 * C;
  extern __shared__ uint8_t raw[];
  uint8_t* sQ = align1024(raw);
  uint8_t* sO = sQ + BM * 128 * C;               // dout
  uint8_t* sK = sO + BM * 128 * C;               // [S][KB]
  uint8_t* sV = sK + S * KB;                     // [S][KB]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + S * KB);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, bkv = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const bf16* kh = k + (long long)bkv * mk.Lk * D;
  const bf16* vh = v + (long long)bkv * mk.Lk * Dv;
  int t0, t1;
  tile_range(q0, min(q0 + BM, mk.Lq) - 1, BN, mk, t0, t1);
  const int n = t1 - t0 + 1;

  auto issue = [&](int i) {
    const int st = i % S, r0 = (t0 + i) * BN;
    if constexpr (TMA) {
      mbar_expect_tx(&full[st], 2 * KB);
      tma_rows<C>(sK + st * KB, &maps.k, &full[st], r0, BN, bkv);
      tma_rows<C>(sV + st * KB, &maps.v, &full[st], r0, BN, bkv);
    } else {
      load_rows<C>(sK + st * KB, kh, r0, BN, mk.Lk, D, vq);
      load_rows<C>(sV + st * KB, vh, r0, BN, mk.Lk, Dv, vv);
    }
  };
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      mbar_init(qbar, 1);
      for (int i = 0; i < S; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], 2);
      }
      fence_mbar_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, 2 * BM * 128 * C);
      tma_rows<C>(sQ, &maps.q, qbar, q0, BM, bh);
      tma_rows<C>(sO, &maps.o, qbar, q0, BM, bh);
      for (int i = 0; i < min(S, n); ++i) issue(i);
    }
  } else {
    load_rows<C>(sQ, q + (long long)bh * mk.Lq * D, q0, BM, mk.Lq, D, vq);
    load_rows<C>(sO, dout + (long long)bh * mk.Lq * Dv, q0, BM, mk.Lq, Dv,
                 vv);
    if (n > 0) issue(0);
    cp_async_commit();
  }

  const int row = q0 + wg * 64 + warp * 16 + g8;
  const int wq0 = q0 + wg * 64;                    // this warpgroup's rows
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    lse_r[h] = r < mk.Lq ? lse[(long long)bh * mk.Lq + r] : 0.f;
    delta_r[h] = r < mk.Lq ? delta[(long long)bh * mk.Lq + r] : 0.f;
  }
  if constexpr (TMA) mbar_wait(qbar, 0);
  const int nd = (D + 15) >> 4, ndv = (Dv + 15) >> 4;
  float acc[N / 2];
  zero(acc);
  for (int i = 0; i < n; ++i) {
    const int it = t0 + i, st = i % S;
    if constexpr (TMA) {
      mbar_wait(&full[st], (i / S) & 1);
    } else {
      if (i + 1 < n) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
      fence_async_smem();
      __syncthreads();
    }
    const uint8_t* kt = sK + st * KB;
    const uint8_t* vt = sV + st * KB;

    float s[BN / 2], dp[BN / 2];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * C; ++kk)
      if (kk < nd) mma_ss(s, kdesc(sQ, BM, wg * 64, kk), kdesc(kt, BN, 0, kk),
                          kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4 * C; ++kk)
      if (kk < ndv)
        mma_ss(dp, kdesc(sO, BM, wg * 64, kk), kdesc(vt, BN, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool live =
        all_live(wq0, wq0 + 63, it * BN, it * BN + BN - 1, mk);
    scale_mask<BN / 8, false>(s, row, it * BN, t4, scale, live, mk);
    p_and_ds<BN / 8, false>(s, dp, row, it * BN, t4, lse_r, delta_r, nullptr,
                            nullptr, live, mk);
    uint32_t hi[BN / 16][4], lo[BN / 16][4];
    to_a2(hi, lo, dp);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      mma_rs(acc, hi[kk], ndesc(kt, BN, kk));
      mma_rs(acc, lo[kk], ndesc(kt, BN, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    if constexpr (TMA) {
      if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[st]);
      if (threadIdx.x == 0 && i >= 1 && i - 1 + S < n) {
        mbar_wait(&empty[(i - 1) % S], ((i - 1) / S) & 1);
        issue(i - 1 + S);
      }
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
  if constexpr (!TMA) cp_async_wait<0>();
  store_bf16<N / 8>(dqo + (long long)bh * mk.Lq * D, row, mk.Lq, D, t4, acc,
                    scale);
}

// ---- dk, dv: 128 keys a block, query tiles of 64 ---------------------------
namespace dkv {
constexpr int BK = 128, BQ = 64;
template <bool TMA>
constexpr int STAGES = TMA ? 3 : 2;
template <int C, bool TMA>
constexpr int smem_bytes() {
  return (2 * BK + 2 * STAGES<TMA> * BQ) * 128 * C +
         2 * STAGES<TMA> * BQ * 4 + 1024 + 64;
}
}  // namespace dkv

// per k tile of kv head bkv, summed over the q tiles and the group's heads:
// dv = sum_q p^T dout,  dk = scale sum_q ds^T q
template <int C, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dko,
               bf16* __restrict__ dvo, int group, int D, int Dv, Mask mk,
               float scale, int vq, int vv,
               const __grid_constant__ Maps maps) {
  using namespace dkv;
  constexpr int S = STAGES<TMA>;
  constexpr int N = 64 * C;
  constexpr int QB = BQ * 128 * C;
  extern __shared__ uint8_t raw[];
  uint8_t* sK = align1024(raw);
  uint8_t* sV = sK + BK * 128 * C;
  uint8_t* sQ = sV + BK * 128 * C;               // [S][QB]
  uint8_t* sO = sQ + S * QB;                     // [S][QB] dout
  float* sL = reinterpret_cast<float*>(sO + S * QB);  // [S][BQ] lse
  float* sD = sL + S * BQ;                       // [S][BQ] delta
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sD + S * BQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int bkv = blockIdx.x, k0 = blockIdx.y * BK;  // causal: longest first
  const int k1 = min(k0 + BK, mk.Lk) - 1;
  const int n_q = (mk.Lq + BQ - 1) / BQ;
  // the next q tile at or after qt that reaches this block's keys
  auto next_tile = [&](int qt) {
    for (; qt < n_q; ++qt)
      if (keys_needed(reach(qt * BQ, min(qt * BQ + BQ, mk.Lq) - 1, mk), k0,
                      k1))
        break;
    return qt;
  };
  // steps (qt, g) in order: query head bkv * group + g, rows qt BQ ..
  auto advance = [&](int& qt, int& g) {
    if (++g == group) {
      g = 0;
      qt = next_tile(qt + 1);
    }
  };
  // step (qt, g) into stage st: TMA by lane 0 of warp 0 and the row
  // statistics by its 32 lanes (warp 0 calls it); cp.async by all threads
  auto issue = [&](int qt, int g, int st) {
    const long long bh = (long long)bkv * group + g;
    const int q0 = qt * BQ;
    if constexpr (TMA) {
      if (lane == 0) {
        mbar_expect_tx(&full[st], 2 * QB);
        tma_rows<C>(sQ + st * QB, &maps.q, &full[st], q0, BQ, (int)bh);
        tma_rows<C>(sO + st * QB, &maps.o, &full[st], q0, BQ, (int)bh);
      }
      for (int j = lane; j < BQ; j += 32) {
        const bool in = q0 + j < mk.Lq;
        const long long at = bh * mk.Lq + (in ? q0 + j : 0);
        cp_async<4>(sL + st * BQ + j, lse + at, in ? 4 : 0);
        cp_async<4>(sD + st * BQ + j, delta + at, in ? 4 : 0);
      }
      cp_async_arrive(&full[st]);
    } else {
      load_rows<C>(sQ + st * QB, q + bh * mk.Lq * D, q0, BQ, mk.Lq, D, vq);
      load_rows<C>(sO + st * QB, dout + bh * mk.Lq * Dv, q0, BQ, mk.Lq, Dv,
                   vv);
      load_vec(sL + st * BQ, lse + bh * mk.Lq + q0, mk.Lq - q0, 0, BQ);
      load_vec(sD + st * BQ, delta + bh * mk.Lq + q0, mk.Lq - q0, 128, BQ);
    }
  };

  int qt = next_tile(0), g = 0;   // the step this thread multiplies
  int pq = qt, pg = 0;            // the next step to issue (TMA: warp 0)
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      mbar_init(kvbar, 1);
      for (int i = 0; i < S; ++i) {
        mbar_init(&full[i], 33);  // the TMA arrival and 32 lanes' copies
        mbar_init(&empty[i], 2);
      }
      fence_mbar_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * BK * 128 * C);
      tma_rows<C>(sK, &maps.k, kvbar, k0, BK, bkv);
      tma_rows<C>(sV, &maps.v, kvbar, k0, BK, bkv);
    }
    if (threadIdx.x < 32)
      for (int i = 0; i < S && pq < n_q; ++i) {
        issue(pq, pg, i);
        advance(pq, pg);
      }
    mbar_wait(kvbar, 0);
  } else {
    load_rows<C>(sK, k + (long long)bkv * mk.Lk * D, k0, BK, mk.Lk, D, vq);
    load_rows<C>(sV, v + (long long)bkv * mk.Lk * Dv, k0, BK, mk.Lk, Dv, vv);
    if (qt < n_q) issue(qt, 0, 0);
    cp_async_commit();
  }

  const int row = k0 + wg * 64 + warp * 16 + g8;  // this lane's key, h = 0
  const int wk0 = k0 + wg * 64;                    // this warpgroup's keys
  const int nd = (D + 15) >> 4, ndv = (Dv + 15) >> 4;
  float adk[N / 2], adv[N / 2];
  zero(adk);
  zero(adv);
  const float none[2] = {0.f, 0.f};
  for (int i = 0; qt < n_q; ++i) {
    const int st = i % S;
    if constexpr (TMA) {
      mbar_wait(&full[st], (i / S) & 1);
    } else {
      int nqt = qt, ng = g;
      advance(nqt, ng);
      if (nqt < n_q) issue(nqt, ng, (i + 1) % S);
      cp_async_commit();
      cp_async_wait<1>();
      fence_async_smem();
      __syncthreads();
    }
    const uint8_t* qtile = sQ + st * QB;
    const uint8_t* otile = sO + st * QB;

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
    float s[BQ / 2], dp[BQ / 2];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * C; ++kk)
      if (kk < nd)
        mma_ss(s, kdesc(sK, BK, wg * 64, kk), kdesc(qtile, BQ, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4 * C; ++kk)
      if (kk < ndv)
        mma_ss(dp, kdesc(sV, BK, wg * 64, kk), kdesc(otile, BQ, 0, kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool live =
        all_live(qt * BQ, qt * BQ + BQ - 1, wk0, wk0 + 63, mk);
    scale_mask<BQ / 8, true>(s, row, qt * BQ, t4, scale, live, mk);
    p_and_ds<BQ / 8, true>(s, dp, row, qt * BQ, t4, none, none, sL + st * BQ,
                           sD + st * BQ, live, mk);
    uint32_t pa[BQ / 16][4], hi[BQ / 16][4], lo[BQ / 16][4];
    to_a(pa, s);
    to_a2(hi, lo, dp);
    fence_regs(adv);
    fence_regs(adk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs(adv, pa[kk], ndesc(otile, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      mma_rs(adk, hi[kk], ndesc(qtile, BQ, kk));
      mma_rs(adk, lo[kk], ndesc(qtile, BQ, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(pa);
    fence_regs(hi);
    fence_regs(lo);
    if constexpr (TMA) {
      if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[st]);
      if (threadIdx.x < 32 && i >= 1 && pq < n_q) {
        mbar_wait(&empty[(i - 1) % S], ((i - 1) / S) & 1);
        issue(pq, pg, (i - 1) % S);
        advance(pq, pg);
      }
      __syncwarp();
    } else {
      __syncthreads();
    }
    advance(qt, g);
  }
  if constexpr (!TMA) cp_async_wait<0>();
  store_bf16<N / 8>(dko + (long long)bkv * mk.Lk * D, row, mk.Lk, D, t4, adk,
                    scale);
  store_bf16<N / 8>(dvo + (long long)bkv * mk.Lk * Dv, row, mk.Lk, Dv, t4,
                    adv, 1.f);
}

}  // namespace wg

// ===========================================================================
// f32 route: 3xTF32 on mma.sync
// ===========================================================================
namespace tc {

// rows [r0, r0 + R) of an (L, n) f32 matrix (row stride n, n % 4 == 0) into
// a tile with row stride ld, columns [0, w) (w = n rounded up to 8), zero
// past row L and past column n; THR threads
template <int THR>
__device__ __forceinline__ void load_rows(float* tile, int ld,
                                          const float* src, int r0, int R,
                                          int L, int n, int w) {
  const int per = w >> 2;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < R * per; i += THR) {
    const int r = i / per, col = (i - r * per) * 4;
    const bool live = r0 + r < L && col < n;
    cp_async<16>(tile + r * ld + col,
                 src + (live ? (long long)(r0 + r) * n + col : 0),
                 live ? 16 : 0);
  }
}

// x = hi + lo: hi rounded to tf32 (nearest, ties away; the conversion
// zeroes the 13 low bits), lo the exact f32 difference, which the tensor
// core truncates to tf32 as it reads it (it takes a tf32 operand's 19 high
// bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma8(float* d, const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a 16 x 8 A fragment (a0 row g col t, a1 row g + 8, a2 col t + 4, a3
// both) split into tf32 terms
struct A3 {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ A3(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// d (16 x 8) += A B in 3xTF32, B = (b0 at row t, b1 at row t + 4)
__device__ __forceinline__ void mma3(float* d, const A3& a, float b0,
                                     float b1) {
  uint32_t bh[2], bl[2];
  split(b0, bh[0], bl[0]);
  split(b1, bh[1], bl[1]);
  mma8(d, a.lo, bh);
  mma8(d, a.hi, bl);
  mma8(d, a.hi, bh);
}

// A fragment of contraction chunk j (8 columns) from an accumulator
// fragment f: A's column t is f's column 2 t and column t + 4 is 2 t + 1,
// so B's rows must be read as 2 t and 2 t + 1 (perm_b)
__device__ __forceinline__ A3 perm_a(const float* f, int j) {
  return A3(f[4 * j], f[4 * j + 2], f[4 * j + 1], f[4 * j + 3]);
}

// f (16 rows x 8 NC columns) += A B over the contraction [0, 8 nk): A rows
// a (this lane's row g; row g + 8 at a + 8 lda, times amul), B given by its
// rows: element (k, n) at b[n ldb + k] (B^T stored row-major: K-major).
// Each 32 of the contraction are summed in a fresh register tile and added
// to f with round-to-nearest f32 adds (see mma_pb).
template <int NC>
__device__ __forceinline__ void mma_kmajor(float (&f)[4 * NC],
                                           const float* a, int lda,
                                           float amul, const float* b,
                                           int ldb, float bmul, int nk,
                                           int t4, int g8) {
  for (int k0 = 0; k0 < nk; k0 += 4) {
    float tmp[4 * NC];
#pragma unroll
    for (int i = 0; i < 4 * NC; ++i) tmp[i] = 0.f;
#pragma unroll
    for (int kc = k0; kc < k0 + 4; ++kc) {
      if (kc >= nk) break;
      // the chunk's columns 2 t, 2 t + 1 as A's t, t + 4 (and B's rows
      // likewise): one 8-byte load each
      const float2 a0 =
          *reinterpret_cast<const float2*>(a + 8 * kc + 2 * t4);
      const float2 a1 =
          *reinterpret_cast<const float2*>(a + 8 * lda + 8 * kc + 2 * t4);
      const A3 A(a0.x * amul, a1.x * amul, a0.y * amul, a1.y * amul);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(
            b + (8 * j + g8) * ldb + 8 * kc + 2 * t4);
        mma3(&tmp[4 * j], A, bb.x * bmul, bb.y * bmul);
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * NC; ++i) f[i] += tmp[i];
  }
}

// acc (16 rows x 8 * 16 columns, the first nn tiles live) += P B, P the
// accumulator fragment p of KC chunks of 8 (the contraction), B rows
// k = 8 j + 2 t (+1) of a row-major tile b, element (k, n) at b[k ldb + n].
// The tensor core truncates its f32 sums, an error relative to the
// accumulator it adds into, at every mma: the tile's product is summed in a
// fresh register tile (one half of the columns at a time) and added to acc
// with round-to-nearest f32 adds, so the long reduction over the tiles
// does not accumulate that error.
template <int KC>
__device__ __forceinline__ void mma_pb(float (&acc)[64],
                                       const float (&p)[4 * KC],
                                       const float* b, int ldb, float bmul,
                                       int nn, int t4, int g8) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (8 * half >= nn) break;
    float tmp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) tmp[i] = 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const A3 A = perm_a(p, j);
      const float* br = b + (8 * j + 2 * t4) * ldb + 64 * half + g8;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        if (8 * half + nt < nn)
          mma3(&tmp[4 * nt], A, br[8 * nt] * bmul, br[ldb + 8 * nt] * bmul);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * half + i] += tmp[i];
  }
}

// rows row + 8 h, columns 8 c + 2 t + e of acc (f32) into dst (L, n), times
// mul; rows past L and columns past n dropped
__device__ __forceinline__ void store_f32(float* dst, int row, int L, int n,
                                          int t4, const float (&f)[64],
                                          float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= L) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = 8 * c + 2 * t4;
      if (col < n)
        *reinterpret_cast<float2*>(dst + (long long)r * n + col) =
            make_float2(f[4 * c + 2 * h] * mul, f[4 * c + 2 * h + 1] * mul);
    }
  }
}

__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) & ~7; }

// ---- forward: 128 query rows a block (8 warps), key tiles of 64 -----------
namespace fwd {
constexpr int NW = 8, THR = 32 * NW, BM = 16 * NW, BN = 64;
inline int smem_bytes(int D, int Dv) {
  const int ldq = pad8(D) + 4, ldv = pad8(Dv) + 4;
  return 4 * (BM * ldq + 2 * BN * (ldq + ldv));
}
}  // namespace fwd

__global__ void __launch_bounds__(fwd::THR)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int group, int D, int Dv, Mask mk,
               float scale) {
  using namespace fwd;
  const int wd = pad8(D), wv = pad8(Dv), ldq = wd + 4, ldv = wv + 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * ldq;       // [2][BN * ldq]
  float* sV = sK + 2 * BN * ldq;   // [2][BN * ldv]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, bkv = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest first
  const float* kh = k + (long long)bkv * mk.Lk * D;
  const float* vh = v + (long long)bkv * mk.Lk * Dv;
  int t0, t1;
  tile_range(q0, min(q0 + BM, mk.Lq) - 1, BN, mk, t0, t1);

  load_rows<THR>(sQ, ldq, q + (long long)bh * mk.Lq * D, q0, BM, mk.Lq, D,
                 wd);
  if (t0 <= t1) {
    load_rows<THR>(sK, ldq, kh, t0 * BN, BN, mk.Lk, D, wd);
    load_rows<THR>(sV, ldv, vh, t0 * BN, BN, mk.Lk, Dv, wv);
  }
  cp_async_commit();

  const int row = q0 + warp * 16 + g8;
  const int wr0 = q0 + warp * 16;                  // this warp's rows
  const float* qa = sQ + (warp * 16 + g8) * ldq;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[64];
  zero(acc);
  for (int it = t0; it <= t1; ++it) {
    const int st = (it - t0) & 1;
    if (it < t1) {
      load_rows<THR>(sK + (st ^ 1) * BN * ldq, ldq, kh, (it + 1) * BN, BN,
                     mk.Lk, D, wd);
      load_rows<THR>(sV + (st ^ 1) * BN * ldv, ldv, vh, (it + 1) * BN, BN,
                     mk.Lk, Dv, wv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[BN / 2];
    zero(s);
    mma_kmajor<BN / 8>(s, qa, ldq, scale, sK + st * BN * ldq, ldq, 1.f,
                       wd >> 3, t4, g8);
    scale_mask<BN / 8, false>(s, row, it * BN, t4, 1.f,
                              all_live(wr0, wr0 + 15, it * BN,
                                       it * BN + BN - 1, mk),
                              mk);
    softmax_step<BN / 8, 16>(s, acc, m, l);
    mma_pb<BN / 8>(acc, s, sV + st * BN * ldv, ldv, 1.f, wv >> 3, t4, g8);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lc = fmaxf(l[h], 1e-30f);
    const int r = row + 8 * h;
    if (t4 == 0 && r < mk.Lq)
      lse[(long long)bh * mk.Lq + r] =
          l[h] > 0.f ? m[h] + logf(lc) : CUDART_INF_F;
    // the reference divides by l
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      acc[4 * c + 2 * h] /= lc;
      acc[4 * c + 2 * h + 1] /= lc;
    }
  }
  store_f32(o + (long long)bh * mk.Lq * Dv, row, mk.Lq, Dv, t4, acc, 1.f);
}

// ---- dq: 128 query rows a block (8 warps), key tiles of 32 ----------------
namespace dq {
constexpr int NW = 8, THR = 32 * NW, BM = 16 * NW, BN = 32;
inline int smem_bytes(int D, int Dv) {
  const int ldq = pad8(D) + 4, ldv = pad8(Dv) + 4;
  return 4 * (BM * (ldq + ldv) + 2 * BN * (ldq + ldv));
}
}  // namespace dq

__global__ void __launch_bounds__(dq::THR)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dqo, int group, int D, int Dv, Mask mk,
              float scale) {
  using namespace dq;
  const int wd = pad8(D), wv = pad8(Dv), ldq = wd + 4, ldv = wv + 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = sQ + BM * ldq;       // dout
  float* sK = sO + BM * ldv;       // [2][BN * ldq]
  float* sV = sK + 2 * BN * ldq;   // [2][BN * ldv]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, bkv = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const float* kh = k + (long long)bkv * mk.Lk * D;
  const float* vh = v + (long long)bkv * mk.Lk * Dv;
  int t0, t1;
  tile_range(q0, min(q0 + BM, mk.Lq) - 1, BN, mk, t0, t1);

  load_rows<THR>(sQ, ldq, q + (long long)bh * mk.Lq * D, q0, BM, mk.Lq, D,
                 wd);
  load_rows<THR>(sO, ldv, dout + (long long)bh * mk.Lq * Dv, q0, BM, mk.Lq,
                 Dv, wv);
  if (t0 <= t1) {
    load_rows<THR>(sK, ldq, kh, t0 * BN, BN, mk.Lk, D, wd);
    load_rows<THR>(sV, ldv, vh, t0 * BN, BN, mk.Lk, Dv, wv);
  }
  cp_async_commit();

  const int row = q0 + warp * 16 + g8;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    lse_r[h] = r < mk.Lq ? lse[(long long)bh * mk.Lq + r] : 0.f;
    delta_r[h] = r < mk.Lq ? delta[(long long)bh * mk.Lq + r] : 0.f;
  }
  const int wr0 = q0 + warp * 16;                  // this warp's rows
  const float* qa = sQ + (warp * 16 + g8) * ldq;
  const float* oa = sO + (warp * 16 + g8) * ldv;
  float acc[64];
  zero(acc);
  for (int it = t0; it <= t1; ++it) {
    const int st = (it - t0) & 1;
    if (it < t1) {
      load_rows<THR>(sK + (st ^ 1) * BN * ldq, ldq, kh, (it + 1) * BN, BN,
                     mk.Lk, D, wd);
      load_rows<THR>(sV + (st ^ 1) * BN * ldv, ldv, vh, (it + 1) * BN, BN,
                     mk.Lk, Dv, wv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = sK + st * BN * ldq;
    float s[BN / 2], dp[BN / 2];
    zero(s);
    zero(dp);
    mma_kmajor<BN / 8>(s, qa, ldq, scale, kt, ldq, 1.f, wd >> 3, t4, g8);
    mma_kmajor<BN / 8>(dp, oa, ldv, 1.f, sV + st * BN * ldv, ldv, 1.f,
                       wv >> 3, t4, g8);
    const bool live =
        all_live(wr0, wr0 + 15, it * BN, it * BN + BN - 1, mk);
    scale_mask<BN / 8, false>(s, row, it * BN, t4, 1.f, live, mk);
    p_and_ds<BN / 8, false>(s, dp, row, it * BN, t4, lse_r, delta_r, nullptr,
                            nullptr, live, mk);
    mma_pb<BN / 8>(acc, dp, kt, ldq, 1.f, wd >> 3, t4, g8);
    __syncthreads();
  }
  cp_async_wait<0>();
  store_f32(dqo + (long long)bh * mk.Lq * D, row, mk.Lq, D, t4, acc, scale);
}

// ---- dk, dv: 128 keys a block (8 warps), query tiles of 32 ----------------
namespace dkv {
constexpr int NW = 8, THR = 32 * NW, BK = 16 * NW, BQ = 32;
inline int smem_bytes(int D, int Dv) {
  const int ldq = pad8(D) + 4, ldv = pad8(Dv) + 4;
  return 4 * (BK * (ldq + ldv) + 2 * BQ * (ldq + ldv) + 4 * BQ);
}
}  // namespace dkv

__global__ void __launch_bounds__(dkv::THR)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dko,
               float* __restrict__ dvo, int group, int D, int Dv, Mask mk,
               float scale) {
  using namespace dkv;
  const int wd = pad8(D), wv = pad8(Dv), ldq = wd + 4, ldv = wv + 4;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BK * ldq;
  float* sQ = sV + BK * ldv;       // [2][BQ * ldq]
  float* sO = sQ + 2 * BQ * ldq;   // [2][BQ * ldv] dout
  float* sL = sO + 2 * BQ * ldv;   // [2][BQ] lse
  float* sD = sL + 2 * BQ;         // [2][BQ] delta
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int bkv = blockIdx.x, k0 = blockIdx.y * BK;  // causal: longest first
  const int k1 = min(k0 + BK, mk.Lk) - 1;
  const int n_q = (mk.Lq + BQ - 1) / BQ;
  auto next_tile = [&](int qt) {
    for (; qt < n_q; ++qt)
      if (keys_needed(reach(qt * BQ, min(qt * BQ + BQ, mk.Lq) - 1, mk), k0,
                      k1))
        break;
    return qt;
  };
  auto load_step = [&](int qt, int g, int st) {
    const long long bh = (long long)bkv * group + g;
    const int q0 = qt * BQ;
    load_rows<THR>(sQ + st * BQ * ldq, ldq, q + bh * mk.Lq * D, q0, BQ,
                   mk.Lq, D, wd);
    load_rows<THR>(sO + st * BQ * ldv, ldv, dout + bh * mk.Lq * Dv, q0, BQ,
                   mk.Lq, Dv, wv);
    load_vec(sL + st * BQ, lse + bh * mk.Lq + q0, mk.Lq - q0, 0, BQ);
    load_vec(sD + st * BQ, delta + bh * mk.Lq + q0, mk.Lq - q0, 128, BQ);
  };

  load_rows<THR>(sK, ldq, k + (long long)bkv * mk.Lk * D, k0, BK, mk.Lk, D,
                 wd);
  load_rows<THR>(sV, ldv, v + (long long)bkv * mk.Lk * Dv, k0, BK, mk.Lk,
                 Dv, wv);
  int qt = next_tile(0), g = 0;
  if (qt < n_q) load_step(qt, 0, 0);
  cp_async_commit();

  const int row = k0 + warp * 16 + g8;  // this lane's key, h = 0
  const int wk0 = k0 + warp * 16;       // this warp's keys
  const float* ka = sK + (warp * 16 + g8) * ldq;
  const float* va = sV + (warp * 16 + g8) * ldv;
  float adk[64], adv[64];
  zero(adk);
  zero(adv);
  const float none[2] = {0.f, 0.f};
  for (int st = 0; qt < n_q; st ^= 1) {
    int nqt = qt, ng = g + 1;
    if (ng == group) nqt = next_tile(qt + 1), ng = 0;
    if (nqt < n_q) load_step(nqt, ng, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qtile = sQ + st * BQ * ldq;
    const float* otile = sO + st * BQ * ldv;
    // S^T = K (scale Q)^T, dP^T = V dO^T: rows keys, columns queries
    float s[BQ / 2], dp[BQ / 2];
    zero(s);
    zero(dp);
    mma_kmajor<BQ / 8>(s, ka, ldq, 1.f, qtile, ldq, scale, wd >> 3, t4, g8);
    mma_kmajor<BQ / 8>(dp, va, ldv, 1.f, otile, ldv, 1.f, wv >> 3, t4, g8);
    const bool live =
        all_live(qt * BQ, qt * BQ + BQ - 1, wk0, wk0 + 15, mk);
    scale_mask<BQ / 8, true>(s, row, qt * BQ, t4, 1.f, live, mk);
    p_and_ds<BQ / 8, true>(s, dp, row, qt * BQ, t4, none, none,
                           sL + st * BQ, sD + st * BQ, live, mk);
    mma_pb<BQ / 8>(adv, s, otile, ldv, 1.f, wv >> 3, t4, g8);
    mma_pb<BQ / 8>(adk, dp, qtile, ldq, scale, wd >> 3, t4, g8);
    __syncthreads();
    qt = nqt;
    g = ng;
  }
  cp_async_wait<0>();
  store_f32(dko + (long long)bkv * mk.Lk * D, row, mk.Lk, D, t4, adk, 1.f);
  store_f32(dvo + (long long)bkv * mk.Lk * Dv, row, mk.Lk, Dv, t4, adv, 1.f);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kern, typename... Args>
int launch(Kern kernel, dim3 grid, int threads, int smem, cudaStream_t st,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

int check_dims(int BH, int group, int D, int Dv) {
  if (BH <= 0 || group <= 0 || BH % group || D <= 0 || Dv <= 0 ||
      D > 128 || Dv > 128 || D % 4 || Dv % 4)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// tiles of `rows` over L, within the grid's y limit
int tiles(int L, int rows, unsigned int& n) {
  n = (unsigned int)((L + rows - 1) / rows);
  return n > 65535u ? (int)cudaErrorInvalidValue : 0;
}

Mask make_mask(int Lq, int Lk, int lk, int causal, int has_window,
               int window, int q_offset) {
  return Mask{Lq, Lk, lk, causal, has_window, window, q_offset};
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// map of a bf16 (heads, L, n) tensor as (n, L, heads), boxes of 64 columns
// by `rows` rows, 128-byte swizzle, zero fill past the edges
int encode(CUtensorMap* map, const void* ptr, int n, int L, int heads,
           int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)L, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 2, (cuuint64_t)L * n * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The bf16 kernels load by TMA where every row stride is 16-byte aligned
// (head dims multiples of 8) and both lengths are positive; by cp.async
// otherwise.  Boxes: q / dout rows qrows, k / v rows krows.
bool tma_shape(int Lq, int Lk, int D, int Dv) {
  return D % 8 == 0 && Dv % 8 == 0 && Lq > 0 && Lk > 0;
}

int make_maps(wg::Maps& m, const void* q, const void* k, const void* v,
              const void* dout, int BH, int BKV, int Lq, int Lk, int D,
              int Dv, int qrows, int krows) {
  if (int e = encode(&m.q, q, D, Lq, BH, qrows)) return e;
  if (int e = encode(&m.k, k, D, Lk, BKV, krows)) return e;
  if (int e = encode(&m.v, v, Dv, Lk, BKV, krows)) return e;
  if (dout != nullptr)
    if (int e = encode(&m.o, dout, Dv, Lq, BH, qrows)) return e;
  return 0;
}

// the bf16 kernel K<C, TMA> with its shared memory, for the padded width
template <template <int, bool> class Kern>
struct Pick {
  template <typename... Args>
  static int run(bool wide, bool tma, dim3 grid, cudaStream_t st,
                 Args... args) {
    if (wide)
      return tma ? launch(Kern<2, true>::fn(), grid, wg::THREADS,
                          Kern<2, true>::smem(), st, args...)
                 : launch(Kern<2, false>::fn(), grid, wg::THREADS,
                          Kern<2, false>::smem(), st, args...);
    return tma ? launch(Kern<1, true>::fn(), grid, wg::THREADS,
                        Kern<1, true>::smem(), st, args...)
               : launch(Kern<1, false>::fn(), grid, wg::THREADS,
                        Kern<1, false>::smem(), st, args...);
  }
};

template <int C, bool TMA>
struct FwdK {
  static auto fn() { return wg::fwd_kernel<C, TMA>; }
  static int smem() { return wg::fwd::smem_bytes<C, TMA>(); }
};
template <int C, bool TMA>
struct DqK {
  static auto fn() { return wg::dq_kernel<C, TMA>; }
  static int smem() { return wg::dq::smem_bytes<C, TMA>(); }
};
template <int C, bool TMA>
struct DkvK {
  static auto fn() { return wg::dkv_kernel<C, TMA>; }
  static int smem() { return wg::dkv::smem_bytes<C, TMA>(); }
};

}  // namespace

// dtype: 0 = float32 (3xTF32 route), 1 = bfloat16 (wgmma route); q, k, v,
// o share it.  q (BH, Lq, D), k (BH / group, Lk, D), v (BH / group, Lk, Dv),
// o (BH, Lq, Dv), lse (BH, Lq) f32; all contiguous, 16-byte aligned.  D and
// Dv: multiples of 4, at most 128.
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
  unsigned int n;
  if (dtype == 1) {
    if (int e = tiles(Lq, wg::fwd::BM, n)) return e;
    const bool tma = tma_shape(Lq, Lk, D, Dv);
    wg::Maps maps{};
    if (tma)
      if (int e = make_maps(maps, q, k, v, nullptr, BH, BH / group, Lq, Lk, D,
                            Dv, wg::fwd::BM, wg::fwd::BN))
        return e;
    return Pick<FwdK>::run(D > 64 || Dv > 64, tma, dim3(BH, n), st,
                           static_cast<const bf16*>(q),
                           static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(o),
                           static_cast<float*>(lse), group, D, Dv, mk, scale,
                           (int)(D % 8 == 0), (int)(Dv % 8 == 0), maps);
  }
  if (int e = tiles(Lq, tc::fwd::BM, n)) return e;
  return launch(tc::fwd_kernel, dim3(BH, n), tc::fwd::THR,
                tc::fwd::smem_bytes(D, Dv), st, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(o), static_cast<float*>(lse), group, D,
                Dv, mk, scale);
}

// The backward's two kernels, launched in order on one stream: dq
// (which = 0), then dk / dv (which = 1).  dout as q; delta (BH, Lq) f32;
// dq, dk, dv as q, k, v.
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
  const float* fl = static_cast<const float*>(lse);
  const float* fd = static_cast<const float*>(delta);
  const int BKV = BH / group;
  unsigned int n;
  if (dtype == 1) {
    const bf16 *bq = static_cast<const bf16*>(q),
               *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v),
               *bo = static_cast<const bf16*>(dout);
    const int vq = D % 8 == 0, vv = Dv % 8 == 0;
    const bool wide = D > 64 || Dv > 64, tma = tma_shape(Lq, Lk, D, Dv);
    wg::Maps maps{};
    if (which == 0) {
      if (Lq <= 0) return 0;
      if (int e = tiles(Lq, wg::dq::BM, n)) return e;
      if (tma)
        if (int e = make_maps(maps, q, k, v, dout, BH, BKV, Lq, Lk, D, Dv,
                              wg::dq::BM, wg::dq::BN))
          return e;
      return Pick<DqK>::run(wide, tma, dim3(BH, n), st, bq, bk, bv, bo, fl,
                            fd, static_cast<bf16*>(dq), group, D, Dv, mk,
                            scale, vq, vv, maps);
    }
    if (Lk <= 0) return 0;
    if (int e = tiles(Lk, wg::dkv::BK, n)) return e;
    if (tma)
      if (int e = make_maps(maps, q, k, v, dout, BH, BKV, Lq, Lk, D, Dv,
                            wg::dkv::BQ, wg::dkv::BK))
        return e;
    return Pick<DkvK>::run(wide, tma, dim3(BKV, n), st, bq, bk, bv, bo, fl,
                           fd, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                           group, D, Dv, mk, scale, vq, vv, maps);
  }
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fo = static_cast<const float*>(dout);
  if (which == 0) {
    if (Lq <= 0) return 0;
    if (int e = tiles(Lq, tc::dq::BM, n)) return e;
    return launch(tc::dq_kernel, dim3(BH, n), tc::dq::THR,
                  tc::dq::smem_bytes(D, Dv), st, fq, fk, fv, fo, fl, fd,
                  static_cast<float*>(dq), group, D, Dv, mk, scale);
  }
  if (Lk <= 0) return 0;
  if (int e = tiles(Lk, tc::dkv::BK, n)) return e;
  return launch(tc::dkv_kernel, dim3(BKV, n), tc::dkv::THR,
                tc::dkv::smem_bytes(D, Dv), st, fq, fk, fv, fo, fl, fd,
                static_cast<float*>(dk), static_cast<float*>(dv), group, D,
                Dv, mk, scale);
}

// The launch resources of one kernel: which = 0 forward, 1 dq, 2 dk / dv,
// for dtype and head dims as above.  out: registers a thread, dynamic
// shared memory a block (bytes), threads a block, and spilled local memory
// a thread (bytes).
extern "C" int flash_attention_resources(int dtype, int D, int Dv, int which,
                                         int* out) {
  if (int e = check_dims(1, 1, D, Dv)) return e;
  cudaFuncAttributes a;
  cudaError_t e;
  if (dtype == 1) {
    // the TMA kernels (head dims multiples of 8; cp.async otherwise)
    const bool wide = D > 64 || Dv > 64, tma = D % 8 == 0 && Dv % 8 == 0;
    out[2] = wg::THREADS;
    auto get = [&](auto k2t, auto k2c, auto k1t, auto k1c, int s2t, int s2c,
                   int s1t, int s1c) {
      out[1] = wide ? (tma ? s2t : s2c) : (tma ? s1t : s1c);
      return cudaFuncGetAttributes(
          &a, wide ? (tma ? k2t : k2c) : (tma ? k1t : k1c));
    };
    if (which == 0)
      e = get(FwdK<2, true>::fn(), FwdK<2, false>::fn(), FwdK<1, true>::fn(),
              FwdK<1, false>::fn(), FwdK<2, true>::smem(),
              FwdK<2, false>::smem(), FwdK<1, true>::smem(),
              FwdK<1, false>::smem());
    else if (which == 1)
      e = get(DqK<2, true>::fn(), DqK<2, false>::fn(), DqK<1, true>::fn(),
              DqK<1, false>::fn(), DqK<2, true>::smem(),
              DqK<2, false>::smem(), DqK<1, true>::smem(),
              DqK<1, false>::smem());
    else
      e = get(DkvK<2, true>::fn(), DkvK<2, false>::fn(), DkvK<1, true>::fn(),
              DkvK<1, false>::fn(), DkvK<2, true>::smem(),
              DkvK<2, false>::smem(), DkvK<1, true>::smem(),
              DkvK<1, false>::smem());
  } else if (which == 0) {
    e = cudaFuncGetAttributes(&a, tc::fwd_kernel);
    out[1] = tc::fwd::smem_bytes(D, Dv);
    out[2] = tc::fwd::THR;
  } else if (which == 1) {
    e = cudaFuncGetAttributes(&a, tc::dq_kernel);
    out[1] = tc::dq::smem_bytes(D, Dv);
    out[2] = tc::dq::THR;
  } else {
    e = cudaFuncGetAttributes(&a, tc::dkv_kernel);
    out[1] = tc::dkv::smem_bytes(D, Dv);
    out[2] = tc::dkv::THR;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return 0;
}
