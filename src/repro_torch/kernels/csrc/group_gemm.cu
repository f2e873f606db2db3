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
// Hopper blocks run in parallel and in no order, so each block loops over g
// and n itself and keeps its sums on chip: the group sum costs no extra
// pass over device memory, the reference kernel's point.
//
// Layout.  A is a stack (Ka, *batch, m, n) and B a stack (Kb, *batch, n, p)
// read in place, pair g taking slices ia[g] / ib[g].  Both are K-major: A
// rows hold n contiguous contraction bytes, and B is STORED (Kb, *batch,
// p, n), so each output column's n bytes are contiguous (the axis=1 split
// writes it so).  Int8 wgmma and mma take both operands K-major, and the
// decode route streams each column as one contiguous run.  Strides come
// from the caller; nothing is copied.
//
// Sign-magnitude digits (the ozimmu_sm_* family) are read as STORED: slice
// 0 signed, slices 1..k-1 magnitudes in [0, 2^beta - 1] stored mod 2^8.
// Bit g of ua / ub says that pair g's A / B slice holds unsigned bytes, and
// each pair runs in the instruction form of its signedness (wgmma
// .s8/.u8 per operand; dp4a .s32/.u32 per operand).  No widened copy exists.
//
// Two routes, chosen by the wrapper (kernels/group_gemm.py:route):
//
// * large (DGEMM shapes, m above the crossover; bound: operations against
//   the 1979 TOP/s of the int8 tensor cores).  128 x 256 output tiles;
//   two consumer warpgroups run wgmma.mma_async m64n256k32 with
//   s32 accumulators in registers, one producer thread keeps TMA loads
//   (cp.async.bulk.tensor, 128-byte swizzle, zero fill past the edges) in
//   flight through a ring of 4 shared-memory stages guarded by mbarriers.
//   One 4-D tensor map per digit stack, (n, rows, batch, slice): moving to
//   pair g changes only the slice coordinate, so the pair loop is part of
//   the contraction loop and the C tile stays in registers over all of it.
//   Needs 16-byte aligned bases and strides (TMA); other shapes take the
//   skinny route.
// * skinny (decode shapes, m <= 8 by the wrapper's measured crossover;
//   bound: bytes, every B byte of the group is read once).  Eight lanes
//   share an output column, each lane streaming
//   16-byte pieces of the column's contraction run with cp.async through a
//   4-stage ring of its own (a lane reads back only what it copied, so the
//   ring needs no barrier).  A's m rows for the current chunk of n sit in
//   registers, loaded once per (pair, chunk), and dp4a computes only the
//   real rows (8 operations per B byte at m = 4, far inside what dp4a
//   supplies per byte of bandwidth).  Each column's sums meet in shared
//   memory; when the p tiles alone give too few blocks for the card, the
//   (pair, chunk) units are split over blocks and the int32 partials are
//   combined with atomicAdd into a zeroed output: integer addition is
//   associative, so the result is bitwise the same in any order.  Rows
//   above 16 run in further row tiles, and unaligned shapes load bytewise.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#define MAX_G 32

namespace {

struct Pairs {
  int ia[MAX_G];
  int ib[MAX_G];
  unsigned int ua, ub;  // bit g: pair g's A / B slice holds unsigned bytes
  int G;
};

__device__ __forceinline__ int form_of(const Pairs& P, int g) {
  return (int)((P.ua >> g) & 1u) | (int)(((P.ub >> g) & 1u) << 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// large route: TMA + wgmma
// ---------------------------------------------------------------------------
namespace large {

// 128 x 256 output tiles (each A tile feeds twice the columns of a
// 128 x 128 tile), 128 contraction bytes per stage (one 128-byte swizzle
// row)
constexpr int BM = 128, BN = 256, BK = 128, STAGES = 4, THREADS = 384;

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
// fault of the kernel; it traps (a launch error) instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long long polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls > (1LL << 26)) __trap();
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO),
// layout type 1 (SWIZZLE_128B).  A k32 step within the row adds 32 bytes to
// the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define GG_D8(i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),        \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define GG_D64(i)                                                     \
  GG_D8(i), GG_D8(i + 8), GG_D8(i + 16), GG_D8(i + 24), GG_D8(i + 32), \
      GG_D8(i + 40), GG_D8(i + 48), GG_D8(i + 56)

#define GG_R128                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// one wgmma m64n256k32 (s32 += A 64x32 @ B 32x256) in the form (AT, BT)
#define GG_MMA256(AT, BT)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n256k32.s32." AT "." BT    \
               " " GG_R128 ", %128, %129, p;\n}\n"                         \
               : GG_D64(0), GG_D64(64)                                     \
               : "l"(da), "l"(db), "r"(1))

template <int FORM>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (FORM == 0) GG_MMA256("s8", "s8");
  if constexpr (FORM == 1) GG_MMA256("u8", "s8");
  if constexpr (FORM == 2) GG_MMA256("s8", "u8");
  if constexpr (FORM == 3) GG_MMA256("u8", "u8");
}

// the four k32 steps of one 128-byte stage
template <int FORM>
__device__ __forceinline__ void mma_stage(int (&d)[BN / 2], uint64_t da,
                                          uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk)
    mma<FORM>(d, da + (uint64_t)(kk * 32 >> 4),
              db + (uint64_t)(kk * 32 >> 4));
}

// the ring, its barriers, and room to align the ring to 1024 bytes
constexpr int SMEM_BYTES = STAGES * (BM + BN) * BK + 2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(THREADS, 1)
    kernel(const __grid_constant__ CUtensorMap tma,
           const __grid_constant__ CUtensorMap tmb, int32_t* __restrict__ C,
           int m, int n, int p, Pairs P) {
  extern __shared__ uint8_t raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = base;                                // [STAGES][BM][BK]
  uint8_t* sb = base + STAGES * BM * BK;             // [STAGES][BN][BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * BN * BK);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int bz = blockIdx.z;
  const int KT = (n + BK - 1) / BK;
  const int T = P.G * KT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread keeps the ring full
    if (t == 0) {
      for (int it = 0; it < T; ++it) {
        const int s = it % STAGES, use = it / STAGES;
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        mbar_expect_tx(&full[s], (BM + BN) * BK);
        const int g = it / KT, k0 = (it % KT) * BK;
        tma_load(sa + s * BM * BK, &tma, &full[s], k0, row0, bz, P.ia[g]);
        tma_load(sb + s * BN * BK, &tmb, &full[s], k0, col0, bz, P.ib[g]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the tile
  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;
  fence_regs(d);
  for (int it = 0; it < T; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint64_t da = sw128_desc(sa + s * BM * BK + wg * 64 * BK);
    const uint64_t db = sw128_desc(sb + s * BN * BK);
    wgmma_fence();
    switch (form_of(P, it / KT)) {
      case 0: mma_stage<0>(d, da, db); break;
      case 1: mma_stage<1>(d, da, db); break;
      case 2: mma_stage<2>(d, da, db); break;
      default: mma_stage<3>(d, da, db); break;
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (it > 0 && t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(d);

  // accumulator fragment: register 4c + 2h + e holds row
  // 16 warp + lane/4 + 8h, column 8c + 2 (lane%4) + e of the warpgroup tile
  int32_t* Cb = C + (long long)bz * m * p;
  const int warp = t / 32, lane = t % 32;
  const bool even = (p % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (r >= m) continue;
    int32_t* crow = Cb + (long long)r * p;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int col = col0 + 8 * c + 2 * (lane % 4);
      const int v0 = d[4 * c + 2 * h], v1 = d[4 * c + 2 * h + 1];
      if (even && col + 1 < p) {
        *reinterpret_cast<int2*>(crow + col) = make_int2(v0, v1);
      } else {
        if (col < p) crow[col] = v0;
        if (col + 1 < p) crow[col + 1] = v1;
      }
    }
  }
}

}  // namespace large

// ---------------------------------------------------------------------------
// skinny route: cp.async streaming + dp4a
// ---------------------------------------------------------------------------
namespace skinny {

constexpr int WARPS = 8, THREADS = 32 * WARPS, STAGES = 4;
constexpr int COLS = 4 * WARPS;  // columns per block iteration (8 lanes each)

// MT rows per tile; S 16-byte pieces per lane per column and chunk; the
// chunk of n one unit covers is KC = 8 lanes x 16 bytes x S
template <int MT>
struct Cfg {
  static constexpr int S = MT <= 4 ? 4 : 16 / MT;
  static constexpr int KC = 128 * S;
};

struct Args {
  const int8_t* a;
  const int8_t* b;
  int32_t* c;
  long long lda, a_bs, a_ss, ldb, b_bs, b_ss;
  int m, n, p;
  int pt;      // columns per block (a multiple of COLS)
  int nc;      // chunks of n
  int ups;     // (pair, chunk) units per split
  int splits;  // splits of the units over blocks
  int atomic;  // partials combined with atomicAdd (splits > 1)
};

template <bool UA, bool UB>
__device__ __forceinline__ int dp4a(int a, int b, int c) {
  int d;
  if (!UA && !UB)
    asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else if (!UA && UB)
    asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else if (UA && !UB)
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else
    asm("dp4a.u32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 16 bytes at src, zero past `valid` (0..16) bytes; ALIGNED: src is 16-byte
// aligned and valid is 0 or 16
template <bool ALIGNED>
__device__ __forceinline__ uint4 load16(const int8_t* src, int valid) {
  if (ALIGNED) {
    return valid > 0 ? __ldg(reinterpret_cast<const uint4*>(src))
                     : make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0, 0, 0, 0};
  for (int i = 0; i < valid; ++i)
    w[i / 4] |= (uint32_t)(uint8_t)src[i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int MT, int S, bool UA, bool UB>
__device__ __forceinline__ void mac(int (&acc)[MT], const uint4 (&af)[S][MT],
                                    const uint4 (&bf)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      acc[r] = dp4a<UA, UB>((int)af[s][r].x, (int)bf[s].x, acc[r]);
      acc[r] = dp4a<UA, UB>((int)af[s][r].y, (int)bf[s].y, acc[r]);
      acc[r] = dp4a<UA, UB>((int)af[s][r].z, (int)bf[s].z, acc[r]);
      acc[r] = dp4a<UA, UB>((int)af[s][r].w, (int)bf[s].w, acc[r]);
    }
}

template <int MT>
__host__ __device__ constexpr int ring_bytes() {
  return WARPS * STAGES * 4 * Cfg<MT>::KC;
}

template <int MT, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    kernel(const Args P, const Pairs pr) {
  constexpr int S = Cfg<MT>::S, KC = Cfg<MT>::KC;
  extern __shared__ __align__(16) uint8_t sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane / 8, j = lane % 8;  // column of the warp's 4, lane in it
  uint8_t* ring = sm + warp * (STAGES * 4 * KC);
  int32_t* sacc = reinterpret_cast<int32_t*>(sm + ring_bytes<MT>());  // [MT][pt]

  const int split = blockIdx.y % P.splits, rt = blockIdx.y / P.splits;
  const int row0 = rt * MT, col0 = blockIdx.x * P.pt;
  const long long bz = blockIdx.z;
  const int units = pr.G * P.nc;
  const int u0 = split * P.ups;
  const int u1 = min(units, u0 + P.ups);
  const int cit = P.pt / COLS;
  const int iters = max(0, u1 - u0) * cit;

  for (int i = threadIdx.x; i < MT * P.pt; i += THREADS) sacc[i] = 0;
  __syncthreads();

  // B pieces of iteration `it` into ring stage it % STAGES; a lane copies
  // exactly the pieces it reads back later
  auto issue = [&](int it) {
    if (it < iters) {
      const int u = u0 + it / cit, ci = it % cit;
      const int g = u / P.nc, k0 = (u % P.nc) * KC;
      const int col = col0 + ci * COLS + warp * 4 + q;
      const bool live = col < P.p;
      const int8_t* src = P.b + pr.ib[g] * P.b_ss + bz * P.b_bs +
                          (long long)(live ? col : 0) * P.ldb;
      uint8_t* dst = ring + ((it % STAGES) * 4 + q) * KC + j * 16;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int k = k0 + s * 128 + j * 16;
        const int valid = live ? max(0, min(16, P.n - k)) : 0;
        if (ALIGNED) {
          cp_async16(dst + s * 128, valid > 0 ? src + k : P.b, valid);
        } else {
          *reinterpret_cast<uint4*>(dst + s * 128) =
              load16<false>(src + k, valid);
        }
      }
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
  };

  uint4 af[S][MT];
  auto load_a = [&](int u) {
    const int g = u / P.nc, k0 = (u % P.nc) * KC;
    const int8_t* base = P.a + pr.ia[g] * P.a_ss + bz * P.a_bs;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s * 128 + j * 16;
      const int valid = max(0, min(16, P.n - k));
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const int row = row0 + r;
        af[s][r] = load16<ALIGNED>(base + (long long)row * P.lda + k,
                                   row < P.m ? valid : 0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  int form = 0;
  for (int it = 0; it < iters; ++it) {
    issue(it + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    const int u = u0 + it / cit, ci = it % cit;
    if (ci == 0) {
      load_a(u);
      form = form_of(pr, u / P.nc);
    }
    const uint8_t* src = ring + ((it % STAGES) * 4 + q) * KC + j * 16;
    uint4 bf[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      bf[s] = *reinterpret_cast<const uint4*>(src + s * 128);
    int acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] = 0;
    switch (form) {
      case 0: mac<MT, S, false, false>(acc, af, bf); break;
      case 1: mac<MT, S, true, false>(acc, af, bf); break;
      case 2: mac<MT, S, false, true>(acc, af, bf); break;
      default: mac<MT, S, true, true>(acc, af, bf); break;
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 4);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    }
    // the column (ci, warp, q) belongs to this lane group alone
    const int lc = ci * COLS + warp * 4 + q;
    if (j == 0) {
#pragma unroll
      for (int r = 0; r < MT; ++r) sacc[r * P.pt + lc] += acc[r];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  int32_t* Cb = P.c + bz * (long long)P.m * P.p;
  for (int i = threadIdx.x; i < MT * P.pt; i += THREADS) {
    const int r = i / P.pt, lc = i % P.pt;
    const int row = row0 + r, col = col0 + lc;
    if (row < P.m && col < P.p) {
      int32_t* dst = Cb + (long long)row * P.p + col;
      if (P.atomic)
        atomicAdd(dst, sacc[i]);
      else
        *dst = sacc[i];
    }
  }
}

template <int MT, bool ALIGNED>
int launch(const Args& P, const Pairs& pr, dim3 grid, cudaStream_t st) {
  // the largest ring plus the largest column tile, set once per form
  constexpr int most = ring_bytes<MT>() + MT * 128 * 4;
  static cudaError_t set = cudaFuncSetAttribute(
      kernel<MT, ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (set != cudaSuccess) return (int)set;
  const int bytes = ring_bytes<MT>() + MT * P.pt * 4;
  kernel<MT, ALIGNED><<<grid, THREADS, bytes, st>>>(P, pr);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_mt(const Args& P, const Pairs& pr, dim3 grid, bool aligned,
              cudaStream_t st) {
  return aligned ? launch<MT, true>(P, pr, grid, st)
                 : launch<MT, false>(P, pr, grid, st);
}

}  // namespace skinny

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

int fill_pairs(Pairs& pr, int G, const int* ia, const int* ib,
               unsigned int ua, unsigned int ub) {
  if (G <= 0 || G > MAX_G) return (int)cudaErrorInvalidValue;
  for (int g = 0; g < MAX_G; ++g) {
    pr.ia[g] = g < G ? ia[g] : 0;
    pr.ib[g] = g < G ? ib[g] : 0;
  }
  pr.ua = ua;
  pr.ub = ub;
  pr.G = G;
  return 0;
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
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// 4-D map (n, rows, batch, slice) of an int8 digit stack, K-major rows;
// strides in bytes (multiples of 16), box BK x box_rows
int encode(CUtensorMap* map, const void* ptr, int n, int rows, int B, int K,
           long long ld, long long bs, long long ss, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)n, (cuuint64_t)rows, (cuuint64_t)B,
                              (cuuint64_t)K};
  const cuuint64_t strides[3] = {(cuuint64_t)ld, (cuuint64_t)bs,
                                 (cuuint64_t)ss};
  const cuuint32_t box[4] = {(cuuint32_t)large::BK, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                  const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// Strides are in elements (= bytes) of the int8 stacks: ld* between rows of
// a slice (A: rows of m, B: rows of p, each holding n contraction bytes),
// *_bs between batch elements, *_ss between slices.  ia/ib: G slice
// indices; bit g of ua/ub: pair g's slice is unsigned.  c: (B, m, p) int32.

// large route.  The wrapper checks the TMA alignment.
extern "C" int group_gemm_large(const void* a, const void* b, void* c, int B,
                                int m, int n, int p, int Ka, int Kb,
                                long long lda, long long a_bs, long long a_ss,
                                long long ldb, long long b_bs, long long b_ss,
                                int G, const int* ia, const int* ib,
                                unsigned int ua, unsigned int ub,
                                void* stream) {
  Pairs pr;
  int err = fill_pairs(pr, G, ia, ib, ua, ub);
  if (err) return err;
  if (B <= 0 || m <= 0 || p <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  // size-1 dimensions: any 16-byte multiple stands in for their stride
  if (B == 1) a_bs = (long long)m * lda, b_bs = (long long)p * ldb;
  if (Ka == 1) a_ss = (long long)B * a_bs;
  if (Kb == 1) b_ss = (long long)B * b_bs;
  CUtensorMap ta, tb;
  err = encode(&ta, a, n, m, B, Ka, lda, a_bs, a_ss, large::BM);
  if (err) return err;
  err = encode(&tb, b, n, p, B, Kb, ldb, b_bs, b_ss, large::BN);
  if (err) return err;
  static cudaError_t set = cudaFuncSetAttribute(
      large::kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      large::SMEM_BYTES);
  if (set != cudaSuccess) return (int)set;
  dim3 grid((p + large::BN - 1) / large::BN, (m + large::BM - 1) / large::BM,
            B);
  large::kernel<<<grid, large::THREADS, large::SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<int32_t*>(c), m, n, p, pr);
  return (int)cudaGetLastError();
}

// skinny route; any shape and stride (16-byte aligned ones stream through
// cp.async, others load bytewise).
extern "C" int group_gemm_skinny(const void* a, const void* b, void* c, int B,
                                 int m, int n, int p, long long lda,
                                 long long a_bs, long long a_ss,
                                 long long ldb, long long b_bs,
                                 long long b_ss, int G, const int* ia,
                                 const int* ib, unsigned int ua,
                                 unsigned int ub, void* stream) {
  Pairs pr;
  int err = fill_pairs(pr, G, ia, ib, ua, ub);
  if (err) return err;
  if (B <= 0 || m <= 0 || p <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const int mt = m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : m <= 8 ? 8 : 16;
  const int kc = 128 * (mt <= 4 ? 4 : 16 / mt);
  const auto al = [](long long v) { return v % 16 == 0; };
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       n % 16 == 0 && al(lda) && al(a_bs) && al(a_ss) &&
                       al(ldb) && al(b_bs) && al(b_ss);
  skinny::Args P;
  P.a = static_cast<const int8_t*>(a);
  P.b = static_cast<const int8_t*>(b);
  P.c = static_cast<int32_t*>(c);
  P.lda = lda, P.a_bs = a_bs, P.a_ss = a_ss;
  P.ldb = ldb, P.b_bs = b_bs, P.b_ss = b_ss;
  P.m = m, P.n = n, P.p = p;
  const int cols = skinny::COLS;
  P.pt = p >= 128 ? 128 : ((p + cols - 1) / cols) * cols;
  P.nc = n > 0 ? (n + kc - 1) / kc : 0;
  const int units = G * P.nc;
  const int rts = (m + mt - 1) / mt;
  const long long tiles = (long long)((p + P.pt - 1) / P.pt) * rts * B;
  // split the units until the card has about four blocks per SM
  int want = (int)((4LL * sm_count() + tiles - 1) / tiles);
  want = units > 0 ? max(1, min(want, units)) : 1;
  P.ups = units > 0 ? (units + want - 1) / want : 0;
  P.splits = P.ups > 0 ? (units + P.ups - 1) / P.ups : 1;
  P.atomic = P.splits > 1;
  if ((long long)rts * P.splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P.atomic) {
    cudaError_t e = cudaMemsetAsync(c, 0, (size_t)B * m * p * 4, st);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p + P.pt - 1) / P.pt, rts * P.splits, B);
  switch (mt) {
    case 1: return skinny::launch_mt<1>(P, pr, grid, aligned, st);
    case 2: return skinny::launch_mt<2>(P, pr, grid, aligned, st);
    case 4: return skinny::launch_mt<4>(P, pr, grid, aligned, st);
    case 8: return skinny::launch_mt<8>(P, pr, grid, aligned, st);
    default: return skinny::launch_mt<16>(P, pr, grid, aligned, st);
  }
}
