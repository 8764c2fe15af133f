// Hopper (sm_90a) building blocks shared by the bf16 bodies of K1
// (flash_fwd.cu), K4 (flash_bwd_dq.cu) and K5 (flash_bwd_dkv.cu): cp.async
// copies into shared memory, the warpgroup product (wgmma) on operands
// stored as 64-column panels with the 128-byte swizzle, and the pass that
// reduces positions to per-tile bounds with the tile rule that reads them;
// for the fp32 bodies of K1 and K5, fp32-accurate products on the tensor
// cores (3xTF32, below); and, for a producer warp that feeds consumer warps
// (qmatmul.cu's bf16 body), mbarriers and tensor-map (TMA) copies that
// complete on them.
//
// Operand layout. A tile of `rows` rows and a multiple of 64 bf16 columns
// is stored as 64-column panels, panel after panel, each row of a panel 128
// bytes with its 16-byte chunks permuted by the row (swizzled()). The same
// tile serves as a K-major operand (rows = M or N, columns = the reduced
// dimension: wgmma_desc) and as an MN-major B operand (rows = the reduced
// dimension, columns = N: wgmma_desc_mn).
//
// Accumulator layout. A wgmma m64nN accumulator is held as [N/8][4] floats
// a thread: warp w's rows 16w + lane/4 (elements 0, 1) and 16w + lane/4 + 8
// (elements 2, 3), columns 8*nt + 2*(lane%4) + {0, 1} of n-tile nt — the
// layout of mma.sync's m16n8 accumulators. Rounded to bf16 in pairs
// (pack_bf16), n-tiles 2kk and 2kk + 1 are k16 step kk of wgmma's register
// A operand: register (nt % 2) * 2 + r of that step holds row half r of
// n-tile nt.

#pragma once

#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// bf16 columns of a staged row in the backward kernels: head_dim 32 is
// zero-padded to one 64-column panel, so that every product is wgmma.
template <int H> __host__ __device__ constexpr int staged_cols() { return H < 64 ? 64 : H; }

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool real) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = real ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
// One 4-byte element (fp32 or int32), zero-filled where !real.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool real) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = real ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 2^x on the special-function unit (relative error 2^-22, denormals to 0):
// the softmax's exponentials, whose p only ever weighs a sum.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Hopper's warpgroup product: a descriptor names a K-major operand tile in
// shared memory stored with the 128-byte swizzle, 8-row groups 1024 bytes
// apart.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
// d (m64 x nN, the same per-warp layout as mma.sync's m16n8 accumulators)
// += A . B^T over one k16 step; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16(float (&d)[8][4], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[4][4], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (m64 x nN) += A . B over one k16 step, A from registers in mma.sync's
// A-fragment layout and B an MN-major tile (rows of k, N contiguous) with
// the 128-byte swizzle.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),
        "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),
        "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),
        "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* p, int panel_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(panel_bytes >> 4) << 16) |  // 64-column panels apart
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
// d (m64 x n(8 NT)) += A . B over one k16 step, B the 16 MN-major rows at
// `rows` of a tile stored as 64-column panels `panel_bytes` apart: one
// wgmma up to n128; at n256 (head_dim 256) two m64n128k16 on d's column
// halves, B's panels 0-1 and 2-3.
template <int NT>
__device__ __forceinline__ void wgmma_bf16_rs_rows(float (&d)[NT][4], const uint32_t (&a)[4],
                                                   const unsigned char* rows, int panel_bytes) {
  if constexpr (NT == 32) {
    wgmma_bf16_rs(*reinterpret_cast<float(*)[16][4]>(&d[0]), a,
                  wgmma_desc_mn(rows, panel_bytes));
    wgmma_bf16_rs(*reinterpret_cast<float(*)[16][4]>(&d[16]), a,
                  wgmma_desc_mn(rows + 2 * panel_bytes, panel_bytes));
  } else {
    wgmma_bf16_rs(d, a, wgmma_desc_mn(rows, panel_bytes));
  }
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The wgmma's accumulators are written asynchronously: keep the compiler
// from moving their reads above the wait.
template <int NT>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    asm volatile("" : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])::"memory");
  }
}
// A register A operand is read asynchronously too: keep its registers
// live, and unchanged, up to the wait.
template <int KK>
__device__ __forceinline__ void wgmma_fence_operands(uint32_t (&a)[KK][4]) {
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]), "+r"(a[i][3])::"memory");
  }
}
// cp.async writes reach shared memory through the generic proxy; wgmma
// reads it through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// mbarriers in shared memory and the tensor-memory accelerator. A ring
// stage's "full" barrier expects the producer's arrivals plus the bytes of
// its copies (arrive_expect_tx before the copies, so the phase cannot
// complete before the bytes are counted); its "empty" barrier one arrival
// from each consumer warp. try_wait.parity(P) succeeds once the phase of
// parity P has completed: a barrier's use u (from 0) completes phase u,
// parity u & 1.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// The initialised barriers are visible to the tensor-memory accelerator.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 2-D tensor map (box column c0, row c1 of its global
// tensor; elements outside the tensor arrive as zeros) into shared `dst`
// (1024-byte aligned for the 128-byte swizzle), completing on `bar`'s
// transaction count with the box's full bytes. `map` lies in the kernel's
// parameter space (a __grid_constant__ argument).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
// A barrier over `threads` threads (a multiple of 32) of the block, by id
// (0 is __syncthreads'): the consumer warps' own, with the producer gone.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of element (r, c), c a multiple of 8, in a K-major tile of
// `rows` rows stored as 64-column panels with the 128-byte swizzle: the
// 16-byte chunk (c mod 64) / 8 of row r sits at chunk ((c mod 64) / 8) xor
// (r mod 8) of its 128-byte row.
__device__ __forceinline__ int swizzled(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4);
}
__device__ __forceinline__ int warp_min_i(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max_i(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 3xTF32: an fp32 product on the tensor cores at about fp32's accuracy,
// as CUTLASS's OpMultiplyAddFastF32 computes it. Each fp32 operand x is
// split as hi = tf32(x), lo = tf32(x - hi) (x - hi is exact; cvt.rna keeps
// 10 mantissa bits, round to nearest, ties away from zero), so hi + lo
// holds about 21 of x's 24 bits, and a . b = a_lo b_hi + a_hi b_lo + a_hi
// b_hi in fp32 accumulators (the lo lo term, 2^-22 relative, is dropped).
// The product is mma.sync m16n8k8 .tf32 (wgmma's m64 tiles are too wide
// for the fp32 bodies' head_dim 32, and ldmatrix serves 16-bit types only):
// A (16 x 8, row-major) holds elements (row g, col t), (g + 8, t), (g, t +
// 4), (g + 8, t + 4) in registers 0-3, B (8 x 8, k x n) holds (k t, n g)
// and (k t + 4, n g), with g = lane / 4 and t = lane % 4; the accumulator
// is the m16n8 layout described at the top.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// An m16n8k8 A fragment, split.
struct FragA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ void split_a(FragA& f, float a0, float a1, float a2, float a3) {
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
}
// Not volatile, so the compiler may reorder independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// An m16n8k8 B fragment, split.
struct FragB {
  uint32_t hi[2], lo[2];
};
__device__ __forceinline__ void split_b(FragB& f, float b0, float b1) {
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
}
// d[r][c + i] += a[r] . b[r][i] for r < R, i < NC in 3xTF32, the small
// terms first, issued term by term over all R * NC tiles (a tile's three
// products are dependent; the tiles' are not).
template <int R, int NC, int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[R][N][4], int c, const FragA (&a)[R],
                                           const FragB (&b)[R][NC]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < NC; ++i) mma_tf32(d[r][c + i], a[r].lo, b[r][i].hi[0], b[r][i].hi[1]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < NC; ++i) mma_tf32(d[r][c + i], a[r].hi, b[r][i].lo[0], b[r][i].lo[1]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < NC; ++i) mma_tf32(d[r][c + i], a[r].hi, b[r][i].hi[0], b[r][i].hi[1]);
  }
}

// bounds[b][t] = (min, max) position over tile t's BT rows below the row
// limit, which is min(L, valid[b]) or, with valid null, L (INT_MAX, INT_MIN
// for a tile with none). One warp per tile.
template <int BT>
__global__ void __launch_bounds__(32) tile_bounds_kernel(const int32_t* __restrict__ pos,
                                                         const int32_t* __restrict__ valid,
                                                         int2* __restrict__ bounds, int L) {
  const int t = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int end = valid != nullptr ? min(L, valid[b]) : L;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = lane; r < BT; r += 32) {
    const int s = t * BT + r;
    if (s < end) {
      const int p = pos[static_cast<size_t>(b) * L + s];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
  if (lane == 0) bounds[static_cast<size_t>(b) * gridDim.x + t] = make_int2(lo, hi);
}

// Whether a (q tile, kv tile) with these position bounds can hold a live
// pair, and whether every pair is live (the caller adds that both tiles
// lie below their row limits); the rule of
// ops/kernels/flash_attention.py:tile_bounds_test.
__device__ __forceinline__ bool tile_live(int qmin, int qmax, int kmin, int kmax, int window) {
  return kmin <= qmax && (window <= 0 || static_cast<long long>(qmin) - kmax < window);
}
__device__ __forceinline__ bool tile_full(int qmin, int qmax, int kmin, int kmax, int window) {
  return kmax <= qmin && (window <= 0 || static_cast<long long>(qmax) - kmin < window);
}

}  // namespace
