// Weight-only quantized matrix product, int8 and packed int4 weights —
// hand-written CUDA for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no pallas_call here. Its
// models/qmatmul.py:qmatmul computes x @ dequant(w) (models/quant.py:dequant)
// and leaves the product to XLA, which fuses the convert, the scale multiply
// and the int4 nibble shifts into the matmul's operand read, so no dense copy
// of a weight lands in HBM. A plain PyTorch x @ dequant(w) on the card
// writes a dense copy of every weight and reads it back, every step: about
// 5 bytes a parameter where bf16 weights cost 2, which would make quantized
// decode slower than unquantized. This file keeps the JAX property: the
// kernel reads the int8 or int4 bytes once and never writes a dense weight.
//
// It computes exactly ops/kernels/qmatmul.py:qmatmul_plain,
//
//   w[k][n] = round_to_T(float(q[k][n]) * s[k / group][n])   (one rounding)
//   y[m][n] = sum_k x[m][k] * w[k][n]                          (fp32 sums)
//
// for x [M, K] in T (bf16 or fp32, the scales' dtype), q int8 [K, N] (int8,
// one scale row) or packed [ceil(K/2), N] (int4: byte b holds row 2b in its
// low nibble and row 2b + 1 in its high one), s [ceil(K/group), N], with N
// contiguous and rows ldq (q) and lds (s) apart, so a column slice of a
// head is taken as it is; y [M, N] in T or fp32.
//
// What bounds it on an H100: at the decode rows (M <= 64: 8 a plain step,
// 32 a verify block, 4 in protocol-s) the weight bytes. A weight is read for
// M multiply-adds, far below the card's ~295 operations a byte, so the least
// time is the read of q and s: wg of llama3-8b (4096 x 14336) at M = 8 reads
// 58.7 MB in int8 (17.5 us at 3.35 TB/s), 29.4 MB plus 0.9 MB of scales in
// int4 (9.0 us), against 117 MB (35.0 us) in bf16. Two things stand between
// a kernel and that time, both measured on an H100 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md, scripts/port_qmatmul_ab.py and port_qmatmul_probe.py):
// the issue rate of the consumers' instructions (the dequant is four or
// five operations a weight pair, and at 8 rows a tile's bytes leave in
// ~300 cycles an SM), and the copies' rate (boxes of 128-byte rows stream
// at ~1.8 (int4) to ~2.2 TB/s (int8) with no consumer work at all).
//
// The bf16 body (qmm_bf16_kernel): a producer warp and four consumer warps.
//
// - The grid is (column strip, split of K). A block owns 128 output columns
//   and a run of whole 64-row tiles of K (split-K: launch_plan in the
//   wrapper, as many blocks as the card holds at once, from this kernel's
//   occupancy, each split at least MIN_SPLIT_TILES tiles, and few enough
//   that the splits' fp32 partials stay under a quarter of the weight's
//   bytes), so a 1024-column matrix keeps the card busy too.
// - The producer warp fills a ring of tiles in shared memory (stages(): six
//   int8, four int4) through the tensor-memory accelerator: one lane arms
//   the stage's full mbarrier
//   with the tile's bytes and issues one 2-D tensor-map copy each for the q
//   tile (64 int8 or 32 packed int4 rows of the strip's 128 bytes), the x
//   rows' 64 columns and int4's scale rows; rows and columns outside a
//   tensor arrive as zeros. Consumers wait on that barrier and release the
//   stage through its empty barrier, one arrival a warp: no block-wide
//   barrier a tile, and no consumer register holds a copy's address. The
//   maps are encoded once for each operand (tensor_map's cache) and passed
//   as a __grid_constant__ argument, so a captured launch replays them. An
//   operand that breaks TMA's 16-byte rules (an unaligned base or stride)
//   is staged by the same warp with plain loads, into the same layout. One
//   copy a staged row (cp.async.bulk) was tried first: at about one copy
//   request an SM every 24-31 cycles it was slower than the cp.async body
//   it replaced.
// - q and x rows are 128 bytes with the 128-byte swizzle (16-byte chunk c
//   of row r at c ^ (r % 8)), so the rows one consumer load reads fall on
//   distinct banks (int8, x) or two to a bank (int4's four rows t).
// - Each consumer dequantizes each weight once, in the registers of the one
//   thread whose mma.sync B fragment holds it (b_fragments): the warp's 32
//   output columns are taken in a permuted order (n-tile j, column c is the
//   strip's column 4c + j), so that a thread's B columns are four
//   neighbouring bytes of a staged row and each of its B registers comes
//   from one 32-bit load a row. A bf16 holds every int8 and int4 value
//   exactly, so a byte_perm puts two of them (two k rows of a column) under
//   the exponent of the bf16 128 in the halves of a register, one bf16x2
//   FMA takes the bias off (exact) and one more multiplies by the scales,
//   which rounds q * s once, as the plain version rounds it. int4 folds its
//   sign flip into that one LOP3 (written out: with two constants the
//   compiler splits it in two) and pays one shift a word: four operations a
//   weight pair. No dequantized weight is stored, not even in shared
//   memory. The product: mma.sync m16n8k16, bf16 operands, fp32
//   accumulators; warp w owns 32 columns (four n8 tiles) and every m16 tile
//   of the M rows (MT = ceil(M / 16), a template argument). The scales'
//   handling is a template argument too (WHOLE): a runtime branch inside the
//   unrolled steps made the compiler recompute every step's addresses.
// - Registers: a consumer holds its MT x 16 accumulators, its B fragments,
//   its columns' scales and the ring's index: 72 (int8) and 80 (int4)
//   registers at 8 rows, 87 and 80 at 32; three (int8, its six-tile ring)
//   or four (int4) blocks of 160 threads an SM, 12 or 16 consumer warps
//   (the cp.async body: three blocks of four warps at ~150 registers, a
//   thread issuing its own copies). setmaxnreg moves registers between
//   warpgroups, and the producer is a single warp: a producer warpgroup at
//   setmaxnreg's floor of 24 registers would cost more than one warp at the
//   consumers' count. A 64-register cap (six blocks an SM) gained at most
//   2.4%.
// - Splits write fp32 partials; the last block of a strip to arrive (an
//   int32 counter a strip, after a __threadfence) sums them (split_sum):
//   its 128 threads share the (row, 4-column cell, run of splits) work, each
//   adding its run in split order with eight loads in flight, and the runs
//   meet in a fixed order through shared memory. No float atomics, so a
//   repeat gives the same bits; the last block resets its counter, so the
//   counters the wrapper keeps are zero between launches and a captured
//   launch needs no memset.
//
// The fp32 body (protocol-s, qmm_fp32_kernel): full fp32 on the CUDA cores
// (fp32 values have no tensor-core product of fp32 accuracy short of 3xTF32;
// these shapes are launch- and latency-bound: K and N of 256 to 1024 read
// at most 1 MB). The contraction is split over the card: a block owns 128
// columns, 4 rows and a slice of K; its 256 threads are 8 column chunks of
// 16 by 32 contraction lanes, each lane loading 16 bytes of a q row a step
// (coalesced: the 8 chunks of a row are its 128 bytes) and accumulating 4 x
// 16 sums with fmaf of float(q) * s, rounded as the plain version rounds it.
// The lanes' sums meet in a fixed order (a shuffle butterfly inside the
// warp, then the eight warps through shared memory), the slices' through
// the partials and the last block's split_sum, as the bf16 body's. One
// thread a column walking all of K filled 2 to 8 of 132 SMs at these widths.
//
// Prefill rows (M > 64) take dequant_kernel instead: the weight into a dense
// T workspace, then a plain torch.matmul (ops/kernels/qmatmul.py), 2.5 to 3
// extra bytes a parameter once a prefill. The int4 unpack in plain PyTorch
// would make several temporaries of every weight; this writes one.

#include <cstdint>
#include <functional>
#include <mutex>
#include <unordered_map>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 128;                  // output columns a block owns
constexpr int KT = 64;                   // contraction rows a tile
constexpr int KP = KT / 2;               // row pairs a tile: one 32-bit word of two bf16 each
constexpr int CONSUMERS = 128;           // four consumer warps, 32 columns each
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
// Tiles in the shared-memory ring: int8's copies bound it, and six tiles
// keep more of its bytes in flight; int4's consumers bound it, and six
// tiles cost it time (scripts/port_qmatmul_probe.py, stages-6).
template <int BITS> __host__ __device__ constexpr int stages() { return BITS == 8 ? 6 : 4; }
constexpr int MAX_STAGES = 6;
constexpr int ROW_BYTES = 128;          // a staged q row (NT bytes) or x row (KT bf16 values)
constexpr int S_ROW_BYTES = NT * 2;      // a staged int4 scale row
constexpr int SWIZZLE = 1024;            // the 128-byte swizzle's period and alignment
constexpr int MAX_ROWS = 64;             // rows the fused kernels take
constexpr int F_ROWS = 4;                // rows a block of the fp32 kernel accumulates
constexpr int F_CHUNKS = NT / 16;        // its column chunks of 16 ...
constexpr int F_LANES = 32;              // ... by contraction lanes
constexpr int F_THREADS = F_CHUNKS * F_LANES;

struct Params {
  const void* x;        // [M, K] T, contiguous
  const int8_t* q;      // int8 [K, ldq] or packed int4 [ceil(K/2), ldq]
  const void* s;        // [G, lds] T
  void* out;            // [M, N] T, or fp32 with out_f32
  float* part;          // split partials (Z > 1): [Z][blocks of a split][rows][128] fp32
  int* arrivals;        // a counter a block of a split, zero between launches (Z > 1)
  int M, K, N, ldq, lds, group, G, per, Z, out_f32;
  int sr;               // bf16 int4: scale rows a ring stage
  int stage;            // bf16: bytes a ring stage
  int tiled;            // bf16: the producer copies through the tensor maps
  int x_rows;           // bf16: x rows a tile copies (8 for M <= 8, else 16 MT)
  int vec_q, vec_x, vec_s;  // 16-byte vector loads are aligned
};

// The bf16 body's tensor maps (a __grid_constant__ argument): q [q rows,
// N] in boxes of QR x 128 bytes and x [M, K] in boxes of x_rows x 64
// values, both with the 128-byte swizzle; int4's s [G, N] in boxes of sr x
// 128 values.
struct Maps {
  CUtensorMap q, x, s;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Byte e of u (a biased value, 0..255) as fp32: the byte under the exponent
// of 2^23 (0x4B000000) is 2^23 + u, exactly.
template <int E> __device__ __forceinline__ float biased_byte(uint32_t u) {
  return __int_as_float(static_cast<int>(__byte_perm(u, 0x4B000000u, 0x7540 | E)));
}
// The four int8 values of a word, and the four low and high int4 nibbles.
__device__ __forceinline__ void int8x4(uint32_t w, float (&v)[4]) {
  const uint32_t u = w ^ 0x80808080u;  // q + 128 in each byte
  v[0] = biased_byte<0>(u) - 8388736.f;  // 2^23 + 128
  v[1] = biased_byte<1>(u) - 8388736.f;
  v[2] = biased_byte<2>(u) - 8388736.f;
  v[3] = biased_byte<3>(u) - 8388736.f;
}
__device__ __forceinline__ void int4x4(uint32_t w, float (&lo)[4], float (&hi)[4]) {
  const uint32_t u = w ^ 0x88888888u;  // each nibble + 8
  const uint32_t l = u & 0x0F0F0F0Fu, h = (u >> 4) & 0x0F0F0F0Fu;
  lo[0] = biased_byte<0>(l) - 8388616.f;  // 2^23 + 8
  lo[1] = biased_byte<1>(l) - 8388616.f;
  lo[2] = biased_byte<2>(l) - 8388616.f;
  lo[3] = biased_byte<3>(l) - 8388616.f;
  hi[0] = biased_byte<0>(h) - 8388616.f;
  hi[1] = biased_byte<1>(h) - 8388616.f;
  hi[2] = biased_byte<2>(h) - 8388616.f;
  hi[3] = biased_byte<3>(h) - 8388616.f;
}

// 16 bytes of a q row from column n (0 past N).
__device__ __forceinline__ uint4 load_q16(const int8_t* row, int n, int N, bool vec) {
  if (vec && n + 16 <= N) return __ldg(reinterpret_cast<const uint4*>(row + n));
  uint4 u;
  unsigned char* b = reinterpret_cast<unsigned char*>(&u);
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = n + j < N ? static_cast<unsigned char>(row[n + j]) : 0;
  return u;
}

// 16 values of a T row from column n as fp32 (0 past N).
template <typename T>
__device__ __forceinline__ void load16(float (&out)[16], const T* row, int n, int N, bool vec) {
  if (vec && n + 16 <= N) {
    constexpr int PER = 16 / static_cast<int>(sizeof(T));  // values a 16-byte load
    const uint4* src = reinterpret_cast<const uint4*>(row + n);
#pragma unroll
    for (int v = 0; v < 16 / PER; ++v) {
      const uint4 u = __ldg(src + v);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[v * PER + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) out[j] = n + j < N ? to_f(row[n + j]) : 0.f;
  }
}

// The scale row of contraction row k; rows past K (zero weights) read the
// last row, so that no load leaves the tensor.
__device__ __forceinline__ int scale_row(const Params& p, int k) {
  return min(k / p.group, p.G - 1);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BITS> __host__ __device__ constexpr int q_tile_rows() { return BITS == 8 ? KT : KP; }
template <int BITS> __host__ __device__ constexpr int q_tile_bytes() {
  return q_tile_rows<BITS>() * ROW_BYTES;
}
// A ring stage: the q tile, 16 MT x rows (both 128-byte rows with the
// 128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8), as the
// tensor map writes them), then sr scale rows (int4); a multiple of the
// swizzle's period.
template <int BITS, int MT> __host__ __device__ constexpr int stage_bytes(int sr) {
  return (q_tile_bytes<BITS>() + MT * 16 * ROW_BYTES + sr * S_ROW_BYTES + SWIZZLE - 1) /
         SWIZZLE * SWIZZLE;
}
// Byte `b` of a staged row `r` (128 bytes with the 128-byte swizzle), from
// the row's start; and from the tile's.
__device__ __forceinline__ int swz_col(int r, int b) {
  return ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}
__device__ __forceinline__ int swz(int r, int b) { return r * ROW_BYTES + swz_col(r, b); }
// Scale rows a 64-row tile can span at this group (int4; the wrapper's
// ops/kernels/qmatmul.py:scale_rows): tiles start at multiples of 64, so a
// tile's first row sits at most group - gcd(64, group) into its group.
__host__ __device__ inline int tile_scale_rows(int group, int G) {
  int a = 64, b = group;
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const long long span = 1 + (static_cast<long long>(group) - a + KT - 1) / group;
  return static_cast<int>(span < G ? span : G);
}

// ------------------------------------------------------------------------
// The split sum, shared by both bodies.
// ------------------------------------------------------------------------

// Four result columns of a 128-column strip, from 4-column cell c4 of the
// partials: in order (fp32 body), or in the bf16 body's permuted order
// (cell position pp = 32w + 8j + c holds the strip's column 32w + 4c + j).
template <typename OutT, bool PERMUTED>
__device__ __forceinline__ void store_cell(const Params& p, int m, int n0, int c4, float4 v) {
  const float e[4] = {v.x, v.y, v.z, v.w};
  OutT* out = static_cast<OutT*>(p.out) + static_cast<size_t>(m) * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int n;
    if (PERMUTED) {
      const int pp = 4 * c4 + i;
      n = n0 + (pp & ~31) + 4 * (pp & 7) + ((pp >> 3) & 3);
    } else {
      n = n0 + 4 * c4 + i;
    }
    if (n < p.N) out[n] = from_f<OutT>(e[i]);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// The last block of a (strip, row group) sums the Z splits' partials of
// its `rows` rows (from `base`, split z at base + z * zstride, row m at
// + m * NT) and writes the result rows m0 ... The work is (row, 4-column
// cell, run of splits): a thread adds its run in split order, eight loads
// in flight; with more threads than cells the runs meet in run order
// through `red` (nth float4). Every thread of the `nth` calls it; `sync`
// is their barrier.
template <typename OutT, bool PERMUTED, typename Sync>
__device__ __forceinline__ void split_sum(const Params& p, const float* base, size_t zstride,
                                          int rows, int m0, int n0, float4* red, int nth, int tid,
                                          Sync sync) {
  constexpr int ZB = 8;
  const int cells = rows * (NT / 4);
  int runs = max(1, min(p.Z, nth / cells));
  const int zc = (p.Z + runs - 1) / runs;
  runs = (p.Z + zc - 1) / zc;
  for (int u = tid; u < cells * runs; u += nth) {
    const int cell = u % cells, h = u / cells;
    const int m = cell / (NT / 4), c4 = cell % (NT / 4);
    const float* src = base + static_cast<size_t>(m) * NT + 4 * c4;
    const int z_end = min(p.Z, (h + 1) * zc);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = h * zc; z0 < z_end; z0 += ZB) {
      float4 v[ZB];
#pragma unroll
      for (int i = 0; i < ZB; ++i) {
        v[i] = z0 + i < z_end ? __ldcg(reinterpret_cast<const float4*>(src + (z0 + i) * zstride))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < ZB; ++i) {
        if (z0 + i < z_end) add4(sum, v[i]);  // split order
      }
    }
    if (runs == 1) {
      store_cell<OutT, PERMUTED>(p, m0 + m, n0, c4, sum);
    } else {
      red[h * cells + cell] = sum;
    }
  }
  if (runs == 1) return;
  sync();
  for (int cell = tid; cell < cells; cell += nth) {
    float4 sum = red[cell];
    for (int h = 1; h < runs; ++h) add4(sum, red[h * cells + cell]);  // run order
    store_cell<OutT, PERMUTED>(p, m0 + cell / (NT / 4), n0, cell % (NT / 4), sum);
  }
}

// After a block's partials are stored: count its arrival; the last block
// of `counter` resets it and returns true. Every thread of the `sync`
// barrier calls it.
template <typename Sync>
__device__ __forceinline__ bool arrive_last(const Params& p, int counter, int tid, int* is_last,
                                            Sync sync) {
  __threadfence();  // this block's partials are visible device-wide ...
  sync();
  int* arrived = p.arrivals + counter;
  if (tid == 0) *is_last = atomicAdd(arrived, 1) == p.Z - 1;  // ... before its arrival counts
  sync();
  if (!*is_last) return false;
  __threadfence();  // every split's partials are visible to this block
  if (tid == 0) *arrived = 0;
  return true;
}

// ------------------------------------------------------------------------
// The bf16 body.
// ------------------------------------------------------------------------

// The bf16x2 pairs (scale row ga in the low half, gb in the high) of
// columns n .. n + 3 (0 past N), from global memory: int8's one row.
__device__ __forceinline__ void load_scale_pairs(uint32_t (&o)[4], const Params& p, int ga,
                                                 int gb, int n) {
  const uint16_t* s = static_cast<const uint16_t*>(p.s);
  const uint16_t* ra = s + static_cast<size_t>(ga) * p.lds;
  const uint16_t* rb = s + static_cast<size_t>(gb) * p.lds;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o[e] = n + e < p.N ? (static_cast<uint32_t>(rb[n + e]) << 16) | ra[n + e] : 0u;
  }
}
// The same from two staged scale rows' four columns (a low halves, b high).
__device__ __forceinline__ void scale_pairs(uint32_t (&o)[4], uint2 a, uint2 b) {
  o[0] = __byte_perm(a.x, b.x, 0x5410);
  o[1] = __byte_perm(a.x, b.x, 0x7632);
  o[2] = __byte_perm(a.y, b.y, 0x5410);
  o[3] = __byte_perm(a.y, b.y, 0x7632);
}

// d = a * b + c on bf16 pairs, each half rounded once to nearest even.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
// (a & b) | c and (a & b) ^ c as one LOP3 each: written out with the
// masks in registers, since a LOP3 takes one immediate and the compiler
// splits the C expression with two constants into two.
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The B fragments of the warp's four n8 tiles for k16 step kk of the
// staged tile, dequantized in registers. The warp's 32 columns are taken in
// a permuted order: column g of n-tile j is the strip's column 4g + j, so
// that a thread (g, t)'s four B columns are the four bytes 4g .. 4g + 3 of
// a staged row, one 32-bit load a row (at byte offset off[parity] of the
// row: the thread's rows differ only in r % 8, which the swizzle reads).
// b[j][0] holds k 2t and 2t + 1, b[j][1] k 2t + 8 and 2t + 9, as
// mma.sync's B fragment, each weight round_bf16(q * s) as the plain
// version rounds it.
//
// int8: rows 2t and 2t + 1 (then 2t + 8 and 2t + 9) of the k16 step give a
// B register's pair of a column: the two bytes go into the halves of a
// bf16x2 by one byte_perm, and q is the bf16 128 + (q & 127) less 128 (q
// >= 0) or 256 (q < 0), both exact; one more bf16x2 FMA multiplies by the
// column's scale ``sc2`` (the same in both halves), which is
// round_bf16(q * s). No fp32 conversion: a bf16 holds every int8 exactly.
__device__ __forceinline__ void b_fragments_int8(uint32_t (&b)[4][2], const unsigned char* raw,
                                                 int kk, int t, const int (&off)[2],
                                                 const uint32_t (&sc2)[4]) {
  constexpr uint32_t kOne = 0x3F803F80u, kMinusZero = 0x80008000u;
  const unsigned char* base = raw + (16 * kk + 2 * t) * ROW_BYTES;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(base + 8 * h * ROW_BYTES + off[0]);
    const uint32_t hi = *reinterpret_cast<const uint32_t*>(base + (8 * h + 1) * ROW_BYTES + off[1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t u = __byte_perm(lo, hi, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
      // 128 + (q & 127) in each half, and -128 or -256 by q's sign bit.
      const uint32_t q = fma_bf16x2(and_or(u, 0x007F007Fu, 0x43004300u), kOne,
                                    and_or(u, 0x00800080u, 0xC300C300u));
      b[j][h] = fma_bf16x2(q, sc2[j], kMinusZero);
    }
  }
}

// int4: packed rows t and t + 4 of the k16 step, whose byte of a column is
// exactly a B register's pair (low nibble k = 2r, high k = 2r + 1). A
// byte_perm of the word and the word shifted by 4 puts the two raw nibbles
// (two's complement, r) in the low bits of the two halves; one LOP3 masks
// them, flips their sign bit (r ^ 8 = q + 8) and sets the exponent of the
// bf16 128 (0x4300 | (q + 8) is 136 + q); one bf16x2 FMA takes 136 off (q,
// exact), and one more multiplies by the pair's scales (``s01`` for k 2t
// and 2t + 1, ``s89`` for 2t + 8 and 2t + 9), which is round_bf16(q * s):
// the exact product rounded once. Adding -0 keeps q * s = +0 for q = 0, as
// the plain version gives it.
__device__ __forceinline__ void b_fragments_int4(uint32_t (&b)[4][2], const unsigned char* raw,
                                                 int kk, int t, const int (&off)[2],
                                                 const uint32_t (&s01)[4],
                                                 const uint32_t (&s89)[4]) {
  constexpr uint32_t kOne = 0x3F803F80u, kMinus136 = 0xC308C308u, kMinusZero = 0x80008000u;
  const unsigned char* base = raw + (8 * kk + t) * ROW_BYTES;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(base + 4 * h * ROW_BYTES + off[h]);
    const uint32_t w4 = w >> 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // half 0 <- w's byte j (its low nibble), half 1 <- w4's byte j (w's high nibble).
      const uint32_t u = __byte_perm(w, w4, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
      const uint32_t q = fma_bf16x2(and_xor(u, 0x000F000Fu, 0x43084308u), kOne, kMinus136);
      b[j][h] = fma_bf16x2(q, h ? s89[j] : s01[j], kMinusZero);
    }
  }
}

// The producer warp: for each tile of the block's split, wait until the
// consumers have released its stage, then fill it. Through the tensor
// maps (``tiled``), lane 0 arms the stage's full barrier with the stage's
// bytes and issues three copies: the q tile, the x tile (rows past M and
// columns past K arrive as zeros), int4's scale rows; the other lanes
// arrive. Otherwise (an operand that breaks TMA's 16-byte rules) the warp
// stages every row with plain loads into the same swizzled layout, zero
// outside the tensors, and each lane arrives.
template <int BITS, int MT>
__device__ __forceinline__ void produce(const Params& p, const Maps& maps, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty, int n_tiles, int t_begin,
                                        int n0, int lane) {
  constexpr int QR = q_tile_rows<BITS>(), XR = MT * 16;
  const int q_rows = BITS == 8 ? p.K : (p.K + 1) / 2;
  const int sr = BITS == 4 ? p.sr : 0;
  const uint32_t bytes = q_tile_bytes<BITS>() + p.x_rows * ROW_BYTES + sr * S_ROW_BYTES;
  const unsigned char* qg = reinterpret_cast<const unsigned char*>(p.q);
  const uint16_t* xg = static_cast<const uint16_t*>(p.x);
  const uint16_t* sg = static_cast<const uint16_t*>(p.s);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % stages<BITS>();
    if (i >= stages<BITS>()) mbar_wait(&empty[st], ((i / stages<BITS>()) - 1) & 1);
    unsigned char* raw = smem + st * p.stage;
    unsigned char* xs = raw + q_tile_bytes<BITS>();
    unsigned char* ss = xs + XR * ROW_BYTES;
    const int k0 = (t_begin + i) * KT;
    const int r0 = BITS == 8 ? k0 : k0 / 2;
    const int g_first = BITS == 4 ? min(k0 / p.group, p.G - 1) : 0;
    if (p.tiled) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], bytes);
        tma_load_2d(raw, &maps.q, n0, r0, &full[st]);
        tma_load_2d(xs, &maps.x, k0, 0, &full[st]);
        if (BITS == 4) tma_load_2d(ss, &maps.s, n0, g_first, &full[st]);
      } else {
        mbar_arrive(&full[st]);
      }
      continue;
    }
    // Bytes 4 lane .. 4 lane + 3 of each q row (0 outside the tensor).
    for (int r = 0; r < QR; ++r) {
      uint32_t v = 0;
      if (r0 + r < q_rows) {
        const unsigned char* src = qg + static_cast<size_t>(r0 + r) * p.ldq + n0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n0 + 4 * lane + e < p.N) v |= static_cast<uint32_t>(src[4 * lane + e]) << (8 * e);
        }
      }
      *reinterpret_cast<uint32_t*>(raw + swz(r, 4 * lane)) = v;
    }
    // Columns k0 + 2 lane and + 1 of each x row (0 past M or K).
    for (int m = 0; m < XR; ++m) {
      const uint16_t* row = xg + static_cast<size_t>(m) * p.K;
      const int k = k0 + 2 * lane;
      const uint32_t a = m < p.M && k < p.K ? row[k] : 0;
      const uint32_t c = m < p.M && k + 1 < p.K ? row[k + 1] : 0;
      *reinterpret_cast<uint32_t*>(xs + swz(m, 4 * lane)) = (c << 16) | a;
    }
    // Columns n0 + 4 lane .. + 3 of each scale row (0 outside the tensor).
    for (int j = 0; j < sr; ++j) {
      const uint16_t* row = sg + static_cast<size_t>(g_first + j) * p.lds + n0;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = g_first + j < p.G && n0 + 4 * lane + e < p.N ? row[4 * lane + e] : 0;
      }
      *reinterpret_cast<uint2*>(ss + j * S_ROW_BYTES + 8 * lane) =
          make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
    }
    mbar_arrive(&full[st]);
  }
}

// Write a block's [M x 128] result, directly (one split) or through the
// partials and the last block's ordered sum. Consumer threads only.
template <typename OutT, int MT>
__device__ __forceinline__ void finish(const Params& p, float (&acc)[MT][4][4], int n0,
                                       float4* red, int* is_last) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  if (p.Z == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // Column c of n-tile nt is the strip's column 4c + nt (b_fragments).
          const int m = 16 * mt + g + 8 * (i >> 1), n = n0 + warp * 32 + 4 * (2 * t + (i & 1)) + nt;
          if (m < p.M && n < p.N) {
            static_cast<OutT*>(p.out)[static_cast<size_t>(m) * p.N + n] =
                from_f<OutT>(acc[mt][nt][i]);
          }
        }
      }
    }
    return;
  }
  // Partials in the permuted order, [split][strip][row][128]: a thread's
  // two neighbouring columns of an n-tile are one 8-byte store.
  const size_t zstride = static_cast<size_t>(gridDim.x) * p.M * NT;
  float* part = p.part + blockIdx.y * zstride + static_cast<size_t>(blockIdx.x) * p.M * NT;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * mt + g + 8 * h;
        if (m < p.M) {
          *reinterpret_cast<float2*>(part + m * NT + warp * 32 + 8 * nt + 2 * t) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
  }
  auto sync = [] { named_sync(1, CONSUMERS); };
  if (!arrive_last(p, blockIdx.x, tid, is_last, sync)) return;
  split_sum<OutT, true>(p, p.part + static_cast<size_t>(blockIdx.x) * p.M * NT, zstride, p.M, 0,
                        n0, red, CONSUMERS, tid, sync);
}

// WHOLE (int4 whose group is a multiple of 64, and int8): no tile crosses
// a scale group, so a consumer takes its scales once a tile; otherwise
// (int4) it follows the group step by step. A compile-time choice: a
// branch on it inside the unrolled steps cost each step a recomputation of
// its addresses.
template <int BITS, int MT, bool WHOLE>
__global__ void __launch_bounds__(THREADS, MT <= 2 ? 4 : 3)
    qmm_bf16_kernel(const Params p, const __grid_constant__ Maps maps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ float4 red[CONSUMERS];
  __shared__ int is_last;
  constexpr int XR = MT * 16;
  // The ring, aligned to the swizzle's period (the launch adds the slack).
  unsigned char* smem = smem_raw + ((SWIZZLE - smem_u32(smem_raw) % SWIZZLE) % SWIZZLE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * NT;
  const int k_tiles = (p.K + KT - 1) / KT;
  const int t_begin = blockIdx.y * p.per;
  const int n_tiles = max(0, min(k_tiles, t_begin + p.per) - t_begin);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < stages<BITS>(); ++s) {
      mbar_init(&full[s], 32);               // the producer's lanes
      mbar_init(&empty[s], CONSUMERS / 32);  // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == CONSUMERS / 32) {
    produce<BITS, MT>(p, maps, smem, full, empty, n_tiles, t_begin, n0, lane);
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  // The thread's four B columns (b_fragments): bytes 4g .. 4g + 3 of the
  // warp's 32, at these offsets in its rows (int8: rows 2t and 2t + 1
  // modulo 8; int4: t and t + 4).
  const int col_byte = warp * 32 + 4 * g;
  const int off[2] = {swz_col(BITS == 8 ? 2 * t : t, col_byte),
                      swz_col(BITS == 8 ? 2 * t + 1 : t + 4, col_byte)};
  // Their scales: int8 one row for every k, loaded once; int4 from the
  // stage's rows, the group of each k16 step followed without a division
  // (``g_cur`` the group of the step's first row, ``next_b`` the next
  // group's first row; ``loaded`` the staged row in s01/s89, -1 for none).
  uint32_t s01[4], s89[4];
  int g_cur = 0, next_b = 0;
  if (BITS == 8) {
    load_scale_pairs(s01, p, 0, 0, n0 + col_byte);
  } else {
    g_cur = t_begin * KT / p.group;
    next_b = (g_cur + 1) * p.group;
  }
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % stages<BITS>();
    mbar_wait(&full[st], (i / stages<BITS>()) & 1);
    const unsigned char* raw = smem + st * p.stage;
    const unsigned char* xs = raw + q_tile_bytes<BITS>();
    const unsigned char* ss = xs + XR * ROW_BYTES + 2 * col_byte;
    const int k0 = (t_begin + i) * KT;
    int g_first = 0, loaded = -1;
    if (BITS == 4 && WHOLE) {  // the tile inside one group: its one staged row
      const uint2 v = *reinterpret_cast<const uint2*>(ss);
      scale_pairs(s01, v, v);
    } else if (BITS == 4) {
      while (k0 >= next_b) {
        ++g_cur;
        next_b += p.group;
      }
      g_first = min(g_cur, p.G - 1);
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t b[4][2];
      if (BITS == 8) {
        b_fragments_int8(b, raw, kk, t, off, s01);
      } else if (WHOLE) {
        b_fragments_int4(b, raw, kk, t, off, s01, s01);
      } else {
        const int kb = k0 + 16 * kk;
        while (kb >= next_b) {
          ++g_cur;
          next_b += p.group;
        }
        if (kb + 15 < next_b) {  // the k16 step inside one group: one scale row
          const int rel = min(g_cur, p.G - 1) - g_first;
          if (rel != loaded) {
            const uint2 v = *reinterpret_cast<const uint2*>(ss + rel * S_ROW_BYTES);
            scale_pairs(s01, v, v);
#pragma unroll
            for (int j = 0; j < 4; ++j) s89[j] = s01[j];
            loaded = rel;
          }
        } else {  // a group boundary inside the step: each k's own row
          uint2 v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = kb + 2 * t + (e & 1) + 8 * (e >> 1);
            v[e] = *reinterpret_cast<const uint2*>(ss + (scale_row(p, k) - g_first) * S_ROW_BYTES);
          }
          scale_pairs(s01, v[0], v[1]);
          scale_pairs(s89, v[2], v[3]);
          loaded = -1;
        }
        b_fragments_int4(b, raw, kk, t, off, s01, s89);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // A fragment: rows 16 mt + g and + 8 (both g modulo 8), bytes 32 kk
        // + 4t and + 16 of the swizzled x rows.
        const unsigned char* r0 = xs + (16 * mt + g) * ROW_BYTES + 4 * t;
        const unsigned char* r8 = r0 + 8 * ROW_BYTES;
        const int c0 = ((2 * kk) ^ g) << 4, c1 = ((2 * kk + 1) ^ g) << 4;
        const bool hi = p.M > 16 * mt + 8;  // rows 8 .. 15 of the m-tile were copied
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(r0 + c0),
                               hi ? *reinterpret_cast<const uint32_t*>(r8 + c0) : 0u,
                               *reinterpret_cast<const uint32_t*>(r0 + c1),
                               hi ? *reinterpret_cast<const uint32_t*>(r8 + c1) : 0u};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the warp's reads of the stage are done
  }
  if (p.out_f32) {
    finish<float, MT>(p, acc, n0, red, &is_last);
  } else {
    finish<__nv_bfloat16, MT>(p, acc, n0, red, &is_last);
  }
}

// ------------------------------------------------------------------------
// The fp32 body.
// ------------------------------------------------------------------------

// Grid (strip, row group of F_ROWS, split of the q rows, `per` each).
// Thread (warp w, lane l): column chunk l % 8 (16 columns), contraction
// lane 4w + l / 8, which walks the split's q rows F_LANES apart.
template <int BITS>
__global__ void __launch_bounds__(F_THREADS) qmm_fp32_kernel(const Params p) {
  __shared__ float red_w[F_THREADS / 32][F_ROWS][F_CHUNKS][17];  // padded: no bank conflicts
  __shared__ float4 red[F_THREADS];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = lane & 7, kl = 4 * warp + (lane >> 3);
  const int n0 = blockIdx.x * NT, nc = n0 + 16 * chunk;
  const int m0 = blockIdx.y * F_ROWS;
  const int rows = min(F_ROWS, p.M - m0);
  const int q_rows = BITS == 8 ? p.K : (p.K + 1) / 2;
  const int r_begin = blockIdx.z * p.per, r_end = min(q_rows, r_begin + p.per);
  const float* x = static_cast<const float*>(p.x) + static_cast<size_t>(m0) * p.K;
  const float* s = static_cast<const float*>(p.s);
  float acc[F_ROWS][16];
#pragma unroll
  for (int m = 0; m < F_ROWS; ++m) {
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;
  }
  float sc[16];
  int g_at = 0;
  load16(sc, s, nc, p.N, p.vec_s);  // scale row 0: int8's only one
#pragma unroll 2
  for (int r = r_begin + kl; r < r_end; r += F_LANES) {
    const uint4 raw = load_q16(p.q + static_cast<size_t>(r) * p.ldq, nc, p.N, p.vec_q);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int h = 0; h < (BITS == 8 ? 1 : 2); ++h) {
      const int k = BITS == 8 ? r : 2 * r + h;
      if (k >= p.K) break;  // the padded nibble of an odd K
      if (BITS == 4) {
        const int gr = scale_row(p, k);
        if (gr != g_at) {
          load16(sc, s + static_cast<size_t>(gr) * p.lds, nc, p.N, p.vec_s);
          g_at = gr;
        }
      }
      float xv[F_ROWS];
#pragma unroll
      for (int m = 0; m < F_ROWS; ++m) {
        xv[m] = m < rows ? __ldg(x + static_cast<size_t>(m) * p.K + k) : 0.f;
      }
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4) {
        float lo[4], hi[4];
        if (BITS == 8) {
          int8x4(words[w4], lo);
        } else {
          int4x4(words[w4], lo, hi);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = (h ? hi[e] : lo[e]) * sc[4 * w4 + e];  // one rounding, as plain
#pragma unroll
          for (int m = 0; m < F_ROWS; ++m) acc[m][4 * w4 + e] = fmaf(xv[m], w, acc[m][4 * w4 + e]);
        }
      }
    }
  }
  // The four contraction lanes of a chunk in a warp (lanes chunk + 8i): a
  // butterfly, the same sums in the same order on every lane.
#pragma unroll
  for (int m = 0; m < F_ROWS; ++m) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  }
  if (lane < F_CHUNKS) {
#pragma unroll
    for (int m = 0; m < F_ROWS; ++m) {
#pragma unroll
      for (int j = 0; j < 16; ++j) red_w[warp][m][chunk][j] = acc[m][j];
    }
  }
  __syncthreads();
  // The eight warps in order: thread o of the F_ROWS x 128 results.
  const size_t blocks = static_cast<size_t>(gridDim.x) * gridDim.y;
  const size_t slot = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const size_t zstride = blocks * F_ROWS * NT;
  float* part = p.Z == 1 ? nullptr : p.part + blockIdx.z * zstride + slot * F_ROWS * NT;
  for (int o = tid; o < rows * NT; o += F_THREADS) {
    const int m = o / NT, c = o % NT;
    float v = red_w[0][m][c / 16][c % 16];
#pragma unroll
    for (int w = 1; w < F_THREADS / 32; ++w) v += red_w[w][m][c / 16][c % 16];
    if (p.Z == 1) {
      if (n0 + c < p.N) static_cast<float*>(p.out)[static_cast<size_t>(m0 + m) * p.N + n0 + c] = v;
    } else {
      part[o] = v;
    }
  }
  if (p.Z == 1) return;
  auto sync = [] { __syncthreads(); };
  if (!arrive_last(p, static_cast<int>(slot), tid, &is_last, sync)) return;
  split_sum<float, false>(p, p.part + slot * F_ROWS * NT, zstride, rows, m0, n0, red, F_THREADS,
                          tid, sync);
}

// ------------------------------------------------------------------------
// The dequant body (prefill rows).
// ------------------------------------------------------------------------

// The dense weight [K, N] in T: a thread takes one q row (a k row, or a
// packed pair of rows) and 16 columns.
template <typename T, int BITS>
__global__ void __launch_bounds__(256) dequant_kernel(const Params p, T* w, int vec_w) {
  const int chunks = (p.N + 15) / 16;
  const int q_rows = BITS == 8 ? p.K : (p.K + 1) / 2;
  const T* s = static_cast<const T*>(p.s);
  const long long total = static_cast<long long>(q_rows) * chunks;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; c < total;
       c += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(c / chunks), n = static_cast<int>(c % chunks) * 16;
    const uint4 raw = load_q16(p.q + static_cast<size_t>(r) * p.ldq, n, p.N, p.vec_q);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(&raw);
    float v[2][16];
#pragma unroll
    for (int w4 = 0; w4 < 4; ++w4) {
      float lo[4], hi[4];
      if (BITS == 8) {
        int8x4(words[w4], lo);
      } else {
        int4x4(words[w4], lo, hi);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[0][4 * w4 + e] = lo[e];
        v[1][4 * w4 + e] = BITS == 8 ? 0.f : hi[e];
      }
    }
#pragma unroll
    for (int h = 0; h < (BITS == 8 ? 1 : 2); ++h) {
      const int k = BITS == 8 ? r : 2 * r + h;
      if (k >= p.K) break;
      float sc[16];
      load16(sc, s + static_cast<size_t>(scale_row(p, k)) * p.lds, n, p.N, p.vec_s);
      constexpr int VECS = 16 * static_cast<int>(sizeof(T)) / 16;  // 16-byte stores a row
      uint4 buf[VECS];
      T* vals = reinterpret_cast<T*>(buf);
#pragma unroll
      for (int j = 0; j < 16; ++j) vals[j] = from_f<T>(v[h][j] * sc[j]);
      T* dst = w + static_cast<size_t>(k) * p.N + n;
      if (vec_w && n + 16 <= p.N) {
#pragma unroll
        for (int i = 0; i < VECS; ++i) reinterpret_cast<uint4*>(dst)[i] = buf[i];
      } else {
        for (int j = 0; j < 16 && n + j < p.N; ++j) dst[j] = vals[j];
      }
    }
  }
}

// ------------------------------------------------------------------------
// Launches.
// ------------------------------------------------------------------------

// The most dynamic shared memory a bf16 instance takes (a scale row for
// every k of a tile), set once; a launch's own need decides its occupancy.
// The dynamic shared memory of a bf16 launch: the ring and the slack that
// aligns it to the swizzle's period.
template <int BITS, int MT> constexpr int ring_bytes(int sr) {
  return stages<BITS>() * stage_bytes<BITS, MT>(sr) + SWIZZLE;
}

template <int BITS, int MT, bool WHOLE> cudaError_t set_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_bf16_kernel<BITS, MT, WHOLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ring_bytes<BITS, MT>(BITS == 4 ? KT : 0));
  return attr;
}

template <int BITS, int MT, bool WHOLE>
cudaError_t launch_bf16(const Params& p, const Maps& maps, cudaStream_t stream) {
  const cudaError_t attr = set_smem<BITS, MT, WHOLE>();
  if (attr != cudaSuccess) return attr;
  qmm_bf16_kernel<BITS, MT, WHOLE><<<dim3((p.N + NT - 1) / NT, p.Z), THREADS,
                                     ring_bytes<BITS, MT>(p.sr), stream>>>(p, maps);
  return cudaGetLastError();
}

// Registers a thread and blocks an SM of the bf16 instance.
template <int BITS, int MT, bool WHOLE> cudaError_t info_bf16(int sr, int* regs, int* blocks) {
  const cudaError_t attr = set_smem<BITS, MT, WHOLE>();
  if (attr != cudaSuccess) return attr;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, qmm_bf16_kernel<BITS, MT, WHOLE>);
  if (err != cudaSuccess) return err;
  *regs = fa.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, qmm_bf16_kernel<BITS, MT, WHOLE>, THREADS, ring_bytes<BITS, MT>(sr));
}

template <int BITS> cudaError_t info_fp32(int* regs, int* blocks) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, qmm_fp32_kernel<BITS>);
  if (err != cudaSuccess) return err;
  *regs = fa.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, qmm_fp32_kernel<BITS>, F_THREADS,
                                                       0);
}

// The bf16 instance for M rows: MT = ceil(M / 16).
template <int BITS, bool WHOLE> cudaError_t info_rows(int M, int sr, int* regs, int* blocks) {
  switch ((M + 15) / 16) {
    case 1:
      return info_bf16<BITS, 1, WHOLE>(sr, regs, blocks);
    case 2:
      return info_bf16<BITS, 2, WHOLE>(sr, regs, blocks);
    case 3:
      return info_bf16<BITS, 3, WHOLE>(sr, regs, blocks);
    default:
      return info_bf16<BITS, 4, WHOLE>(sr, regs, blocks);
  }
}
template <int BITS, bool WHOLE>
cudaError_t launch_rows(const Params& p, const Maps& maps, cudaStream_t stream) {
  switch ((p.M + 15) / 16) {
    case 1:
      return launch_bf16<BITS, 1, WHOLE>(p, maps, stream);
    case 2:
      return launch_bf16<BITS, 2, WHOLE>(p, maps, stream);
    case 3:
      return launch_bf16<BITS, 3, WHOLE>(p, maps, stream);
    default:
      return launch_bf16<BITS, 4, WHOLE>(p, maps, stream);
  }
}

// Whether an int4 group puts every 64-row tile inside one group.
bool whole_groups(int group) { return group % KT == 0; }

template <int BITS> cudaError_t info_bits(int dtype, int M, int group, int sr, int* regs,
                                          int* blocks) {
  if (dtype == 0) return info_fp32<BITS>(regs, blocks);
  if constexpr (BITS == 8) {
    return info_rows<8, true>(M, sr, regs, blocks);
  } else {
    return whole_groups(group) ? info_rows<4, true>(M, sr, regs, blocks)
                               : info_rows<4, false>(M, sr, regs, blocks);
  }
}

template <int BITS> int stage_for(int M, int sr) {
  switch ((M + 15) / 16) {
    case 1:
      return stage_bytes<BITS, 1>(sr);
    case 2:
      return stage_bytes<BITS, 2>(sr);
    case 3:
      return stage_bytes<BITS, 3>(sr);
    default:
      return stage_bytes<BITS, 4>(sr);
  }
}

template <int BITS>
cudaError_t launch_bits(const Params& p, const Maps& maps, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    qmm_fp32_kernel<BITS><<<dim3((p.N + NT - 1) / NT, (p.M + F_ROWS - 1) / F_ROWS, p.Z),
                            F_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
  if constexpr (BITS == 8) {
    return launch_rows<8, true>(p, maps, stream);
  } else {
    return whole_groups(p.group) ? launch_rows<4, true>(p, maps, stream)
                                 : launch_rows<4, false>(p, maps, stream);
  }
}

// Tensor maps, encoded once for each (address, shape, stride, box) and
// kept: a weight's maps are made at its first launch, an activation
// buffer's at the first launch that reads it there (the caching allocator
// and the decode graphs hand the same buffers back). The encoder is the
// CUDA library's, reached through the runtime's entry-point query, so this
// library links no libcuda.
struct MapKey {
  const void* ptr;
  uint64_t cols, rows, pitch;
  uint32_t box_cols, box_rows;
  int type, swizzle;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && cols == o.cols && rows == o.rows && pitch == o.pitch &&
           box_cols == o.box_cols && box_rows == o.box_rows && type == o.type &&
           swizzle == o.swizzle;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (uint64_t v : {k.cols, k.rows, k.pitch, static_cast<uint64_t>(k.box_cols),
                       static_cast<uint64_t>(k.box_rows), static_cast<uint64_t>(k.type),
                       static_cast<uint64_t>(k.swizzle)}) {
      h ^= std::hash<uint64_t>()(v) + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
    }
    return h;
  }
};
constexpr size_t MAX_MAPS = 8192;

PFN_cuTensorMapEncodeTiled_v12000 map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
               : nullptr;
  }();
  return fn;
}

// A 2-D map of `rows` rows of `cols` elements, rows `pitch` bytes apart,
// in boxes of box_rows x box_cols; false where the encoder refuses it.
bool tensor_map(CUtensorMap* out, CUtensorMapDataType type, const void* ptr, uint64_t cols,
                uint64_t rows, uint64_t pitch, uint32_t box_cols, uint32_t box_rows,
                CUtensorMapSwizzle swizzle) {
  static std::mutex mutex;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{ptr, cols, rows, pitch, box_cols, box_rows, static_cast<int>(type),
                   static_cast<int>(swizzle)};
  std::lock_guard<std::mutex> lock(mutex);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *out = it->second;
    return true;
  }
  const PFN_cuTensorMapEncodeTiled_v12000 encode = map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(out, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  if (maps.size() >= MAX_MAPS) maps.clear();
  maps.emplace(key, *out);
  return true;
}

// The bf16 body's maps of q, x and (int4) s, where TMA takes them: every
// base 16-byte aligned and every row stride a multiple of 16 bytes.
bool make_maps(Maps* maps, const Params& p, int bits) {
  const int q_rows = bits == 8 ? p.K : (p.K + 1) / 2;
  if (!p.vec_q || !p.vec_x || (bits == 4 && !p.vec_s)) return false;
  return tensor_map(&maps->q, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, p.N, q_rows, p.ldq, NT,
                    bits == 8 ? KT : KP, CU_TENSOR_MAP_SWIZZLE_128B) &&
         tensor_map(&maps->x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, p.K, p.M,
                    static_cast<uint64_t>(p.K) * 2, KT, p.x_rows, CU_TENSOR_MAP_SWIZZLE_128B) &&
         (bits == 8 || tensor_map(&maps->s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.s, p.N, p.G,
                                  static_cast<uint64_t>(p.lds) * 2, NT, p.sr,
                                  CU_TENSOR_MAP_SWIZZLE_NONE));
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

Params make_params(int dtype, const void* x, const void* q, const void* s, void* out, int M, int K,
                   int N, int ldq, int lds, int group, int G) {
  const int elem = dtype == 0 ? 4 : 2;
  Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.s = s;
  p.out = out;
  p.part = nullptr;
  p.arrivals = nullptr;
  p.M = M;
  p.K = K;
  p.N = N;
  p.ldq = ldq;
  p.lds = lds;
  p.group = group;
  p.G = G;
  p.per = 1;
  p.Z = 1;
  p.out_f32 = 0;
  p.sr = 0;
  p.stage = 0;
  p.tiled = 0;
  p.x_rows = 0;
  p.vec_q = aligned16(q) && ldq % 16 == 0;
  p.vec_x = x != nullptr && aligned16(x) && (static_cast<long long>(K) * elem) % 16 == 0;
  p.vec_s = aligned16(s) && (static_cast<long long>(lds) * elem) % 16 == 0;
  return p;
}

bool shapes_ok(int dtype, int bits, int K, int N, int ldq, int lds, int group, int G) {
  return (dtype == 0 || dtype == 1) && (bits == 8 || bits == 4) && K > 0 && N > 0 && ldq >= N &&
         lds >= N && group > 0 && G > 0 && (G - 1) * static_cast<long long>(group) < K;
}

}  // namespace

// The fused product for M <= 64 rows. dtype: 0 = float32, 1 = bfloat16 (x,
// s and, unless out_f32, out). bits: 8 (q [K, ldq]) or 4 (q [ceil(K/2),
// ldq]); s [G, lds] with row k / group for contraction row k (int8: G = 1,
// group = K). Z splits of the contraction, `per` each: bf16 64-row tiles
// (grid: column strips x Z), fp32 q rows (grid: column strips x row groups
// of 4 x Z). With Z > 1, part is fp32 scratch of Z x (the blocks of a
// split) x (bf16: M; fp32: 4) x 128 and arrivals int32, one a block of a
// split, zero on entry and left so (ops/kernels/qmatmul.py:launch_plan).
// Returns cudaGetLastError().
extern "C" int pt_qmatmul(int dtype, int bits, int out_f32, const void* x, const void* q,
                          const void* s, void* out, void* part, void* arrivals, int M, int K,
                          int N, int ldq, int lds, int group, int G, int per, int Z,
                          void* stream) {
  if (!shapes_ok(dtype, bits, K, N, ldq, lds, group, G) || M <= 0 || M > MAX_ROWS || Z < 1 ||
      Z > 65535 || per < 1 || (dtype == 0 && !out_f32) ||
      (Z > 1 && (part == nullptr || arrivals == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(dtype, x, q, s, out, M, K, N, ldq, lds, group, G);
  p.part = static_cast<float*>(part);
  p.arrivals = static_cast<int*>(arrivals);
  p.per = per;
  p.Z = Z;
  p.out_f32 = out_f32;
  Maps maps{};
  if (dtype == 1) {
    p.sr = bits == 4 ? tile_scale_rows(group, G) : 0;
    p.stage = bits == 8 ? stage_for<8>(M, p.sr) : stage_for<4>(M, p.sr);
    p.x_rows = M <= 8 ? 8 : (M + 15) / 16 * 16;
    p.tiled = make_maps(&maps, p, bits);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bits == 8 ? launch_bits<8>(p, maps, dtype, st)
                                    : launch_bits<4>(p, maps, dtype, st));
}

// The dense weight w [K, N] (contiguous, in the dtype of s) of q and s, as
// pt_qmatmul reads them. Returns cudaGetLastError().
extern "C" int pt_qdequant(int dtype, int bits, const void* q, const void* s, void* w, int K, int N,
                           int ldq, int lds, int group, int G, void* stream) {
  if (!shapes_ok(dtype, bits, K, N, ldq, lds, group, G) || w == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(dtype, nullptr, q, s, nullptr, 0, K, N, ldq, lds, group, G);
  const int elem = dtype == 0 ? 4 : 2;
  const int vec_w = aligned16(w) && (static_cast<long long>(N) * elem) % 16 == 0;
  const long long total =
      static_cast<long long>(bits == 8 ? K : (K + 1) / 2) * ((N + 15) / 16);
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);  // then grid-stride
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (bits == 8) {
      dequant_kernel<float, 8><<<blocks, 256, 0, st>>>(p, static_cast<float*>(w), vec_w);
    } else {
      dequant_kernel<float, 4><<<blocks, 256, 0, st>>>(p, static_cast<float*>(w), vec_w);
    }
  } else if (bits == 8) {
    dequant_kernel<__nv_bfloat16, 8><<<blocks, 256, 0, st>>>(p, static_cast<__nv_bfloat16*>(w), vec_w);
  } else {
    dequant_kernel<__nv_bfloat16, 4><<<blocks, 256, 0, st>>>(p, static_cast<__nv_bfloat16*>(w), vec_w);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused kernel that M rows of this dtype launch: its registers a
// thread and the blocks an SM holds at once (bf16: with the ring this K
// and group give; the wrapper's launch plan fills the card with one wave).
extern "C" int pt_qmatmul_info(int dtype, int bits, int M, int K, int group, int* regs,
                               int* blocks) {
  if ((dtype != 0 && dtype != 1) || (bits != 8 && bits != 4) || M <= 0 || M > MAX_ROWS || K <= 0 ||
      group <= 0 || regs == nullptr || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sr = bits == 4 ? tile_scale_rows(group, (K + group - 1) / group) : 0;
  return static_cast<int>(bits == 8 ? info_bits<8>(dtype, M, group, sr, regs, blocks)
                                    : info_bits<4>(dtype, M, group, sr, regs, blocks));
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
