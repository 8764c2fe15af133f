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
// int4 (9.0 us), against 117 MB (35.0 us) in bf16.
//
// The design, bf16 (qmm_bf16_kernel):
//
// - The grid is (column strip, split of K). A block owns 128 output columns
//   and a run of whole 64-row tiles of K (split-K, from the wrapper's
//   split_count: as many blocks as the card holds at once, from the
//   kernel's occupancy, so that no block waits for a second wave, each
//   split at least two tiles long), so even a 1024-column matrix keeps the
//   card busy. Splits write fp32 partials; the last block of a strip to
//   arrive (an int32 counter per strip, after a __threadfence) sums them in
//   split order and writes the result, as K2 merges its splits
//   (decode_attention.cu): no float atomics, so a repeat gives the same bits.
//   Its loads are batched, four rows by eight splits in flight at once. The
//   last block resets its counter, so the counters the wrapper keeps are
//   zero between launches and a captured launch needs no memset.
// - A 4-stage ring of tiles in shared memory, filled by 16-byte cp.async
//   copies (hopper.cuh): the tile's int8 or packed int4 bytes (64 or 32 rows
//   of 128 bytes, padded so that the rows one load reads fall on distinct
//   banks) and the x rows' 64-column slice (rows past M and columns past K
//   zero-filled). Three tiles are in flight while the fourth is used; one
//   barrier a tile.
// - Each weight is dequantized once, in the registers of the one thread
//   whose mma.sync B fragment holds it (b_fragments): the warp's 32 output
//   columns are taken in a permuted order (n-tile j, column c is the
//   strip's column 4c + j), so that a thread's B columns are four
//   neighbouring bytes of a staged row and each of its B registers comes
//   from one 32-bit load per row. The weights never pass through fp32: a
//   bf16 holds every int8 and int4 value exactly, so a byte_perm puts two
//   of them (two k rows of a column) under the exponent of the bf16 128 in
//   the halves of a register, one bf16x2 FMA takes the bias off (exact) and
//   one more multiplies by the scales, which rounds q * s once, as the
//   plain version rounds it. The scales of the thread's four columns are
//   loaded once a block (int8) or when the group changes (int4, followed
//   without a division). No dequantized weight is stored, not even in
//   shared memory.
// - The product on the tensor cores, mma.sync m16n8k16 in bf16 with fp32
//   accumulators (hopper.cuh's m16n8 layout): warp w owns 32 columns (four
//   n8 tiles), every m16 tile of the M rows (MT = ceil(M / 16) <= 4, a
//   template argument) and the tile's four k16 steps; A fragments are read
//   from the staged x rows with 32-bit loads on distinct banks. x rows past
//   M are zero, so the padding rows cost tensor work only. The result's
//   columns are put back in order when they are stored.
//
// Registers: the alternative body, every product on the CUDA cores with a
// thread owning columns x rows of accumulators, needs M x 16 fp32 registers
// a thread at 16 columns (512 at M = 32) and M fp32 multiply-adds a weight
// (8 at a plain step: about 24 us for wg against its 17.5 us of bytes,
// three times that at a verify block). With the products on the tensor
// cores a thread holds MT x 16 accumulators (64 at M = 64), and the CUDA
// cores only dequantize: about two and a half operations a weight, whatever
// M is. Measured on an H100 (scripts/port_qmatmul_ab.py, PERF.md, wg at 8
// rows, its weights streamed from HBM in a CUDA graph): a first body that
// dequantized each tile into shared memory for ldmatrix, with two barriers
// a tile, took ~38 us in int8 and ~44 in int4; this one ~34 and ~36
// (torch.matmul on the bf16 weight ~43; the bytes' bound 17.6 and 9.1).
// Neither the instruction count (a third fewer here), the fp32 route's
// conversions nor a fourth stage moved it much: at ~150 registers a thread
// the card holds three blocks, 12 warps, an SM, too few to hide the
// latency of each warp's chain of loads, bf16x2 FMAs and mma.sync
// (ROADMAP B.6).
//
// fp32 (protocol-s, qmm_fp32_kernel): every product on the CUDA cores in
// full fp32, one thread a column and eight rows, the contraction walked in
// order. fp32 values have no tensor-core product of fp32 accuracy short of
// 3xTF32, and these shapes are small.
//
// Prefill rows (M > 64) take dequant_kernel instead: the weight into a dense
// T workspace, then a plain torch.matmul (ops/kernels/qmatmul.py), 2.5 to 3
// extra bytes a parameter once a prefill. The int4 unpack in plain PyTorch
// would make several temporaries of every weight; this writes one.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 128;            // output columns a block owns
constexpr int KT = 64;             // contraction rows a tile
constexpr int KP = KT / 2;         // row pairs a tile: one 32-bit word of two bf16 each
constexpr int THREADS = 128;       // four warps, 32 columns each
constexpr int STAGES = 4;          // tiles in the shared-memory ring
constexpr int ROW_WORDS = KP + 4;  // a staged x row of KT bf16 values, padded by 16 bytes
constexpr int MAX_ROWS = 64;       // rows the fused kernels take
constexpr int FP32_ROWS = 8;       // rows a thread of the fp32 kernel accumulates

struct Params {
  const void* x;        // [M, K] T, contiguous
  const int8_t* q;      // int8 [K, ldq] or packed int4 [ceil(K/2), ldq]
  const void* s;        // [G, lds] T
  void* out;            // [M, N] T, or fp32 with out_f32
  float* part;          // [Z, M, N] fp32 split partials (Z > 1)
  int* arrivals;        // [column strips] zero between launches (Z > 1)
  int M, K, N, ldq, lds, group, G, per, Z, out_f32;
  int vec_q, vec_x, vec_s;  // 16-byte vector loads are aligned
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
// Bytes between staged q rows: 128 padded so that the four rows a load
// instruction's lanes read (int8: 2t, int4: t, for t = lane % 4) fall on
// distinct banks: a stride of 36 words (int8, rows 2t) or 40 (int4, rows t).
template <int BITS> __host__ __device__ constexpr int q_row_bytes() {
  return BITS == 8 ? NT + 16 : NT + 32;
}
template <int BITS> __host__ __device__ constexpr int raw_bytes() {
  return q_tile_rows<BITS>() * q_row_bytes<BITS>();
}
template <int BITS, int MT> __host__ __device__ constexpr int stage_bytes() {
  return raw_bytes<BITS>() + MT * 16 * ROW_WORDS * 4;
}
template <int BITS, int MT> constexpr size_t smem_bytes() {
  return static_cast<size_t>(STAGES) * stage_bytes<BITS, MT>();
}

// One 16-byte chunk of the q tile: q row r (a k row, or a packed pair) from
// column n, zero outside the tensor.
__device__ __forceinline__ void stage_q(unsigned char* dst, const Params& p, int r, int rows,
                                        int n) {
  const bool in = r < rows;
  if (p.vec_q && n + 16 <= p.N) {
    cp_async16_zfill(dst, p.q + (in ? static_cast<size_t>(r) * p.ldq + n : 0), in);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        in ? load_q16(p.q + static_cast<size_t>(r) * p.ldq, n, p.N, false) : make_uint4(0, 0, 0, 0);
  }
}

// One 16-byte chunk of x: row m, columns k .. k + 7, zero outside.
__device__ __forceinline__ void stage_x(unsigned char* dst, const Params& p, int m, int k) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const bool in = m < p.M && k < p.K;
  if (!in || (p.vec_x && k + 8 <= p.K)) {
    cp_async16_zfill(dst, in ? x + static_cast<size_t>(m) * p.K + k : x, in);
  } else {
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
    const __nv_bfloat16* row = x + static_cast<size_t>(m) * p.K;
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = k + e < p.K ? row[k + e] : __float2bfloat16_rn(0.f);
  }
}

// The bf16x2 pairs (scale row ga in the low half, gb in the high) of
// columns n .. n + 3 (0 past N): int4's scales for two k rows of a column.
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

// d = a * b + c on bf16 pairs, each half rounded once to nearest even.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The B fragments of the warp's four n8 tiles for k16 step kk of the
// staged tile, dequantized in registers. The warp's 32 columns are taken in
// a permuted order: column g of n-tile j is the strip's column 4g + j, so
// that a thread (g, t)'s four B columns are the four bytes 4g .. 4g + 3 of
// a staged row, one 32-bit load a row. b[j][0] holds k 2t and 2t + 1,
// b[j][1] k 2t + 8 and 2t + 9, as mma.sync's B fragment, each weight
// round_bf16(q * s) as the plain version rounds it.
//
// int8: rows 2t and 2t + 1 (then 2t + 8 and 2t + 9) of the k16 step give a
// B register's pair of a column: the two bytes go into the halves of a
// bf16x2 by one byte_perm, and q is the bf16 128 + (q & 127) less 128 (q
// >= 0) or 256 (q < 0), both exact; one more bf16x2 FMA multiplies by the
// column's scale ``sc2`` (the same in both halves), which is
// round_bf16(q * s). No fp32 conversion: a bf16 holds every int8 exactly.
__device__ __forceinline__ void b_fragments_int8(uint32_t (&b)[4][2], const unsigned char* raw,
                                                 int kk, int col_byte, int t,
                                                 const uint32_t (&sc2)[4]) {
  constexpr int RB = q_row_bytes<8>();
  constexpr uint32_t kOne = 0x3F803F80u, kMinusZero = 0x80008000u;
  const unsigned char* base = raw + (16 * kk + 2 * t) * RB + col_byte;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(base + 8 * h * RB);
    const uint32_t hi = *reinterpret_cast<const uint32_t*>(base + (8 * h + 1) * RB);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t u = __byte_perm(lo, hi, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
      // 128 + (q & 127) in each half, and -128 or -256 by q's sign bit.
      const uint32_t q = fma_bf16x2((u & 0x007F007Fu) | 0x43004300u, kOne,
                                    (u & 0x00800080u) | 0xC300C300u);
      b[j][h] = fma_bf16x2(q, sc2[j], kMinusZero);
    }
  }
}

// int4: packed rows t and t + 4 of the k16 step, whose byte of a column is
// exactly a B register's pair (low nibble k = 2r, high k = 2r + 1). The
// two biased nibbles u (q + 8) go under the exponent of the bf16 128 in the
// two halves of a register (0x4300 | u is 128 + u), one bf16x2 FMA takes
// 136 off (q, exact), and one more multiplies by the pair's scales
// (``s01`` for k 2t and 2t + 1, ``s89`` for 2t + 8 and 2t + 9), which is
// round_bf16(q * s): the exact product rounded once. Adding -0 keeps q * s
// = +0 for q = 0, as the plain version gives it.
__device__ __forceinline__ void b_fragments_int4(uint32_t (&b)[4][2], const unsigned char* raw,
                                                 int kk, int col_byte, int t,
                                                 const uint32_t (&s01)[4],
                                                 const uint32_t (&s89)[4]) {
  constexpr int RB = q_row_bytes<4>();
  constexpr uint32_t kOne = 0x3F803F80u, kMinus136 = 0xC308C308u, kMinusZero = 0x80008000u;
  const unsigned char* base = raw + (8 * kk + t) * RB + col_byte;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(base + 4 * h * RB) ^ 0x88888888u;
    const uint32_t lo = x & 0x0F0F0F0Fu, hi = (x >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // half 0 <- lo's byte j, half 1 <- hi's byte j, each under 0x4300.
      const uint32_t u = __byte_perm(lo, hi, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
      const uint32_t q = fma_bf16x2((u & 0x000F000Fu) | 0x43004300u, kOne, kMinus136);
      b[j][h] = fma_bf16x2(q, h ? s89[j] : s01[j], kMinusZero);
    }
  }
}

template <typename OutT>
__device__ __forceinline__ void store_out(const Params& p, int m, int n, float v) {
  static_cast<OutT*>(p.out)[static_cast<size_t>(m) * p.N + n] = from_f<OutT>(v);
}

// Write a block's [M x 128] result, directly (one split) or through the
// partials and the last block's ordered sum.
template <typename OutT, int MT>
__device__ __forceinline__ void finish(const Params& p, float (&acc)[MT][4][4], int n0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nb = n0 + warp * 32;
  float* part = p.Z == 1 ? nullptr : p.part + static_cast<size_t>(blockIdx.y) * p.M * p.N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // Column c of n-tile nt is the strip's column 4c + nt (b_fragments).
        const int m = 16 * mt + g + 8 * (i >> 1), n = nb + 4 * (2 * t + (i & 1)) + nt;
        if (m < p.M && n < p.N) {
          if (part == nullptr) {
            store_out<OutT>(p, m, n, acc[mt][nt][i]);
          } else {
            part[static_cast<size_t>(m) * p.N + n] = acc[mt][nt][i];
          }
        }
      }
    }
  }
  if (part == nullptr) return;
  __threadfence();  // this block's partials are visible device-wide ...
  __syncthreads();
  __shared__ int is_last;
  int* arrived = p.arrivals + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(arrived, 1) == p.Z - 1;  // ... before its arrival counts
  __syncthreads();
  if (!is_last) return;
  __threadfence();  // every split's partials are visible to this block
  if (tid == 0) *arrived = 0;
  // Thread t sums column n0 + t of every row, the splits in order. The
  // partials are read through L2 (another SM wrote them), RB rows by ZB
  // splits at a time, all in flight together: one L2 round trip for each
  // RB x ZB partials rather than one for each.
  constexpr int RB = 4, ZB = 8;
  const int n = n0 + tid;
  if (n >= p.N) return;
  const size_t plane = static_cast<size_t>(p.M) * p.N;
  for (int m0 = 0; m0 < p.M; m0 += RB) {
    float sum[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) sum[r] = 0.f;
    for (int z0 = 0; z0 < p.Z; z0 += ZB) {
      float v[RB][ZB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int i = 0; i < ZB; ++i) {
          const bool in = m0 + r < p.M && z0 + i < p.Z;
          v[r][i] = in ? __ldcg(p.part + (z0 + i) * plane + static_cast<size_t>(m0 + r) * p.N + n)
                       : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int i = 0; i < ZB; ++i) {
          if (z0 + i < p.Z) sum[r] += v[r][i];  // split order
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (m0 + r < p.M) store_out<OutT>(p, m0 + r, n, sum[r]);
    }
  }
}

template <int BITS, int MT>
__global__ void __launch_bounds__(THREADS) qmm_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STRIDE = stage_bytes<BITS, MT>();
  constexpr int QR = q_tile_rows<BITS>();
  constexpr int RB = q_row_bytes<BITS>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * NT;
  const int k_tiles = (p.K + KT - 1) / KT;
  const int t_begin = blockIdx.y * p.per;
  const int n_tiles = max(0, min(k_tiles, t_begin + p.per) - t_begin);
  const int q_rows = BITS == 8 ? p.K : (p.K + 1) / 2;
  // The thread's four B columns (b_fragments): bytes 4g .. 4g + 3 of the
  // warp's 32.
  const int col_byte = warp * 32 + 4 * g;
  const int ncol = n0 + col_byte;
  // Their scales: int8 one row for every k, loaded once; int4 the group of
  // each k16 step, followed without a division in the loop (``g_cur`` the
  // group of the step's first row, ``next_b`` the next group's first row;
  // ``g_at`` the group whose pairs are loaded, -1 for none).
  uint32_t s01[4], s89[4];
  int g_cur = 0, next_b = 0, g_at = -1;
  if (BITS == 8) {
    load_scale_pairs(s01, p, 0, 0, ncol);
  } else {
    g_cur = t_begin * KT / p.group;
    next_b = (g_cur + 1) * p.group;
  }

  auto issue = [&](int i) {
    unsigned char* raw = smem + (i % STAGES) * STRIDE;
    unsigned char* xs = raw + raw_bytes<BITS>();
    const int k0 = (t_begin + i) * KT;
    const int r0 = BITS == 8 ? k0 : k0 / 2;
    for (int c = tid; c < QR * 8; c += THREADS) {
      const int r = c >> 3, cc = c & 7;
      stage_q(raw + r * RB + cc * 16, p, r0 + r, q_rows, n0 + cc * 16);
    }
    for (int c = tid; c < MT * 16 * 8; c += THREADS) {
      const int m = c >> 3, cc = c & 7;
      stage_x(xs + m * ROW_WORDS * 4 + cc * 16, p, m, k0 + cc * 8);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();              // ... every thread's; every read of tile i - 1 is done
    if (i + STAGES - 1 < n_tiles) issue(i + STAGES - 1);
    cp_async_commit();
    const unsigned char* raw = smem + (i % STAGES) * STRIDE;
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(raw + raw_bytes<BITS>());
    const int k0 = (t_begin + i) * KT;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t b[4][2];
      if (BITS == 8) {
        b_fragments_int8(b, raw, kk, col_byte, t, s01);
      } else {
        const int kb = k0 + 16 * kk;
        while (kb >= next_b) {
          ++g_cur;
          next_b += p.group;
        }
        if (kb + 15 < next_b) {  // the k16 step inside one group: one scale row
          const int gr = min(g_cur, p.G - 1);
          if (gr != g_at) {
            load_scale_pairs(s01, p, gr, gr, ncol);
#pragma unroll
            for (int j = 0; j < 4; ++j) s89[j] = s01[j];
            g_at = gr;
          }
        } else {  // a group boundary inside the step: each k's own row
          load_scale_pairs(s01, p, scale_row(p, kb + 2 * t), scale_row(p, kb + 2 * t + 1), ncol);
          load_scale_pairs(s89, p, scale_row(p, kb + 2 * t + 8), scale_row(p, kb + 2 * t + 9),
                           ncol);
          g_at = -1;
        }
        b_fragments_int4(b, raw, kk, col_byte, t, s01, s89);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* r0 = xs + (16 * mt + g) * ROW_WORDS + 8 * kk + t;
        const uint32_t* r8 = r0 + 8 * ROW_WORDS;
        const uint32_t a[4] = {r0[0], r8[0], r0[4], r8[4]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  if (p.out_f32) {
    finish<float, MT>(p, acc, n0);
  } else {
    finish<__nv_bfloat16, MT>(p, acc, n0);
  }
}

// fp32: thread n of the strip, rows m0 .. m0 + 7, the contraction in order.
template <int BITS>
__global__ void __launch_bounds__(128) qmm_fp32_kernel(const Params p) {
  const int n = blockIdx.x * 128 + threadIdx.x;
  const int m0 = blockIdx.y * FP32_ROWS;
  if (n >= p.N) return;
  const float* x = static_cast<const float*>(p.x);
  const float* s = static_cast<const float*>(p.s);
  const int rows = min(FP32_ROWS, p.M - m0);
  float acc[FP32_ROWS];
#pragma unroll
  for (int r = 0; r < FP32_ROWS; ++r) acc[r] = 0.f;
  for (int k = 0; k < p.K; ++k) {
    int v;
    if (BITS == 8) {
      v = p.q[static_cast<size_t>(k) * p.ldq + n];
    } else {
      const int b = p.q[static_cast<size_t>(k >> 1) * p.ldq + n];
      v = (k & 1) ? (b >> 4) : (((b & 0xF) ^ 8) - 8);
    }
    const float w = static_cast<float>(v) * s[static_cast<size_t>(scale_row(p, k)) * p.lds + n];
#pragma unroll
    for (int r = 0; r < FP32_ROWS; ++r) {
      if (r < rows) acc[r] = fmaf(__ldg(x + static_cast<size_t>(m0 + r) * p.K + k), w, acc[r]);
    }
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int r = 0; r < FP32_ROWS; ++r) {
    if (r < rows) out[static_cast<size_t>(m0 + r) * p.N + n] = acc[r];
  }
}

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

template <int BITS, int MT> cudaError_t set_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_bf16_kernel<BITS, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<BITS, MT>()));
  return attr;
}

template <int BITS, int MT>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const cudaError_t attr = set_smem<BITS, MT>();
  if (attr != cudaSuccess) return attr;
  qmm_bf16_kernel<BITS, MT><<<dim3((p.N + NT - 1) / NT, p.Z), THREADS, smem_bytes<BITS, MT>(),
                              stream>>>(p);
  return cudaGetLastError();
}

template <int BITS, int MT> cudaError_t occupancy(int* blocks) {
  const cudaError_t attr = set_smem<BITS, MT>();
  if (attr != cudaSuccess) return attr;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, qmm_bf16_kernel<BITS, MT>, THREADS,
                                                       smem_bytes<BITS, MT>());
}

template <int BITS> cudaError_t occupancy_bits(int M, int* blocks) {
  switch ((M + 15) / 16) {
    case 1:
      return occupancy<BITS, 1>(blocks);
    case 2:
      return occupancy<BITS, 2>(blocks);
    case 3:
      return occupancy<BITS, 3>(blocks);
    default:
      return occupancy<BITS, 4>(blocks);
  }
}

template <int BITS>
cudaError_t launch_bits(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    qmm_fp32_kernel<BITS><<<dim3((p.N + 127) / 128, (p.M + FP32_ROWS - 1) / FP32_ROWS), 128, 0,
                            stream>>>(p);
    return cudaGetLastError();
  }
  switch ((p.M + 15) / 16) {
    case 1:
      return launch_bf16<BITS, 1>(p, stream);
    case 2:
      return launch_bf16<BITS, 2>(p, stream);
    case 3:
      return launch_bf16<BITS, 3>(p, stream);
    default:
      return launch_bf16<BITS, 4>(p, stream);
  }
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
// group = K). bf16 only: Z splits of `per` 64-row tiles each; with Z > 1,
// part is fp32 scratch of Z*M*N and arrivals int32 [ceil(N/128)], zero on
// entry and left so. Returns cudaGetLastError().
extern "C" int pt_qmatmul(int dtype, int bits, int out_f32, const void* x, const void* q,
                          const void* s, void* out, void* part, void* arrivals, int M, int K,
                          int N, int ldq, int lds, int group, int G, int per, int Z,
                          void* stream) {
  if (!shapes_ok(dtype, bits, K, N, ldq, lds, group, G) || M <= 0 || M > MAX_ROWS || Z < 1 ||
      Z > 65535 || per < 1 || (dtype == 0 && (Z != 1 || !out_f32)) ||
      (Z > 1 && (part == nullptr || arrivals == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(dtype, x, q, s, out, M, K, N, ldq, lds, group, G);
  p.part = static_cast<float*>(part);
  p.arrivals = static_cast<int*>(arrivals);
  p.per = per;
  p.Z = Z;
  p.out_f32 = out_f32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bits == 8 ? launch_bits<8>(p, dtype, st) : launch_bits<4>(p, dtype, st));
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

// Blocks of the bf16 fused kernel an SM holds at once for M rows (the
// wrapper's split count fills the card with one wave of them).
extern "C" int pt_qmatmul_blocks_per_sm(int bits, int M, int* blocks) {
  if ((bits != 8 && bits != 4) || M <= 0 || M > MAX_ROWS || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(bits == 8 ? occupancy_bits<8>(M, blocks)
                                    : occupancy_bits<4>(M, blocks));
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
