// The integer-operand quantized product (PILOTTAI_QMATMUL=native), int8
// and packed int4 weights — hand-written CUDA for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's models/qmatmul.py:
// _native_int8_matmul leaves this arm to XLA (an int8 dot_general into int32,
// a grouped one for int4, the scales after). Two kernels compute exactly
// ops/kernels/int8_matmul.py:native_matmul_plain:
//
//   sx[m]     = max(max_k |x[m][k]|, 1e-8) * fp32(1/127)
//   xq[m][k]  = clamp(rint(x[m][k] / sx[m]), -127, 127)              int8
//   int8:  y[m][n] = (float(sum_k xq[m][k] q[k][n]) * sx[m]) * s[0][n]
//   int4:  y[m][n] = (sum_g float(acc_g[m][n]) * s[g][n]) * sx[m],
//          acc_g = sum over group g's rows of xq * q, the groups summed in
//          XLA's order: at most 32 groups, one fmaf a group in index order;
//          more, the products rounded and added in windows of 32 groups (the
//          group axis padded with zero groups, `lead` of them before the
//          first), each window in order, then the windows in order.
//
// The int32 sums are exact, so the fp32 result equals the plain version's
// bit for bit, and a bf16 result after its one rounding. Every fp32
// operation of the epilogue is an explicit __fmul_rn, __fadd_rn or
// __fmaf_rn, so nvcc cannot contract or reorder it.
//
// quantize_kernel: one block of 256 threads a row (rows padded to the
// product's row tile with zeros): the row's amax by a warp-shuffle and
// shared-memory max, then xq written zero-padded to kx columns (whole k32
// steps; int4 whole scale groups) and sx. Its workspace comes from the
// caching allocator, so both launches can be captured in a CUDA graph.
//
// int8_mma_kernel: a block is one warp (up to 64 rows) or four; each warp
// owns 32 output columns and every m16 tile of the block's 16 * MT rows,
// and walks all of the contraction in k32 steps of mma.sync.m16n8k32 s8 x
// s8 -> s32.
//
// - The weights lie K by N, N contiguous; the s8 mma wants each B column's
//   four k values in one register. The warp's 32 columns are taken in a
//   permuted order (n-tile j, column c is the warp's column 4c + j), so a
//   thread's B columns in its four n-tiles are four neighbouring bytes of a
//   weight row: it loads one 32-bit word from each of its four k rows and
//   transposes the 4 x 4 bytes with eight byte_perms (int8). int4 loads two
//   words of packed rows, spreads the nibbles to bytes as 16 times their
//   value (a shift and two masks: the sign stays in the byte's top bit),
//   interleaves them with the same eight byte_perms, and takes the int32
//   sum back down by an exact arithmetic shift of 4.
// - The A fragments are 32-bit loads of xq straight from global memory (the
//   warps of a block read the same rows, through L1). No shared memory,
//   no second copy of any weight: the weight bytes are read once a row tile.
// - A warp issues the loads of U k32 steps (8 at one m16 tile a warp, 4 at
//   two, 2 at four) before their products, so that U steps of bytes are in
//   flight: one step at a time left a block waiting a memory latency a
//   step (0.2 ms for wq at 8 rows, 40x its byte bound). A step wholly
//   inside the weight loads its words at offsets fixed before the walk,
//   with no bounds checks: computing each word's address and bounds took
//   about 20 instructions a load, and a decode step's single warp an SM
//   could not hide their latency.
// - What bounds it: at decode rows (8) the weight bytes, as for the
//   dequant arm's kernel, and with one warp of 32 columns walking all of K
//   a small N leaves most of the card idle (wk of llama3-8b: 32 warps); at
//   the admission's 2048 rows the tensor cores, reached here only through
//   mma.sync from registers, with every column strip reading its rows of
//   xq again through L2. A simple kernel that is right: wgmma on K-major
//   tiles, split-K, the quantizer fused into the norm before it and one
//   launch for products that share their input are ROADMAP's B.7.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QUANT_THREADS = 256;
constexpr int WINDOW = 32;             // XLA's tree-reduction window

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// The row quantizer
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_kernel(const T* __restrict__ x, long long ldx, int M, int K, int kx,
                int8_t* __restrict__ xq, float* __restrict__ sx) {
  const int m = blockIdx.x;
  int8_t* out = xq + static_cast<long long>(m) * kx;
  if (m >= M) {  // a padding row of the product's row tile
    for (int k = threadIdx.x; k < kx; k += QUANT_THREADS) out[k] = 0;
    if (threadIdx.x == 0) sx[m] = 0.f;
    return;
  }
  const T* row = x + static_cast<long long>(m) * ldx;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += QUANT_THREADS) {
    amax = fmaxf(amax, fabsf(to_float(row[k])));
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  __shared__ float warp_max[QUANT_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < QUANT_THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  // max(amax, 1e-8) / 127 as XLA compiles it: a product with fp32(1/127).
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), static_cast<float>(1.0 / 127.0));
  for (int k = threadIdx.x; k < kx; k += QUANT_THREADS) {
    int8_t v = 0;
    if (k < K) {
      const float r = rintf(__fdiv_rn(to_float(row[k]), s));  // half to even
      v = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
    }
    out[k] = v;
  }
  if (threadIdx.x == 0) sx[m] = s;
}

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

struct Args {
  const int8_t* xq;   // [rows, kx] int8, zero-padded
  const float* sx;    // [rows]
  const int8_t* q;    // int8 [K, N] or packed int4 [ceil(K/2), N], rows ldq apart
  const void* s;      // scales [G, N] in T, rows lds apart
  void* out;          // [M, N], T or fp32
  int M, N, ldq, lds, q_rows, kx, steps, G, lead, out_f32, vec;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four bytes of a weight row at columns col..col+3, zeros beyond N or
// beyond the weight's rows. VEC (the base, the rows and N multiples of 4
// bytes): one 32-bit load; else four byte loads. No branch: a load out of
// bounds reads the weight's first byte instead and its value is dropped, so
// that the compiler can issue every load of a step's batch before any is
// used.
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const Args& a, int row, int col) {
  const bool in = row < a.q_rows;
  const int8_t* p = a.q + (in ? static_cast<long long>(row) * a.ldq : 0);
  if (VEC) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(p + (col < a.N ? col : 0)));
    return in && col < a.N ? w : 0u;
  }
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = in && col + j < a.N;
    const uint32_t b = static_cast<uint8_t>(__ldg(p + (ok ? col + j : 0)));
    w |= (ok ? b : 0u) << (8 * j);
  }
  return w;
}

// Rows r0..r3 (bytes j = column col + j) to the four n-tiles' B registers:
// b[j] = { r0_j, r1_j, r2_j, r3_j }.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t (&b)[4]) {
  const uint32_t a01 = __byte_perm(r0, r1, 0x5140);  // r0_0 r1_0 r0_1 r1_1
  const uint32_t b01 = __byte_perm(r0, r1, 0x7362);  // r0_2 r1_2 r0_3 r1_3
  const uint32_t a23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t b23 = __byte_perm(r2, r3, 0x7362);
  b[0] = __byte_perm(a01, a23, 0x5410);
  b[1] = __byte_perm(a01, a23, 0x7632);
  b[2] = __byte_perm(b01, b23, 0x5410);
  b[3] = __byte_perm(b01, b23, 0x7632);
}

// Weight words a thread loads for one k32 step.
template <int BITS>
constexpr int B_WORDS = BITS == 8 ? 8 : 4;

// The words of a k32 step at k0: int8, k rows k0 + 4t + r and k0 + 16 + 4t
// + r (r < 4); int4, packed rows k0/2 + 2t, + 1 (k rows k0 + 4t .. + 3) and
// the same 8 packed rows on (k0 + 16 + 4t ..).
template <int BITS, bool VEC>
__device__ __forceinline__ void b_load(const Args& a, int k0, int t, int col,
                                       uint32_t (&w)[B_WORDS<BITS>]) {
  if (BITS == 8) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      w[r] = load_word<VEC>(a, k0 + 4 * t + r, col);
      w[4 + r] = load_word<VEC>(a, k0 + 16 + 4 * t + r, col);
    }
  } else {
    const int r = k0 / 2 + 2 * t;
    w[0] = load_word<VEC>(a, r, col);
    w[1] = load_word<VEC>(a, r + 1, col);
    w[2] = load_word<VEC>(a, r + 8, col);
    w[3] = load_word<VEC>(a, r + 9, col);
  }
}

// Those words as the B registers of the step's two k16 halves (int4: each
// nibble as a byte of 16 times its value).
template <int BITS>
__device__ __forceinline__ void b_frags(const uint32_t (&w)[B_WORDS<BITS>], uint32_t (&lo)[4],
                                        uint32_t (&hi)[4]) {
  if (BITS == 8) {
    transpose4(w[0], w[1], w[2], w[3], lo);
    transpose4(w[4], w[5], w[6], w[7], hi);
  } else {
    constexpr uint32_t HI = 0xF0F0F0F0u;
    transpose4((w[0] << 4) & HI, w[0] & HI, (w[1] << 4) & HI, w[1] & HI, lo);
    transpose4((w[2] << 4) & HI, w[2] & HI, (w[3] << 4) & HI, w[3] & HI, hi);
  }
}

template <typename T>
__device__ __forceinline__ void store(const Args& a, int m, int n, float v) {
  if (m >= a.M || n >= a.N) return;
  const long long i = static_cast<long long>(m) * a.N + n;
  if (a.out_f32) {
    static_cast<float*>(a.out)[i] = v;
  } else if constexpr (sizeof(T) == 2) {
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(a.out)[i] = v;
  }
}

// This thread's eight scales of group grp (its columns of the four
// n-tiles; a column beyond N reads column 0, its product is never stored).
template <typename T>
__device__ __forceinline__ void load_scales(const Args& a, const T* s, int grp, int t, int n_warp,
                                            T (&raw)[4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n_warp + 4 * (2 * t + e) + j;
      raw[j][e] = __ldg(s + static_cast<long long>(grp) * a.lds + (n < a.N ? n : 0));
    }
  }
}

// The end of int4 scale group grp: its int32 sums (16 times the products:
// the nibbles were held as 16 q) times the group's scales (raw, loaded a
// group ahead so that the walk does not wait for them), into the fp32
// sum: one fmaf (MODE 1), or a product rounded and added to the window's
// sum, the window added to the total where it closes (MODE 2).
template <typename T, int MT, int MODE>
__device__ __forceinline__ void group_end(const Args& a, const T (&raw)[4][2], int grp,
                                          int (&acc)[MT][4][4], float (&total)[MT][4][4],
                                          float (&win)[MODE == 2 ? MT : 1][4][4]) {
  float sc[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) sc[j][e] = to_float(raw[j][e]);
  }
  const bool closes = MODE == 2 && (((grp + a.lead) % WINDOW) == WINDOW - 1 || grp == a.G - 1);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = __int2float_rn(acc[i][j][c] >> 4);
        acc[i][j][c] = 0;
        if (MODE == 1) {
          total[i][j][c] = __fmaf_rn(v, sc[j][c & 1], total[i][j][c]);
        } else {
          float& w = win[MODE == 2 ? i : 0][j][c];
          w = __fadd_rn(w, __fmul_rn(v, sc[j][c & 1]));
          if (closes) {
            total[i][j][c] = __fadd_rn(total[i][j][c], w);
            w = 0.f;
          }
        }
      }
    }
  }
}

// MT m16 tiles a warp; BITS 8 or 4; MODE 0 int8, 1 int4 one fmaf a group,
// 2 int4 in windows of groups; WB warps a block, 32 columns each; VEC the
// weight's 32-bit loads.
template <typename T, int MT, int BITS, int MODE, int WB, bool VEC>
__global__ void __launch_bounds__(32 * WB)
int8_mma_kernel(const Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_warp = (blockIdx.x * WB + warp) * 32;  // the warp's first column
  const int col = n_warp + 4 * g;                  // the thread's B columns col..col+3
  const int m0 = blockIdx.y * 16 * MT;
  const T* s = static_cast<const T*>(a.s);

  int acc[MT][4][4];
  [[maybe_unused]] float total[MT][4][4];
  [[maybe_unused]] float win[MODE == 2 ? MT : 1][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][j][c] = 0;
        total[i][j][c] = 0.f;
        if (MODE == 2) win[MODE == 2 ? i : 0][j][c] = 0.f;
      }
    }
  }
  // This thread's A rows: m0 + 16 i + g and + 8.
  const int8_t* xrow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) xrow[i] = a.xq + static_cast<long long>(m0 + 16 * i + g) * a.kx;
  const long long row8 = 8LL * a.kx;
  // The weight rows of a step that lies wholly inside q (VEC): this
  // thread's words at fixed offsets from the step's first row, a column
  // beyond N reading column 0 and masked to zero. Steps past full_steps (a
  // short tail, int4's padded groups) take load_word's bounds checks.
  constexpr int STEP_ROWS = BITS == 8 ? 32 : 16;  // q rows a k32 step
  const int full_steps = VEC ? a.q_rows / STEP_ROWS : 0;
  const uint32_t col_mask = col < a.N ? 0xFFFFFFFFu : 0u;
  const int8_t* q_col = a.q + (col < a.N ? col : 0);
  int roff[B_WORDS<BITS>];
#pragma unroll
  for (int w = 0; w < B_WORDS<BITS>; ++w) {
    const int r = BITS == 8 ? (w < 4 ? 4 * t + w : 16 + 4 * t + (w - 4))
                            : 2 * t + (w & 1) + (w < 2 ? 0 : 8);
    roff[w] = r * a.ldq;
  }

  // The walk: U k32 steps at a time, every load of the U steps issued
  // before their products, so that U steps of bytes are in flight a warp.
  // The order of the sums is the plain version's: each group's int32 sum,
  // then the group's end in index order.
  constexpr int U = MT == 1 ? 8 : MT == 2 ? 4 : 2;
  const int n_steps = a.G * a.steps;
  [[maybe_unused]] T sc_raw[4][2];
  if (MODE != 0) load_scales<T>(a, s, 0, t, n_warp, sc_raw);
  for (int s0 = 0; s0 < n_steps; s0 += U) {
    uint32_t bw[U][B_WORDS<BITS>];
    uint32_t aw[U][MT][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < n_steps) {
        const int k0 = (s0 + u) * 32;
        if (s0 + u < full_steps) {
          const int8_t* q_step = q_col + static_cast<long long>(s0 + u) * STEP_ROWS * a.ldq;
#pragma unroll
          for (int w = 0; w < B_WORDS<BITS>; ++w) {
            bw[u][w] = __ldg(reinterpret_cast<const uint32_t*>(q_step + roff[w]));
          }
        } else {
          b_load<BITS, VEC>(a, k0, t, col, bw[u]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int8_t* xr = xrow[i] + k0 + 4 * t;
          aw[u][i][0] = __ldg(reinterpret_cast<const uint32_t*>(xr));
          aw[u][i][1] = __ldg(reinterpret_cast<const uint32_t*>(xr + row8));
          aw[u][i][2] = __ldg(reinterpret_cast<const uint32_t*>(xr + 16));
          aw[u][i][3] = __ldg(reinterpret_cast<const uint32_t*>(xr + row8 + 16));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int step = s0 + u;
      if (step < n_steps) {
        // Columns beyond N masked here, not at the load: an operation on a
        // loaded word makes the warp wait for it, one latency a step.
#pragma unroll
        for (int w = 0; w < B_WORDS<BITS>; ++w) bw[u][w] &= col_mask;
        uint32_t blo[4], bhi[4];
        b_frags<BITS>(bw[u], blo, bhi);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], aw[u][i], blo[j], bhi[j]);
        }
        if (MODE != 0 && (step + 1) % a.steps == 0) {
          const int grp = step / a.steps;
          group_end<T, MT, MODE>(a, sc_raw, grp, acc, total, win);
          if (grp + 1 < a.G) load_scales<T>(a, s, grp + 1, t, n_warp, sc_raw);
        }
      }
    }
  }

  // Epilogue: accumulator c of n-tile j is row g (c < 2) or g + 8, column
  // 2t + (c & 1) of the tile, the warp's column 4 (2t + (c & 1)) + j.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * i + g + 8 * h;
      const float xs = a.sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * h + e;
          const int n = n_warp + 4 * (2 * t + e) + j;
          float v;
          if (MODE == 0) {
            const float ws = n < a.N ? to_float(s[n]) : 0.f;
            v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][c]), xs), ws);
          } else {
            v = __fmul_rn(total[i][j][c], xs);
          }
          store<T>(a, m, n, v);
        }
      }
    }
  }
}

template <typename T, int MT, int BITS, int MODE, int WB>
cudaError_t launch(const Args& a, int M, cudaStream_t st) {
  const dim3 grid((a.N + 32 * WB - 1) / (32 * WB), (M + 16 * MT - 1) / (16 * MT));
  if (a.vec) {
    int8_mma_kernel<T, MT, BITS, MODE, WB, true><<<grid, 32 * WB, 0, st>>>(a);
  } else {
    int8_mma_kernel<T, MT, BITS, MODE, WB, false><<<grid, 32 * WB, 0, st>>>(a);
  }
  return cudaGetLastError();
}

// The plans the wrapper makes (ops/kernels/int8_matmul.py:launch_plan):
// up to 64 rows one warp a block, so that a decode step's few column
// strips spread over as many SMs; more rows four warps, which share their
// rows of xq through L1.
template <typename T, int BITS, int MODE>
cudaError_t launch_tiles(const Args& a, int M, int mt, int warps, cudaStream_t st) {
  if (warps == 1 && mt == 1) return launch<T, 1, BITS, MODE, 1>(a, M, st);
  if (warps == 1 && mt == 2) return launch<T, 2, BITS, MODE, 1>(a, M, st);
  if constexpr (BITS == 8) {
    if (warps == 1 && mt == 4) return launch<T, 4, BITS, MODE, 1>(a, M, st);
    if (warps == 4 && mt == 4) return launch<T, 4, BITS, MODE, 4>(a, M, st);
  } else {
    if (warps == 4 && mt == 2) return launch<T, 2, BITS, MODE, 4>(a, M, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dtype(const Args& a, int M, int bits, int mt, int mode, int warps,
                         cudaStream_t st) {
  if (bits == 8 && mode == 0) return launch_tiles<T, 8, 0>(a, M, mt, warps, st);
  if (bits == 4 && mode == 1) return launch_tiles<T, 4, 1>(a, M, mt, warps, st);
  if (bits == 4 && mode == 2) return launch_tiles<T, 4, 2>(a, M, mt, warps, st);
  return cudaErrorInvalidValue;
}

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; }

}  // namespace

extern "C" const char* pt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x [M, K] (rows ldx elements apart; dtype 0 fp32, 1 bf16) into xq [rows,
// kx] int8 and sx [rows] fp32, rows >= M and kx >= K (zeros beyond x).
// Returns cudaGetLastError().
extern "C" int pt_quantize_rows(int dtype, const void* x, long long ldx, int M, int rows, int K,
                                int kx, void* xq, void* sx, void* stream) {
  if (M < 1 || rows < M || K < 1 || kx < K || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    quantize_kernel<float><<<rows, QUANT_THREADS, 0, st>>>(
        static_cast<const float*>(x), ldx, M, K, kx, static_cast<int8_t*>(xq),
        static_cast<float*>(sx));
  } else {
    quantize_kernel<__nv_bfloat16><<<rows, QUANT_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, M, K, kx, static_cast<int8_t*>(xq),
        static_cast<float*>(sx));
  }
  return static_cast<int>(cudaGetLastError());
}

// The product of pt_quantize_rows's xq and sx (rows a multiple of 16 mt,
// kx of 32, int4's kx = G * steps * 32) with q and s, blocks of `warps`
// warps. out [M, N] in the dtype (out_f32 = 0) or fp32. Returns
// cudaGetLastError().
extern "C" int pt_int8_matmul(int dtype, int bits, int out_f32, int mt, int mode, int warps,
                              const void* xq,
                              const void* sx, const void* q, const void* s, void* out, int M,
                              int N, int ldq, int lds, int q_rows, int kx, int steps, int G,
                              int lead, void* stream) {
  if (M < 1 || N < 1 || steps < 1 || G < 1 || kx != G * steps * 32 || kx % 32 != 0 ||
      (dtype != 0 && dtype != 1) || !aligned4(xq) || (bits == 8 && G != 1) ||
      (mode == 2 && G > WINDOW * WINDOW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
         static_cast<const int8_t*>(q), s, out, M, N, ldq, lds, q_rows, kx, steps, G, lead,
         out_f32, (aligned4(q) && ldq % 4 == 0 && N % 4 == 0) ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0
                              ? launch_dtype<float>(a, M, bits, mt, mode, warps, st)
                              : launch_dtype<__nv_bfloat16>(a, M, bits, mt, mode, warps, st));
}
