// Ragged paged GQA decode attention through a block table, online-softmax
// statistics — hand-written CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel pilottai_tpu/ops/pallas/paged_attention.py:_paged_kernel
// (entry point paged_decode_attention). For q [B,N,H], the page pools
// k, v [K,num_pages,P,H] (bf16, fp32, or int8 with per-token scales
// [K,num_pages,P] fp32), the block table [B,max_pages] (sentinel num_pages-1)
// and last, qpos [B]:
//
//   page jt of slot b is live iff jt < n_blocks, table[b,jt] != sentinel,
//     jt*P <= last[b] and (window <= 0 or qpos - (jt*P + P - 1) < window)
//   in a live page, key col attends row g iff col <= last[b] and
//     (window <= 0 or qpos + (g mod q_blocks) - col < window)
//   logits = (q . k) * scale, tanh soft-cap when softcap > 0; int8 pools
//     are dequantised as k*ks and v*vs, with q in fp32
//   m = running max (NEG_INF = -2^30 while nothing attended); p = exp(s - m),
//     0 while m is NEG_INF; corr = exp(m_old - m_new), 0 while m_old is NEG_INF
//   l = sum p; acc = sum p(cast to the value dtype, fp32 for int8) * v (fp32)
//
// and, when a ring is given, the chunk's ring [B,K,R,H] after the last page:
// rows r <= step (and step - r < window) in the ring's (= q's) dtype. As in
// the TPU kernel, the ring gets its own (acc_r, m_r, l_r), and the two are
// merged with wa = exp(m_pages - m), wb = exp(m_r - m), m = max(m_pages, m_r)
// (wa = 0 while m_pages is NEG_INF; row `step` always attends, so m_r never
// is). The kernel returns the unnormalised (acc, m, l); the caller divides.
//
// What bounds it on an H100: HBM bytes. Every live key costs 2*H pool
// elements read for 4*H*G multiply-adds (G = N/K query rows per kv head),
// far below the card's ~295 operations per byte, so the time is the read of
// the live pages. The card reaches its memory rate only with many bytes in
// flight on every SM.
//
// The design is flash-decoding, in two launches on the caller's stream:
//
// 1. paged_split_kernel, one block per (kv head, slot, split). A split is a
//    fixed run of `pages_per_split` page slots (256 keys' worth; the wrapper's
//    split_plan), so one long slot spreads over many blocks however the
//    other slots are sized, and the grid comes from n_blocks alone: nothing
//    on the host reads `last`. One more split per (kv head, slot) runs the
//    ring. A split past last[b] writes m = NEG_INF, l = 0 and exits; a split
//    whose pages are all dead (sentinel or out of the window) stages
//    nothing and writes the same. Each block streams its live tiles of 32
//    keys through a 3-stage ring in shared memory filled with 16-byte
//    cp.async copies in the pool's own dtype, so two tiles are in flight
//    while the third is computed; rows are padded by 16 bytes so the lane
//    that owns a key reads its row without bank conflicts. Within a tile,
//    each warp owns query rows (warp w: rows w, w+4, ...): lane j scores key
//    j, the warp runs the row's online softmax with shuffles, and the PV
//    product broadcasts p_j while each lane accumulates H/32 columns, all in
//    registers. The only block barriers are the ring's, two per tile.
// 2. paged_merge_kernel, one block per (kv head, slot): the page splits'
//    (acc, m, l) merged in split order (m = max over splits, each split
//    weighted by exp(m_s - m), dead splits skipped), then the ring merged
//    with wa and wb; the splits' m and l are staged in shared memory and
//    each thread owns one (row, column) of acc. A fixed order and no
//    atomics: a repeat is bit-identical.
//
// Keys that are masked must not poison the PV sum (0 * NaN = NaN): the PV
// loop visits only the tile's staged rows and selects on p != 0 rather than
// multiplying a masked key's value by zero; scores of unstaged lanes are
// selected away before the softmax. Offsets into a pool are 64-bit.
//
// Modes: bf16 and fp32 pools (q and the ring in the pool's dtype), int8 pools
// with scales (q and the ring in bf16 or fp32), q_blocks >= 1 (speculative
// rows: row = head*q_blocks + d sits at position qpos + d), ring or none,
// window, softcap; head_dim 32, 64, 128 and, built from this source by
// paged_attention_h256.cu, 256; any page size P >= 8 (the JAX
// engine's floor: a page is walked in tiles of 32 keys, the last one of a
// page cut to what the page holds, and a page longer than a split is a
// split of its own); at most 32 query rows per kv head. The engine runs
// q_blocks > 1 on the speculative verify (engine_speculate) and int8 pools
// with the int8 KV cache (engine_kv_quantize="int8"): the decode step with
// the ring, the verify block and the paged model drafts. The dequantize-first
// algebra above is the TPU kernel's; the JAX engine's CPU path applies the
// scales after the dots instead, which differs from it only in rounding.
// At head_dim 256 (Gemma) a lane owns 8 output columns a row; with fp32 q
// (fp32 pools, or int8 pools under fp32 q) the ring is two stages deep
// (stages() below) so that q for 32 rows and the ring fit a block.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the JAX package's NEG_INF
constexpr int kMaxRows = 32;               // query rows per kv head
constexpr int TS = 32;                     // keys per tile: one warp lane per key
constexpr int NT = 128;                    // threads per block
constexpr int NW = NT / 32;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// p as the PV product sees it: rounded to the value dtype (fp32 for int8
// pools, which are dequantised to fp32).
template <typename T> __device__ __forceinline__ float round_p(float x) { return x; }
template <> __device__ __forceinline__ float round_p<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// N consecutive elements of type T from shared memory, widened to fp32:
// one vector load, or 16-byte loads for more than 16 bytes (the PV
// product's 8 fp32 columns a lane at head_dim 256).
template <typename T, int N>
__device__ __forceinline__ void load_row(const unsigned char* src, float* out) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  if constexpr (BYTES > 16) {
    static_assert(BYTES % 16 == 0, "whole 16-byte loads");
    constexpr int PER = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int i = 0; i < N; i += PER) load_row<T, PER>(src + i * sizeof(T), out + i);
  } else {
    static_assert(BYTES == 1 || BYTES == 2 || BYTES == 4 || BYTES == 8 || BYTES == 16,
                  "one vector load");
    using V = typename std::conditional<
        BYTES == 16, uint4,
        typename std::conditional<
            BYTES == 8, uint2,
            typename std::conditional<BYTES == 4, uint32_t,
                                      typename std::conditional<BYTES == 2, uint16_t,
                                                                uint8_t>::type>::type>::type>::type;
    const V raw = *reinterpret_cast<const V*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
// One 4-byte element: a page's scales start wherever P puts them.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;  // null unless the pools are int8
  const float* v_scales;
  const int32_t* table;
  const int32_t* last;
  const int32_t* qpos;
  const void* ring_k;     // null when R == 0
  const void* ring_v;
  float* acc;
  float* m;
  float* l;
  float* part_acc;        // [B, Kh, Z, G, H]: each split's acc (Z = n_split, + 1 with a ring)
  float* part_m;          // [B, Kh, Z, G]
  float* part_l;
  int N, Kh, num_pages, P, max_pages, n_blocks, q_blocks, R, ring_step, window;
  int pages_per_split, n_split, Z;
  float scale, softcap;
};

// Bytes of one staged row of H elements of T: padded by 16 so lanes that
// read neighbouring rows in 16-byte vectors fall on different banks.
template <typename T, int H> __host__ __device__ constexpr int row_bytes() {
  return H * static_cast<int>(sizeof(T)) + 16;
}

// One ring stage: K rows, V rows (TS each, row_bytes apart), then TS k
// scales and TS v scales.
template <typename TQ, typename TKV, int H> __host__ __device__ constexpr int stage_bytes() {
  constexpr int rb = row_bytes<TQ, H>() > row_bytes<TKV, H>() ? row_bytes<TQ, H>()
                                                               : row_bytes<TKV, H>();
  return 2 * TS * rb + 2 * TS * static_cast<int>(sizeof(float));
}

// Tiles in the shared-memory ring: three, or two where three stages and
// q for kMaxRows rows would pass the 227 KB a block can have (fp32 rows at
// head_dim 256: 3 x 66.8 KB + 32 KB).
template <typename TQ, typename TKV, int H> __host__ __device__ constexpr int stages() {
  return static_cast<size_t>(kMaxRows) * H * sizeof(float) + 3 * stage_bytes<TQ, TKV, H>() <=
                 227 * 1024
             ? 3
             : 2;
}

template <typename TQ, typename TKV, int H>
constexpr size_t smem_bytes(int G) {
  return static_cast<size_t>(G) * H * sizeof(float) +
         static_cast<size_t>(stages<TQ, TKV, H>()) * stage_bytes<TQ, TKV, H>();
}


// What a tile holds: `rows` keys staged from k and v (0 = a dead tile:
// nothing staged or computed), their scales (int8 pools), and win_base =
// the query position of row offset 0 minus the tile's first key column
// (key j attends row g iff j < rows and, with a window, win_base +
// (g mod q_blocks) - j < window).
struct Tile {
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  int rows;
  int win_base;
};

// Tile i of the page slots [page_lo, page_hi) of slot b: page slot
// jt = page_lo + i / tiles_per_page, keys t0 = (i % tiles_per_page) * TS on.
template <typename T, int H>
__device__ __forceinline__ Tile page_tile(const Params& p, int kh, int b, int page_lo,
                                          int page_hi, int last, int qp, int i) {
  const int tpp = (p.P + TS - 1) / TS;
  const int jt = page_lo + i / tpp;
  const int t0 = (i % tpp) * TS;
  const int j0 = jt * p.P;
  Tile t{nullptr, nullptr, nullptr, nullptr, 0, 0};
  if (jt >= page_hi || j0 + t0 > last) return t;
  const int page = p.table[static_cast<size_t>(b) * p.max_pages + jt];
  if (page == p.num_pages - 1) return t;
  if (p.window > 0 && qp - (j0 + p.P - 1) >= p.window) return t;
  const size_t row = (static_cast<size_t>(kh) * p.num_pages + page) * p.P + t0;
  t.k = static_cast<const unsigned char*>(p.k_pool) + row * H * sizeof(T);
  t.v = static_cast<const unsigned char*>(p.v_pool) + row * H * sizeof(T);
  t.ks = p.k_scales ? p.k_scales + row : nullptr;
  t.vs = p.v_scales ? p.v_scales + row : nullptr;
  t.rows = min(min(TS, p.P - t0), last - (j0 + t0) + 1);
  t.win_base = qp - (j0 + t0);
  return t;
}

// Tile i of the ring of (slot b, kv head kh): rows r0 = r_first + i*TS on,
// up to row `step`; rows before the window's start are masked by win_base.
template <typename T, int H>
__device__ __forceinline__ Tile ring_tile(const Params& p, int kh, int b, int r_first, int i) {
  const int r0 = r_first + i * TS;
  const size_t row = (static_cast<size_t>(b) * p.Kh + kh) * p.R + r0;
  Tile t;
  t.k = static_cast<const unsigned char*>(p.ring_k) + row * H * sizeof(T);
  t.v = static_cast<const unsigned char*>(p.ring_v) + row * H * sizeof(T);
  t.ks = t.vs = nullptr;
  t.rows = min(min(TS, p.R - r0), p.ring_step - r0 + 1);
  t.win_base = p.ring_step - r0;
  return t;
}

// Every thread of the block issues its share of the tile's 16-byte copies.
template <typename T, int H>
__device__ __forceinline__ void issue_tile(const Tile& t, unsigned char* stage) {
  constexpr int RB = row_bytes<T, H>();
  constexpr int CPR = H * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks per row
  static_assert(CPR >= 1, "rows copy in 16-byte chunks");
  unsigned char* sk = stage;
  unsigned char* sv = stage + TS * RB;
  float* sks = reinterpret_cast<float*>(stage + 2 * TS * RB);
  for (int idx = threadIdx.x; idx < t.rows * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * 16;
    const size_t src = static_cast<size_t>(r) * H * sizeof(T) + c;
    cp_async16(sk + r * RB + c, t.k + src);
    cp_async16(sv + r * RB + c, t.v + src);
  }
  if (t.ks != nullptr) {
    // Scales one float at a time: with P not a multiple of 4 a tile's
    // scales are not 16-byte aligned, and only the tile's own rows are read.
    for (int idx = threadIdx.x; idx < 2 * t.rows; idx += NT) {
      const int r = idx % t.rows;
      if (idx < t.rows) {
        cp_async4(sks + r, t.ks + r);
      } else {
        cp_async4(sks + TS + r, t.vs + r);
      }
    }
  }
}

// One staged tile into the warp's rows' online-softmax state. RPW: the most
// query rows a warp owns (row g = warp + NW*i).
template <typename T, typename VT, int H, int RPW>
__device__ __forceinline__ void attend_tile(const unsigned char* stage, bool scaled, int rows,
                                            int win_base, int window, int q_blocks, int G,
                                            float scale, float softcap, const float* sq,
                                            float (&m)[RPW], float (&l)[RPW],
                                            float (&acc)[RPW][H / 32]) {
  constexpr int RB = row_bytes<T, H>();
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load
  constexpr int DPL = H / 32;  // output columns per lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* sk = stage;
  const unsigned char* sv = stage + TS * RB;
  const float* sks = reinterpret_cast<const float*>(stage + 2 * TS * RB);

  // Scores: lane j owns key j (a lane past `rows` reads a stale row, whose
  // score is selected away below).
  float dot[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) dot[i] = 0.f;
  const unsigned char* krow = sk + lane * RB;
#pragma unroll 4
  for (int c = 0; c < H; c += VEC) {
    float kx[VEC];
    load_row<T, VEC>(krow + c * sizeof(T), kx);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int g = warp + NW * i;
      if (g < G) {
        const float4* qr = reinterpret_cast<const float4*>(sq + g * H + c);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 qv = qr[e];  // the same address in every lane: a broadcast
          dot[i] = fmaf(qv.x, kx[4 * e], dot[i]);
          dot[i] = fmaf(qv.y, kx[4 * e + 1], dot[i]);
          dot[i] = fmaf(qv.z, kx[4 * e + 2], dot[i]);
          dot[i] = fmaf(qv.w, kx[4 * e + 3], dot[i]);
        }
      }
    }
  }
  const float kscale = scaled && lane < rows ? sks[lane] : 1.f;
  const float vscale = scaled && lane < rows ? sks[TS + lane] : 1.f;

  float pj[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int g = warp + NW * i;
    pj[i] = 0.f;
    if (g < G) {
      float s = dot[i] * kscale * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      bool ok = lane < rows;
      if (window > 0) ok = ok && (win_base + (g % q_blocks) - lane < window);
      const float x = ok ? s : kNegInf;
      const float m_old = m[i];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = m_new > kNegInf * 0.5f ? expf(x - m_new) : 0.f;
      const float corr = m_old > kNegInf * 0.5f ? expf(m_old - m_new) : 0.f;
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= corr;
      pj[i] = round_p<VT>(p) * vscale;
    }
  }

  // PV: p_j broadcast from lane j; each lane owns columns lane*DPL on.
#pragma unroll 8
  for (int j = 0; j < rows; ++j) {
    float vx[DPL];
    load_row<T, DPL>(sv + j * RB + lane * DPL * sizeof(T), vx);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (warp + NW * i < G) {
        const float w = __shfl_sync(0xffffffffu, pj[i], j);
        if (w != 0.f) {
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(w, vx[d], acc[i][d]);
        }
      }
    }
  }
}

// Stream n_tiles tiles (tile(i) says where tile i lives, or that it is
// dead) through the STAGES-deep ring: tile i + STAGES - 1 is copied while
// tile i is computed.
template <typename T, typename VT, int H, int RPW, int STAGES, typename TileAt>
__device__ __forceinline__ void stream_tiles(TileAt tile, int n_tiles, unsigned char* ring,
                                             int stage_stride, bool scaled, const Params& p,
                                             int G, const float* sq, float (&m)[RPW],
                                             float (&l)[RPW], float (&acc)[RPW][H / 32]) {
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) {
      const Tile t = tile(i);
      if (t.rows > 0) issue_tile<T, H>(t, ring + i * stage_stride);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int nx = i + STAGES - 1;
    if (nx < n_tiles) {
      const Tile t = tile(nx);
      if (t.rows > 0) issue_tile<T, H>(t, ring + (nx % STAGES) * stage_stride);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile i has landed (this thread's copies)
    __syncthreads();              // ... and every other thread's
    const Tile t = tile(i);
    if (t.rows > 0) {
      attend_tile<T, VT, H, RPW>(ring + (i % STAGES) * stage_stride, scaled, t.rows,
                                 t.win_base, p.window, p.q_blocks, G, p.scale, p.softcap, sq,
                                 m, l, acc);
    }
    __syncthreads();  // stage i % STAGES is free for tile i + STAGES
  }
}

template <typename TQ, typename TKV, int H, int RPW>
__global__ void __launch_bounds__(NT) paged_split_kernel(const Params p) {
  using VT = typename std::conditional<std::is_same<TKV, int8_t>::value, float, TKV>::type;
  constexpr int DPL = H / 32;
  const int G = p.N / p.Kh;
  const int kh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t part = (static_cast<size_t>(b) * p.Kh + kh) * p.Z + z;
  const bool ring_split = z == p.n_split;  // only when R > 0
  const int last = p.last[b];
  const int qp = p.qpos[b];
  const int n_pages = last >= 0 ? min(p.n_blocks, last / p.P + 1) : 0;
  const int page_lo = z * p.pages_per_split;
  const int page_hi = min(page_lo + p.pages_per_split, n_pages);
  if (!ring_split && page_lo >= page_hi) {  // past last[b]: nothing to attend
    for (int g = tid; g < G; g += NT) {
      p.part_m[part * G + g] = kNegInf;
      p.part_l[part * G + g] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // [G][H] q widened to fp32
  unsigned char* ring = smem + static_cast<size_t>(G) * H * sizeof(float);
  constexpr int stride = stage_bytes<TQ, TKV, H>();
  const TQ* q = static_cast<const TQ*>(p.q) + (static_cast<size_t>(b) * p.N + kh * G) * H;
  for (int idx = tid; idx < G * H; idx += NT) sq[idx] = to_f(q[idx]);  // visible after the
                                                                        // ring's first barrier
  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  if (ring_split) {
    const int r_lo = p.window > 0 ? max(0, p.ring_step - p.window + 1) : 0;
    const int r_first = (r_lo / TS) * TS;
    const int n_tiles = (p.ring_step - r_first) / TS + 1;
    stream_tiles<TQ, TQ, H, RPW, stages<TQ, TKV, H>()>(
        [&](int i) { return ring_tile<TQ, H>(p, kh, b, r_first, i); }, n_tiles, ring, stride,
        false, p, G, sq, m, l, acc);
  } else {
    const int tpp = (p.P + TS - 1) / TS;
    stream_tiles<TKV, VT, H, RPW, stages<TQ, TKV, H>()>(
        [&](int i) { return page_tile<TKV, H>(p, kh, b, page_lo, page_hi, last, qp, i); },
        (page_hi - page_lo) * tpp, ring, stride, p.k_scales != nullptr, p, G, sq, m, l, acc);
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int g = warp + NW * i;
    if (g < G) {
      float* out = p.part_acc + (part * G + g) * H + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) out[d] = acc[i][d];
      if (lane == 0) {
        p.part_m[part * G + g] = m[i];
        p.part_l[part * G + g] = l[i];
      }
    }
  }
}

// The splits of one (kv head, slot) merged in split order, then the ring.
// The splits' m and l are staged in shared memory first; each thread then
// owns one (row, column) of acc and sums its splits' acc from device memory.
constexpr int NT_MERGE = 256;

template <int H>
__global__ void __launch_bounds__(NT_MERGE) paged_merge_kernel(const Params p) {
  const int G = p.N / p.Kh;
  const int kh = blockIdx.x, b = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * p.Kh + kh) * p.Z;
  const size_t out0 = static_cast<size_t>(b) * p.N + kh * G;
  extern __shared__ float sml[];  // [Z][G] m, then [Z][G] l
  float* sm = sml;
  float* sl = sml + p.Z * G;
  for (int idx = threadIdx.x; idx < p.Z * G; idx += NT_MERGE) {
    sm[idx] = p.part_m[base * G + idx];
    sl[idx] = p.part_l[base * G + idx];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * H; idx += NT_MERGE) {
    const int g = idx / H, h = idx % H;
    float m = kNegInf;
    for (int s = 0; s < p.n_split; ++s) m = fmaxf(m, sm[s * G + g]);
    float a = 0.f, l = 0.f;
    if (m > kNegInf * 0.5f) {
#pragma unroll 4
      for (int s = 0; s < p.n_split; ++s) {
        const float ms = sm[s * G + g];
        if (ms > kNegInf * 0.5f) {  // a dead split wrote no acc
          const float w = expf(ms - m);
          a += w * p.part_acc[((base + s) * G + g) * H + h];
          l += w * sl[s * G + g];
        }
      }
    }
    if (p.R > 0) {
      // The merge of the TPU kernel (and of engine/decode.py:_merge_stats).
      const int r = p.n_split * G + g;
      const float m_r = sm[r];
      const float m_new = fmaxf(m, m_r);
      const float wa = m > kNegInf * 0.5f ? expf(m - m_new) : 0.f;
      const float wb = m_r > kNegInf * 0.5f ? expf(m_r - m_new) : 0.f;
      a = a * wa + p.part_acc[((base + p.n_split) * G + g) * H + h] * wb;
      l = l * wa + sl[r] * wb;
      m = m_new;
    }
    p.acc[(out0 + g) * H + h] = a;
    if (h == 0) {
      p.m[out0 + g] = m;
      p.l[out0 + g] = l;
    }
  }
}

template <typename TQ, typename TKV, int H, int RPW>
cudaError_t launch_split(const Params& p, int B, cudaStream_t stream) {
  auto kern = paged_split_kernel<TQ, TKV, H, RPW>;
  // Set once per instantiation, for the most rows it takes.
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes<TQ, TKV, H>(RPW * NW)));
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(p.Kh, B, p.Z), NT, smem_bytes<TQ, TKV, H>(p.N / p.Kh), stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int H>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const cudaError_t err = p.N / p.Kh <= NW ? launch_split<TQ, TKV, H, 1>(p, B, stream)
                                           : launch_split<TQ, TKV, H, kMaxRows / NW>(p, B, stream);
  if (err != cudaSuccess) return err;
  const size_t merge_smem = 2 * static_cast<size_t>(p.Z) * (p.N / p.Kh) * sizeof(float);
  static const cudaError_t merge_attr = cudaFuncSetAttribute(
      paged_merge_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (merge_attr != cudaSuccess) return merge_attr;
  paged_merge_kernel<H><<<dim3(p.Kh, B), NT_MERGE, merge_smem, stream>>>(p);
  return cudaGetLastError();
}

// Head dims 32, 64 and 128 here; 256 in the library that
// paged_attention_h256.cu builds from this source, so that nvcc compiles
// the two halves side by side.
template <typename TQ, typename TKV>
cudaError_t dispatch_h(int H, const Params& p, int B, cudaStream_t stream) {
  switch (H) {
#ifdef PT_PAGED_HEAD_DIM_256
    case 256:
      return launch<TQ, TKV, 256>(p, B, stream);
#else
    case 32:
      return launch<TQ, TKV, 32>(p, B, stream);
    case 64:
      return launch<TQ, TKV, 64>(p, B, stream);
    case 128:
      return launch<TQ, TKV, 128>(p, B, stream);
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (with k_scales/v_scales); a float pool has q's dtype. R = 0: no
// ring. part_acc [B,Kh,Z,G,H], part_m and part_l [B,Kh,Z,G] fp32 are the
// splits' scratch, Z = ceil(n_blocks / pages_per_split) + (R > 0). All
// tensors contiguous; returns cudaGetLastError().
extern "C" int pt_paged_attention(int q_dtype, int kv_dtype, const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scales,
                                  const void* v_scales, const void* table, const void* last,
                                  const void* qpos, const void* ring_k, const void* ring_v,
                                  void* acc, void* m, void* l, void* part_acc, void* part_m,
                                  void* part_l, int B, int N, int Kh, int num_pages, int P,
                                  int H, int max_pages, int n_blocks, int pages_per_split,
                                  int q_blocks, int R, int ring_step, int window, float scale,
                                  float softcap, void* stream) {
  if (B <= 0 || Kh <= 0 || N % Kh != 0 || N / Kh > kMaxRows || q_blocks < 1 ||
      (N / Kh) % q_blocks != 0 || P < 8 || n_blocks < 1 ||
      n_blocks > max_pages || pages_per_split < 1 ||
      (R > 0 && (ring_step < 0 || ring_step >= R || q_blocks != 1)) ||
      ((kv_dtype == 2) != (k_scales != nullptr && v_scales != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.table = static_cast<const int32_t*>(table);
  p.last = static_cast<const int32_t*>(last);
  p.qpos = static_cast<const int32_t*>(qpos);
  p.ring_k = ring_k;
  p.ring_v = ring_v;
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.N = N;
  p.Kh = Kh;
  p.num_pages = num_pages;
  p.P = P;
  p.max_pages = max_pages;
  p.n_blocks = n_blocks;
  p.q_blocks = q_blocks;
  p.R = R;
  p.ring_step = ring_step;
  p.window = window;
  p.pages_per_split = pages_per_split;
  p.n_split = (n_blocks + pages_per_split - 1) / pages_per_split;
  p.Z = p.n_split + (R > 0 ? 1 : 0);
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) {
    err = dispatch_h<float, float>(H, p, B, st);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    err = dispatch_h<__nv_bfloat16, __nv_bfloat16>(H, p, B, st);
  } else if (q_dtype == 0 && kv_dtype == 2) {
    err = dispatch_h<float, int8_t>(H, p, B, st);
  } else if (q_dtype == 1 && kv_dtype == 2) {
    err = dispatch_h<__nv_bfloat16, int8_t>(H, p, B, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
