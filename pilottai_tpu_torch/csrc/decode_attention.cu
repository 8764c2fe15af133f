// One-token GQA attention over the dense K-major KV cache, online-softmax
// statistics — hand-written CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel pilottai_tpu/ops/pallas/decode_attention.py:_decode_kernel
// (entry point decode_attention, return_stats=True), which is also what the
// JAX package's XLA function engine/decode.py:_prefix_stats_dense computes.
// For q [B,N,H] and the cache panels k, v [B,K,S,H]:
//
//   attend(s) = s <= last[b]  and  (window <= 0 or q_pos[b] - s < window)
//   logits = (q . k) * scale, then tanh soft-cap when softcap > 0
//   m = max over attended logits (NEG_INF = -2^30 when none)
//   p = exp(logits - m), 0 on rows whose m is NEG_INF
//   l = sum p;  acc = sum p(cast to the cache dtype) * v   (fp32)
//
// With an int8 cache (engine_kv_quantize="int8") the panels are int8 with
// fp32 scales k_scale, v_scale [B,K,S] (one per token and kv head), and
// the function is the JAX package's _prefix_stats_dense with kv_scales:
//
//   logits = ((q . k) * scale) * k_scale[s], then the soft-cap and the mask
//   m, p and l as above (l taken before the v scale)
//   acc = sum round_q(p * v_scale[s]) * v   (round_q: to q's dtype, fp32)
//
// the int8 values widened to fp32, which is exact, and q in bf16 or fp32.
// The scales enter after the dot products, so the panels stream as int8
// and nothing makes a dequantized copy of them.
//
// What bounds it on an H100: HBM bytes. Every attended key costs 2*H cache
// elements read for 4*H*G multiply-adds (G = N/K query heads per kv head),
// far below the card's ~295 operations per byte, so the least time is the
// read of the live keys. At a decode step that read is small (a few MB at
// llama3-8b's 8 slots), so what the card can reach is set by latency: how
// many blocks are in flight, and how many bytes each has on the way.
//
// The design is flash-decoding, as K3's split pass is, on the dense panel:
//
// - A grid fixed by the shapes: (kv head, slot, split). The split count Z
//   comes from B, K, S and the SM count alone (the wrapper's split_count:
//   enough blocks to cover the SMs about four times, at most one 32-key
//   tile a split), so nothing on the host reads `last` and the decode loop
//   does not synchronise. A tile's scoring and PV product are
//   latency-bound at a few warps an SM, so at the dense llama3-8b step
//   (about 7 tiles a slot) one tile a block ran faster on an H100 than
//   two, which half as many splits give. Each block computes its own range
//   on the device
//   (split_range below): the live keys [s_begin, s_end], s_begin =
//   max(0, q_pos - window + 1) under a window and 0 without, s_end =
//   min(last, S - 1), cut into Z runs of whole 32-key tiles. A long slot
//   and a short one both spread over all their blocks; a block whose run
//   is empty writes m = NEG_INF, l = 0, acc = 0.
// - The walk inside a block streams its tiles through a 3-stage ring in
//   shared memory filled with 16-byte cp.async copies in the cache's own
//   dtype (no widened staging), two tiles in flight while the third is
//   computed; rows are padded by 16 bytes, so the lane that owns a key
//   reads its row without bank conflicts. Warp g owns query row g of the
//   kv head (four warps up to G = 4, eight up to G = 8): lane j scores key
//   j against q (staged once in fp32 while the first tiles are in flight),
//   the row's online softmax runs with
//   shuffles, the scale folded into the exponent of ex2.approx, and the PV
//   product broadcasts p_j while each lane accumulates H/32 columns in
//   registers. The ring's two barriers a tile are the only block barriers.
// - The merge: each split writes its (acc, m, l) to a partials scratch and
//   counts its arrival on an int32 counter per (kv head, slot), after a
//   __threadfence(); the block that arrives last merges the splits in
//   split order (m = max m_s, weights 2^((m_s - m) log2 e), dead splits
//   skipped; warp g merges row g, every split's partial read at once),
//   writes the result and resets the counter to 0. No result
//   depends on which block arrives last and nothing is summed by atomics,
//   so a repeat is bit-identical. The merge is inside the one launch
//   rather than a second launch (K3's way) because the dense decode step
//   waits on its host: each launch costs host time, and one wrapper call
//   is one launch. With Z = 1 the block writes its result directly. The
//   counters belong to the caller (the wrapper keeps one zeroed scratch
//   per device and stream): launches sharing them must be ordered on one
//   stream, as the decode loop's are.
//
// Keys that are masked must not poison the PV sum (0 * NaN = NaN, and a
// recycled slot's stale rows may hold anything): the PV loop visits only
// the tile's staged rows and selects on p != 0 rather than multiplying a
// masked key's value by zero, and scores of unstaged lanes are selected
// away before the softmax; the merge likewise selects a split on its
// weight. Offsets into a panel are 64-bit.
//
// The int8 body is the same walk over int8 tiles: a staged row is H bytes
// (plus the 16 of padding), a lane scores a key from 16 int8 values a
// 16-byte load, and each tile's 32 k and v scales ride in the same ring
// stage, copied with 4-byte cp.async (a split's first key, and so its
// scales, need not sit on a 16-byte boundary). The key's k scale and the
// scale are applied to its dot product before the soft-cap and the max
// (so for int8 the max is kept in logits, not folded into ex2's
// exponent), and the lane that owns key j rounds p_j * v_scale[j] to q's
// dtype before the PV broadcast.
//
// Modes: bf16 and fp32 caches (q in the cache's dtype), and int8 caches
// with q in bf16 or fp32; window, softcap; head_dim 32, 64, 128, 256; at
// most 8 query heads per kv head. At head_dim 256 (Gemma) a lane owns 8
// output columns and a staged row is 256 elements: the walk is the same,
// and the fp32 ring's three stages (195 KB) and q (G KB) still fit one
// block's shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the JAX package's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxG = 8;   // query heads per kv head
constexpr int TS = 32;     // keys per tile: one warp lane per key
constexpr int STAGES = 3;  // tiles in the shared-memory ring

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// p as the PV product sees it: rounded to q's dtype (for a float cache,
// q's dtype is the cache's).
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
            typename std::conditional<
                BYTES == 4, uint32_t,
                typename std::conditional<BYTES == 2, uint16_t, uint8_t>::type>::type>::type>::type;
    const V raw = *reinterpret_cast<const V*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  }
}

// N consecutive fp32 values from device memory through L2 (not L1: another
// SM wrote them), in one vector load.
template <int N> __device__ __forceinline__ void load_cg(const float* src, float* out) {
  if constexpr (N > 4) {
    static_assert(N % 4 == 0, "whole float4 loads");
#pragma unroll
    for (int i = 0; i < N; i += 4) load_cg<4>(src + i, out + i);
  } else if constexpr (N == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src));
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(src));
    out[0] = v.x, out[1] = v.y;
  } else {
    static_assert(N == 1, "one vector load");
    out[0] = __ldcg(src);
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
// 2^x on the special-function unit (relative error 2^-22, denormals to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
// 4 bytes (through L1: cp.async.cg takes only 16).
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
  const void* k;
  const void* v;
  const float* k_scale;  // [B, Kh, S], int8 caches only
  const float* v_scale;
  const int32_t* last;
  const int32_t* qpos;
  float* acc;       // [B, N, H]
  float* m;         // [B, N]
  float* l;
  float* part_acc;  // [B, Kh, Z, G, H]: each split's acc (Z > 1 only)
  float* part_m;    // [B, Kh, Z, G], in the units of `u` below
  float* part_l;
  int* arrivals;    // [B, Kh], zero between launches
  int N, Kh, S, Z, window;
  float scale, softcap;
};

// Keys [lo, hi] of split z of (slot b): the live range cut into Z runs of
// whole tiles (ops/kernels/decode_attention.py:split_range is the same rule
// in Python). lo > hi: the split attends nothing.
__device__ __forceinline__ void split_range(int last, int qp, int window, int S, int Z, int z,
                                            int& lo, int& hi) {
  const int s_end = min(last, S - 1);
  const int s_begin = window > 0 ? max(0, qp - window + 1) : 0;
  const int n_keys = s_end - s_begin + 1;
  lo = 0;
  hi = -1;
  if (n_keys <= 0) return;
  const int n_tiles = (n_keys + TS - 1) / TS;
  const int per = (n_tiles + Z - 1) / Z;  // tiles a split
  if (z * per >= n_tiles) return;
  lo = s_begin + z * per * TS;
  hi = min(s_end, lo + per * TS - 1);
}

// Bytes of one staged row of H elements of T: padded by 16 so lanes that
// read neighbouring rows in 16-byte vectors fall on different banks.
template <typename T, int H> __host__ __device__ constexpr int row_bytes() {
  return H * static_cast<int>(sizeof(T)) + 16;
}
// K rows, then V rows; an int8 stage then holds the tile's 32 k scales and
// its 32 v scales.
template <typename T, int H> __host__ __device__ constexpr int stage_bytes() {
  return 2 * TS * row_bytes<T, H>() +
         (std::is_same<T, int8_t>::value ? 2 * TS * static_cast<int>(sizeof(float)) : 0);
}
template <typename T, int H> constexpr size_t smem_bytes(int G) {
  return static_cast<size_t>(G) * H * sizeof(float) +
         static_cast<size_t>(STAGES) * stage_bytes<T, H>();
}

// TQ: q's type; T: the cache's (TQ itself, or int8_t with scales).
template <typename TQ, typename T, int H, int NW>
__global__ void __launch_bounds__(32 * NW) decode_split_kernel(const Params p) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  constexpr int NT = 32 * NW;
  constexpr int RB = row_bytes<T, H>();
  constexpr int CPR = H * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks per row
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));       // elements per 16-byte load
  constexpr int DPL = H / 32;                                 // output columns per lane
  constexpr int STRIDE = stage_bytes<T, H>();
  const int G = p.N / p.Kh;
  const int kh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Z = p.Z;
  const bool capped = p.softcap > 0.f;
  // A row's running max is kept in u, the raw dot product (or the logit,
  // when capped or int8): the logit is u * m_unit and p = 2^((u - u_max) *
  // f), so the scale folds into the exponent and m leaves as u_max *
  // m_unit, as the plain version rounds it.
  const bool fold = !capped && !Q8;
  const float f = fold ? p.scale * kLog2e : kLog2e;
  const float m_unit = fold ? p.scale : 1.f;
  const size_t row0 = static_cast<size_t>(b) * p.N + kh * G;  // the first of the G rows
  const size_t part = (static_cast<size_t>(b) * p.Kh + kh) * Z + z;

  int lo, hi;
  split_range(p.last[b], p.qpos[b], p.window, p.S, Z, z, lo, hi);

  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // [G][H] q widened to fp32
  unsigned char* ring = smem + static_cast<size_t>(G) * H * sizeof(float);

  float u_max = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;

  if (lo <= hi) {
    const size_t panel = (static_cast<size_t>(b) * p.Kh + kh) * p.S;
    const unsigned char* kbase = static_cast<const unsigned char*>(p.k) + panel * H * sizeof(T);
    const unsigned char* vbase = static_cast<const unsigned char*>(p.v) + panel * H * sizeof(T);
    const int n_tiles = (hi - lo) / TS + 1;
    auto issue = [&](int i) {
      const int t0 = lo + i * TS, rows = min(TS, hi - t0 + 1);
      unsigned char* sk = ring + (i % STAGES) * STRIDE;
      unsigned char* sv = sk + TS * RB;
      for (int idx = tid; idx < rows * CPR; idx += NT) {
        const int r = idx / CPR, c = (idx % CPR) * 16;
        const size_t src = static_cast<size_t>(t0 + r) * H * sizeof(T) + c;
        cp_async16(sk + r * RB + c, kbase + src);
        cp_async16(sv + r * RB + c, vbase + src);
      }
      if constexpr (Q8) {
        float* ss = reinterpret_cast<float*>(sv + TS * RB);  // k scales, then v scales
        if (tid < rows) {
          cp_async4(ss + tid, p.k_scale + panel + t0 + tid);
          cp_async4(ss + TS + tid, p.v_scale + panel + t0 + tid);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n_tiles) issue(i);
      cp_async_commit();
    }
    // q is read while the first tiles are in flight; it is visible after
    // the ring's first barrier.
    const TQ* q = static_cast<const TQ*>(p.q) + row0 * H;
    for (int idx = tid; idx < G * H; idx += NT) sq[idx] = to_f(q[idx]);
    for (int i = 0; i < n_tiles; ++i) {
      if (i + STAGES - 1 < n_tiles) issue(i + STAGES - 1);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // tile i has landed (this thread's copies)
      __syncthreads();              // ... and every other thread's
      const int rows = min(TS, hi - (lo + i * TS) + 1);
      const unsigned char* sk = ring + (i % STAGES) * STRIDE;
      const unsigned char* sv = sk + TS * RB;
      if (warp < G) {
        // Lane j scores key j (a lane past `rows` reads a stale row, whose
        // score is selected away below).
        const float* qr = sq + warp * H;
        const unsigned char* krow = sk + lane * RB;
        float d4[4] = {0.f, 0.f, 0.f, 0.f};  // four independent chains
#pragma unroll
        for (int c = 0; c < H; c += VEC) {
          float kx[VEC];
          load_row<T, VEC>(krow + c * sizeof(T), kx);
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + c + e);  // a broadcast
            d4[0] = fmaf(qv.x, kx[e], d4[0]);
            d4[1] = fmaf(qv.y, kx[e + 1], d4[1]);
            d4[2] = fmaf(qv.z, kx[e + 2], d4[2]);
            d4[3] = fmaf(qv.w, kx[e + 3], d4[3]);
          }
        }
        const float dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
        // The tile's scales (int8); a lane past `rows` reads a stale one, and
        // its u is selected away.
        [[maybe_unused]] const float* ss = reinterpret_cast<const float*>(sv + TS * RB);
        float u;
        if constexpr (Q8) {
          const float s = dot * p.scale * ss[lane];
          u = capped ? tanhf(s / p.softcap) * p.softcap : s;
        } else {
          u = capped ? tanhf(dot * p.scale / p.softcap) * p.softcap : dot;
        }
        u = lane < rows ? u : kNegInf;
        const float u_new = fmaxf(u_max, warp_max(u));  // a real key: u_new is live
        const float pj = lane < rows ? ex2((u - u_new) * f) : 0.f;
        const float corr = u_max > kNegInf * 0.5f ? ex2((u_max - u_new) * f) : 0.f;
        l = l * corr + warp_sum(pj);
        u_max = u_new;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[d] *= corr;
        // Only lanes below `rows` are broadcast, so a stale v scale is never read.
        float pv;
        if constexpr (Q8) {
          pv = round_p<TQ>(pj * ss[TS + lane]);
        } else {
          pv = round_p<TQ>(pj);
        }
        // PV: p_j broadcast from lane j; each lane owns columns lane*DPL on.
        // Every visited row is staged, so its load needs no branch; a key
        // whose p is 0 is selected out, not multiplied by zero.
#pragma unroll 8
        for (int j = 0; j < rows; ++j) {
          const float w = __shfl_sync(0xffffffffu, pv, j);
          float vx[DPL];
          load_row<T, DPL>(sv + j * RB + lane * DPL * sizeof(T), vx);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[d] = w != 0.f ? fmaf(w, vx[d], acc[d]) : acc[d];
        }
      }
      __syncthreads();  // stage i % STAGES is free for tile i + STAGES
    }
    cp_async_wait<0>();  // nothing lands in the ring once the merge reuses it
  }

  if (Z == 1) {  // the block's own statistics are the result
    if (warp < G) {
      float* out = p.acc + (row0 + warp) * H + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) out[d] = acc[d];
      if (lane == 0) {
        const bool live = u_max > kNegInf * 0.5f;
        p.m[row0 + warp] = live ? u_max * m_unit : kNegInf;
        p.l[row0 + warp] = live ? l : 0.f;
      }
    }
    return;
  }

  if (warp < G) {  // a split with no key writes u = NEG_INF, l = 0, acc = 0
    float* out = p.part_acc + (part * G + warp) * H + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) out[d] = acc[d];
    if (lane == 0) {
      p.part_m[part * G + warp] = u_max;
      p.part_l[part * G + warp] = l;
    }
  }
  __threadfence();  // this block's partials are visible device-wide ...
  __syncthreads();
  __shared__ int is_last;
  int* arrived = p.arrivals + static_cast<size_t>(b) * p.Kh + kh;
  if (tid == 0) is_last = atomicAdd(arrived, 1) == Z - 1;  // ... before its arrival counts
  __syncthreads();
  if (!is_last) return;
  __threadfence();  // every split's partials are visible to this block
  if (tid == 0) *arrived = 0;

  // The merge, in split order, warp g for row g: lane s reads split s's m
  // and l (s, s + 32, ... with more than 32 splits) and the warp reduces
  // the max, the weights and l; then each lane sums its H/32 columns of
  // acc over the splits, every split's partial read at once (through L2:
  // another SM wrote them). Every split wrote its partials, a dead one
  // u = NEG_INF, l = 0 and acc = 0, so no load needs a branch; a split of
  // weight 0 is selected out.
  if (warp >= G) return;
  const size_t base = (static_cast<size_t>(b) * p.Kh + kh) * Z;
  float* sw = reinterpret_cast<float*>(ring) + warp * Z;  // the row's weights
  constexpr int PER_LANE = 4;  // splits a lane keeps in registers
  float ms[PER_LANE], lsp[PER_LANE];
  float um = kNegInf;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int s = lane + 32 * i;
    ms[i] = s < Z ? __ldcg(p.part_m + (base + s) * G + warp) : kNegInf;
    lsp[i] = s < Z ? __ldcg(p.part_l + (base + s) * G + warp) : 0.f;
  }
  for (int s = lane + 32 * PER_LANE; s < Z; s += 32) {
    um = fmaxf(um, __ldcg(p.part_m + (base + s) * G + warp));
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) um = fmaxf(um, ms[i]);
  um = warp_max(um);
  const bool live = um > kNegInf * 0.5f;
  float ls = 0.f;
  auto weigh = [&](int s, float m_s, float l_s) {
    const float w = live && m_s > kNegInf * 0.5f ? ex2((m_s - um) * f) : 0.f;
    sw[s] = w;
    ls = w != 0.f ? fmaf(w, l_s, ls) : ls;
  };
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    if (lane + 32 * i < Z) weigh(lane + 32 * i, ms[i], lsp[i]);
  }
  for (int s = lane + 32 * PER_LANE; s < Z; s += 32) {
    weigh(s, __ldcg(p.part_m + (base + s) * G + warp), __ldcg(p.part_l + (base + s) * G + warp));
  }
  ls = warp_sum(ls);
  __syncwarp();  // the row's weights are in shared memory
  float a[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) a[d] = 0.f;
  const float* row_parts = p.part_acc + (base * G + warp) * H + lane * DPL;
#pragma unroll 8
  for (int s = 0; s < Z; ++s) {
    const float w = sw[s];
    float x[DPL];
    load_cg<DPL>(row_parts + static_cast<size_t>(s) * G * H, x);
#pragma unroll
    for (int d = 0; d < DPL; ++d) a[d] = w != 0.f ? fmaf(w, x[d], a[d]) : a[d];
  }
  float* out = p.acc + (row0 + warp) * H + lane * DPL;
#pragma unroll
  for (int d = 0; d < DPL; ++d) out[d] = a[d];
  if (lane == 0) {
    p.m[row0 + warp] = live ? um * m_unit : kNegInf;
    p.l[row0 + warp] = live ? ls : 0.f;
  }
}

template <typename TQ, typename T, int H, int NW>
cudaError_t launch_nw(const Params& p, int B, cudaStream_t stream) {
  // The merge keeps its weights in the ring's memory.
  if (static_cast<size_t>(p.Z) * (p.N / p.Kh) * sizeof(float) >
      static_cast<size_t>(STAGES) * stage_bytes<T, H>()) {
    return cudaErrorInvalidValue;
  }
  auto kern = decode_split_kernel<TQ, T, H, NW>;
  // Set once per instantiation, for the most rows it takes.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes<T, H>(NW)));
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(p.Kh, B, p.Z), 32 * NW, smem_bytes<T, H>(p.N / p.Kh), stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename T, int H>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  // One warp per query row: four warps up to G = 4 (the spare ones copy).
  return p.N / p.Kh <= 4 ? launch_nw<TQ, T, H, 4>(p, B, stream)
                         : launch_nw<TQ, T, H, kMaxG>(p, B, stream);
}

template <typename TQ, typename T>
cudaError_t dispatch_h(int H, const Params& p, int B, cudaStream_t stream) {
  switch (H) {
    case 32:
      return launch<TQ, T, 32>(p, B, stream);
    case 64:
      return launch<TQ, T, 64>(p, B, stream);
    case 128:
      return launch<TQ, T, 128>(p, B, stream);
    case 256:
      return launch<TQ, T, 256>(p, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and the cache); 2 = an int8 cache
// with float32 q, 3 = an int8 cache with bfloat16 q, both with fp32
// k_scale and v_scale [B, Kh, S] (null otherwise). Z splits a (kv head,
// slot); with Z > 1, part is fp32 scratch of B*Kh*Z*G*(H + 2) (each
// split's acc, then its m, then its l) and arrivals int32 [B*Kh], all 0 on
// entry and left so. All tensors contiguous; returns cudaGetLastError().
extern "C" int pt_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale, const void* last,
                                   const void* qpos, void* acc, void* m, void* l, void* part,
                                   void* arrivals, int B, int N, int Kh, int S, int H, int Z,
                                   int window, float scale, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0 || N / Kh > kMaxG || Z < 1 || Z > 65535 ||
      (Z > 1 && (part == nullptr || arrivals == nullptr)) ||
      ((dtype >= 2) != (k_scale != nullptr && v_scale != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = N / Kh;
  const size_t rows = static_cast<size_t>(B) * Kh * Z * G;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.last = static_cast<const int32_t*>(last);
  p.qpos = static_cast<const int32_t*>(qpos);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.part_acc = static_cast<float*>(part);
  p.part_m = part != nullptr ? p.part_acc + rows * H : nullptr;
  p.part_l = part != nullptr ? p.part_m + rows : nullptr;
  p.arrivals = static_cast<int*>(arrivals);
  p.N = N;
  p.Kh = Kh;
  p.S = S;
  p.Z = Z;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_h<float, float>(H, p, B, st);
  } else if (dtype == 1) {
    err = dispatch_h<__nv_bfloat16, __nv_bfloat16>(H, p, B, st);
  } else if (dtype == 2) {
    err = dispatch_h<float, int8_t>(H, p, B, st);
  } else if (dtype == 3) {
    err = dispatch_h<__nv_bfloat16, int8_t>(H, p, B, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
