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
// the live pages. The design reads each live key's K/V row from device
// memory exactly once for all G rows of its kv head (one block per
// (kv head, slot)), walks a slot's table only up to last[b] and skips dead
// pages without touching them, stages each page in tiles of 32 keys through
// shared memory with 16-byte loads, and keeps scores, statistics and the
// accumulator on chip. Offsets into a pool are 64-bit (a pool for 8 slots of
// 8192 tokens at 8B holds 67M elements per layer).
//
// Keys that are masked must not poison the PV sum (0 * NaN = NaN): rows past
// last[b] are staged as zeros, and the PV loop selects on p != 0 rather than
// multiplying a masked key's value by zero.
//
// What this design leaves on the table: one block per (kv head, slot) is
// B*K blocks (64 at 8 slots of llama3-8b, for 132 SMs), and one long slot's
// pages are walked serially by its K blocks while the short slots' blocks
// have long finished. Splitting the page walk across blocks, with a merge of
// the partial statistics (flash-decoding), is the next step for speed.
//
// Modes: bf16 and fp32 pools (q and the ring in the pool's dtype), int8 pools
// with scales (q and the ring in bf16 or fp32), q_blocks >= 1 (speculative
// rows: row = head*q_blocks + d sits at position qpos + d), ring or none,
// window, softcap; head_dim 32, 64, 128; P a multiple of 16 up to 256; at
// most 32 query rows per kv head. The engine refuses speculation and KV
// quantization (later slices), so int8 pools and q_blocks > 1 run only in
// the kernel checks of chip_smoke.py and the CPU tests of the plain version.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the JAX package's NEG_INF
constexpr int kMaxRows = 32;               // query rows per kv head
constexpr int TS = 32;                      // keys per tile: one warp lane per key
constexpr int NT = 128;                     // threads per block
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

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
  int N, Kh, num_pages, P, max_pages, n_blocks, q_blocks, R, ring_step, window;
  float scale, softcap;
};

struct Smem {
  float* q;   // [G][H]
  float* k;   // [TS][H+1]
  float* v;   // [TS][H]
  float* p;   // [G][TS]
  float* m;   // [G]
  float* l;   // [G]
  float* c;   // [G] this tile's correction
  float* pa;  // [G][H] the pages' acc while the ring runs
  float* pm;  // [G] the pages' m
  float* pl;  // [G] the pages' l
};

// Floats of dynamic shared memory for G query rows of head_dim H.
constexpr int smem_floats(int G, int H) {
  return 2 * G * H + TS * (H + 1) + TS * H + G * TS + 5 * G;
}

// One tile of up to TS keys: rows [lo, hi) of kt/vt attend; the others are
// staged as zeros and masked. win_base = qpos - (column of row 0) when the
// per-row window applies (page tiles), window = 0 otherwise (the ring's
// window is already in [lo, hi)).
template <typename T, typename VT, int H, int MAXR>
__device__ __forceinline__ void attend_tile(const T* __restrict__ kt, const T* __restrict__ vt,
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs, int lo, int hi,
                                            int win_base, int window, int q_blocks, int G,
                                            float scale, float softcap, const Smem& sm,
                                            float (&acc)[MAXR]) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KSTRIDE = H + 1;
  static_assert(H % VEC == 0, "rows load in 16-byte vectors");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __syncthreads();  // the previous tile's readers are done with k, v and p
  for (int idx = tid; idx < TS * (H / VEC); idx += NT) {
    const int j = idx / (H / VEC), c = (idx % (H / VEC)) * VEC;
    float kx[VEC], vx[VEC];
    if (j >= lo && j < hi) {
      unpack<T, VEC>(*reinterpret_cast<const uint4*>(kt + static_cast<size_t>(j) * H + c), kx);
      unpack<T, VEC>(*reinterpret_cast<const uint4*>(vt + static_cast<size_t>(j) * H + c), vx);
      if (ks != nullptr) {
        const float a = ks[j], b = vs[j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kx[e] *= a;
          vx[e] *= b;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kx[e] = vx[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sm.k[j * KSTRIDE + c + e] = kx[e];
      sm.v[j * H + c + e] = vx[e];
    }
  }
  __syncthreads();

  for (int idx = tid; idx < G * TS; idx += NT) {
    const int g = idx / TS, j = idx % TS;
    const float* qr = sm.q + g * H;
    const float* kr = sm.k + j * KSTRIDE;
    float dot = 0.f;
#pragma unroll 16
    for (int h = 0; h < H; ++h) dot = fmaf(qr[h], kr[h], dot);
    float s = dot * scale;
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    bool ok = j >= lo && j < hi;
    if (window > 0) ok = ok && (win_base + (g % q_blocks) - j < window);
    sm.p[idx] = ok ? s : kNegInf;
  }
  __syncthreads();

  for (int g = warp; g < G; g += NW) {
    const float x = sm.p[g * TS + lane];
    const float m_old = sm.m[g];
    const float m_new = fmaxf(m_old, warp_max(x));
    const float p = m_new > kNegInf * 0.5f ? expf(x - m_new) : 0.f;
    const float psum = warp_sum(p);
    sm.p[g * TS + lane] = round_p<VT>(p);
    if (lane == 0) {
      const float corr = m_old > kNegInf * 0.5f ? expf(m_old - m_new) : 0.f;
      sm.c[g] = corr;
      sm.l[g] = sm.l[g] * corr + psum;
      sm.m[g] = m_new;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int idx = tid + r * NT;
    if (idx < G * H) {
      const int g = idx / H, h = idx % H;
      const float* prow = sm.p + g * TS;
      float a = acc[r] * sm.c[g];
#pragma unroll 8
      for (int j = 0; j < TS; ++j) {
        const float pj = prow[j];
        if (pj != 0.f) a = fmaf(pj, sm.v[j * H + h], a);
      }
      acc[r] = a;
    }
  }
}

template <typename TQ, typename TKV, int H>
__global__ void __launch_bounds__(NT) paged_attention_kernel(const Params p) {
  using VT = typename std::conditional<std::is_same<TKV, int8_t>::value, float, TKV>::type;
  constexpr int MAXR = (kMaxRows * H + NT - 1) / NT;  // accumulator columns per thread
  const int G = p.N / p.Kh;
  extern __shared__ float smem[];
  Smem sm;
  sm.q = smem;
  sm.k = sm.q + G * H;
  sm.v = sm.k + TS * (H + 1);
  sm.p = sm.v + TS * H;
  sm.m = sm.p + G * TS;
  sm.l = sm.m + G;
  sm.c = sm.l + G;
  sm.pa = sm.c + G;
  sm.pm = sm.pa + G * H;
  sm.pl = sm.pm + G;

  const int tid = threadIdx.x;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const TQ* q = static_cast<const TQ*>(p.q);
  for (int idx = tid; idx < G * H; idx += NT) {
    sm.q[idx] = to_f(q[(static_cast<size_t>(b) * p.N + kh * G) * H + idx]);
  }
  for (int g = tid; g < G; g += NT) {
    sm.m[g] = kNegInf;
    sm.l[g] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  const int P = p.P;
  const int last = p.last[b];
  const int qp = p.qpos[b];
  const int sentinel = p.num_pages - 1;
  const int n_pages = last >= 0 ? min(p.n_blocks, last / P + 1) : 0;
  const TKV* kpool = static_cast<const TKV*>(p.k_pool);
  const TKV* vpool = static_cast<const TKV*>(p.v_pool);
  for (int jt = 0; jt < n_pages; ++jt) {
    const int page = p.table[static_cast<size_t>(b) * p.max_pages + jt];
    const int j0 = jt * P;
    if (page == sentinel) continue;
    if (p.window > 0 && qp - (j0 + P - 1) >= p.window) continue;
    const size_t row0 = (static_cast<size_t>(kh) * p.num_pages + page) * P;
    for (int t0 = 0; t0 < P && j0 + t0 <= last; t0 += TS) {
      const int hi = min(min(TS, P - t0), last - (j0 + t0) + 1);
      const size_t off = row0 + t0;
      attend_tile<TKV, VT, H, MAXR>(
          kpool + off * H, vpool + off * H, p.k_scales ? p.k_scales + off : nullptr,
          p.v_scales ? p.v_scales + off : nullptr, 0, hi, qp - (j0 + t0), p.window,
          p.q_blocks, G, p.scale, p.softcap, sm, acc);
    }
  }

  if (p.R > 0) {
    // Set the pages' statistics aside and run the ring as a softmax of its own.
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int idx = tid + r * NT;
      if (idx < G * H) sm.pa[idx] = acc[r];
      acc[r] = 0.f;
    }
    for (int g = tid; g < G; g += NT) {
      sm.pm[g] = sm.m[g];
      sm.pl[g] = sm.l[g];
      sm.m[g] = kNegInf;
      sm.l[g] = 0.f;
    }
    const int step = p.ring_step;  // ring rows 0..step hold this chunk's keys
    const int r_lo = p.window > 0 ? max(0, step - p.window + 1) : 0;
    const size_t ring0 = (static_cast<size_t>(b) * p.Kh + kh) * p.R;
    const TQ* rk = static_cast<const TQ*>(p.ring_k) + ring0 * H;
    const TQ* rv = static_cast<const TQ*>(p.ring_v) + ring0 * H;
    for (int r0 = (r_lo / TS) * TS; r0 <= step; r0 += TS) {
      const int lo = max(0, r_lo - r0);
      const int hi = min(min(TS, p.R - r0), step - r0 + 1);
      attend_tile<TQ, TQ, H, MAXR>(rk + static_cast<size_t>(r0) * H,
                                   rv + static_cast<size_t>(r0) * H, nullptr, nullptr, lo, hi,
                                   0, 0, 1, G, p.scale, p.softcap, sm, acc);
    }
    __syncthreads();
    // The merge of the TPU kernel (and of engine/decode.py:_merge_stats).
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int idx = tid + r * NT;
      if (idx < G * H) {
        const int g = idx / H;
        const float m_a = sm.pm[g], m_b = sm.m[g], m_new = fmaxf(m_a, m_b);
        const float wa = m_a > kNegInf * 0.5f ? expf(m_a - m_new) : 0.f;
        const float wb = m_b > kNegInf * 0.5f ? expf(m_b - m_new) : 0.f;
        acc[r] = sm.pa[idx] * wa + acc[r] * wb;
      }
    }
    __syncthreads();  // every thread has read sm.m before it is overwritten
    for (int g = tid; g < G; g += NT) {
      const float m_a = sm.pm[g], m_b = sm.m[g], m_new = fmaxf(m_a, m_b);
      const float wa = m_a > kNegInf * 0.5f ? expf(m_a - m_new) : 0.f;
      const float wb = m_b > kNegInf * 0.5f ? expf(m_b - m_new) : 0.f;
      sm.l[g] = sm.pl[g] * wa + sm.l[g] * wb;
      sm.m[g] = m_new;
    }
  }
  __syncthreads();

  const size_t out0 = static_cast<size_t>(b) * p.N + kh * G;
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int idx = tid + r * NT;
    if (idx < G * H) p.acc[out0 * H + idx] = acc[r];
  }
  for (int g = tid; g < G; g += NT) {
    p.m[out0 + g] = sm.m[g];
    p.l[out0 + g] = sm.l[g];
  }
}

template <typename TQ, typename TKV, int H>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto kern = paged_attention_kernel<TQ, TKV, H>;
  const int G = p.N / p.Kh;
  const size_t smem = smem_floats(G, H) * sizeof(float);
  // Set once per instantiation, for the most rows it takes.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_floats(kMaxRows, H) * sizeof(float)));
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(p.Kh, B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_h(int H, const Params& p, int B, cudaStream_t stream) {
  switch (H) {
    case 32:
      return launch<TQ, TKV, 32>(p, B, stream);
    case 64:
      return launch<TQ, TKV, 64>(p, B, stream);
    case 128:
      return launch<TQ, TKV, 128>(p, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (with k_scales/v_scales); a float pool has q's dtype. R = 0: no
// ring. All tensors contiguous; returns cudaGetLastError().
extern "C" int pt_paged_attention(int q_dtype, int kv_dtype, const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scales,
                                  const void* v_scales, const void* table, const void* last,
                                  const void* qpos, const void* ring_k, const void* ring_v,
                                  void* acc, void* m, void* l, int B, int N, int Kh,
                                  int num_pages, int P, int H, int max_pages, int n_blocks,
                                  int q_blocks, int R, int ring_step, int window, float scale,
                                  float softcap, void* stream) {
  if (B <= 0 || Kh <= 0 || N % Kh != 0 || N / Kh > kMaxRows || q_blocks < 1 ||
      (N / Kh) % q_blocks != 0 || P % 16 != 0 || P <= 0 || P > 256 || n_blocks > max_pages ||
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
