// Causal GQA flash attention, forward — hand-written CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel pilottai_tpu/ops/pallas/flash_attention.py:_flash_kernel
// (reached through _fwd_impl, flash_attention and flash_attention_with_lse).
// Computes, for q [B,T,N,H] and k, v [B,S,K,H] (N = K*G query heads share a
// kv head), with an fp32 online softmax:
//
//   attend(t, s) = kv_pos[s] <= q_pos[t]  and  s < valid[b]
//                  and (window <= 0 or q_pos[t] - kv_pos[s] < window)
//   logits = (q . k) * scale, then tanh soft-cap when softcap > 0
//   o = softmax(logits) . v  (p cast to the input dtype before the PV product)
//   lse = m + log(l), NEG_INF (-2^30) where a row saw no key (o = 0 there)
//
// What bounds it on an H100: at long T the work is compute (4*H multiply-adds
// per live (query, key, head) pair against T*(N+2K)*H inputs), so the kernel
// is bounded by operations; at short T by the bytes of q, k, v and o. Both
// kernels keep every intermediate out of device memory, skip kv tiles in
// which no (query, key) pair is live (causal prefill reads about half of
// them) and never visit keys at or past valid[b]. In bf16 both products run
// on the tensor cores with scores, probabilities and the output accumulator
// in registers and K/V loads in flight (flash_fwd_bf16_kernel, described
// above it); in fp32 they run on the CUDA cores in full fp32
// (flash_fwd_fp32_kernel), so the fp32 path matches the reference to
// summation order (tensor cores would round to TF32). The bf16 body runs
// both products on wgmma, Hopper's warpgroup product; its tiles arrive by
// cp.async from the same threads: TMA from a producer warp, two consumer
// warpgroups and a persistent schedule are the next steps.
//
// fp32 kernel layout: BQ query rows of one head of one batch row, NT threads.
// Per kv tile of BK keys: K and V are staged in shared memory (K rows
// padded to H+1 floats so a warp reading 32 different keys hits 32 banks),
// each thread computes BQ*BK/NT scores, one warp per row runs the online
// softmax update, and each thread accumulates its output column for BQ*H/NT
// rows. A row that has seen no live key keeps m = NEG_INF and p = 0.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the JAX package's NEG_INF

__device__ __forceinline__ bool attends(int qp, int kp, int window) {
  return kp <= qp && (window <= 0 || qp - kp < window);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int H, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT) flash_fwd_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
    const int32_t* __restrict__ valid, float* __restrict__ o, float* __restrict__ lse,
    int Tq, int S, int N, int Kh, int window, float scale, float softcap) {
  static_assert(NT % H == 0, "each column is owned by NT / H threads");
  static_assert(BK % 32 == 0, "one warp covers a score row in BK/32 steps");
  constexpr int NW = NT / 32;
  constexpr int COLS_GROUPS = NT / H;        // threads sharing a column
  constexpr int RPT = BQ / COLS_GROUPS;      // rows accumulated per thread
  constexpr int KSTRIDE = H + 1;

  extern __shared__ float smem[];
  float* sQ = smem;                       // [BQ][H]
  float* sK = sQ + BQ * H;                // [BK][H+1]
  float* sV = sK + BK * KSTRIDE;          // [BK][H]
  float* sP = sV + BK * H;                // [BQ][BK]
  float* sM = sP + BQ * BK;               // [BQ]
  float* sL = sM + BQ;                    // [BQ]
  float* sC = sL + BQ;                    // [BQ] per-tile correction
  int* sQpos = reinterpret_cast<int*>(sC + BQ);  // [BQ]
  int* sKpos = sQpos + BQ;                       // [BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = n / (N / Kh);
  const int kv_end = min(S, valid[b]);

  for (int idx = tid; idx < BQ * H; idx += NT) {
    const int i = idx / H, h = idx % H, t = q0 + i;
    sQ[idx] = t < Tq ? q[((static_cast<size_t>(b) * Tq + t) * N + n) * H + h] : 0.f;
  }
  for (int i = tid; i < BQ; i += NT) {
    const int t = q0 + i;
    sQpos[i] = t < Tq ? qpos[static_cast<size_t>(b) * Tq + t] : INT_MIN;
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }

  const int h = tid % H;
  const int r0 = tid / H;
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // previous tile's readers are done with sK/sV/sP/sKpos
    for (int j = tid; j < BK; j += NT) {
      const int s = j0 + j;
      sKpos[j] = s < kv_end ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
    }
    __syncthreads();
    // Tile skip: no live (query, key) pair in this tile contributes nothing.
    int live = 0;
    for (int idx = tid; idx < BQ * BK && !live; idx += NT) {
      const int i = idx / BK, j = idx % BK;
      live = q0 + i < Tq && j0 + j < kv_end && attends(sQpos[i], sKpos[j], window);
    }
    if (!__syncthreads_or(live)) continue;

    for (int idx = tid; idx < BK * H; idx += NT) {
      const int j = idx / H, hh = idx % H, s = j0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < kv_end) {
        const size_t off = ((static_cast<size_t>(b) * S + s) * Kh + kh) * H + hh;
        kx = k[off];
        vx = v[off];
      }
      sK[j * KSTRIDE + hh] = kx;
      sV[j * H + hh] = vx;
    }
    __syncthreads();

    for (int idx = tid; idx < BQ * BK; idx += NT) {
      const int i = idx / BK, j = idx % BK;
      const float* qr = sQ + i * H;
      const float* kr = sK + j * KSTRIDE;
      float dot = 0.f;
#pragma unroll 16
      for (int hh = 0; hh < H; ++hh) dot = fmaf(qr[hh], kr[hh], dot);
      float s = dot * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const bool ok = q0 + i < Tq && j0 + j < kv_end && attends(sQpos[i], sKpos[j], window);
      sP[idx] = ok ? s : kNegInf;
    }
    __syncthreads();

    for (int i = warp; i < BQ; i += NW) {
      float* row = sP + i * BK;
      float mx = kNegInf;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = sM[i];
      const float m_new = fmaxf(m_old, mx);
      const bool any = m_new > kNegInf * 0.5f;
      float psum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = any ? expf(row[j] - m_new) : 0.f;
        psum += p;
        row[j] = p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = any ? expf(m_old - m_new) : 1.f;
        sC[i] = corr;
        sL[i] = sL[i] * corr + psum;
        sM[i] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = r0 + r * COLS_GROUPS;
      const float* prow = sP + i * BK;
      float a = acc[r] * sC[i];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(prow[j], sV[j * H + h], a);
      acc[r] = a;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = r0 + r * COLS_GROUPS;
    const int t = q0 + i;
    if (t >= Tq) continue;
    const float l = sL[i];
    const float out = l > 0.f ? acc[r] / fmaxf(l, 1e-30f) : 0.f;
    o[((static_cast<size_t>(b) * Tq + t) * N + n) * H + h] = out;
    if (h == 0) {
      lse[(static_cast<size_t>(b) * N + n) * Tq + t] =
          l > 0.f ? sM[i] + logf(fmaxf(l, 1e-30f)) : kNegInf;
    }
  }
}

// bf16 path: the same function with both products on the tensor cores.
// A block is one warpgroup (4 warps, 128 threads) holding F_BQ = 64 query
// rows of one head. From head_dim 64 on, both products are wgmma: S = Q K^T
// (m64 x BK x k16 steps) reads Q and K from shared memory, stored as
// K-major 64-column panels with the 128-byte swizzle; the online softmax
// runs on S's accumulator registers (each warp's 16 rows in mma.sync's
// accumulator layout, row statistics reduced over the 4 lanes that share
// a row); p is rounded to bf16 in registers and is the register A operand
// of P V (m64 x H x k16 steps), which reads V from shared memory as an
// MN-major tile in the same swizzled panels; O stays in registers until
// the epilogue. At head_dim 32, whose 64-byte rows do not fill a swizzle
// row, both products are mma.sync (m16n8k16) from padded rows through
// ldmatrix, Q held in registers. Four blocks share an SM (at most 128
// registers a thread). K and V tiles of BK keys (64, or 32 at head_dim 128
// so that four blocks fit an SM's shared memory) come through a 2-stage
// shared-memory ring filled with cp.async (rows past valid[b]
// zero-filled), so the next tile's bytes arrive while this one is
// computed.
//
// Tile liveness comes from bounds, not a pair scan: with qmin/qmax the
// q tile's positions and kmin/kmax the kv tile's (over real rows and keys),
// a tile can hold a live pair only if kmin <= qmax and (no window or
// qmin - kmax < window), and every pair is live if kmax <= qmin, (no
// window or qmax - kmin < window) and the tile lies below valid[b]; only
// tiles in between are masked pair by pair (tile_live, tile_full in
// hopper.cuh). A first small launch (tile_bounds_kernel) reduces each
// (batch row, kv tile) to its bounds once, so a block tests a tile with
// one load, and dead tiles are never loaded; a full tile stages no key
// positions. Without a soft-cap the scores stay unscaled and the scale
// rides in the exponent. The grid walks q tiles from the last, the
// longest under causal positions, to the first.
constexpr int F_BQ = 64, F_NT = 128;
// Keys per kv tile.
template <int H> __host__ __device__ constexpr int f_bk() { return H == 128 ? 32 : 64; }

// From head_dim 64 on, both products run on wgmma with Q, K and V in the
// swizzled layout (plus 1 KB to align it); at 32 on mma.sync from padded
// rows.
template <int H> __host__ __device__ constexpr bool f_wgmma() { return H >= 64; }

template <int H>
constexpr size_t f_smem_bytes() {
  constexpr size_t row = f_wgmma<H>() ? H : H + 8;  // bf16 per staged Q, K or V row
  return (f_wgmma<H>() ? 1024 : 0) + (F_BQ + 4 * f_bk<H>()) * row * sizeof(__nv_bfloat16) +
         static_cast<size_t>(F_BQ + 2 * f_bk<H>()) * sizeof(int);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += a . b for one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int H>
__global__ void __launch_bounds__(F_NT, 4) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const int32_t* __restrict__ valid,
    const int2* __restrict__ bounds, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int Tq, int S, int N, int Kh, int window, float scale, float softcap) {
  constexpr int F_BK = f_bk<H>();
  constexpr int LD = H + 8;        // bf16 row stride of the staged tiles
  constexpr int CPR = H / 8;       // 16-byte chunks per row
  constexpr int KSTEPS = H / 16;   // k-steps of Q K^T over the head dim
  constexpr int SNT = F_BK / 8;    // n-tiles of a score row block
  constexpr int ONT = H / 8;       // n-tiles of the output
  static_assert(H % 16 == 0 && F_BK % 16 == 0 && F_BQ == 16 * (F_NT / 32), "mma tiles");

  constexpr bool WG = f_wgmma<H>();
  constexpr int QK_LD = WG ? H : LD;  // bf16 per staged Q, K or V row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw;
  if (WG) {  // the swizzle pattern follows address bits: tiles start 1024-aligned
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
    base += (1024 - (a & 1023)) & 1023;
  }
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base);  // [BQ][QK_LD]
  __nv_bfloat16* sK = sQ + F_BQ * QK_LD;                         // [2][BK][QK_LD]
  __nv_bfloat16* sV = sK + 2 * F_BK * QK_LD;                     // [2][BK][QK_LD]
  int* sQpos = reinterpret_cast<int*>(sV + 2 * F_BK * QK_LD);    // [BQ]
  int* sKpos = sQpos + F_BQ;                                     // [2][BK]
  // Where element (r, c) of a staged Q, K or V tile of `rows` rows goes.
  auto qk_at = [](__nv_bfloat16* tile, int r, int c, int rows) {
    return WG ? reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<unsigned char*>(tile) +
                                                 swizzled(r, c, rows))
              : tile + r * LD + c;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * F_BQ;  // the longest q tiles first
  const int kh = n / (N / Kh);
  const int kv_end = min(S, valid[b]);
  // Without a soft-cap, scores stay unscaled and the scale rides in the
  // exponent: p = 2^(s*sl2 - m*sl2) with sl2 = scale*log2(e); m is kept in
  // the scores' own units and scaled back for the lse.
  const bool capped = softcap > 0.f;
  const float sl2 = capped ? kLog2e : scale * kLog2e;
  const float m_unit = capped ? 1.f : scale;

  // The q tile's rows go in flight first; its positions (and their bounds,
  // in every warp) and the first kv tile's bounds are read meanwhile.
  for (int idx = tid; idx < F_BQ * CPR; idx += F_NT) {
    const int i = idx / CPR, c = (idx % CPR) * 8, t = q0 + i;
    const size_t row = (static_cast<size_t>(b) * Tq + min(t, Tq - 1)) * N + n;
    cp_async16_zfill(qk_at(sQ, i, c, F_BQ), q + row * H + c, t < Tq);
  }
  cp_async_commit();
  const int n_tiles = (kv_end + F_BK - 1) / F_BK;
  const int2* tile_bounds = bounds + static_cast<size_t>(b) * ((S + F_BK - 1) / F_BK);
  const int2 first = n_tiles > 0 ? tile_bounds[0] : make_int2(INT_MAX, INT_MIN);
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = lane; i < F_BQ; i += 32) {
    const int t = q0 + i;
    const int qp = t < Tq ? qpos[static_cast<size_t>(b) * Tq + t] : INT_MIN;
    if (t < Tq) {
      qmin = min(qmin, qp);
      qmax = max(qmax, qp);
    }
    if (warp == 0) sQpos[i] = qp;
  }
  qmin = warp_min_i(qmin);
  qmax = warp_max_i(qmax);

  // The first live tile at or after j (n_tiles if none), and its bounds.
  auto next_live = [&](int j, int& kmin, int& kmax) {
    for (; j < n_tiles; ++j) {
      const int2 kb = j == 0 ? first : tile_bounds[j];
      kmin = kb.x;
      kmax = kb.y;
      if (tile_live(qmin, qmax, kmin, kmax, window)) return j;
    }
    return n_tiles;
  };
  // Every pair of tile j live: no per-pair mask, so no key positions staged.
  auto is_full = [&](int j, int kmin, int kmax) {
    return (j + 1) * F_BK <= kv_end && tile_full(qmin, qmax, kmin, kmax, window);
  };
  auto load_kv = [&](int j, int st, bool full) {
    const int j0 = j * F_BK;
    for (int idx = tid; idx < F_BK * CPR; idx += F_NT) {
      const int r = idx / CPR, c = (idx % CPR) * 8, s = j0 + r;
      const bool real = s < kv_end;
      const size_t off = ((static_cast<size_t>(b) * S + (real ? s : 0)) * Kh + kh) * H + c;
      cp_async16_zfill(qk_at(sK + st * F_BK * QK_LD, r, c, F_BK), k + off, real);
      cp_async16_zfill(qk_at(sV + st * F_BK * QK_LD, r, c, F_BK), v + off, real);
    }
    for (int r = tid; r < F_BK && !full; r += F_NT) {
      const int s = j0 + r;
      sKpos[st * F_BK + r] = s < kv_end ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
    }
  };

  int kmin = INT_MAX, kmax = INT_MIN;
  int j = next_live(0, kmin, kmax);
  if (j < n_tiles) load_kv(j, 0, is_full(j, kmin, kmax));
  cp_async_commit();

  const int r_lo = warp * 16 + (lane >> 2);  // this lane's two rows: r_lo and r_lo + 8
  const int cq = (lane & 3) * 2;             // and its column pair within an n-tile
  float oacc[ONT][4];
#pragma unroll
  for (int nt = 0; nt < ONT; ++nt) oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};  // this lane's share of the row sums
  constexpr bool QREG = !WG;  // mma.sync's Q fragments, held from the first tile on
  uint32_t qf[QREG ? KSTEPS : 1][4];
  bool have_q = false;
  int st = 0;

  while (j < n_tiles) {
    int kmin_n = INT_MAX, kmax_n = INT_MIN;
    const int jn = next_live(j + 1, kmin_n, kmax_n);
    if (jn < n_tiles) load_kv(jn, st ^ 1, is_full(jn, kmin_n, kmax_n));
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile j have landed (this thread's copies)
    if (WG) fence_proxy_async();  // for wgmma's reads
    __syncthreads();     // ... and every thread's
    if (QREG && !have_q) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        ldmatrix_x4(qf[QREG ? ks : 0],
                    sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      }
      have_q = true;
    }
    const __nv_bfloat16* tK = sK + st * F_BK * QK_LD;
    const __nv_bfloat16* tV = sV + st * F_BK * QK_LD;
    const int j0 = j * F_BK;

    // S = Q K^T for the warp's 16 rows.
    float sacc[SNT][4];
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
    if constexpr (WG) {
      // The warpgroup's 64 rows at once; k-step ks starts 32 bytes per
      // step into 64-column panel ks / 4 of each operand.
      const unsigned char* qb = reinterpret_cast<const unsigned char*>(sQ);
      const unsigned char* kb = reinterpret_cast<const unsigned char*>(tK);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int panel = ks >> 2, koff = (ks & 3) * 32;
        wgmma_bf16(sacc, wgmma_desc(qb + panel * F_BQ * 128 + koff),
                   wgmma_desc(kb + panel * F_BK * 128 + koff), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(sacc);
    }
#pragma unroll
    for (int ks = 0; ks < (WG ? 0 : KSTEPS); ++ks) {
      uint32_t qa[4];
      if (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[QREG ? ks : 0][e];
      } else {
        ldmatrix_x4(qa, sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < SNT; nt += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, tK + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[nt], qa, kb[0], kb[1]);
        mma_bf16(sacc[nt + 1], qa, kb[2], kb[3]);
      }
    }

    // Scale, soft-cap and, on a boundary tile, the pair mask.
    const bool full = is_full(j, kmin, kmax);
    const int qp0 = sQpos[r_lo], qp1 = sQpos[r_lo + 8];
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[nt][e];
        if (capped) s = tanhf(s * scale / softcap) * softcap;
        if (!full) {
          const int col = nt * 8 + cq + (e & 1);
          const bool ok = j0 + col < kv_end &&
                          attends(e < 2 ? qp0 : qp1, sKpos[st * F_BK + col], window);
          s = ok ? s : kNegInf;
        }
        sacc[nt][e] = s;
      }
    }

    // Online softmax of the lane's two rows (the 4 lanes of a row agree on
    // its max); l sums the unrounded p, P V reads p rounded to bf16.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
        mx = fmaxf(mx, fmaxf(sacc[nt][2 * hr], sacc[nt][2 * hr + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[hr], mx);
      const bool any = m_new > kNegInf * 0.5f;
      const float corr = any ? ex2((m_row[hr] - m_new) * sl2) : 1.f;
      const float mb = m_new * sl2;
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = any ? ex2(fmaf(sacc[nt][e], sl2, -mb)) : 0.f;
          psum += p;
          sacc[nt][e] = p;
        }
      }
      l_part[hr] = l_part[hr] * corr + psum;
      m_row[hr] = m_new;
#pragma unroll
      for (int nt = 0; nt < ONT; ++nt) {
        oacc[nt][2 * hr] *= corr;
        oacc[nt][2 * hr + 1] *= corr;
      }
    }
    uint32_t pf[F_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < F_BK / 16; ++kk) {
      pf[kk][0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      pf[kk][1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      pf[kk][2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
    }

    // O += P V.
    if constexpr (WG) {
      // Keys kk*16 on are 16 swizzled rows into each of V's panels.
      const unsigned char* vb = reinterpret_cast<const unsigned char*>(tV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F_BK / 16; ++kk) {
        wgmma_bf16_rs(oacc, pf[kk], wgmma_desc_mn(vb + kk * 16 * 128, F_BK * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(oacc);
    }
#pragma unroll
    for (int kk = 0; kk < (WG ? 0 : F_BK / 16); ++kk) {
#pragma unroll
      for (int nt = 0; nt < ONT; nt += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  nt * 8 + (lane >> 4) * 8);
        mma_bf16(oacc[nt], pf[kk], vb[0], vb[1]);
        mma_bf16(oacc[nt + 1], pf[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
    st ^= 1;
    j = jn;
    kmin = kmin_n;
    kmax = kmax_n;
  }
  cp_async_wait<0>();  // nothing may land after the block exits

  // Epilogue: the row sums over the 4 lanes of a row, then o and lse.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_part[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int t = q0 + r_lo + 8 * hr;
    if (t >= Tq) continue;
    __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * Tq + t) * N + n) * H + cq;
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      const float o0 = l > 0.f ? oacc[nt][2 * hr] / fmaxf(l, 1e-30f) : 0.f;
      const float o1 = l > 0.f ? oacc[nt][2 * hr + 1] / fmaxf(l, 1e-30f) : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) = __floats2bfloat162_rn(o0, o1);
    }
    if ((lane & 3) == 0) {
      lse[(static_cast<size_t>(b) * N + n) * Tq + t] =
          l > 0.f ? m_row[hr] * m_unit + logf(fmaxf(l, 1e-30f)) : kNegInf;
    }
  }
}

// bounds: scratch of B * ceil(S / 32) int2 (32: the smallest f_bk), filled by
// the first launch.
template <int H>
cudaError_t launch_bf16_tc(const void* q, const void* k, const void* v, const void* qpos,
                           const void* kpos, const void* valid, void* bounds, void* o, void* lse,
                           int B, int Tq, int S, int N, int Kh, int window, float scale,
                           float softcap, cudaStream_t stream) {
  constexpr int BK = f_bk<H>();
  constexpr size_t smem = f_smem_bytes<H>();
  auto kern = flash_fwd_bf16_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tile_bounds_kernel<BK><<<dim3((S + BK - 1) / BK, B), 32, 0, stream>>>(
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<int2*>(bounds), S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(N, B, (Tq + F_BQ - 1) / F_BQ);
  kern<<<grid, F_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<const int2*>(bounds), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      Tq, S, N, Kh, window, scale, softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* qpos,
                        const void* kpos, const void* valid, void* o, void* lse, int B, int Tq,
                        int S, int N, int Kh, int window, float scale, float softcap,
                        cudaStream_t stream) {
  constexpr int BQ = 32, BK = 64, NT = 128;
  constexpr size_t smem = (BQ * H + BK * (H + 1) + BK * H + BQ * BK + 3 * BQ) * sizeof(float) +
                          (BQ + BK) * sizeof(int);
  auto kern = flash_fwd_fp32_kernel<H, BQ, BK, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, N, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
      static_cast<const int32_t*>(valid), static_cast<float*>(o), static_cast<float*>(lse), Tq, S,
      N, Kh, window, scale, softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* qpos,
                   const void* kpos, const void* valid, void* bounds, void* o, void* lse, int B,
                   int Tq, int S, int N, int Kh, int window, float scale, float softcap,
                   cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fp32<H>(q, k, v, qpos, kpos, valid, o, lse, B, Tq, S, N, Kh, window, scale,
                            softcap, stream);
    case 1:
      return launch_bf16_tc<H>(q, k, v, qpos, kpos, valid, bounds, o, lse, B, Tq, S, N, Kh,
                               window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bounds: int32 scratch of 2 * B * ceil(S / 32)
// for the bf16 path (unused in fp32). All tensors contiguous; returns
// cudaGetLastError().
extern "C" int pt_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                            const void* qpos, const void* kpos, const void* valid, void* bounds,
                            void* o, void* lse, int B, int Tq, int S, int N, int Kh, int H,
                            int window, float scale, float softcap, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32:
      return launch<32>(dtype, q, k, v, qpos, kpos, valid, bounds, o, lse, B, Tq, S, N, Kh,
                        window, scale, softcap, st);
    case 64:
      return launch<64>(dtype, q, k, v, qpos, kpos, valid, bounds, o, lse, B, Tq, S, N, Kh,
                        window, scale, softcap, st);
    case 128:
      return launch<128>(dtype, q, k, v, qpos, kpos, valid, bounds, o, lse, B, Tq, S, N, Kh,
                         window, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
