// Causal GQA flash attention, backward for dk and dv (K5) — hand-written
// CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel pilottai_tpu/ops/pallas/flash_attention.py:
// _bwd_dkv_kernel (pallas_call in _bwd_impl, reached through the custom_vjp
// rules). For q, dO [B,T,N,H], k, v [B,S,K,H] (N = K*G query heads share a
// kv head), K1's lse rows and delta = rowsum(dO * O) - dlse, both fp32
// [B,N,T], it recomputes the probabilities under K1's mask and accumulates,
// over the G query heads of each kv head and over every live q tile:
//
//   p  = exp(s_c - lse) where attend and lse > NEG_INF, else 0 (s_c, the
//        mask and the softcap as in K1 and K4)
//   dv += p^T . dO          ds = p * (dO . v - delta) * (1 - t^2 under softcap)
//   dk += ds^T . q * scale
//
// dk and dv leave the kernel in fp32; the wrapper casts them to k's dtype.
//
// What bounds it on an H100: 8*H flops (4*H multiply-adds: s, dp, dv, dk)
// per live (query, key, head) triple, so at training lengths it is bounded
// by operations. One block owns a (batch row, kv head, kv tile): its K and V
// tile stays resident, and the block loops over the live q tiles and the G
// query heads, accumulating dk and dv inside the block, as the TPU kernel's
// in-cell group sum does. No atomics and no reduction across blocks, so the
// gradients are the same bits on every run. q tiles in which no (query,
// key) pair is live are skipped (causal training visits about half of
// them), and a block whose keys all lie at or past valid[b] only writes
// zeros. In bf16 (flash_bwd_dkv_bf16_tc_kernel, described above it) the
// four products run on wgmma, Hopper's warpgroup product, with s, dp, p and
// ds in registers and the q-side operands streamed through a cp.async
// ring; p is rounded to bf16 for dv, ds to bf16 for dk, as the TPU kernel
// rounds them to v's and q's dtypes. In fp32 (flash_bwd_dkv_fp32_kernel,
// described above it) the four products run on the tensor cores in 3xTF32,
// at fp32's accuracy and the fp32-accurate tensor-core rate (495e12 / 3
// FLOP/s, where the CUDA cores cap full fp32 at 67e12), with the same
// ring, walk and tile rule.
// Head dims 32, 64, 128 and 256 (Gemma); the head_dim 256 instantiations
// are built from flash_bwd_dkv_h256.cu, a source of their own, so nvcc
// compiles them in parallel with the others. Each body's note says what 256
// changes.
// Left on the table: S^T and dP^T read both operands from shared memory,
// and an m64n64k16 product reads as many bytes a cycle as shared memory
// delivers, so K and V held in registers (they are resident) or wider
// tiles would relieve it, at the cost of registers that now buy
// occupancy; TMA from a producer warp and two consumer warpgroups sharing
// each q and dO tile (a 128-key block halves the q-side traffic and puts
// one warpgroup's products under the other's elementwise work); a
// persistent schedule; and sharing the recomputed p with K4 in one pass.

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

// fp32 path: the same function with all four products on the tensor cores
// in 3xTF32 (hopper.cuh), which keeps about fp32's accuracy. A block holds
// W_BK = 64 keys of one kv head with eight warps: four key warps of 16
// keys, times two q groups. Grid, item walk and tile rule are the bf16
// body's (below), with items of W_BQ = 64 q rows of one query head, and q
// group g takes rows 32g to 32g + 31 of every item, so two warps share
// each SM sub-partition's work on a key's walk (a lone warp walking every
// item would wait on its own products); at the end group 1 hands its dK
// and dV to group 0 through shared memory, which adds them in a fixed
// order and writes. At head_dim 32 each warp keeps its keys' K and V rows
// in registers for the whole walk, as the split A fragments of S^T and
// dP^T (64 registers; at 64 and 128 they would not fit beside dK and dV,
// and are read from shared memory and split at each use instead). Items
// come through a 3-stage ring (2 at head_dim 128 and 256, for shared memory). Per
// item, each warp runs mma.sync m16n8k8 in 3xTF32 on its 16 keys and 32
// q rows:
//   S^T = K Q^T and dP^T = V dO^T, Q and dO read as B operands;
//   p and ds on their accumulator registers (p = 2^(s scale log2(e) - lse
//     log2(e)), ds = p (dp - delta), times (1 - t^2) under a soft-cap);
//   dV += P^T dO and dK += dS^T Q with the accumulators as A operands in
//     place: the q rows of each k8 step are permuted (column t holds q row
//     2t, column t + 4 row 2t + 1, as the accumulator does), and dO's and
//     Q's B elements are read from the same permuted rows.
// Staged rows are H + 4 floats apart, so every fragment read hits 32
// banks. Items in which none of a warp's keys is live are skipped by that
// warp, and a warp whose every pair is live masks nothing. dK and dV stay
// in registers until the epilogue; no atomics, bit-identical repeats.
// At head_dim 256 (Gemma) dK and dV of a warp's 16 keys would take 256
// registers a lane, and K, V and one ring stage of 64 rows 400 KB of shared
// memory. So a block holds W_BK = 32 keys with its eight warps as two key
// warps, times two column halves, times two q groups, over items of 32 q
// rows (16 a group): a warp keeps its keys' dK and dV on its 128 columns
// only (128 registers), computes S^T and dP^T over all 256 as its partner
// on the other half does (the product's cost grows from 4 to 6 units of
// H multiply-adds a (key, q row) pair; sharing p and ds through shared memory
// would avoid that), and runs dV += P^T dO and dK += dS^T Q over its
// columns in passes of four n-tiles, each in fresh accumulators. K, V and
// a two-stage ring take 200 KB.
constexpr int W_QG = 2;    // q groups
constexpr int W_NT = 256;  // eight warps: key warps x column groups x q groups
// Keys a block (16 a key warp), column groups, q rows an item.
template <int H> __host__ __device__ constexpr int w_bk() { return H == 256 ? 32 : 64; }
template <int H> __host__ __device__ constexpr int w_ch() { return H == 256 ? 2 : 1; }
template <int H> __host__ __device__ constexpr int w_bq() { return H == 256 ? 32 : 64; }
// Items in the ring.
template <int H> __host__ __device__ constexpr int w_stages() { return H >= 128 ? 2 : 3; }
// An item of the walk: q tile i (-1 past the last) of query head g, and
// the q tile's position bounds.
struct Item {
  int i, g, qmin, qmax;
};
// K and V resident in registers as split fragments at head_dim 32.
template <int H> __host__ __device__ constexpr bool w_kvreg() { return H == 32; }

// Dynamic shared memory for Tq query rows: K, V, the ring, then the q tile
// bounds.
template <int H>
size_t w_smem_bytes(int Tq) {
  constexpr int W_BK = w_bk<H>(), W_BQ = w_bq<H>();
  return static_cast<size_t>(2 * W_BK + 2 * w_stages<H>() * W_BQ) * (H + 4) * sizeof(float) +
         static_cast<size_t>(w_stages<H>() * 3 * W_BQ) * sizeof(float) +
         static_cast<size_t>((Tq + W_BQ - 1) / W_BQ) * sizeof(int2);
}

template <int H>
__global__ void __launch_bounds__(W_NT, 1) flash_bwd_dkv_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const int32_t* __restrict__ valid,
    const int2* __restrict__ bounds, float* __restrict__ dk, float* __restrict__ dv, int Tq,
    int S, int N, int Kh, int window, float scale, float softcap) {
  constexpr int W_BK = w_bk<H>(), W_BQ = w_bq<H>(), W_CH = w_ch<H>();
  constexpr int W_KW = W_BK / 16;         // key warps, 16 keys each
  constexpr int W_GQ = W_BQ / W_QG;       // q rows a group takes of an item
  constexpr int LD = H + 4;               // fp32 row stride of the staged tiles
  constexpr int CPR = H / 4;              // 16-byte chunks per row
  constexpr int KSTEPS = H / 8;           // k-steps of S^T and dP^T over the head dim
  constexpr int SNT = W_GQ / 8;           // n-tiles of a warp's s^T and dp^T
  constexpr int ONT = H / 8 / W_CH;       // n-tiles of the warp's columns of dk and dv
  constexpr int NP = W_CH > 1 ? 4 : ONT;  // n-tiles a pass of the item's products
  constexpr int NC = NP < 4 ? NP : 4;     // n-tiles a product step
  constexpr int W_STAGES = w_stages<H>();
  constexpr bool KVREG = w_kvreg<H>();
  static_assert(32 * W_KW * W_CH * W_QG == W_NT && W_QG == 2,
                "a key warp owns 16 keys; column groups; two q groups");

  extern __shared__ __align__(16) float smem_w[];
  float* sK = smem_w;                                              // [BK][LD]
  float* sV = sK + W_BK * LD;                                      // [BK][LD]
  float* sQ = sV + W_BK * LD;                                      // [STAGES][BQ][LD]
  float* sDO = sQ + W_STAGES * W_BQ * LD;                          // [STAGES][BQ][LD]
  float* sLse = sDO + W_STAGES * W_BQ * LD;                        // [STAGES][BQ]
  float* sDelta = sLse + W_STAGES * W_BQ;                          // [STAGES][BQ]
  int* sQpos = reinterpret_cast<int*>(sDelta + W_STAGES * W_BQ);  // [STAGES][BQ]
  int2* sBounds = reinterpret_cast<int2*>(sQpos + W_STAGES * W_BQ);  // [ceil(Tq / BQ)]

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) % W_KW;             // key warp
  const int ch = (tid >> 5) / W_KW % W_CH;        // column group
  const int grp = (tid >> 5) / (W_KW * W_CH);     // q group
  const int c0 = ch * ONT * 8;                    // the warp's first column of dk and dv
  const int kh = blockIdx.x, b = blockIdx.y;
  const int j0 = blockIdx.z * W_BK;  // the first kv tiles, the longest, first
  const int G = N / Kh;
  const int kv_end = min(S, valid[b]);
  const bool capped = softcap > 0.f;
  const float sl2 = scale * kLog2e;
  const float inf = __int_as_float(0x7f800000);

  // K and V go in flight first (keys past valid[b] zero-filled); the keys'
  // positions and bounds are read meanwhile.
  for (int idx = tid; idx < W_BK * CPR; idx += W_NT) {
    const int r = idx / CPR, c = (idx % CPR) * 4, s = j0 + r;
    const bool real = s < kv_end;
    const size_t off = ((static_cast<size_t>(b) * S + (real ? s : 0)) * Kh + kh) * H + c;
    cp_async16_zfill(sK + r * LD + c, k + off, real);
    cp_async16_zfill(sV + r * LD + c, v + off, real);
  }
  cp_async_commit();
  // The batch row's q tile bounds, staged once: the walk reads them from
  // shared memory, not one dependent load from device memory a q tile.
  const int n_qt = (Tq + W_BQ - 1) / W_BQ;
  const int2* q_bounds = bounds + static_cast<size_t>(b) * n_qt;
  for (int idx = tid; idx < n_qt; idx += W_NT) sBounds[idx] = q_bounds[idx];
  const int r_lo = warp * 16 + (lane >> 2);  // this lane's two keys: r_lo and r_lo + 8
  const int tq = lane & 3;
  const int cq = tq * 2;                     // and its column pair within an n-tile
  int kp[2];
  bool key_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = j0 + r_lo + 8 * hr;
    key_ok[hr] = s < kv_end;
    kp[hr] = key_ok[hr] ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
  }
  // The block's key bounds (over every lane) and the warp's (lane l < 16
  // and l - 16 read the warp's key l % 16), over keys below valid[b].
  int kmin = INT_MAX, kmax = INT_MIN, wkmin = INT_MAX, wkmax = INT_MIN;
  for (int r = lane; r < W_BK; r += 32) {
    const int s = j0 + r;
    if (s < kv_end) {
      const int p = kpos[static_cast<size_t>(b) * S + s];
      kmin = min(kmin, p);
      kmax = max(kmax, p);
    }
  }
  {
    const int s = j0 + warp * 16 + (lane & 15);
    if (s < kv_end) wkmin = wkmax = kpos[static_cast<size_t>(b) * S + s];
  }
  kmin = warp_min_i(kmin);
  kmax = warp_max_i(kmax);
  wkmin = warp_min_i(wkmin);
  wkmax = warp_max_i(wkmax);
  const bool warp_keys_real = j0 + warp * 16 + 16 <= kv_end;
  __syncthreads();  // sBounds is staged

  // The first q tile at or before i that the block's keys can serve (-1 if
  // none), and its bounds.
  auto next_live = [&](int i, int& qmin, int& qmax) {
    for (; i >= 0; --i) {
      const int2 qb = sBounds[i];
      qmin = qb.x;
      qmax = qb.y;
      if (tile_live(qmin, qmax, kmin, kmax, window)) return i;
    }
    return -1;
  };
  auto load_item = [&](int i, int gi, int st) {
    const int t0 = i * W_BQ, nh = kh * G + gi;
    for (int idx = tid; idx < W_BQ * CPR; idx += W_NT) {
      const int r = idx / CPR, c = (idx % CPR) * 4, t = t0 + r;
      const size_t off = ((static_cast<size_t>(b) * Tq + min(t, Tq - 1)) * N + nh) * H + c;
      cp_async16_zfill(sQ + (st * W_BQ + r) * LD + c, q + off, t < Tq);
      cp_async16_zfill(sDO + (st * W_BQ + r) * LD + c, dout + off, t < Tq);
    }
    const size_t row = (static_cast<size_t>(b) * N + nh) * Tq;
    for (int idx = tid; idx < 3 * W_BQ; idx += W_NT) {
      const int which = idx / W_BQ, r = idx % W_BQ, t = t0 + r, tc = min(t, Tq - 1);
      if (which == 0) cp_async4_zfill(sLse + st * W_BQ + r, lse + row + tc, t < Tq);
      if (which == 1) cp_async4_zfill(sDelta + st * W_BQ + r, delta + row + tc, t < Tq);
      if (which == 2) {
        cp_async4_zfill(sQpos + st * W_BQ + r, qpos + static_cast<size_t>(b) * Tq + tc, t < Tq);
      }
    }
  };
  // The A fragment of k-step ks of a staged K or V tile: the warp's keys
  // r_lo, r_lo + 8, columns 8ks + tq, + 4.
  auto kv_frag = [&](FragA& f, const float* tile, int ks) {
    const float* p = tile + r_lo * LD + ks * 8 + tq;
    split_a(f, p[0], p[8 * LD], p[4], p[8 * LD + 4]);
  };

  // The next item: the next query head of this q tile, else the first head
  // of the next live q tile below it.
  auto advance = [&](Item it) {
    if (it.i >= 0 && ++it.g == G) {
      it.g = 0;
      it.i = next_live(it.i - 1, it.qmin, it.qmax);
    }
    return it;
  };
  // The items in flight: ring[0] is computed now, ring[s] is s items ahead
  // and sits in stage (st + s) % STAGES.
  Item ring[W_STAGES];
  ring[0] = Item{-1, 0, INT_MAX, INT_MIN};
  ring[0].i = next_live(n_qt - 1, ring[0].qmin, ring[0].qmax);
#pragma unroll
  for (int s = 1; s < W_STAGES; ++s) ring[s] = advance(ring[s - 1]);
#pragma unroll
  for (int s = 0; s + 1 < W_STAGES; ++s) {
    if (ring[s].i >= 0) load_item(ring[s].i, ring[s].g, s);
    cp_async_commit();
  }

  float acc[2][ONT][4];  // dV, then dK
#pragma unroll
  for (int nt = 0; nt < ONT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][nt][e] = acc[1][nt][e] = 0.f;
  }
  FragA kf[KVREG ? KSTEPS : 1], vf[KVREG ? KSTEPS : 1];
  bool have_kv = false;
  int st = 0;

  while (ring[0].i >= 0) {
    const int i = ring[0].i, qmin = ring[0].qmin, qmax = ring[0].qmax;
    const Item& ahead = ring[W_STAGES - 1];
    if (ahead.i >= 0) load_item(ahead.i, ahead.g, (st + W_STAGES - 1) % W_STAGES);
    cp_async_commit();
    cp_async_wait<W_STAGES - 1>();  // K, V and this item have landed (this thread's copies)
    __syncthreads();                // ... and every thread's
    if (KVREG && !have_kv) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        kv_frag(kf[KVREG ? ks : 0], sK, ks);
        kv_frag(vf[KVREG ? ks : 0], sV, ks);
      }
      have_kv = true;
    }
    if (tile_live(qmin, qmax, wkmin, wkmax, window)) {
      // This q group's rows of the item.
      const float* tQ = sQ + (st * W_BQ + grp * W_GQ) * LD;
      const float* tDO = sDO + (st * W_BQ + grp * W_GQ) * LD;
      const int sr = st * W_BQ + grp * W_GQ;  // its first row's statistics

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys, issued
      // together.
      float sp[2][SNT][4];
      auto& sacc = sp[0];
      auto& pacc = sp[1];
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] = pacc[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        FragA kva[2];
        if (KVREG) {
          kva[0] = kf[KVREG ? ks : 0];
          kva[1] = vf[KVREG ? ks : 0];
        } else {
          kv_frag(kva[0], sK, ks);
          kv_frag(kva[1], sV, ks);
        }
        FragB qdb[2][SNT];
#pragma unroll
        for (int nt = 0; nt < SNT; ++nt) {
          const int at = (nt * 8 + (lane >> 2)) * LD + ks * 8 + tq;
          split_b(qdb[0][nt], tQ[at], tQ[at + 4]);
          split_b(qdb[1][nt], tDO[at], tDO[at + 4]);
        }
        mma_3xtf32(sp, 0, kva, qdb);
      }

      // p and ds; on a boundary item, the pair mask. Column c of n-tile nt
      // is q row t0 + nt*8 + cq + (e & 1); a column past Tq or whose lse is
      // NEG_INF carries lse = +inf, which gives p = 0.
      const bool full = warp_keys_real && tile_full(qmin, qmax, wkmin, wkmax, window);
      const int t0 = i * W_BQ + grp * W_GQ;
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
        const int col = nt * 8 + cq;
        const float2 l2 = *reinterpret_cast<const float2*>(sLse + sr + col);
        const float2 d2 = *reinterpret_cast<const float2*>(sDelta + sr + col);
        const int2 p2 = *reinterpret_cast<const int2*>(sQpos + sr + col);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float l = u ? l2.y : l2.x;
          const float lb = t0 + col + u < Tq && l > kNegInf * 0.5f ? l * kLog2e : inf;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int e = 2 * hr + u;
            float th = 0.f, p;
            if (capped) {
              th = tanhf(sacc[nt][e] * scale / softcap);
              p = ex2(th * softcap * kLog2e - lb);
            } else {
              p = ex2(fmaf(sacc[nt][e], sl2, -lb));
            }
            if (!full) p = key_ok[hr] && attends(u ? p2.y : p2.x, kp[hr], window) ? p : 0.f;
            float ds = p * (pacc[nt][e] - (u ? d2.y : d2.x));
            if (capped) ds *= 1.f - th * th;
            sacc[nt][e] = p;
            pacc[nt][e] = ds;
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q over the warp's columns: n-tile kk of
      // P^T and dS^T is k-step kk, its column tq q row 2tq and column tq + 4
      // q row 2tq + 1; dO's and Q's B elements come from those rows. The
      // item's products sum in fresh accumulators, NP n-tiles a pass (all of
      // them below head_dim 256), added to dK and dV on the CUDA cores: the
      // tensor cores' accumulation truncates, and its error would grow with
      // every item summed into dK and dV.
#pragma unroll
      for (int p0 = 0; p0 < ONT; p0 += NP) {
        float item[2][NP][4];  // this item's dV and dK on the pass's n-tiles
#pragma unroll
        for (int nt = 0; nt < NP; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) item[0][nt][e] = item[1][nt][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < SNT; ++kk) {
          FragA pda[2];
          split_a(pda[0], sacc[kk][0], sacc[kk][2], sacc[kk][1], sacc[kk][3]);
          split_a(pda[1], pacc[kk][0], pacc[kk][2], pacc[kk][1], pacc[kk][3]);
          const int at = (kk * 8 + cq) * LD + (lane >> 2) + c0 + p0 * 8;
#pragma unroll
          for (int c = 0; c < NP; c += NC) {
            FragB oqb[2][NC];
#pragma unroll
            for (int i = 0; i < NC; ++i) {
              const int x = at + (c + i) * 8;
              split_b(oqb[0][i], tDO[x], tDO[x + LD]);
              split_b(oqb[1][i], tQ[x], tQ[x + LD]);
            }
            mma_3xtf32(item, c, pda, oqb);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int nt = 0; nt < NP; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][p0 + nt][e] += item[r][nt][e];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
    st = st + 1 == W_STAGES ? 0 : st + 1;
#pragma unroll
    for (int s = 0; s + 1 < W_STAGES; ++s) ring[s] = ring[s + 1];
    ring[W_STAGES - 1] = advance(ring[W_STAGES - 1]);
  }
  cp_async_wait<0>();  // nothing may land after the block exits
  __syncthreads();     // the ring is free for the hand-over

  // q group 1 hands its dV and dK to group 0 through the ring's memory;
  // group 0 adds them and writes. Every key below S is written: keys at or
  // past valid[b] get zeros.
  float* xacc = sQ;  // [2][BK][LD]
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* row = xacc + (r * W_BK + r_lo + 8 * hr) * LD + c0 + cq;
#pragma unroll
        for (int nt = 0; nt < ONT; ++nt) {
          *reinterpret_cast<float2*>(row + nt * 8) =
              make_float2(acc[r][nt][2 * hr], acc[r][nt][2 * hr + 1]);
        }
      }
    }
  }
  __syncthreads();
  if (grp != 0) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = j0 + r_lo + 8 * hr;
    if (s >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + s) * Kh + kh) * H + c0 + cq;
    const float* xv = xacc + (r_lo + 8 * hr) * LD + c0 + cq;
    const float* xk = xacc + (W_BK + r_lo + 8 * hr) * LD + c0 + cq;
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      const float2 v1 = *reinterpret_cast<const float2*>(xv + nt * 8);
      const float2 k1 = *reinterpret_cast<const float2*>(xk + nt * 8);
      *reinterpret_cast<float2*>(dk + off + nt * 8) =
          make_float2((acc[1][nt][2 * hr] + k1.x) * scale, (acc[1][nt][2 * hr + 1] + k1.y) * scale);
      *reinterpret_cast<float2*>(dv + off + nt * 8) =
          make_float2(acc[0][nt][2 * hr] + v1.x, acc[0][nt][2 * hr + 1] + v1.y);
    }
  }
}

// bf16 path. A block is one warpgroup (4 warps, 128 threads) holding
// V_BK = 64 keys of one kv head, its K and V rows staged once and resident.
// It walks the flattened sequence of (live q tile, query head) items, BQ q
// rows each (64; 32 at head_dim 128, where dK and dV alone take 128
// registers a thread), and per item:
//   S^T = K Q^T and dP^T = V dO^T: wgmma m64 x BQ, both operands K-major
//     panels with the 128-byte swizzle, issued as two groups;
//   p on S^T's registers while dP^T is still computed: the rows are keys and
//     the columns q rows, so each thread reads lse (and q positions, on a
//     boundary item) of the columns it holds from shared memory;
//     p = 2^(s scale log2(e) - lse log2(e)), rounded to bf16 and packed as
//     wgmma's register A operand;
//   dV += P^T dO: wgmma m64 x H, dO read as the MN-major B operand of the
//     same swizzled panels that dP^T read K-major;
//   ds = p (dp - delta), times (1 - t^2) under a soft-cap, rounded and
//     packed likewise, and dK += dS^T Q from Q's panels.
// s, dp, p and ds never touch shared memory; dK and dV stay in registers
// until the epilogue. Head_dim 32 is staged zero-padded to one 64-column
// panel, so every product is wgmma at every head_dim. The items' q, dO,
// lse, delta and q positions come through a 2-stage cp.async ring, so the
// next item (the next query head of the same q tile, or the next live q
// tile) arrives while this one is computed. A column whose lse is NEG_INF,
// or past Tq, carries lse = +inf into the exponent, which gives p = 0.
//
// Liveness comes from position bounds, by K1's rule (tile_live, tile_full
// in hopper.cuh): a first small launch (tile_bounds_kernel) reduces each
// (batch row, q tile) to its q-position bounds, each block reduces its own
// keys' (below valid[b]), and an item is skipped, taken whole (no mask) or
// masked pair by pair. The grid starts with the first kv tiles, which
// under causal positions have the most live q tiles; a block walks its q
// tiles from the last.
//
// At head_dim 256 (Gemma) dK and dV of 64 keys would take 256 registers a
// thread in one warpgroup, above the 255 a thread can have, and wgmma's M
// is 64 rows a warpgroup, so fewer keys would not help. So the block is two
// warpgroups over the same staged K, V and ring: each computes S^T and
// dP^T for all 64 keys and all 256 columns (the same products), and owns
// dK and dV on one half of the columns (128 registers), its P^T dO and dS^T
// Q one m64n128k16 a k16 step from its half's two panels of dO and Q. The
// doubled S^T and dP^T raise the work from 4 to 6 units of H multiply-adds
// a (key, q row) pair; passing p and ds between the warpgroups through
// shared memory would avoid that, at the price of a hand-over each item.
// K, V and the ring of 32-row items take 130 KB, one block an SM.
constexpr int V_BK = 64, V_NT = 128;  // keys a block, threads a warpgroup
// q rows per item.
template <int H> __host__ __device__ constexpr int v_bq() { return H >= 128 ? 32 : 64; }
// Warpgroups a block, each owning dK and dV on its share of the columns.
template <int H> __host__ __device__ constexpr int v_wg() { return H == 256 ? 2 : 1; }
// Blocks an SM: three from head_dim 64 down (a little spilling, measured
// faster than two without), two at 128, where dK and dV alone fill 128
// registers a thread, one at 256 (shared memory).
template <int H> constexpr int v_min_blocks() { return H == 256 ? 1 : H == 128 ? 2 : 3; }

template <int H>
constexpr size_t v_smem_bytes() {
  return 1024 + static_cast<size_t>(2 * V_BK + 4 * v_bq<H>()) * staged_cols<H>() *
                    sizeof(__nv_bfloat16) +
         static_cast<size_t>(2 * 3 * v_bq<H>()) * sizeof(float);
}

template <int H>
__global__ void __launch_bounds__(V_NT * v_wg<H>(), v_min_blocks<H>())
    flash_bwd_dkv_bf16_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
    const int32_t* __restrict__ valid, const int2* __restrict__ bounds, float* __restrict__ dk,
    float* __restrict__ dv, int Tq, int S, int N, int Kh, int window, float scale,
    float softcap) {
  constexpr int BQ = v_bq<H>();
  constexpr int WG = v_wg<H>();
  constexpr int NT = V_NT * WG;     // threads a block
  constexpr int HP = staged_cols<H>();
  constexpr int CPR = HP / 8;       // 16-byte chunks per staged row
  constexpr int KSTEPS = HP / 16;   // k-steps of S^T and dP^T over the head dim
  constexpr int SNT = BQ / 8;       // n-tiles of s^T and dp^T
  constexpr int ONT = HP / 8 / WG;  // n-tiles of the warpgroup's columns of dk and dv
  static_assert(V_BK == 16 * (V_NT / 32) && BQ % 16 == 0 && HP % (64 * WG) == 0,
                "wgmma tiles");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // The swizzle pattern follows address bits: tiles start 1024-aligned.
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((1024 - (smem_addr & 1023)) & 1023);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(base);  // [BK][HP]
  __nv_bfloat16* sV = sK + V_BK * HP;                           // [BK][HP]
  __nv_bfloat16* sQ = sV + V_BK * HP;                           // [2][BQ][HP]
  __nv_bfloat16* sDO = sQ + 2 * BQ * HP;                        // [2][BQ][HP]
  float* sLse = reinterpret_cast<float*>(sDO + 2 * BQ * HP);    // [2][BQ]
  float* sDelta = sLse + 2 * BQ;                                // [2][BQ]
  int* sQpos = reinterpret_cast<int*>(sDelta + 2 * BQ);         // [2][BQ]
  auto at = [](__nv_bfloat16* tile, int r, int c, int rows) {
    return reinterpret_cast<unsigned char*>(tile) + swizzled(r, c, rows);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) % 4;
  const int wg = tid / V_NT;                 // the warpgroup: its share of the columns
  const int c0 = wg * ONT * 8;               // the warpgroup's first column
  const int kh = blockIdx.x, b = blockIdx.y;
  const int j0 = blockIdx.z * V_BK;  // the first kv tiles, the longest, first
  const int G = N / Kh;
  const int kv_end = min(S, valid[b]);
  const bool capped = softcap > 0.f;
  const float sl2 = scale * kLog2e;
  const float inf = __int_as_float(0x7f800000);

  // K and V go in flight first (keys past valid[b] and padded columns
  // zero-filled); the keys' positions and bounds are read meanwhile.
  for (int idx = tid; idx < V_BK * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * 8, s = j0 + r;
    const bool real = s < kv_end && c < H;
    const size_t off =
        ((static_cast<size_t>(b) * S + (s < kv_end ? s : 0)) * Kh + kh) * H + (c < H ? c : 0);
    cp_async16_zfill(at(sK, r, c, V_BK), k + off, real);
    cp_async16_zfill(at(sV, r, c, V_BK), v + off, real);
  }
  cp_async_commit();
  const int r_lo = warp * 16 + (lane >> 2);  // this lane's two keys: r_lo and r_lo + 8
  const int cq = (lane & 3) * 2;             // and its column pair within an n-tile
  int kp[2];
  bool key_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = j0 + r_lo + 8 * hr;
    key_ok[hr] = s < kv_end;
    kp[hr] = key_ok[hr] ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
  }
  int kmin = INT_MAX, kmax = INT_MIN;  // over the tile's keys below valid[b], in every warp
  for (int r = lane; r < V_BK; r += 32) {
    const int s = j0 + r;
    if (s < kv_end) {
      const int p = kpos[static_cast<size_t>(b) * S + s];
      kmin = min(kmin, p);
      kmax = max(kmax, p);
    }
  }
  kmin = warp_min_i(kmin);
  kmax = warp_max_i(kmax);

  const int n_qt = (Tq + BQ - 1) / BQ;
  const int2* q_bounds = bounds + static_cast<size_t>(b) * n_qt;
  // The first live q tile at or before i (-1 if none), and its bounds.
  auto next_live = [&](int i, int& qmin, int& qmax) {
    for (; i >= 0; --i) {
      const int2 qb = q_bounds[i];
      qmin = qb.x;
      qmax = qb.y;
      if (tile_live(qmin, qmax, kmin, kmax, window)) return i;
    }
    return -1;
  };
  auto load_item = [&](int i, int g, int st) {
    const int t0 = i * BQ, nh = kh * G + g;
    for (int idx = tid; idx < BQ * CPR; idx += NT) {
      const int r = idx / CPR, c = (idx % CPR) * 8, t = t0 + r;
      const bool real = t < Tq && c < H;
      const size_t off =
          ((static_cast<size_t>(b) * Tq + min(t, Tq - 1)) * N + nh) * H + (c < H ? c : 0);
      cp_async16_zfill(at(sQ + st * BQ * HP, r, c, BQ), q + off, real);
      cp_async16_zfill(at(sDO + st * BQ * HP, r, c, BQ), dout + off, real);
    }
    const size_t row = (static_cast<size_t>(b) * N + nh) * Tq;
    for (int idx = tid; idx < 3 * BQ; idx += NT) {
      const int which = idx / BQ, r = idx % BQ, t = t0 + r, tc = min(t, Tq - 1);
      if (which == 0) cp_async4_zfill(sLse + st * BQ + r, lse + row + tc, t < Tq);
      if (which == 1) cp_async4_zfill(sDelta + st * BQ + r, delta + row + tc, t < Tq);
      if (which == 2) {
        cp_async4_zfill(sQpos + st * BQ + r, qpos + static_cast<size_t>(b) * Tq + tc, t < Tq);
      }
    }
  };

  int qmin = INT_MAX, qmax = INT_MIN;
  int i = next_live(n_qt - 1, qmin, qmax), g = 0;
  if (i >= 0) load_item(i, 0, 0);
  cp_async_commit();

  float dk_acc[ONT][4], dv_acc[ONT][4];
#pragma unroll
  for (int nt = 0; nt < ONT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  }
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(sK);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(sV);
  int st = 0;

  while (i >= 0) {
    // The next item: the next query head of this q tile, else the first
    // head of the next live q tile below it.
    int in = i, gn = g + 1, qmin_n = qmin, qmax_n = qmax;
    if (gn == G) {
      gn = 0;
      in = next_live(i - 1, qmin_n, qmax_n);
    }
    if (in >= 0) load_item(in, gn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this item have landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();     // ... and every thread's
    const unsigned char* qb = reinterpret_cast<const unsigned char*>(sQ + st * BQ * HP);
    const unsigned char* dob = reinterpret_cast<const unsigned char*>(sDO + st * BQ * HP);

    // S^T = K Q^T and dP^T = V dO^T; k-step ks starts 32 bytes per step
    // into 64-column panel ks / 4 of each operand.
    float sacc[SNT][4], pacc[SNT][4];
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = pacc[nt][e] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int panel = ks >> 2, koff = (ks & 3) * 32;
      wgmma_bf16(sacc, wgmma_desc(kb + panel * V_BK * 128 + koff),
                 wgmma_desc(qb + panel * BQ * 128 + koff), ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int panel = ks >> 2, koff = (ks & 3) * 32;
      wgmma_bf16(pacc, wgmma_desc(vb + panel * V_BK * 128 + koff),
                 wgmma_desc(dob + panel * BQ * 128 + koff), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T has landed; dP^T is still in flight
    wgmma_fence_operands(sacc);

    // p while dP^T is computed, packed as the A operand of P^T dO; on a
    // boundary item, the pair mask. Column c of n-tile nt is q row
    // t0 + nt*8 + cq + (e & 1). s^T's registers keep p, times (1 - t^2)
    // under a soft-cap: ds's factor.
    const bool full = j0 + V_BK <= kv_end && tile_full(qmin, qmax, kmin, kmax, window);
    const int t0 = i * BQ;
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) {
      const int col = nt * 8 + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(sLse + st * BQ + col);
      const int2 p2 = *reinterpret_cast<const int2*>(sQpos + st * BQ + col);
      float lb[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float l = u ? l2.y : l2.x;
        lb[u] = t0 + col + u < Tq && l > kNegInf * 0.5f ? l * kLog2e : inf;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float pu[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * hr + u;
          float th = 0.f, p;
          if (capped) {
            th = tanhf(sacc[nt][e] * scale / softcap);
            p = ex2(th * softcap * kLog2e - lb[u]);
          } else {
            p = ex2(fmaf(sacc[nt][e], sl2, -lb[u]));
          }
          if (!full) p = key_ok[hr] && attends(u ? p2.y : p2.x, kp[hr], window) ? p : 0.f;
          pu[u] = p;
          sacc[nt][e] = capped ? p * (1.f - th * th) : p;
        }
        pf[nt >> 1][(nt & 1) * 2 + hr] = pack_bf16(pu[0], pu[1]);
      }
    }

    // dV += P^T dO on the warpgroup's columns: q rows kk*16 on are 16
    // swizzled rows into each of its panels of dO.
    const int half = c0 / 64 * BQ * 128;  // the warpgroup's first panel of dO and Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_bf16_rs_rows(dv_acc, pf[kk], dob + half + kk * 16 * 128, BQ * 128);
    }
    wgmma_commit();
    wgmma_wait<0>();  // dP^T and P^T dO have landed: P^T's registers are free
    wgmma_fence_operands(pf);
    wgmma_fence_operands(pacc);
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) {
      const float2 d2 = *reinterpret_cast<const float2*>(sDelta + st * BQ + nt * 8 + cq);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int e = 2 * hr;
        dsf[nt >> 1][(nt & 1) * 2 + hr] = pack_bf16(sacc[nt][e] * (pacc[nt][e] - d2.x),
                                                    sacc[nt][e + 1] * (pacc[nt][e + 1] - d2.y));
      }
    }

    // dK += dS^T Q, from the same panels of Q that S^T read K-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_bf16_rs_rows(dk_acc, dsf[kk], qb + half + kk * 16 * 128, BQ * 128);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(dv_acc);
    wgmma_fence_operands(dk_acc);
    __syncthreads();  // every warp is done with stage st before it is refilled
    st ^= 1;
    i = in;
    g = gn;
    qmin = qmin_n;
    qmax = qmax_n;
  }
  cp_async_wait<0>();  // nothing may land after the block exits

  // Every key below S is written: keys at or past valid[b] get zeros.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = j0 + r_lo + 8 * hr;
    if (s >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + s) * Kh + kh) * H + c0 + cq;
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      if (c0 + nt * 8 >= H) continue;
      *reinterpret_cast<float2*>(dk + off + nt * 8) =
          make_float2(dk_acc[nt][2 * hr] * scale, dk_acc[nt][2 * hr + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + nt * 8) =
          make_float2(dv_acc[nt][2 * hr], dv_acc[nt][2 * hr + 1]);
    }
  }
}

// bounds: scratch of B * ceil(Tq / 32) int2 (32: the smallest v_bq), filled
// by the first launch.
template <int H>
cudaError_t launch_bf16_tc(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* qpos, const void* kpos,
                           const void* valid, void* bounds, void* dk, void* dv, int B, int Tq,
                           int S, int N, int Kh, int window, float scale, float softcap,
                           cudaStream_t stream) {
  constexpr int BQ = v_bq<H>();
  constexpr size_t smem = v_smem_bytes<H>();
  auto kern = flash_bwd_dkv_bf16_tc_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tile_bounds_kernel<BQ><<<dim3((Tq + BQ - 1) / BQ, B), 32, 0, stream>>>(
      static_cast<const int32_t*>(qpos), nullptr, static_cast<int2*>(bounds), Tq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(Kh, B, (S + V_BK - 1) / V_BK);
  kern<<<grid, V_NT * v_wg<H>(), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
      static_cast<const int32_t*>(valid), static_cast<const int2*>(bounds),
      static_cast<float*>(dk), static_cast<float*>(dv), Tq, S, N, Kh, window, scale, softcap);
  return cudaGetLastError();
}

// bounds: scratch of B * ceil(Tq / 32) int2, filled by the first launch.
template <int H>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* qpos, const void* kpos,
                        const void* valid, void* bounds, void* dk, void* dv, int B, int Tq, int S,
                        int N, int Kh, int window, float scale, float softcap,
                        cudaStream_t stream) {
  constexpr int W_BK = w_bk<H>(), W_BQ = w_bq<H>();
  const size_t smem = w_smem_bytes<H>(Tq);
  auto kern = flash_bwd_dkv_fp32_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tile_bounds_kernel<W_BQ><<<dim3((Tq + W_BQ - 1) / W_BQ, B), 32, 0, stream>>>(
      static_cast<const int32_t*>(qpos), nullptr, static_cast<int2*>(bounds), Tq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(Kh, B, (S + W_BK - 1) / W_BK);
  kern<<<grid, W_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<const int2*>(bounds), static_cast<float*>(dk), static_cast<float*>(dv), Tq, S,
      N, Kh, window, scale, softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qpos, const void* kpos,
                   const void* valid, void* bounds, void* dk, void* dv, int B, int Tq, int S,
                   int N, int Kh, int window, float scale, float softcap, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fp32<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B, Tq,
                            S, N, Kh, window, scale, softcap, stream);
    case 1:
      return launch_bf16_tc<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B, Tq,
                               S, N, Kh, window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are fp32 [B,N,T]; bounds:
// int32 scratch of 2 * B * ceil(T / 32), where the first launch puts the q
// tiles' position bounds; all tensors contiguous; dk and dv fp32 [B,S,K,H].
// H: 32, 64 and 128, or 256 in the library built from flash_bwd_dkv_h256.cu.
// Returns cudaGetLastError().
extern "C" int pt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                const void* qpos, const void* kpos, const void* valid,
                                void* bounds, void* dk, void* dv, int B, int Tq, int S, int N,
                                int Kh, int H, int window, float scale, float softcap,
                                void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
#ifdef PT_BWD_HEAD_DIM_256
    case 256:
      return launch<256>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B,
                         Tq, S, N, Kh, window, scale, softcap, st);
#else
    case 32:
      return launch<32>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B, Tq,
                        S, N, Kh, window, scale, softcap, st);
    case 64:
      return launch<64>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B, Tq,
                        S, N, Kh, window, scale, softcap, st);
    case 128:
      return launch<128>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B,
                         Tq, S, N, Kh, window, scale, softcap, st);
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
