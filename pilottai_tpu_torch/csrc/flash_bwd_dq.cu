// Causal GQA flash attention, backward for dq (K4) — hand-written CUDA for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pilottai_tpu/ops/pallas/flash_attention.py:
// _bwd_dq_kernel (pallas_call in _bwd_impl). For q, dO [B,T,N,H], k, v
// [B,S,K,H] (N = K*G query heads share a kv head), K1's lse rows and
// delta = rowsum(dO * O) - dlse, both fp32 [B,N,T], it recomputes the
// probabilities under K1's mask and accumulates dq in fp32:
//
//   attend(t, s) = kv_pos[s] <= q_pos[t]  and  s < valid[b]
//                  and (window <= 0 or q_pos[t] - kv_pos[s] < window)
//   s_c = (q . k) * scale, then t = tanh(s_c / softcap), s_c = t * softcap
//   p   = exp(s_c - lse) where attend and lse > NEG_INF, else 0
//   dp  = dO . v          ds = p * (dp - delta) * (1 - t^2 under softcap)
//   dq  = (ds . k) * scale, stored in q's dtype
//
// What bounds it on an H100: 6*H flops (3*H multiply-adds: s, dp, dq) per
// live (query, key, head) triple against T*N*H*2 + S*K*H*2 input elements,
// so at training lengths it is bounded by operations. One block owns a
// (batch row, head, q tile) — in fp32, 32 flattened (position, head) rows of
// one kv head: the q, dO, lse and delta rows are staged once and the block
// walks the live kv tiles, so dq needs no reduction across blocks and no
// intermediate leaves the block. Kv tiles in which no
// (query, key) pair is live are skipped (causal training visits about half
// of them) and keys at or past valid[b] are never visited. In bf16
// (flash_bwd_dq_bf16_tc_kernel, described above it) the three products run
// on wgmma, Hopper's warpgroup product, with s, dp, p and ds in registers
// and kv tiles streamed through a cp.async ring; ds is rounded to bf16 for
// the dq product as the TPU kernel rounds it to k's dtype, and dp's bf16
// products are exact in fp32, as the TPU kernel's fp32 widening makes them.
// In fp32 (flash_bwd_dq_fp32_kernel, described above it) the three products
// run on the tensor cores in 3xTF32, at fp32's accuracy and the
// fp32-accurate tensor-core rate (495e12 / 3 FLOP/s, where the CUDA cores
// cap full fp32 at 67e12), with the same tile rule, K and V streamed through
// a cp.async ring and shared by the G heads of a kv head; at the golden
// training shape it is latency-bound, which its two key groups a block
// answer.
// Head dims 32, 64, 128 and 256 (Gemma); the head_dim 256 instantiations
// are built from flash_bwd_dq_h256.cu, a source of their own, so nvcc
// compiles them in parallel with the others. Each body's note says what 256
// changes.
// Left on the table: S and dP read both operands from shared memory, and an
// m64n64k16 product reads as many bytes a cycle as shared memory delivers,
// so wider tiles or Q and dO held in registers would relieve it; TMA from
// a producer warp and two consumer warpgroups (one tile's products under
// the other's elementwise work); a persistent schedule; and sharing the
// recomputed p with K5 in one pass (dq would then need a reduction across
// blocks: atomics would break bit-identical repeats).

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

// fp32 path: the same function with all three products on the tensor cores
// in 3xTF32 (hopper.cuh), which keeps about fp32's accuracy. A block holds
// 32 rows, flattened (position, head) rows of one kv head of one batch row:
// row R = t*G + g is query position t of query head kh*G + g, so the G
// heads that share a kv head share each staged K and V tile. Grid (kv
// head, batch row, row tile), the last row tiles, the longest under causal
// positions, first. Four warps: two row warps of 16 rows, times two key
// groups. The block walks super-tiles of two kv tiles of BK keys, and key
// group k takes kv tile k of each, summing dq for its rows on its own; at
// the end group 1 hands its dq to group 0 through shared memory, which adds
// the two in a fixed order, scales and writes, so repeats are
// bit-identical. Per kv tile, each warp runs mma.sync m16n8k8 in 3xTF32 on
// its 16 rows:
//   S = Q K^T and dP = dO V^T, issued together: Q's and dO's split A
//     fragments held in registers for the whole walk at head_dim 32 (read
//     from shared memory and split at each use at 64 and 128, where they
//     would not fit beside dq), K and V read as B operands;
//   p and ds on S's and dP's accumulator registers: p = 2^(s scale log2(e)
//     - lse log2(e)), ds = p (dp - delta), times (1 - t^2) under a
//     soft-cap; a row past Tq or whose lse is NEG_INF carries lse = +inf
//     into the exponent, which gives p = 0;
//   dQ += dS K with dS's accumulator registers as the A operand in place:
//     the keys of each k8 step are permuted (column t holds key 2t, column
//     t + 4 key 2t + 1, as the accumulator does), and K's B elements are
//     read from the same permuted rows. Each tile's product sums in fresh
//     accumulators (one for the even and one for the odd k-steps, four
//     n-tiles a pass), added to dq on the CUDA cores: the tensor cores'
//     accumulation truncates, and its error would grow with every tile
//     summed into dq.
// Staged rows are H + 4 floats apart: an A-layout or K^T read (row g,
// column t) and a permuted K read (row 2t or 2t + 1, column g) then hit 32
// banks. K and V come through a 2-stage cp.async ring (keys past valid[b]
// zero-filled), so the next super-tile arrives while this one is computed.
// Kv tiles are live, full or masked pair by pair from the position bounds
// that the first launch (tile_bounds_kernel) writes to the bounds scratch,
// staged in shared memory once, against the block's and the warp's own
// row bounds, as in the bf16 body; a super-tile with no live kv tile is
// never loaded, and key positions are staged only for one that is not
// full.
// At the golden training shape (q [4,512,8,32]) the body is bound by
// latency, not by the card's rates: 512 blocks of 4 warps, each warp
// walking up to 4 super-tiles of ~290 mma.sync (dependent in threes) and
// ~250 split, load and elementwise instructions. Hence two warps a row
// (the key groups) on each block's walk and Q and dO held in registers,
// rather than wider tiles. At head_dim 256 (Gemma) a kv tile is 16 keys
// (q_bk): dq alone takes 128 registers a lane there, and the staged tiles
// of 32 keys would pass the 227 KB a block can have (2 * Q_BR + 4 * BKS
// rows of H + 4 floats: 333 KB at 32 keys, 200 KB at 16).
constexpr int Q_ROWW = 2;     // row warps, 16 rows each
constexpr int Q_GROUPS = 2;   // key groups
constexpr int Q_NT = 32 * Q_ROWW * Q_GROUPS;
constexpr int Q_BR = 16 * Q_ROWW;     // flattened rows a block
constexpr int kMaxSmem = 227 * 1024;  // an H100 block's dynamic shared memory
// Keys per kv tile, a key group's share of a super-tile.
template <int H> __host__ __device__ constexpr int q_bk() {
  return H == 256 ? 16 : H == 128 ? 32 : 64;
}
// Q's and dO's split fragments in registers (2H of them) at head_dim 32.
template <int H> __host__ __device__ constexpr bool q_reg() { return H == 32; }

// Dynamic shared memory for S keys: Q, dO, the two stages of K, V and key
// positions, then the kv tile bounds.
template <int H>
size_t q_smem_bytes(int S) {
  constexpr int BKS = Q_GROUPS * q_bk<H>();
  return static_cast<size_t>(2 * Q_BR + 4 * BKS) * (H + 4) * sizeof(float) +
         static_cast<size_t>(2 * BKS) * sizeof(int) +
         static_cast<size_t>((S + q_bk<H>() - 1) / q_bk<H>()) * sizeof(int2);
}

template <int H>
__global__ void __launch_bounds__(Q_NT) flash_bwd_dq_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const int32_t* __restrict__ valid,
    const int2* __restrict__ bounds, float* __restrict__ dq, int Tq, int S, int N, int Kh,
    int window, float scale, float softcap) {
  constexpr int BK = q_bk<H>();
  constexpr int BKS = Q_GROUPS * BK;      // keys a super-tile
  constexpr int LD = H + 4;               // fp32 row stride of the staged tiles
  constexpr int CPR = H / 4;              // 16-byte chunks per row
  constexpr int KSTEPS = H / 8;           // k-steps of S and dP over the head dim
  constexpr int SNT = BK / 8;             // n-tiles of a warp's s and dp
  constexpr int ONT = H / 8;              // n-tiles of dq
  constexpr int NCS = SNT < 4 ? SNT : 4;  // n-tiles of S and dP a pass
  constexpr int NC = ONT < 4 ? ONT : 4;   // n-tiles of dQ a pass
  constexpr bool QREG = q_reg<H>();
  static_assert(Q_BR == 32 && Q_GROUPS == 2, "one lane per block row; two key groups");

  extern __shared__ __align__(16) float smem_q[];
  float* sQ = smem_q;                                        // [BR][LD]
  float* sDO = sQ + Q_BR * LD;                               // [BR][LD]
  float* sK = sDO + Q_BR * LD;                               // [2][BKS][LD]
  float* sV = sK + 2 * BKS * LD;                             // [2][BKS][LD]
  int* sKpos = reinterpret_cast<int*>(sV + 2 * BKS * LD);    // [2][BKS]
  int2* sBounds = reinterpret_cast<int2*>(sKpos + 2 * BKS);  // [ceil(S / BK)]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % Q_ROWW, kg = warp / Q_ROWW;  // row warp, key group
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = N / Kh;
  const int n_rows = Tq * G;
  const int R0 = (gridDim.z - 1 - blockIdx.z) * Q_BR;  // the longest row tiles first
  const int kv_end = min(S, valid[b]);
  const bool capped = softcap > 0.f;
  const float sl2 = scale * kLog2e;
  const float inf = __int_as_float(0x7f800000);
  // Where flattened row R lives in q, dO and dq, and in lse and delta.
  auto row_off = [&](int R) {
    const int t = R / G;
    return ((static_cast<size_t>(b) * Tq + t) * N + kh * G + (R - t * G)) * H;
  };
  auto stat_off = [&](int R) {
    const int t = R / G;
    return (static_cast<size_t>(b) * N + kh * G + (R - t * G)) * Tq + t;
  };

  // The q and dO rows go in flight first (rows past the last zero-filled);
  // the bounds, positions and row statistics are read meanwhile.
  for (int idx = tid; idx < Q_BR * CPR; idx += Q_NT) {
    const int r = idx / CPR, c = (idx % CPR) * 4, R = R0 + r;
    const bool real = R < n_rows;
    const size_t off = row_off(real ? R : 0) + c;
    cp_async16_zfill(sQ + r * LD + c, q + off, real);
    cp_async16_zfill(sDO + r * LD + c, dout + off, real);
  }
  cp_async_commit();
  // The batch row's kv tile bounds, staged once: the walk reads them from
  // shared memory, not one dependent load from device memory a tile.
  const int2* tile_bounds = bounds + static_cast<size_t>(b) * ((S + BK - 1) / BK);
  for (int idx = tid; idx < (S + BK - 1) / BK; idx += Q_NT) sBounds[idx] = tile_bounds[idx];

  // Lane l reads block row l's position: the block's bounds come from every
  // lane, a row warp's from its half, each lane's two rows' by shuffle.
  const int Rl = R0 + lane;
  const bool real_l = Rl < n_rows;
  const int qp_l = real_l ? qpos[static_cast<size_t>(b) * Tq + Rl / G] : INT_MIN;
  int wqmin = real_l ? qp_l : INT_MAX, wqmax = qp_l;
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    wqmin = min(wqmin, __shfl_xor_sync(0xffffffffu, wqmin, off));
    wqmax = max(wqmax, __shfl_xor_sync(0xffffffffu, wqmax, off));
  }
  const int qmin = min(wqmin, __shfl_xor_sync(0xffffffffu, wqmin, 16));
  const int qmax = max(wqmax, __shfl_xor_sync(0xffffffffu, wqmax, 16));
  wqmin = __shfl_sync(0xffffffffu, wqmin, rw * 16);
  wqmax = __shfl_sync(0xffffffffu, wqmax, rw * 16);
  const int r_lo = rw * 16 + (lane >> 2);  // this lane's two rows: r_lo and r_lo + 8
  const int tq = lane & 3;
  const int cq = tq * 2;                   // and its column pair within an n-tile
  int qp[2];
  float lb[2], dl[2];  // lse * log2(e) (+inf where p is 0) and delta of the two rows
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int R = R0 + r_lo + 8 * hr;
    qp[hr] = __shfl_sync(0xffffffffu, qp_l, r_lo + 8 * hr);
    lb[hr] = inf;
    dl[hr] = 0.f;
    if (R < n_rows) {
      const float l = lse[stat_off(R)];
      lb[hr] = l > kNegInf * 0.5f ? l * kLog2e : inf;
      dl[hr] = delta[stat_off(R)];
    }
  }

  const int n_tiles = (kv_end + BK - 1) / BK;
  const int n_super = (n_tiles + Q_GROUPS - 1) / Q_GROUPS;
  __syncthreads();  // sBounds is staged
  // Whether kv tile jt can hold a live pair, or holds only live pairs, for
  // rows with positions in [lo, hi].
  auto tile_is_live = [&](int jt, int lo, int hi) {
    return jt < n_tiles && tile_live(lo, hi, sBounds[jt].x, sBounds[jt].y, window);
  };
  auto tile_is_full = [&](int jt, int lo, int hi) {
    return (jt + 1) * BK <= kv_end && tile_full(lo, hi, sBounds[jt].x, sBounds[jt].y, window);
  };
  // The first super-tile at or after J with a kv tile the block's rows can
  // attend (n_super if none).
  auto next_live = [&](int J) {
    for (; J < n_super; ++J) {
      if (tile_is_live(2 * J, qmin, qmax) || tile_is_live(2 * J + 1, qmin, qmax)) return J;
    }
    return n_super;
  };
  auto load_kv = [&](int J, int st) {
    const int j0 = J * BKS;
    for (int idx = tid; idx < BKS * CPR; idx += Q_NT) {
      const int r = idx / CPR, c = (idx % CPR) * 4, s = j0 + r;
      const bool real = s < kv_end;
      const size_t off = ((static_cast<size_t>(b) * S + (real ? s : 0)) * Kh + kh) * H + c;
      cp_async16_zfill(sK + (st * BKS + r) * LD + c, k + off, real);
      cp_async16_zfill(sV + (st * BKS + r) * LD + c, v + off, real);
    }
    // Key positions, unless every pair of both kv tiles is live.
    if (tile_is_full(2 * J, qmin, qmax) && tile_is_full(2 * J + 1, qmin, qmax)) return;
    for (int r = tid; r < BKS; r += Q_NT) {
      const int s = j0 + r;
      sKpos[st * BKS + r] = s < kv_end ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
    }
  };
  // The A fragment of k-step ks of a staged row tile (Q or dO): rows r_lo,
  // r_lo + 8, columns 8ks + tq, + 4.
  auto row_frag = [&](FragA& f, const float* tile, int ks) {
    const float* p = tile + r_lo * LD + ks * 8 + tq;
    split_a(f, p[0], p[8 * LD], p[4], p[8 * LD + 4]);
  };

  int J = next_live(0);
  if (J < n_super) load_kv(J, 0);
  cp_async_commit();

  float dqa[ONT][4];
#pragma unroll
  for (int nt = 0; nt < ONT; ++nt) dqa[nt][0] = dqa[nt][1] = dqa[nt][2] = dqa[nt][3] = 0.f;
  FragA qf[QREG ? KSTEPS : 1], df[QREG ? KSTEPS : 1];
  bool have_rows = false;
  int st = 0;

  while (J < n_super) {
    const int Jn = next_live(J + 1);
    if (Jn < n_super) load_kv(Jn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and super-tile J have landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    if (QREG && !have_rows) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        row_frag(qf[QREG ? ks : 0], sQ, ks);
        row_frag(df[QREG ? ks : 0], sDO, ks);
      }
      have_rows = true;
    }
    // This key group's kv tile; a warp whose rows attend nothing there
    // skips it.
    const int jt = J * Q_GROUPS + kg;
    if (tile_is_live(jt, wqmin, wqmax)) {
      const float* tK = sK + (st * BKS + kg * BK) * LD;
      const float* tV = sV + (st * BKS + kg * BK) * LD;
      const int* tKpos = sKpos + st * BKS + kg * BK;
      const int j0 = jt * BK;

      // S = Q K^T and dP = dO V^T for the warp's 16 rows, issued together.
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
        FragA rows[2];
        if (QREG) {
          rows[0] = qf[QREG ? ks : 0];
          rows[1] = df[QREG ? ks : 0];
        } else {
          row_frag(rows[0], sQ, ks);
          row_frag(rows[1], sDO, ks);
        }
#pragma unroll
        for (int c = 0; c < SNT; c += NCS) {
          FragB kvb[2][NCS];
#pragma unroll
          for (int i = 0; i < NCS; ++i) {
            const int at = ((c + i) * 8 + (lane >> 2)) * LD + ks * 8 + tq;
            split_b(kvb[0][i], tK[at], tK[at + 4]);
            split_b(kvb[1][i], tV[at], tV[at + 4]);
          }
          mma_3xtf32(sp, c, rows, kvb);
        }
      }

      // p and ds; on a boundary tile, the pair mask. s's registers keep ds.
      const bool full = tile_is_full(jt, wqmin, wqmax);
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float th = 0.f, p;
          if (capped) {
            th = tanhf(sacc[nt][e] * scale / softcap);
            p = ex2(th * softcap * kLog2e - lb[hr]);
          } else {
            p = ex2(fmaf(sacc[nt][e], sl2, -lb[hr]));
          }
          if (!full) {
            const int col = nt * 8 + cq + (e & 1);
            const bool ok = j0 + col < kv_end && attends(qp[hr], tKpos[col], window);
            p = ok ? p : 0.f;
          }
          float ds = p * (pacc[nt][e] - dl[hr]);
          if (capped) ds *= 1.f - th * th;
          sacc[nt][e] = ds;
        }
      }

      // dQ += dS K: n-tile kk of dS is k-step kk, its column tq key 2tq and
      // column tq + 4 key 2tq + 1; K's B elements come from those rows. The
      // tile's product sums in fresh accumulators, NC n-tiles a pass.
#pragma unroll
      for (int c = 0; c < ONT; c += NC) {
        float part[2][NC][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            part[u][i][0] = part[u][i][1] = part[u][i][2] = part[u][i][3] = 0.f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < SNT; kk += 2) {
          FragA da[2];
          FragB kb[2][NC];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            split_a(da[u], sacc[kk + u][0], sacc[kk + u][2], sacc[kk + u][1], sacc[kk + u][3]);
            const float* kr = tK + ((kk + u) * 8 + cq) * LD + (lane >> 2) + c * 8;
#pragma unroll
            for (int i = 0; i < NC; ++i) split_b(kb[u][i], kr[i * 8], kr[LD + i * 8]);
          }
          mma_3xtf32(part, 0, da, kb);
        }
#pragma unroll
        for (int i = 0; i < NC; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[c + i][e] += part[0][i][e] + part[1][i][e];
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
    st ^= 1;
    J = Jn;
  }
  cp_async_wait<0>();  // nothing may land after the block exits
  __syncthreads();     // the stages are free for the hand-over

  // Key group 1 hands its rows' dq to group 0 through the stages' memory;
  // group 0 adds the two, scales and writes.
  float* xo = sK;  // [BR][LD]
  if (kg == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r_lo + 8 * hr;
#pragma unroll
      for (int nt = 0; nt < ONT; ++nt) {
        *reinterpret_cast<float2*>(xo + row * LD + nt * 8 + cq) =
            make_float2(dqa[nt][2 * hr], dqa[nt][2 * hr + 1]);
      }
    }
  }
  __syncthreads();
  if (kg != 0) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r_lo + 8 * hr;
    const int R = R0 + row;
    if (R >= n_rows) continue;
    float* orow = dq + row_off(R) + cq;
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      const float2 x = *reinterpret_cast<const float2*>(xo + row * LD + nt * 8 + cq);
      *reinterpret_cast<float2*>(orow + nt * 8) =
          make_float2((dqa[nt][2 * hr] + x.x) * scale, (dqa[nt][2 * hr + 1] + x.y) * scale);
    }
  }
}

// bf16 path. A block is one warpgroup (4 warps, 128 threads) holding
// D_BQ = 64 query rows of one head. Per live kv tile of BK keys (64; 32 at
// head_dim 128, which keeps s, dp and dq of three blocks an SM in the
// register file without spilling):
//   S = Q K^T and dP = dO V^T: wgmma m64 x BK, both operands K-major panels
//     with the 128-byte swizzle (as K1's S), issued as two groups;
//   p on S's registers while dP is still computed: p = 2^(s scale log2(e) -
//     lse log2(e)); then ds = p (dp - delta), times (1 - t^2) under a
//     soft-cap, rounded to bf16 and packed as wgmma's register A operand;
//   dQ += dS K: wgmma m64 x H, K read as the MN-major B operand of the same
//     swizzled panels (as K1 reads V).
// s, dp, p and ds never touch shared memory; dQ stays in registers until
// the epilogue scales and rounds it. Head_dim 32 is staged zero-padded to
// one 64-column panel, so every product is wgmma at every head_dim. K and
// V tiles come through a 2-stage cp.async ring (keys past valid[b] and
// padded columns zero-filled), so the next tile's bytes arrive while this
// one is computed. A row whose lse is NEG_INF, or past Tq, carries
// lse = +inf into the exponent, which gives p = 0 exactly. At head_dim 256
// (Gemma) dQ's 64 x 256 fp32 accumulator takes 128 registers a thread on
// its own, so a block takes 32-key tiles and an SM one block (Q, dO and two
// stages of K and V are 129 KB of shared memory), and dS K is two
// m64n128k16 a k16 step, one per half of dQ's columns
// (wgmma_bf16_rs_rows), as K1's P V at 256.
//
// Tile liveness comes from position bounds, by K1's rule (tile_live,
// tile_full in hopper.cuh): a first small launch (tile_bounds_kernel)
// reduces each (batch row, kv tile) to its key-position bounds, each block
// reduces its own q rows', and a tile is skipped, taken whole (no mask, no
// key positions staged) or masked pair by pair. The grid walks q tiles
// from the last, the longest under causal positions, to the first.
constexpr int D_BQ = 64, D_NT = 128;
// Keys per kv tile.
template <int H> __host__ __device__ constexpr int d_bk() { return H >= 128 ? 32 : 64; }
// Blocks an SM: four from head_dim 64 down (a little spilling, measured
// faster than three without, and than 32-key tiles without), three at 128,
// one at 256 (shared memory; up to 255 registers a thread).
template <int H> constexpr int d_min_blocks() { return H == 256 ? 1 : H == 128 ? 3 : 4; }

template <int H>
constexpr size_t d_smem_bytes() {
  return 1024 + static_cast<size_t>(2 * D_BQ + 4 * d_bk<H>()) * staged_cols<H>() *
                    sizeof(__nv_bfloat16) +
         static_cast<size_t>(2 * d_bk<H>()) * sizeof(int);
}

template <int H>
__global__ void __launch_bounds__(D_NT, d_min_blocks<H>()) flash_bwd_dq_bf16_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
    const int32_t* __restrict__ valid, const int2* __restrict__ bounds,
    __nv_bfloat16* __restrict__ dq, int Tq, int S, int N, int Kh, int window, float scale,
    float softcap) {
  constexpr int BK = d_bk<H>();
  constexpr int HP = staged_cols<H>();
  constexpr int CPR = HP / 8;      // 16-byte chunks per staged row
  constexpr int KSTEPS = HP / 16;  // k-steps of S and dP over the head dim
  constexpr int SNT = BK / 8;      // n-tiles of s and dp
  constexpr int ONT = HP / 8;      // n-tiles of dq
  static_assert(D_BQ == 16 * (D_NT / 32) && BK % 16 == 0 && HP % 64 == 0, "wgmma tiles");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // The swizzle pattern follows address bits: tiles start 1024-aligned.
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((1024 - (smem_addr & 1023)) & 1023);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base);  // [BQ][HP]
  __nv_bfloat16* sDO = sQ + D_BQ * HP;                          // [BQ][HP]
  __nv_bfloat16* sK = sDO + D_BQ * HP;                          // [2][BK][HP]
  __nv_bfloat16* sV = sK + 2 * BK * HP;                         // [2][BK][HP]
  int* sKpos = reinterpret_cast<int*>(sV + 2 * BK * HP);        // [2][BK]
  auto at = [](__nv_bfloat16* tile, int r, int c, int rows) {
    return reinterpret_cast<unsigned char*>(tile) + swizzled(r, c, rows);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * D_BQ;  // the longest q tiles first
  const int kh = n / (N / Kh);
  const int kv_end = min(S, valid[b]);
  const bool capped = softcap > 0.f;
  const float sl2 = scale * kLog2e;
  const float inf = __int_as_float(0x7f800000);

  // The q and dO rows go in flight first (rows past Tq and padded columns
  // zero-filled); the rows' statistics and positions are read meanwhile.
  for (int idx = tid; idx < D_BQ * CPR; idx += D_NT) {
    const int i = idx / CPR, c = (idx % CPR) * 8, t = q0 + i;
    const bool real = t < Tq && c < H;
    const size_t off =
        ((static_cast<size_t>(b) * Tq + min(t, Tq - 1)) * N + n) * H + (c < H ? c : 0);
    cp_async16_zfill(at(sQ, i, c, D_BQ), q + off, real);
    cp_async16_zfill(at(sDO, i, c, D_BQ), dout + off, real);
  }
  cp_async_commit();
  const int r_lo = warp * 16 + (lane >> 2);  // this lane's two rows: r_lo and r_lo + 8
  const int cq = (lane & 3) * 2;             // and its column pair within an n-tile
  int qp[2];
  float lb[2], dl[2];  // lse * log2(e) (+inf where p is 0) and delta of the two rows
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = q0 + r_lo + 8 * hr;
    qp[hr] = INT_MIN;
    lb[hr] = inf;
    dl[hr] = 0.f;
    if (t < Tq) {
      const size_t row = (static_cast<size_t>(b) * N + n) * Tq + t;
      const float l = lse[row];
      qp[hr] = qpos[static_cast<size_t>(b) * Tq + t];
      lb[hr] = l > kNegInf * 0.5f ? l * kLog2e : inf;
      dl[hr] = delta[row];
    }
  }
  int qmin = INT_MAX, qmax = INT_MIN;  // over the tile's real rows, in every warp
  for (int i = lane; i < D_BQ; i += 32) {
    const int t = q0 + i;
    if (t < Tq) {
      const int p = qpos[static_cast<size_t>(b) * Tq + t];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
  qmin = warp_min_i(qmin);
  qmax = warp_max_i(qmax);

  const int n_tiles = (kv_end + BK - 1) / BK;
  const int2* kv_bounds = bounds + static_cast<size_t>(b) * ((S + BK - 1) / BK);
  // The first live tile at or after j (n_tiles if none), and its bounds.
  auto next_live = [&](int j, int& kmin, int& kmax) {
    for (; j < n_tiles; ++j) {
      const int2 kb = kv_bounds[j];
      kmin = kb.x;
      kmax = kb.y;
      if (tile_live(qmin, qmax, kmin, kmax, window)) return j;
    }
    return n_tiles;
  };
  auto is_full = [&](int j, int kmin, int kmax) {
    return (j + 1) * BK <= kv_end && tile_full(qmin, qmax, kmin, kmax, window);
  };
  auto load_kv = [&](int j, int st, bool full) {
    const int j0 = j * BK;
    for (int idx = tid; idx < BK * CPR; idx += D_NT) {
      const int r = idx / CPR, c = (idx % CPR) * 8, s = j0 + r;
      const bool real = s < kv_end && c < H;
      const size_t off =
          ((static_cast<size_t>(b) * S + (s < kv_end ? s : 0)) * Kh + kh) * H + (c < H ? c : 0);
      cp_async16_zfill(at(sK + st * BK * HP, r, c, BK), k + off, real);
      cp_async16_zfill(at(sV + st * BK * HP, r, c, BK), v + off, real);
    }
    for (int r = tid; r < BK && !full; r += D_NT) {
      const int s = j0 + r;
      sKpos[st * BK + r] = s < kv_end ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
    }
  };

  int kmin = INT_MAX, kmax = INT_MIN;
  int j = next_live(0, kmin, kmax);
  if (j < n_tiles) load_kv(j, 0, is_full(j, kmin, kmax));
  cp_async_commit();

  float dacc[ONT][4];
#pragma unroll
  for (int nt = 0; nt < ONT; ++nt) dacc[nt][0] = dacc[nt][1] = dacc[nt][2] = dacc[nt][3] = 0.f;
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(sQ);
  const unsigned char* dob = reinterpret_cast<const unsigned char*>(sDO);
  int st = 0;

  while (j < n_tiles) {
    int kmin_n = INT_MAX, kmax_n = INT_MIN;
    const int jn = next_live(j + 1, kmin_n, kmax_n);
    if (jn < n_tiles) load_kv(jn, st ^ 1, is_full(jn, kmin_n, kmax_n));
    cp_async_commit();
    cp_async_wait<1>();  // q, dO and tile j have landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();     // ... and every thread's
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(sK + st * BK * HP);
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(sV + st * BK * HP);

    // S = Q K^T and dP = dO V^T; k-step ks starts 32 bytes per step into
    // 64-column panel ks / 4 of each operand.
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
      wgmma_bf16(sacc, wgmma_desc(qb + panel * D_BQ * 128 + koff),
                 wgmma_desc(kb + panel * BK * 128 + koff), ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int panel = ks >> 2, koff = (ks & 3) * 32;
      wgmma_bf16(pacc, wgmma_desc(dob + panel * D_BQ * 128 + koff),
                 wgmma_desc(vb + panel * BK * 128 + koff), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S has landed; dP is still in flight
    wgmma_fence_operands(sacc);

    // p while dP is computed; on a boundary tile, the pair mask. s's
    // registers keep p, times (1 - t^2) under a soft-cap: ds's factor.
    const bool full = is_full(j, kmin, kmax);
    const int j0 = j * BK;
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float th = 0.f, p;
        if (capped) {
          th = tanhf(sacc[nt][e] * scale / softcap);
          p = ex2(th * softcap * kLog2e - lb[hr]);
        } else {
          p = ex2(fmaf(sacc[nt][e], sl2, -lb[hr]));
        }
        if (!full) {
          const int col = nt * 8 + cq + (e & 1);
          const bool ok = j0 + col < kv_end && attends(qp[hr], sKpos[st * BK + col], window);
          p = ok ? p : 0.f;
        }
        sacc[nt][e] = capped ? p * (1.f - th * th) : p;
      }
    }
    wgmma_wait<0>();
    wgmma_fence_operands(pacc);
    // ds, rounded to bf16 and packed as the A operand of dS K: n-tiles 2kk
    // and 2kk + 1 are k-step kk.
    uint32_t dsf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int e = 2 * hr;
        dsf[nt >> 1][(nt & 1) * 2 + hr] = pack_bf16(sacc[nt][e] * (pacc[nt][e] - dl[hr]),
                                                    sacc[nt][e + 1] * (pacc[nt][e + 1] - dl[hr]));
      }
    }

    // dQ += dS K: keys kk*16 on are 16 swizzled rows into each of K's panels.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_bf16_rs_rows(dacc, dsf[kk], kb + kk * 16 * 128, BK * 128);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(dacc);
    __syncthreads();  // every warp is done with stage st before it is refilled
    st ^= 1;
    j = jn;
    kmin = kmin_n;
    kmax = kmax_n;
  }
  cp_async_wait<0>();  // nothing may land after the block exits

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = q0 + r_lo + 8 * hr;
    if (t >= Tq) continue;
    __nv_bfloat16* row = dq + ((static_cast<size_t>(b) * Tq + t) * N + n) * H + cq;
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      if (nt * 8 >= H) continue;
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8) =
          __floats2bfloat162_rn(dacc[nt][2 * hr] * scale, dacc[nt][2 * hr + 1] * scale);
    }
  }
}

// bounds: scratch of B * ceil(S / 32) int2 (32: the smallest d_bk), filled by
// the first launch.
template <int H>
cudaError_t launch_bf16_tc(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* qpos, const void* kpos,
                           const void* valid, void* bounds, void* dq, int B, int Tq, int S, int N,
                           int Kh, int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int BK = d_bk<H>();
  constexpr size_t smem = d_smem_bytes<H>();
  auto kern = flash_bwd_dq_bf16_tc_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tile_bounds_kernel<BK><<<dim3((S + BK - 1) / BK, B), 32, 0, stream>>>(
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<int2*>(bounds), S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(N, B, (Tq + D_BQ - 1) / D_BQ);
  kern<<<grid, D_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
      static_cast<const int32_t*>(valid), static_cast<const int2*>(bounds),
      static_cast<__nv_bfloat16*>(dq), Tq, S, N, Kh, window, scale, softcap);
  return cudaGetLastError();
}

// bounds: scratch of B * ceil(S / 16) int2 (16: q_bk<256>), filled by the
// first launch.
template <int H>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* qpos, const void* kpos,
                        const void* valid, void* bounds, void* dq, int B, int Tq, int S, int N,
                        int Kh, int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int BK = q_bk<H>();
  const size_t smem = q_smem_bytes<H>(S);
  auto kern = flash_bwd_dq_fp32_kernel<H>;
  // Set once per instantiation, to the most a block may take; each launch
  // asks for what its S needs.
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  tile_bounds_kernel<BK><<<dim3((S + BK - 1) / BK, B), 32, 0, stream>>>(
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<int2*>(bounds), S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(Kh, B, (Tq * (N / Kh) + Q_BR - 1) / Q_BR);
  kern<<<grid, Q_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<const int2*>(bounds), static_cast<float*>(dq), Tq, S, N, Kh, window, scale,
      softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qpos, const void* kpos,
                   const void* valid, void* bounds, void* dq, int B, int Tq, int S, int N, int Kh,
                   int window, float scale, float softcap, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fp32<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq, S,
                            N, Kh, window, scale, softcap, stream);
    case 1:
      return launch_bf16_tc<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq, S,
                               N, Kh, window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are fp32 [B,N,T]; bounds:
// int32 scratch of 2 * B * ceil(S / 16), the kv tile bounds of the first launch;
// all tensors contiguous; dq in q's dtype. H: 32, 64 and 128, or 256 in the
// library built from flash_bwd_dq_h256.cu. Returns cudaGetLastError().
extern "C" int pt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               const void* qpos, const void* kpos, const void* valid,
                               void* bounds, void* dq, int B, int Tq, int S, int N, int Kh, int H,
                               int window, float scale, float softcap, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
#ifdef PT_BWD_HEAD_DIM_256
    case 256:
      return launch<256>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq,
                         S, N, Kh, window, scale, softcap, st);
#else
    case 32:
      return launch<32>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq, S,
                        N, Kh, window, scale, softcap, st);
    case 64:
      return launch<64>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq, S,
                        N, Kh, window, scale, softcap, st);
    case 128:
      return launch<128>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq,
                         S, N, Kh, window, scale, softcap, st);
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
