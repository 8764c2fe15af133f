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
// (batch row, query head, q tile): the q, dO, lse and delta rows are staged
// once and the block walks the live kv tiles, so dq needs no reduction
// across blocks and no intermediate leaves the block. Kv tiles in which no
// (query, key) pair is live are skipped (causal training visits about half
// of them) and keys at or past valid[b] are never visited. In bf16
// (flash_bwd_dq_bf16_tc_kernel, described above it) the three products run
// on wgmma, Hopper's warpgroup product, with s, dp, p and ds in registers
// and kv tiles streamed through a cp.async ring; ds is rounded to bf16 for
// the dq product as the TPU kernel rounds it to k's dtype, and dp's bf16
// products are exact in fp32, as the TPU kernel's fp32 widening makes them.
// In fp32 every product runs on the CUDA cores in full fp32 (never TF32), so
// it matches the reference up to summation order.
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

// fp32 path. A block holds BQ query rows of one head; per kv tile of BK
// keys, K and V are staged with rows padded to H+1 floats (a warp reading
// 32 keys hits 32 banks), each thread computes BQ*BK/NT (s, dp, ds)
// triples, and each thread accumulates its dq column for BQ*H/NT rows.
template <int H, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT) flash_bwd_dq_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const int32_t* __restrict__ valid, float* __restrict__ dq,
    int Tq, int S, int N, int Kh, int window, float scale, float softcap) {
  static_assert(NT % H == 0, "each column is owned by NT / H threads");
  constexpr int COLS_GROUPS = NT / H;
  constexpr int RPT = BQ / COLS_GROUPS;  // rows accumulated per thread
  constexpr int KS = H + 1;

  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][H]
  float* sDO = sQ + BQ * H;         // [BQ][H]
  float* sK = sDO + BQ * H;         // [BK][H+1]
  float* sV = sK + BK * KS;         // [BK][H+1]
  float* sDS = sV + BK * KS;        // [BQ][BK]
  float* sLse = sDS + BQ * BK;      // [BQ]
  float* sDelta = sLse + BQ;        // [BQ]
  int* sQpos = reinterpret_cast<int*>(sDelta + BQ);  // [BQ]
  int* sKpos = sQpos + BQ;                           // [BK]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = n / (N / Kh);
  const int kv_end = min(S, valid[b]);

  for (int idx = tid; idx < BQ * H; idx += NT) {
    const int i = idx / H, h = idx % H, t = q0 + i;
    const size_t off = ((static_cast<size_t>(b) * Tq + t) * N + n) * H + h;
    sQ[idx] = t < Tq ? q[off] : 0.f;
    sDO[idx] = t < Tq ? dout[off] : 0.f;
  }
  for (int i = tid; i < BQ; i += NT) {
    const int t = q0 + i;
    const size_t row = (static_cast<size_t>(b) * N + n) * Tq + t;
    sQpos[i] = t < Tq ? qpos[static_cast<size_t>(b) * Tq + t] : INT_MIN;
    sLse[i] = t < Tq ? lse[row] : kNegInf;
    sDelta[i] = t < Tq ? delta[row] : 0.f;
  }

  const int h = tid % H;
  const int r0 = tid / H;
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // the previous tile's readers are done with sK/sV/sDS/sKpos
    for (int j = tid; j < BK; j += NT) {
      const int s = j0 + j;
      sKpos[j] = s < kv_end ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
    }
    __syncthreads();
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
      sK[j * KS + hh] = kx;
      sV[j * KS + hh] = vx;
    }
    __syncthreads();

    for (int idx = tid; idx < BQ * BK; idx += NT) {
      const int i = idx / BK, j = idx % BK;
      const float* qr = sQ + i * H;
      const float* dr = sDO + i * H;
      const float* kr = sK + j * KS;
      const float* vr = sV + j * KS;
      float dot = 0.f, dp = 0.f;
#pragma unroll 16
      for (int hh = 0; hh < H; ++hh) {
        dot = fmaf(qr[hh], kr[hh], dot);
        dp = fmaf(dr[hh], vr[hh], dp);
      }
      float s = dot * scale, th = 0.f;
      if (softcap > 0.f) {
        th = tanhf(s / softcap);
        s = th * softcap;
      }
      const bool ok = q0 + i < Tq && j0 + j < kv_end && sLse[i] > kNegInf * 0.5f &&
                      attends(sQpos[i], sKpos[j], window);
      const float p = ok ? expf(s - sLse[i]) : 0.f;
      float ds = p * (dp - sDelta[i]);
      if (softcap > 0.f) ds *= 1.f - th * th;
      sDS[idx] = ds;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float* dsr = sDS + (r0 + r * COLS_GROUPS) * BK;
      float a = acc[r];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(dsr[j], sK[j * KS + h], a);
      acc[r] = a;
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = q0 + r0 + r * COLS_GROUPS;
    if (t < Tq) dq[((static_cast<size_t>(b) * Tq + t) * N + n) * H + h] = acc[r] * scale;
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
// lse = +inf into the exponent, which gives p = 0 exactly.
//
// Tile liveness comes from position bounds, by K1's rule (tile_live,
// tile_full in hopper.cuh): a first small launch (tile_bounds_kernel)
// reduces each (batch row, kv tile) to its key-position bounds, each block
// reduces its own q rows', and a tile is skipped, taken whole (no mask, no
// key positions staged) or masked pair by pair. The grid walks q tiles
// from the last, the longest under causal positions, to the first.
constexpr int D_BQ = 64, D_NT = 128;
// Keys per kv tile.
template <int H> __host__ __device__ constexpr int d_bk() { return H == 128 ? 32 : 64; }
// Blocks an SM: four from head_dim 64 down (a little spilling, measured
// faster than three without, and than 32-key tiles without), three at 128.
template <int H> constexpr int d_min_blocks() { return H == 128 ? 3 : 4; }

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
      wgmma_bf16_rs(dacc, dsf[kk], wgmma_desc_mn(kb + kk * 16 * 128, BK * 128));
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

template <int H>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* qpos, const void* kpos,
                        const void* valid, void* dq, int B, int Tq, int S, int N, int Kh,
                        int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int BQ = 32, BK = 64, NT = 128;
  constexpr size_t smem = (2 * BQ * H + 2 * BK * (H + 1) + BQ * BK + 2 * BQ) * sizeof(float) +
                          (BQ + BK) * sizeof(int);
  auto kern = flash_bwd_dq_fp32_kernel<H, BQ, BK, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, N, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<float*>(dq), Tq, S, N, Kh, window, scale, softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qpos, const void* kpos,
                   const void* valid, void* bounds, void* dq, int B, int Tq, int S, int N, int Kh,
                   int window, float scale, float softcap, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fp32<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, dq, B, Tq, S, N, Kh,
                            window, scale, softcap, stream);
    case 1:
      return launch_bf16_tc<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq, S,
                               N, Kh, window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are fp32 [B,N,T]; bounds:
// int32 scratch of 2 * B * ceil(S / 32) for the bf16 path (unused in fp32);
// all tensors contiguous; dq in q's dtype. Returns cudaGetLastError().
extern "C" int pt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               const void* qpos, const void* kpos, const void* valid,
                               void* bounds, void* dq, int B, int Tq, int S, int N, int Kh, int H,
                               int window, float scale, float softcap, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32:
      return launch<32>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq, S,
                        N, Kh, window, scale, softcap, st);
    case 64:
      return launch<64>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq, S,
                        N, Kh, window, scale, softcap, st);
    case 128:
      return launch<128>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dq, B, Tq,
                         S, N, Kh, window, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
