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
// tile stays resident in shared memory, and the block loops over the live q
// tiles and the G query heads, accumulating dk and dv inside the block, as
// the TPU kernel's in-cell group sum does. No atomics and no reduction
// across blocks, so the gradients are the same bits on every run. q tiles
// in which no (query, key) pair is live are skipped (causal training visits
// about half of them), and a block whose keys all lie at or past valid[b]
// only writes zeros. In bf16 (flash_bwd_dkv_bf16_tc_kernel, described above
// it) the four products run on wgmma, Hopper's warpgroup product, with s,
// dp, p and ds in registers and the q-side operands streamed through a
// cp.async ring; p is rounded to bf16 for dv, ds to bf16 for dk, as the TPU
// kernel rounds them to v's and q's dtypes. In fp32 every product runs on
// the CUDA cores in full fp32 (never TF32), so it matches the reference up
// to summation order.
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

// Stages the positions of the q tile at t0 and says whether any of its
// (query, key) pairs with the block's keys is live. Uniform across the block.
template <int BQ, int BK, int NT>
__device__ __forceinline__ bool stage_q_tile(const int32_t* __restrict__ qpos, int* sQpos,
                                             const int* sKpos, int b, int t0, int Tq, int j0,
                                             int kv_end, int window) {
  __syncthreads();  // every reader of the previous q tile is done
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const int t = t0 + i;
    sQpos[i] = t < Tq ? qpos[static_cast<size_t>(b) * Tq + t] : INT_MIN;
  }
  __syncthreads();
  int live = 0;
  for (int idx = threadIdx.x; idx < BQ * BK && !live; idx += NT) {
    const int i = idx / BK, j = idx % BK;
    live = t0 + i < Tq && j0 + j < kv_end && attends(sQpos[i], sKpos[j], window);
  }
  return __syncthreads_or(live);
}

// fp32 path. A block holds BK keys of one kv head. Per q tile of BQ rows and
// per query head, Q and dO are staged with rows padded to H+1 floats; each
// thread computes BK*BQ/NT (p, ds) pairs, then accumulates its dk and dv
// column for BK*H/NT keys.
template <int H, int BK, int BQ, int NT>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const int32_t* __restrict__ valid,
    float* __restrict__ dk, float* __restrict__ dv, int Tq, int S, int N, int Kh, int window,
    float scale, float softcap) {
  static_assert(NT % H == 0, "each column is owned by NT / H threads");
  constexpr int COLS_GROUPS = NT / H;
  constexpr int RPT = BK / COLS_GROUPS;  // keys accumulated per thread
  constexpr int HS = H + 1;

  extern __shared__ float smem[];
  float* sK = smem;                 // [BK][H+1]
  float* sV = sK + BK * HS;         // [BK][H+1]
  float* sQ = sV + BK * HS;         // [BQ][H+1]
  float* sDO = sQ + BQ * HS;        // [BQ][H+1]
  float* sP = sDO + BQ * HS;        // [BK][BQ]
  float* sDS = sP + BK * BQ;        // [BK][BQ]
  float* sLse = sDS + BK * BQ;      // [BQ]
  float* sDelta = sLse + BQ;        // [BQ]
  int* sQpos = reinterpret_cast<int*>(sDelta + BQ);  // [BQ]
  int* sKpos = sQpos + BQ;                           // [BK]

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = N / Kh;
  const int kv_end = min(S, valid[b]);

  for (int idx = tid; idx < BK * H; idx += NT) {
    const int j = idx / H, hh = idx % H, s = j0 + j;
    float kx = 0.f, vx = 0.f;
    if (s < kv_end) {
      const size_t off = ((static_cast<size_t>(b) * S + s) * Kh + kh) * H + hh;
      kx = k[off];
      vx = v[off];
    }
    sK[j * HS + hh] = kx;
    sV[j * HS + hh] = vx;
  }
  for (int j = tid; j < BK; j += NT) {
    const int s = j0 + j;
    sKpos[j] = s < kv_end ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
  }

  const int h = tid % H;
  const int r0 = tid / H;
  float dk_acc[RPT], dv_acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) dk_acc[r] = dv_acc[r] = 0.f;

  for (int t0 = 0; j0 < kv_end && t0 < Tq; t0 += BQ) {
    if (!stage_q_tile<BQ, BK, NT>(qpos, sQpos, sKpos, b, t0, Tq, j0, kv_end, window)) continue;
    for (int g = 0; g < G; ++g) {
      const int n = kh * G + g;
      __syncthreads();  // the previous head's readers are done with sQ/sDO/sP/sDS
      for (int idx = tid; idx < BQ * H; idx += NT) {
        const int i = idx / H, hh = idx % H, t = t0 + i;
        const size_t off = ((static_cast<size_t>(b) * Tq + t) * N + n) * H + hh;
        sQ[i * HS + hh] = t < Tq ? q[off] : 0.f;
        sDO[i * HS + hh] = t < Tq ? dout[off] : 0.f;
      }
      for (int i = tid; i < BQ; i += NT) {
        const int t = t0 + i;
        const size_t row = (static_cast<size_t>(b) * N + n) * Tq + t;
        sLse[i] = t < Tq ? lse[row] : kNegInf;
        sDelta[i] = t < Tq ? delta[row] : 0.f;
      }
      __syncthreads();

      for (int idx = tid; idx < BK * BQ; idx += NT) {
        const int j = idx / BQ, i = idx % BQ;
        const float* kr = sK + j * HS;
        const float* vr = sV + j * HS;
        const float* qr = sQ + i * HS;
        const float* dr = sDO + i * HS;
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
        const bool ok = t0 + i < Tq && j0 + j < kv_end && sLse[i] > kNegInf * 0.5f &&
                        attends(sQpos[i], sKpos[j], window);
        const float p = ok ? expf(s - sLse[i]) : 0.f;
        float ds = p * (dp - sDelta[i]);
        if (softcap > 0.f) ds *= 1.f - th * th;
        sP[idx] = p;
        sDS[idx] = ds;
      }
      __syncthreads();

#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int j = r0 + r * COLS_GROUPS;
        const float* pr = sP + j * BQ;
        const float* dsr = sDS + j * BQ;
        float a = dv_acc[r], c = dk_acc[r];
#pragma unroll 8
        for (int i = 0; i < BQ; ++i) {
          a = fmaf(pr[i], sDO[i * HS + h], a);
          c = fmaf(dsr[i], sQ[i * HS + h], c);
        }
        dv_acc[r] = a;
        dk_acc[r] = c;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int s = j0 + r0 + r * COLS_GROUPS;
    if (s < S) {
      const size_t off = ((static_cast<size_t>(b) * S + s) * Kh + kh) * H + h;
      dk[off] = dk_acc[r] * scale;
      dv[off] = dv_acc[r];
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
constexpr int V_BK = 64, V_NT = 128;
// q rows per item.
template <int H> __host__ __device__ constexpr int v_bq() { return H == 128 ? 32 : 64; }
// Blocks an SM: three from head_dim 64 down (a little spilling, measured
// faster than two without), two at 128, where dK and dV alone fill 128
// registers a thread.
template <int H> constexpr int v_min_blocks() { return H == 128 ? 2 : 3; }

template <int H>
constexpr size_t v_smem_bytes() {
  return 1024 + static_cast<size_t>(2 * V_BK + 4 * v_bq<H>()) * staged_cols<H>() *
                    sizeof(__nv_bfloat16) +
         static_cast<size_t>(2 * 3 * v_bq<H>()) * sizeof(float);
}

template <int H>
__global__ void __launch_bounds__(V_NT, v_min_blocks<H>()) flash_bwd_dkv_bf16_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
    const int32_t* __restrict__ valid, const int2* __restrict__ bounds, float* __restrict__ dk,
    float* __restrict__ dv, int Tq, int S, int N, int Kh, int window, float scale,
    float softcap) {
  constexpr int BQ = v_bq<H>();
  constexpr int HP = staged_cols<H>();
  constexpr int CPR = HP / 8;      // 16-byte chunks per staged row
  constexpr int KSTEPS = HP / 16;  // k-steps of S^T and dP^T over the head dim
  constexpr int SNT = BQ / 8;      // n-tiles of s^T and dp^T
  constexpr int ONT = HP / 8;      // n-tiles of dk and dv
  static_assert(V_BK == 16 * (V_NT / 32) && BQ % 16 == 0 && HP % 64 == 0, "wgmma tiles");

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

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int j0 = blockIdx.z * V_BK;  // the first kv tiles, the longest, first
  const int G = N / Kh;
  const int kv_end = min(S, valid[b]);
  const bool capped = softcap > 0.f;
  const float sl2 = scale * kLog2e;
  const float inf = __int_as_float(0x7f800000);

  // K and V go in flight first (keys past valid[b] and padded columns
  // zero-filled); the keys' positions and bounds are read meanwhile.
  for (int idx = tid; idx < V_BK * CPR; idx += V_NT) {
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
    for (int idx = tid; idx < BQ * CPR; idx += V_NT) {
      const int r = idx / CPR, c = (idx % CPR) * 8, t = t0 + r;
      const bool real = t < Tq && c < H;
      const size_t off =
          ((static_cast<size_t>(b) * Tq + min(t, Tq - 1)) * N + nh) * H + (c < H ? c : 0);
      cp_async16_zfill(at(sQ + st * BQ * HP, r, c, BQ), q + off, real);
      cp_async16_zfill(at(sDO + st * BQ * HP, r, c, BQ), dout + off, real);
    }
    const size_t row = (static_cast<size_t>(b) * N + nh) * Tq;
    for (int idx = tid; idx < 3 * BQ; idx += V_NT) {
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

    // dV += P^T dO: q rows kk*16 on are 16 swizzled rows into each panel of
    // dO.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_bf16_rs(dv_acc, pf[kk], wgmma_desc_mn(dob + kk * 16 * 128, BQ * 128));
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
      wgmma_bf16_rs(dk_acc, dsf[kk], wgmma_desc_mn(qb + kk * 16 * 128, BQ * 128));
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
    const size_t off = ((static_cast<size_t>(b) * S + s) * Kh + kh) * H + cq;
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      if (nt * 8 >= H) continue;
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
  kern<<<grid, V_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
      static_cast<const int32_t*>(valid), static_cast<const int2*>(bounds),
      static_cast<float*>(dk), static_cast<float*>(dv), Tq, S, N, Kh, window, scale, softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* qpos, const void* kpos,
                        const void* valid, void* dk, void* dv, int B, int Tq, int S, int N, int Kh,
                        int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int BK = 32, BQ = 32, NT = 128;
  constexpr size_t smem =
      (2 * BK * (H + 1) + 2 * BQ * (H + 1) + 2 * BK * BQ + 2 * BQ) * sizeof(float) +
      (BQ + BK) * sizeof(int);
  auto kern = flash_bwd_dkv_fp32_kernel<H, BK, BQ, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BK - 1) / BK, Kh, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<float*>(dk), static_cast<float*>(dv), Tq, S, N, Kh, window, scale, softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qpos, const void* kpos,
                   const void* valid, void* bounds, void* dk, void* dv, int B, int Tq, int S,
                   int N, int Kh, int window, float scale, float softcap, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fp32<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, dk, dv, B, Tq, S, N,
                            Kh, window, scale, softcap, stream);
    case 1:
      return launch_bf16_tc<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B, Tq,
                               S, N, Kh, window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are fp32 [B,N,T]; bounds:
// int32 scratch of 2 * B * ceil(T / 32) for the bf16 path (unused in fp32);
// all tensors contiguous; dk and dv fp32 [B,S,K,H]. Returns
// cudaGetLastError().
extern "C" int pt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                const void* qpos, const void* kpos, const void* valid,
                                void* bounds, void* dk, void* dv, int B, int Tq, int S, int N,
                                int Kh, int H, int window, float scale, float softcap,
                                void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32:
      return launch<32>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B, Tq,
                        S, N, Kh, window, scale, softcap, st);
    case 64:
      return launch<64>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B, Tq,
                        S, N, Kh, window, scale, softcap, st);
    case 128:
      return launch<128>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, bounds, dk, dv, B,
                         Tq, S, N, Kh, window, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
