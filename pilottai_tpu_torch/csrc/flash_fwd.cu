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
// Head dims 32, 64, 128 and 256 (Gemma); each body's note says what 256
// changes.
//
// What bounds it on an H100: at long T the work is compute (4*H multiply-adds
// per live (query, key, head) pair against T*(N+2K)*H inputs), so the kernel
// is bounded by operations; at short T by the bytes of q, k, v and o. Both
// bodies keep every intermediate out of device memory, skip kv tiles in
// which no (query, key) pair is live (causal prefill reads about half of
// them) and never visit keys at or past valid[b]. In bf16 both products run
// on wgmma, Hopper's warpgroup product, with scores, probabilities and the
// output accumulator in registers and K/V loads in flight
// (flash_fwd_bf16_kernel, described above it); its tiles arrive by
// cp.async from the same threads: TMA from a producer warp, two consumer
// warpgroups and a persistent schedule are the next steps. In fp32 both
// products run on the tensor cores too, in 3xTF32 (flash_fwd_fp32_kernel,
// described above it): fp32's accuracy at the fp32-accurate tensor-core
// rate (495e12 / 3 FLOP/s), where full fp32 on the CUDA cores would cap it
// at 67e12.

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

// fp32 path: the same function with both products on the tensor cores in
// 3xTF32 (hopper.cuh), which keeps about fp32's accuracy. A block holds 32
// rows, flattened (position, head) rows of one kv head of one batch row:
// row R = t*G + g is query position t of query head kh*G + g, so the G
// heads that share a kv head share each K and V tile, and a warp's 16 rows
// span 16/G positions. Grid (kv head, batch row, row tile), the last row
// tiles, the longest under causal positions, first. Four warps: two row
// warps of 16 rows, times two key groups. The block walks super-tiles of
// two kv tiles of BK keys, and key group k takes kv tile k of each, with
// an online softmax of its own; at the end group 1 hands its (m, l, O) to
// group 0 through shared memory, which merges them and writes o and lse.
// So a row's keys are walked by two warps at once, and the golden serving
// shape (4096 rows, 128 blocks) puts a warp on each of about 512 of the
// card's 528 SM sub-partitions: a lone warp walking every tile would wait
// on its own products. Per kv tile of BK keys, each warp runs:
//   S = Q K^T: mma.sync m16n8k8 in 3xTF32, Q's split A fragments held in
//     registers for the whole walk (read from shared memory at head_dim
//     128, where they would take 128 registers), K read as the B operand;
//   the online softmax on S's accumulator registers, as the bf16 head_dim
//     32 path runs it (row statistics over the 4 lanes of a row);
//   O += P V: P's accumulator registers are the A operand in place, with
//     the keys of each k8 step permuted (column t holds key 2t, column t + 4
//     key 2t + 1, as the accumulator does), and V's B elements read from
//     the same permuted rows; O stays in registers until the epilogue.
// Staged rows are H + 4 floats apart: an A-layout or K^T read (row g,
// column t) and a permuted V read (row 2t or 2t + 1, column g) then hit 32
// banks. K and V come through a 2-stage cp.async ring (keys past valid[b]
// zero-filled); kv tiles are live, full or masked pair by pair from the
// bounds pass (staged in shared memory once) and the block's and the
// warp's own position bounds, as in the bf16 body, and a super-tile with no
// live kv tile is never loaded. At head_dim 256 (Gemma) a kv tile is 16
// keys (r_bk) and the PV product runs over O's columns in passes of four
// n-tiles (r_och): O alone takes 128 registers a lane there.
constexpr int R_ROWW = 2;     // row warps, 16 rows each
constexpr int R_GROUPS = 2;   // key groups
constexpr int R_NT = 32 * R_ROWW * R_GROUPS;
constexpr int R_BR = 16 * R_ROWW;  // flattened rows a block
// Keys per kv tile, a key group's share of a super-tile: 16 at head_dim 256,
// where the staged tiles of 32 keys would pass the 227 KB a block can have
// (R_BR + 4 * BKS rows of H + 4 floats: 300 KB at 32 keys, 166 KB at 16).
template <int H> __host__ __device__ constexpr int r_bk() {
  return H == 256 ? 16 : H == 128 ? 32 : 64;
}
// Output n-tiles a pass of O += P V: all of them up to head_dim 128; at 256,
// whose O already takes 128 registers a lane, four at a time, so that the
// pass's two fresh accumulators take 32 registers and not 256.
template <int H> __host__ __device__ constexpr int r_och() { return H == 256 ? 4 : H / 8; }
// Q's split fragments in registers (H of them) up to head_dim 64.
template <int H> __host__ __device__ constexpr bool r_qreg() { return H <= 64; }

// Dynamic shared memory for S keys: Q, the two stages of K, V and key
// positions, then the kv tile bounds.
template <int H>
size_t r_smem_bytes(int S) {
  constexpr int BKS = R_GROUPS * r_bk<H>();
  return static_cast<size_t>(R_BR + 4 * BKS) * (H + 4) * sizeof(float) +
         static_cast<size_t>(2 * BKS) * sizeof(int) +
         static_cast<size_t>((S + r_bk<H>() - 1) / r_bk<H>()) * sizeof(int2);
}

template <int H>
__global__ void __launch_bounds__(R_NT) flash_fwd_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
    const int32_t* __restrict__ valid, const int2* __restrict__ bounds, float* __restrict__ o,
    float* __restrict__ lse, int Tq, int S, int N, int Kh, int window, float scale,
    float softcap) {
  constexpr int BK = r_bk<H>();
  constexpr int BKS = R_GROUPS * BK;  // keys a super-tile
  constexpr int LD = H + 4;           // fp32 row stride of the staged tiles
  constexpr int CPR = H / 4;          // 16-byte chunks per row
  constexpr int KSTEPS = H / 8;       // k-steps of Q K^T over the head dim
  constexpr int SNT = BK / 8;         // n-tiles of a score row block
  constexpr int ONT = H / 8;          // n-tiles of the output
  constexpr bool QREG = r_qreg<H>();
  static_assert(R_BR == 32 && R_GROUPS == 2, "one lane per block row; two key groups");

  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;                                  // [BR][LD]
  float* sK = sQ + R_BR * LD;                            // [2][BKS][LD]
  float* sV = sK + 2 * BKS * LD;                         // [2][BKS][LD]
  int* sKpos = reinterpret_cast<int*>(sV + 2 * BKS * LD);  // [2][BKS]
  int2* sBounds = reinterpret_cast<int2*>(sKpos + 2 * BKS);  // [ceil(S / BK)]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % R_ROWW, kg = warp / R_ROWW;  // row warp, key group
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = N / Kh;
  const int n_rows = Tq * G;
  const int R0 = (gridDim.z - 1 - blockIdx.z) * R_BR;  // the longest row tiles first
  const int kv_end = min(S, valid[b]);
  const bool capped = softcap > 0.f;
  const float sl2 = capped ? kLog2e : scale * kLog2e;
  const float m_unit = capped ? 1.f : scale;
  // Where flattened row R lives in q and o.
  auto row_off = [&](int R) {
    const int t = R / G;
    return ((static_cast<size_t>(b) * Tq + t) * N + kh * G + (R - t * G)) * H;
  };

  for (int idx = tid; idx < R_BR * CPR; idx += R_NT) {
    const int r = idx / CPR, c = (idx % CPR) * 4, R = R0 + r;
    const bool real = R < n_rows;
    cp_async16_zfill(sQ + r * LD + c, q + row_off(real ? R : 0) + c, real);
  }
  cp_async_commit();
  // The batch row's kv tile bounds, staged once: the walk reads them from
  // shared memory, not one dependent load from device memory a tile.
  const int2* tile_bounds = bounds + static_cast<size_t>(b) * ((S + BK - 1) / BK);
  for (int idx = tid; idx < (S + BK - 1) / BK; idx += R_NT) sBounds[idx] = tile_bounds[idx];

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
  const int qp0 = __shfl_sync(0xffffffffu, qp_l, r_lo);
  const int qp1 = __shfl_sync(0xffffffffu, qp_l, r_lo + 8);

  const int n_tiles = (kv_end + BK - 1) / BK;
  const int n_super = (n_tiles + R_GROUPS - 1) / R_GROUPS;
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
    for (int idx = tid; idx < BKS * CPR; idx += R_NT) {
      const int r = idx / CPR, c = (idx % CPR) * 4, s = j0 + r;
      const bool real = s < kv_end;
      const size_t off = ((static_cast<size_t>(b) * S + (real ? s : 0)) * Kh + kh) * H + c;
      cp_async16_zfill(sK + (st * BKS + r) * LD + c, k + off, real);
      cp_async16_zfill(sV + (st * BKS + r) * LD + c, v + off, real);
    }
    // Key positions, unless every pair of both kv tiles is live.
    if (tile_is_full(2 * J, qmin, qmax) && tile_is_full(2 * J + 1, qmin, qmax)) return;
    for (int r = tid; r < BKS; r += R_NT) {
      const int s = j0 + r;
      sKpos[st * BKS + r] = s < kv_end ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
    }
  };
  // Q's A fragment of k-step ks: rows r_lo, r_lo + 8, columns 8ks + tq, + 4.
  auto q_frag = [&](FragA& f, int ks) {
    const float* p = sQ + r_lo * LD + ks * 8 + tq;
    split_a(f, p[0], p[8 * LD], p[4], p[8 * LD + 4]);
  };

  int J = next_live(0);
  if (J < n_super) load_kv(J, 0);
  cp_async_commit();

  float oacc[ONT][4];
#pragma unroll
  for (int nt = 0; nt < ONT; ++nt) oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};  // this lane's share of the row sums
  FragA qf[QREG ? KSTEPS : 1];
  bool have_q = false;
  int st = 0;

  while (J < n_super) {
    const int Jn = next_live(J + 1);
    if (Jn < n_super) load_kv(Jn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and super-tile J have landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    if (QREG && !have_q) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) q_frag(qf[QREG ? ks : 0], ks);
      have_q = true;
    }
    // This key group's kv tile; a warp whose rows attend nothing there
    // skips it.
    const int jt = J * R_GROUPS + kg;
    if (tile_is_live(jt, wqmin, wqmax)) {
      const float* tK = sK + (st * BKS + kg * BK) * LD;
      const float* tV = sV + (st * BKS + kg * BK) * LD;
      const int* tKpos = sKpos + st * BKS + kg * BK;
      const int j0 = jt * BK;

      // S = Q K^T for the warp's 16 rows.
      float s_acc[1][SNT][4];
      auto& sacc = s_acc[0];
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        FragA qa[1];
        if (QREG) {
          qa[0] = qf[QREG ? ks : 0];
        } else {
          q_frag(qa[0], ks);
        }
        FragB kb[1][SNT];
#pragma unroll
        for (int nt = 0; nt < SNT; ++nt) {
          const float* kr = tK + (nt * 8 + (lane >> 2)) * LD + ks * 8 + tq;
          split_b(kb[0][nt], kr[0], kr[4]);
        }
        mma_3xtf32(s_acc, 0, qa, kb);
      }

      // Scale, soft-cap and, on a boundary tile, the pair mask.
      const bool full = tile_is_full(jt, wqmin, wqmax);
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sacc[nt][e];
          if (capped) s = tanhf(s * scale / softcap) * softcap;
          if (!full) {
            const int col = nt * 8 + cq + (e & 1);
            const bool ok =
                j0 + col < kv_end && attends(e < 2 ? qp0 : qp1, tKpos[col], window);
            s = ok ? s : kNegInf;
          }
          sacc[nt][e] = s;
        }
      }

      // Online softmax of the lane's two rows (the 4 lanes of a row agree
      // on its max).
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

      // O += P V: n-tile kk of P is k-step kk, its column tq key 2tq and
      // column tq + 4 key 2tq + 1; V's B elements come from those rows. The
      // tile's products sum in fresh accumulators, one for the even and one
      // for the odd k-steps, added to O on the CUDA cores: the tensor cores'
      // accumulation truncates, and its error would grow with every tile
      // summed into O.
      constexpr int NC = ONT < 4 ? ONT : 4;  // n-tiles a product batch
      constexpr int OCH = r_och<H>();         // n-tiles a pass
#pragma unroll
      for (int c0 = 0; c0 < ONT; c0 += OCH) {
        float pv[2][OCH][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int nt = 0; nt < OCH; ++nt) {
            pv[u][nt][0] = pv[u][nt][1] = pv[u][nt][2] = pv[u][nt][3] = 0.f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < SNT; kk += 2) {
          FragA pa[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            split_a(pa[u], sacc[kk + u][0], sacc[kk + u][2], sacc[kk + u][1], sacc[kk + u][3]);
          }
#pragma unroll
          for (int c = 0; c < OCH; c += NC) {
            FragB vb[2][NC];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float* vr = tV + ((kk + u) * 8 + cq) * LD + (lane >> 2) + (c0 + c) * 8;
#pragma unroll
              for (int i = 0; i < NC; ++i) split_b(vb[u][i], vr[i * 8], vr[LD + i * 8]);
            }
            mma_3xtf32(pv, c, pa, vb);
          }
        }
#pragma unroll
        for (int nt = 0; nt < OCH; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[c0 + nt][e] += pv[0][nt][e] + pv[1][nt][e];
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
    st ^= 1;
    J = Jn;
  }
  cp_async_wait<0>();  // nothing may land after the block exits
  __syncthreads();     // the stages are free for the hand-over

  // Key group 1 hands its rows' (m, l, O) to group 0 through the stages'
  // memory; group 0 merges them, rescaled to the larger max, and writes.
  float* xo = sK;                 // [BR][LD]
  float* xm = xo + R_BR * LD;     // [BR]
  float* xl = xm + R_BR;          // [BR]
  float l_row[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_part[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[hr] = l;
  }
  if (kg == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r_lo + 8 * hr;
#pragma unroll
      for (int nt = 0; nt < ONT; ++nt) {
        *reinterpret_cast<float2*>(xo + row * LD + nt * 8 + cq) =
            make_float2(oacc[nt][2 * hr], oacc[nt][2 * hr + 1]);
      }
      if (tq == 0) {
        xm[row] = m_row[hr];
        xl[row] = l_row[hr];
      }
    }
  }
  __syncthreads();
  if (kg != 0) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r_lo + 8 * hr;
    const float m1 = xm[row];
    const float m = fmaxf(m_row[hr], m1);
    const float c0 = m_row[hr] > kNegInf * 0.5f ? ex2((m_row[hr] - m) * sl2) : 0.f;
    const float c1 = m1 > kNegInf * 0.5f ? ex2((m1 - m) * sl2) : 0.f;
    const float l = l_row[hr] * c0 + xl[row] * c1;
    const int R = R0 + row;
    if (R >= n_rows) continue;
    float* orow = o + row_off(R) + cq;
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      const float2 x = *reinterpret_cast<const float2*>(xo + row * LD + nt * 8 + cq);
      const float o0 = oacc[nt][2 * hr] * c0 + x.x * c1;
      const float o1 = oacc[nt][2 * hr + 1] * c0 + x.y * c1;
      *reinterpret_cast<float2*>(orow + nt * 8) =
          l > 0.f ? make_float2(o0 / fmaxf(l, 1e-30f), o1 / fmaxf(l, 1e-30f))
                  : make_float2(0.f, 0.f);
    }
    if (tq == 0) {
      const int t = R / G;
      lse[(static_cast<size_t>(b) * N + kh * G + (R - t * G)) * Tq + t] =
          l > 0.f ? m * m_unit + logf(fmaxf(l, 1e-30f)) : kNegInf;
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
// computed. At head_dim 256 (Gemma) O's 64 x 256 fp32 accumulator takes
// 128 registers a thread on its own, so two blocks share an SM (up to 255
// registers a thread) with tiles of 32 keys (98 KB of shared memory a
// block), and P V is two m64n128k16 products a k16 step, one per half of
// O's columns (pv_step). A simple body first: FlashAttention-3's split of
// O over two consumer warpgroups and a producer warp is later work.
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
template <int H> __host__ __device__ constexpr int f_bk() { return H >= 128 ? 32 : 64; }
// Blocks an SM: four, at most 128 registers a thread; two at head_dim 256,
// whose 64 x 256 fp32 output accumulator alone takes 128 registers a
// thread (up to 255 a thread at two blocks).
template <int H> __host__ __device__ constexpr int f_min_blocks() { return H == 256 ? 2 : 4; }

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

// O += P V over one k16 step of P: one m64nHk16 wgmma up to head_dim 128; at
// 256 two m64n128k16 on O's two column halves, V's panels 0-1 and 2-3.
template <int ONT>
__device__ __forceinline__ void pv_step(float (&oacc)[ONT][4], const uint32_t (&a)[4],
                                        const unsigned char* v_rows, int panel_bytes) {
  if constexpr (ONT == 32) {
    wgmma_bf16_rs(*reinterpret_cast<float(*)[16][4]>(&oacc[0]), a,
                  wgmma_desc_mn(v_rows, panel_bytes));
    wgmma_bf16_rs(*reinterpret_cast<float(*)[16][4]>(&oacc[16]), a,
                  wgmma_desc_mn(v_rows + 2 * panel_bytes, panel_bytes));
  } else {
    wgmma_bf16_rs(oacc, a, wgmma_desc_mn(v_rows, panel_bytes));
  }
}

template <int H>
__global__ void __launch_bounds__(F_NT, f_min_blocks<H>()) flash_fwd_bf16_kernel(
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
        pv_step(oacc, pf[kk], vb + kk * 16 * 128, F_BK * 128);
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

// bounds: scratch of B * ceil(S / 16) int2 (16: the smallest tile, r_bk<256>),
// filled by the first launch.
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

// bounds: scratch of B * ceil(S / 16) int2, filled by the first launch.
template <int H>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* qpos,
                        const void* kpos, const void* valid, void* bounds, void* o, void* lse,
                        int B, int Tq, int S, int N, int Kh, int window, float scale,
                        float softcap, cudaStream_t stream) {
  constexpr int BK = r_bk<H>();
  const size_t smem = r_smem_bytes<H>(S);
  auto kern = flash_fwd_fp32_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tile_bounds_kernel<BK><<<dim3((S + BK - 1) / BK, B), 32, 0, stream>>>(
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<int2*>(bounds), S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(Kh, B, (Tq * (N / Kh) + R_BR - 1) / R_BR);
  kern<<<grid, R_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
      static_cast<const int32_t*>(valid), static_cast<const int2*>(bounds),
      static_cast<float*>(o), static_cast<float*>(lse), Tq, S, N, Kh, window, scale, softcap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* qpos,
                   const void* kpos, const void* valid, void* bounds, void* o, void* lse, int B,
                   int Tq, int S, int N, int Kh, int window, float scale, float softcap,
                   cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fp32<H>(q, k, v, qpos, kpos, valid, bounds, o, lse, B, Tq, S, N, Kh, window,
                            scale, softcap, stream);
    case 1:
      return launch_bf16_tc<H>(q, k, v, qpos, kpos, valid, bounds, o, lse, B, Tq, S, N, Kh,
                               window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bounds: int32 scratch of 2 * B * ceil(S / 16),
// where the first launch puts the kv tiles' position bounds. All tensors
// contiguous; returns cudaGetLastError().
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
    case 256:
      return launch<256>(dtype, q, k, v, qpos, kpos, valid, bounds, o, lse, B, Tq, S, N, Kh,
                         window, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
