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
// only writes zeros. In bf16 the four products run on the tensor cores
// through WMMA (bf16 operands, fp32 accumulate): p is rounded to bf16 for
// dv, ds to bf16 for dk, as the TPU kernel rounds them to v's and q's
// dtypes. In fp32 every product runs on the CUDA cores in full fp32 (never
// TF32), so it matches the reference up to summation order.
// Left on the table: wgmma with TMA-fed shared-memory rings, a persistent
// schedule, and sharing one pass over the tiles with K4.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

// bf16 path: TC_BK = 64 keys of one kv head per block; each of its 4 warps
// owns 16 of them end to end (the transposed s and dp tiles, p and ds, and
// the dk and dv accumulators in WMMA fragments), so after a q tile of one
// head is staged a warp needs only __syncwarp. Tiles arrive with 16-byte
// loads; shared-memory rows are padded by 8 bf16 / 4 floats so fragment
// loads spread over the banks, and every fragment pointer is 32-byte
// aligned, as WMMA requires.
constexpr int TC_BK = 64, TC_BQ = 64, TC_NT = 128;

template <int H>
constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(2 * TC_BK * (H + 8) + 2 * TC_BQ * (H + 8) +
                             2 * TC_BK * (TC_BQ + 8)) *
             sizeof(__nv_bfloat16) +
         static_cast<size_t>(2 * TC_BK * (TC_BQ + 4) + 2 * TC_BQ) * sizeof(float) +
         static_cast<size_t>(TC_BQ + TC_BK) * sizeof(int);
}

template <int H>
__global__ void __launch_bounds__(TC_NT) flash_bwd_dkv_bf16_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
    const int32_t* __restrict__ valid, float* __restrict__ dk, float* __restrict__ dv, int Tq,
    int S, int N, int Kh, int window, float scale, float softcap) {
  using namespace nvcuda;
  constexpr int BK = TC_BK, BQ = TC_BQ, NT = TC_NT;
  constexpr int LDH = H + 8;   // bf16 row stride of the K, V, Q and dO tiles
  constexpr int LDP = BQ + 8;  // bf16 row stride of p^T and ds^T
  constexpr int LDS = BQ + 4;  // float row stride of the s^T and dp^T tiles
  constexpr int LDO = H + 4;   // float row stride of the output staging (reuses them)
  constexpr int VEC = 8;       // bf16 per 16-byte load
  static_assert(H % 16 == 0 && BQ % 32 == 0, "WMMA tiles");
  static_assert(LDO <= 2 * LDS, "the output staging fits in the s and dp tiles");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][LDH]
  __nv_bfloat16* sV = sK + BK * LDH;                                 // [BK][LDH]
  __nv_bfloat16* sQ = sV + BK * LDH;                                 // [BQ][LDH]
  __nv_bfloat16* sDO = sQ + BQ * LDH;                                // [BQ][LDH]
  __nv_bfloat16* sPt = sDO + BQ * LDH;                               // [BK][LDP]
  __nv_bfloat16* sDSt = sPt + BK * LDP;                              // [BK][LDP]
  float* sS = reinterpret_cast<float*>(sDSt + BK * LDP);             // [BK][LDS]
  float* sDP = sS + BK * LDS;                                        // [BK][LDS]
  float* sLse = sDP + BK * LDS;
  float* sDelta = sLse + BQ;
  int* sQpos = reinterpret_cast<int*>(sDelta + BQ);
  int* sKpos = sQpos + BQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = N / Kh;
  const int kv_end = min(S, valid[b]);
  const int r0 = warp * 16;  // this warp's first key in the tile

  for (int idx = tid; idx < BK * (H / VEC); idx += NT) {
    const int j = idx / (H / VEC), c = (idx % (H / VEC)) * VEC, s = j0 + j;
    uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
    if (s < kv_end) {
      const size_t off = ((static_cast<size_t>(b) * S + s) * Kh + kh) * H + c;
      kx = *reinterpret_cast<const uint4*>(k + off);
      vx = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(sK + j * LDH + c) = kx;
    *reinterpret_cast<uint4*>(sV + j * LDH + c) = vx;
  }
  for (int j = tid; j < BK; j += NT) {
    const int s = j0 + j;
    sKpos[j] = s < kv_end ? kpos[static_cast<size_t>(b) * S + s] : INT_MAX;
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[H / 16], dv_acc[H / 16];
#pragma unroll
  for (int nb = 0; nb < H / 16; ++nb) {
    wmma::fill_fragment(dk_acc[nb], 0.f);
    wmma::fill_fragment(dv_acc[nb], 0.f);
  }

  for (int t0 = 0; j0 < kv_end && t0 < Tq; t0 += BQ) {
    if (!stage_q_tile<BQ, BK, NT>(qpos, sQpos, sKpos, b, t0, Tq, j0, kv_end, window)) continue;
    for (int g = 0; g < G; ++g) {
      const int n = kh * G + g;
      __syncthreads();  // every warp is done with the previous head's tiles
      for (int idx = tid; idx < BQ * (H / VEC); idx += NT) {
        const int i = idx / (H / VEC), c = (idx % (H / VEC)) * VEC, t = t0 + i;
        uint4 qx = make_uint4(0u, 0u, 0u, 0u), dx = qx;
        if (t < Tq) {
          const size_t off = ((static_cast<size_t>(b) * Tq + t) * N + n) * H + c;
          qx = *reinterpret_cast<const uint4*>(q + off);
          dx = *reinterpret_cast<const uint4*>(dout + off);
        }
        *reinterpret_cast<uint4*>(sQ + i * LDH + c) = qx;
        *reinterpret_cast<uint4*>(sDO + i * LDH + c) = dx;
      }
      for (int i = tid; i < BQ; i += NT) {
        const int t = t0 + i;
        const size_t row = (static_cast<size_t>(b) * N + n) * Tq + t;
        sLse[i] = t < Tq ? lse[row] : kNegInf;
        sDelta[i] = t < Tq ? delta[row] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T, then dp^T = V dO^T, for the warp's 16 keys.
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const __nv_bfloat16* A = which == 0 ? sK : sV;
        const __nv_bfloat16* Bm = which == 0 ? sQ : sDO;
        float* out = which == 0 ? sS : sDP;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BQ / 16];
#pragma unroll
        for (int nb = 0; nb < BQ / 16; ++nb) wmma::fill_fragment(acc[nb], 0.f);
#pragma unroll
        for (int kk = 0; kk < H; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + r0 * LDH + kk, LDH);
#pragma unroll
          for (int nb = 0; nb < BQ / 16; ++nb) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bq;
            wmma::load_matrix_sync(bq, Bm + nb * 16 * LDH + kk, LDH);
            wmma::mma_sync(acc[nb], a, bq, acc[nb]);
          }
        }
#pragma unroll
        for (int nb = 0; nb < BQ / 16; ++nb) {
          wmma::store_matrix_sync(out + r0 * LDS + nb * 16, acc[nb], LDS, wmma::mem_row_major);
        }
      }
      __syncwarp();

      // p^T and ds^T for the warp's keys, rounded to bf16 for the products.
      for (int r = 0; r < 16; ++r) {
        const int j = r0 + r;
        const int kp = sKpos[j];
        const bool key_ok = j0 + j < kv_end;
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {
          const int i = lane + 32 * u;
          const float lse_i = sLse[i];
          float s = sS[j * LDS + i] * scale, th = 0.f;
          if (softcap > 0.f) {
            th = tanhf(s / softcap);
            s = th * softcap;
          }
          const bool ok = key_ok && t0 + i < Tq && lse_i > kNegInf * 0.5f &&
                          attends(sQpos[i], kp, window);
          const float p = ok ? expf(s - lse_i) : 0.f;
          float ds = p * (sDP[j * LDS + i] - sDelta[i]);
          if (softcap > 0.f) ds *= 1.f - th * th;
          sPt[j * LDP + i] = __float2bfloat16(p);
          sDSt[j * LDP + i] = __float2bfloat16(ds);
        }
      }
      __syncwarp();

      // dv += p^T dO and dk += ds^T Q for the warp's keys.
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> ap, ads;
        wmma::load_matrix_sync(ap, sPt + r0 * LDP + kk, LDP);
        wmma::load_matrix_sync(ads, sDSt + r0 * LDP + kk, LDP);
#pragma unroll
        for (int nb = 0; nb < H / 16; ++nb) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bd, bq;
          wmma::load_matrix_sync(bd, sDO + kk * LDH + nb * 16, LDH);
          wmma::mma_sync(dv_acc[nb], ap, bd, dv_acc[nb]);
          wmma::load_matrix_sync(bq, sQ + kk * LDH + nb * 16, LDH);
          wmma::mma_sync(dk_acc[nb], ads, bq, dk_acc[nb]);
        }
      }
    }
  }
  // A full barrier: the staging below overlaps other warps' s and dp rows,
  // and when no q tile ran it is the first barrier after the staging above.
  __syncthreads();

  float* sOut = sS;  // [BK][LDO]
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int nb = 0; nb < H / 16; ++nb) {
      wmma::store_matrix_sync(sOut + r0 * LDO + nb * 16, which == 0 ? dk_acc[nb] : dv_acc[nb],
                              LDO, wmma::mem_row_major);
    }
    __syncwarp();
    float* dst = which == 0 ? dk : dv;
    const float mul = which == 0 ? scale : 1.f;
    for (int idx = lane; idx < 16 * H; idx += 32) {
      const int j = r0 + idx / H, h = idx % H, s = j0 + j;
      if (s < S) dst[((static_cast<size_t>(b) * S + s) * Kh + kh) * H + h] = sOut[j * LDO + h] * mul;
    }
    __syncwarp();
  }
}

template <int H>
cudaError_t launch_bf16_tc(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* qpos, const void* kpos,
                           const void* valid, void* dk, void* dv, int B, int Tq, int S, int N,
                           int Kh, int window, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<H>();
  auto kern = flash_bwd_dkv_bf16_tc_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TC_BK - 1) / TC_BK, Kh, B);
  kern<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
      static_cast<const int32_t*>(valid), static_cast<float*>(dk), static_cast<float*>(dv), Tq,
      S, N, Kh, window, scale, softcap);
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
                   const void* valid, void* dk, void* dv, int B, int Tq, int S, int N, int Kh,
                   int window, float scale, float softcap, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fp32<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, dk, dv, B, Tq, S, N,
                            Kh, window, scale, softcap, stream);
    case 1:
      return launch_bf16_tc<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, dk, dv, B, Tq, S, N,
                               Kh, window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are fp32 [B,N,T]; all
// tensors contiguous; dk and dv fp32 [B,S,K,H]. Returns cudaGetLastError().
extern "C" int pt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                const void* qpos, const void* kpos, const void* valid, void* dk,
                                void* dv, int B, int Tq, int S, int N, int Kh, int H, int window,
                                float scale, float softcap, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32:
      return launch<32>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, dk, dv, B, Tq, S, N,
                        Kh, window, scale, softcap, st);
    case 64:
      return launch<64>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, dk, dv, B, Tq, S, N,
                        Kh, window, scale, softcap, st);
    case 128:
      return launch<128>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, dk, dv, B, Tq, S, N,
                         Kh, window, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
