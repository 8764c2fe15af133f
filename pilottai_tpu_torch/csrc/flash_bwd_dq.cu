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
// so at training lengths it is bounded by operations. This first version
// keeps every intermediate out of device memory (scores, dp and ds live in
// shared memory, the dq accumulator in registers), skips kv tiles in which
// no (query, key) pair is live (causal training visits about half of them)
// and never visits keys at or past valid[b]. One block owns a (batch row,
// query head, q tile): the q, dO, lse and delta rows are staged once and the
// block walks the live kv tiles, so dq needs no reduction across blocks.
// In bf16 the three products run on the tensor cores through WMMA (bf16
// operands, fp32 accumulate; dp's bf16 products are exact in fp32, as the
// TPU kernel's fp32 widening makes them), ds is rounded to bf16 for the dq
// product as the TPU kernel rounds it to k's dtype. In fp32 every product
// runs on the CUDA cores in full fp32 (never TF32), so it matches the
// reference up to summation order.
// Left on the table: wgmma with TMA-fed shared-memory rings, a persistent
// schedule, and fusing K5 into one pass over the tiles.

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

// bf16 path: TC_BQ = 64 query rows of one head per block; each of its 4
// warps owns 16 of them end to end (s and dp tiles, ds, the dq accumulator
// in WMMA fragments), so after the shared K/V tile is loaded a warp needs
// only __syncwarp. Tiles arrive with 16-byte loads; shared-memory rows are
// padded by 8 bf16 / 4 floats so fragment loads spread over the banks, and
// every fragment pointer is 32-byte aligned, as WMMA requires.
constexpr int TC_BQ = 64, TC_BK = 64, TC_NT = 128;

template <int H>
constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(2 * TC_BQ * (H + 8) + 2 * TC_BK * (H + 8) + TC_BQ * (TC_BK + 8)) *
             sizeof(__nv_bfloat16) +
         static_cast<size_t>(2 * TC_BQ * (TC_BK + 4) + 2 * TC_BQ) * sizeof(float) +
         static_cast<size_t>(TC_BQ + TC_BK) * sizeof(int);
}

template <int H>
__global__ void __launch_bounds__(TC_NT) flash_bwd_dq_bf16_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
    const int32_t* __restrict__ valid, __nv_bfloat16* __restrict__ dq, int Tq, int S, int N,
    int Kh, int window, float scale, float softcap) {
  using namespace nvcuda;
  constexpr int BQ = TC_BQ, BK = TC_BK, NT = TC_NT;
  constexpr int LDH = H + 8;   // bf16 row stride of the Q, dO, K and V tiles
  constexpr int LDP = BK + 8;  // bf16 row stride of ds
  constexpr int LDS = BK + 4;  // float row stride of the s and dp tiles
  constexpr int LDO = H + 4;   // float row stride of the dq staging (reuses s and dp)
  constexpr int VEC = 8;       // bf16 per 16-byte load
  static_assert(H % 16 == 0 && BK % 32 == 0, "WMMA tiles");
  static_assert(LDO <= 2 * LDS, "the dq staging fits in the s and dp tiles");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LDH]
  __nv_bfloat16* sDO = sQ + BQ * LDH;                                // [BQ][LDH]
  __nv_bfloat16* sK = sDO + BQ * LDH;                                // [BK][LDH]
  __nv_bfloat16* sV = sK + BK * LDH;                                 // [BK][LDH]
  __nv_bfloat16* sDS = sV + BK * LDH;                                // [BQ][LDP]
  float* sS = reinterpret_cast<float*>(sDS + BQ * LDP);              // [BQ][LDS]
  float* sDP = sS + BQ * LDS;                                        // [BQ][LDS]
  float* sLse = sDP + BQ * LDS;
  float* sDelta = sLse + BQ;
  int* sQpos = reinterpret_cast<int*>(sDelta + BQ);
  int* sKpos = sQpos + BQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = n / (N / Kh);
  const int kv_end = min(S, valid[b]);
  const int r0 = warp * 16;  // this warp's first row in the tile

  for (int idx = tid; idx < BQ * (H / VEC); idx += NT) {
    const int i = idx / (H / VEC), c = (idx % (H / VEC)) * VEC, t = q0 + i;
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
    const int t = q0 + i;
    const size_t row = (static_cast<size_t>(b) * N + n) * Tq + t;
    sQpos[i] = t < Tq ? qpos[static_cast<size_t>(b) * Tq + t] : INT_MIN;
    sLse[i] = t < Tq ? lse[row] : kNegInf;
    sDelta[i] = t < Tq ? delta[row] : 0.f;
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc[H / 16];
#pragma unroll
  for (int nb = 0; nb < H / 16; ++nb) wmma::fill_fragment(dacc[nb], 0.f);

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
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
    __syncthreads();

    // s = Q K^T and dp = dO V^T for the warp's 16 rows against the tile.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16], pacc[BK / 16];
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        wmma::fill_fragment(sacc[nb], 0.f);
        wmma::fill_fragment(pacc[nb], 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < H; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> aq, ad;
        wmma::load_matrix_sync(aq, sQ + r0 * LDH + kk, LDH);
        wmma::load_matrix_sync(ad, sDO + r0 * LDH + kk, LDH);
#pragma unroll
        for (int nb = 0; nb < BK / 16; ++nb) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb, vb;
          wmma::load_matrix_sync(kb, sK + nb * 16 * LDH + kk, LDH);
          wmma::mma_sync(sacc[nb], aq, kb, sacc[nb]);
          wmma::load_matrix_sync(vb, sV + nb * 16 * LDH + kk, LDH);
          wmma::mma_sync(pacc[nb], ad, vb, pacc[nb]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        wmma::store_matrix_sync(sS + r0 * LDS + nb * 16, sacc[nb], LDS, wmma::mem_row_major);
        wmma::store_matrix_sync(sDP + r0 * LDS + nb * 16, pacc[nb], LDS, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // ds for the warp's rows, rounded to bf16 for the dq product.
    for (int r = 0; r < 16; ++r) {
      const int i = r0 + r;
      const int qp = sQpos[i];
      const float lse_i = sLse[i], delta_i = sDelta[i];
      const bool row_ok = q0 + i < Tq && lse_i > kNegInf * 0.5f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int j = lane + 32 * u;
        float s = sS[i * LDS + j] * scale, th = 0.f;
        if (softcap > 0.f) {
          th = tanhf(s / softcap);
          s = th * softcap;
        }
        const bool ok = row_ok && j0 + j < kv_end && attends(qp, sKpos[j], window);
        const float p = ok ? expf(s - lse_i) : 0.f;
        float ds = p * (sDP[i * LDS + j] - delta_i);
        if (softcap > 0.f) ds *= 1.f - th * th;
        sDS[i * LDP + j] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dq += ds K for the warp's rows.
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sDS + r0 * LDP + kk, LDP);
#pragma unroll
      for (int nb = 0; nb < H / 16; ++nb) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> kb;
        wmma::load_matrix_sync(kb, sK + kk * LDH + nb * 16, LDH);
        wmma::mma_sync(dacc[nb], a, kb, dacc[nb]);
      }
    }
  }
  // A full barrier: the staging below overlaps other warps' s and dp rows,
  // and when no tile ran it is the first barrier after the staging above.
  __syncthreads();

  float* sOut = sS;  // [BQ][LDO]
#pragma unroll
  for (int nb = 0; nb < H / 16; ++nb) {
    wmma::store_matrix_sync(sOut + r0 * LDO + nb * 16, dacc[nb], LDO, wmma::mem_row_major);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * H; idx += 32) {
    const int i = r0 + idx / H, h = idx % H, t = q0 + i;
    if (t < Tq) {
      dq[((static_cast<size_t>(b) * Tq + t) * N + n) * H + h] =
          __float2bfloat16(sOut[i * LDO + h] * scale);
    }
  }
}

template <int H>
cudaError_t launch_bf16_tc(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* qpos, const void* kpos,
                           const void* valid, void* dq, int B, int Tq, int S, int N, int Kh,
                           int window, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<H>();
  auto kern = flash_bwd_dq_bf16_tc_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + TC_BQ - 1) / TC_BQ, N, B);
  kern<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
      static_cast<const int32_t*>(valid), static_cast<__nv_bfloat16*>(dq), Tq, S, N, Kh, window,
      scale, softcap);
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
                   const void* valid, void* dq, int B, int Tq, int S, int N, int Kh, int window,
                   float scale, float softcap, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fp32<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, dq, B, Tq, S, N, Kh,
                            window, scale, softcap, stream);
    case 1:
      return launch_bf16_tc<H>(q, k, v, dout, lse, delta, qpos, kpos, valid, dq, B, Tq, S, N, Kh,
                               window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are fp32 [B,N,T]; all
// tensors contiguous; dq in q's dtype. Returns cudaGetLastError().
extern "C" int pt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               const void* qpos, const void* kpos, const void* valid, void* dq,
                               int B, int Tq, int S, int N, int Kh, int H, int window,
                               float scale, float softcap, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32:
      return launch<32>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, dq, B, Tq, S, N, Kh,
                        window, scale, softcap, st);
    case 64:
      return launch<64>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, dq, B, Tq, S, N, Kh,
                        window, scale, softcap, st);
    case 128:
      return launch<128>(dtype, q, k, v, dout, lse, delta, qpos, kpos, valid, dq, B, Tq, S, N,
                         Kh, window, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
