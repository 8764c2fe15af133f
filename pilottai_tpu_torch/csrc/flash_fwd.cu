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
// is bounded by operations; at short T by the bytes of q, k, v and o. This
// first version keeps every intermediate out of device memory (scores and
// probabilities live in shared memory, the output accumulator in registers),
// skips kv tiles in which no (query, key) pair is live (causal prefill reads
// about half of them) and never visits keys at or past valid[b]. In bf16 both
// products run on the tensor cores through WMMA (flash_fwd_bf16_tc_kernel);
// in fp32 they run on the CUDA cores in full fp32 (flash_fwd_fp32_kernel), so
// the fp32 path matches the reference to summation order (tensor cores would
// round to TF32).
// wgmma, TMA staging and a persistent schedule are later work.
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
#include <mma.h>

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

// bf16 path: the same function with both products on the tensor cores
// (WMMA m16n16k16, bf16 operands, fp32 accumulate). A block holds TC_BQ = 64
// query rows of one head; each of its 4 warps owns 16 of them end to end
// (scores, softmax, PV and the output accumulator), so after the shared
// K/V tile is loaded a warp needs only __syncwarp. Tiles arrive with
// 16-byte loads. Shared-memory rows are padded by 8 bf16 / 4 floats so the
// fragment loads spread over the banks; every fragment pointer is 32-byte
// aligned, as WMMA requires.
constexpr int TC_BQ = 64, TC_BK = 64, TC_NT = 128;

template <int H>
constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(TC_BQ * (H + 8) + 2 * TC_BK * (H + 8) + TC_BQ * (TC_BK + 8)) *
             sizeof(__nv_bfloat16) +
         static_cast<size_t>(TC_BQ * (TC_BK + 4) + TC_BQ * (H + 4) + 3 * TC_BQ) * sizeof(float) +
         static_cast<size_t>(TC_BQ + TC_BK) * sizeof(int);
}

template <int H>
__global__ void __launch_bounds__(TC_NT) flash_fwd_bf16_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const int32_t* __restrict__ valid,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Tq, int S, int N, int Kh,
    int window, float scale, float softcap) {
  using namespace nvcuda;
  constexpr int BQ = TC_BQ, BK = TC_BK, NT = TC_NT;
  constexpr int LDH = H + 8;        // bf16 row stride of the Q, K and V tiles
  constexpr int LDP = BK + 8;       // bf16 row stride of P
  constexpr int LDS = BK + 4;       // float row stride of the scores
  constexpr int LDO = H + 4;        // float row stride of a tile's PV product
  constexpr int VEC = 8;            // bf16 per 16-byte load
  constexpr int OPL = 16 * H / 32;  // output elements per lane (a warp's 16 rows x H)
  static_assert(H % 16 == 0 && BK % 32 == 0, "WMMA tiles");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LDH]
  __nv_bfloat16* sK = sQ + BQ * LDH;                                 // [BK][LDH]
  __nv_bfloat16* sV = sK + BK * LDH;                                 // [BK][LDH]
  __nv_bfloat16* sP = sV + BK * LDH;                                 // [BQ][LDP]
  float* sS = reinterpret_cast<float*>(sP + BQ * LDP);               // [BQ][LDS]
  float* sPV = sS + BQ * LDS;                                        // [BQ][LDO]
  float* sM = sPV + BQ * LDO;
  float* sL = sM + BQ;
  float* sC = sL + BQ;
  int* sQpos = reinterpret_cast<int*>(sC + BQ);
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
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < Tq) {
      val = *reinterpret_cast<const uint4*>(q + ((static_cast<size_t>(b) * Tq + t) * N + n) * H + c);
    }
    *reinterpret_cast<uint4*>(sQ + i * LDH + c) = val;
  }
  for (int i = tid; i < BQ; i += NT) {
    const int t = q0 + i;
    sQpos[i] = t < Tq ? qpos[static_cast<size_t>(b) * Tq + t] : INT_MIN;
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  float oacc[OPL];
#pragma unroll
  for (int e = 0; e < OPL; ++e) oacc[e] = 0.f;

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

    // Scores of this warp's 16 rows against the tile's BK keys.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) wmma::fill_fragment(acc[nb], 0.f);
#pragma unroll
      for (int kk = 0; kk < H; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + r0 * LDH + kk, LDH);
#pragma unroll
        for (int nb = 0; nb < BK / 16; ++nb) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, sK + nb * 16 * LDH + kk, LDH);
          wmma::mma_sync(acc[nb], a, kb, acc[nb]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        wmma::store_matrix_sync(sS + r0 * LDS + nb * 16, acc[nb], LDS, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // Online softmax over the warp's rows; p goes to sP in bf16.
    for (int r = 0; r < 16; ++r) {
      const int i = r0 + r;
      const int qp = sQpos[i];
      const bool row_real = q0 + i < Tq;
      float sv[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int j = lane + 32 * u;
        float s = sS[i * LDS + j] * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        const bool ok = row_real && j0 + j < kv_end && attends(qp, sKpos[j], window);
        sv[u] = ok ? s : kNegInf;
        mx = fmaxf(mx, sv[u]);
      }
      mx = warp_max(mx);
      const float m_old = sM[i];
      const float m_new = fmaxf(m_old, mx);
      const bool any = m_new > kNegInf * 0.5f;
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = any ? expf(sv[u] - m_new) : 0.f;
        psum += p;
        sP[i * LDP + lane + 32 * u] = __float2bfloat16(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = any ? expf(m_old - m_new) : 1.f;
        sC[i] = corr;
        sL[i] = sL[i] * corr + psum;
        sM[i] = m_new;
      }
    }
    __syncwarp();

    // This tile's P . V for the warp's rows, then the rescaled accumulate.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv[H / 16];
#pragma unroll
      for (int nb = 0; nb < H / 16; ++nb) wmma::fill_fragment(pv[nb], 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sP + r0 * LDP + kk, LDP);
#pragma unroll
        for (int nb = 0; nb < H / 16; ++nb) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
          wmma::load_matrix_sync(vb, sV + kk * LDH + nb * 16, LDH);
          wmma::mma_sync(pv[nb], a, vb, pv[nb]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < H / 16; ++nb) {
        wmma::store_matrix_sync(sPV + r0 * LDO + nb * 16, pv[nb], LDO, wmma::mem_row_major);
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < OPL; ++e) {
      const int idx = lane + 32 * e;
      const int i = r0 + idx / H, h = idx % H;
      oacc[e] = oacc[e] * sC[i] + sPV[i * LDO + h];
    }
  }
  // A full barrier, not __syncwarp: when no tile ran (valid[b] == 0) this is
  // the first barrier after other warps initialized sM and sL.
  __syncthreads();

#pragma unroll
  for (int e = 0; e < OPL; ++e) {
    const int idx = lane + 32 * e;
    const int i = r0 + idx / H, h = idx % H, t = q0 + i;
    if (t >= Tq) continue;
    const float l = sL[i];
    const float out = l > 0.f ? oacc[e] / fmaxf(l, 1e-30f) : 0.f;
    o[((static_cast<size_t>(b) * Tq + t) * N + n) * H + h] = __float2bfloat16(out);
    if (h == 0) {
      lse[(static_cast<size_t>(b) * N + n) * Tq + t] =
          l > 0.f ? sM[i] + logf(fmaxf(l, 1e-30f)) : kNegInf;
    }
  }
}

template <int H>
cudaError_t launch_bf16_tc(const void* q, const void* k, const void* v, const void* qpos,
                           const void* kpos, const void* valid, void* o, void* lse, int B, int Tq,
                           int S, int N, int Kh, int window, float scale, float softcap,
                           cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<H>();
  auto kern = flash_fwd_bf16_tc_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + TC_BQ - 1) / TC_BQ, N, B);
  kern<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(valid),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Tq, S, N, Kh, window, scale,
      softcap);
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
                   const void* kpos, const void* valid, void* o, void* lse, int B, int Tq, int S,
                   int N, int Kh, int window, float scale, float softcap, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fp32<H>(q, k, v, qpos, kpos, valid, o, lse, B, Tq, S, N, Kh, window, scale,
                            softcap, stream);
    case 1:
      return launch_bf16_tc<H>(q, k, v, qpos, kpos, valid, o, lse, B, Tq, S, N, Kh, window,
                               scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous; returns cudaGetLastError().
extern "C" int pt_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                            const void* qpos, const void* kpos, const void* valid, void* o,
                            void* lse, int B, int Tq, int S, int N, int Kh, int H, int window,
                            float scale, float softcap, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32:
      return launch<32>(dtype, q, k, v, qpos, kpos, valid, o, lse, B, Tq, S, N, Kh, window,
                        scale, softcap, st);
    case 64:
      return launch<64>(dtype, q, k, v, qpos, kpos, valid, o, lse, B, Tq, S, N, Kh, window,
                        scale, softcap, st);
    case 128:
      return launch<128>(dtype, q, k, v, qpos, kpos, valid, o, lse, B, Tq, S, N, Kh, window,
                         scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
