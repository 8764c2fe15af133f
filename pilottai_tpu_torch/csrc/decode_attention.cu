// One-token GQA attention over the dense K-major KV cache, online-softmax
// statistics — hand-written CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel pilottai_tpu/ops/pallas/decode_attention.py:_decode_kernel
// (entry point decode_attention, return_stats=True), which is also what the
// JAX package's XLA function engine/decode.py:_prefix_stats_dense computes.
// For q [B,N,H] and the cache panels k, v [B,K,S,H]:
//
//   attend(s) = s <= last[b]  and  (window <= 0 or q_pos[b] - s < window)
//   logits = (q . k) * scale, then tanh soft-cap when softcap > 0
//   m = max over attended logits (NEG_INF = -2^30 when none)
//   p = exp(logits - m), 0 on rows whose m is NEG_INF
//   l = sum p;  acc = sum p(cast to the cache dtype) * v   (fp32)
//
// What bounds it on an H100: HBM bytes. Every attended key costs 2*H cache
// elements read for 4*H*G multiply-adds (G = N/K query heads per kv head),
// far below the card's ~295 operations per byte, so the time is the cache
// read. The design reads each attended K/V row from device memory exactly
// once for all G query heads of its kv head (one block per (kv head, batch
// row)), walks only [max(0, q_pos - window + 1), last[b]] instead of the
// whole panel the TPU kernel DMAs, and keeps scores and the accumulator on
// chip. Rows are read as contiguous [TS, H] tiles with 16-byte loads (the
// K-major layout makes a tile one span of device memory). One block per
// (kv head, batch row) is B*K blocks — 64 at 8 slots of llama3-8b, fewer
// than the 132 SMs — so splitting the key range over more blocks is the
// next step for speed.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the JAX package's NEG_INF
constexpr int kMaxG = 8;                    // query heads per kv head

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Widen one 16-byte load of VEC elements to floats.
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

template <typename T, int H, int TS, int NT>
__global__ void __launch_bounds__(NT) decode_stats_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int32_t* __restrict__ last, const int32_t* __restrict__ qpos,
    float* __restrict__ acc_out, float* __restrict__ m_out, float* __restrict__ l_out, int N,
    int Kh, int S, int window, float scale, float softcap) {
  static_assert(TS == 32, "one warp lane per key of a tile");
  constexpr int NW = NT / 32;
  constexpr int KSTRIDE = H + 1;
  constexpr int MAXR = (kMaxG * H + NT - 1) / NT;  // accumulator columns per thread
  constexpr int VEC = 16 / sizeof(T);               // elements per 16-byte load
  static_assert(H % VEC == 0, "rows load in 16-byte vectors");

  const int G = N / Kh;
  extern __shared__ float smem[];
  float* sQ = smem;                 // [G][H]
  float* sK = sQ + G * H;           // [TS][H+1]
  float* sV = sK + TS * KSTRIDE;    // [TS][H]
  float* sP = sV + TS * H;          // [G][TS]
  float* sM = sP + G * TS;          // [G]
  float* sL = sM + G;               // [G]
  float* sC = sL + G;               // [G]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int qp = qpos[b];
  const int s_end = min(last[b], S - 1);                  // inclusive
  const int s_begin = window > 0 ? max(0, qp - window + 1) : 0;
  const size_t panel = (static_cast<size_t>(b) * Kh + kh) * S * H;

  for (int idx = tid; idx < G * H; idx += NT) {
    sQ[idx] = to_f(q[(static_cast<size_t>(b) * N + kh * G) * H + idx]);
  }
  for (int g = tid; g < G; g += NT) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  for (int t0 = s_begin; t0 <= s_end; t0 += TS) {
    __syncthreads();  // previous tile's readers are done with sK/sV/sP
    for (int idx = tid; idx < TS * (H / VEC); idx += NT) {
      const int j = idx / (H / VEC), c = (idx % (H / VEC)) * VEC, s = t0 + j;
      float kx[VEC], vx[VEC];
      if (s <= s_end) {
        const size_t off = panel + static_cast<size_t>(s) * H + c;
        unpack<T, VEC>(*reinterpret_cast<const uint4*>(kc + off), kx);
        unpack<T, VEC>(*reinterpret_cast<const uint4*>(vc + off), vx);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sK[j * KSTRIDE + c + e] = kx[e];
        sV[j * H + c + e] = vx[e];
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * TS; idx += NT) {
      const int g = idx / TS, j = idx % TS;
      const float* qr = sQ + g * H;
      const float* kr = sK + j * KSTRIDE;
      float dot = 0.f;
#pragma unroll 16
      for (int h = 0; h < H; ++h) dot = fmaf(qr[h], kr[h], dot);
      float s = dot * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      sP[idx] = t0 + j <= s_end ? s : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      const float x = sP[g * TS + lane];
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const bool any = m_new > kNegInf * 0.5f;
      const float p = any ? expf(x - m_new) : 0.f;
      const float psum = warp_sum(p);
      sP[g * TS + lane] = to_f(from_f<T>(p));  // p in the cache dtype for the PV product
      if (lane == 0) {
        const float corr = any ? expf(m_old - m_new) : 1.f;
        sC[g] = corr;
        sL[g] = sL[g] * corr + psum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int idx = tid + r * NT;
      if (idx < G * H) {
        const int g = idx / H, h = idx % H;
        const float* prow = sP + g * TS;
        float a = acc[r] * sC[g];
#pragma unroll 8
        for (int j = 0; j < TS; ++j) a = fmaf(prow[j], sV[j * H + h], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  const size_t row0 = static_cast<size_t>(b) * N + kh * G;
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int idx = tid + r * NT;
    if (idx < G * H) acc_out[row0 * H + idx] = acc[r];
  }
  for (int g = tid; g < G; g += NT) {
    m_out[row0 + g] = sM[g];
    l_out[row0 + g] = sL[g];
  }
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* k, const void* v, const void* last,
                   const void* qpos, void* acc, void* m, void* l, int B, int N, int Kh, int S,
                   int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int TS = 32, NT = 128;
  const int G = N / Kh;
  const size_t smem = (G * H + TS * (H + 1) + TS * H + G * TS + 3 * G) * sizeof(float);
  auto kern = decode_stats_kernel<T, H, TS, NT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(Kh, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(last), static_cast<const int32_t*>(qpos),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), N, Kh, S, window,
      scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_h(int H, const void* q, const void* k, const void* v, const void* last,
                       const void* qpos, void* acc, void* m, void* l, int B, int N, int Kh,
                       int S, int window, float scale, float softcap, cudaStream_t stream) {
  switch (H) {
    case 32:
      return launch<T, 32>(q, k, v, last, qpos, acc, m, l, B, N, Kh, S, window, scale, softcap,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, last, qpos, acc, m, l, B, N, Kh, S, window, scale, softcap,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, last, qpos, acc, m, l, B, N, Kh, S, window, scale, softcap,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous; returns cudaGetLastError().
extern "C" int pt_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                   const void* last, const void* qpos, void* acc, void* m,
                                   void* l, int B, int N, int Kh, int S, int H, int window,
                                   float scale, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || Kh <= 0 || N % Kh != 0 || N / Kh > kMaxG) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_h<float>(H, q, k, v, last, qpos, acc, m, l, B, N, Kh, S, window, scale,
                            softcap, st);
  } else if (dtype == 1) {
    err = dispatch_h<__nv_bfloat16>(H, q, k, v, last, qpos, acc, m, l, B, N, Kh, S, window,
                                    scale, softcap, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
