// Causal flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel
// (flash_attention_pallas).  For q, k, v (BH, S, d) it computes
//
//   o[b,i,:] = sum_{j<=i} softmax_j(q[b,i,:] . k[b,j,:] * d^-1/2) v[b,j,:]
//
// with the reference's online softmax in f32: running max m (start -1e30),
// running sum l, accumulator acc, masked scores set to -1e30, and the
// final acc / max(l, 1e-30), cast to the input type.  Inputs are f32, bf16
// or f16 (a template on the type), converted to f32 as they are loaded.
//
// What bounds it on the card: the 4*BH*d*S(S+1)/2 causal flops (tensor
// cores: 989 TFLOP/s in bf16) at long S; the q, k, v, o bytes at short S.
// This first version computes on the CUDA cores in f32, which the f32
// contract (3e-5 against the plain f32 softmax) needs; wgmma bf16 tiles are
// later work.  Design: one block of 8 warps per (bh, 64-query tile); the
// q tiles are issued latest first, since the causal work grows with the
// tile index.  The block walks 32-key tiles up to the tile's last query,
// so strictly-future tiles are never touched; the tiles are staged in
// shared memory in f32 (q tile [64][DP], k tile [32][DP+4], v tile
// [32][DP], DP = d rounded up to 32, 64.5 KB at d = 128).  Each warp owns
// 8 query rows: lane j scores key j against the 8 rows (float4 reads, the
// q reads broadcast, the k rows padded so a quarter-warp hits 32 distinct
// banks), the row max and sum are warp shuffles, and the p @ v update
// keeps acc[row][lane + 32t] in registers.  Keys past S and head columns
// past d load as zeros; keys past a query are masked.  Nothing is padded
// in memory, so S and d are arbitrary (d <= 256).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int BQ = 64;               // queries per block
constexpr int BKV = 32;              // keys per tile (one per lane)
constexpr int RPW = BQ / kWarps;     // query rows per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);      // round to nearest even, as torch/XLA
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int d, float scale) {
  constexpr int DP = NT * 32;        // head dim padded to the warp width
  constexpr int KST = DP + 4;        // k row stride (16-byte aligned)
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][DP]
  float* Ks = Qs + BQ * DP;                      // [BKV][KST]
  float* Vs = Ks + BKV * KST;                    // [BKV][DP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const long long base = (long long)blockIdx.y * S * d;
  const int r0 = warp * RPW;

  for (int i = tid; i < BQ * DP; i += blockDim.x) {
    const int r = i / DP, c = i % DP;
    Qs[i] = (q0 + r < S && c < d)
                ? to_f32(q[base + (long long)(q0 + r) * d + c]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][NT];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }

  const int kv_end = min(S, q0 + BQ);
  for (int j0 = 0; j0 < kv_end; j0 += BKV) {
    __syncthreads();                 // the previous tile's readers are done
    for (int i = tid; i < BKV * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      const bool ok = j0 + r < S && c < d;
      const long long g = base + (long long)(j0 + r) * d + c;
      Ks[r * KST + c] = ok ? to_f32(k[g]) : 0.f;
      Vs[r * DP + c] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * KST);
#pragma unroll 4
    for (int c4 = 0; c4 < DP / 4; ++c4) {
      const float4 kk = krow[c4];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(Qs + (r0 + r) * DP)[c4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int kpos = j0 + lane;
    float p[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float sv = (kpos <= q0 + r0 + r) ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      p[r] = expf(sv - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= alpha;
      m[r] = m_new;
    }
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float vj[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) vj[t] = Vs[j * DP + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[r][t] = fmaf(pj, vj[t], acc[r][t]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = lane + 32 * t;
      if (c < d)
        o[base + (long long)qpos * d + c] = from_f32<T>(acc[r][t] / den);
    }
  }
}

template <typename T, int NT>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int d, float scale, cudaStream_t stream) {
  constexpr int DP = NT * 32;
  const size_t smem = size_t(BQ * DP + BKV * (DP + 4) + BKV * DP) * sizeof(float);
  auto kern = flash_attention_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((S + BQ - 1) / BQ, BH);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, d, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH,
             int S, int d, float scale, cudaStream_t st) {
  if (d <= 32) return launch<T, 1>(q, k, v, o, BH, S, d, scale, st);
  if (d <= 64) return launch<T, 2>(q, k, v, o, BH, S, d, scale, st);
  if (d <= 128) return launch<T, 4>(q, k, v, o, BH, S, d, scale, st);
  return launch<T, 8>(q, k, v, o, BH, S, d, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// value (0 = launched); -1 for arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int d, int dtype, float scale,
                                      void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || d <= 0 || d > 256) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, o, BH, S, d, scale, st);
    case 1: return launch_d<__nv_bfloat16>(q, k, v, o, BH, S, d, scale, st);
    case 2: return launch_d<__half>(q, k, v, o, BH, S, d, scale, st);
    default: return -1;
  }
}
