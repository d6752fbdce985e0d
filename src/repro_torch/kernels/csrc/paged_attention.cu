// Int8 paged-attention decode for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention.py::_kernel (launched by
// _paged_call, entry paged_attention_decode).  One query token per slot:
// for every (slot b, kv head g) it walks the logical pages j <= pos[b]/ps
// through page_table[b, j], dequantizes each int8 page by its per-(page,
// kv head) f32 scale, overlays the slot's bf16 tail page at
// j == pos[b]/ps, masks tokens past pos[b] with -1e30 and runs an f32
// online softmax (m, l, acc) with scale HD^-0.5 for the n_rep query rows
// that share the head; the final division clamps l at 1e-30.
//
// Shapes: q (B, KV, R, HD) f32, pages (P, ps, KV, HD) int8, scales (P, KV)
// f32, tails (B, ps, KV, HD) bf16, table (B, MP) int32, pos (B,) int32 ->
// out (B, KV, R, HD) f32.
//
// What bounds it on the card: the bytes of the pages it reads (int8,
// pos+1 tokens per slot) -- at the decode shapes of the serving path a few
// hundred KB per layer, so in practice the launch itself.  Design: one
// block of 128 threads per (slot, kv head), so the page bytes of one head
// are read once for all of its query rows; a page is dequantized into
// shared memory, each warp takes (row, token) dot products with a shuffle
// reduction, and the softmax statistics stay in shared memory in f32.
// Pages past pos are never read.  expf (not __expf) keeps the reference's
// tolerance.  It allocates nothing and runs on the caller's stream.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const int8_t* __restrict__ kp, const int8_t* __restrict__ vp,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const __nv_bfloat16* __restrict__ kt,
                    const __nv_bfloat16* __restrict__ vt,
                    const int* __restrict__ table, const int* __restrict__ pos,
                    float* __restrict__ out, int KV, int R, int HD, int ps,
                    int MP, float scale) {
  extern __shared__ float sm[];
  float* q_s = sm;                  // [R*HD]
  float* acc_s = q_s + R * HD;      // [R*HD]
  float* k_s = acc_s + R * HD;      // [ps*HD]
  float* v_s = k_s + ps * HD;       // [ps*HD]
  float* s_s = v_s + ps * HD;       // [R*ps]
  float* m_s = s_s + R * ps;        // [R]
  float* l_s = m_s + R;             // [R]
  float* al_s = l_s + R;            // [R]

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int p = pos[b];
  const int tailj = p / ps;
  const long long qoff = ((long long)b * KV + g) * R * HD;

  for (int i = tid; i < R * HD; i += blockDim.x) {
    q_s[i] = q[qoff + i];
    acc_s[i] = 0.f;
  }
  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j <= tailj && j < MP; ++j) {
    const bool tail = j == tailj;
    if (tail) {
      for (int i = tid; i < ps * HD; i += blockDim.x) {
        const int t = i / HD, d = i - (i / HD) * HD;
        const long long o = (((long long)b * ps + t) * KV + g) * HD + d;
        k_s[i] = __bfloat162float(kt[o]);
        v_s[i] = __bfloat162float(vt[o]);
      }
    } else {
      const long long phys = table[(long long)b * MP + j];
      const float sck = ks[phys * KV + g];
      const float scv = vs[phys * KV + g];
      for (int i = tid; i < ps * HD; i += blockDim.x) {
        const int t = i / HD, d = i - (i / HD) * HD;
        const long long o = ((phys * ps + t) * KV + g) * HD + d;
        k_s[i] = (float)kp[o] * sck;
        v_s[i] = (float)vp[o] * scv;
      }
    }
    __syncthreads();

    for (int pr = warp; pr < R * ps; pr += nwarps) {
      const int r = pr / ps, t = pr - (pr / ps) * ps;
      float dot = 0.f;
      for (int d = lane; d < HD; d += 32) dot += q_s[r * HD + d] * k_s[t * HD + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) s_s[pr] = (j * ps + t <= p) ? dot * scale : kNegInf;
    }
    __syncthreads();

    if (tid < R) {
      const int r = tid;
      const float mprev = m_s[r];
      float mx = mprev;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, s_s[r * ps + t]);
      float lsum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float e = expf(s_s[r * ps + t] - mx);
        s_s[r * ps + t] = e;
        lsum += e;
      }
      const float al = expf(mprev - mx);
      l_s[r] = l_s[r] * al + lsum;
      m_s[r] = mx;
      al_s[r] = al;
    }
    __syncthreads();

    for (int i = tid; i < R * HD; i += blockDim.x) {
      const int r = i / HD, d = i - (i / HD) * HD;
      float pv = 0.f;
      for (int t = 0; t < ps; ++t) pv += s_s[r * ps + t] * v_s[t * HD + d];
      acc_s[i] = acc_s[i] * al_s[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * HD; i += blockDim.x) {
    const int r = i / HD;
    out[qoff + i] = acc_s[i] / fmaxf(l_s[r], 1e-30f);
  }
}

}  // namespace

// Returns a cudaError_t value (0 = launched), -1 for arguments the kernel
// does not take.
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* kt,
                                      const void* vt, const void* table,
                                      const void* pos, void* out, int B,
                                      int KV, int R, int HD, int ps, int MP,
                                      float scale, void* stream) {
  if (B <= 0 || KV <= 0 || R <= 0 || HD <= 0 || ps <= 0 || MP <= 0) return -1;
  if (KV > 65535) return -1;
  const size_t smem = sizeof(float) * (2 * (size_t)R * HD + 2 * (size_t)ps * HD
                                       + (size_t)R * ps + 3 * (size_t)R);
  if (smem > 227 * 1024) return -1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, KV);
  paged_decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const __nv_bfloat16*>(kt),
      static_cast<const __nv_bfloat16*>(vt), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<float*>(out), KV, R, HD, ps,
      MP, scale);
  return static_cast<int>(cudaGetLastError());
}
