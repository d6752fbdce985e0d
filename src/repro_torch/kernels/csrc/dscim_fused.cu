// Fused DS-CIM MVM for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/dscim_fused.py::_kernel (launched by
// _fused_call, entry dscim_fused_mvm_prepared).  Computes, for int8
// activations xq (M, nw*g) with per-(row, window) scales sx (M, nw) and
// prepared int8 weight planes wq (nw*g, N) with scales sw (nw, N):
//
//   out[m,n] = sum_u  sx[m,u] * sw[u,n] * psum_u[m,n]
//   psum_u   = scale*C_u - 128*sum(x) - 128*sum(w+128)
//              (+ c1*(sum(a) + sum(b)) + g*delta^2 for center truncation)
//
// with a = (x+128)>>k, b = (w+128)>>k and C_u the OR-accumulated count of
// window u.  The count of one row r is the number of sampling points p of
// its block (r mod G, the row index *within the window*) with
// lu_p < a and lv_p < b.  The wrapper hands over two (G, S) tables of
// uint32 bit masks, ta[g][a] = {p : lu_p < a} and tb[g][b] = {p : lv_p < b}
// (pmax <= 32 bits), so the count is exact integer arithmetic:
//   C_u[m,n] = sum_r popc(ta[r%G][a[m,r]] & tb[r%G][b[r,n]]).
// This equals the reference's {0,1} bit-expansion dot product and its
// joint-count LUT bit for bit.
//
// What bounds it on the card: at decode (M = batch <= 16) the bytes of the
// int8 weight planes (K*N) read once; at prefill (M = 256) the M*N*K
// popcounts.  Design: one block of 8 warps per (32 columns, MT rows); each
// lane owns one column, so the weight row loads of a warp are 32
// contiguous bytes, and every weight byte is read once per M tile.  Warps
// split the windows (u = warp, warp+8, ...), keep integer counts over the
// g rows of a window, apply the exact corrections and the sx*sw dequant in
// f32 at the window's end, and the 8 per-warp partial sums are added in a
// fixed order through shared memory: the result does not depend on
// scheduling.  The activation masks of 32 rows are staged per warp in
// shared memory and read as broadcasts.  Tensor-core bit expansion is
// later work.
//
// No padding: the kernel walks exactly the g rows of each window (the
// reference's never-fire sentinel rows and the half of its window
// constant that cancels them do not exist here) and masks the ragged
// M/N edges.  It allocates nothing and runs on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 32;       // rows staged per warp
constexpr int kMaxTab = 2048;    // G*S: 512 (k=1), 1024 (k=2), 2048 (k=3)

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int MT>
__global__ void __launch_bounds__(kWarps * 32)
dscim_fused_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                   const int8_t* __restrict__ wq, const float* __restrict__ sw,
                   const uint32_t* __restrict__ ta,
                   const uint32_t* __restrict__ tb, float* __restrict__ out,
                   int M, int N, int nw, int g, int k, int G, int S,
                   float scale, float c1, float wconst) {
  __shared__ uint32_t ta_s[kMaxTab];
  __shared__ uint32_t tb_s[kMaxTab];
  // per-warp activation masks [MT][kChunk]; reused for the final reduction
  __shared__ uint32_t buf[kWarps * MT * kChunk];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * MT;
  const bool col_ok = n < N;
  const long long K = (long long)nw * g;

  for (int i = tid; i < G * S; i += blockDim.x) {
    ta_s[i] = ta[i];
    tb_s[i] = tb[i];
  }
  __syncthreads();

  uint32_t* am = buf + warp * MT * kChunk;
  float total[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) total[m] = 0.f;

  for (int u = warp; u < nw; u += kWarps) {
    int cnt[MT], xs[MT], as[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) cnt[m] = xs[m] = as[m] = 0;
    int wsum = 0, bsum = 0;
    for (int r0 = 0; r0 < g; r0 += kChunk) {
      const int r = r0 + lane;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t mask = 0;
        if (r < g && m0 + m < M) {
          const int xv = xq[(long long)(m0 + m) * K + (long long)u * g + r];
          const int a = (xv + 128) >> k;
          mask = ta_s[(r % G) * S + a];
          xs[m] += xv;
          as[m] += a;
        }
        am[m * kChunk + lane] = mask;
      }
      __syncwarp();
      const int rend = min(kChunk, g - r0);
      if (col_ok) {
        const int8_t* wp = wq + ((long long)u * g + r0) * N + n;
#pragma unroll 4
        for (int rr = 0; rr < rend; ++rr) {
          const int wv = wp[(long long)rr * N];
          const int b = (wv + 128) >> k;
          const uint32_t mb = tb_s[((r0 + rr) % G) * S + b];
          wsum += wv + 128;
          bsum += b;
#pragma unroll
          for (int m = 0; m < MT; ++m)
            cnt[m] += __popc(am[m * kChunk + rr] & mb);
        }
      }
      __syncwarp();
    }
    const float swv = col_ok ? sw[(long long)u * N + n] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int xsum = warp_sum(xs[m]);
      const int asum = warp_sum(as[m]);
      if (m0 + m < M) {
        float psum = scale * (float)cnt[m];
        psum = psum - 128.f * (float)xsum;
        psum = psum - 128.f * (float)wsum;
        if (c1 != 0.f) psum = psum + c1 * (float)(asum + bsum);
        psum = psum + wconst;
        total[m] += psum * sx[(long long)(m0 + m) * nw + u] * swv;
      }
    }
  }

  __syncthreads();
  float* red = reinterpret_cast<float*>(buf);   // [kWarps][MT][32]
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(warp * MT + m) * 32 + lane] = total[m];
  __syncthreads();
  if (warp == 0 && col_ok) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m < M) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[(w * MT + m) * 32 + lane];
        out[(long long)(m0 + m) * N + n] = s;
      }
    }
  }
}

template <int MT>
void launch(const void* xq, const void* sx, const void* wq, const void* sw,
            const void* ta, const void* tb, void* out, int M, int N, int nw,
            int g, int k, int G, int S, float scale, float c1, float wconst,
            cudaStream_t stream) {
  dim3 grid((N + 31) / 32, (M + MT - 1) / MT);
  dscim_fused_kernel<MT><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(wq), static_cast<const float*>(sw),
      static_cast<const uint32_t*>(ta), static_cast<const uint32_t*>(tb),
      static_cast<float*>(out), M, N, nw, g, k, G, S, scale, c1, wconst);
}

}  // namespace

// Returns a cudaError_t value (0 = launched).  -1: arguments the kernel
// does not take (checked again here; the Python wrapper checks first).
extern "C" int dscim_fused_launch(const void* xq, const void* sx,
                                  const void* wq, const void* sw,
                                  const void* ta, const void* tb, void* out,
                                  int M, int N, int nw, int g, int k, int G,
                                  int S, float scale, float c1, float wconst,
                                  void* stream) {
  if (G * S > kMaxTab || M <= 0 || N <= 0 || nw <= 0 || g <= 0) return -1;
  if ((M + 15) / 16 > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4)
    launch<4>(xq, sx, wq, sw, ta, tb, out, M, N, nw, g, k, G, S, scale, c1,
              wconst, st);
  else if (M <= 8)
    launch<8>(xq, sx, wq, sw, ta, tb, out, M, N, nw, g, k, G, S, scale, c1,
              wconst, st);
  else
    launch<16>(xq, sx, wq, sw, ta, tb, out, M, N, nw, g, k, G, S, scale, c1,
               wconst, st);
  return static_cast<int>(cudaGetLastError());
}
