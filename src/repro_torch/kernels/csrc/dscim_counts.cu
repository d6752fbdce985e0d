// Raw DS-CIM OR-accumulated counts for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas kernels that compute the same function:
//   src/repro/kernels/dscim_mvm.py::_kernel (dscim_counts_pallas: all L
//     sampling points, the SNG compares (cu==bc)&(lu<a) x (cv==br)&(lv<b)
//     expanded to {0,1} bits in the kernel), and
//   src/repro/kernels/dscim_mvm_blocked.py::_kernel (dscim_counts_blocked:
//     each row compared only with the points of its own block).
// For int8 x (M, K) and w (K, N), a = (x+128)>>k and b = (w+128)>>k, both
// compute the exact integer count matrix
//
//   C[m,n] = sum_h |{t : (cu_t, cv_t) = block(h mod G),
//                        lu_t < a[m,h], lv_t < b[h,n]}|
//
// Grouping the points by block is an exact rewrite for any point set, so
// the all-L bit expansion is not carried over (at M=256, K=1024, N=3072,
// L=256 it is 2*10^11 bit products).  The wrapper hands over per-block
// bit-mask tables of W uint32 words: bit p of ta[g][a][w] is set when
// point 32w+p of block g has lu < a, and likewise tb[g][b][w] for lv < b.
// Then
//
//   C[m,n] = sum_h sum_w popc(ta[h%G][a[m,h]][w] & tb[h%G][b[h,n]][w])
//
// for any point set with at most 32*W points in one block (W = 8 holds all
// 256 points of an L=256 set in one block).  Counts are exact integers,
// written as f32 as in the reference (counts < 2^24).
//
// What bounds it on the card: the M*N*K*W popcount-and-table-read steps
// (the int8 operands are a few MB and read from L2 once per tile).
// Design: one block of 8 warps per (32 columns, MT rows).  Each lane owns
// one column, so a warp's weight loads are 32 contiguous bytes.  Warps
// split K in 32-row chunks (chunk c goes to warp c mod 8); a warp stages
// the table offsets of its chunk's activations in shared memory and reads
// the activation masks as broadcasts.  Both tables live in dynamic shared
// memory (2*G*S*W*4 bytes: 16 KB at W = 1, 128 KB at k = 3, W = 8).  The
// 8 per-warp integer partial counts are added in a fixed order through
// shared memory, no atomics.  Ragged M/N/K edges are masked; nothing is
// padded.  Tensor-core bit expansion is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 32;                 // rows of K per warp step
constexpr int kMaxSmem = 232448;           // H100: 227 KB per block

template <int W, int MT>
__global__ void __launch_bounds__(kWarps * 32)
dscim_counts_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const uint32_t* __restrict__ ta,
                    const uint32_t* __restrict__ tb, float* __restrict__ out,
                    int M, int K, int N, int k, int G, int S) {
  extern __shared__ uint32_t smem[];
  uint32_t* ta_s = smem;                         // [G][S][W]
  uint32_t* tb_s = ta_s + G * S * W;             // [G][S][W]
  int* buf = reinterpret_cast<int*>(tb_s + G * S * W);  // [kWarps][MT][32]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * MT;
  const bool col_ok = n < N;
  const int gmask = G - 1;                       // G = 4^k, a power of two

  for (int i = tid; i < G * S * W; i += blockDim.x) {
    ta_s[i] = ta[i];
    tb_s[i] = tb[i];
  }
  __syncthreads();

  int* off = buf + warp * MT * kChunk;           // ta offsets of the chunk
  int cnt[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) cnt[m] = 0;

  for (int h0 = warp * kChunk; h0 < K; h0 += kWarps * kChunk) {
    const int h = h0 + lane;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      int o = 0;
      if (h < K && m0 + m < M) {
        const int a = (x[(long long)(m0 + m) * K + h] + 128) >> k;
        o = ((h & gmask) * S + a) * W;
      }
      off[m * kChunk + lane] = o;
    }
    __syncwarp();
    const int rend = min(kChunk, K - h0);
    if (col_ok) {
      const int8_t* wp = w + (long long)h0 * N + n;
      for (int rr = 0; rr < rend; ++rr) {
        const int b = (wp[(long long)rr * N] + 128) >> k;
        const uint32_t* tbp = tb_s + (((h0 + rr) & gmask) * S + b) * W;
        uint32_t mb[W];
#pragma unroll
        for (int j = 0; j < W; ++j) mb[j] = tbp[j];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint32_t* tap = ta_s + off[m * kChunk + rr];
#pragma unroll
          for (int j = 0; j < W; ++j) cnt[m] += __popc(tap[j] & mb[j]);
        }
      }
    }
    __syncwarp();
  }

  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) buf[(warp * MT + m) * 32 + lane] = cnt[m];
  __syncthreads();
  if (warp == 0 && col_ok) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m < M) {
        int s = 0;
        for (int v = 0; v < kWarps; ++v) s += buf[(v * MT + m) * 32 + lane];
        out[(long long)(m0 + m) * N + n] = (float)s;
      }
    }
  }
}

template <int W, int MT>
int launch(const void* x, const void* w, const void* ta, const void* tb,
           void* out, int M, int K, int N, int k, int G, int S,
           cudaStream_t stream) {
  const size_t smem = (size_t(2) * G * S * W + size_t(kWarps) * MT * kChunk)
                      * sizeof(uint32_t);
  if (smem > size_t(kMaxSmem)) return -1;
  auto kern = dscim_counts_kernel<W, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + 31) / 32, (M + MT - 1) / MT);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const uint32_t*>(ta), static_cast<const uint32_t*>(tb),
      static_cast<float*>(out), M, K, N, k, G, S);
  return int(cudaGetLastError());
}

template <int W>
int launch_w(const void* x, const void* w, const void* ta, const void* tb,
             void* out, int M, int K, int N, int k, int G, int S,
             cudaStream_t st) {
  if (M <= 4) return launch<W, 4>(x, w, ta, tb, out, M, K, N, k, G, S, st);
  if (M <= 8) return launch<W, 8>(x, w, ta, tb, out, M, K, N, k, G, S, st);
  return launch<W, 16>(x, w, ta, tb, out, M, K, N, k, G, S, st);
}

}  // namespace

// Returns a cudaError_t value (0 = launched).  -1: arguments the kernel
// does not take (checked again here; the Python wrapper checks first).
extern "C" int dscim_counts_launch(const void* x, const void* w,
                                   const void* ta, const void* tb, void* out,
                                   int M, int K, int N, int k, int G, int S,
                                   int W, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || (G & (G - 1)) != 0) return -1;
  if (S != (256 >> k) || (M + 15) / 16 > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch_w<1>(x, w, ta, tb, out, M, K, N, k, G, S, st);
    case 2: return launch_w<2>(x, w, ta, tb, out, M, K, N, k, G, S, st);
    case 4: return launch_w<4>(x, w, ta, tb, out, M, K, N, k, G, S, st);
    case 8: return launch_w<8>(x, w, ta, tb, out, M, K, N, k, G, S, st);
    default: return -1;
  }
}
