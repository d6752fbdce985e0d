// Exact int8 x int8 -> int32 GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/int8_matmul.py::_kernel (int8_matmul_pallas,
// entry ops.int8_matmul), the DCIM adder-tree baseline the paper compares
// the DS-CIM estimate against:  out[m,n] = sum_k x[m,k] * w[k,n]  in int32.
//
// What bounds it on the card: at the MLP shapes the 2*M*N*K integer
// operations (int8 tensor cores: 1979 TOP/s) above M of a few dozen, the
// int8 operand bytes below.  This first version runs on the CUDA cores,
// not the tensor cores: __dp4a (four int8 products summed into an int32)
// over shared-memory tiles.  One block of 256 threads per 64x64 output
// tile; each thread owns a 4x4 sub-tile at rows ty+16i and columns tx+16j,
// so its shared-memory reads are broadcasts (A) or conflict-free (B) and
// its output stores are coalesced.  K goes in 32-byte steps: the A tile is
// stored K-packed as As[k/4][m] and the B tile, read from w's row-major
// (K, N) layout, is repacked so that each word holds four consecutive k of
// one column (Bs[k/4][n]), the layout __dp4a needs.  Ragged M/N/K edges
// load as zeros, which add nothing.  The int32 sums are exact (and wrap as
// the reference's int32 accumulation would).  Tensor-core mma/wgmma s8
// tiles are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, KW = BK / 4;

__global__ void __launch_bounds__(256)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int32_t* __restrict__ out, int M, int N, int K) {
  __shared__ int As[KW][BM];
  __shared__ int Bs[KW][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A: 64 rows x 8 words; a thread packs 4 consecutive bytes of one row
    for (int i = tid; i < BM * KW; i += 256) {
      const int m = i / KW, kw = i % KW;
      const int gm = m0 + m, gk = k0 + 4 * kw;
      uint32_t v = 0;
      if (gm < M) {
        const int8_t* p = x + (long long)gm * K + gk;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (gk + b < K) v |= uint32_t(uint8_t(p[b])) << (8 * b);
      }
      As[kw][m] = int(v);
    }
    // B: 8 words x 64 columns; a thread packs rows gk..gk+3 of one column
    for (int i = tid; i < KW * BN; i += 256) {
      const int n = i % BN, kw = i / BN;
      const int gn = n0 + n, gk = k0 + 4 * kw;
      uint32_t v = 0;
      if (gn < N) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (gk + b < K)
            v |= uint32_t(uint8_t(w[(long long)(gk + b) * N + gn])) << (8 * b);
      }
      Bs[kw][n] = int(v);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kw][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kw][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// Returns a cudaError_t value (0 = launched); -1 for shapes the kernel
// does not take.
extern "C" int int8_matmul_launch(const void* x, const void* w, void* out,
                                  int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535) return -1;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, N, K);
  return int(cudaGetLastError());
}
