// Exact int8 x int8 -> int32 GEMM for Hopper (sm_90a) on the int8 tensor
// cores, plain C interface.
//
// Replaces: src/repro/kernels/int8_matmul.py::_kernel (int8_matmul_pallas,
// entry ops.int8_matmul), the DCIM adder-tree baseline the paper compares
// the DS-CIM estimate against:  out[m,n] = sum_k x[m,k] * w[k,n]  in int32.
//
// What bounds it on the card: the 2*M*N*K integer operations (1979 TOP/s on
// the int8 tensor cores) at large M, the int8 operand bytes at small M; at
// qwen3-0.6b's MLP shapes the bound is a microsecond or two, so launch and
// fill time weigh as much as the arithmetic.
//
// Design: mma.sync.m16n8k32 s8 x s8 -> s32 over BM x 128 output tiles, 8
// warps in a 2 x 4 grid, K in 64-byte steps through a 3-stage ring of
// 16-byte cp.async copies (zero-filled past the ragged M, N and K edges:
// zeros add nothing).  x (M, K) is K-contiguous, the "row" A operand, read
// with ldmatrix.  The s8 mma takes B K-major only and w (K, N) is
// N-contiguous; ldmatrix.trans transposes 16-bit pairs, not bytes, so B
// fragments are built in two steps: one ldmatrix.x4.trans over the K rows
// {0,1,4,5,8,9,12,13} and {2,3,6,7,...} (+16) of a 16-column chunk gives
// each thread 2 x 2 byte blocks (k 4t, 4t+1 | 4t+2, 4t+3; columns 2g, 2g+1),
// and __byte_perm joins them into the K-major words of columns 2g and 2g+1.
// Column 16c + 2g + p of a warp's 32 is column g of its n8 tile 2c + p, so
// each thread ends with 4 consecutive output columns per chunk and row.
// Shared tiles are XOR-swizzled in 16-byte units so that every ldmatrix
// phase hits 8 distinct bank groups.  Rows that are not 16-byte aligned (K
// or N not a multiple of 16) are copied byte by byte instead.  m16 tiles
// wholly past M are skipped.
//
// Filling the card: BM = 128 where 128-row tiles alone number at least the
// SMs, else BM = 64.  Where the tiles are fewer than the SMs, K is split:
// splits = min(k steps, floor(SMs / tiles)), so that no SM gets two blocks
// (co-resident blocks would share its tensor cores), rounded so that each
// split has the same number of 64-byte k steps (the last one fewer).  Each
// split adds its partial sums into the output, zeroed first, with int32
// atomics, staged through shared memory so that each warp instruction adds
// 32 consecutive words.  Integer addition is associative and wraps modulo
// 2^32 as the reference's int32 accumulation does, so the result is bitwise
// the same for any split and any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 128, BK = 64, STAGES = 3, kThreads = 256;

template <int BM>
struct Cfg {
  static constexpr int WM = BM / 2;        // rows per warp (2 x 4 warps)
  static constexpr int MT = WM / 16;       // m16 tiles per warp
  static constexpr int A_BYTES = BM * BK;  // [BM][64], 4 chunks a row
  static constexpr int STAGE = A_BYTES + BK * BN;   // + [64][128], 8 chunks
  static constexpr int SMEM = STAGES * STAGE;   // <= 48 KB: no opt-in
  static_assert(SMEM >= 8 * 32 * 36 * 4 && SMEM <= 48 * 1024, "smem");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a . b on a 16x8x32 tile, s8 inputs, s32 accumulators (wrapping)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// byte offsets of 16-byte chunk c of row r in the swizzled tiles: A rows
// r..r+7 (one ldmatrix phase) land in 8 distinct bank groups, and so do the
// B rows {0,1,4,5,8,9,12,13} + const and {2,3,6,7,10,11,14,15} + const
__device__ __forceinline__ int a_off(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}
__device__ __forceinline__ int b_off(int r, int c) {
  return r * BN + ((c ^ ((r & 1) | ((r >> 1) & 6))) << 4);
}

// one 16-byte chunk: n (0..16) bytes from src, zeros after; by cp.async
// (VEC, src stays a valid address where n is 0) or byte by byte where rows
// are not 16-byte aligned
template <bool VEC>
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const int8_t* src,
                                           int n) {
  if constexpr (VEC) {
    cp_async16(smem_u32(dst), src, n);
  } else {
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
    for (int e = 0; e < n; ++e)
      wd[e >> 2] |= uint32_t(uint8_t(src[e])) << (8 * (e & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

template <int BM, bool VEC>
__device__ __forceinline__ void load_stage(uint8_t* st, const int8_t* x,
                                           const int8_t* w, int m0, int n0,
                                           int k0, int M, int N, int K) {
  uint8_t* As = st;
  uint8_t* Bs = st + Cfg<BM>::A_BYTES;
  for (int i = threadIdx.x; i < BM * (BK / 16); i += kThreads) {
    const int r = i >> 2, c = i & 3;
    const int gm = m0 + r, gk = k0 + 16 * c;
    const int n = gm < M ? max(0, min(16, K - gk)) : 0;
    copy_chunk<VEC>(As + a_off(r, c), x + (n ? (long long)gm * K + gk : 0), n);
  }
  for (int i = threadIdx.x; i < BK * (BN / 16); i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const int gk = k0 + r, gn = n0 + 16 * c;
    const int n = gk < K ? max(0, min(16, N - gn)) : 0;
    copy_chunk<VEC>(Bs + b_off(r, c), w + (n ? (long long)gk * N + gn : 0), n);
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int32_t* __restrict__ out, int M, int N, int K,
                   int k_steps, int atomic) {
  using C = Cfg<BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * k_steps;
  const int nk = min(k_steps, (K + BK - 1) / BK - kt0);

  int acc[C::MT][4][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, VEC>(smem + s * C::STAGE, x, w, m0, n0, (kt0 + s) * BK, M,
                          N, K);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();               // stage t landed; stage t - 1 is free
    const int nxt = t + STAGES - 1;
    if (nxt < nk)
      load_stage<BM, VEC>(smem + (nxt % STAGES) * C::STAGE, x, w, m0, n0,
                          (kt0 + nxt) * BK, M, N, K);
    cp_async_commit();

    const uint8_t* As = smem + (t % STAGES) * C::STAGE;
    const uint8_t* Bs = As + C::A_BYTES;
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc) {
      // B fragments of n8 tiles 2c + p: matrix mi of the x4 covers K rows
      // 16 * (mi >> 1) + 2 * (mi & 1) + {0,1,4,5,8,9,12,13} of chunk c
      uint32_t b[4][2];
      const int mi = lane >> 3, r8 = lane & 7;
      const int kr = kc * 32 + (mi >> 1) * 16 + (r8 >> 1) * 4 + (r8 & 1) +
                     (mi & 1) * 2;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t t[4];
        ldsm_x4_t(t, smem_u32(Bs + b_off(kr, 2 * wn + c)));
        b[2 * c][0] = __byte_perm(t[0], t[1], 0x6420);
        b[2 * c + 1][0] = __byte_perm(t[0], t[1], 0x7531);
        b[2 * c][1] = __byte_perm(t[2], t[3], 0x6420);
        b[2 * c + 1][1] = __byte_perm(t[2], t[3], 0x7531);
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        if (m0 + wm * C::WM + i * 16 >= M) continue;   // rows past M
        uint32_t a[4];
        ldsm_x4(a, smem_u32(As + a_off(wm * C::WM + i * 16 + (lane & 15),
                                       2 * kc + (lane >> 4))));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }

  // thread holds rows g, g+8 of each m16 tile at columns 16c + 4*tig + 0..3
  // of the warp's 32: acc[.][2c + p][0|2] at + p, acc[.][2c + p][1|3] at
  // + 2 + p
  auto quad = [&](int i, int h, int c) {
    return make_int4(acc[i][2 * c][2 * h], acc[i][2 * c + 1][2 * h],
                     acc[i][2 * c][2 * h + 1], acc[i][2 * c + 1][2 * h + 1]);
  };
  if (atomic) {
    // per warp, 32 rows at a time through a [32][36] int32 stage (the ring
    // is free once every copy has landed)
    cp_async_wait<0>();
    __syncthreads();
    int* stage = reinterpret_cast<int*>(smem) + warp * 32 * 36;
#pragma unroll
    for (int p = 0; p < C::MT / 2; ++p) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            *reinterpret_cast<int4*>(stage + (ii * 16 + g + 8 * h) * 36 +
                                     16 * c + 4 * tig) = quad(2 * p + ii, h, c);
      __syncwarp();
      const int row0 = m0 + wm * C::WM + 32 * p;
      const int col = n0 + wn * 32 + lane;
      for (int r = 0; r < 32 && row0 + r < M; ++r)
        if (col < N) atomicAdd(out + (long long)(row0 + r) * N + col,
                               stage[r * 36 + lane]);
      __syncwarp();
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * C::WM + i * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n0 + wn * 32 + 16 * c + 4 * tig;
        int32_t* o = out + (long long)row * N + col;
        const int4 v = quad(i, h, c);
        if (N % 4 == 0 && col + 4 <= N) {
          *reinterpret_cast<int4*>(o) = v;
        } else {
          const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (col + u < N) o[u] = e[u];
        }
      }
    }
  }
}

template <int BM>
int launch(const int8_t* x, const int8_t* w, int32_t* out, int M, int N,
           int K, int sms, cudaStream_t stream) {
  using C = Cfg<BM>;
  if ((M + BM - 1) / BM > 65535) return -1;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int k_tiles = (K + BK - 1) / BK;
  int splits = min(k_tiles, max(1, sms / tiles));
  const int k_steps = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + k_steps - 1) / k_steps;
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(out, 0, size_t(M) * N * 4, stream);
    if (err != cudaSuccess) return int(err);
  }
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const int atomic = splits > 1 ? 1 : 0;
  if (vec)
    int8_matmul_kernel<BM, true><<<grid, kThreads, C::SMEM, stream>>>(
        x, w, out, M, N, K, k_steps, atomic);
  else
    int8_matmul_kernel<BM, false><<<grid, kThreads, C::SMEM, stream>>>(
        x, w, out, M, N, K, k_steps, atomic);
  return int(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t value (0 = launched); -1 for shapes the kernel
// does not take.
extern "C" int int8_matmul_launch(const void* x, const void* w, void* out,
                                  int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return -1;
  static int sms[64] = {};              // SM count per device, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= 64) return -1;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return int(err);
  }
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* wi = static_cast<const int8_t*>(w);
  auto* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles128 = ((M + 127LL) / 128) * ((N + BN - 1) / BN);
  return tiles128 >= sms[dev] ? launch<128>(xi, wi, o, M, N, K, sms[dev], st)
                              : launch<64>(xi, wi, o, M, N, K, sms[dev], st);
}
