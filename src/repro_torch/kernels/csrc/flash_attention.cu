// Causal flash attention for Hopper (sm_90a) on the tensor cores, plain C
// interface.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel
// (flash_attention_pallas).  For q, k, v (BH, S, d) it computes
//
//   o[b,i,:] = sum_{j<=i} softmax_j(q[b,i,:] . k[b,j,:] * d^-1/2) v[b,j,:]
//
// with the reference's online softmax in f32: running max m (start -1e30),
// running sum l, accumulator acc, masked scores set to -1e30, and the final
// acc / max(l, 1e-30), cast to the input type.  Inputs are f32, bf16 or f16.
//
// What bounds it on the card: the 4*BH*d*S(S+1)/2 causal flops at long S
// (989 TFLOP/s in bf16/f16 on the tensor cores; f32 runs as three TF32
// products, 3 x flops at 495 TFLOP/s), the q, k, v, o bytes at short S.
// mma.sync itself reaches about 63 % of those peaks on an H100 (PERF.md).
//
// Design (FlashAttention-2 on mma.sync): one block of 4 warps per (bh, query
// tile); each warp owns MW m16 row tiles (16 * MW query rows, MW in {1, 2}),
// and the query tiles are issued latest first, since the causal work grows
// with the tile index.  K and V tiles go through a 2-stage cp.async ring in
// shared memory, rows padded by 16 bytes so that ldmatrix and the f32
// fragment reads hit no bank conflicts; keys past S and head columns past d
// arrive as zeros through the copies' zero-fill, so nothing is padded in
// memory and S and d (<= 256) are arbitrary.  The head dim is padded in
// shared memory to D in {32, 64, 128, 256}, a template parameter; rows that
// are not 16-byte aligned (d * size not a multiple of 16) take an instance
// that copies element by element.
//
// - bf16/f16: S = Q.K^T by mma.m16n8k16 with f32 accumulation; at MW = 1 and
//   D <= 128 Q stays in registers as A fragments, elsewhere they are read
//   from shared memory per tile; K tiles are the "col" B operand as ldmatrix
//   gives them.  The f32 score accumulators become the A fragments of
//   O += P.V in registers (the m16n8 accumulator layout is the m16n8k16 A
//   layout), rounded to the input type; V's B fragments come from
//   ldmatrix.trans.  With the output's own rounding, one bf16 rounding of
//   P reaches at most 5.5e-3 of the 8e-3 bf16 tolerance on every measured
//   shape; splitting P into bf16 hi + lo halves (two products) measured
//   the output's rounding alone, 3.9e-3, at 13-27 % more time (PERF.md).
//   MW = 2 (128-query blocks, each K/V fragment feeding two
//   products) is chosen at launch for 16-bit inputs at D = 128 where the
//   grid still holds at least two blocks per SM.
// - f32: every product is 3xTF32 (hi.hi + hi.lo + lo.hi by
//   mma.m16n8k8.tf32, split_tf32 below), enough for the reference's 3e-5
//   absolute tolerance.  Fragments are read with scalar shared loads; P.V
//   permutes the key index inside each 8-key step so that the score
//   accumulators are the A fragments as they are and V needs no transpose.
// The scale and the causal mask apply to the f32 accumulators; only tiles
// that reach past a row tile's first row are masked, and tiles wholly past
// a warp's last row, or warps wholly past S, are skipped (all-masked tiles
// change nothing).  Softmax runs in base 2: the max is taken over raw
// scores and p = 2^(s * d^-1/2 * log2 e - m) is one FFMA and one ex2.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>



namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// MW m16 row tiles per warp (1, or 2 in 16-bit types at D = 128, where
// each K/V fragment then feeds two products)
template <typename T, int D, int MW_ = 1>
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int MW = MW_;
  static_assert(MW == 1 || (!kF32 && D == 128), "two row tiles per warp");
  static constexpr int BQ = 16 * MW * kWarps;       // queries per block
  static constexpr int BKV = (kF32 || D > 128) ? 32 : 64;   // keys per tile
  static constexpr int LD = D + (kF32 ? 4 : 8);     // shared row stride
  static constexpr int kChunk = 16 / int(sizeof(T));   // elements per copy
  static constexpr bool kQRegs = !kF32 && D <= 128 && MW == 1;
  static constexpr size_t kSmem = size_t(BQ + 4 * BKV) * LD * sizeof(T);
  static constexpr int kDim = D;
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; bytes past src_bytes (0..16) are written as zeros
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
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a . b on a 16x8x16 tile, 16-bit inputs, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// c += a . b on a 16x8x8 tile in TF32, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x on the SFU (max relative error 2^-22; -1e30 and below give 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo for 3xTF32: hi is x with the 13 low mantissa bits cleared (a
// TF32 value), lo = x - hi is exact in f32 and |lo| < 2^-10 |x|; the mma
// reads lo's top 11 bits, so hi.hi + hi.lo + lo.hi misses each product by
// less than 2^-19 of it.  (Masking instead of cvt.rna.tf32, which is several
// instructions on this target, cut the f32 kernel's time by 38 %.)
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = __float_as_uint(x[i]) & 0xffffe000u;
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
}

// the A fragment word of the pair (x0, x1) in T, x0 in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// o[0], o[1] = x0, x1 in T, one 2-element store (o is 2-element aligned)
__device__ __forceinline__ void store2(float* o, float x0, float x1) {
  *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(__half* o, float x0, float x1) {
  *reinterpret_cast<__half2*>(o) = __floats2half2_rn(x0, x1);
}

// ROWS rows of one (S, d) matrix from row r0 into a [ROWS][LD] tile: 16-byte
// cp.async with zero-fill where the row is past S or the columns past d
// (VEC); element by element, synchronously, where rows are not 16-byte
// aligned.  Each thread copies one fixed 16-byte column of every RSTEP-th
// row.
template <typename C, int ROWS, bool VEC, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int S,
                                          int d) {
  constexpr int CH = C::kDim / C::kChunk;      // 16-byte chunks per row
  constexpr int RSTEP = kWarps * 32 / CH;
  static_assert(RSTEP >= 1 && ROWS % RSTEP == 0, "tile rows per pass");
  const int c = (threadIdx.x % CH) * C::kChunk;
  const int nc = max(0, min(C::kChunk, d - c));  // elements inside d
#pragma unroll
  for (int i = 0; i < ROWS / RSTEP; ++i) {
    const int r = threadIdx.x / CH + i * RSTEP;
    const int row = r0 + r;
    const int n = row < S ? nc : 0;
    const T* g = n ? src + (long long)row * d + c : src;
    T* s = dst + r * C::LD + c;
    if constexpr (VEC) {
      cp_async16(smem_u32(s), g, n * int(sizeof(T)));
    } else {
#pragma unroll
      for (int e = 0; e < C::kChunk; ++e)
        s[e] = e < n ? g[e] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int D, int MW_, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int d, float scale_log2) {
  using C = Tile<T, D, MW_>;
  constexpr int BKV = C::BKV, LD = C::LD, MW = C::MW, BQ = C::BQ;
  constexpr int NT = BKV / 8;          // score accumulators: 8 keys each
  constexpr int DT = D / 8;            // output accumulators: 8 columns each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);      // [BQ][LD]
  T* Ks = Qs + BQ * LD;                        // [2][BKV][LD]
  T* Vs = Ks + 2 * BKV * LD;                   // [2][BKV][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int wrow = warp * 16 * MW;             // the warp's first row
  const long long base = (long long)blockIdx.y * S * d;
  q += base;
  k += base;
  v += base;
  o += base;
  // key tiles up to the block's last query; later ones are all future keys
  const int n_tiles = (min(S, q0 + BQ) + BKV - 1) / BKV;

  load_tile<C, BQ, VEC>(Qs, q, q0, S, d);
  load_tile<C, BKV, VEC>(Ks, k, 0, S, d);
  load_tile<C, BKV, VEC>(Vs, v, 0, S, d);
  cp_async_commit();

  // per m16 tile w of the warp: rows wrow + 16w + g (accumulator entries
  // 0, 1) and + 8 (entries 2, 3)
  float acc[MW][DT][4], m[MW][2], l[MW][2];
#pragma unroll
  for (int w = 0; w < MW; ++w) {
    m[w][0] = m[w][1] = kNegInf;
    l[w][0] = l[w][1] = 0.f;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      acc[w][i][0] = acc[w][i][1] = acc[w][i][2] = acc[w][i][3] = 0.f;
  }
  uint32_t qf[C::kQRegs ? D / 16 : 1][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<C, BKV, VEC>(Ks + (st ^ 1) * BKV * LD, k, (t + 1) * BKV, S,
                             d);
      load_tile<C, BKV, VEC>(Vs + (st ^ 1) * BKV * LD, v, (t + 1) * BKV, S,
                             d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = Ks + st * BKV * LD;
    const T* Vt = Vs + st * BKV * LD;

    if constexpr (C::kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc)
          ldsm_x4(qf[kc], smem_u32(Qs + (wrow + (lane & 15)) * LD + kc * 16 +
                                   (lane >> 4) * 8));
      }
    }

    // tiles whose first key follows the warp's last row change nothing, nor
    // does any tile for a warp whose rows are all past S
    if (t * BKV <= q0 + wrow + 16 * MW - 1 && q0 + wrow < S) {
      float s[MW][NT][4];
#pragma unroll
      for (int w = 0; w < MW; ++w)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          s[w][j][0] = s[w][j][1] = s[w][j][2] = s[w][j][3] = 0.f;

      // ---- S = Q . K^T ----
      if constexpr (!C::kF32) {
        const int mi = lane >> 3;
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          uint32_t a[MW][4];
#pragma unroll
          for (int w = 0; w < MW; ++w) {
            if constexpr (C::kQRegs) {
#pragma unroll
              for (int i = 0; i < 4; ++i) a[w][i] = qf[kc][i];
            } else {
              ldsm_x4(a[w], smem_u32(Qs + (wrow + 16 * w + (lane & 15)) * LD +
                                     kc * 16 + (lane >> 4) * 8));
            }
          }
#pragma unroll
          for (int jj = 0; jj < NT / 2; ++jj) {
            uint32_t b[4];
            ldsm_x4(b, smem_u32(Kt + (jj * 16 + (mi >> 1) * 8 + (lane & 7)) * LD
                                + kc * 16 + (mi & 1) * 8));
#pragma unroll
            for (int w = 0; w < MW; ++w) {
              mma16<T>(s[w][2 * jj], a[w], b[0], b[1]);
              mma16<T>(s[w][2 * jj + 1], a[w], b[2], b[3]);
            }
          }
        }
      } else {
#pragma unroll 4
        for (int kc = 0; kc < D / 8; ++kc) {
          uint32_t ah[MW][4], al[MW][4];
#pragma unroll
          for (int w = 0; w < MW; ++w) {
            const float* qa = Qs + (wrow + 16 * w + g) * LD + kc * 8 + tig;
            const float af[4] = {qa[0], qa[8 * LD], qa[4], qa[8 * LD + 4]};
            split_tf32(af, ah[w], al[w]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float* kb = Kt + (j * 8 + g) * LD + kc * 8 + tig;
            const float bf[2] = {kb[0], kb[4]};
            uint32_t bh[2], bl[2];
            split_tf32(bf, bh, bl);
#pragma unroll
            for (int w = 0; w < MW; ++w) {
              mma_tf32(s[w][j], al[w], bh);
              mma_tf32(s[w][j], ah[w], bl);
              mma_tf32(s[w][j], ah[w], bh);
            }
          }
        }
      }

      // ---- causal mask, online softmax (base 2) ----
      // scores stay unscaled: max over raw scores (the scale is positive),
      // then p = 2^(s * scale * log2 e - m) in one FFMA
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        const int r0 = q0 + wrow + 16 * w;       // the m16 tile's first row
        float mx[2] = {kNegInf, kNegInf};
        if ((t + 1) * BKV - 1 > r0) {            // keys past some row
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (t * BKV + j * 8 + 2 * tig + (e & 1) > r0 + g + (e >> 1) * 8)
                s[w][j][e] = kNegInf;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[w][j][e]);
        float alpha[2], mneg[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          const float m_new = fmaxf(m[w][r], mx[r] * scale_log2);
          alpha[r] = ex2(m[w][r] - m_new);
          m[w][r] = m_new;
          mneg[r] = -m_new;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[w][j][e] = ex2(fmaf(s[w][j][e], scale_log2, mneg[e >> 1]));
            rs[e >> 1] += s[w][j][e];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[w][r] = l[w][r] * alpha[r] + rs[r];
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          acc[w][i][0] *= alpha[0];
          acc[w][i][1] *= alpha[0];
          acc[w][i][2] *= alpha[1];
          acc[w][i][3] *= alpha[1];
        }
      }

      // ---- O += P . V ----
      if constexpr (!C::kF32) {
        const int mi = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          uint32_t ph[MW][4];
#pragma unroll
          for (int w = 0; w < MW; ++w)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              ph[w][i] = pack2<T>(s[w][2 * kk + (i >> 1)][2 * (i & 1)],
                                  s[w][2 * kk + (i >> 1)][2 * (i & 1) + 1]);
#pragma unroll
          for (int dd = 0; dd < D / 16; ++dd) {
            uint32_t b[4];
            ldsm_x4_t(b, smem_u32(Vt + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                           LD + dd * 16 + (mi >> 1) * 8));
#pragma unroll
            for (int w = 0; w < MW; ++w) {
              mma16<T>(acc[w][2 * dd], ph[w], b[0], b[1]);
              mma16<T>(acc[w][2 * dd + 1], ph[w], b[2], b[3]);
            }
          }
        }
      } else {
        // key 2*tig of the step is k index tig, key 2*tig+1 is tig + 4
#pragma unroll
        for (int kc = 0; kc < NT; ++kc) {
          uint32_t ph[MW][4], pl[MW][4];
#pragma unroll
          for (int w = 0; w < MW; ++w) {
            const float pa[4] = {s[w][kc][0], s[w][kc][2], s[w][kc][1],
                                 s[w][kc][3]};
            split_tf32(pa, ph[w], pl[w]);
          }
          const float* vb = Vt + (kc * 8 + 2 * tig) * LD + g;
#pragma unroll
          for (int i = 0; i < DT; ++i) {
            const float bf[2] = {vb[i * 8], vb[LD + i * 8]};
            uint32_t bh[2], bl[2];
            split_tf32(bf, bh, bl);
#pragma unroll
            for (int w = 0; w < MW; ++w) {
              mma_tf32(acc[w][i], pl[w], bh);
              mma_tf32(acc[w][i], ph[w], bl);
              mma_tf32(acc[w][i], ph[w], bh);
            }
          }
        }
      }
    }
    __syncthreads();          // every warp is done with this stage
  }

  // ---- o = acc / max(l, 1e-30) ----
#pragma unroll
  for (int w = 0; w < MW; ++w) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[w][r];
      lr += __shfl_xor_sync(kFull, lr, 1);
      lr += __shfl_xor_sync(kFull, lr, 2);
      lr = fmaxf(lr, 1e-30f);
      const int row = q0 + wrow + 16 * w + g + 8 * r;
      if (row >= S) continue;
      T* orow = o + (long long)row * d;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        const int col = i * 8 + 2 * tig;
        if (col >= d) continue;
        const float x0 = acc[w][i][2 * r] / lr, x1 = acc[w][i][2 * r + 1] / lr;
        if (d % 2 == 0) {
          store2(orow + col, x0, x1);
        } else {
          orow[col] = from_f32<T>(x0);
          if (col + 1 < d) orow[col + 1] = from_f32<T>(x1);
        }
      }
    }
  }
}

template <typename T, int D, int MW, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int d, float scale, int dev, cudaStream_t stream) {
  using C = Tile<T, D, MW>;
  auto kern = flash_attention_kernel<T, D, MW, VEC>;
  static unsigned attr_set = 0;        // one bit per device
  if (!(attr_set >> dev & 1u)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::kSmem));
    if (err != cudaSuccess) return int(err);
    attr_set |= 1u << dev;
  }
  dim3 grid((S + C::BQ - 1) / C::BQ, BH);
  kern<<<grid, kWarps * 32, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, d, scale * kLog2e);
  return int(cudaGetLastError());
}

// Rows that are not 16-byte aligned take the element-by-element copy (one
// row tile per warp).  Otherwise 16-bit inputs at D = 128 take two row
// tiles per warp (128-query blocks) where that grid still holds at least
// two blocks per SM, one elsewhere.
template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH,
             int S, int d, float scale, int dev, int sms, cudaStream_t st) {
  const bool vec = (size_t(d) * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (!vec) return launch<T, D, 1, false>(q, k, v, o, BH, S, d, scale, dev, st);
  if constexpr (!std::is_same<T, float>::value && D == 128) {
    if ((long long)BH * ((S + 127) / 128) >= 2LL * sms)
      return launch<T, D, 2, true>(q, k, v, o, BH, S, d, scale, dev, st);
  }
  return launch<T, D, 1, true>(q, k, v, o, BH, S, d, scale, dev, st);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, int BH,
             int S, int d, float scale, int dev, int sms, cudaStream_t st) {
  if (d <= 32) return launch_d<T, 32>(q, k, v, o, BH, S, d, scale, dev, sms, st);
  if (d <= 64) return launch_d<T, 64>(q, k, v, o, BH, S, d, scale, dev, sms, st);
  if (d <= 128)
    return launch_d<T, 128>(q, k, v, o, BH, S, d, scale, dev, sms, st);
  return launch_d<T, 256>(q, k, v, o, BH, S, d, scale, dev, sms, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// value (0 = launched); -1 for arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int d, int dtype, float scale,
                                      void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || d <= 0 || d > 256) return -1;
  static int sms[32] = {};              // SM count per device, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= 32) return -1;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return int(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<float>(q, k, v, o, BH, S, d, scale, dev, sms[dev], st);
    case 1:
      return launch_t<__nv_bfloat16>(q, k, v, o, BH, S, d, scale, dev,
                                     sms[dev], st);
    case 2: return launch_t<__half>(q, k, v, o, BH, S, d, scale, dev, sms[dev], st);
    default: return -1;
  }
}
