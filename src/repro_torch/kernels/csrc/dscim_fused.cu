// Fused DS-CIM MVM for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/dscim_fused.py::_kernel (launched by
// _fused_call, entry dscim_fused_mvm_prepared), together with the
// per-(row, window) activation quantization the wrapper ran before it.
// From float activations x (M, K) (f32, bf16 or f16) and prepared int8
// weight planes wq (nw, g, N) with scales sw (nw, N) it computes
//
//   xq[m,u*g+r] = clamp(rint(x / s), +-127),  s = max(|x|_window, eps)/127
//   out[m,n]    = sum_u  sx[m,u] * sw[u,n] * psum_u[m,n]
//   psum_u      = scale*C_u - 128*sum(x) - 128*sum(w+128)
//                 (+ c1*(sum(a) + sum(b)) + g*delta^2 for center truncation)
//
// with a = (xq+128)>>k, b = (w+128)>>k and C_u the OR-accumulated count of
// window u.  A first kernel quantizes x per (row, window) in x's dtype
// exactly as quantize_activations_windowed does it in torch (amax,
// clamp_min(eps), the multiply by the dtype's rounded 1/127, an IEEE
// divide, each rounded to the dtype, then rintf and the clamp), so xq and
// sx are bitwise the torch ones, and sums x and a per window; the MVM
// reads them.  One C call launches both.
//
// The counts: row r of window u adds popc(ta[r%G][a] & tb[r%G][b]), where
// ta[g][a] = {p : lu_p < a} and tb[g][b] = {p : lv_p < b} are 32-bit point
// masks (pmax <= 32).  That is a binary matrix product, and Hopper's tensor
// cores run it: mma.sync m16n8k256 .b1 .and.popc (measured at 4.5x the
// row products per second of s8 m16n8k32 on {0,1} operands expanded to a
// byte per point: scripts/mma_sync_peak.py; the b1 wgmma form, which this
// kernel does not use, peaks 1.5x higher).  One k256 step takes 8 rows,
// one 32-bit mask per row, so the masks are the operands as they are.
// The weight columns sit on the mma's 16-row side and the <= 8 activation
// rows of a tile on its 8 side (decode pads the small side only).
//
// What bounds it: at decode (M <= 16) the int8 weight bytes, read once;
// at prefill (M = 256) the mask lookups that build the operands (the b1
// products themselves are cheap).  Design:
//  * a block (4 warps) owns NC = 64 columns x M_T rows x its windows;
//    weights stream through a 4-stage cp.async ring of 128-row slabs
//    (16-byte copies), and a block walks several column tiles so the ring
//    prefetches across them;
//  * each ring stage also holds the tile rows' xq slab, the tile's sw and
//    the rows' window scalars, so no global load waits inside a job; the
//    activation masks are looked up from xq as the B fragments are built;
//  * each warp owns whole k-ranges of its columns and rows (decode: 16
//    columns each, prefill: 16 rows each), so counts, column sums and
//    window terms stay in its registers: no barrier per window;
//  * the windows are cut into nchunk <= 8 chunks of ceil(nw/8) windows,
//    a function of nw alone, and every output is summed as
//    ((0 + p_0) + p_1) + ..., p_c the chunk's window terms added in window
//    order.  Where the output tiles alone give the card fewer blocks than
//    SMs, each chunk of a tile is a block of its own that stages p_c in
//    global scratch, and the tile's last block to finish (an atomic
//    counter per tile, reset by that block) adds them in chunk order;
//    otherwise one block walks all the chunks.  Either way the same terms
//    are added in the same order, with no float atomics: a row's bits
//    depend neither on its batch nor on the regime.  (A thread-block
//    cluster with distributed shared memory did the same sum about 7 us
//    slower a decode call on an H100.)
//
// No padding: the kernel walks exactly the g rows of each window and
// masks the ragged M/N/K edges.  It allocates nothing and runs on the
// caller's stream.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlab = 128;       // weight rows per ring stage
constexpr int kXPitch = kSlab + 16;     // bytes; conflict-free B fragments
constexpr int kMaxTab = 2048;    // G*S: 512 (k=1), 1024 (k=2), 2048 (k=3)
constexpr int kMaxChunks = 8;    // chunks an output's windows are summed in
constexpr int kSplitNC = 64;     // columns per tile where windows are split

struct Params {
  const void* x;
  const int8_t* wq;
  const float* sw;
  const uint32_t* ta;
  const uint32_t* tb;
  float* out;
  int8_t* xq;         // (M, nw*g) quantized activations
  float* sx;          // (M, nw) their scales
  int* xsum;          // (M, nw) sum of xq over the window
  int* asum;          // (M, nw) sum of a = (xq+128)>>k over the window
  float* stage;       // split: each chunk's partial of each output tile
  int* counters;      // split: chunks done per output tile (left at 0)
  int M, N, K, nw, g, k, G, S;
  int chunk, nchunk, vec, xvec;
  float scale, c1, wconst, eps, recip;
};

template <typename T> struct XT;
template <> struct XT<float> {
  static __device__ __forceinline__ float ld(const void* p, long long i) {
    return static_cast<const float*>(p)[i];
  }
  static __device__ __forceinline__ float rnd(float v) { return v; }
};
template <> struct XT<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const void* p, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};
template <> struct XT<__half> {
  static __device__ __forceinline__ float ld(const void* p, long long i) {
    return __half2float(static_cast<const __half*>(p)[i]);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __half2float(__float2half_rn(v));
  }
};

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void bmma(int (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// One window's term psum * sx * sw, with every rounding explicit (no
// contraction), so each regime computes the same bits.
__device__ __forceinline__ float window_term(const Params& p, int cnt,
                                             int xsum, int asum, int wsum,
                                             int bsum, float sxv, float swv) {
  float ps = __fmul_rn(p.scale, (float)cnt);
  ps = __fsub_rn(ps, __fmul_rn(128.f, (float)xsum));
  ps = __fsub_rn(ps, __fmul_rn(128.f, (float)wsum));
  if (p.c1 != 0.f) ps = __fadd_rn(ps, __fmul_rn(p.c1, (float)(asum + bsum)));
  ps = __fadd_rn(ps, p.wconst);
  return __fmul_rn(__fmul_rn(ps, sxv), swv);
}

// Quantizes row m of x over window u with one warp, in x's dtype as
// quantize_int8 computes it in torch: the g values go to dst[0..g), the
// scale is returned and the sums of q and of a = (q+128)>>k land in every
// lane's xs and as.
template <typename T>
__device__ __forceinline__ float quantize_window(const Params& p, int m, int u,
                                                 int lane, int8_t* dst,
                                                 int& xs, int& as) {
  const long long base = (long long)m * p.K + (long long)u * p.g;
  const int valid = min(p.g, p.K - u * p.g);       // rows past K are x = 0
  float mx = 0.f;
  for (int r = lane; r < valid; r += 32)
    mx = fmaxf(mx, fabsf(XT<T>::ld(p.x, base + r)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  // clamp_min(amax, eps) * (1/127), rounded to x's dtype
  const float sc = XT<T>::rnd(__fmul_rn(mx < p.eps ? p.eps : mx, p.recip));
  xs = as = 0;
  for (int r = lane; r < p.g; r += 32) {
    const float xv = r < valid ? XT<T>::ld(p.x, base + r) : 0.f;
    float qf = rintf(XT<T>::rnd(__fdiv_rn(xv, sc)));
    // torch's clamp keeps a NaN (0 / 0 where eps rounds to 0 in f16), and
    // its cast to int8 makes it 0, as the conversion below does
    qf = qf < -127.f ? -127.f : (qf > 127.f ? 127.f : qf);
    const int q = (int)qf;
    dst[r] = (int8_t)q;
    xs += q;
    as += (q + 128) >> p.k;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    xs += __shfl_xor_sync(0xffffffffu, xs, o);
    as += __shfl_xor_sync(0xffffffffu, as, o);
  }
  return sc;
}

// Per-(row, window) activation quantization, one warp per (m, u).
template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_kernel(const Params p) {
  // let the MVM start its weight loads now; it waits for this grid's
  // results before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int id = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (id >= p.M * p.nw) return;
  const int m = id / p.nw, u = id - (id / p.nw) * p.nw;
  int xs, as;
  const float sc = quantize_window<T>(
      p, m, u, lane, p.xq + (long long)m * p.nw * p.g + (long long)u * p.g,
      xs, as);
  if (lane == 0) {
    p.sx[id] = sc;
    p.xsum[id] = xs;
    p.asum[id] = as;
  }
}

// stage bytes: weights, then the tile rows' xq, sw of the tile, the rows'
// sx / xsum / asum, then the table offset ((r0 + r) % G) * S of each slab
// row r
__host__ __device__ constexpr int stage_bytes(int MT, int NC) {
  return kSlab * NC + MT * kXPitch + 4 * NC + 12 * MT + 4 * kSlab;
}

// Warp layout: WN warps across the NC = 16*TA*WN columns, TA m16 tiles
// (16 columns) each; WM warps across the rows, NT 8-row tiles each;
// WN * WM = 4 and every warp walks every k-step, so its counts, column
// sums and window terms stay in its registers.  SPLIT: the block owns one
// chunk of windows and stages its partial; the tile's last chunk adds
// them (else the block walks every window itself).
template <int TA, int NT, int WN, int WM, bool SPLIT, int STAGES>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const Params p) {
  static_assert(WN * WM == kThreads / 32, "layout");
  constexpr int NC = 16 * TA * WN;            // columns per tile
  constexpr int MT = WM * NT * 8;
  constexpr int CB = 2 * TA;                  // contiguous columns a thread
  constexpr int NWORD = (CB + 3) / 4;         // 32-bit words of them a row
  constexpr uint32_t LANES = CB >= 4 ? 0xFFFFFFFFu : 0x0000FFFFu;
  constexpr int PER = TA * NT * 4;            // output elements per thread
  constexpr int SB = stage_bytes(MT, NC);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  const int tabn = p.G * p.S;
  uint32_t* tb_s = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ta_s = tb_s + tabn;
  unsigned char* ring = reinterpret_cast<unsigned char*>(ta_s + tabn);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = warp % WN, wm = warp / WN;
  const int cb = wn * 16 * TA + CB * gid;     // first column of the thread
  const int rbase = wm * NT * 8;              // first row of the warp
  const int m0 = blockIdx.y * MT;
  const int c = blockIdx.z;                   // chunk
  const int nct = (p.N + NC - 1) / NC;
  const int ub = SPLIT ? c * p.chunk : 0;
  const int nwin = SPLIT ? min(p.nw, ub + p.chunk) - ub : p.nw;
  const int ns = (p.g + kSlab - 1) / kSlab;   // slabs per window
  const int jt = nwin * ns;                   // jobs per column tile
  const int ntiles = (nct - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int njobs = ntiles * jt;
  const long long Kp = (long long)p.nw * p.g;
  const uint32_t bmask4 = 0x01010101u * (0xFFu >> p.k);

  // job j's weight slab, the tile's sw and the slab rows' table offsets,
  // into ring stage j % STAGES, zero-filled past every edge
  auto issue_w = [&](int j) {
    if (j >= njobs) return;
    const int it = j / jt, rem = j - it * jt;
    const int u = ub + rem / ns, s = rem - (rem / ns) * ns;
    const int n0 = (blockIdx.x + it * gridDim.x) * NC;
    const int r0 = s * kSlab, rows = min(kSlab, p.g - r0);
    unsigned char* st = ring + (j % STAGES) * SB;
    const int8_t* src = p.wq + ((long long)u * p.g + r0) * p.N + n0;
    if (p.vec == 16) {
      for (int i = tid; i < kSlab * (NC / 16); i += kThreads) {
        const int r = i / (NC / 16), col = (i % (NC / 16)) * 16;
        const bool ok = r < rows && n0 + col < p.N;
        cp_async(st + r * NC + col, ok ? src + (long long)r * p.N + col
                                       : p.wq, 16, ok ? 16 : 0);
      }
    } else if (p.vec == 4) {
      for (int i = tid; i < kSlab * (NC / 4); i += kThreads) {
        const int r = i / (NC / 4), col = (i % (NC / 4)) * 4;
        const bool ok = r < rows && n0 + col < p.N;
        cp_async(st + r * NC + col, ok ? src + (long long)r * p.N + col
                                       : p.wq, 4, ok ? 4 : 0);
      }
    } else {
      for (int i = tid; i < kSlab * NC; i += kThreads) {
        const int r = i / NC, col = i % NC;
        st[i] = (r < rows && n0 + col < p.N)
                    ? (unsigned char)src[(long long)r * p.N + col] : 0;
      }
    }
    float* sws = reinterpret_cast<float*>(st + kSlab * NC + MT * kXPitch);
    for (int i = tid; i < NC; i += kThreads) {
      const bool ok = n0 + i < p.N;
      cp_async(sws + i, ok ? p.sw + (long long)u * p.N + n0 + i : p.sw, 4,
               ok ? 4 : 0);
    }
    int* rowg = reinterpret_cast<int*>(st + SB - 4 * kSlab);
    for (int i = tid; i < kSlab; i += kThreads) rowg[i] = ((r0 + i) % p.G) * p.S;
  };
  // job j's xq slab and window scalars from the quantize kernel
  auto issue_x = [&](int j) {
    if (j >= njobs) return;
    const int it = j / jt, rem = j - it * jt;
    const int u = ub + rem / ns, s = rem - (rem / ns) * ns;
    const int r0 = s * kSlab, rows = min(kSlab, p.g - r0);
    unsigned char* xs = ring + (j % STAGES) * SB + kSlab * NC;
    const int8_t* xsrc = p.xq + (long long)m0 * Kp + (long long)u * p.g + r0;
    if (p.xvec == 16) {
      for (int i = tid; i < MT * (kSlab / 16); i += kThreads) {
        const int m = i / (kSlab / 16), col = (i % (kSlab / 16)) * 16;
        const bool ok = m0 + m < p.M && col < rows;
        cp_async(xs + m * kXPitch + col,
                 ok ? xsrc + (long long)m * Kp + col : p.xq, 16, ok ? 16 : 0);
      }
    } else if (p.xvec == 4) {
      for (int i = tid; i < MT * (kSlab / 4); i += kThreads) {
        const int m = i / (kSlab / 4), col = (i % (kSlab / 4)) * 4;
        const bool ok = m0 + m < p.M && col < rows;
        cp_async(xs + m * kXPitch + col,
                 ok ? xsrc + (long long)m * Kp + col : p.xq, 4, ok ? 4 : 0);
      }
    } else {
      for (int i = tid; i < MT * kSlab; i += kThreads) {
        const int m = i / kSlab, col = i % kSlab;
        xs[m * kXPitch + col] = (m0 + m < p.M && col < rows)
            ? (unsigned char)xsrc[(long long)m * Kp + col] : 0;
      }
    }
    int* scal = reinterpret_cast<int*>(xs + MT * kXPitch + 4 * NC);
    for (int i = tid; i < 3 * MT; i += kThreads) {
      const int w = i / MT, m = i - w * MT;
      const bool ok = m0 + m < p.M;
      const void* base = w == 0 ? (const void*)p.sx
                       : w == 1 ? (const void*)p.xsum : (const void*)p.asum;
      const long long o = ok ? (long long)(m0 + m) * p.nw + u : 0;
      cp_async(scal + i, static_cast<const int*>(base) + o, 4, ok ? 4 : 0);
    }
  };

  // one group before the loop: the tables and the first STAGES-1 jobs'
  // weights go out first; then, once the quantize kernel's results are
  // there (programmatic dependent launch), their activation side
  for (int i = tid * 4; i < tabn; i += kThreads * 4) {
    cp_async(tb_s + i, p.tb + i, 16, 16);
    cp_async(ta_s + i, p.ta + i, 16, 16);
  }
  for (int j = 0; j < STAGES - 1; ++j) issue_w(j);
  grid_dependency_wait();
  for (int j = 0; j < STAGES - 1; ++j) issue_x(j);
  cp_commit();

  int acc[TA][NT][4];
  uint32_t wl[NWORD], wh[NWORD], bl[NWORD], bh[NWORD];  // 16-bit lanes
  int wsum[CB], bsum[CB];                               // over the window
  float part[PER];
  float total[SPLIT ? 1 : PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) part[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (SPLIT ? 1 : PER); ++i) total[i] = 0.f;
#pragma unroll
  for (int t = 0; t < TA; ++t)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][q][e] = 0;
#pragma unroll
  for (int h = 0; h < NWORD; ++h) wl[h] = wh[h] = bl[h] = bh[h] = 0u;
#pragma unroll
  for (int i = 0; i < CB; ++i) wsum[i] = bsum[i] = 0;

  for (int j = 0; j < njobs; ++j) {
    if (j == 0)
      cp_wait<0>();
    else
      cp_wait<STAGES - 2>();
    __syncthreads();
    // every warp is past job j-1: its stage takes job j + STAGES - 1
    issue_w(j + STAGES - 1);
    issue_x(j + STAGES - 1);
    cp_commit();

    const int it = j / jt, rem = j - it * jt;
    const int uu = rem / ns, s = rem - uu * ns;
    const int u = ub + uu;
    const int n0 = (blockIdx.x + it * gridDim.x) * NC;
    const int r0 = s * kSlab, rows = min(kSlab, p.g - r0);
    const unsigned char* wt = ring + (j % STAGES) * SB;
    const int8_t* xst = reinterpret_cast<const int8_t*>(wt + kSlab * NC);
    const float* sws =
        reinterpret_cast<const float*>(wt + kSlab * NC + MT * kXPitch);
    const int* rowg = reinterpret_cast<const int*>(wt + SB - 4 * kSlab);

    // counts of this slab on the tensor cores
    const int nks = (rows + 7) >> 3;
#pragma unroll 2
    for (int ks = 0; ks < nks; ++ks) {
      const int ra = ks * 8 + tig, rb = ra + 4;
      const bool va = ra < rows, vb = rb < rows;
      uint32_t wa[NWORD], wb[NWORD];
      if constexpr (CB >= 8) {
        const uint2 a2 = *reinterpret_cast<const uint2*>(wt + ra * NC + cb);
        const uint2 b2 = *reinterpret_cast<const uint2*>(wt + rb * NC + cb);
        wa[0] = a2.x; wa[NWORD - 1] = a2.y;
        wb[0] = b2.x; wb[NWORD - 1] = b2.y;
      } else if constexpr (CB == 4) {
        wa[0] = *reinterpret_cast<const uint32_t*>(wt + ra * NC + cb);
        wb[0] = *reinterpret_cast<const uint32_t*>(wt + rb * NC + cb);
      } else {
        wa[0] = *reinterpret_cast<const uint16_t*>(wt + ra * NC + cb);
        wb[0] = *reinterpret_cast<const uint16_t*>(wt + rb * NC + cb);
      }
      // u = w + 128 and b = u >> k, a byte a column; rows past the slab
      // give u = b = 0
      uint32_t ba[NWORD], bb[NWORD];
#pragma unroll
      for (int h = 0; h < NWORD; ++h) {
        const uint32_t ua = va ? (wa[h] ^ 0x80808080u) & LANES : 0u;
        const uint32_t ubv = vb ? (wb[h] ^ 0x80808080u) & LANES : 0u;
        ba[h] = (ua >> p.k) & bmask4;
        bb[h] = (ubv >> p.k) & bmask4;
        wl[h] += (ua & 0x00FF00FFu) + (ubv & 0x00FF00FFu);
        wh[h] += ((ua >> 8) & 0x00FF00FFu) + ((ubv >> 8) & 0x00FF00FFu);
        if (p.c1 != 0.f) {            // sum(b) enters center truncation only
          bl[h] += (ba[h] & 0x00FF00FFu) + (bb[h] & 0x00FF00FFu);
          bh[h] += ((ba[h] >> 8) & 0x00FF00FFu) + ((bb[h] >> 8) & 0x00FF00FFu);
        }
      }
      const int ga = rowg[ra], gb = rowg[rb];
      const uint32_t* tab_a = tb_s + ga;
      const uint32_t* tab_b = tb_s + gb;
      uint32_t af[TA][4];
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        // column cb + i is row gid (+8 if i odd) of the warp's tile i/2
        af[i >> 1][i & 1] = tab_a[(ba[i >> 2] >> (8 * (i & 3))) & 0xFFu];
        af[i >> 1][2 + (i & 1)] = tab_b[(bb[i >> 2] >> (8 * (i & 3))) & 0xFFu];
      }
      const uint32_t* xa_tab = ta_s + ga;
      const uint32_t* xb_tab = ta_s + gb;
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int8_t* xr = xst + (rbase + q * 8 + gid) * kXPitch;
        const uint32_t b0 = va ? xa_tab[(xr[ra] + 128) >> p.k] : 0u;
        const uint32_t b1 = vb ? xb_tab[(xr[rb] + 128) >> p.k] : 0u;
#pragma unroll
        for (int t = 0; t < TA; ++t) bmma(acc[t][q], af[t], b0, b1);
      }
    }

    // slab end: the column sums over the thread group's rows (each 16-bit
    // lane < 2^16 over one slab), widened; lo lanes hold columns 4h + {0,
    // 2}, hi lanes 4h + {1, 3}
#pragma unroll
    for (int h = 0; h < NWORD; ++h) {
      uint32_t v[4] = {wl[h], wh[h], bl[h], bh[h]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 1);
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 2);
      }
      wl[h] = wh[h] = bl[h] = bh[h] = 0u;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (4 * h + q < CB) {
          wsum[4 * h + q] += (int)(v[q] & 0xFFFFu);
          bsum[4 * h + q] += (int)(v[2 + q] & 0xFFFFu);
        }
        if (4 * h + 2 + q < CB) {
          wsum[4 * h + 2 + q] += (int)(v[q] >> 16);
          bsum[4 * h + 2 + q] += (int)(v[2 + q] >> 16);
        }
      }
    }

    if (s == ns - 1) {
      // window end: this thread's terms, from its registers and the stage
      const float* sxs = reinterpret_cast<const float*>(
          xst + MT * kXPitch + 4 * NC);
#pragma unroll
      for (int t = 0; t < TA; ++t)
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ci = 2 * t + (e >> 1);             // of the CB columns
            const int row = rbase + q * 8 + 2 * tig + (e & 1);
            const int i = (t * NT + q) * 4 + e;
            part[i] = __fadd_rn(part[i], window_term(
                p, acc[t][q][e], reinterpret_cast<const int*>(sxs + MT)[row],
                reinterpret_cast<const int*>(sxs + 2 * MT)[row], wsum[ci],
                bsum[ci], sxs[row], sws[cb + ci]));
            acc[t][q][e] = 0;
          }
#pragma unroll
      for (int i = 0; i < CB; ++i) wsum[i] = bsum[i] = 0;

      if constexpr (!SPLIT) {
        if ((u + 1) % p.chunk == 0 || u == p.nw - 1) {     // chunk end
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            total[i] = __fadd_rn(total[i], part[i]);
            part[i] = 0.f;
          }
        }
        if (uu == nwin - 1) {                              // tile end
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int t = i / (NT * 4), q = (i / 4) % NT, e = i % 4;
            const int n = n0 + cb + 2 * t + (e >> 1);
            const int m = m0 + rbase + q * 8 + 2 * tig + (e & 1);
            if (m < p.M && n < p.N) p.out[(long long)m * p.N + n] = total[i];
            total[i] = 0.f;
          }
        }
      } else if (uu == nwin - 1) {
        // tile end: stage this chunk's partial; the tile's last chunk to
        // finish adds all of them in chunk order -- the same sum as the
        // unsplit walk, whichever block comes last
        const long long tile = (long long)blockIdx.y * nct + n0 / NC;
        float* slots = p.stage + tile * p.nchunk * (MT * NC);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          slots[(long long)c * (MT * NC) + i * kThreads + tid] = part[i];
          part[i] = 0.f;
        }
        __syncthreads();
        if (tid == 0) {
          // acq_rel: the block's staged writes (ordered before this by the
          // barrier) are visible before the count, and the last block sees
          // every other block's before it reads them
          int done;
          asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                       : "=r"(done) : "l"(p.counters + tile) : "memory");
          last_s = done == p.nchunk - 1;
        }
        __syncthreads();
        if (last_s) {
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            float v[kMaxChunks];
#pragma unroll
            for (int r = 0; r < kMaxChunks; ++r)
              v[r] = r < p.nchunk
                         ? __ldcg(slots + (long long)r * (MT * NC)
                                  + i * kThreads + tid)
                         : 0.f;
            float tot = 0.f;
#pragma unroll
            for (int r = 0; r < kMaxChunks; ++r)
              if (r < p.nchunk) tot = __fadd_rn(tot, v[r]);
            const int t = i / (NT * 4), q = (i / 4) % NT, e = i % 4;
            const int n = n0 + cb + 2 * t + (e >> 1);
            const int m = m0 + rbase + q * 8 + 2 * tig + (e & 1);
            if (m < p.M && n < p.N) p.out[(long long)m * p.N + n] = tot;
          }
          if (tid == 0) p.counters[tile] = 0;
        }
      }
    }
  }
  cp_wait<0>();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

int rows_per_block(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : 64; }

// Split the windows over blocks only when the output tiles (of kSplitNC
// columns) alone give the card fewer blocks than SMs; either way every
// output adds the same terms in the same order.
bool split_windows(int M, int N, int nw) {
  const int chunk = (nw + kMaxChunks - 1) / kMaxChunks;
  const int nchunk = (nw + chunk - 1) / chunk;
  const long long tiles = (long long)((N + kSplitNC - 1) / kSplitNC)
                          * ((M + rows_per_block(M) - 1) / rows_per_block(M));
  return nchunk > 1 && tiles < sm_count();
}

template <int TA, int NT, int WN, int WM, bool SPLIT, int STAGES>
int launch_mvm(const Params& p, cudaStream_t st) {
  constexpr int NC = 16 * TA * WN;
  constexpr int MT = WM * NT * 8;
  static_assert(!SPLIT || NC == kSplitNC, "split tiles");
  const size_t smem =
      8 * (size_t)(p.G * p.S) + (size_t)STAGES * stage_bytes(MT, NC);
  auto kern = fused_kernel<TA, NT, WN, WM, SPLIT, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nct = (p.N + NC - 1) / NC;
  const int rt = (p.M + MT - 1) / MT;
  const int z = SPLIT ? p.nchunk : 1;
  // one wave: as many blocks as fit on the card at once; a block walks
  // the column tiles blockIdx.x, blockIdx.x + gridDim.x, ...
  int per_sm = 1;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  const int want = max(1, max(per_sm, 1) * sm_count() / (rt * z));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(nct, want), rt, z);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;                  // overlap the quantize kernel's tail
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int quantize(const Params& p, cudaStream_t st) {
  const int warps = kThreads / 32;
  const int blocks = (p.M * p.nw + warps - 1) / warps;
  quantize_kernel<T><<<blocks, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// The MVM after the quantize kernel.  Decode (M <= 16, NT 8-row tiles):
// where the windows are split, 16 columns a warp (64 a tile, many
// blocks); else 32 a warp (128 a tile, fewer instructions a weight byte).
// Prefill (M > 16): 64 rows x 64 columns a block, 16 rows a warp.
template <int NT>
int decode(const Params& p, cudaStream_t st) {
  return split_windows(p.M, p.N, p.nw)
             ? launch_mvm<1, NT, 4, 1, true, 4>(p, st)
             : launch_mvm<2, NT, 4, 1, false, 3>(p, st);
}

int prefill(const Params& p, cudaStream_t st) {
  return split_windows(p.M, p.N, p.nw)
             ? launch_mvm<4, 2, 1, 4, true, 3>(p, st)
             : launch_mvm<4, 2, 1, 4, false, 3>(p, st);
}

template <typename T>
int run(const Params& p, cudaStream_t st) {
  const int rc = quantize<T>(p, st);
  if (rc != 0) return rc;
  if (p.M <= 8) return decode<1>(p, st);
  if (p.M <= 16) return decode<2>(p, st);
  return prefill(p, st);
}

// scratch layout, 16-byte aligned pieces: xq (M, nw*g) int8, sx (M, nw)
// f32, xsum and asum (M, nw) int32, then (split only) the staged partials
// of each output tile's chunks
long long xq_bytes(int M, int nw, int g) {
  return ((long long)M * nw * g + 15) / 16 * 16;
}
long long scalar_bytes(int M, int nw) { return (12LL * M * nw + 15) / 16 * 16; }

}  // namespace

// Tile counters dscim_fused_launch needs: one per output tile where the
// windows are split over blocks, else none.
extern "C" int dscim_fused_counters(int M, int N, int nw) {
  if (M <= 0 || N <= 0 || nw <= 0 || !split_windows(M, N, nw)) return 0;
  // split only below the SM count, so the product stays small
  return ((N + kSplitNC - 1) / kSplitNC)
         * ((M + rows_per_block(M) - 1) / rows_per_block(M));
}

// Bytes of scratch dscim_fused_launch needs (-1: a shape it does not take).
extern "C" int dscim_fused_scratch_bytes(int M, int N, int nw, int g) {
  if (M <= 0 || N <= 0 || nw <= 0 || g <= 0) return -1;
  long long b = xq_bytes(M, nw, g) + scalar_bytes(M, nw);
  if (split_windows(M, N, nw)) {
    const int chunk = (nw + kMaxChunks - 1) / kMaxChunks;
    const int nchunk = (nw + chunk - 1) / chunk;
    const int MT = rows_per_block(M);
    b += 4LL * nchunk * ((M + MT - 1) / MT) * MT
         * ((N + kSplitNC - 1) / kSplitNC) * kSplitNC;
  }
  return b < (1LL << 31) ? (int)b : -1;
}

// x_dtype: 0 f32, 1 bf16, 2 f16.  vec: the widest copy (16, 4 or 1 bytes)
// that wq's base and row pitch allow.  scratch (16-byte aligned, of
// dscim_fused_scratch_bytes) holds what the quantize kernel hands the MVM
// and, where the windows are split over blocks, the staged partials;
// counters: dscim_fused_counters int32 zeros (each launch leaves them so).
// Launches the quantize kernel, which leaves xq (M, nw, g) int8 and sx
// (M, nw) f32 at the start of scratch, and the MVM on the stream.  Returns
// a cudaError_t value (0 = launched); -1: arguments the kernels do not
// take (the Python wrapper checks them first).
extern "C" int dscim_fused_launch(const void* x, int x_dtype, const void* wq,
                                  const void* sw, const void* ta,
                                  const void* tb, void* out, void* scratch,
                                  void* counters, int M, int N, int K, int nw,
                                  int g, int k, int G, int S, int vec,
                                  float scale, float c1,
                                  float wconst, float eps, float recip,
                                  void* stream) {
  if (G * S > kMaxTab || M <= 0 || N <= 0 || nw <= 0 || g <= 0 || K <= 0 ||
      K > nw * g || (long long)nw * g - K >= g)
    return -1;
  if (vec != 16 && vec != 4 && vec != 1) return -1;
  if ((M + 15) / 16 > 65535 || (long long)M * nw > (1LL << 31) - 1024)
    return -1;
  Params p;
  p.x = x;
  p.wq = static_cast<const int8_t*>(wq);
  p.sw = static_cast<const float*>(sw);
  p.ta = static_cast<const uint32_t*>(ta);
  p.tb = static_cast<const uint32_t*>(tb);
  p.out = static_cast<float*>(out);
  char* sc = static_cast<char*>(scratch);
  p.xq = reinterpret_cast<int8_t*>(sc);
  p.sx = reinterpret_cast<float*>(sc + xq_bytes(M, nw, g));
  p.xsum = reinterpret_cast<int*>(p.sx + (long long)M * nw);
  p.asum = p.xsum + (long long)M * nw;
  p.stage = reinterpret_cast<float*>(sc + xq_bytes(M, nw, g)
                                     + scalar_bytes(M, nw));
  p.counters = static_cast<int*>(counters);
  p.M = M; p.N = N; p.K = K; p.nw = nw; p.g = g; p.k = k; p.G = G; p.S = S;
  p.chunk = (nw + kMaxChunks - 1) / kMaxChunks;
  p.nchunk = (nw + p.chunk - 1) / p.chunk;
  p.vec = vec;
  p.xvec = g % 16 == 0 ? 16 : (g % 4 == 0 ? 4 : 1);
  p.scale = scale; p.c1 = c1; p.wconst = wconst; p.eps = eps; p.recip = recip;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return run<float>(p, st);
    case 1: return run<__nv_bfloat16>(p, st);
    case 2: return run<__half>(p, st);
    default: return -1;
  }
}
