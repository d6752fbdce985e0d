// DS-CIM OR-accumulated counts for Hopper (sm_90a) on the b1 tensor cores,
// plain C interface.
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
// the all-L bit expansion is not carried over.  The wrapper hands over
// per-block bit-mask tables of W uint32 words (W = 1, 2, 4 or 8): bit p of
// ta[g][a][j] is set when point 32j+p of block g has lu < a, and likewise
// tb[g][b][j] for lv < b.  Then
//
//   C[m,n] = sum_h sum_{j<W} popc(ta[h%G][a[m,h]][j] & tb[h%G][b[h,n]][j]),
//
// a binary matrix product over K*32*W bits, which the tensor cores run as
// mma.sync m16n8k256 .b1 .and.popc with s32 accumulators.  A k256 step
// takes 8/W K-rows of W words: its word slot s (bits 32s .. 32s+31) holds
// word s%W of K-row (8/W)*step + s/W.  Counts are exact integers, written
// as f32 as in the reference.
//
// What bounds it on the card: not the products (at M=256, K=1024, N=3072,
// W=1 about 5 us of b1 mma.sync on the whole card) but building their
// operands, one table lookup for each int8 byte a tile reads, and the
// shared-memory traffic of the fragments.  (The first design, a popcount
// per (row, column, K-row, word) on the CUDA cores, sat at the popcount
// rate: about 0.26 ms for that shape.)  Design:
//  * weight columns sit on the mma's 16-row side, activation rows on its
//    8 side, so decode (M <= 8) pads only the small side; a block owns
//    128 columns x 8 rows (4 warps) up to M = 8, else 256 x 128 (16 warps)
//    where its shared memory holds the tables (all but k = 3 with 8-word
//    masks, which stay on the 8-row tile);
//  * int8 slabs of four k256 steps (32/W K-rows) of x and w stream through
//    a 3-stage cp.async ring (16-byte copies where the pitch allows);
//  * each slab's bytes become b1 fragments once per block, one lookup in
//    the block's tables a byte, stored in fragment order (a uint4 or uint2
//    a lane) in a double-buffered mask area; every warp's products then
//    read a fragment with one 16- or 8-byte load.  Thread group gid builds
//    the neighbouring columns 2gid, 2gid+1 of an m16 tile as its rows gid,
//    gid+8, so its weight bytes are one 16-bit load;
//  * a one-wave grid whose blocks walk (tile, K-slice) items, so a block
//    loads the tables (2*G*S*W*4 bytes) once for all its items;
//  * where the output tiles leave block slots of the card idle, K is cut
//    into slices of at least two slabs, and the slices add their partial
//    counts to the output with f32 atomics (float2, Hopper's vector form).
//    A small kernel zeroes the output first; the count kernel starts
//    beside it (programmatic dependent launch) and waits for it only
//    before its first add.  Every partial and sum is an integer below
//    2^24 (the entry refuses K*32*W >= 2^24), so the adds are exact in any
//    order and every plan gives the same bits.  (Int32 partials in scratch,
//    converted by each tile's last slice behind a fence and a counter,
//    were slower; so is a memset in place of the zero kernel.)
// No padding: ragged M/N/K edges are masked (K-rows past K give zero
// masks).  It allocates nothing and runs on the caller's stream.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 4;          // k256 steps a slab
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kMinSlabs = 2;       // slabs a K-slice holds at least
constexpr int kMaxSmem = 232448;   // H100: 227 KB per block

struct Params {
  const int8_t* x;
  const int8_t* w;
  const uint32_t* ta;
  const uint32_t* tb;
  float* out;
  int M, K, N, k, G, S, W, lw, ls;   // ls = log2 S = 8 - k
  int R;             // K-rows a slab: 8 * kSteps / W
  int ns;            // slabs a tile
  int ntn;           // column tiles
  int split, items;
  int lvw, lvx, vt;  // log2 copy widths of w and x; tables' (bytes)
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

__device__ __forceinline__ void bmma(int (&c)[4], const uint4& a, uint32_t b0,
                                     uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// A block's walk over the slabs of its items: the item, the slab s of the
// item's tile, the end of the item's K-slice and the tile's first column
// and row.  Item i is slice i % split of tile i / split; slice c of a tile
// holds slabs [c*ns/split, (c+1)*ns/split).
template <int BN, int BM>
struct Walk {
  int item, s, end, n0, m0;

  __device__ __forceinline__ void to(const Params& p, int i) {
    item = i;
    if (i < p.items) {
      const int tile = i / p.split, c = i - tile * p.split;
      s = (int)((long long)c * p.ns / p.split);
      end = (int)((long long)(c + 1) * p.ns / p.split);
      n0 = (tile % p.ntn) * BN;
      m0 = (tile / p.ntn) * BM;
    }
  }
  __device__ __forceinline__ void next(const Params& p) {
    if (item < p.items && ++s == end) to(p, item + gridDim.x);
  }
};

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// Warp layout: WN warps across the BN = 16*TA*WN columns (TA m16 tiles
// each), WM across the BM = 8*NT*WM rows (NT n8 tiles each).  LW: log2 W
// fixed at compile time (0: the calibrated presets' one-word masks), or -1
// to take it from p.
template <int TA, int NT, int WN, int WM, int LW>
__global__ void __launch_bounds__(32 * WN * WM) counts_kernel(const Params p) {
  constexpr int kThreads = 32 * WN * WM;
  constexpr int BN = 16 * TA * WN;
  constexpr int BM = 8 * NT * WM;
  constexpr int TT = BN / 16, NQ = BM / 8;   // m16 / n8 tiles a block
  constexpr int kLogBN = ilog2(BN), kLogBM = ilog2(BM);
  static_assert(BN == 1 << kLogBN && BM == 1 << kLogBM, "powers of two");
  constexpr int WP = BN + 16;                // weight slab pitch, bytes
  constexpr int AU = kSteps * TT * 32;       // A fragments a slab (uint4)
  constexpr int BU = kSteps * NQ * 32;       // B fragments a slab (uint2)
  extern __shared__ __align__(16) unsigned char smem[];
  const int tabn = p.G * p.S * p.W;
  uint32_t* ta_s = reinterpret_cast<uint32_t*>(smem);
  uint32_t* tb_s = ta_s + tabn;
  uint4* amask = reinterpret_cast<uint4*>(tb_s + tabn);        // [2][AU]
  uint2* bmask = reinterpret_cast<uint2*>(amask + 2 * AU);     // [2][BU]
  unsigned char* ring = reinterpret_cast<unsigned char*>(bmask + 2 * BU);
  using W_ = Walk<BN, BM>;
  const int lw = LW >= 0 ? LW : p.lw;        // log2 words a K-row's mask
  const int R = (8 * kSteps) >> lw;          // K-rows a slab
  const int XP = R + 16;                     // activation slab pitch
  const int SB = R * WP + BM * XP;           // bytes a ring stage

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = warp % WN, wm = warp / WN;
  const int rps = 8 >> lw;                   // K-rows a k256 step
  const int gmask = p.G - 1;                 // G = 4^k, a power of two
  const int lsw = p.ls + lw;                 // log2 words a block's table

  // the slab at wk (R K-rows of w's BN columns, x's BM rows) into ring
  // stage `stage`, zero-filled past every edge
  auto issue = [&](const W_& wk, int stage) {
    if (wk.item >= p.items) return;
    const int n0 = wk.n0, m0 = wk.m0, h0 = wk.s * R;
    unsigned char* ws = ring + stage * SB;
    const int8_t* wsrc = p.w + (long long)h0 * p.N + n0;
    const int lw_row = kLogBN - p.lvw;      // log2 copies a weight row
    for (int i = tid; i < R << lw_row; i += kThreads) {
      const int r = i >> lw_row, col = (i & ((1 << lw_row) - 1)) << p.lvw;
      const bool ok = h0 + r < p.K && n0 + col < p.N;
      const int8_t* src = wsrc + (long long)r * p.N + col;
      if (p.lvw == 0)
        ws[r * WP + col] = ok ? (unsigned char)*src : 0;
      else
        cp_async(ws + r * WP + col, ok ? src : p.w, 1 << p.lvw,
                 ok ? 1 << p.lvw : 0);
    }
    unsigned char* xs = ws + R * WP;
    const int8_t* xsrc = p.x + (long long)m0 * p.K + h0;
    const int lx_row = ilog2(8 * kSteps) - lw - p.lvx;   // log2 copies a row
    for (int i = tid; i < BM << lx_row; i += kThreads) {
      const int m = i >> lx_row, col = (i & ((1 << lx_row) - 1)) << p.lvx;
      const bool ok = m0 + m < p.M && h0 + col < p.K;
      const int8_t* src = xsrc + (long long)m * p.K + col;
      if (p.lvx == 0)
        xs[m * XP + col] = ok ? (unsigned char)*src : 0;
      else
        cp_async(xs + m * XP + col, ok ? src : p.x, 1 << p.lvx,
                 ok ? 1 << p.lvx : 0);
    }
  };

  // step ks's b1 fragments of the slab at wk (ring stage `stage`) into
  // mask buffer `buf`; K-rows past K give zero masks
  auto build = [&](const W_& wk, int stage, int buf, int ks) {
    const int h0 = wk.s * R;
    const unsigned char* ws = ring + stage * SB;
    const unsigned char* xs = ws + R * WP;
    uint4* am = amask + buf * AU + ks * (TT * 32);
    uint2* bm = bmask + buf * BU + ks * (NQ * 32);
    // A (weights): lane (gid, tig) of m16 tile t holds slots tig and tig+4
    // of columns t*16 + 2gid (row gid) and + 1 (row gid+8)
#pragma unroll
    for (int i = 0; i < (TT * 32 + kThreads - 1) / kThreads; ++i) {
      const int v = tid + i * kThreads;
      if ((TT * 32) % kThreads != 0 && v >= TT * 32) break;
      const int t = v >> 5;
      uint32_t r[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int sl = tig + 4 * half;
        const int rr = ks * rps + (sl >> lw);
        const int h = h0 + rr;
        uint32_t v0 = 0u, v1 = 0u;
        if (h < p.K) {
          const uint32_t two = *reinterpret_cast<const uint16_t*>(
              ws + rr * WP + t * 16 + 2 * gid);
          const uint32_t* tab =
              tb_s + ((h & gmask) << lsw) + (sl & ((1 << lw) - 1));
          v0 = tab[(((two & 0xFFu) ^ 0x80u) >> p.k) << lw];
          v1 = tab[(((two >> 8) ^ 0x80u) >> p.k) << lw];
        }
        r[2 * half] = v0;
        r[2 * half + 1] = v1;
      }
      am[v] = make_uint4(r[0], r[1], r[2], r[3]);
    }
    // B (activations): lane (gid, tig) of n8 tile q holds slots tig and
    // tig+4 of row q*8 + gid
#pragma unroll
    for (int i = 0; i < (NQ * 32 + kThreads - 1) / kThreads; ++i) {
      const int v = tid + i * kThreads;
      if ((NQ * 32) % kThreads != 0 && v >= NQ * 32) break;
      const unsigned char* xr = xs + ((v >> 5) * 8 + gid) * XP;
      uint32_t b[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int sl = tig + 4 * half;
        const int rr = ks * rps + (sl >> lw);
        const int h = h0 + rr;
        b[half] = h < p.K
            ? ta_s[((h & gmask) << lsw) + (((xr[rr] ^ 0x80u) >> p.k) << lw)
                   + (sl & ((1 << lw) - 1))]
            : 0u;
      }
      bm[v] = make_uint2(b[0], b[1]);
    }
  };

  int acc[TA][NT][4];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // step ks's products of mask buffer `buf`
  auto products = [&](int buf, int ks) {
    const uint4* am = amask + buf * AU + ks * (TT * 32);
    const uint2* bm = bmask + buf * BU + ks * (NQ * 32);
    uint4 a[TA];
#pragma unroll
    for (int i = 0; i < TA; ++i) a[i] = am[(wn * TA + i) * 32 + lane];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint2 b = bm[(wm * NT + j) * 32 + lane];
#pragma unroll
      for (int i = 0; i < TA; ++i) bmma(acc[i][j], a[i], b.x, b.y);
    }
  };

  // acc element e of (i, j): column n0 + (wn*TA + i)*16 + 2gid + (e>>1)
  // (m16 row gid + 8*(e>>1)), row m0 + (wm*NT + j)*8 + 2tig + (e&1)
  auto epilogue = [&](int n0, int m0) {
    if (p.split == 1) {
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + (wn * TA + i) * 16 + 2 * gid;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + (wm * NT + j) * 8 + 2 * tig + e;
            if (m >= p.M || n >= p.N) continue;
            float* o = p.out + (long long)m * p.N + n;
            const float lo = (float)acc[i][j][e], hi = (float)acc[i][j][2 + e];
            if (n + 1 < p.N && (p.N & 1) == 0) {
              *reinterpret_cast<float2*>(o) = make_float2(lo, hi);
            } else {
              o[0] = lo;
              if (n + 1 < p.N) o[1] = hi;
            }
          }
        }
    } else {
      // the slice's partials, added to the zeroed output in f32: exact in
      // any order, every partial and sum being an integer below 2^24; the
      // zero kernel ahead on the stream has finished (a no-op unless this
      // launch depends on it)
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + (wn * TA + i) * 16 + 2 * gid;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + (wm * NT + j) * 8 + 2 * tig + e;
            const int lo = acc[i][j][e], hi = acc[i][j][2 + e];
            if (m >= p.M || n >= p.N || (lo | hi) == 0) continue;
            float* o = p.out + (long long)m * p.N + n;
            if (n + 1 < p.N && (p.N & 1) == 0) {
              atomicAdd(reinterpret_cast<float2*>(o),
                        make_float2((float)lo, (float)hi));
            } else {
              atomicAdd(o, (float)lo);
              if (n + 1 < p.N) atomicAdd(o + 1, (float)hi);
            }
          }
        }
    }
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  };

  // the tables go out with the first slab, in one group
  if (p.vt == 16) {
    for (int i = tid * 4; i < tabn; i += kThreads * 4) {
      cp_async(ta_s + i, p.ta + i, 16, 16);
      cp_async(tb_s + i, p.tb + i, 16, 16);
    }
  } else {
    for (int i = tid; i < tabn; i += kThreads) {
      cp_async(ta_s + i, p.ta + i, 4, 4);
      cp_async(tb_s + i, p.tb + i, 4, 4);
    }
  }
  W_ iw, bw;                   // the next slab to issue, the one to build
  iw.to(p, blockIdx.x);
  bw = iw;
  for (int st = 0; st < kStages - 1; ++st) {
    issue(iw, st);
    iw.next(p);
    cp_commit();
  }

  // slab c: built into mask buffer c&1 in iteration c, multiplied in
  // iteration c+1 (so one barrier a slab separates build and products),
  // step by step, each step's products beside the next slab's lookups
  int c = 0;
  W_ prev = bw;                // slab c-1's place
  bool ended = false;          // slab c-1 was the last of its item
  for (; bw.item < p.items; ++c) {
    cp_wait<kStages - 2>();
    __syncthreads();
    // every warp is past build(c-1): its stage takes slab c + kStages-1
    issue(iw, (c + kStages - 1) % kStages);
    iw.next(p);
    cp_commit();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (c > 0) products((c - 1) & 1, ks);
      build(bw, c % kStages, c & 1, ks);
    }
    if (c > 0 && ended) epilogue(prev.n0, prev.m0);
    prev = bw;
    bw.next(p);
    ended = bw.item != prev.item;
  }
  if (c > 0) {
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) products((c - 1) & 1, ks);
    epilogue(prev.n0, prev.m0);
  }
  cp_wait<0>();
}

// The output's zeros where K is split; lets the count kernel start at once.
__global__ void zero_kernel(float* out, long long n) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += gridDim.x * 256LL)
    out[i] = 0.f;
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

// Dynamic shared memory of a BN x BM block: the tables, the two mask
// buffers and the ring.
size_t smem_bytes(const Params& p, int BN, int BM) {
  return 8 * (size_t)p.G * p.S * p.W + 2 * (size_t)kSteps * 32 * (BN + BM)
         + (size_t)kStages * (p.R * (BN + 16) + BM * (p.R + 16));
}

// Plans a call of one instance: shared memory, tiles, the K split and the
// one-wave grid.  K is split only where the tiles alone fill fewer block
// slots than the card has, into slices of at least kMinSlabs slabs.
template <int TA, int NT, int WN, int WM, int LW>
int plan(Params& p, size_t& smem, int& grid) {
  constexpr int BN = 16 * TA * WN;
  constexpr int BM = 8 * NT * WM;
  smem = smem_bytes(p, BN, BM);
  if (smem > (size_t)kMaxSmem) return -1;
  auto kern = counts_kernel<TA, NT, WN, WM, LW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    32 * WN * WM, smem);
  if (e != cudaSuccess) return (int)e;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  p.ntn = (p.N + BN - 1) / BN;
  const long long tiles = (long long)p.ntn * ((p.M + BM - 1) / BM);
  p.ns = (p.K + p.R - 1) / p.R;
  long long split = 1;
  if (tiles < slots) {
    split = slots / tiles;
    if (split > p.ns / kMinSlabs) split = p.ns / kMinSlabs;
    if (split < 1) split = 1;
  }
  if (tiles * split > INT_MAX / 2) return -1;
  p.split = (int)split;
  p.items = (int)(tiles * split);
  grid = (int)(p.items < slots ? p.items : slots);
  return 0;
}

// Launches after a zero kernel for the output where K is split (the
// slices add into it)
template <int TA, int NT, int WN, int WM, int LW>
int launch(Params p, cudaStream_t st) {
  size_t smem = 0;
  int grid = 0;
  const int rc = plan<TA, NT, WN, WM, LW>(p, smem, grid);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(32 * WN * WM, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (p.split > 1) {
    // zero the output; the counts start beside it (programmatic dependent
    // launch) and wait for it before their first add
    const long long n = (long long)p.M * p.N;
    const long long blocks = (n + 1023) / 1024;
    zero_kernel<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, st>>>(p.out,
                                                                      n);
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t ze = cudaGetLastError();
    if (ze != cudaSuccess) return (int)ze;
  }
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, counts_kernel<TA, NT, WN, WM, LW>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Up to M = 8, and wherever the wide tile's shared memory does not hold
// the tables: 128 columns x 8 rows (one n8 tile) a block of 4 warps;
// else 256 x 128, 16 warps of 64 x 32: the wide tile halves the
// activation lookups of a 128 x 128 one, and 16 warps of 128 registers
// hide the lookups' latency better than four of 64 x 64 (over 200
// registers)
template <int LW>
int run_rows(const Params& p, cudaStream_t st) {
  if (p.M <= 8 || smem_bytes(p, 256, 128) > (size_t)kMaxSmem)
    return launch<2, 1, 4, 1, LW>(p, st);
  return launch<4, 4, 4, 4, LW>(p, st);
}

int run(const Params& p, cudaStream_t st) {
  return p.W == 1 ? run_rows<0>(p, st) : run_rows<-1>(p, st);
}

int setup(Params& p, int M, int K, int N, int k, int G, int S, int W) {
  if (M <= 0 || N <= 0 || K <= 0 || k < 0 || k > 7 || G <= 0 ||
      (G & (G - 1)) != 0 || S != (256 >> k))
    return -1;
  int lw;
  switch (W) {
    case 1: lw = 0; break;
    case 2: lw = 1; break;
    case 4: lw = 2; break;
    case 8: lw = 3; break;
    default: return -1;
  }
  if ((long long)K * 32 * W >= (1LL << 24)) return -1;   // exact in f32
  p.M = M; p.K = K; p.N = N; p.k = k; p.G = G; p.S = S; p.W = W; p.lw = lw;
  p.ls = 8 - k;
  p.R = (8 * kSteps) >> lw;
  return 0;
}

}  // namespace

// Returns a cudaError_t value (0 = launched).  -1: arguments the kernel
// does not take (checked again here; the Python wrapper checks first).
extern "C" int dscim_counts_launch(const void* x, const void* w,
                                   const void* ta, const void* tb, void* out,
                                   int M, int K, int N, int k, int G, int S,
                                   int W, void* stream) {
  Params p = {};
  if (setup(p, M, K, N, k, G, S, W) != 0) return -1;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.ta = static_cast<const uint32_t*>(ta);
  p.tb = static_cast<const uint32_t*>(tb);
  p.out = static_cast<float*>(out);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  p.lvw = (N % 16 == 0 && wa % 16 == 0) ? 4 : (N % 4 == 0 && wa % 4 == 0) ? 2 : 0;
  p.lvx = (K % 16 == 0 && p.R % 16 == 0 && xa % 16 == 0) ? 4
          : (K % 4 == 0 && p.R % 4 == 0 && xa % 4 == 0) ? 2 : 0;
  p.vt = ((reinterpret_cast<uintptr_t>(ta) | reinterpret_cast<uintptr_t>(tb))
          % 16 == 0) ? 16 : 4;
  return run(p, static_cast<cudaStream_t>(stream));
}
