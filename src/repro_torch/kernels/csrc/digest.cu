// The integrity layer's uint32 digests for Hopper (sm_90a), plain C
// interface.
//
// Replaces no Pallas kernel: the reference computes these digests in jnp
// under jax.jit (src/repro/core/kvcache.py::_csum_fold and page_checksums,
// src/repro/core/qweights.py::plane_digest and weight_plane_digests, each
// sweep compiled once in src/repro/runtime/integrity.py::_sweeps).  The
// port's eager version (core/digest.py, here the plain version) took a few
// int64 kernels a plane; this file makes each sweep one launch.
//
// A digest over n elements x_i is  sum_i (2i+1) * GOLD * mult * u32(x_i)
// mod 2^32, with u32 the reference's: int8 and int16 sign-extended, uint8
// and bool zero-extended, 16-bit floats' bits zero-extended, 32-bit values'
// bits as they are.  Products and sums mod 2^32 are exact in any order, so
// the per-thread, per-block and atomic partial sums below give the plain
// version's bits; GOLD * mult factors out of the sum and multiplies each
// block's total once.
//
// What bounds it on the card: the bytes (each element read once, an 8-byte
// digest or a 1-byte flag written; 3.35 TB/s).  An int8 element costs half
// an integer instruction: the 16 bytes of one load at first index j add
// (2j+1) * sum_k x_k + 2 * sum_k k x_k (k < 16), both sums by __dp4a over
// its four words.
//
// Entry (a), digest_planes_launch: many planes in one launch.  A device
// table holds one row a plane (pointer, elements, kind, GOLD*mult, output
// slot, first block, blocks of its slot); each block digests 64 KB of one
// plane with 16-byte loads (the scalar head and tail of a plane not aligned
// to 16 bytes apart), adds its total into a uint32 accumulator with an
// atomic, and the slot's last block (a completion counter, as the tile
// counters of the other kernels) writes the digest and leaves the
// accumulator and counter zero for the next launch.
//
// Entry (b), digest_pages_launch: one block a (layer, candidate page)
// reads that page's k and v int8 slabs and its 2 KV f32 scales in place
// from the pool, (L, P, ps, KV, HD) and (L, P, KV), multipliers 1, 3, 5, 7.
// The candidates are every page, the listed pages phys, or a refresh
// window: for slot b and j < J, logical page pos0[b] / ps + j, hit where
// its last token lies in [pos0[b], upper[b]) and below the table's width,
// at the physical page the slot's table row names
// (core/kvcache.py refresh_page_checksums).  Write mode stores the digest
// into sums (L, P) for each hit candidate; compare mode writes flags (L,
// P), the digest != sums, for every page.  No host read and no
// allocation: a CUDA graph can capture it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 64 * 1024;   // entry (a): bytes a block
constexpr uint32_t kGold = 2654435761u;

enum Kind : int { S8 = 0, U8 = 1, S16 = 2, U16 = 3, B32 = 4 };

// entry (a)'s table row; the wrapper (kernels/digest.py) writes int64s
struct Row {
  long long ptr, n, kind, gm, slot, first_block, slot_blocks, pad;
};

__device__ __forceinline__ int elem_bytes(int kind) {
  return kind <= U8 ? 1 : kind <= U16 ? 2 : 4;
}

__device__ __forceinline__ uint32_t load_u32(const unsigned char* p,
                                             int kind) {
  switch (kind) {
    case S8: return uint32_t(int32_t(*reinterpret_cast<const int8_t*>(p)));
    case U8: return *p;
    case S16:
      return uint32_t(int32_t(*reinterpret_cast<const int16_t*>(p)));
    case U16: return *reinterpret_cast<const uint16_t*>(p);
    default: return *reinterpret_cast<const uint32_t*>(p);
  }
}

// sum over the 16 bytes of v, first element index j, of u32(x_k) (2(j+k)+1)
__device__ __forceinline__ uint32_t vec_sum(uint4 v, uint32_t j, int kind) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const uint32_t base = 2u * j + 1u;
  // byte k of word q holds element 4q + k (little-endian)
  const uint32_t idx[4] = {0x03020100u, 0x07060504u, 0x0B0A0908u,
                           0x0F0E0D0Cu};
  if (kind == S8) {
    int s0 = 0, s1 = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s0 = __dp4a(int(w[q]), 0x01010101, s0);
      s1 = __dp4a(int(w[q]), int(idx[q]), s1);
    }
    return base * uint32_t(s0) + 2u * uint32_t(s1);
  }
  if (kind == U8) {
    uint32_t s0 = 0, s1 = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s0 = __dp4a(w[q], 0x01010101u, s0);
      s1 = __dp4a(w[q], idx[q], s1);
    }
    return base * s0 + 2u * s1;
  }
  uint32_t acc = 0;
  if (kind == S16 || kind == U16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t lo = w[q] & 0xFFFFu, hi = w[q] >> 16;
      if (kind == S16) {
        lo = uint32_t(int32_t(int16_t(lo)));
        hi = uint32_t(int32_t(int16_t(hi)));
      }
      acc += lo * (base + 4u * q) + hi * (base + 4u * q + 2u);
    }
    return acc;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) acc += w[q] * (base + 2u * q);
  return acc;
}

__device__ __forceinline__ uint4 load16(const uint4* p) {
  return __ldg(p);
}

// this thread's share of sum_{i0 <= i < i1} u32(x_i) (2i+1), x at `base`
__device__ uint32_t range_sum(const unsigned char* base, long long i0,
                              long long i1, int kind) {
  if (i0 >= i1) return 0u;
  const int t = threadIdx.x;
  const int eb = elem_bytes(kind);
  const int ve = 16 / eb;                          // elements a load
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(base) + i0 * eb;
  long long a = i0 + (long long)((16 - (a0 & 15)) & 15) / eb;
  if (a > i1) a = i1;
  const long long nv = (i1 - a) / ve;
  const long long b = a + nv * ve;
  const uint4* vp = reinterpret_cast<const uint4*>(base + a * eb);
  uint32_t acc = 0u;
  long long v = t;
  for (; v + 3 * kThreads < nv; v += 4 * kThreads) {
    const uint4 x0 = load16(vp + v), x1 = load16(vp + v + kThreads);
    const uint4 x2 = load16(vp + v + 2 * kThreads);
    const uint4 x3 = load16(vp + v + 3 * kThreads);
    acc += vec_sum(x0, uint32_t(a + v * ve), kind);
    acc += vec_sum(x1, uint32_t(a + (v + kThreads) * ve), kind);
    acc += vec_sum(x2, uint32_t(a + (v + 2 * kThreads) * ve), kind);
    acc += vec_sum(x3, uint32_t(a + (v + 3 * kThreads) * ve), kind);
  }
  for (; v < nv; v += kThreads)
    acc += vec_sum(load16(vp + v), uint32_t(a + v * ve), kind);
  // the head [i0, a) and the tail [b, i1): fewer than ve elements each
  if (t < a - i0) {
    const long long i = i0 + t;
    acc += load_u32(base + i * eb, kind) * (2u * uint32_t(i) + 1u);
  }
  if (t < i1 - b) {
    const long long i = b + t;
    acc += load_u32(base + i * eb, kind) * (2u * uint32_t(i) + 1u);
  }
  return acc;
}

// the block's total (mod 2^32), valid in thread 0
__device__ __forceinline__ uint32_t block_sum(uint32_t v) {
  __shared__ uint32_t warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warps[wid] = v;
  __syncthreads();
  v = 0u;
  if (wid == 0) {
    v = lane < kThreads / 32 ? warps[lane] : 0u;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
planes_kernel(const Row* __restrict__ rows, int n_rows,
              uint32_t* __restrict__ acc, unsigned int* __restrict__ done,
              long long* __restrict__ out) {
  __shared__ int row_s;
  if (threadIdx.x == 0) {          // the last row starting at or before us
    int lo = 0, hi = n_rows - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (rows[mid].first_block <= (long long)blockIdx.x) lo = mid;
      else hi = mid - 1;
    }
    row_s = lo;
  }
  __syncthreads();
  const Row r = rows[row_s];
  const int kind = int(r.kind);
  const long long per = kChunkBytes / elem_bytes(kind);
  const long long i0 = ((long long)blockIdx.x - r.first_block) * per;
  const long long i1 = i0 + per < r.n ? i0 + per : r.n;
  const uint32_t s = block_sum(range_sum(
      reinterpret_cast<const unsigned char*>(r.ptr), i0, i1, kind))
      * uint32_t(r.gm);
  if (threadIdx.x != 0) return;
  const int slot = int(r.slot);
  if (r.slot_blocks == 1) {
    out[slot] = (long long)s;
    return;
  }
  atomicAdd(acc + slot, s);
  __threadfence();
  if (atomicAdd(done + slot, 1u) == (unsigned int)(r.slot_blocks - 1)) {
    __threadfence();
    out[slot] = (long long)atomicExch(acc + slot, 0u);
    done[slot] = 0u;
  }
}

// a refresh window's candidates: slot b's logical pages from pos0[b] / ps
struct Window {
  const int* table;            // (B, mp) int32 page table
  const int* pos0;             // (B,) int32
  const int* upper;            // (B,) int32
  int mp, J, ps;
};

__global__ void __launch_bounds__(kThreads)
pages_kernel(const unsigned char* __restrict__ k,
             const unsigned char* __restrict__ v,
             const unsigned char* __restrict__ ks,
             const unsigned char* __restrict__ vs, int P, long long E,
             int KV, const long long* __restrict__ phys, Window w,
             long long* __restrict__ sums, bool* __restrict__ flags) {
  const int j = blockIdx.x, l = blockIdx.y;
  long long p = j;
  if (w.table != nullptr) {
    const int b = j / w.J;
    const int js = w.pos0[b] / w.ps + j % w.J;
    const int last = js * w.ps + w.ps - 1;
    if (js >= w.mp || last < w.pos0[b] || last >= w.upper[b]) return;
    p = w.table[(long long)b * w.mp + js];
  } else if (phys != nullptr) {
    p = phys[j];
  }
  if (p < 0 || p >= P) return;
  const long long lp = (long long)l * P + p;
  const uint32_t t =
      kGold * range_sum(k + lp * E, 0, E, S8)
      + kGold * 3u * range_sum(v + lp * E, 0, E, S8)
      + kGold * 5u * range_sum(ks + lp * KV * 4, 0, KV, B32)
      + kGold * 7u * range_sum(vs + lp * KV * 4, 0, KV, B32);
  const uint32_t s = block_sum(t);
  if (threadIdx.x != 0) return;
  if (flags != nullptr) flags[lp] = (long long)s != sums[lp];
  else sums[lp] = (long long)s;
}

}  // namespace

// Entry (a): rows (n_rows Row, device), n_blocks = the last row's
// first_block + its blocks; acc_done: 2 * n_slots zeroed uint32 (the
// accumulators, then the counters; left zero); out: n_slots int64.
extern "C" int digest_planes_launch(const void* rows, int n_rows,
                                    int n_blocks, void* acc_done,
                                    int n_slots, void* out, void* stream) {
  if (n_rows <= 0 || n_blocks <= 0 || n_slots <= 0) return -1;
  auto* acc = static_cast<uint32_t*>(acc_done);
  planes_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Row*>(rows), n_rows, acc,
      reinterpret_cast<unsigned int*>(acc + n_slots),
      static_cast<long long*>(out));
  return int(cudaGetLastError());
}

// Entry (b): the pool's k, v (L, P, E int8 a page) and scales ks, vs (L, P,
// KV f32); the n candidates: every page (phys and table null, n = P), the
// listed pages phys (n int64, device), or a refresh window (table (B, mp)
// int32, pos0 and upper (B,) int32, n = B * J); flags null: write the
// digests into sums (L, P int64), else compare with sums into flags (L, P
// bool).  A candidate page outside [0, P) is skipped.
extern "C" int digest_pages_launch(const void* k, const void* v,
                                   const void* ks, const void* vs, int L,
                                   int P, long long E, int KV,
                                   const void* phys, int n,
                                   const void* table, const void* pos0,
                                   const void* upper, int mp, int J, int ps,
                                   void* sums, void* flags, void* stream) {
  if (L <= 0 || n <= 0 || P <= 0 || E < 0 || KV < 0 || L > 65535) return -1;
  if (table != nullptr && (mp <= 0 || J <= 0 || ps <= 0)) return -1;
  const Window w{static_cast<const int*>(table),
                 static_cast<const int*>(pos0),
                 static_cast<const int*>(upper), mp, J, ps};
  pages_kernel<<<dim3(n, L), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(k),
      static_cast<const unsigned char*>(v),
      static_cast<const unsigned char*>(ks),
      static_cast<const unsigned char*>(vs), P, E, KV,
      static_cast<const long long*>(phys), w,
      static_cast<long long*>(sums), static_cast<bool*>(flags));
  return int(cudaGetLastError());
}
