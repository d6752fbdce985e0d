// Int8 paged-attention decode for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention.py::_kernel (launched by
// _paged_call, entry paged_attention_decode).  One query token per slot:
// for every (slot b, kv head g) it walks the logical pages j <= pos[b]/ps
// through page_table[b, j], dequantizes each int8 page by its per-(page,
// kv head) f32 scale, overlays the slot's bf16 tail page at
// j == pos[b]/ps, masks tokens past pos[b] with -1e30 and runs an f32
// softmax with scale HD^-0.5 for the n_rep query rows that share the head;
// the final division clamps l at 1e-30.
//
// Shapes: q (B, KV, R, HD) f32, pages (P, ps, KV, HD) int8, scales (P, KV)
// f32, tails (B, ps, KV, HD) bf16, table (B, MP) int32, pos (B,) int32 ->
// out (B, KV, R, HD) f32.
//
// What bounds it on the card: the bytes of the pages it reads (int8,
// pos+1 tokens per slot and kv head).  Design (flash-decoding, split-KV):
//  * each (slot, kv head) cuts its logical pages into runs of 32 or 64
//    tokens (64 past 512 tokens of context, whole pages); the
//    plan depends only on that slot's pos and on ps, never on B or the
//    grid, so a slot's result does not depend on the batch it shares;
//  * one block of 128 threads per (run, kv head, slot): the run's int8 K
//    and V rows (and the bf16 tail page) arrive in shared memory by 16-byte
//    cp.async copies, all in flight at once; four threads share a token's
//    dot products, each over a quarter of the head dims for every query
//    row, and the page scale multiplies the dot product once; one warp per
//    query row takes the run's max and sum across the warp and folds each
//    token's V page scale into P; for P.V, where the slot's runs are at
//    most 32 tokens, a thread takes 4 head dims of every 4th token (4-byte
//    V loads) for every row and the token groups' sums, kept where the
//    run's K bytes were, are added in group order, else a thread takes one
//    head dim of every token (faster there);
//  * the run's (m, l, acc) go to a scratch buffer, and the last block of
//    the (slot, kv head) to finish (an atomic counter, reset by that block
//    for the next launch) adds them in run order: the same order whichever
//    block comes last.  A slot with one run writes its output directly.
// A slot's bits depend on its own pos and on ps, on HD and on whether HD
// is a multiple of 16 with the page and tail bases 16-byte aligned
// (vec16: 16-byte loads and their order of the score sums, and the
// grouped P.V); never on B, MP or the other slots.
// expf (not __expf), the -1e30 mask and max(l, 1e-30) keep the reference's
// numerics.  Pages past pos are never read.  It allocates nothing and runs
// on the caller's stream; the counters must not be shared by launches on
// two streams at once.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinRun = 32;      // tokens of a split-KV run, at least
constexpr int kMaxRun = 64;      // and at most
constexpr int kRunsPerSlot = 16; // runs a slot aims at between the two
constexpr float kNegInf = -1e30f;

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

// Pages per split-KV run of a slot whose context is npages pages of ps
// tokens: a power-of-two run of kMinRun to kMaxRun tokens, the shortest
// that keeps the slot within kRunsPerSlot runs (whole pages).  It depends on nothing
// but the slot's own pos and ps.
__host__ __device__ inline int run_pages(int npages, int ps) {
  int tokens = kMinRun;
  while (tokens < kMaxRun && (long long)tokens * kRunsPerSlot < (long long)npages * ps)
    tokens *= 2;
  return tokens > ps ? tokens / ps : 1;
}

// shared-memory row pitches in bytes: 16-byte multiples, 16 bytes past the
// row so that the rows of 8 neighbouring tokens start in distinct bank
// groups
__host__ __device__ inline int kv_pitch(int HD) { return ((HD + 15) & ~15) + 16; }
__host__ __device__ inline int tail_pitch(int HD) {
  return ((2 * HD + 15) & ~15) + 16;
}

// Whether a slot whose runs are run_tokens long takes P.V in token groups
// of 4 head dims, whose sums fill pv_bytes() of shared memory.
__host__ __device__ inline bool grouped_pv(int run_tokens, int HD, int vec16) {
  return vec16 && run_tokens <= kMinRun && HD >= 4 && HD <= 4 * kThreads;
}
__host__ __device__ constexpr int pv_bytes() {
  return 4 * 4 * kThreads * (int)sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// One (run, kv head g, slot) of the walk: the block's whole work at one
// head per block; a block of gh heads runs it for each of its heads in
// turn, so every head's arithmetic is the same whatever gh.
__device__ __forceinline__ void
paged_head(const float* __restrict__ q, const int8_t* __restrict__ kp,
           const int8_t* __restrict__ vp, const float* __restrict__ ks,
           const float* __restrict__ vs, const __nv_bfloat16* __restrict__ kt,
           const __nv_bfloat16* __restrict__ vt,
           const int* __restrict__ table, const int* __restrict__ pos,
           float* __restrict__ out, float* __restrict__ part,
           int* __restrict__ counters, int KV, int R, int HD, int ps, int MP,
           int TS, int kb, int nsmax, int vec16, float scale, int g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TS: tokens of the longest run any slot may have (shared memory);
  // kb: bytes of the K rows, which the grouped P.V sums reuse
  const int KP = kv_pitch(HD);          // byte pitch of an int8 token row
  const int TP = tail_pitch(HD);        // byte pitch of a bf16 tail row
  int8_t* k8_s = reinterpret_cast<int8_t*>(smem_raw);          // [TS][KP]
  int8_t* v8_s = k8_s + kb;                                    // [TS][KP]
  __nv_bfloat16* kt_s =
      reinterpret_cast<__nv_bfloat16*>(v8_s + TS * KP);        // [ps][TP/2]
  __nv_bfloat16* vt_s = kt_s + ps * (TP / 2);                  // [ps][TP/2]
  float* q_s = reinterpret_cast<float*>(vt_s + ps * (TP / 2)); // [R][HD]
  float* p_s = q_s + R * HD;            // [R][max(TS, nsmax)]
  float* m_s = p_s + R * max(TS, nsmax);  // [R]
  float* l_s = m_s + R;                 // [R]
  const int ppm = TS > ps ? TS / ps : 1;   // pages of the longest run
  float* ksc_s = l_s + R;               // [ppm] page scales, K
  float* vsc_s = ksc_s + ppm;           // [ppm] page scales, V
  int* phys_s = reinterpret_cast<int*>(vsc_s + ppm);           // [ppm]
  // [4 * groups][HD] P.V sums of the token groups, over the K rows (which
  // P.V does not read)
  float* pv_s = reinterpret_cast<float*>(k8_s);
  __shared__ int last_s;

  const int sp = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  const int tailj = p / ps;
  const int npages = min(tailj + 1, MP);
  const int pps = run_pages(npages, ps);
  const int nsplit = (npages + pps - 1) / pps;
  if (sp >= nsplit) return;
  const int j0 = sp * pps, j1 = min(j0 + pps, npages);
  const int ntok = (j1 - j0) * ps;
  const long long bg = (long long)b * KV + g;

  for (int i = tid; i < R * HD; i += kThreads) q_s[i] = q[bg * R * HD + i];
  if (tid < j1 - j0) {
    const int j = j0 + tid;
    const int ph = j == tailj ? 0 : table[(long long)b * MP + j];
    phys_s[tid] = ph;
    ksc_s[tid] = j == tailj ? 1.f : ks[(long long)ph * KV + g];
    vsc_s[tid] = j == tailj ? 1.f : vs[(long long)ph * KV + g];
  }
  __syncthreads();

  // the run's K and V bytes (and the bf16 tail page) into shared memory:
  // 16-byte cp.async copies, all in flight at once, no registers held
  if (vec16) {
    const int cpr = HD >> 4;                         // int8 copies a row
    for (int i = tid; i < ntok * cpr; i += kThreads) {
      const int t = i / cpr, c16 = (i - t * cpr) * 16;
      const int pp = t / ps, tt = t - pp * ps;
      if (j0 + pp == tailj) continue;
      const long long o = (((long long)phys_s[pp] * ps + tt) * KV + g) * HD + c16;
      cp_async16(k8_s + t * KP + c16, kp + o);
      cp_async16(v8_s + t * KP + c16, vp + o);
    }
    if (tailj < j1) {
      const int cpt = HD >> 3;                       // bf16 copies a row
      for (int i = tid; i < ps * cpt; i += kThreads) {
        const int tt = i / cpt, c8 = (i - tt * cpt) * 8;
        const long long o = (((long long)b * ps + tt) * KV + g) * HD + c8;
        cp_async16(kt_s + tt * (TP / 2) + c8, kt + o);
        cp_async16(vt_s + tt * (TP / 2) + c8, vt + o);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (int i = tid; i < ntok * HD; i += kThreads) {
      const int t = i / HD, d = i - t * HD;
      const int pp = t / ps, tt = t - pp * ps;
      if (j0 + pp == tailj) {
        const long long o = (((long long)b * ps + tt) * KV + g) * HD + d;
        kt_s[tt * (TP / 2) + d] = kt[o];
        vt_s[tt * (TP / 2) + d] = vt[o];
      } else {
        const long long o = (((long long)phys_s[pp] * ps + tt) * KV + g) * HD + d;
        k8_s[t * KP + d] = kp[o];
        v8_s[t * KP + d] = vp[o];
      }
    }
  }
  __syncthreads();

  // scores: four threads per token, each over a quarter of the head dims
  // for up to four query rows at once, added across the quarter lanes; an
  // int8 row's page scale multiplies its dot product once
  const int tok0 = j0 * ps;
  for (int t0 = 0; t0 < ntok; t0 += kThreads / 4) {
    const int t = t0 + (tid >> 2), qtr = tid & 3;
    const bool tv = t < ntok;
    const int pp = tv ? t / ps : 0, tt = t - pp * ps;
    const bool tail = j0 + pp == tailj;
    for (int rc = 0; rc < R; rc += 4) {
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      if (tv && !tail && vec16) {
        const int8_t* kr = k8_s + t * KP;
        for (int d = 16 * qtr; d < HD; d += 64) {
          const int4 w = *reinterpret_cast<const int4*>(kr + d);
          const int8_t* k16 = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (rc + e >= R) continue;
            const float* qr = q_s + (rc + e) * HD + d;
#pragma unroll
            for (int v = 0; v < 16; v += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qr + v);
              dot[e] += qq.x * (float)k16[v] + qq.y * (float)k16[v + 1]
                        + qq.z * (float)k16[v + 2] + qq.w * (float)k16[v + 3];
            }
          }
        }
      } else if (tv) {
        for (int d = qtr; d < HD; d += 4) {
          const float kv = tail ? __bfloat162float(kt_s[tt * (TP / 2) + d])
                                : (float)k8_s[t * KP + d];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (rc + e < R) dot[e] += q_s[(rc + e) * HD + d] * kv;
        }
      }
      const float sc = tail ? 1.f : ksc_s[pp];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dot[e] += __shfl_xor_sync(0xffffffffu, dot[e], 1);
        dot[e] += __shfl_xor_sync(0xffffffffu, dot[e], 2);
        if (qtr == 0 && tv && rc + e < R)
          p_s[(rc + e) * TS + t] =
              (tok0 + t <= p) ? dot[e] * sc * scale : kNegInf;
      }
    }
  }
  __syncthreads();

  // the run's softmax statistics: a warp per query row; P keeps e^(s-m)
  // times its token's V page scale (the bf16 tail has none) for P.V
  for (int r = warp; r < R; r += kThreads / 32) {
    float mx = kNegInf;
    for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, p_s[r * TS + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < ntok; t += 32) {
      const float e = expf(p_s[r * TS + t] - mx);
      const int pp = t / ps;
      p_s[r * TS + t] = j0 + pp == tailj ? e : e * vsc_s[pp];
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  __syncthreads();

  // P.V (P carries the V page scales)
  float* pacc = part;                                   // [B*KV][nsmax][R][HD]
  float* pml = part + (long long)gridDim.z * KV * nsmax * R * HD;  // [..][R][2]
  const long long prow = (bg * nsmax + sp) * R;         // rows of this run
  // a slot whose runs are at most kMinRun tokens (measured faster there): a
  // thread per 4 head dims and token group (every ng-th token), for up to
  // four query rows at once, 4-byte V loads; the groups' sums are then
  // added in group order
  const int tail_t0 = tailj < j1 ? (tailj - j0) * ps : ntok;
  const int nd4 = HD >> 2, ng = nd4 > 0 ? kThreads / nd4 : 0;
  if (grouped_pv(pps * ps, HD, vec16)) {
    const int d4 = tid % nd4, tg = tid / nd4;
    for (int rc = 0; rc < R; rc += 4) {
      float a[4][4] = {};
      if (tg < ng) {
        for (int t = tg; t < ntok; t += ng) {
          float4 v;
          if (t >= tail_t0) {
            const __nv_bfloat16* vr = vt_s + (t - tail_t0) * (TP / 2) + 4 * d4;
            v = make_float4(__bfloat162float(vr[0]), __bfloat162float(vr[1]),
                            __bfloat162float(vr[2]), __bfloat162float(vr[3]));
          } else {
            const char4 c = *reinterpret_cast<const char4*>(v8_s + t * KP + 4 * d4);
            v = make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (rc + e < R) {
              const float pr = p_s[(rc + e) * TS + t];
              a[e][0] += pr * v.x;
              a[e][1] += pr * v.y;
              a[e][2] += pr * v.z;
              a[e][3] += pr * v.w;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (rc + e < R)
            *reinterpret_cast<float4*>(pv_s + (tg * 4 + e) * HD + 4 * d4) =
                make_float4(a[e][0], a[e][1], a[e][2], a[e][3]);
      }
      __syncthreads();
      for (int i = tid; i < 4 * HD; i += kThreads) {
        const int e = i / HD, d = i - e * HD;
        if (rc + e >= R) continue;
        float acc = 0.f;
        for (int g2 = 0; g2 < ng; ++g2) acc += pv_s[(g2 * 4 + e) * HD + d];
        const int o = (rc + e) * HD + d;
        if (nsplit == 1)
          out[bg * R * HD + o] = acc / fmaxf(l_s[rc + e], 1e-30f);
        else
          pacc[prow * HD + o] = acc;
      }
      __syncthreads();
    }
  } else {
    // longer runs: a thread per head dim, for up to four query rows at
    // once, each V element converted once; even and odd tokens in
    // separate sums
    for (int d = tid; d < HD; d += kThreads) {
      for (int rc = 0; rc < R; rc += 4) {
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
        for (int pp = 0; pp < j1 - j0; ++pp) {
          const int tb = pp * ps;
          const bool tail = j0 + pp == tailj;
          for (int tt = 0; tt < ps; tt += 2) {
            const int t = tb + tt;
            const float v0 = tail ? __bfloat162float(vt_s[tt * (TP / 2) + d])
                                  : (float)v8_s[t * KP + d];
            const bool two = tt + 1 < ps;
            const float v1 = !two ? 0.f
                : tail ? __bfloat162float(vt_s[(tt + 1) * (TP / 2) + d])
                       : (float)v8_s[(t + 1) * KP + d];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (rc + e < R) {
                a0[e] += p_s[(rc + e) * TS + t] * v0;
                if (two) a1[e] += p_s[(rc + e) * TS + t + 1] * v1;
              }
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (rc + e >= R) continue;
          const float acc = a0[e] + a1[e];
          const int i = (rc + e) * HD + d;
          if (nsplit == 1)
            out[bg * R * HD + i] = acc / fmaxf(l_s[rc + e], 1e-30f);
          else
            pacc[prow * HD + i] = acc;
        }
      }
    }
  }
  if (nsplit == 1) return;
  if (tid < R) {
    pml[(prow + tid) * 2] = m_s[tid];
    pml[(prow + tid) * 2 + 1] = l_s[tid];
  }
  __syncthreads();
  if (tid == 0) {
    // acq_rel: this run's partial (ordered before by the barrier) is
    // visible before the count, and the last run sees every other's
    int done;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(done) : "l"(counters + bg) : "memory");
    last_s = done == nsplit - 1;
  }
  __syncthreads();
  if (!last_s) return;

  // last run of this (slot, kv head): combine the runs.  A warp per row
  // takes the max and the run weights (a fixed lane per run, so a fixed
  // order), then a thread per (row, 4 dims) adds the runs in run order.
  float* w_s = p_s;                       // [R][nsplit], reuses p_s
  for (int r = warp; r < R; r += kThreads / 32) {
    float mx = kNegInf;
    for (int s = lane; s < nsplit; s += 32)
      mx = fmaxf(mx, __ldcg(pml + ((bg * nsmax + s) * R + r) * 2));
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float* ml = pml + ((bg * nsmax + s) * R + r) * 2;
      const float al = expf(__ldcg(ml) - mx);
      w_s[r * nsplit + s] = al;
      l += __ldcg(ml + 1) * al;
    }
    l = warp_sum(l);
    if (lane == 0) l_s[r] = l;
  }
  __syncthreads();
  const long long step = (long long)R * HD;             // between runs
  if ((HD & 3) == 0) {
    for (int i = tid; i < R * HD / 4; i += kThreads) {
      const int r = (4 * i) / HD;
      const float4* col = reinterpret_cast<const float4*>(
          pacc + bg * nsmax * step) + i;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
      for (int s = 0; s < nsplit; ++s) {
        const float4 v = __ldcg(col + s * (step / 4));
        const float w = w_s[r * nsplit + s];
        acc.x += v.x * w;
        acc.y += v.y * w;
        acc.z += v.z * w;
        acc.w += v.w * w;
      }
      const float inv = fmaxf(l_s[r], 1e-30f);
      reinterpret_cast<float4*>(out + bg * R * HD)[i] = make_float4(
          acc.x / inv, acc.y / inv, acc.z / inv, acc.w / inv);
    }
  } else {
    for (int i = tid; i < R * HD; i += kThreads) {
      const int r = i / HD;
      float acc = 0.f;
      for (int s = 0; s < nsplit; ++s)
        acc += __ldcg(pacc + bg * nsmax * step + s * step + i) *
               w_s[r * nsplit + s];
      out[bg * R * HD + i] = acc / fmaxf(l_s[r], 1e-30f);
    }
  }
  if (tid == 0) counters[bg] = 0;
}

// gh kv heads a block (blockIdx.y * gh ..), one after another.
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q, const int8_t* __restrict__ kp,
                   const int8_t* __restrict__ vp, const float* __restrict__ ks,
                   const float* __restrict__ vs,
                   const __nv_bfloat16* __restrict__ kt,
                   const __nv_bfloat16* __restrict__ vt,
                   const int* __restrict__ table, const int* __restrict__ pos,
                   float* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ counters, int KV, int R, int HD, int ps,
                   int MP, int TS, int kb, int nsmax, int vec16, float scale,
                   int gh) {
  for (int i = 0; i < gh; ++i) {
    paged_head(q, kp, vp, ks, vs, kt, vt, table, pos, out, part, counters,
               KV, R, HD, ps, MP, TS, kb, nsmax, vec16, scale,
               blockIdx.y * gh + i);
    __syncthreads();                 // the next head reuses shared memory
  }
}

}  // namespace

// The most split-KV runs any slot of a table with MP pages of ps tokens
// can have (the grid's run axis and the scratch's run count).
extern "C" int paged_attention_max_runs(int ps, int MP) {
  int most = 1;
  for (int n = 1; n <= MP; ++n) {
    const int pps = run_pages(n, ps);
    most = max(most, (n + pps - 1) / pps);
  }
  return most;
}

// part: f32 scratch of B*KV*paged_attention_max_runs(ps, MP)*R*(HD+2)
// (each run's acc rows,
// then each run's (m, l)); out and part 16-byte aligned; counters: B*KV int32,
// zero before the first launch (each launch leaves them zero).  vec16: HD
// is a multiple of 16 and the page and tail bases are 16-byte aligned.
// gh: kv heads a block takes, a divisor of KV (1 is the rule; every gh
// gives the same bits, kernels/autotune.py).
// Returns a cudaError_t value (0 = launched), -1 for arguments the kernel
// does not take.
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* kt,
                                      const void* vt, const void* table,
                                      const void* pos, void* out, void* part,
                                      void* counters, int B, int KV, int R,
                                      int HD, int ps, int MP, int vec16,
                                      int gh, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || R <= 0 || HD <= 0 || ps <= 0 || MP <= 0) return -1;
  if (gh <= 0 || KV % gh != 0) return -1;
  if (KV > 65535 || B > 65535) return -1;
  const int nsmax = paged_attention_max_runs(ps, MP);
  const int TS = run_pages(MP, ps) * ps;   // the longest run: at MP pages
  // the K rows' bytes, at least the grouped P.V's sums where the shortest
  // run (one slot page) takes it
  int kb = TS * kv_pitch(HD);
  if (grouped_pv(run_pages(1, ps) * ps, HD, vec16) && kb < pv_bytes())
    kb = pv_bytes();
  const size_t smem = (size_t)kb + (size_t)TS * kv_pitch(HD)
      + 2 * (size_t)ps * tail_pitch(HD)
      + sizeof(float) * ((size_t)R * HD
                         + (size_t)R * (TS > nsmax ? TS : nsmax) + 2 * R
                         + 3 * (size_t)(TS / ps > 0 ? TS / ps : 1));
  if (smem > 227 * 1024) return -1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nsmax, KV / gh, B);
  paged_split_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const __nv_bfloat16*>(kt),
      static_cast<const __nv_bfloat16*>(vt), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), KV, R, HD, ps,
      MP, TS, kb, nsmax, vec16, scale, gh);
  return static_cast<int>(cudaGetLastError());
}
