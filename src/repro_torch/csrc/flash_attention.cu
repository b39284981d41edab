// Flash attention forward: O = softmax(mask(softcap(Q K^T * scale))) V per
// head, causal, with an optional sliding window (kind 1) or chunk (kind 2),
// grouped-query heads, float32 or bf16 in and out, float32 arithmetic.
//
// Replaces: repro/kernels/flash_attention/flash.py::flash_attention_pallas
// (body _flash_kernel). It computes what that kernel computes, with the
// same finite sentinel and the same order of operations per score:
//   1. s = (q . k) * scale;
//   2. if cap > 0: s = cap * tanh(s / max(cap, 1e-6));
//   3. masked to -2^30 unless q_pos >= k_pos, and q_pos - k_pos < window
//      (kind 1) or q_pos / chunk == k_pos / chunk (kind 2);
// then the online softmax (m, l, acc) over key tiles in increasing order,
// and acc / (l == 0 ? 1 : l). kind, window, chunk, scale and cap are
// runtime arguments (SMEM data on the TPU): one compiled kernel per head
// dim and I/O type serves every layer kind.
//
// Bound on the H100: 4 D operations per live (unmasked) query-key pair.
// At the widths of the repo's configs (gemma2-9b: S 8192, 16 heads,
// D 256; llama4-scout: S 16384, 40 heads, D 128) that is 4e11-1.4e12
// operations against 0.2-0.4 GB of traffic: bound by operations, 0.4-1.4
// ms at the bf16 tensor-core rate (989 TFLOP/s), 6-21 ms at float32's 67.
//
// Two routes; the caller picks one (kernels/flash_attention/ops.py
// ROUTES, by I/O type and head dim). Blocks run in parallel here, so the
// sequential key axis of the Pallas grid becomes a loop inside the block
// on both, and key tiles outside the causal frontier, the window or the
// chunk of a block's rows are not visited (the predicate of
// flash.py:55-58 on the block's tiles), which only saves work. A row
// whose first visited tile is fully masked sums its values with weight 1
// (every score equals the sentinel, the running max is the sentinel); the
// first live score wipes that exactly, since corr = exp(-2^30 - m) is 0
// in float32. A -INFINITY sentinel would give exp(-inf + inf) = NaN
// there. Keys past the end of the sequence get -INFINITY, which gives
// weight 0 in every state.
//
// SIMT (flash_fwd_kernel): float32 I/O at every head dim, bf16 at D 16
// and 32 (and at any D when the caller asks for it). One block of 8 warps
// per (batch-head, 64-row query tile); the longest query tiles are
// scheduled first. Warp w owns query rows w, w + 8, ..., w + 56 of the
// tile for the whole kernel: the scores of its rows against a 32-key tile
// (lane = key), their row max and sum by warp shuffles, the (m, l) state
// in registers, and the output rows (lane = head-dim column, D / 32
// columns each) in registers. Q, K and V tiles are converted to float32
// (exact for bf16) in dynamic shared memory; Q and K rows are padded by 4
// floats so that the float4 reads of a K tile by 32 lanes do not
// conflict, and the Q reads are broadcasts. Only the probabilities pass
// through shared memory, within the warp that owns their rows, so a key
// tile needs two block barriers (before and after its load). At D = 256
// the tiles take 141 KB of shared memory. Float32 stays here: on the
// tensor cores it would be TF32 (about 3 decimal digits), outside the
// 2e-5 that the JAX package's flash tests hold. Dot products use
// explicit fmaf, as the build's -fmad=false would otherwise split them.
//
// wgmma (flash_wgmma_kernel): bf16 I/O at D 64, 128, 256, on the bf16
// tensor cores. One block of three warpgroups per (batch-head, 128-row
// query tile), heaviest tiles first, the q heads of one kv head in
// adjacent blocks (their K/V tiles then come from L2):
//   * a producer warpgroup (setmaxnreg down to 24) in which one thread
//     loads the Q tile once and K and V tiles of BK keys (64 at D = 256,
//     128 below) into a 2-stage ring, by TMA with the 128-byte swizzle,
//     each tile as D / 64 chunks of 128-byte rows. K and V have their own
//     full and empty barriers: a K slot is refilled once the 8 consumer
//     warps have finished its S, a V slot once they have finished its
//     P V. Shared memory: Q 64 KB + 2 x (K 32 + V 32) KB at D = 256;
//     160 KB at D = 128. Rows past Sq or Sk arrive as TMA's zero fill
//     (3-d maps, one head per plane); keys past Sk are masked to -INFINITY.
//   * two consumer warpgroups (setmaxnreg up to 240) of 64 query rows.
//     Per key tile: S = Q K^T by wgmma m64nBKk16 from shared memory, both
//     operands K-major (a product of two bf16 values is exact in float32,
//     so S differs from the plain version only in summation order); scale,
//     softcap with the accurate tanhf, and the mask only on tiles that
//     cross the causal diagonal, the window's left edge, a chunk edge or
//     Sk (each tile is classified per warpgroup as fully live or
//     partial); the online softmax in registers on the accumulator layout
//     (a row's values sit in a quad of threads: max reduced by
//     __shfl_xor_sync over 1 and 2, each thread keeps a partial l that the
//     quad sums once at the end); then O += P V by wgmma m64nDk16 with P
//     rounded to bf16 in registers as the A operand (the accumulator
//     layout of S is the A fragment layout, so no shuffle) and V from
//     shared memory as an MN-major B (transpose bit set). l sums the
//     unrounded float32 p, so rounding P moves an output by at most about
//     2^-9 sum_k p_k |v_k| / l (modelled by checks.flash_tiled_ref).
//   * overlap: a warpgroup issues S of tile i and P V of tile i - 1 as one
//     batch, then runs the softmax of tile i while P V runs; the two
//     warpgroups take turns issuing their batches (named barriers 1 and
//     2), so one's softmax overlaps the other's products. The softmax is
//     a few passes over the registers, each under a branch that is
//     uniform across the warpgroup (cap > 0, tile not fully live); with
//     those branches inside the per-score loop the kernel ran several
//     times slower, as if every score paid for tanhf, the division and
//     the mask. Each row's first visible key is computed once, so the
//     mask makes no division.
//   * exponentials by ex2.approx.ftz (a p below 2^-126 is 0; beside the
//     row's largest p, 1, it adds nothing): corr = 2^((m_old - m_new)
//     log2e), exactly 1 when the max holds, and p = 2^(__fmaf_rn(s,
//     log2e, -(m_new log2e))), one rounding before the exp2 (-2^30 log2e
//     is exact, so a fully masked row still gets p = 1 and is wiped as
//     above). Every read of an accumulator follows the wgmma.wait_group
//     that retires its writer (fence_regs), and no wgmma is issued or
//     waited on in a branch, so ptxas neither serialises the wgmma (C7514,
//     C7518) nor injects waits (C7517). Epilogue: acc / safe_l, rounded
//     to bf16 and stored, rows past Sq masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2^30, flash.py:24
constexpr int WARPS = 8;
constexpr int RPW = 8;               // query rows per warp
constexpr int BQ = WARPS * RPW;      // 64 query rows per block
constexpr int BK = 32;               // keys per tile, one per lane
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return (BQ + BK) * (D + 4) + BK * D + BQ * BK;
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int bh_count,
                     int sq, int sk, int groups, int kind, int window,
                     int chunk, float scale, float cap) {
  constexpr int DP = D + 4;                  // padded row of Q and K tiles
  constexpr int DW = D < 32 ? D : 32;        // lanes that own a column
  constexpr int DPL = D < 32 ? 1 : D / 32;   // output columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][DP]
  float* Ks = Qs + BQ * DP;                     // [BK][DP]
  float* Vs = Ks + BK * DP;                     // [BK][D]
  float* Ps = Vs + BK * D;                      // [BQ][BK]

  const int nq = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (nq - 1 - blockIdx.x / bh_count) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qg = q + (size_t)bh * sq * D;
  const size_t kv_off = (size_t)(bh / groups) * sk * D;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;

  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    Qs[r * DP + c] = q0 + r < sq ? to_f32(qg[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  // Keys any row of this tile can see: [k_begin, k_end).
  const int q_hi = min(q0 + BQ, sq) - 1;
  int k_begin = 0;
  if (kind == 1) k_begin = max(0, q0 - window + 1);
  if (kind == 2) k_begin = (q0 / chunk) * chunk;
  const int k_end = min(sk, q_hi + 1);

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K and V tiles
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < sk;
      const size_t g = (size_t)(k0 + r) * D + c;
      Ks[r * DP + c] = in ? to_f32(kg[g]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vg[g]) : 0.f;
    }
    __syncthreads();

    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const float* krow = Ks + lane * DP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (warp + WARPS * i) * DP + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i;
      const int qpos = q0 + r;
      float x = s[i] * scale;
      if (cap > 0.f) x = cap * tanhf(x / fmaxf(cap, 1e-6f));
      bool live = qpos >= kpos;
      if (kind == 1) live = live && qpos - kpos < window;
      if (kind == 2) live = live && qpos / chunk == kpos / chunk;
      x = live ? x : NEG_INF;
      if (kpos >= sk) x = -INFINITY;
      float mt = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      const float p = expf(x - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(FULL, ps, off);
      l[i] = fmaf(l[i], corr, ps);
      m[i] = m_new;
      Ps[r * BK + lane] = p;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a warp reads back only the rows of Ps it wrote

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p4[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (warp + WARPS * i) * BK +
                                                 c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const float vv = Vs[(c + cc) * D + (lane % DW) + 32 * j];
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const float pv = cc == 0 ? p4[i].x
                           : cc == 1 ? p4[i].y
                           : cc == 2 ? p4[i].z
                                     : p4[i].w;
            acc[i][j] = fmaf(pv, vv, acc[i][j]);
          }
        }
      }
    }
    __syncwarp();  // Ps rows are rewritten by the next tile
  }

  if (lane >= DW) return;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qpos = q0 + warp + WARPS * i;
    if (qpos >= sq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)bh * sq + qpos) * D;
#pragma unroll
    for (int j = 0; j < DPL; ++j) store(orow + lane + 32 * j, acc[i][j] / safe);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int groups, int kind, int window, int chunk,
           float scale, float cap, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<D>();
  auto kernel = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)bh * ((sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, sq, sk, groups, kind,
      window, chunk, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int bh, int sq, int sk, int groups, int kind, int window,
             int chunk, float scale, float cap, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, o, bh, sq, sk, groups, kind,
                                  window, chunk, scale, cap, stream);
    case 32: return launch<32, T>(q, k, v, o, bh, sq, sk, groups, kind,
                                  window, chunk, scale, cap, stream);
    case 64: return launch<64, T>(q, k, v, o, bh, sq, sk, groups, kind,
                                  window, chunk, scale, cap, stream);
    case 128: return launch<128, T>(q, k, v, o, bh, sq, sk, groups, kind,
                                    window, chunk, scale, cap, stream);
    case 256: return launch<256, T>(q, k, v, o, bh, sq, sk, groups, kind,
                                    window, chunk, scale, cap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// wgmma route: TMA-fed K/V ring, wgmma for QK^T and PV, bf16 in and out.
// ---------------------------------------------------------------------------

// The launcher's route codes; kernels/flash_attention/ops.py passes them.
enum Route { ROUTE_SIMT = 0, ROUTE_WGMMA = 1 };

constexpr int WQ = 128;               // query rows per block, 64 a consumer
constexpr int W_THREADS = 384;        // warpgroups 0-1 consume, 2 produces
constexpr int W_CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.44269504088896341f;

template <int D>
struct Wg {
  static constexpr int BK = D == 256 ? 64 : 128;  // keys per tile
  static constexpr int CH = D / 64;               // 128-byte column chunks
  static constexpr int Q_CHUNK = WQ * 128;        // bytes of a Q chunk
  static constexpr int KV_CHUNK = BK * 128;       // of a K or V chunk
  static constexpr int Q_BYTES = CH * Q_CHUNK;
  static constexpr int KV_BYTES = CH * KV_CHUNK;  // a K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int STAGES = 2;                // depth of the K/V ring
  // 1024 to align the swizzled tiles; the barriers: Q's, and a full and
  // an empty one for K and for V in each stage.
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * STAGE + 8 * (1 + 4 * STAGES);
};

// S (64 x BK) = Q (64 x 16) K^T (16 x BK) + (scale_d ? S : 0), A and B
// from shared memory, both K-major.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 WG_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : WG_OUT32(d)
                 : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 WG_D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : WG_OUT64(d)
                 : "l"(da), "l"(db), "r"(scale_d));
  }
}

// O (64 x D) += P (64 x 16, bf16 pairs in registers) V (16 x D), V from
// shared memory MN-major (D contiguous): the transpose bit of B is set.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 WG_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : WG_OUT32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  } else if constexpr (D == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 WG_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                 : WG_OUT64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
                 WG_D128 ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
                 : WG_OUT128(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  }
}

// wgmma descriptor of the MN-major V tile (keys x D, D contiguous),
// written by TMA as D / 64 chunks of BK rows of 128 bytes with the
// 128-byte swizzle: leading offset = the stride between the 64-column
// chunks (BK x 128 bytes), stride offset = between 8-key groups (1024
// bytes). A k step of 16 keys adds 2048 bytes to the start address.
template <int BK>
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((BK * 128) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x to ex2.approx's ~2^-22 relative error, results below 2^-126
// flushed to zero (such a p adds nothing beside the row's largest, 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The two consumer warpgroups take turns issuing their wgmma batches on
// named barriers 1 and 2 (0 is __syncthreads): warpgroup wg waits on
// 1 + wg for the other's arrival, issues, then arrives on the other's.
__device__ __forceinline__ void sched_sync(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void sched_arrive(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

// S = Q K^T for one key tile: D / 16 k steps, chunk kk / 4 of Q and K,
// 32 bytes a step within it; one commit group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Wg<D>::BK / 2],
                                         uint64_t dq, uint64_t dk) {
  using W = Wg<D>;
  fence_regs(sc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_qk<W::BK>(sc, dq + (kk / 4) * (W::Q_CHUNK >> 4) + 2 * (kk % 4),
                    dk + (kk / 4) * (W::KV_CHUNK >> 4) + 2 * (kk % 4),
                    kk > 0);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// O += P V for one key tile: BK / 16 k steps of 16 keys (2048 bytes of
// V), P's registers 4 kk .. 4 kk + 3; one commit group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[Wg<D>::BK / 4],
                                         uint64_t dv) {
  fence_regs(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < Wg<D>::BK / 16; ++kk)
    wgmma_pv<D>(acc, pa + 4 * kk, dv + kk * ((16 * 128) >> 4));
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// One key tile's scores, in place in the S accumulator: scale, cap and
// mask them (the mask only where the tile is not fully live for these 64
// rows), update the online softmax state (m, l) of the thread's two rows
// and leave p = 2^(s log2e - m log2e) in sc; corr rescales O. Each step
// is its own pass over the registers under a branch that is uniform
// across the warpgroup. Row h sees keys lo[h] <= k <= row + 8 h, which is
// the reference's predicate (a window: row - k < window; a chunk: row /
// chunk == k / chunk, given k <= row); keys past sk get -INFINITY.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool full, int row, const int (&lo)[2], int kcol, int sk, float scale,
    float cap) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = sc[i] * scale;
  if (cap > 0.f) {
    const float div = fmaxf(cap, 1e-6f);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = cap * tanhf(sc[i] / div);
  }
  if (!full) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, kpos = kcol + 8 * j + (e & 1);
        const bool live = kpos >= lo[h] && kpos <= row + 8 * h;
        float& x = sc[4 * j + e];
        x = kpos >= sk ? -INFINITY : live ? x : NEG_INF;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float ml[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = ex2((m[h] - m_new) * LOG2E);
    ml[h] = m_new * LOG2E;
    m[h] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = ex2(__fmaf_rn(sc[i], LOG2E, -ml[h]));
    rs[h] = rs[h] + sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = __fmaf_rn(l[h], corr[h], rs[h]);
}

// Whether every key of the tile at k0 is live for every one of the 64
// rows from r0: then the tile needs no mask.
__device__ __forceinline__ bool tile_full(int k0, int r0, int sk, int kind,
                                          int window, int chunk, int bk) {
  return k0 + bk <= sk && k0 + bk - 1 <= r0 &&
         (kind != 1 || r0 + 63 - k0 < window) &&
         (kind != 2 || k0 / chunk == (r0 + 63) / chunk);
}

// P as the A operand of P V: register r holds p[2 r] and p[2 r + 1] in
// bf16.
template <int BK>
__device__ __forceinline__ void to_pairs(const float (&sc)[BK / 2],
                                         uint32_t (&pa)[BK / 4]) {
#pragma unroll
  for (int r = 0; r < BK / 4; ++r)
    pa[r] = pack_bf16(sc[2 * r], sc[2 * r + 1]);
}

// O *= corr, row by row; skipped by a warp whose 16 rows all kept their
// max (corr exactly 1).
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&corr)[2]) {
  if (!__any_sync(FULL, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
  }
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o, int sq, int sk,
                       int groups, int kind, int window, int chunk,
                       float scale, float cap) {
  using W = Wg<D>;
  constexpr int BK = W::BK;
  extern __shared__ uint8_t fa_smem[];
  const uint32_t q_s = (smem_u32(fa_smem) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + W::Q_BYTES;  // stage s: K at + s STAGE, V next
  constexpr int ST = W::STAGES;
  const uint32_t bar_q = kv_s + ST * W::STAGE;
  const uint32_t full_k = bar_q + 8;    // + 8 s, each
  const uint32_t full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST;
  const uint32_t empty_v = empty_k + 8 * ST;

  // Heaviest query tiles first; the q heads of one kv head (adjacent bh)
  // in adjacent blocks, so their K/V tiles come from L2.
  const int nq = (sq + WQ - 1) / WQ;
  const int bh_count = gridDim.x / nq;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (nq - 1 - blockIdx.x / bh_count) * WQ;
  // Key tiles any row of this block can see: [t_begin, t_begin + n).
  const int q_hi = min(q0 + WQ, sq) - 1;
  int k_begin = 0;
  if (kind == 1) k_begin = max(0, q0 - window + 1);
  if (kind == 2) k_begin = (q0 / chunk) * chunk;
  const int k_end = min(sk, q_hi + 1);
  const int t_begin = k_begin / BK;
  const int n = k_end > k_begin ? (k_end + BK - 1) / BK - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, W_CONSUMER_WARPS);
      mbar_init(empty_v + 8 * s, W_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread issues every load. K and V have their own
    // empty barriers: K of a tile is released as soon as its S is done,
    // V one product later (P V lags S by a tile).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      const int kvh = bh / groups;
      mbar_expect_tx(bar_q, W::Q_BYTES);
      for (int c = 0; c < W::CH; ++c)
        tma_load_3d(q_s + c * W::Q_CHUNK, &map_q, bar_q, 64 * c, q0, bh);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST, k0 = (t_begin + i) * BK;
        const uint32_t ph = ((i / ST) & 1) ^ 1;
        const uint32_t ks = kv_s + s * W::STAGE, vs = ks + W::KV_BYTES;
        mbar_wait(empty_k + 8 * s, ph);
        mbar_expect_tx(full_k + 8 * s, W::KV_BYTES);
        for (int c = 0; c < W::CH; ++c)
          tma_load_3d(ks + c * W::KV_CHUNK, &map_k, full_k + 8 * s, 64 * c,
                      k0, kvh);
        mbar_wait(empty_v + 8 * s, ph);
        mbar_expect_tx(full_v + 8 * s, W::KV_BYTES);
        for (int c = 0; c < W::CH; ++c)
          tma_load_3d(vs + c * W::KV_CHUNK, &map_v, full_v + 8 * s, 64 * c,
                      k0, kvh);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [r0, r0 + 64) of the tile. In the
  // accumulator layout a thread holds rows `row` and row + 8, columns
  // 8 j + col (+ 1) for every j: S[4 j + 2 h + c] and O[4 j + 2 h + c]
  // at row + 8 h, column 8 j + col + c. The accumulator of S is also the
  // layout of P as the A operand of P V: P's register r holds S[2 r] and
  // S[2 r + 1].
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = q0 + 64 * wg;
  const int row = r0 + 16 * (warp & 3) + (lane >> 2);
  const int col = 2 * (lane & 3);
  int lo[2];  // the first key each of the thread's rows sees
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = row + 8 * h;
    lo[h] = kind == 1 ? qpos - window + 1 : kind == 2 ? qpos / chunk * chunk
                                                       : 0;
  }
  float acc[D / 2], sc[BK / 2], corr[2] = {1.f, 1.f};
  uint32_t pa[BK / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint64_t dq = sw128_desc(q_s + wg * (64 * 128));
  mbar_wait(bar_q, 0);

  // Step i issues S of tile i and P V of tile i - 1 as one turn, then
  // runs the softmax of tile i while P V (and the other warpgroup's
  // turn) occupy the tensor cores. The first step issues S alone, the
  // last P V alone; no wgmma is issued or waited on in a branch.
  if (n > 0) {
    if (wg == 1) sched_arrive(wg);  // warpgroup 0 goes first
    sched_sync(wg);
    mbar_wait(full_k, 0);
    issue_qk<D>(sc, dq, sw128_desc(kv_s));
    sched_arrive(wg);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty_k);
    softmax_tile<BK>(sc, m, l, corr,
                     tile_full(t_begin * BK, r0, sk, kind, window, chunk, BK),
                     row, lo, t_begin * BK + col, sk, scale, cap);
    to_pairs<BK>(sc, pa);
    for (int i = 1; i < n; ++i) {
      const int s = i % ST, sp = (i - 1) % ST;  // stages of tiles i, i - 1
      const uint32_t ph = (i / ST) & 1, php = ((i - 1) / ST) & 1;
      const int k0 = (t_begin + i) * BK;
      sched_sync(wg);
      mbar_wait(full_k + 8 * s, ph);
      issue_qk<D>(sc, dq, sw128_desc(kv_s + s * W::STAGE));
      rescale<D>(acc, corr);
      mbar_wait(full_v + 8 * sp, php);
      issue_pv<D>(acc, pa,
                  sw128_mn_desc<BK>(kv_s + sp * W::STAGE + W::KV_BYTES));
      sched_arrive(wg);
      wgmma_wait<1>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      softmax_tile<BK>(sc, m, l, corr,
                       tile_full(k0, r0, sk, kind, window, chunk, BK), row,
                       lo, k0 + col, sk, scale, cap);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
      fence_regs(sc);  // P is rewritten only after P V of tile i - 1
      to_pairs<BK>(sc, pa);
    }
    const int sp = (n - 1) % ST;
    sched_sync(wg);
    rescale<D>(acc, corr);
    mbar_wait(full_v + 8 * sp, ((n - 1) / ST) & 1);
    issue_pv<D>(acc, pa,
                sw128_mn_desc<BK>(kv_s + sp * W::STAGE + W::KV_BYTES));
    if (wg == 0) sched_arrive(wg);  // balanced: warpgroup 1 arrived first
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h] + __shfl_xor_sync(FULL, l[h], 1);
    lt = lt + __shfl_xor_sync(FULL, lt, 2);
    const float safe = lt == 0.f ? 1.f : lt;
    const int qpos = row + 8 * h;
    if (qpos >= sq) continue;
    __nv_bfloat16* orow = o + ((size_t)bh * sq + qpos) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / safe,
                                acc[4 * j + 2 * h + 1] / safe);
  }
}

// The map of a (heads, rows, D) bf16 tensor: boxes of 64 columns (128
// bytes) x box_rows rows of one head, 128-byte swizzle, zeros past a
// head's last row.
CUresult head_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int heads, int rows, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh,
                 int sq, int sk, int groups, int kind, int window, int chunk,
                 float scale, float cap, cudaStream_t stream) {
  using W = Wg<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  CUresult r = head_map(encode, &mq, q, bh, sq, D, WQ);
  if (r == CUDA_SUCCESS)
    r = head_map(encode, &mk, k, bh / groups, sk, D, W::BK);
  if (r == CUDA_SUCCESS)
    r = head_map(encode, &mv, v, bh / groups, sk, D, W::BK);
  if (r != CUDA_SUCCESS) return DRIVER_ERROR + (int)r;
  static int dev_sms[64];
  auto kernel = flash_wgmma_kernel<D>;
  const cudaError_t err = prepare(reinterpret_cast<const void*>(kernel),
                                  W::SMEM, dev_sms, nullptr);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)bh * ((sq + WQ - 1) / WQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, W_THREADS, W::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), sq, sk, groups, kind,
      window, chunk, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d); k, v: (bh / groups, sk, d); o: (bh, sq, d); all of one
// type, float32 (bf16 = 0) or bf16 (bf16 = 1), contiguous. kind: 0 causal,
// 1 local window, 2 chunked. route: ROUTE_SIMT (any type, d 16, 32, 64,
// 128, 256) or ROUTE_WGMMA (bf16, d 64, 128, 256; q, k, v 16-byte
// aligned). Returns a CUDA error code (DRIVER_ERROR + CUresult when a
// tensor map cannot be encoded), or cudaErrorInvalidValue for a route,
// type or head dim the kernels do not take or a degenerate window or
// chunk.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int sq,
                                     int sk, int d, int groups, int kind,
                                     int window, int chunk, float scale,
                                     float softcap, int bf16, int route,
                                     void* stream) {
  if (groups < 1 || bh % groups || kind < 0 || kind > 2 ||
      (kind == 1 && window <= 0) || (kind == 2 && chunk <= 0) ||
      (route != ROUTE_SIMT && route != ROUTE_WGMMA) ||
      (route == ROUTE_WGMMA && !bf16))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == ROUTE_WGMMA) {
    if (sk <= 0) return (int)cudaErrorInvalidValue;
    switch (d) {
      case 64: return launch_wgmma<64>(q, k, v, o, bh, sq, sk, groups, kind,
                                       window, chunk, scale, softcap, s);
      case 128: return launch_wgmma<128>(q, k, v, o, bh, sq, sk, groups,
                                         kind, window, chunk, scale, softcap,
                                         s);
      case 256: return launch_wgmma<256>(q, k, v, o, bh, sq, sk, groups,
                                         kind, window, chunk, scale, softcap,
                                         s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, o, bh, sq, sk, groups,
                                        kind, window, chunk, scale, softcap, s)
              : dispatch<float>(d, q, k, v, o, bh, sq, sk, groups, kind,
                                window, chunk, scale, softcap, s);
}
