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
// ms at the bf16 tensor-core rate, 6-21 ms at the float32 rate this
// kernel computes at.
//
// Design (not the TPU's block structure: blocks run in parallel here, so
// the sequential key axis of the Pallas grid becomes a loop inside the
// block). One block of 8 warps per (batch-head, 64-row query tile); the
// longest query tiles are scheduled first. Warp w owns query rows
// w, w + 8, ..., w + 56 of the tile for the whole kernel: the scores of
// its rows against a 32-key tile (lane = key), their row max and sum by
// warp shuffles, the (m, l) state in registers, and the output rows
// (lane = head-dim column, D / 32 columns each) in registers. Q, K and V
// tiles are converted to float32 (exact for bf16) in dynamic shared
// memory; Q and K rows are padded by 4 floats so that the float4 reads of
// a K tile by 32 lanes do not conflict, and the Q reads are broadcasts.
// Only the probabilities pass through shared memory, within the warp that
// owns their rows, so a key tile needs two block barriers (before and
// after its load). At D = 256 the tiles take 141 KB of shared memory,
// above the 48 KB of static shared memory: the launcher opts in to the
// dynamic size. No tensor cores yet (a later redesign); dot products use
// explicit fmaf, as the build's -fmad=false would otherwise split them.
//
// Key tiles outside the causal frontier, the window or the chunk are not
// visited (the predicate of flash.py:55-58 on this kernel's tiles), which
// only saves work. A row whose first visited tile is fully masked sums
// its values with weight 1 (every score equals the sentinel, the running
// max is the sentinel); the first live score wipes that exactly, since
// corr = exp(-2^30 - m) is 0 in float32. A -INFINITY sentinel would give
// exp(-inf + inf) = NaN there. Keys past the end of the sequence get
// -INFINITY, which gives weight 0 in every state.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace

// q: (bh, sq, d); k, v: (bh / groups, sk, d); o: (bh, sq, d); all of one
// type, float32 (bf16 = 0) or bf16 (bf16 = 1), contiguous. kind: 0 causal,
// 1 local window, 2 chunked. Returns a CUDA error code, or
// cudaErrorInvalidValue for a head dim other than 16, 32, 64, 128 or 256
// or a degenerate window or chunk.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int sq,
                                     int sk, int d, int groups, int kind,
                                     int window, int chunk, float scale,
                                     float softcap, int bf16, void* stream) {
  if (groups < 1 || bh % groups || kind < 0 || kind > 2 ||
      (kind == 1 && window <= 0) || (kind == 2 && chunk <= 0))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, o, bh, sq, sk, groups,
                                        kind, window, chunk, scale, softcap, s)
              : dispatch<float>(d, q, k, v, o, bh, sq, sk, groups, kind,
                                window, chunk, scale, softcap, s);
}
