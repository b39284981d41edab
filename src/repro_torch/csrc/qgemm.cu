// Chopped GEMM: C = chop?( chop(A) @ chop(B) ), float32 accumulation,
// summed in blocks of bk along K.
//
// Replaces: repro/kernels/qmatmul/qmatmul.py::qmatmul_pallas (body
// _qmatmul_kernel: chop both tiles, jnp.dot with float32 accumulation, add
// into the accumulator), as both of its callers reach it:
//   * repro/kernels/qmatmul/ops.py::qgemm_op, one K block: on the solver
//     path the blocked-LU trailing update, (n_pad - k1, 64) x (64,
//     n_pad - k1). Here bk >= K.
//   * repro/kernels/qmatmul/ops.py::qmatmul_op, K blocks of a runtime bk
//     (by default 256), a float32 accumulator carried across the K grid
//     axis (acc_ref[...] += jnp.dot(...)).
//
// Two routes. The caller picks one from the format id at run time; one
// build serves all seven ids, and the format parameters (t, emin,
// xmax_bits, saturate, chop_out) are runtime arguments.
//
// Tensor cores, for e5m2, e4m3, bf16, fp16 and tf32. chop(x) in these
// formats is exact in a tensor-core input type: bf16 holds e5m2, e4m3 and
// bf16; fp16 holds fp16; tf32 (float32 with the low 13 mantissa bits zero)
// holds tf32. Products of such values are exact in float32, so a
// tensor-core product with float32 accumulation computes what the TPU
// kernel computes, and only the summation order changes; the reference
// does not pin it (DESIGN.md §6.2). e4m3 and e5m2 are fed as bf16, not to
// the fp8 tensor cores: on Hopper those keep only about 14 bits of their
// float32 accumulation, which the order tolerance does not hold. Two
// launches:
//   1. qgemm_pack_kernel reads A (M, K) and B (K, N) once, chops each
//      element (chop_f32) and writes A as (M, Kp) and B transposed as
//      (N, Kp), both K-major in the operand type, K zero-padded to Kp, a
//      multiple of the 128-byte K tile. B goes through a shared tile so
//      that its reads and its writes are both coalesced.
//   2. qgemm_wgmma_kernel: persistent blocks of 384 threads, one 128x128
//      output tile at a time. One producer thread keeps a ring of four
//      stages (A and B tiles of 128 rows x 128 bytes of K) filled through
//      TMA with the 128-byte swizzle and mbarriers; two consumer
//      warpgroups run wgmma m64n128k16 (bf16, fp16) or m64n128k8 (tf32) on
//      64 rows each, straight from shared memory. The wgmma accumulator is
//      the partial of the current K block (scale-d = 0 on the block's
//      first k step); at the block's end it is added into a second register
//      set with __fadd_rn, the order of the Pallas body and of
//      `qmatmul_ref_blocked`. That holds when bk is a multiple of the K
//      tile (64 bf16/fp16 values, 32 tf32 values), which covers every bk
//      the ops choose, and when bk >= K (one block). Called with any other
//      bk the kernel sums K as one chain; the wrapper (`ops._gemm`) never
//      does: it launches each such K block on its own and adds the
//      partials in order.
//
// FFMA, for fp32 and fp64 (on the float32 carrier they leave the operands
// unchanged, and no tensor-core type holds them). qgemm_ffma_kernel: a
// 128x128 tile per block of 256 threads, 8x8 outputs each, A (transposed)
// and B staged through double-buffered cp.async with zero fill at the
// edges, float4 shared loads, one __fmaf_rn per term: the build keeps
// -fmad=false, so the FMA is spelled out, and it rounds once per term. The
// K-block partial lives in registers and is added with __fadd_rn into a
// per-thread accumulator in shared memory, which leaves registers for two
// blocks per SM. Operands are chopped in shared memory as they arrive
// unless the format is the identity on float32, so the kernel is right for
// every format id. The wrapper routes only fp32 and fp64 to it; the chop
// is kept so that a format the tensor cores failed to hold (a subnormal
// or an infinity the float32 reference keeps otherwise) could move here
// by a change of `ROUTES` alone, and the card tests hold this kernel for
// all seven ids through the launcher's route argument for that reason.
//
// Bounds on the H100 SXM at gemma2-9b's FFN width, (4096, 3584) x (3584,
// 14336), 4.21e11 operations: 0.426 ms at the bf16/fp16 tensor-core rate
// (989 TFLOP/s; e4m3 and e5m2 too, since they run in bf16), 0.851 ms at
// tf32's 495 TFLOP/s, 6.28 ms at float32's 67 TFLOP/s outside the tensor
// cores. The float32 operands and output are 0.50 GB, 0.149 ms at 3.35
// TB/s, so every route is bound by operations; the pack pass adds 0.40 GB
// of traffic (about 0.12 ms) on the tensor-core routes. At the solver's
// trailing update, (448, 64) x (64, 448), both bounds are under a
// microsecond and the launches' latency decides. One call makes one
// ctypes call, two launches and no tensor-map encode when the scratch
// comes back at an address seen before (`cached_map`).
//
// Batches (the solver's batched program: every row's trailing update in
// one call): B products (B, M, K) x (B, K, N) -> (B, M, N), contiguous, one
// grid dimension over the rows of the batch (the pack's y, the FFMA
// kernel's z; the persistent wgmma kernel walks the tiles of every row).
// The route follows the format, so the wrapper makes one launch per route
// present in the batch: `ids` (device, one int32 a row) gives each row's
// format from the launch's table (chop_core.cuh `RowFmts`), and `fmask`
// the ids this launch takes (bit k for id k); a block of a row outside it
// returns at once. Without ids every row takes the launch's one format.
// The packed operands are (B M, Kp) and (B N, Kp): a tile that runs past a
// row's M or N reads the next row's packed values (or TMA's zeros past the
// last), which reach only the outputs past M or N that the epilogue masks.
//
// Edges: the pack zero-pads K; TMA fills tile rows past M or N with zeros;
// the FFMA kernel's cp.async zero-fills past M, N and K; the epilogues mask
// stores past M and N. Padded K terms add an exact +0.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "chop_core.cuh"
#include "hopper.cuh"

namespace {

// Route codes of the C launcher; kernels/qmatmul/ops.py passes them.
enum Route { ROUTE_FFMA = 0, ROUTE_BF16 = 1, ROUTE_F16 = 2, ROUTE_TF32 = 3 };

struct Fmt {
  int t, emin;
  uint32_t xmax_bits;
  int saturate;
};

__device__ __forceinline__ float chop(float v, const Fmt& f) {
  return chop_f32(v, f.t, f.emin, f.xmax_bits, f.saturate);
}

// Whether batch row q belongs to this launch (its id in fmask, or no
// ids), and its format in f.
__device__ __forceinline__ bool batch_row(const RowFmts& rf, unsigned fmask,
                                          long long q, Fmt& f) {
  if (rf.ids == nullptr) return true;
  if (!((fmask >> rf.ids[q]) & 1u)) return false;
  row_format(rf, q, f.t, f.emin, f.xmax_bits, f.saturate);
  return true;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Pack: chop, convert to the operand type, lay out K-major.
// ---------------------------------------------------------------------------

// A block packs one 32 (K) x 128 (rows of A or columns of B) tile; each
// thread moves 4 consecutive values 4 times. Kp is a multiple of PACK_K.
constexpr int PACK_K = 32, PACK_R = 128;

template <typename T>
__device__ __forceinline__ T to_operand(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_operand(float v) {
  return __float2bfloat16_rn(v);  // exact: v is a bf16 value, inf or NaN
}
template <>
__device__ __forceinline__ __half to_operand(float v) {
  return __float2half_rn(v);  // exact: v is an fp16 value, inf or NaN
}
// tf32: the chopped float32 bits. A NaN is made quiet so that it is still
// a NaN in the top 19 bits, the only ones the tensor cores read.
template <>
__device__ __forceinline__ float to_operand(float v) {
  return isnan(v) ? __uint_as_float(0x7fc00000u) : v;
}

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

// x[i], x[i + 1], x[i + 2], x[i + 3] of a row of n values, 0 past n; one
// 16-byte load where the row allows it (vec: n % 4 == 0).
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int i,
                                        int n, bool vec) {
  if (vec && i + 3 < n) return *reinterpret_cast<const float4*>(x + i);
  return make_float4(i < n ? x[i] : 0.0f, i + 1 < n ? x[i + 1] : 0.0f,
                     i + 2 < n ? x[i + 2] : 0.0f, i + 3 < n ? x[i + 3] : 0.0f);
}

template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ dst, float4 v,
                                       const Fmt& f) {
  Vec4<T> o;
  o.v[0] = to_operand<T>(chop(v.x, f));
  o.v[1] = to_operand<T>(chop(v.y, f));
  o.v[2] = to_operand<T>(chop(v.z, f));
  o.v[3] = to_operand<T>(chop(v.w, f));
  *reinterpret_cast<Vec4<T>*>(dst) = o;
}

// Blocks [0, a_blocks) pack tiles of A (128 rows x 32 k, read and
// written along K), the rest tiles of B (32 k x 128 columns, read along
// N, transposed through shared memory, written along K).
template <typename T>
__global__ void __launch_bounds__(256) qgemm_pack_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    T* __restrict__ Ap, T* __restrict__ Bp, int M, int N, int K, int Kp,
    int a_blocks, Fmt f, RowFmts rf, unsigned fmask) {
  __shared__ float tile[PACK_K][PACK_R + 1];
  const long long q = blockIdx.y;
  if (!batch_row(rf, fmask, q, f)) return;
  A += q * M * K;
  B += q * K * N;
  Ap += q * M * Kp;
  Bp += q * N * Kp;
  const int k_tiles = Kp / PACK_K;
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  if (blk < a_blocks) {
    const int m0 = blk / k_tiles * PACK_R, k0 = blk % k_tiles * PACK_K;
    const bool vec = (K & 3) == 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tid / 8 + 32 * i, k = k0 + (tid & 7) * 4;
      if (m < M)
        store4(Ap + (size_t)m * Kp + k, load4(A + (size_t)m * K, k, K, vec),
               f);
    }
    return;
  }
  blk -= a_blocks;
  const int n0 = blk / k_tiles * PACK_R, k0 = blk % k_tiles * PACK_K;
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = tid / 32 + 8 * i, c = (tid & 31) * 4;
    const float4 v = k0 + kk < K
                         ? load4(B + (size_t)(k0 + kk) * N, n0 + c, N, vec)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    tile[kk][c] = v.x;
    tile[kk][c + 1] = v.y;
    tile[kk][c + 2] = v.z;
    tile[kk][c + 3] = v.w;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = tid / 8 + 32 * i, kk = (tid & 7) * 4;
    if (n0 + n < N)
      store4(Bp + (size_t)(n0 + n) * Kp + k0 + kk,
             make_float4(tile[kk][n], tile[kk + 1][n], tile[kk + 2][n],
                         tile[kk + 3][n]),
             f);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core GEMM: TMA + mbarrier ring, wgmma, warp-specialised.
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128, TC_BN = 128, TC_STAGES = 4;
constexpr int TC_TILE = 128 * 128;   // bytes: 128 rows x 128 bytes of K
constexpr int TC_STAGE = 2 * TC_TILE;
constexpr int TC_THREADS = 384;      // warpgroups 0-1 consume, 2 produces
constexpr int TC_CONSUMER_WARPS = 8;
constexpr int TC_SMEM = TC_STAGES * TC_STAGE + 1024 + 2 * TC_STAGES * 8;

// One wgmma of a 64x128 tile, A and B from shared memory; d = A B + (scale_d
// ? d : 0). TAIL: the immediate scale and transpose operands.
#define WGMMA_64x128(INSTR, TAIL)                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" INSTR         \
               " " WG_D64 ", %64, %65, p" TAIL ";\n}\n"                   \
               : WG_OUT64(d)                                              \
               : "l"(da), "l"(db), "r"(scale_d))

template <int ROUTE>
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (ROUTE == ROUTE_BF16) {
    WGMMA_64x128("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                 ", 1, 1, 0, 0");
  } else if constexpr (ROUTE == ROUTE_F16) {
    WGMMA_64x128("wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16",
                 ", 1, 1, 0, 0");
  } else {
    WGMMA_64x128("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
                 ", 1, 1");
  }
}

__device__ __forceinline__ void store_pair(float* C, int row, int col, int M,
                                           int N, float v0, float v1) {
  if (row >= M) return;
  float* p = C + (size_t)row * N + col;
  if (col + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < N) p[0] = v0;
    if (col + 1 < N) p[1] = v1;
  }
}

// nk: K tiles of 128 bytes; tpb: K tiles per K block (nk for one block).
template <int ROUTE>
__global__ void __launch_bounds__(TC_THREADS, 1)
    qgemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       float* __restrict__ C, int M, int N, int nk, int tpb,
                       Fmt f0, int chop_out, int nb, RowFmts rf,
                       unsigned fmask) {
  constexpr int BKE = ROUTE == ROUTE_TF32 ? 32 : 64;  // K tile, elements
  extern __shared__ uint8_t tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t full0 = base + TC_STAGES * TC_STAGE;  // full[s]: +8 s
  const uint32_t empty0 = full0 + 8 * TC_STAGES;       // empty[s]: +8 s
  const int m_tiles = (M + TC_BM - 1) / TC_BM;
  const int row_tiles = m_tiles * ((N + TC_BN - 1) / TC_BN);
  const int tiles = nb * row_tiles;  // every row's, row after row
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, TC_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread issues every load. Tiles walk M fastest, so
    // the blocks in flight share B's column panels and A stays in L2.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int q = tile / row_tiles, rt = tile % row_tiles;
        Fmt f = f0;
        if (!batch_row(rf, fmask, q, f)) continue;
        const int m0 = rt % m_tiles * TC_BM, n0 = rt / m_tiles * TC_BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full0 + 8 * stage, TC_STAGE);
          const uint32_t dst = base + stage * TC_STAGE;
          tma_load_2d(dst, &map_a, full0 + 8 * stage, kt * BKE, q * M + m0);
          tma_load_2d(dst + TC_TILE, &map_b, full0 + 8 * stage, kt * BKE,
                      q * N + n0);
          if (++stage == TC_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int q = tile / row_tiles, rt = tile % row_tiles;
      Fmt f = f0;
      if (!batch_row(rf, fmask, q, f)) continue;
      const int m0 = rt % m_tiles * TC_BM, n0 = rt / m_tiles * TC_BN;
      float* Cq = C + (size_t)q * M * N;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      for (int kb = 0; kb < nk; kb += tpb) {  // one K block
        const int kend = kb + tpb < nk ? kb + tpb : nk;
        int prev = -1;  // the stage of the k tile before, still in flight
        for (int kt = kb; kt < kend; ++kt) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint32_t tile_a = base + stage * TC_STAGE + wg * (64 * 128);
          const uint64_t da = sw128_desc(tile_a);
          const uint64_t db = sw128_desc(base + stage * TC_STAGE + TC_TILE);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_step<ROUTE>(part, da + 2 * kk, db + 2 * kk,
                              kt > kb || kk > 0);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          // Keep this k tile's wgmma in flight; release the one before.
          wgmma_wait<1>();
          if (lane == 0 && prev >= 0) mbar_arrive(empty0 + 8 * prev);
          prev = stage;
          if (++stage == TC_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        // End of the K block: the partial is complete; add it in.
        wgmma_wait<0>();
        fence_regs(part);
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      }
      // Accumulator fragment: warp w of the warpgroup holds rows 16 (w % 4)
      // + lane / 4 (+ 8); columns 8 j + 2 (lane % 4) (+ 1).
      const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
      const int col = n0 + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (chop_out) {
            v0 = chop(v0, f);
            v1 = chop(v1, f);
          }
          store_pair(Cq, row + 8 * h, col + 8 * j, M, N, v0, v1);
        }
      }
    }
  }
}

// The map of a (rows, Kp) K-major operand: boxes of 128 rows x 128 bytes,
// 128-byte swizzle, zeros past the last row.
CUresult operand_map(EncodeTiled encode, CUtensorMap* map,
                     CUtensorMapDataType type, int esize, void* ptr, int rows,
                     int Kp) {
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), 128};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, ptr, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A map depends only on (type, address, rows, Kp), and PyTorch's caching
// allocator hands a caller's scratch out again at the same addresses, so
// each host thread keeps its last few maps and encodes only on a miss.
constexpr int MAP_CACHE = 8;
struct MapEntry {
  CUtensorMap map;
  const void* ptr;
  int type, rows, Kp;
};

CUresult cached_map(EncodeTiled encode, const CUtensorMap** out,
                    CUtensorMapDataType type, int esize, void* ptr, int rows,
                    int Kp) {
  thread_local MapEntry cache[MAP_CACHE] = {};
  thread_local int next = 0;
  for (const MapEntry& e : cache)
    if (e.ptr == ptr && e.type == (int)type && e.rows == rows && e.Kp == Kp) {
      *out = &e.map;
      return CUDA_SUCCESS;
    }
  MapEntry& e = cache[next];
  e.ptr = nullptr;
  const CUresult r = operand_map(encode, &e.map, type, esize, ptr, rows, Kp);
  if (r != CUDA_SUCCESS) return r;
  e.ptr = ptr;
  e.type = (int)type;
  e.rows = rows;
  e.Kp = Kp;
  next = (next + 1) % MAP_CACHE;
  *out = &e.map;
  return CUDA_SUCCESS;
}

// The pack alone: A (B, M, K) and B (B, K, N) chopped into pa (B M, Kp)
// and pb (B N, Kp) of type T.
template <typename T>
int launch_pack(const float* a, const float* b, void* pa, void* pb, int nb,
                int M, int N, int K, int Kp, const Fmt& f, const RowFmts& rf,
                unsigned fmask, cudaStream_t s) {
  constexpr int bke = 128 / sizeof(T);
  if (pa == nullptr || pb == nullptr || Kp < K || Kp < bke || Kp % bke ||
      nb > 65535)
    return (int)cudaErrorInvalidValue;
  const int k_tiles = Kp / PACK_K;
  const int a_blocks = cdiv(M, PACK_R) * k_tiles;
  const int b_blocks = cdiv(N, PACK_R) * k_tiles;
  qgemm_pack_kernel<T><<<dim3(a_blocks + b_blocks, nb), 256, 0, s>>>(
      a, b, static_cast<T*>(pa), static_cast<T*>(pb), M, N, K, Kp, a_blocks,
      f, rf, fmask);
  return (int)cudaGetLastError();
}

template <int ROUTE, typename T>
int launch_tensor_cores(const float* a, const float* b, float* c, void* pa,
                        void* pb, int nb, int M, int N, int K, int Kp, int bk,
                        const Fmt& f, const RowFmts& rf, unsigned fmask,
                        int chop_out, cudaStream_t s) {
  constexpr int esize = sizeof(T), bke = 128 / esize;
  const int rc = launch_pack<T>(a, b, pa, pb, nb, M, N, K, Kp, f, rf, fmask,
                                s);
  if (rc != 0) return rc;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType type =
      ROUTE == ROUTE_BF16  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : ROUTE == ROUTE_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMap *map_a = nullptr, *map_b = nullptr;
  CUresult r = cached_map(encode, &map_a, type, esize, pa, nb * M, Kp);
  if (r == CUDA_SUCCESS)
    r = cached_map(encode, &map_b, type, esize, pb, nb * N, Kp);
  if (r != CUDA_SUCCESS) return DRIVER_ERROR + (int)r;

  const int nk = Kp / bke;
  const int tpb = (bk < K && bk % bke == 0) ? bk / bke : nk;
  static int dev_sms[64];
  int sms = 0;
  const cudaError_t err = prepare(
      reinterpret_cast<const void*>(qgemm_wgmma_kernel<ROUTE>), TC_SMEM,
      dev_sms, &sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = nb * cdiv(M, TC_BM) * cdiv(N, TC_BN);
  qgemm_wgmma_kernel<ROUTE><<<tiles < sms ? tiles : sms, TC_THREADS, TC_SMEM,
                              s>>>(*map_a, *map_b, c, M, N, nk, tpb, f,
                                   chop_out, nb, rf, fmask);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FFMA GEMM: register-tiled SIMT, cp.async double buffering.
// ---------------------------------------------------------------------------

constexpr int FM_BM = 128, FM_BN = 128, FM_BK = 16;
constexpr int FM_LDA = FM_BM + 4;          // A^T rows, padded, 16-byte aligned
constexpr int FM_A = FM_BK * FM_LDA;       // floats of one A stage
constexpr int FM_B = FM_BK * FM_BN;        // floats of one B stage
constexpr int FM_SMEM = (2 * (FM_A + FM_B) + 64 * 256) * 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Thread tid copies elements tid + 256 i (i < 8) of each K tile: of A
// (128 rows x 16 k, read along k) row e / 16 and k e % 16, stored
// transposed; of B (16 k x 128 columns) k e / 128 and column e % 128.
__global__ void __launch_bounds__(256, 2)
    qgemm_ffma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K, int nk,
                      int tpb, Fmt f, int chop_in, int chop_out, RowFmts rf,
                      unsigned fmask) {
  const long long q = blockIdx.z;
  if (!batch_row(rf, fmask, q, f)) return;
  if (rf.ids != nullptr) chop_in = !(f.t >= 24 && f.emin <= -126);
  A += q * M * K;
  B += q * K * N;
  C += q * M * N;
  extern __shared__ float4 fm_smem[];
  float* As = reinterpret_cast<float*>(fm_smem);  // [2][FM_BK][FM_LDA]
  float* Bs = As + 2 * FM_A;                      // [2][FM_BK][FM_BN]
  float* accs = Bs + 2 * FM_B;  // [64][256]: each thread's accumulator
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FM_BM, n0 = blockIdx.x * FM_BN;

  auto load = [&](int kt, int buf) {
    if (kt < nk) {
      const int k0 = kt * FM_BK;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + 256 * i, r = e >> 4, kk = e & 15;
        const bool ok = m0 + r < M && k0 + kk < K;
        cp_async4(As + buf * FM_A + kk * FM_LDA + r,
                  ok ? A + (size_t)(m0 + r) * K + k0 + kk : A, ok);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + 256 * i, kk = e >> 7, cc = e & 127;
        const bool ok = k0 + kk < K && n0 + cc < N;
        cp_async4(Bs + buf * FM_B + kk * FM_BN + cc,
                  ok ? B + (size_t)(k0 + kk) * N + n0 + cc : B, ok);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < 64; ++s) accs[s * 256 + tid] = 0.0f;
  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;

  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    load(kt + 1, buf ^ 1);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    float* a_s = As + buf * FM_A;
    float* b_s = Bs + buf * FM_B;
    if (chop_in) {  // this thread's own copies are visible to it now
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + 256 * i;
        float* pa = a_s + (e & 15) * FM_LDA + (e >> 4);
        float* pb = b_s + (e >> 7) * FM_BN + (e & 127);
        *pa = chop(*pa, f);
        *pb = chop(*pb, f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FM_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * FM_LDA + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * FM_LDA + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * FM_BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + kk * FM_BN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = __fmaf_rn(a[i], b[j], part[i][j]);
    }
    if (kt % tpb == tpb - 1 || kt == nk - 1) {  // end of a K block
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* p = accs + (i * 8 + j) * 256 + tid;
          *p = __fadd_rn(*p, part[i][j]);
          part[i][j] = 0.0f;
        }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // Rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = accs[(i * 8 + 4 * h + j) * 256 + tid];
        if (chop_out) v[j] = chop(v[j], f);
      }
      float* p = C + (size_t)row * N + col;
      if (col + 3 < N && (N & 3) == 0) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) p[j] = v[j];
      }
    }
  }
}

int launch_ffma(const float* a, const float* b, float* c, int nb, int M,
                int N, int K, int bk, const Fmt& f, const RowFmts& rf,
                unsigned fmask, int chop_out, cudaStream_t s) {
  const int nk = cdiv(K, FM_BK);
  const int tpb = (bk < K && bk % FM_BK == 0) ? bk / FM_BK : (nk > 0 ? nk : 1);
  // chop_f32 is the identity on float32 for t >= 24 and emin <= -126
  // (with ids, each block decides for its row).
  const int chop_in = !(f.t >= 24 && f.emin <= -126);
  if (nb > 65535) return (int)cudaErrorInvalidValue;
  static int dev_sms[64];
  const cudaError_t err = prepare(
      reinterpret_cast<const void*>(qgemm_ffma_kernel), FM_SMEM, dev_sms,
      nullptr);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(N, FM_BN), cdiv(M, FM_BM), nb);
  qgemm_ffma_kernel<<<grid, 256, FM_SMEM, s>>>(a, b, c, M, N, K, nk, tpb, f,
                                                chop_in, chop_out, rf, fmask);
  return (int)cudaGetLastError();
}

}  // namespace

// C (B, M, N) = chop?(chop(A) @ chop(B)) for float32 A (B, M, K) and B
// (B, K, N), contiguous, summed in K blocks of bk (bk >= K: one block).
// route: ROUTE_FFMA, or a tensor-core route whose operand scratch pa
// (B M, Kp) and pb (B N, Kp) the caller allocated in the route's type
// (bf16, fp16, float32 for tf32), Kp >= K a multiple of 128 bytes of that
// type. ids: null (every row in the format t, emin, xmax_bits, saturate)
// or one int32 id a row (device) into `table` (host, chop_core.cuh
// `FmtRow` x NFMT), the launch taking the rows whose id is in fmask.
// Every launch goes on `stream`; returns the first CUDA error
// (DRIVER_ERROR + CUresult when a tensor map cannot be encoded), 0 when
// all launched.
extern "C" int repro_qgemm(const float* a, const float* b, float* c, void* pa,
                           void* pb, int nb, int M, int N, int K, int Kp,
                           int bk, int t, int emin, unsigned xmax_bits,
                           int saturate, const void* ids, const void* table,
                           unsigned fmask, int chop_out, int route,
                           void* stream) {
  if (bk < 1 || M < 0 || N < 0 || K < 0 || nb < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0 || nb == 0) return 0;
  const Fmt f{t, emin, xmax_bits, saturate};
  const RowFmts rf = row_fmts(ids, table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case ROUTE_FFMA:
      return launch_ffma(a, b, c, nb, M, N, K, bk, f, rf, fmask, chop_out, s);
    case ROUTE_BF16:
      return launch_tensor_cores<ROUTE_BF16, __nv_bfloat16>(
          a, b, c, pa, pb, nb, M, N, K, Kp, bk, f, rf, fmask, chop_out, s);
    case ROUTE_F16:
      return launch_tensor_cores<ROUTE_F16, __half>(
          a, b, c, pa, pb, nb, M, N, K, Kp, bk, f, rf, fmask, chop_out, s);
    case ROUTE_TF32:
      return launch_tensor_cores<ROUTE_TF32, float>(
          a, b, c, pa, pb, nb, M, N, K, Kp, bk, f, rf, fmask, chop_out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The pack kernel alone, for the card checks that hold it against its
// plain version (`ref.pack_ref`): pa and pb as `repro_qgemm` takes them
// for one product, route a tensor-core route.
extern "C" int repro_qgemm_pack(const float* a, const float* b, void* pa,
                                void* pb, int M, int N, int K, int Kp, int t,
                                int emin, unsigned xmax_bits, int saturate,
                                int route, void* stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 && N == 0) return 0;
  const Fmt f{t, emin, xmax_bits, saturate};
  const RowFmts rf = row_fmts(nullptr, nullptr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case ROUTE_BF16:
      return launch_pack<__nv_bfloat16>(a, b, pa, pb, 1, M, N, K, Kp, f, rf,
                                        0u, s);
    case ROUTE_F16:
      return launch_pack<__half>(a, b, pa, pb, 1, M, N, K, Kp, f, rf, 0u, s);
    case ROUTE_TF32:
      return launch_pack<float>(a, b, pa, pb, 1, M, N, K, Kp, f, rf, 0u, s);
  }
  return (int)cudaErrorInvalidValue;
}
