// Blocked triangular substitution on a combined LU factor, in emulated
// precision: forward (unit-lower, strictly-lower triangle read) or
// backward (upper triangle incl. the diagonal) in one launch.
//
// Replaces: repro/kernels/trisolve/trisolve.py::trisolve_pallas (body
// repro/kernels/trisolve/ref.py::_trisolve_core), the TPU kernel that holds
// the whole factor in VMEM (up to MAX_N = 1024) and runs the blocked solve
// in one grid step.
//
// Bound on the H100: neither bytes nor operations. The factor at
// n_pad = 512 is 1 MiB (0.3 us at 3.35 TB/s) and the work is n^2 multiply-
// adds, but the diagonal blocks are a chain of n dependent rows, each a
// rounded 128-wide dot reduced by a fixed tree; that chain of latencies
// sets the time.
//
// Design: one thread block (8 warps) per solve. The float32 factor at
// n_pad = 512 does not fit in shared memory (227 KB), so it streams from
// device memory (it stays in L2 between the GMRES iterations); only the
// solution vector, the current diagonal block and small per-warp buffers
// live in shared memory. For each block row, in the order of
// _trisolve_core:
//   * off-diagonal tiles: each warp takes rows; per tile the row's products
//     are rounded and summed by the fixed halving tree over the block
//     width (warp_tree_sum), then added to the row's carrier accumulator in
//     increasing tile order; the rhs gets one rounding on the subtraction;
//   * the diagonal block is rounded into shared memory, masked to the
//     triangle, and one warp runs the strict row loop: masked rounded
//     products, tree sum, one rounding on the subtraction and, for the
//     upper solve, a second rounding after the division.
// Rows and columns past n read as the identity and the rhs as 0: this is
// the identity padding of ref.pad_unit without a padded copy. Multiplies,
// adds, subtractions and divisions are the _rn intrinsics, never
// contracted, so the result is bit-exact against the plain torch version.
#include "chop_core.cuh"

constexpr int TS_WARPS = 8;

__device__ __forceinline__ float lu_at(const float* __restrict__ Lu, int n,
                                       int r, int c) {
  if (r < n && c < n) return Lu[(size_t)r * n + c];
  return r == c ? 1.0f : 0.0f;
}

__global__ void trisolve_kernel(const float* __restrict__ Lu,
                                const float* __restrict__ b,
                                float* __restrict__ y, int n, int n_pad,
                                int block, int lower, int t, int emin,
                                uint32_t xmax_bits, int saturate) {
  extern __shared__ float smem[];
  float* ys = smem;                    // solution, n_pad
  float* diag = ys + n_pad;            // diagonal block, block * block
  float* tb = diag + block * block;    // rhs after the off-diagonal tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wbuf = tb + block + warp * block;  // this warp's tree buffer
  const int nb = n_pad / block;
#define CHOP(v) chop_f32((v), t, emin, xmax_bits, saturate)

  for (int bi = 0; bi < nb; ++bi) {
    const int i = lower ? bi : nb - 1 - bi;
    const int r0 = i * block;
    const int jlo = lower ? 0 : i + 1, jhi = lower ? i : nb;

    for (int r = warp; r < block; r += TS_WARPS) {
      const int gr = r0 + r;
      float acc = 0.0f;
      for (int j = jlo; j < jhi; ++j) {
        const int c0 = j * block;
        __syncwarp();
        for (int c = lane; c < block; c += 32)
          wbuf[c] = CHOP(__fmul_rn(CHOP(lu_at(Lu, n, gr, c0 + c)),
                                   ys[c0 + c]));
        __syncwarp();
        acc = __fadd_rn(acc, warp_tree_sum(wbuf, block, lane));
      }
      if (lane == 0) {
        const float rhs = CHOP(gr < n ? b[gr] : 0.0f);
        tb[r] = CHOP(__fsub_rn(rhs, acc));
      }
    }

    for (int e = threadIdx.x; e < block * block; e += blockDim.x) {
      const int r = e / block, c = e % block;
      const bool keep = lower ? (r > c) : (r <= c);
      diag[e] = keep ? CHOP(lu_at(Lu, n, r0 + r, r0 + c)) : 0.0f;
    }
    __syncthreads();

    if (warp == 0) {
      float* yb = ys + r0;
      for (int rloc = 0; rloc < block; ++rloc) {
        const int r = lower ? rloc : block - 1 - rloc;
        const float* drow = diag + (size_t)r * block;
        for (int c = lane; c < block; c += 32) {
          const bool m = lower ? (c < r) : (c > r);
          wbuf[c] = m ? CHOP(__fmul_rn(drow[c], yb[c])) : 0.0f;
        }
        __syncwarp();
        const float s = warp_tree_sum(wbuf, block, lane);
        if (lane == 0) {
          float val = CHOP(__fsub_rn(tb[r], s));
          if (!lower) {
            const float d = drow[r];
            val = CHOP(__fdiv_rn(val, d == 0.0f ? 1.0f : d));
          }
          yb[r] = val;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
#undef CHOP
  for (int k = threadIdx.x; k < n; k += blockDim.x) y[k] = ys[k];
}

extern "C" int repro_trisolve_f32(const float* lu, const float* b, float* y,
                                  int n, int block, int lower, int t,
                                  int emin, unsigned xmax_bits, int saturate,
                                  void* stream) {
  if (n <= 0) return 0;
  const int n_pad = (n + block - 1) / block * block;
  const size_t smem =
      (size_t)(n_pad + block * block + block + TS_WARPS * block) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        trisolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  trisolve_kernel<<<1, 32 * TS_WARPS, smem, (cudaStream_t)stream>>>(
      lu, b, y, n, n_pad, block, lower, t, emin, xmax_bits, saturate);
  return (int)cudaGetLastError();
}
