// Fused chopped matvec: out[r] = chop?( tree_sum_k( chop(A[r,k]) * chop(v[k]) ) ).
//
// Replaces: repro/kernels/qmatmul/qmatmul.py::qmv_pallas (body _qmv_kernel),
// the TPU kernel that rounds a (bm, Kp) row block in VMEM and row-sums the
// products over the lane-padded K.
//
// Bound on the H100: device-memory bytes in principle (the matrix is read
// once, 4 bytes per element, for one multiply and one add: 1 MiB at
// n = 512, 0.3 us). At the solver's sizes the time is latency instead:
// each row's fixed reduction tree is log2(Kp) dependent levels through
// shared memory.
//
// Design: one warp per row, four rows per block. The warp writes the
// row's products to its own Kp-float buffer in shared memory and reduces
// them by the fixed halving tree of `tree_sum` (warp_tree_sum), odd
// widths included (Kp = 384 halves to 3): a shuffle or library reduction
// would add in another order. Columns k >= K are the zero padding of
// `qmv_ref` (products exactly +0). Multiplies and adds are __fmul_rn /
// __fadd_rn, never contracted, so the result is bit-exact against the
// plain torch version.
#include "chop_core.cuh"

constexpr int QMV_ROWS = 4;  // warps (rows) per block

__global__ void qmv_kernel(const float* __restrict__ a,
                           const float* __restrict__ v,
                           float* __restrict__ out, int M, int K, int Kp,
                           int lda, int t, int emin, uint32_t xmax_bits,
                           int saturate, int chop_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * QMV_ROWS + warp;
  if (row >= M) return;  // whole warp leaves together
  float* buf = smem + (size_t)warp * Kp;
  const float* arow = a + (size_t)row * lda;
  for (int k = lane; k < Kp; k += 32) {
    float p = 0.0f;
    if (k < K)
      p = __fmul_rn(chop_f32(arow[k], t, emin, xmax_bits, saturate),
                    chop_f32(v[k], t, emin, xmax_bits, saturate));
    buf[k] = p;
  }
  __syncwarp();
  float s = warp_tree_sum(buf, Kp, lane);
  if (lane == 0) {
    if (chop_out) s = chop_f32(s, t, emin, xmax_bits, saturate);
    out[row] = s;
  }
}

extern "C" int repro_qmv_f32(const float* a, const float* v, float* out,
                             int M, int K, int lda, int t, int emin,
                             unsigned xmax_bits, int saturate, int chop_out,
                             void* stream) {
  if (M <= 0) return 0;
  const int Kp = (K + 127) / 128 * 128;
  const size_t smem = (size_t)QMV_ROWS * (Kp > 0 ? Kp : 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        qmv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (M + QMV_ROWS - 1) / QMV_ROWS;
  qmv_kernel<<<blocks, 32 * QMV_ROWS, smem, (cudaStream_t)stream>>>(
      a, v, out, M, K, Kp, lda, t, emin, xmax_bits, saturate, chop_out);
  return (int)cudaGetLastError();
}
