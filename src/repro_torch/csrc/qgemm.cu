// Chopped GEMM: C = chop?( chop(A) @ chop(B) ), float32 accumulation,
// summed in blocks of bk along K.
//
// Replaces: repro/kernels/qmatmul/qmatmul.py::qmatmul_pallas (body
// _qmatmul_kernel), as both of its callers reach it:
//   * repro/kernels/qmatmul/ops.py::qgemm_op, one K block (bk = Kp <= 512),
//     operands rounded in VMEM, f32 MXU dot, output rounded. On the solver
//     path it is the blocked-LU trailing update, (n_pad - k1, 64) x
//     (64, n_pad - k1). Here: bk >= K, one block.
//   * repro/kernels/qmatmul/ops.py::qmatmul_op, 256^3 blocks with a float32
//     scratch accumulator carried across the K grid axis
//     (acc_ref[...] += jnp.dot(...)), any input dtype cast to float32,
//     optional output rounding. Here: a runtime bk, by default 256.
//
// Bound on the H100: at the solver's shapes (M = N <= 448, K = 64) the
// bytes (about 1 MB) and the float32 operations (about 26 MFLOP against
// 67 TFLOP/s without tensor cores) both come to well under a microsecond;
// with at most 49 blocks the card is mostly empty, and the K loop's
// latency decides the time. At an LM's FFN width, (4096, 3584) x
// (3584, 14336), it is 4.2e11 float32 operations, 6.3 ms at 67 TFLOP/s,
// against 0.5 GB of traffic (0.15 ms): bound by operations. This kernel
// spends two instructions per term (a multiply and an add, no FMA) and
// rounds every operand as it stages it, so it cannot come closer than
// about twice that bound.
//
// Design: a tiled SIMT GEMM, 64x64 output tile per block of 256 threads,
// each thread 4x4 outputs strided by 16 so that shared-memory reads do
// not conflict. A and B are rounded to the format as they are staged into
// shared memory (BK = 16 per step). No tensor cores and no TF32: both
// would round the operands again and change what is computed. Every
// multiply and add is __fmul_rn / __fadd_rn. Within a K block of bk the
// products are summed in increasing k into a per-thread partial, which is
// added into the accumulator at the end of the block: the order of the
// Pallas body and of the plain `qmatmul_ref_blocked`. The reference's dot
// leaves its order within a block to the library, so this kernel is held
// to a tolerance, not to bits. The reference pads M, N and K with zeros to
// block multiples; padded K terms add an exact +0 (a partial that starts
// at +0 never becomes -0) and are not iterated, and the ragged edges are
// handled by index arithmetic, so no padded copy is made.
#include "chop_core.cuh"

constexpr int BM = 64, BN = 64, BK = 16;

__global__ void qgemm_kernel(const float* __restrict__ A,
                             const float* __restrict__ B,
                             float* __restrict__ C, int M, int N, int K,
                             int bk, int t, int emin, uint32_t xmax_bits,
                             int saturate, int chop_out) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kb0 = 0; kb0 < K; kb0 += bk) {
    const int kb1 = min(K, kb0 + bk);  // this K block is [kb0, kb1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
    for (int k0 = kb0; k0 < kb1; k0 += BK) {
      for (int e = tid; e < BM * BK; e += 256) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        const float v = (gr < M && gk < kb1) ? A[(size_t)gr * K + gk] : 0.0f;
        As[kk][r] = chop_f32(v, t, emin, xmax_bits, saturate);
      }
      for (int e = tid; e < BK * BN; e += 256) {
        const int kk = e / BN, c = e % BN;
        const int gk = k0 + kk, gc = col0 + c;
        const float v = (gk < kb1 && gc < N) ? B[(size_t)gk * N + gc] : 0.0f;
        Bs[kk][c] = chop_f32(v, t, emin, xmax_bits, saturate);
      }
      __syncthreads();
      const int kmax = min(BK, kb1 - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i][j] = __fadd_rn(part[i][j], __fmul_rn(a[i], b[j]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      float v = acc[i][j];
      if (chop_out) v = chop_f32(v, t, emin, xmax_bits, saturate);
      C[(size_t)r * N + c] = v;
    }
  }
}

// bk: the K block; bk >= K gives one block (qgemm_op), bk < K the
// K-blocked order of qmatmul_op. Returns a CUDA error code, or
// cudaErrorInvalidValue for bk < 1.
extern "C" int repro_qgemm_f32(const float* a, const float* b, float* c,
                               int M, int N, int K, int bk, int t, int emin,
                               unsigned xmax_bits, int saturate, int chop_out,
                               void* stream) {
  if (bk < 1) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      a, b, c, M, N, K, bk, t, emin, xmax_bits, saturate, chop_out);
  return (int)cudaGetLastError();
}
