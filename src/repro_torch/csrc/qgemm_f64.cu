// Chopped GEMM on the float64 carrier: C = chop?( chop(A) @ chop(B) ),
// float64 accumulation, one K block.
//
// Replaces: repro/kernels/qmatmul/qmatmul.py::qmatmul_pallas as
// repro/kernels/qmatmul/ops.py::qgemm_op reaches it on the solver path, the
// blocked LU's trailing update (n_pad - k1, 64) x (64, n_pad - k1), for
// the float64 carrier. The TPU kernel takes float32 only; on float64 the
// JAX package's backend computes the same update as `qgemm_ref`: the
// operands rounded, one float64 `jnp.dot`, the result rounded. So on this
// carrier every format id sums in float64, and none can take csrc/qgemm.cu's
// tensor-core routes, whose wgmma accumulates in float32. This kernel is
// the one route of every id (`kernels.qmatmul.ROUTES_F64`, "dfma").
//
// qgemm_f64_kernel: a 64 x 64 output tile per block of 256 threads, each
// thread 4 x 4 outputs at rows ty + 16 i and columns tx + 16 j (so that a
// warp's reads of a B row and its stores are 16 consecutive doubles). A
// and B are staged through shared memory in K tiles of 16, rounded to the
// format as they arrive (chop_f64; zero past M, N and K), A transposed
// with one double of padding. Each output is one chain of __fma_rn in
// increasing k: one rounding per term, the float64 summation that the
// reference's dot leaves to the library, held to the order tolerance
// (DESIGN.md §6.2; `kernels.qmatmul.checks.held` on float64). The result
// is rounded once more when chop_out.
//
// Batches (the solver's batched program): B products (B, M, K) x (B, K,
// N), contiguous, the grid's z over the rows of the batch, each row in the
// format of its own id (`ids` into the launch's format table,
// chop_core.cuh `RowFmts`), or every row in the launch's one format when
// there are no ids.
//
// Bound on the H100 at the trailing update (448, 64) x (64, 448): 2.57e7
// operations, 0.38 us at the float64 tensor cores' 67 TFLOP/s (0.77 us at
// the 34 TFLOP/s of the float64 FMA units this kernel runs on); 2.06 MB of
// float64 operands and output, 0.61 us at 3.35 TB/s. Both are under the
// launch's own latency: a simple kernel that is right comes first.
#include "chop_core.cuh"

namespace {

constexpr int DG_BM = 64, DG_BN = 64, DG_BK = 16, DG_THREADS = 256;

__global__ void __launch_bounds__(DG_THREADS)
    qgemm_f64_kernel(const double* __restrict__ A,
                     const double* __restrict__ B, double* __restrict__ C,
                     int M, int N, int K, int t, int emin, uint64_t xmax_bits,
                     int saturate, RowFmts rf, int chop_out) {
  const long long q = blockIdx.z;
  A += q * M * K;
  B += q * K * N;
  C += q * M * N;
  row_format(rf, q, t, emin, xmax_bits, saturate);
  __shared__ double As[DG_BK][DG_BM + 1];  // A^T tile
  __shared__ double Bs[DG_BK][DG_BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * DG_BM, n0 = blockIdx.x * DG_BN;
  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
  for (int k0 = 0; k0 < K; k0 += DG_BK) {
#pragma unroll
    for (int q = 0; q < DG_BM * DG_BK / DG_THREADS; ++q) {
      const int e = threadIdx.x + DG_THREADS * q;
      const int r = e / DG_BK, kk = e % DG_BK;
      const int gr = m0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K)
                      ? chop_f64(A[(size_t)gr * K + gk], t, emin, xmax_bits,
                                 saturate)
                      : 0.0;
    }
#pragma unroll
    for (int q = 0; q < DG_BN * DG_BK / DG_THREADS; ++q) {
      const int e = threadIdx.x + DG_THREADS * q;
      const int kk = e / DG_BN, c = e % DG_BN;
      const int gk = k0 + kk, gc = n0 + c;
      Bs[kk][c] = (gk < K && gc < N)
                      ? chop_f64(B[(size_t)gk * N + gc], t, emin, xmax_bits,
                                 saturate)
                      : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DG_BK; ++kk) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fma_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx + 16 * j;
      if (gr < M && gc < N)
        C[(size_t)gr * N + gc] =
            chop_out ? chop_f64(acc[i][j], t, emin, xmax_bits, saturate)
                     : acc[i][j];
    }
  }
}

}  // namespace

// a (B, M, K), b (B, K, N), c (B, M, N), all row-major float64. xmax_bits
// is the format's xmax as a float64 pattern. ids: null (every row in that
// format) or one int32 id a row (device) into `table` (host,
// chop_core.cuh `FmtRow` x NFMT).
extern "C" int repro_qgemm_f64(const double* a, const double* b, double* c,
                               int nb, int M, int N, int K, int t, int emin,
                               unsigned long long xmax_bits, int saturate,
                               const void* ids, const void* table,
                               int chop_out, void* stream) {
  if (M <= 0 || N <= 0 || nb <= 0) return 0;
  if (K < 0 || nb > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + DG_BN - 1) / DG_BN, (M + DG_BM - 1) / DG_BM, nb);
  qgemm_f64_kernel<<<grid, DG_THREADS, 0, (cudaStream_t)stream>>>(
      a, b, c, M, N, K, t, emin, xmax_bits, saturate, row_fmts(ids, table),
      chop_out);
  return (int)cudaGetLastError();
}
