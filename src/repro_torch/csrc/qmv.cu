// Fused chopped matvec: out[r] = chop?( tree_sum_k( chop(A[r,k]) * chop(v[k]) ) ).
//
// Replaces: repro/kernels/qmatmul/qmatmul.py::qmv_pallas (body _qmv_kernel),
// the TPU kernel that rounds a (bm, Kp) row block in VMEM and row-sums the
// products over the lane-padded K.
//
// Bound on the H100: device-memory bytes in principle (the matrix is read
// once, 4 bytes per element, for one multiply and one add: 1 MiB at
// n = 512, 0.3 us). At the solver's sizes (M, K = 128..512) the time is
// latency instead: one round trip to memory, the chops (some 30 integer
// operations per element) and the fixed reduction tree of log2(Kp)
// dependent adds.
//
// Two routes, chosen by the wrapper from Kp (`kernels.qmatmul.QMV_ROUTES`):
//   * "shfl" (qmv_shfl_kernel), Kp = 128..1024. Each block chops v once
//     into shared memory; each warp takes one row. Lane l loads the row's
//     elements l + 32 j (coalesced 4-byte loads, all J = Kp / 32 in flight
//     before the block waits for v), rounds them, multiplies, and reduces
//     them in registers: the in-lane levels while the width is an even
//     multiple of 32, then the xor butterfly (Kp = 128 * 2^k), or, where
//     the in-lane levels stop at an odd multiple of 32 (Kp = 384 stops at
//     96, 640 at 160), the rest of the tree in shared memory
//     (warp_tree_sum). Both keep `tree_sum`'s order (chop_core.cuh).
//   * "smem" (qmv_smem_kernel), any Kp: one warp per row, four rows per
//     block; every warp rounds v for its row and writes the row's products
//     to shared memory, where warp_tree_sum reduces them. The wrapper
//     takes it for Kp outside "shfl"'s range (K = 0, K > 1024).
// Columns k >= K are the zero padding of `qmv_ref`: products exactly +0,
// added like the others (skipping them would turn a -0 sum into +0 and
// back). Multiplies and adds are __fmul_rn / __fadd_rn, never contracted,
// so both routes are bit-exact against the plain torch version.
//
// Batches (the solver's batched program): B matvecs in one launch, A
// (B, M, K) with row stride lda and batch stride a_b, v (B, K) with batch
// stride v_b, out (B, M); the grid's y is the row of the batch, and each
// row is rounded to the format of its own id (`ids` into the launch's
// format table, chop_core.cuh `RowFmts`), or every row to the launch's
// one format when there are no ids.
//
// Carriers: both kernels are templates on the carrier, instantiated on
// float (`repro_qmv_f32`) and double (`repro_qmv_f64`, chop_f64, __dmul_rn
// / __dadd_rn, double shuffles and double tiles): the float64 carrier runs
// the same tree in the same order, bit for bit against the plain version
// on float64. Its bound doubles with its bytes (8 a matrix element).
#include "chop_core.cuh"

namespace {

enum QmvRoute { QMV_SMEM = 0, QMV_SHFL = 1 };

constexpr int QMV_WARPS = 4;       // rows (warps) per block on "shfl"
constexpr int QMV_SMEM_ROWS = 4;  // rows (warps) per block on "smem"

#define CHOP(x) chop_t((x), t, emin, xmax_bits, saturate)

// The batch row of the block (the grid's y): its operands and its format.
#define BATCH_ROW()                                        \
  const long long q = blockIdx.y;                          \
  a += q * a_b;                                            \
  v += q * v_b;                                            \
  out += q * M;                                            \
  row_format(rf, q, t, emin, xmax_bits, saturate)

template <int J, typename T>
__global__ void __launch_bounds__(32 * QMV_WARPS)
    qmv_shfl_kernel(const T* __restrict__ a, const T* __restrict__ v,
                    T* __restrict__ out, int M, int K, int lda,
                    long long a_b, long long v_b, int t, int emin,
                    uint64_t xmax_bits, int saturate, RowFmts rf,
                    int chop_out) {
  BATCH_ROW();
  constexpr int Kp = 32 * J;
  constexpr int R = odd_part(J);  // registers left after the in-lane levels
  extern __shared__ __align__(16) unsigned char qmv_smem[];
  T* vc = reinterpret_cast<T*>(qmv_smem);  // chop(v), zero past K: Kp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * QMV_WARPS + warp;
  // The row's loads go out first: they do not wait for v.
  T x[J];
  const T* arow = a + (size_t)row * lda;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = lane + 32 * j;
    x[j] = (row < M && k < K) ? arow[k] : T(0);
  }
  for (int k = threadIdx.x; k < Kp; k += blockDim.x)
    vc[k] = k < K ? CHOP(v[k]) : T(0);
  __syncthreads();
  if (row >= M) return;  // whole warp leaves together
  T p[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = lane + 32 * j;
    p[j] = keep_or_zero(mul_rn(CHOP(x[j]), vc[k]), k < K);
  }
  fold_in_lane<J>(p);
  T s;
  if constexpr (R == 1) {
    s = butterfly(p[0]);
  } else {
    T* buf = vc + Kp + warp * 32 * R;
#pragma unroll
    for (int j = 0; j < R; ++j) buf[lane + 32 * j] = p[j];
    __syncwarp();
    s = warp_tree_sum(buf, 32 * R, lane);
  }
  if (lane == 0) out[row] = chop_out ? CHOP(s) : s;
}

template <typename T>
__global__ void qmv_smem_kernel(const T* __restrict__ a,
                                const T* __restrict__ v,
                                T* __restrict__ out, int M, int K, int Kp,
                                int lda, long long a_b, long long v_b, int t,
                                int emin, uint64_t xmax_bits, int saturate,
                                RowFmts rf, int chop_out) {
  BATCH_ROW();
  extern __shared__ __align__(16) unsigned char qmv_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * QMV_SMEM_ROWS + warp;
  if (row >= M) return;  // whole warp leaves together
  T* buf = reinterpret_cast<T*>(qmv_smem) + (size_t)warp * Kp;
  const T* arow = a + (size_t)row * lda;
  for (int k = lane; k < Kp; k += 32) {
    T p = T(0);
    if (k < K) p = mul_rn(CHOP(arow[k]), CHOP(v[k]));
    buf[k] = p;
  }
  __syncwarp();
  T s = warp_tree_sum(buf, Kp, lane);
  if (lane == 0) out[row] = chop_out ? CHOP(s) : s;
}

#undef BATCH_ROW
#undef CHOP

template <int J, typename T>
int launch_shfl(const T* a, const T* v, T* out, int B, int M, int K, int lda,
                long long a_b, long long v_b, int t, int emin,
                uint64_t xmax_bits, int saturate, const RowFmts& rf,
                int chop_out, cudaStream_t stream) {
  const size_t smem =
      (size_t)(32 * J + (odd_part(J) > 1 ? QMV_WARPS * 32 * odd_part(J) : 0))
      * sizeof(T);
  const int blocks = (M + QMV_WARPS - 1) / QMV_WARPS;
  qmv_shfl_kernel<J, T><<<dim3(blocks, B), 32 * QMV_WARPS, smem, stream>>>(
      a, v, out, M, K, lda, a_b, v_b, t, emin, xmax_bits, saturate, rf,
      chop_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_qmv(const T* a, const T* v, T* out, int B, int M, int K, int lda,
               long long a_b, long long v_b, int t, int emin,
               uint64_t xmax_bits, int saturate, const void* ids,
               const void* table, int chop_out, int route, void* stream) {
  if (M <= 0 || B <= 0) return 0;
  if (K < 0 || lda < K || B > 65535) return (int)cudaErrorInvalidValue;
  const int Kp = (K + 127) / 128 * 128;
  const RowFmts rf = row_fmts(ids, table);
  cudaStream_t s = (cudaStream_t)stream;
  if (route == QMV_SHFL) {
    switch (Kp / 32) {
#define CASE(J)                                                            \
  case J:                                                                  \
    return launch_shfl<J, T>(a, v, out, B, M, K, lda, a_b, v_b, t, emin,   \
                             xmax_bits, saturate, rf, chop_out, s);
      CASE(4) CASE(8) CASE(12) CASE(16) CASE(20) CASE(24) CASE(28) CASE(32)
#undef CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != QMV_SMEM) return (int)cudaErrorInvalidValue;
  static bool raised[64] = {};
  const size_t smem = (size_t)QMV_SMEM_ROWS * (Kp > 0 ? Kp : 1) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = allow_smem(qmv_smem_kernel<T>, raised);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (M + QMV_SMEM_ROWS - 1) / QMV_SMEM_ROWS;
  qmv_smem_kernel<T><<<dim3(blocks, B), 32 * QMV_SMEM_ROWS, smem, s>>>(
      a, v, out, M, K, Kp, lda, a_b, v_b, t, emin, xmax_bits, saturate, rf,
      chop_out);
  return (int)cudaGetLastError();
}

}  // namespace

// B matvecs: a (B, M, K) with row stride lda (>= K) and batch stride a_b,
// v (B, K) with batch stride v_b, out (B, M) contiguous, in elements.
// route: QMV_SHFL (Kp = 128..1024) or QMV_SMEM (any Kp). ids: null (every
// row in the format t, emin, xmax_bits, saturate) or one int32 id a row
// (device) into `table` (host, chop_core.cuh `FmtRow` x NFMT).
extern "C" int repro_qmv_f32(const float* a, const float* v, float* out,
                             int B, int M, int K, int lda, long long a_b,
                             long long v_b, int t, int emin,
                             unsigned xmax_bits, int saturate,
                             const void* ids, const void* table,
                             int chop_out, int route, void* stream) {
  return launch_qmv<float>(a, v, out, B, M, K, lda, a_b, v_b, t, emin,
                           xmax_bits, saturate, ids, table, chop_out, route,
                           stream);
}

// The float64 carrier: xmax_bits is the format's xmax as a float64
// pattern.
extern "C" int repro_qmv_f64(const double* a, const double* v, double* out,
                             int B, int M, int K, int lda, long long a_b,
                             long long v_b, int t, int emin,
                             unsigned long long xmax_bits, int saturate,
                             const void* ids, const void* table,
                             int chop_out, int route, void* stream) {
  return launch_qmv<double>(a, v, out, B, M, K, lda, a_b, v_b, t, emin,
                            xmax_bits, saturate, ids, table, chop_out, route,
                            stream);
}
