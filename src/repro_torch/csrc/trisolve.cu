// Blocked triangular substitution on a combined LU factor, in emulated
// precision: forward (unit-lower, strictly-lower triangle read) or
// backward (upper triangle incl. the diagonal) in one launch.
//
// Replaces: repro/kernels/trisolve/trisolve.py::trisolve_pallas (body
// repro/kernels/trisolve/ref.py::_trisolve_core), the TPU kernel that holds
// the whole factor in VMEM (up to MAX_N = 1024) and runs the blocked solve
// in one grid step.
//
// What it computes, in the order of _trisolve_core, for each block row i
// (lower: i = 0, 1, ...; upper: i = nb - 1, ..., 0):
//   * each off-diagonal tile j (lower j < i, upper j > i, increasing j) is
//     a chopped matvec: products chop(chop(L[r, c]) * y[c]), each row
//     summed by the fixed halving tree over the block width, and added
//     to a carrier accumulator that starts at 0 (acc = ((0 + T_first) +
//     ...), not T_first: the leading 0 + turns a -0 into +0);
//   * t = chop(chop(b) - acc), one rounding;
//   * the diagonal block, rounded and masked to the triangle, is solved
//     row after row: the masked products (+0 where masked, and added),
//     the tree, one rounding on the subtraction and, for the upper solve,
//     a second after the division by the diagonal (1 where it is 0).
// Rows and columns past n read as the identity and the rhs as 0: the
// identity padding of ref.pad_unit without a padded copy. Multiplies,
// adds, subtractions and divisions are the _rn intrinsics, never
// contracted, so the result is bit-exact against the plain torch version.
//
// Bound on the H100: neither bytes nor operations. The factor at
// n_pad = 512 is 1 MiB (0.3 us at 3.35 TB/s) and the work n^2 multiply-
// adds; the diagonal blocks are a chain of n dependent rows, and in each
// only one product waits for the row before (the one with y[r - 1]): its
// chop, the log2(block) adds of the tree on its path, the subtraction's
// chop (and, upper, the division and its chop). That chain sets the time
// (`scripts/chain_bound.py` measures it).
//
// Two routes, chosen by the wrapper (`kernels.trisolve.ROUTES`):
//   * "shfl" (trisolve_shfl_kernel), block a power of two up to 128: one
//     block of 16 warps. Warp 0 runs each diagonal block's chain alone on
//     its scheduler: lane l holds y[c] for the block's columns c = l + 32 j
//     in registers and reads the rounded, masked diagonal block from
//     shared memory (conflict-free). Each row's tree is prepared a row
//     ahead, less its newest product: the products, the in-lane levels and
//     the xor butterfly, every lane recording the partner values it
//     receives. When the row before has given y[r - 1] (upper: y[r + 1]),
//     the lane that holds that column multiplies and rounds the one new
//     product and finishes the tree in the tree's own order, 2 in-lane and
//     5 recorded adds with no shuffle; one shuffle hands the sum to every
//     lane, and every lane rounds the subtraction (upper: and the division,
//     by `quotient` with 1 / d prepared in double) and so holds the new y.
//     The next row's products come before the hand-over and its butterfly
//     after it, all in one basic block, so that the compiler interleaves
//     the two rows (warps issue in order).
//     The 12 warps on the other three schedulers (warps 4, 8 and 12 share
//     warp 0's and stay idle) prepare block row i while the chain of the
//     block row before runs: they round and mask diagonal block i into the
//     second of two buffers (with 1 / d of its diagonal), sum every tile
//     that does not wait for that chain (all but j = i - 1, lower, or
//     j = i + 1, upper) into shared memory by the same register tree, and
//     load and round the first rows of the one that does. When the chain
//     hands over (named barrier 1), they finish that tile, fold the
//     accumulator in tile order and write t; the chain takes it on named
//     barrier 2.
//   * "smem" (trisolve_smem_kernel), any block: one block of 8 warps; the
//     off-diagonal tiles by all warps, then warp 0 alone runs the chain,
//     each row's products through a shared-memory tree (warp_tree_sum)
//     with a __syncwarp per level. The wrapper takes it for block widths
//     that are not a power of two.
#include "chop_core.cuh"

namespace {

enum TrisolveRoute { TS_SMEM = 0, TS_SHFL = 1 };

constexpr int TS_SMEM_WARPS = 8;
constexpr int TS_WARPS = 16;          // "shfl": warp 0 runs the chains
constexpr int TS_WORKERS = 12;        // the warps with warp % 4 != 0
constexpr int TS_SYNC = 32 * (1 + TS_WORKERS);  // threads at each barrier
constexpr int TS_RC = 4;              // rows a worker loads at once
constexpr int BAR_CHAIN_DONE = 1;     // chain -> workers: y of a block
constexpr int BAR_READY = 2;          // workers -> chain: t and diag

#define CHOP(v) chop_f32((v), t, emin, xmax_bits, saturate)

// Identity padding past n; the load is unconditional (its address
// clamped) so that loads of many entries can be in flight together.
__device__ __forceinline__ float lu_at(const float* __restrict__ Lu, int n,
                                       int r, int c) {
  const float v = Lu[(size_t)min(r, n - 1) * n + min(c, n - 1)];
  return (r < n && c < n) ? v : (r == c ? 1.0f : 0.0f);
}

// A chunk of a worker's rows of one tile, r = wi + TS_WORKERS (k0 + k),
// k < TS_RC: the rounded factor entries chop(L[r0 + r, c0 + c]) at
// c = lane + 32 j, all loads issued before any is used.
template <int J>
__device__ __forceinline__ void load_rows(float (&lt)[TS_RC][J],
                                          const float* __restrict__ Lu, int n,
                                          int r0, int c0, int wi, int k0,
                                          int lane, int t, int emin,
                                          uint32_t xmax_bits, int saturate) {
#pragma unroll
  for (int k = 0; k < TS_RC; ++k)
#pragma unroll
    for (int j = 0; j < J; ++j)
      lt[k][j] = lu_at(Lu, n, r0 + wi + TS_WORKERS * (k0 + k),
                       c0 + lane + 32 * j);
#pragma unroll
  for (int k = 0; k < TS_RC; ++k)
#pragma unroll
    for (int j = 0; j < J; ++j) lt[k][j] = CHOP(lt[k][j]);
}

// One tile row's sum over the block's columns c = lane + 32 j < W: the
// products chop(l * ys[c]), the in-lane levels and the butterfly. Every
// lane returns it.
template <int J>
__device__ __forceinline__ float tile_row(const float (&l)[J], const float* ys,
                                          int W, int lane, int t, int emin,
                                          uint32_t xmax_bits, int saturate) {
  float p[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    p[j] = keep_or_zero(CHOP(__fmul_rn(l[j], ys[min(c, W - 1)])), c < W);
  }
  fold_in_lane<J>(p);
  return butterfly(p[0], J > 1 ? 16 : W / 2);
}

// A row of the chain, ahead of time: its tree less its newest product (the
// column solved by the row before). Lane l's products, their in-lane pair
// sums, and the partner values its butterfly received, offset 16 first:
// what lane l would add to its own value. For the lane that holds the
// newest column these never include that column, so its tree is finished
// later from the new product in 2 + 5 dependent adds, without a shuffle.
template <int J>
struct Ahead {
  float P[J];       // products (0 where masked, and at the newest column)
  float Q[2];       // J = 4: the pair sums P0 + P2, P1 + P3
  float v;          // the lane's in-lane sum
  float w[5];       // received at offsets 16, 8, 4, 2, 1 (0 where unused)
  float dnew;       // the row's entry at the newest column
  float tbr;        // t of the row
  float d;          // upper: the row's diagonal, 1 where it is 0
  double rd;        // upper: 1 / d rounded to double (by the workers)
};

// The products, the in-lane levels and the row's operands: no shuffle.
template <int J, bool LOWER>
__device__ __forceinline__ void ahead_products(
    Ahead<J>& a, const float* D, const double* RD, const float* tb,
    const float (&yv)[J], int r, int cnew, int W, int lane, int t, int emin,
    uint32_t xmax_bits, int saturate) {
  const float* drow = D + r * W;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    const bool live = LOWER ? c < cnew : (c > cnew && c < W);
    a.P[j] = keep_or_zero(CHOP(__fmul_rn(drow[c], yv[j])), live);
  }
  a.v = a.P[0];
  if constexpr (J == 2) a.v = __fadd_rn(a.P[0], a.P[1]);
  if constexpr (J == 4) {
    a.Q[0] = __fadd_rn(a.P[0], a.P[2]);
    a.Q[1] = __fadd_rn(a.P[1], a.P[3]);
    a.v = __fadd_rn(a.Q[0], a.Q[1]);
  }
  a.dnew = drow[clampi(cnew, 0, W - 1)];
  a.tbr = tb[r];
  if (!LOWER) {
    const float d = drow[r];
    a.d = d == 0.0f ? 1.0f : d;
    a.rd = RD[r];
  }
}

// The butterfly over the lanes' in-lane sums, recording what each lane
// receives.
template <int J>
__device__ __forceinline__ void ahead_butterfly(Ahead<J>& a, int lanes) {
  float v = a.v;
#pragma unroll
  for (int lv = 0; lv < 5; ++lv) {
    const int o = 16 >> lv;
    a.w[lv] = 0.0f;
    if (o < lanes) {
      a.w[lv] = __shfl_xor_sync(0xffffffffu, v, o);
      v = __fadd_rn(v, a.w[lv]);
    }
  }
}

// The row's tree on the lane that holds its newest column (register
// jn = cnew / 32), with the new product pnew: its place in the in-lane
// levels, then the recorded butterfly partners, in the tree's order.
template <int J>
__device__ __forceinline__ float finish(const Ahead<J>& a, float pnew, int jn,
                                        int lanes) {
  float v = pnew;
  if constexpr (J == 2)
    v = jn == 0 ? __fadd_rn(pnew, a.P[1]) : __fadd_rn(a.P[0], pnew);
  if constexpr (J == 4) {
    const float sib = (jn & 2) ? ((jn & 1) ? a.P[1] : a.P[0])
                               : ((jn & 1) ? a.P[3] : a.P[2]);
    const float pair = jn < 2 ? __fadd_rn(pnew, sib) : __fadd_rn(sib, pnew);
    v = (jn & 1) ? __fadd_rn(a.Q[0], pair) : __fadd_rn(pair, a.Q[1]);
  }
#pragma unroll
  for (int lv = 0; lv < 5; ++lv)
    if ((16 >> lv) < lanes) v = __fadd_rn(v, a.w[lv]);
  return v;
}

// Warp 0: the chains, one diagonal block after another. Row r's tree is
// prepared a row ahead (products, then butterfly); once the row before
// has given y of the newest column, its lane finishes the tree (`finish`),
// one shuffle hands the sum to every lane, and every lane rounds the
// subtraction (and the division) and so holds the new y. In each step the
// next row's products come first, the row's hand-over next and the next
// row's butterfly last, so that the hand-over is not placed behind the
// next row's shuffles; and nothing in the loop branches, so that the
// compiler interleaves the two rows in one basic block (a warp issues in
// order: the interleaving is the compiler's).
template <int J, bool LOWER>
__device__ __forceinline__ void run_chains(
    float* __restrict__ y, float* ys, const float* tb, const float* diag,
    const double* rdiag, int n, int nb, int W, int lane, int t, int emin,
    uint32_t xmax_bits, int saturate) {
  const int lanes = J > 1 ? 32 : W;
  for (int s = 0; s < nb; ++s) {
    const int i = LOWER ? s : nb - 1 - s;
    named_sync(BAR_READY, TS_SYNC);
    const float* D = diag + (s & 1) * W * W;
    const double* RD = rdiag + (s & 1) * W;
    float yv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) yv[j] = 0.0f;
    Ahead<J> a;
    ahead_products<J, LOWER>(a, D, RD, tb, yv, LOWER ? 0 : W - 1,
                             LOWER ? -1 : W, W, lane, t, emin, xmax_bits,
                             saturate);
    ahead_butterfly<J>(a, lanes);
    float ynew = 0.0f;
#pragma unroll 2
    for (int k = 0; k < W; ++k) {
      const int r = LOWER ? k : W - 1 - k;
      const int cn = LOWER ? r - 1 : r + 1;   // the newest column (k > 0)
#pragma unroll
      for (int j = 0; j < J; ++j)             // its owner keeps y
        yv[j] = (k > 0 && lane + 32 * j == cn) ? ynew : yv[j];
      // The next row (past the block's last, a row of the block, unused).
      Ahead<J> next;
      ahead_products<J, LOWER>(next, D, RD, tb, yv,
                               LOWER ? min(r + 1, W - 1) : max(r - 1, 0), r,
                               W, lane, t, emin, xmax_bits, saturate);
      const float pnew = keep_or_zero(CHOP(__fmul_rn(a.dnew, ynew)), k > 0);
      const float sum = __shfl_sync(0xffffffffu,
                                    finish(a, pnew, cn >> 5, lanes),
                                    cn & 31);
      ahead_butterfly<J>(next, lanes);
      float val = CHOP(__fsub_rn(a.tbr, sum));
      if (!LOWER) val = CHOP(quotient(val, a.d, a.rd));
      ynew = val;
      a = next;
    }
    const int rlast = LOWER ? W - 1 : 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j, gc = i * W + c;
      if (c == rlast) yv[j] = ynew;
      if (c < W) {
        ys[gc] = yv[j];
        if (gc < n) y[gc] = yv[j];
      }
    }
    if (s + 1 < nb) {
      __syncwarp();
      __threadfence_block();
      named_arrive(BAR_CHAIN_DONE, TS_SYNC);
    }
  }
}

// Warps 1-3, 5-7, 9-11, 13-15: block row i's tiles, diagonal block and t.
// Each worker takes rows r = wi + 12 k, in chunks of TS_RC rows whose
// loads are in flight together (few registers: the chain warp shares the
// kernel's register count, and its schedule needs them).
template <int J, bool LOWER>
__device__ __forceinline__ void run_workers(
    const float* __restrict__ Lu, const float* __restrict__ b, const float* ys,
    float* tsum, float* tb, float* diag, double* rdiag, int n, int nb, int W,
    int lw, int wi, int lane, int t, int emin, uint32_t xmax_bits,
    int saturate) {
  constexpr int RW = (32 * J + TS_WORKERS - 1) / TS_WORKERS;  // rows each
  constexpr int NC = (RW + TS_RC - 1) / TS_RC;                 // chunks
  for (int s = 0; s < nb; ++s) {
    const int i = LOWER ? s : nb - 1 - s;
    const int r0 = i * W;
    // Diagonal block i, rounded and masked, into buffer s & 1 (the chain
    // before this one reads the other); for the upper solve also 1 / d
    // of its diagonal, rounded in double, for `quotient`.
    float* D = diag + (s & 1) * W * W;
#pragma unroll 4
    for (int e = wi * 32 + lane; e < W * W; e += TS_WORKERS * 32) {
      const int r = e >> lw, c = e & (W - 1);
      const bool keep = LOWER ? r > c : r <= c;
      D[e] = keep_or_zero(CHOP(lu_at(Lu, n, r0 + r, r0 + c)), keep);
    }
    if (!LOWER)
      for (int r = wi * 32 + lane; r < W; r += TS_WORKERS * 32) {
        const float d = CHOP(lu_at(Lu, n, r0 + r, r0 + r));
        rdiag[(s & 1) * W + r] = __ddiv_rn(1.0, d == 0.0f ? 1.0 : (double)d);
      }
    // The tiles that do not wait for the running chain, summed into
    // tsum[j * W + r].
    const int jdep = s == 0 ? -1 : (LOWER ? i - 1 : i + 1);
    const int jlo = LOWER ? 0 : i + 1, jhi = LOWER ? i : nb;
    float lt[TS_RC][J];
    for (int j = jlo; j < jhi; ++j) {
      if (j == jdep) continue;
      for (int c = 0; c < NC; ++c) {
        load_rows<J>(lt, Lu, n, r0, j * W, wi, c * TS_RC, lane, t, emin,
                     xmax_bits, saturate);
#pragma unroll
        for (int k = 0; k < TS_RC; ++k) {
          const int r = wi + TS_WORKERS * (c * TS_RC + k);
          const float ts = tile_row<J>(lt[k], ys + j * W, W, lane, t, emin,
                                       xmax_bits, saturate);
          if (lane == 0 && r < W) tsum[j * W + r] = ts;
        }
      }
    }
    // The rounded rhs, and the waiting tile's first chunk, before the
    // hand-over.
    float rb[NC * TS_RC];
#pragma unroll
    for (int k = 0; k < NC * TS_RC; ++k) {
      const int gr = r0 + wi + TS_WORKERS * k;
      rb[k] = CHOP(gr < n ? b[min(gr, n - 1)] : 0.0f);
    }
    if (jdep >= 0)
      load_rows<J>(lt, Lu, n, r0, jdep * W, wi, 0, lane, t, emin, xmax_bits,
                   saturate);
    if (s > 0) named_sync(BAR_CHAIN_DONE, TS_SYNC);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c > 0 && jdep >= 0)
        load_rows<J>(lt, Lu, n, r0, jdep * W, wi, c * TS_RC, lane, t, emin,
                     xmax_bits, saturate);
#pragma unroll
      for (int k = 0; k < TS_RC; ++k) {
        const int r = wi + TS_WORKERS * (c * TS_RC + k);
        const float tdep = jdep >= 0 ? tile_row<J>(lt[k], ys + jdep * W, W,
                                                   lane, t, emin, xmax_bits,
                                                   saturate)
                                     : 0.0f;
        if (lane == 0 && r < W) {
          float acc = 0.0f;
          for (int j = jlo; j < jhi; ++j)
            acc = __fadd_rn(acc, j == jdep ? tdep : tsum[j * W + r]);
          tb[r] = CHOP(__fsub_rn(rb[c * TS_RC + k], acc));
        }
      }
    }
    __syncwarp();
    __threadfence_block();
    named_arrive(BAR_READY, TS_SYNC);
  }
}

// W: the block width, a power of two <= 32 J (J = 1 for W <= 32), 2^lw.
template <int J, bool LOWER>
__global__ void __launch_bounds__(32 * TS_WARPS, 1)
    trisolve_shfl_kernel(const float* __restrict__ Lu,
                         const float* __restrict__ b, float* __restrict__ y,
                         int n, int n_pad, int W, int lw, int t, int emin,
                         uint32_t xmax_bits, int saturate) {
  extern __shared__ double smem_d[];
  double* rdiag = smem_d;        // upper: 1 / d of two diagonals, W each
  float* ys = reinterpret_cast<float*>(rdiag + 2 * W);  // the solution
  float* tsum = ys + n_pad;      // tile sums of the block row prepared
  float* tb = tsum + n_pad;      // t of the block row handed over, W
  float* diag = tb + W;          // two diagonal blocks, W * W each (+32)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = n_pad / W;
  if (warp == 0)
    run_chains<J, LOWER>(y, ys, tb, diag, rdiag, n, nb, W, lane, t, emin,
                         xmax_bits, saturate);
  else if (warp % 4 != 0)
    run_workers<J, LOWER>(Lu, b, ys, tsum, tb, diag, rdiag, n, nb, W, lw,
                          warp - warp / 4 - 1, lane, t, emin, xmax_bits,
                          saturate);
}

__global__ void trisolve_smem_kernel(const float* __restrict__ Lu,
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

  for (int bi = 0; bi < nb; ++bi) {
    const int i = lower ? bi : nb - 1 - bi;
    const int r0 = i * block;
    const int jlo = lower ? 0 : i + 1, jhi = lower ? i : nb;

    for (int r = warp; r < block; r += TS_SMEM_WARPS) {
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
  for (int k = threadIdx.x; k < n; k += blockDim.x) y[k] = ys[k];
}

#undef CHOP

template <int J, bool LOWER>
int launch_shfl(const float* lu, const float* b, float* y, int n, int n_pad,
                int W, int t, int emin, unsigned xmax_bits, int saturate,
                cudaStream_t stream) {
  static bool raised[64] = {};
  cudaError_t e = allow_smem(trisolve_shfl_kernel<J, LOWER>, raised);
  if (e != cudaSuccess) return (int)e;
  const size_t smem =
      (size_t)(4 * W + 2 * n_pad + W + 2 * W * W + 32) * sizeof(float);
  const int lw = 31 - __builtin_clz((unsigned)W);
  trisolve_shfl_kernel<J, LOWER><<<1, 32 * TS_WARPS, smem, stream>>>(
      lu, b, y, n, n_pad, W, lw, t, emin, xmax_bits, saturate);
  return (int)cudaGetLastError();
}

}  // namespace

// route: TS_SHFL (block a power of two <= 128) or TS_SMEM (any block).
extern "C" int repro_trisolve_f32(const float* lu, const float* b, float* y,
                                  int n, int block, int lower, int t,
                                  int emin, unsigned xmax_bits, int saturate,
                                  int route, void* stream) {
  if (n <= 0) return 0;
  if (block < 1) return (int)cudaErrorInvalidValue;
  const int n_pad = (n + block - 1) / block * block;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == TS_SHFL) {
    if (block > 128 || (block & (block - 1)))
      return (int)cudaErrorInvalidValue;
    const int J = block > 32 ? block / 32 : 1;
#define CASE(J, LOWER)                                                     \
  case J * 2 + LOWER:                                                      \
    return launch_shfl<J, LOWER>(lu, b, y, n, n_pad, block, t, emin,       \
                                 xmax_bits, saturate, s);
    switch (J * 2 + (lower ? 1 : 0)) {
      CASE(1, false) CASE(1, true) CASE(2, false) CASE(2, true)
      CASE(4, false) CASE(4, true)
#undef CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != TS_SMEM) return (int)cudaErrorInvalidValue;
  static bool raised[64] = {};
  const size_t smem =
      (size_t)(n_pad + block * block + block + TS_SMEM_WARPS * block) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = allow_smem(trisolve_smem_kernel, raised);
    if (e != cudaSuccess) return (int)e;
  }
  trisolve_smem_kernel<<<1, 32 * TS_SMEM_WARPS, smem, s>>>(
      lu, b, y, n, n_pad, block, lower, t, emin, xmax_bits, saturate);
  return (int)cudaGetLastError();
}
