// Device helpers shared by every kernel of the port.
//
// chop_f32 / chop_f64: round one float32 / float64 to a reduced format,
// round-to-nearest-even, by integer manipulation of the IEEE bit pattern.
// Each is the algorithm of `repro.precision.chop._chop_core` (the body of
// the TPU chop kernel) and of the plain torch
// `repro_torch.precision.chop._chop_core`, for its carrier, and agrees
// with both bit for bit. Format parameters are runtime values: one build
// serves every format id on each carrier. `chop_t` picks one by the
// carrier type, and `add_rn`, `sub_rn`, `mul_rn`, `div_rn` the carrier's
// single-rounding operation, so that a kernel templated on the carrier
// spells each step once.
//
// chop_sr_f32: stochastic rounding of a float32 with a given random word
// (the JAX package's `chop_stochastic`), on the same format arguments.
//
// The fixed halving tree of `tree_sum` (fold the upper half onto the lower
// half, log2(n) times; an odd width parks its last element in a tail
// accumulator added once at the end) in two forms:
//   * in registers (fold_in_lane, butterfly): lane l of a warp holds the
//     values at positions l + 32 j, j < J. A level that folds a width 32 m
//     with m even pairs position k with k + 16 m, which the same lane
//     holds, so it is an add of two registers. At width 32 the xor
//     butterfly with offsets 16, 8, 4, 2, 1 adds on lane l its own value
//     and lane l ^ o's: the tree's add on lanes l < o, the same add with
//     the operands swapped on the others, which is the same bits (the
//     card returns one canonical NaN whatever the operands). Lane 0 ends
//     with the tree's root in the tree's own operand order, and every lane
//     with the same bits. A width below 32 that is a power of two starts
//     the butterfly at half the width. Widths 32 * 2^k take this form
//     whole; a width 32 m with m odd (384 = 32 * 12 folds in lane to 96)
//     finishes in shared memory;
//   * in shared memory (warp_tree_sum): every level explicit, for any
//     width, odd widths included.
// The plain model of both, held against `tree_sum` on the CPU, is
// `repro_torch.kernels.lanes.lane_tree_sum`.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float chop_f32(float x, int t, int emin,
                                          uint32_t xmax_bits, int saturate) {
  // Branch-free, in a short dependency chain (the row chain of the
  // trisolve kernel waits on two of these per row). A value at or above
  // the format's smallest normal 2^emin keeps t significant bits: it
  // drops s = 24 - t bits of its own float32 pattern, rounded to nearest
  // even by adding half an ulp (less one, plus the kept last bit) and
  // clearing them; a carry out of the significand moves into the
  // exponent, as a renormalisation would, up to the infinity pattern. A
  // smaller value (a float32 subnormal too) rounds to a multiple of the
  // format's smallest subnormal 2^qmin, qmin = emin - t + 1: adding
  // C = 2^(qmin + 23), whose ulp that is, rounds it there (ties to even,
  // since C's significand is even), and subtracting C is exact. Above
  // the largest value the format saturates or overflows; infinities, NaN
  // and zeros pass unchanged. When t >= 24 (the format holds float32) no
  // bit is dropped and a float32 subnormal is a multiple of 2^qmin, so
  // every value passes unchanged, with no branch on t. The integer
  // algorithm it replaces, every case spelled out, is
  // `repro_torch.precision.chop._chop_core`.
  const uint32_t bits = __float_as_uint(x);
  const uint32_t mag = bits & 0x7fffffffu;
  const int s = clampi(24 - t, 0, 23);
  const uint32_t mask = (1u << s) - 1u;  // 0 when t >= 24: out = mag
  uint32_t out =
      (mag + (mask >> 1) + ((mag >> s) & (uint32_t)(s != 0))) & ~mask;
  const float C =
      __uint_as_float((uint32_t)clampi(emin - t + 1 + 150, 1, 254) << 23);
  const uint32_t tiny =
      __float_as_uint(__fsub_rn(__fadd_rn(__uint_as_float(mag), C), C));
  out = mag < ((uint32_t)clampi(emin + 127, 0, 255) << 23) ? tiny : out;
  if (out > xmax_bits) out = saturate ? xmax_bits : 0x7f800000u;
  const bool keep = mag >= 0x7f800000u || mag == 0u;
  return keep ? x : __uint_as_float((bits & 0x80000000u) | out);
}

// The float64 carrier's chop_f32, step for step: a value at or above
// 2^emin drops s = 53 - t bits of its float64 pattern (64-bit masks), a
// smaller one (a float64 subnormal too) rounds through C = 2^(qmin + 52),
// whose ulp is the format's smallest subnormal 2^qmin, qmin = emin - t + 1,
// and the overflow, the infinities, NaN and zeros are those of chop_f32
// with float64's exponent field. When t = 53 (fp64 on this carrier) no bit
// is dropped and C = 2^-1022 adds and subtracts a float64 subnormal
// exactly, so every value passes unchanged. The host-side model of this
// chain, held against the integer algorithm on the CPU, is
// `repro_torch.kernels.chop.checks.chop_short`.
__device__ __forceinline__ double chop_f64(double x, int t, int emin,
                                           uint64_t xmax_bits, int saturate) {
  const uint64_t bits = (uint64_t)__double_as_longlong(x);
  const uint64_t mag = bits & 0x7fffffffffffffffull;
  const int s = clampi(53 - t, 0, 52);
  const uint64_t mask = (1ull << s) - 1ull;  // 0 when t >= 53: out = mag
  uint64_t out =
      (mag + (mask >> 1) + ((mag >> s) & (uint64_t)(s != 0))) & ~mask;
  const double C = __longlong_as_double(
      (long long)((uint64_t)clampi(emin - t + 1 + 1075, 1, 2046) << 52));
  const uint64_t tiny = (uint64_t)__double_as_longlong(__dsub_rn(
      __dadd_rn(__longlong_as_double((long long)mag), C), C));
  out = mag < ((uint64_t)clampi(emin + 1023, 0, 2047) << 52) ? tiny : out;
  if (out > xmax_bits) out = saturate ? xmax_bits : 0x7ff0000000000000ull;
  const bool keep = mag >= 0x7ff0000000000000ull || mag == 0ull;
  return keep ? x
              : __longlong_as_double(
                    (long long)((bits & 0x8000000000000000ull) | out));
}

// Stochastic rounding of one float32 to a reduced format: the integer
// formulation of the JAX package's `chop_stochastic`
// (repro/precision/chop.py:237) with its random word `r` given. With s
// bits of the significand M (implicit bit included) below the format's
// quantum 2^q, add u = r & (2^s - 1) and truncate: M rounds up with
// probability (M mod 2^s) / 2^s. The result is reassembled as the
// reference does, a normal or a float32-subnormal pattern, then the
// overflow to infinity (or the saturation to xmax) above the format's
// largest value; zeros, infinities, NaN and values with no bit to drop
// pass unchanged, and a value more than 31 bits below the quantum (deep
// underflow) rounds to a signed zero. M < 2^24, so M + u never carries
// out of 32 bits. The plain version is
// `repro_torch.kernels.chop.ref.chop_sr_ref`.
__device__ __forceinline__ float chop_sr_f32(float x, uint32_t r, int t,
                                             int emin, uint32_t xmax_bits,
                                             int saturate) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t sign = bits & 0x80000000u;
  const uint32_t mag = bits & 0x7fffffffu;
  const int E = (int)(mag >> 23);
  const uint32_t frac = mag & 0x7fffffu;
  const uint32_t M = E == 0 ? frac : (frac | 0x800000u);
  const int base = (E == 0 ? 1 : E) - 150;  // |x| = M 2^base
  const int e_x = 31 - __clz(M == 0u ? 1u : M) + base;
  const int q = (e_x > emin ? e_x : emin) - (t - 1);
  const int s = q - base;                   // bits to round off
  if (mag >= 0x7f800000u || mag == 0u || s <= 0) return x;
  const uint32_t Mr = s > 31 ? 0u : (M + (r & ((1u << s) - 1u))) >> s;
  if (Mr == 0u) return __uint_as_float(sign);
  const int msb_r = 31 - __clz(Mr);
  const int new_e = msb_r + q;
  uint32_t out;
  if (new_e < -126) {  // a float32 subnormal: Mr 2^q = Mr 2^(q + 149) ulps
    out = Mr << clampi(q + 149, 0, 31);
  } else {
    const int shift_n = 23 - msb_r;
    out = ((uint32_t)(new_e + 127) << 23) |
          (((Mr << clampi(shift_n, 0, 31)) >> clampi(-shift_n, 0, 31)) &
           0x7fffffu);
  }
  if (out > xmax_bits) out = saturate ? xmax_bits : 0x7f800000u;
  return __uint_as_float(sign | out);
}

// The carrier's chop and its single-rounding operations, by type.
__device__ __forceinline__ float chop_t(float x, int t, int emin,
                                        uint64_t xmax_bits, int saturate) {
  return chop_f32(x, t, emin, (uint32_t)xmax_bits, saturate);
}
__device__ __forceinline__ double chop_t(double x, int t, int emin,
                                         uint64_t xmax_bits, int saturate) {
  return chop_f64(x, t, emin, xmax_bits, saturate);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// buf: n values written by the calling warp, made visible by __syncwarp()
// before the call. Every lane returns the sum. buf is clobbered.
template <typename T>
__device__ __forceinline__ T warp_tree_sum(T* buf, int n, int lane) {
  if (n == 0) return T(0);
  T tail = T(0);
  bool has_tail = false;
  while (n > 1) {
    const int m = n >> 1;
    if (n & 1) {  // buf[n - 1] is not written at this level
      const T last = buf[n - 1];
      tail = has_tail ? add_rn(tail, last) : last;
      has_tail = true;
    }
    for (int k = lane; k < m; k += 32) buf[k] = add_rn(buf[k], buf[k + m]);
    __syncwarp();
    n = m;
  }
  const T out = buf[0];
  __syncwarp();  // every lane has read buf[0] before the caller reuses buf
  return has_tail ? add_rn(out, tail) : out;
}

// The correctly rounded x / d (d != 0) of the float32 carrier from rd =
// 1 / d rounded to double,
// which a caller that divides by d often prepares ahead of time: x * rd
// rounded to double and then to float is x / d rounded once wherever that
// is a normal float or larger, and through infinities, zeros and NaN. The
// quotient of two floats lies at least 2^-49 of itself away from a
// float's rounding boundary (it is never a midpoint, and its distance to
// one is a nonzero integer over 2 x 2^24 in units of its last place),
// and x * rd is within 2^-52 of x / d. A quotient in the subnormal range
// (where a midpoint can be hit), and a NaN (whose bits are the
// division's own), take the division itself.
__device__ __forceinline__ float quotient(float x, float d, double rd) {
  const double qd = __dmul_rn((double)x, rd);
  if ((x != 0.0f && fabs(qd) < 0x1p-126) || qd != qd) return __fdiv_rn(x, d);
  return __double2float_rn(qd);
}

// The float64 carrier has no wider type to divide through: its quotient
// is the division itself, correctly rounded (rd is unused).
__device__ __forceinline__ double quotient(double x, double d, double) {
  return __ddiv_rn(x, d);
}

// keep ? v : +0, as a bit mask: the product is computed either way, so
// that a mask that differs between lanes splits no warp.
__device__ __forceinline__ float keep_or_zero(float v, bool keep) {
  return __uint_as_float(__float_as_uint(v) & (0u - (uint32_t)keep));
}
__device__ __forceinline__ double keep_or_zero(double v, bool keep) {
  return __longlong_as_double(__double_as_longlong(v) &
                              (0ll - (long long)keep));
}

// Odd part of j: the register count left after the in-lane levels.
__host__ __device__ constexpr int odd_part(int j) {
  return j % 2 ? j : odd_part(j / 2);
}

// The in-lane levels of a width-32 J row held as v[j] = x[lane + 32 j]:
// while J is even, v[j] += v[j + J/2] for j < J/2. Leaves odd_part(J)
// registers.
template <int J, typename T>
__device__ __forceinline__ void fold_in_lane(T* v) {
  if constexpr (J % 2 == 0) {
#pragma unroll
    for (int j = 0; j < J / 2; ++j) v[j] = add_rn(v[j], v[j + J / 2]);
    fold_in_lane<J / 2>(v);
  }
}

// The shuffle levels: offsets first, first / 2, ..., 1 (first = 16 for a
// width of 32 or more). Every lane returns the sum of its group.
template <typename T>
__device__ __forceinline__ T butterfly(T s, int first = 16) {
#pragma unroll
  for (int o = first; o > 0; o >>= 1)
    s = add_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// Named barriers (bar.sync / bar.arrive on ids 1..15) between the warps
// of a block that hand work to one another; `count` threads in whole
// warps. An arrive orders the arriving thread's earlier shared-memory
// writes before the waiting threads' later reads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Streaming multiprocessors of the current device, looked up once per
// device (the elementwise kernels size one wave of blocks with it).
inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int c = 0;
    if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        c <= 0)
      return 132;
    count[dev] = c;
  }
  return count[dev];
}

// Raises `kernel`'s dynamic shared-memory limit to the block maximum
// (227 KB) on the current device, once per device: the launchers set the
// device through the wrappers' device guard.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// Per-row formats of a batch (`repro_torch.precision.rows`): the rows of
// one launch, element e belonging to row e's index along the batch
// dimension, each rounded to the format of its own id. The wrapper passes
// the ids (a device array, one int32 a row) and a host pointer to the
// table of every format id's parameters on the launch's carrier
// (`kernels.library.format_table`: NFMT rows of FmtRow, xmax_bits in the
// carrier's width); the launcher copies the table into the kernel's
// arguments. ids null: every row takes the launch's one format.
constexpr int NFMT = 8;

struct FmtRow {
  int t, emin;
  unsigned long long xmax_bits;
  int saturate, pad;
};
static_assert(sizeof(FmtRow) == 24, "kernels/library.py packs 24 bytes");

struct RowFmts {
  const int* ids;
  FmtRow row[NFMT];
};

inline RowFmts row_fmts(const void* ids, const void* table) {
  RowFmts r;
  r.ids = static_cast<const int*>(ids);
  if (ids != nullptr && table != nullptr)
    memcpy(r.row, table, sizeof(r.row));
  else
    memset(r.row, 0, sizeof(r.row));
  return r;
}

// The format of batch row `b`: the row's id's entry of the table, or the
// launch's one format (left as it is) when the launch has no ids.
template <typename X>
__device__ __forceinline__ void row_format(const RowFmts& rf, long long b,
                                           int& t, int& emin, X& xmax_bits,
                                           int& saturate) {
  if (rf.ids != nullptr) {
    const FmtRow& f = rf.row[rf.ids[b]];
    t = f.t;
    emin = f.emin;
    xmax_bits = (X)f.xmax_bits;
    saturate = f.saturate;
  }
}
