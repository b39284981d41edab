// Device helpers shared by every kernel of the port.
//
// chop_f32: round one float32 to a reduced format, round-to-nearest-even,
// by integer manipulation of the IEEE bit pattern. It is the algorithm of
// `repro.precision.chop._chop_core` (the body of the TPU chop kernel) and
// of the plain torch `repro_torch.precision.chop._chop_core`, for the
// float32 carrier, and agrees with both bit for bit. Format parameters are
// runtime values: one build serves every format id.
//
// warp_tree_sum: the fixed halving tree of `tree_sum` over n values that
// one warp wrote to shared memory: fold the upper half onto the lower
// half, log2(n) times; an odd width parks its last element in a tail
// accumulator that is added once at the end. No shuffle or library
// reduction reproduces that order in general, so every level is explicit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float chop_f32(float x, int t, int emin,
                                          uint32_t xmax_bits, int saturate) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t sign = bits & 0x80000000u;
  const uint32_t mag = bits & 0x7fffffffu;
  const int E = (int)(mag >> 23);
  if (E == 255 || mag == 0) return x;  // inf, nan, signed zero pass through

  const bool is_sub = (E == 0);
  const uint32_t frac = mag & 0x7fffffu;
  const uint32_t M = is_sub ? frac : (frac | 0x800000u);  // M >= 1 here
  const int base = (is_sub ? 1 : E) - 150;                // |x| = M * 2^base
  const int e_x = (31 - __clz(M)) + base;
  const int q = max(e_x, emin) - (t - 1);                 // target quantum
  const int s = q - base;                                 // bits to drop
  if (s <= 0) return x;                                   // representable

  uint32_t Mr = 0u;  // s > 31: |x| < 2^(q-1), rounds to zero
  if (s <= 31) {
    const uint32_t lsb = (M >> s) & 1u;
    const uint32_t round_add = ((1u << (s - 1)) - 1u) + lsb;
    Mr = (M + round_add) >> s;
  }

  uint32_t out_mag = 0u;
  if (Mr != 0u) {
    const int msb_r = 31 - __clz(Mr);
    const int new_e = msb_r + q;
    if (new_e < -126) {  // carrier subnormal: exponent field 0
      out_mag = Mr << clampi(q + 149, 0, 31);
    } else {
      const int shift_n = 23 - msb_r;
      const uint32_t frac_n =
          ((Mr << clampi(shift_n, 0, 31)) >> clampi(-shift_n, 0, 31)) &
          0x7fffffu;
      out_mag = ((uint32_t)(new_e + 127) << 23) | frac_n;
    }
  }
  if (out_mag > xmax_bits) out_mag = saturate ? xmax_bits : 0x7f800000u;
  return __uint_as_float(sign | out_mag);
}

// buf: n floats written by the calling warp, made visible by __syncwarp()
// before the call. Every lane returns the sum. buf is clobbered.
__device__ __forceinline__ float warp_tree_sum(float* buf, int n, int lane) {
  if (n == 0) return 0.0f;
  float tail = 0.0f;
  bool has_tail = false;
  while (n > 1) {
    const int m = n >> 1;
    if (n & 1) {  // buf[n - 1] is not written at this level
      const float last = buf[n - 1];
      tail = has_tail ? __fadd_rn(tail, last) : last;
      has_tail = true;
    }
    for (int k = lane; k < m; k += 32) buf[k] = __fadd_rn(buf[k], buf[k + m]);
    __syncwarp();
    n = m;
  }
  const float out = buf[0];
  __syncwarp();  // every lane has read buf[0] before the caller reuses buf
  return has_tail ? __fadd_rn(out, tail) : out;
}
