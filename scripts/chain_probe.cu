// Latency of the dependent operations on trisolve's row chain, measured
// with clock64() in one warp: each chain runs `reps` times an operation
// whose input is the previous one's output, so its cycles over `reps`
// are the operation's latency on this card (the issue rate plays no
// part). One kernel per carrier: float (chop_f32, `repro_chain_probe`)
// and double (chop_f64, `repro_chain_probe_f64`, whose row chain divides
// with __ddiv_rn: slots 4 and 5 time the same division). Built and run by
// scripts/chain_bound.py; not part of the port.
#include "chop_core.cuh"

#define CHOP(x) chop_t((x), t, emin, xmax_bits, saturate)

template <typename T>
__global__ void chain_probe_kernel(T* out, long long* cycles, int reps,
                                   int t, int emin, uint64_t xmax_bits,
                                   int saturate, T c) {
  const int lane = threadIdx.x & 31;
  T x = T(1) + T(0.001) * lane;
  long long t0, t1;
#define TIME(slot, step)                                  \
  __syncwarp();                                           \
  t0 = clock64();                                         \
  for (int i = 0; i < reps; ++i) {                        \
    step;                                                 \
  }                                                       \
  __syncwarp();                                           \
  t1 = clock64();                                         \
  if (lane == 0) cycles[slot] = t1 - t0;
  TIME(0, x = add_rn(x, c))                                     // add
  TIME(1, x = add_rn(x, __shfl_xor_sync(0xffffffffu, x, 1)))    // level
  TIME(2, x = CHOP(mul_rn(x, c)))                               // product
  TIME(3, x = CHOP(sub_rn(c, x)))                               // subtract
  TIME(4, x = CHOP(div_rn(x, c)))                               // divide
  const double rc = __ddiv_rn(1.0, (double)c);
  TIME(5, x = CHOP(quotient(x, c, rc)))              // divide, 1 / c ahead
#undef TIME
  out[lane] = x;
}

extern "C" int repro_chain_probe(float* out, long long* cycles, int reps,
                                 int t, int emin, unsigned xmax_bits,
                                 int saturate, float c, void* stream) {
  chain_probe_kernel<float><<<1, 32, 0, (cudaStream_t)stream>>>(
      out, cycles, reps, t, emin, xmax_bits, saturate, c);
  return (int)cudaGetLastError();
}

extern "C" int repro_chain_probe_f64(double* out, long long* cycles,
                                     int reps, int t, int emin,
                                     unsigned long long xmax_bits,
                                     int saturate, double c, void* stream) {
  chain_probe_kernel<double><<<1, 32, 0, (cudaStream_t)stream>>>(
      out, cycles, reps, t, emin, xmax_bits, saturate, c);
  return (int)cudaGetLastError();
}
