// Stochastic rounding to a reduced format on the float32 carrier.
//
// Replaces no TPU kernel: the JAX package's `chop_stochastic`
// (repro/precision/chop.py:237) is plain jnp, an elementwise integer
// formulation that XLA fuses. This is that formulation, element for
// element, with the random word as an input instead of a
// `jax.random.bits` draw: with s bits of the significand M below the
// format's quantum, add u = bits & (2^s - 1) to M and truncate, so M
// rounds up with probability (M mod 2^s) / 2^s and E[result] = x. The
// rounding itself is `chop_sr_f32` of chop_core.cuh, which takes the
// RNE chop's four format arguments (`library.fmt_args`), so one build
// serves every format id. Its plain version, held against the reference
// bit for bit on the CPU, is `repro_torch.kernels.chop.ref.chop_sr_ref`;
// scripts/chop_host_check.py compiles `chop_sr_f32` for the host and
// holds it against that plain version.
//
// Bound on the H100: bytes (a 4-byte read of x and of its random word,
// a 4-byte write: 12 bytes an element) against ~40 integer operations.
// One thread an element, at most one wave of blocks over a grid-stride
// loop.
#include "chop_core.cuh"

namespace {

constexpr int SR_THREADS = 256;

__global__ void __launch_bounds__(SR_THREADS)
chop_sr_kernel(const float* __restrict__ x, const uint32_t* __restrict__ r,
               float* __restrict__ out, long long n, int t, int emin,
               uint32_t xmax_bits, int saturate) {
  const long long stride = (long long)gridDim.x * SR_THREADS;
  for (long long i = (long long)blockIdx.x * SR_THREADS + threadIdx.x;
       i < n; i += stride)
    out[i] = chop_sr_f32(x[i], r[i], t, emin, xmax_bits, saturate);
}

}  // namespace

// x, r, out: n contiguous float32 values, their random words and the
// result. Returns 0 without a launch for n = 0, else the launch's
// cudaGetLastError().
extern "C" int repro_chop_sr(const void* x, const void* r, void* out,
                             long long n, int t, int emin, unsigned xmax_bits,
                             int saturate, void* stream) {
  if (n <= 0) return 0;
  const long long want = (n + SR_THREADS - 1) / SR_THREADS;
  const long long wave = (2048LL / SR_THREADS) * sm_count();
  const long long blocks = want < wave ? want : wave;
  chop_sr_kernel<<<(unsigned)blocks, SR_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(r),
      static_cast<float*>(out), n, t, emin, (uint32_t)xmax_bits, saturate);
  return (int)cudaGetLastError();
}
