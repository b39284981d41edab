// Elementwise round-to-format kernel.
//
// Replaces: repro/kernels/chop/chop.py::chop_pallas (body _chop_kernel),
// the TPU kernel that rounds (256, 128) float32 tiles held in VMEM.
//
// Bound on the H100: device-memory bytes. Each element is read once and
// written once (8 bytes) against some 30 integer operations, far below
// the card's operations-per-byte balance. On the solver path most calls
// are short vectors (n <= 512), where the launch itself is the cost.
//
// Design: a grid-stride loop, one element per thread per step, so every
// warp reads and writes 128 contiguous bytes. The format parameters are
// kernel arguments, never template values, so one build serves all seven
// format ids. The rounding is the integer algorithm of chop_core.cuh and
// agrees with the plain torch version bit for bit.
#include "chop_core.cuh"

__global__ void chop_kernel(const float* __restrict__ x,
                            float* __restrict__ out, long long n, int t,
                            int emin, uint32_t xmax_bits, int saturate) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = chop_f32(x[i], t, emin, xmax_bits, saturate);
}

extern "C" int repro_chop_f32(const float* x, float* out, long long n, int t,
                              int emin, unsigned xmax_bits, int saturate,
                              void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  chop_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, out, n, t, emin, xmax_bits, saturate);
  return (int)cudaGetLastError();
}
