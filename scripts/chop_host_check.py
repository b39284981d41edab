#!/usr/bin/env python3
"""The chop kernel's roundings, compiled for the host, against the integer
algorithm.

    python3 scripts/chop_host_check.py [--per-field N] [--seed S]

`chop_f32` and `chop_f64` of `src/repro_torch/csrc/chop_core.cuh` are the
short-chain forms of `_chop_core` that every kernel of the port rounds
with. This compiles that header for the host with g++ and a small header
of stand-ins for the CUDA intrinsics it uses (bit casts, and the _rn
adds and subtractions as plain IEEE operations, which x86-64's SSE
arithmetic rounds the same way), runs both functions on every exponent
field of their carrier (N random patterns each, both signs) and on the
edges of every format (largest value, smallest normal and subnormal,
their neighbours and midpoints, the carrier's subnormals, zeros,
infinities, NaN), for all seven format ids, and compares each result
bit for bit with `repro_torch.precision.chop._chop_core` on the same
patterns. No GPU is needed; needs g++. Prints one line per carrier and
format and exits 1 on a mismatch.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")

# What chop_core.cuh needs from <cuda_runtime.h>, for the host.
SHIM = r"""
#pragma once
#include <cstdint>
#include <cstring>
#include <math.h>
#define __device__
#define __host__
#define __forceinline__ inline
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidDevice = 101 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int*) { return 0; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline uint32_t __float_as_uint(float x) {
  uint32_t u; memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(uint32_t u) {
  float x; memcpy(&x, &u, 4); return x; }
inline long long __double_as_longlong(double x) {
  long long u; memcpy(&u, &x, 8); return u; }
inline double __longlong_as_double(long long u) {
  double x; memcpy(&x, &u, 8); return x; }
#define RN(T, name, op) \
  inline T name(T a, T b) { volatile T r = a op b; return r; }
RN(float, __fadd_rn, +) RN(float, __fsub_rn, -)
RN(float, __fmul_rn, *) RN(float, __fdiv_rn, /)
RN(double, __dadd_rn, +) RN(double, __dsub_rn, -)
RN(double, __dmul_rn, *) RN(double, __ddiv_rn, /)
inline float __double2float_rn(double a) { return (float)a; }
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline void __syncwarp() {}
"""

# Reads the patterns of one carrier (argv[1]: 32 or 64) from argv[2],
# writes chop of each under the format parameters that follow (four
# numbers a format: t, emin, xmax_bits, saturate) to argv[3].
DRIVER = r"""
#include "chop_core.cuh"
#include <cstdio>
#include <cstdlib>
#include <vector>
template <class U, class F>
int run(const char* in, const char* out, int nfmt, char** p, F chop) {
  FILE* f = fopen(in, "rb");
  if (!f) return 2;
  std::vector<U> x;
  U v;
  while (fread(&v, sizeof(U), 1, f) == 1) x.push_back(v);
  fclose(f);
  FILE* o = fopen(out, "wb");
  if (!o) return 2;
  for (int k = 0; k < nfmt; ++k) {
    const int t = atoi(p[4 * k]), emin = atoi(p[4 * k + 1]);
    const unsigned long long xm = strtoull(p[4 * k + 2], 0, 10);
    const int sat = atoi(p[4 * k + 3]);
    for (U u : x) {
      const U r = chop(u, t, emin, xm, sat);
      fwrite(&r, sizeof(U), 1, o);
    }
  }
  fclose(o);
  return 0;
}
int main(int argc, char** argv) {
  const int nfmt = (argc - 4) / 4;
  if (atoi(argv[1]) == 32)
    return run<uint32_t>(argv[2], argv[3], nfmt, argv + 4,
        [](uint32_t u, int t, int e, unsigned long long xm, int s) {
          return __float_as_uint(
              chop_f32(__uint_as_float(u), t, e, (uint32_t)xm, s));
        });
  return run<uint64_t>(argv[2], argv[3], nfmt, argv + 4,
      [](uint64_t u, int t, int e, unsigned long long xm, int s) {
        return (uint64_t)__double_as_longlong(
            chop_f64(__longlong_as_double((long long)u), t, e, xm, s));
      });
}
"""


def patterns(dtype, per_field: int, seed: int) -> np.ndarray:
    """Every exponent field of the carrier `per_field` times (random
    signs and fractions), then each format's edges and the carrier's
    specials, as the carrier's unsigned bit patterns."""
    from repro_torch.precision.formats import FORMAT_LIST
    f64 = dtype == np.float64
    ut = np.uint64 if f64 else np.uint32
    w, mbits, efmax = (64, 52, 2047) if f64 else (32, 23, 255)
    rng = np.random.default_rng(seed)
    exps = np.repeat(np.arange(efmax + 1, dtype=ut), per_field)
    pats = (rng.integers(0, 2, exps.size, dtype=ut) << ut(w - 1)) \
        | (exps << ut(mbits)) | rng.integers(0, 1 << mbits, exps.size,
                                             dtype=ut)
    fi = np.finfo(dtype)
    edges = [0.0, np.inf, np.nan, float(fi.tiny), float(fi.smallest_subnormal),
             float(fi.tiny) - float(fi.smallest_subnormal), 1.0]
    with np.errstate(over="ignore"):
        for f in FORMAT_LIST:
            for v in (f.xmax, 2.0 ** f.emin, 2.0 ** (f.emin - f.t + 1)):
                ulp = 2.0 ** (np.floor(np.log2(v)) - (f.t - 1))
                for e in (v, v + ulp / 2, v - ulp / 4, v + 1.5 * ulp,
                          v + ulp / 2 + ulp / 8):
                    x = dtype(e)
                    edges += [x, np.nextafter(x, dtype(0)),
                              np.nextafter(x, dtype(np.inf))]
    edges = np.asarray(edges, dtype)
    return np.concatenate([pats, edges.view(ut), (-edges).view(ut)])


def check(per_field: int = 64, seed: int = 0, out=print) -> int:
    """Compile, run and compare; returns the number of mismatches."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.precision.chop import _chop_core, fmt_params
    from repro_torch.precision.formats import FORMAT_LIST
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "cuda_runtime.h"), "w") as f:
            f.write(SHIM)
        src = os.path.join(tmp, "driver.cpp")
        with open(src, "w") as f:
            f.write(DRIVER)
        exe = os.path.join(tmp, "driver")
        subprocess.run(["g++", "-O2", "-std=c++17", "-msse2", "-mfpmath=sse",
                        "-I", tmp, "-I", CSRC, src, "-o", exe], check=True)
        for dtype, tdt, bits in ((np.float32, torch.float32, 32),
                                 (np.float64, torch.float64, 64)):
            pats = patterns(dtype, per_field, seed)
            inp, res = os.path.join(tmp, "in.bin"), os.path.join(tmp, "o.bin")
            pats.tofile(inp)
            args = [a for fid in range(len(FORMAT_LIST))
                    for a in map(str, (int(v) for v in fmt_params(fid, tdt)))]
            subprocess.run([exe, str(bits), inp, res, *args], check=True)
            got = np.fromfile(res, pats.dtype).reshape(len(FORMAT_LIST), -1)
            x = torch.from_numpy(pats.view(dtype).copy())
            for fid, f in enumerate(FORMAT_LIST):
                want = _chop_core(x, *fmt_params(fid, tdt)).numpy()
                g = got[fid].view(dtype)
                nan = np.isnan(g) & np.isnan(want)
                n = int(((got[fid] != want.view(pats.dtype)) & ~nan).sum())
                bad += n
                out(f"chop_f{bits} {f.name}: {pats.size} patterns, "
                    f"{n} mismatches")
    return bad


def main():
    args = sys.argv[1:]
    per_field = int(args[args.index("--per-field") + 1]) \
        if "--per-field" in args else 64
    seed = int(args[args.index("--seed") + 1]) if "--seed" in args else 0
    return 1 if check(per_field, seed) else 0


if __name__ == "__main__":
    sys.exit(main())
