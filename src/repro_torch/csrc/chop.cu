// Elementwise round-to-format, fused with the arithmetic that produces its
// operand and with the store that takes its result.
//
// Replaces: repro/kernels/chop/chop.py::chop_pallas (body _chop_kernel),
// the TPU kernel that rounds (256, 128) float32 tiles held in VMEM, and
// the fusion that kernel was written for (its docstring: the rounding
// "can be fused into producers / consumers"). In the JAX package that
// fusion is XLA's: PallasBackend sends every array under
// `chop_min_elems` to the plain rounding (repro/precision/backend.py),
// which XLA compiles into the loop of the operation that produces the
// value and of the select or update that stores it. The solver rounds
// the result of one add, subtract, multiply or divide at almost every
// step, rounds twice in a row at five sites of GMRES-IR and three of CG-IR
// (the CG updates z + chop(alpha p), p = y + chop(beta p) and
// r - chop(alpha q)), and stores most results in
// a slot of a vector or a block of a matrix. Here one entry,
// `repro_chop_expr`, evaluates one of a fixed set of forms in one launch:
//   x        (0)    chop(a)
//   add..div (1-4)  chop(a + b), chop(a - b), chop(a * b), chop(a / b)
//   sub_mul  (5)    chop(a - chop(b * c))
//   sub_div  (6)    chop(chop(a - b) / c)
//   add_mul  (7)    chop(a + chop(b * c))
// Operands broadcast as torch broadcasts them, up to two dimensions
// (element strides, 0 along a broadcast dimension; a 0-dim tensor is a
// scalar). The result goes through the strides of an output view, which
// may be operand `a` itself element for element (`w = chop(w - ...)`,
// the LU's in-place update): each element is read and written by the
// same thread, a read before its write. A live range [lo, hi) of the
// flat index stores +0 outside it (the strict substitutions' masked
// products, `where(idx < i, prods, 0)`). Each step is spelled
// __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn (float64: __dadd_rn, ...) and
// the library is built with -fmad=false, so every step is the single IEEE
// round-to-nearest operation of torch's kernels on the carrier, and every
// form is bit for bit the chain of launches it replaces.
//
// Carriers: every kernel is instantiated on float (chop_f32) and on double
// (chop_f64); the packed arguments' `dtype` picks one at run time. The
// float64 carrier is new work beside the TPU kernel, which takes float32
// only: it runs the paper's own x64 setting on the card.
//
// Bound on the H100: bytes. An output element costs a 4-byte read of each
// operand and a 4-byte write (8-byte on float64) against 30-70 integer
// and float operations,
// far below the card's operations-per-byte balance; on the solver path
// the operands were just written by the previous launch and come from L2.
// Most calls are 0-dim or short vectors, where the launch itself is the
// cost, so the entry takes its arguments packed in one struct (one
// pointer through ctypes) and every route is one launch.
//
// Routes, chosen on the host by `kernels.chop.chop_route` (route codes
// below; the bound and the vector route's shape measured on the H100 by
// scripts/chop_routes.py):
//   block   (0): one block, one element a thread with 32-bit indices, at
//                most BLOCK_MAX elements: the 0-dim and short-vector
//                roundings that make up most of the solver's launches,
//                with no grid to size and no loop;
//   vector  (1): larger operands that are dense in the output's layout
//                (or a broadcast scalar), output dense, all 16-byte
//                aligned: 16-byte loads and stores, each thread issuing
//                VEC_UNROLL float4 (float64: double2) loads of every
//                operand before it rounds anything, blocks of VEC_THREADS,
//                at most one wave (2048 threads an SM) and a grid-stride
//                loop past it; block 0 takes the last n mod 4 (n mod 2)
//                elements;
//   strided (2): every other layout (a broadcast row or column, a view of
//                a wider matrix, an address off 16 bytes): a 2-D
//                grid-stride loop over (row, column), one element a
//                thread a step, so that a warp's accesses to a dense row
//                coalesce.
// The format parameters are kernel arguments, never template values, so
// one build serves all seven format ids.
#include <type_traits>

#include "chop_core.cuh"

namespace {

// The vector route's block size and float4 loads per operand in flight;
// a build may set them (-DCHOP_VEC_THREADS=..., -DCHOP_VEC_UNROLL=...) to
// compare variants (scripts/chop_routes.py --define).
#ifndef CHOP_VEC_THREADS
#define CHOP_VEC_THREADS 128
#endif
#ifndef CHOP_VEC_UNROLL
#define CHOP_VEC_UNROLL 2
#endif

constexpr int THREADS = 256;
constexpr int BLOCK_MAX = 256;    // kernels.chop.BLOCK_MAX
constexpr int VEC_THREADS = CHOP_VEC_THREADS;
constexpr int VEC_UNROLL = CHOP_VEC_UNROLL;

enum Form { X = 0, ADD, SUB, MUL, DIV, SUB_MUL, SUB_DIV, ADD_MUL };

__host__ __device__ constexpr int arity(int form) {
  return form == X ? 1 : (form >= SUB_MUL ? 3 : 2);
}

// An operand broadcast to the (M, N) output: element strides, 0 along a
// broadcast dimension.
template <typename T>
struct Operand {
  const T* p;
  long long s0, s1;
};

template <typename T>
struct Out {
  T* p;
  long long s0, s1;
};

// The launcher's arguments, packed by `kernels/chop/ops.py` (`_ARGS`:
// seventeen 8-byte fields, four 4-byte ones, the 8-byte xmax_bits, two
// 4-byte ones). xmax_bits is the format's xmax in the carrier's width;
// dtype 0 is the float32 carrier, 1 the float64 one.
struct ExprArgs {
  Operand<void> a, b, c;
  Out<void> out;
  long long M, N, lo, hi;
  void* stream;
  int form, route, t, emin;
  uint64_t xmax_bits;
  int saturate, dtype;
};
static_assert(sizeof(ExprArgs) == 168, "kernels/chop/ops.py packs 168 bytes");

template <typename T>
Operand<T> typed(const Operand<void>& x) {
  return {static_cast<const T*>(x.p), x.s0, x.s1};
}
template <typename T>
Out<T> typed(const Out<void>& x) {
  return {static_cast<T*>(x.p), x.s0, x.s1};
}

// The format's parameters; xmax_bits in the carrier's width.
template <typename T>
struct Fmt {
  int t, emin;
  typename std::conditional<sizeof(T) == 8, uint64_t, uint32_t>::type
      xmax_bits;
  int saturate;
};

__device__ __forceinline__ float rnd(float x, const Fmt<float>& f) {
  return chop_f32(x, f.t, f.emin, f.xmax_bits, f.saturate);
}
__device__ __forceinline__ double rnd(double x, const Fmt<double>& f) {
  return chop_f64(x, f.t, f.emin, f.xmax_bits, f.saturate);
}

template <int FORM, typename T>
__device__ __forceinline__ T eval(T a, T b, T c, const Fmt<T>& f) {
  if constexpr (FORM == ADD) return rnd(add_rn(a, b), f);
  if constexpr (FORM == SUB) return rnd(sub_rn(a, b), f);
  if constexpr (FORM == MUL) return rnd(mul_rn(a, b), f);
  if constexpr (FORM == DIV) return rnd(div_rn(a, b), f);
  if constexpr (FORM == SUB_MUL)
    return rnd(sub_rn(a, rnd(mul_rn(b, c), f)), f);
  if constexpr (FORM == SUB_DIV)
    return rnd(div_rn(rnd(sub_rn(a, b), f), c), f);
  if constexpr (FORM == ADD_MUL)
    return rnd(add_rn(a, rnd(mul_rn(b, c), f)), f);
  return rnd(a, f);
}

template <int FORM, typename T>
__device__ __forceinline__ T eval_at(const Operand<T>& a, const Operand<T>& b,
                                     const Operand<T>& c, long long r,
                                     long long k, const Fmt<T>& f) {
  const T va = a.p[r * a.s0 + k * a.s1];
  T vb = T(0), vc = T(0);
  if constexpr (arity(FORM) > 1) vb = b.p[r * b.s0 + k * b.s1];
  if constexpr (arity(FORM) > 2) vc = c.p[r * c.s0 + k * c.s1];
  return eval<FORM>(va, vb, vc, f);
}

template <int FORM, typename T>
__global__ void __launch_bounds__(THREADS)
    chop_block_kernel(Operand<T> a, Operand<T> b, Operand<T> c, Out<T> o,
                      int M, int N, int lo, int hi, Fmt<T> f) {
  const int i = threadIdx.x;
  if (i >= M * N) return;
  const int r = M == 1 ? 0 : i / N, k = i - r * N;
  o.p[r * o.s0 + k * o.s1] =
      keep_or_zero(eval_at<FORM>(a, b, c, r, k, f), i >= lo && i < hi);
}

template <int FORM, typename T>
__global__ void __launch_bounds__(THREADS)
    chop_strided_kernel(Operand<T> a, Operand<T> b, Operand<T> c, Out<T> o,
                        long long M, long long N, long long lo, long long hi,
                        Fmt<T> f) {
  const long long step = (long long)gridDim.x * THREADS;
  for (long long r = blockIdx.y; r < M; r += gridDim.y) {
    for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < N;
         k += step) {
      const long long i = r * N + k;
      o.p[r * o.s0 + k * o.s1] =
          keep_or_zero(eval_at<FORM>(a, b, c, r, k, f), i >= lo && i < hi);
    }
  }
}

__device__ __forceinline__ float4 splat(float v) {
  return make_float4(v, v, v, v);
}
__device__ __forceinline__ double2 splat(double v) {
  return make_double2(v, v);
}

// The 16-byte vector of a carrier: 4 floats or 2 doubles.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int L = 4, LOG = 2;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int L = 2, LOG = 1;
};

// A dense operand's vector i, or its scalar broadcast (s1 == 0).
template <typename T>
__device__ __forceinline__ typename Vec<T>::type load_vec(const Operand<T>& x,
                                                          T s, long long i) {
  using V = typename Vec<T>::type;
  return x.s1 ? reinterpret_cast<const V*>(x.p)[i] : splat(s);
}

// One vector's results, element e0 + k of the output at lane k.
template <int FORM>
__device__ __forceinline__ float4 eval_vec(const float4& a, const float4& b,
                                           const float4& c, long long e,
                                           long long lo, long long hi,
                                           const Fmt<float>& f) {
  return make_float4(
      keep_or_zero(eval<FORM>(a.x, b.x, c.x, f), e >= lo && e < hi),
      keep_or_zero(eval<FORM>(a.y, b.y, c.y, f), e + 1 >= lo && e + 1 < hi),
      keep_or_zero(eval<FORM>(a.z, b.z, c.z, f), e + 2 >= lo && e + 2 < hi),
      keep_or_zero(eval<FORM>(a.w, b.w, c.w, f), e + 3 >= lo && e + 3 < hi));
}
template <int FORM>
__device__ __forceinline__ double2 eval_vec(const double2& a,
                                            const double2& b,
                                            const double2& c, long long e,
                                            long long lo, long long hi,
                                            const Fmt<double>& f) {
  return make_double2(
      keep_or_zero(eval<FORM>(a.x, b.x, c.x, f), e >= lo && e < hi),
      keep_or_zero(eval<FORM>(a.y, b.y, c.y, f), e + 1 >= lo && e + 1 < hi));
}

// Every operand dense in the output's layout (s1 = 1) or a scalar (s1 =
// 0), the output dense, all 16-byte aligned: n elements, flat.
template <int FORM, typename T>
__global__ void __launch_bounds__(VEC_THREADS)
    chop_vector_kernel(Operand<T> a, Operand<T> b, Operand<T> c, T* out,
                       long long n, long long lo, long long hi, Fmt<T> f) {
  using V = typename Vec<T>::type;
  constexpr int NOP = arity(FORM), L = Vec<T>::L, LOG = Vec<T>::LOG;
  const T sa = a.s1 ? T(0) : a.p[0];
  const T sb = (NOP < 2 || b.s1) ? T(0) : b.p[0];
  const T sc = (NOP < 3 || c.s1) ? T(0) : c.p[0];
  const long long nv = n >> LOG;
  V* ov = reinterpret_cast<V*>(out);
  const long long step = (long long)gridDim.x * VEC_THREADS * VEC_UNROLL;
  for (long long base = (long long)blockIdx.x * VEC_THREADS * VEC_UNROLL +
                        threadIdx.x;
       base < nv; base += step) {
    V va[VEC_UNROLL], vb[VEC_UNROLL], vc[VEC_UNROLL];
#pragma unroll
    for (int u = 0; u < VEC_UNROLL; ++u) {
      const long long i = base + (long long)u * VEC_THREADS;
      va[u] = vb[u] = vc[u] = splat(T(0));
      if (i < nv) {
        va[u] = load_vec(a, sa, i);
        if constexpr (NOP > 1) vb[u] = load_vec(b, sb, i);
        if constexpr (NOP > 2) vc[u] = load_vec(c, sc, i);
      }
    }
#pragma unroll
    for (int u = 0; u < VEC_UNROLL; ++u) {
      const long long i = base + (long long)u * VEC_THREADS;
      if (i < nv) ov[i] = eval_vec<FORM>(va[u], vb[u], vc[u], i << LOG, lo,
                                         hi, f);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & (L - 1))) {
    const long long i = (nv << LOG) + threadIdx.x;
    out[i] = keep_or_zero(eval_at<FORM>(a, b, c, 0, i, f), i >= lo && i < hi);
  }
}

// Streaming multiprocessors of the current device, looked up once per
// device.
int sm_count() {
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

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

template <int FORM, typename T>
int launch(const ExprArgs& p) {
  const Fmt<T> f{p.t, p.emin,
                 static_cast<decltype(Fmt<T>::xmax_bits)>(p.xmax_bits),
                 p.saturate};
  const Operand<T> a = typed<T>(p.a), b = typed<T>(p.b), c = typed<T>(p.c);
  const Out<T> o = typed<T>(p.out);
  const cudaStream_t s = static_cast<cudaStream_t>(p.stream);
  const long long n = p.M * p.N;
  if (p.route == 0) {
    if (n > BLOCK_MAX) return (int)cudaErrorInvalidValue;
    const int threads = (int)cdiv(n, 32) * 32;
    chop_block_kernel<FORM><<<1, threads, 0, s>>>(
        a, b, c, o, (int)p.M, (int)p.N, (int)p.lo, (int)p.hi, f);
  } else if (p.route == 1) {
    // Flat: every operand's s1 is 1 (dense) or 0 (scalar), the output
    // dense; the vector loads need every dense pointer 16-byte aligned.
    const Operand<void>* ops[3] = {&p.a, &p.b, &p.c};
    for (int k = 0; k < arity(FORM); ++k)
      if (ops[k]->s1 && misaligned(ops[k]->p))
        return (int)cudaErrorMisalignedAddress;
    if (misaligned(p.out.p)) return (int)cudaErrorMisalignedAddress;
    // At most one wave: 2048 threads on each SM.
    const long long want = cdiv(cdiv(n, Vec<T>::L),
                                (long long)VEC_THREADS * VEC_UNROLL);
    const long long wave = (2048LL / VEC_THREADS) * sm_count();
    const long long blocks = want < wave ? want : wave;
    chop_vector_kernel<FORM><<<(unsigned)(blocks > 0 ? blocks : 1),
                               VEC_THREADS, 0, s>>>(a, b, c, o.p, n, p.lo,
                                                    p.hi, f);
  } else if (p.route == 2) {
    const long long cap = 16LL * sm_count();
    long long gx = cdiv(p.N, THREADS);
    if (gx > cap) gx = cap;
    long long gy = cap / gx;
    if (gy > p.M) gy = p.M;
    if (gy > 65535) gy = 65535;
    if (gy < 1) gy = 1;
    chop_strided_kernel<FORM><<<dim3((unsigned)gx, (unsigned)gy), THREADS, 0,
                                s>>>(a, b, c, o, p.M, p.N, p.lo, p.hi, f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_form(const ExprArgs& p) {
  switch (p.form) {
    case X: return launch<X, T>(p);
    case ADD: return launch<ADD, T>(p);
    case SUB: return launch<SUB, T>(p);
    case MUL: return launch<MUL, T>(p);
    case DIV: return launch<DIV, T>(p);
    case SUB_MUL: return launch<SUB_MUL, T>(p);
    case SUB_DIV: return launch<SUB_DIV, T>(p);
    case ADD_MUL: return launch<ADD_MUL, T>(p);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// args: one ExprArgs. Returns 0 without a launch for an empty output,
// else the launch's cudaGetLastError().
extern "C" int repro_chop_expr(const void* args) {
  const ExprArgs& p = *static_cast<const ExprArgs*>(args);
  if (p.M <= 0 || p.N <= 0) return 0;
  switch (p.dtype) {
    case 0: return launch_form<float>(p);
    case 1: return launch_form<double>(p);
    default: return (int)cudaErrorInvalidValue;
  }
}
