"""How the chopped GEMM is checked against its plain versions, in one
place for `chip_smoke.py` and the tests: the order tolerance `held`
that `qgemm_op` and `qmatmul_op` are held to, the operands at each
format's edges, the float32 bit patterns that the chop and the operand
pack are held on, and `pack_equal`, the pack kernel against `pack_ref`.
Nothing on the main path calls it; `float64_patterns` is the float64
carrier's counterpart of `float32_patterns`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.precision import FORMAT_LIST, chop

from .ref import pack_ref

# Operands at a format's edges (`special_operands`).
SPECIAL_KINDS = ("subnormal_a", "subnormal_b", "largest", "inf")


def float32_patterns(seed: int) -> torch.Tensor:
    """Every float32 exponent field 64 times, both signs, random
    fractions, then zeros, infinities, NaN, the smallest subnormals and
    the fp8 and fp16 saturation values and their neighbours."""
    rng = np.random.default_rng(seed)
    exps = np.repeat(np.arange(256, dtype=np.uint32), 64)
    pats = (rng.integers(0, 2, exps.size, dtype=np.uint32) << 31) \
        | (exps << 23) | rng.integers(0, 1 << 23, exps.size, dtype=np.uint32)
    extra = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        448.0, 464.0, 57344.0, 61440.0, 65504.0, 65520.0],
                       np.float32)
    return torch.from_numpy(np.concatenate([pats.view(np.float32), extra]))


def float64_patterns(seed: int) -> torch.Tensor:
    """The float64 carrier's `float32_patterns`: every float64 exponent
    field 16 times, both signs, random fractions, then zeros,
    infinities, NaN, float64's smallest and largest subnormals and
    smallest normal, and each format's largest value, smallest normal and
    smallest subnormal with their neighbours and the midpoints of the
    format's spacing around them."""
    rng = np.random.default_rng(seed)
    exps = np.repeat(np.arange(2048, dtype=np.uint64), 16)
    pats = (rng.integers(0, 2, exps.size, dtype=np.uint64) << np.uint64(63)) \
        | (exps << np.uint64(52)) \
        | rng.integers(0, 1 << 52, exps.size, dtype=np.uint64)
    extra = [0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324, -5e-324,
             2.225073858507201e-308, 2.2250738585072014e-308]
    with np.errstate(over="ignore"):     # fp64's xmax: its next is inf
        for f in FORMAT_LIST:
            for v in (f.xmax, 2.0 ** f.emin, 2.0 ** (f.emin - f.t + 1)):
                ulp = 2.0 ** (np.floor(np.log2(v)) - (f.t - 1))
                extra += [v, np.nextafter(v, 0.0), np.nextafter(v, np.inf),
                          v + ulp / 2, v - ulp / 4, v + 1.5 * ulp]
    extra = np.asarray(extra, np.float64)
    return torch.from_numpy(np.concatenate([pats.view(np.float64), extra,
                                            -extra]))


def special_operands(kind: str, fid: int, M: int, K: int, N: int,
                     g: torch.Generator):
    """Float32 operands at the edges of format `fid` (CPU generator `g`):
    one operand scaled into the format's subnormal range ("subnormal_a",
    "subnormal_b"); A near the largest value with every column of B
    summing to 1/2 in magnitude, so that no partial sum overflows in any
    order ("largest"); A with 0.5% of its entries +-inf ("inf")."""
    f = FORMAT_LIST[fid]
    emin = max(f.emin, -126)
    xmax = min(f.xmax, float(torch.finfo(torch.float32).max))
    a, b = torch.randn(M, K, generator=g), torch.randn(K, N, generator=g)
    if kind == "subnormal_a":
        a = a * 2.0 ** (emin - 2)
    elif kind == "subnormal_b":
        b = b * 2.0 ** (emin - 2)
    elif kind == "largest":
        a = torch.sign(a) * (xmax * (0.5 + 0.5 * torch.rand(M, K, generator=g)))
        b = b / (2 * b.abs().sum(0, keepdim=True))
    elif kind == "inf":
        a[torch.rand(M, K, generator=g) < 0.005] = float("inf")
        a = a * torch.sign(torch.randn(M, K, generator=g))
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return a, b


# Significand bits and smallest normal exponent of each carrier.
_CARRIER_T = {torch.float32: (24, -126), torch.float64: (53, -1022)}


def ulp_fmt(y: torch.Tensor, fid: int, dtype=torch.float32) -> torch.Tensor:
    """Spacing of format `fid` (capped at the carrier `dtype`'s) at |y|,
    in float64."""
    f = FORMAT_LIST[fid]
    t_c, emin_c = _CARRIER_T[dtype]
    t, emin = min(f.t, t_c), max(f.emin, emin_c)
    ay = y.double().abs()
    e = torch.floor(torch.log2(torch.where(ay > 0, ay, torch.ones_like(ay))))
    e = torch.clamp(torch.where(ay > 0, e, torch.full_like(e, emin)),
                    min=emin)
    return torch.pow(2.0, e - t + 1)


def held(got: torch.Tensor, want: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, fid: int, Kp: int, chop_out: bool):
    """A chopped GEMM's result `got` against its plain version `want`, on
    got's device: (ok, max abs error, largest share of the tolerance).
    ok when every element is equal (a NaN matches a NaN) or both are
    finite and |got - want| <= ulp_fmt(|want|) (with the output rounding)
    + Kp u sum_k |chop(a)_ik| |chop(b)_kj|, u the unit roundoff of got's
    carrier (2^-24 on float32, 2^-53 on float64): two summation orders of
    the same products plus one flipped output rounding. The error is 0
    where equal and inf where only one side is finite."""
    dev, carrier = got.device, got.dtype
    t_c, _ = _CARRIER_T[carrier]
    # abs(), not abs_(): for a format the chop leaves alone on a float64
    # operand, chop and .double() return the operand itself.
    ac = chop(a.to(dev, carrier), fid).double().abs()
    bc = chop(b.to(dev, carrier), fid).double().abs()
    tol = (ac @ bc).mul_(Kp * 2.0 ** -t_c)
    del ac, bc
    if chop_out:
        tol += ulp_fmt(want, fid, carrier)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    fin = torch.isfinite(got) & torch.isfinite(want)
    diff = (got.double() - want.double()).abs_()
    ok = bool((same | (fin & (diff <= tol))).all())
    diff = torch.where(same, torch.zeros_like(diff), torch.where(
        fin, diff, torch.full_like(diff, float("inf"))))
    if not diff.numel():
        return ok, 0.0, 0.0
    return ok, float(diff.max()), float(diff.div_(tol).max())


def pack_equal(pa: torch.Tensor, pb: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, fid: int) -> bool:
    """The pack kernel's outputs (`ops._pack`) against `pack_ref`: pa is
    chop(A) with K zero-padded, pb chop(B) transposed, bit for bit, and
    NaN where the plain version has a NaN (a NaN's payload is the
    conversion's own)."""
    Kp = pa.shape[1]
    want_a = pack_ref(F.pad(a.float(), (0, Kp - a.shape[1])), fid)
    want_b = pack_ref(F.pad(b.float(), (0, 0, 0, Kp - b.shape[0])).t()
                      .contiguous(), fid)
    for got, want in ((pa, want_a), (pb, want_b)):
        got, want = got.cpu(), want.cpu()
        if got.dtype != want.dtype or got.shape != want.shape:
            return False
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            return False
        bits = torch.int16 if got.element_size() == 2 else torch.int32
        if not torch.equal(got[~nan].view(bits), want[~nan].view(bits)):
            return False
    return True
