"""The premise of the chopped GEMM's tensor-core route, on the CPU.

`csrc/qgemm.cu` feeds the tensor cores chop(x) cast to a narrower type
(`kernels.qmatmul.ROUTES`): bf16 for e5m2, e4m3 and bf16, fp16 for fp16,
and float32 with the low 13 mantissa bits zero (tf32) for tf32. That is
only the same computation if the cast loses nothing. Here the plain pack
step `pack_ref` is held to chop bit for bit on every float32 exponent
field, both signs, random fractions, signed zeros, infinities, the
smallest subnormals and the saturation values; a NaN stays a NaN (its
payload is the type's own). Products of two packed values are exact in
float32, so float32 accumulation of them computes what the TPU kernel
computes, up to the summation order. fp32 and fp64 go to the FFMA
kernel: no tensor-core type holds them.

The kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py phases 3 and 7); here the two checks they are held
with there, `checks.held` and `checks.pack_equal`, are shown to accept
what they should and to reject one flipped bit, NaN or infinity.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.qmatmul import ROUTES, pack_ref
from repro_torch.kernels.qmatmul.checks import (float32_patterns, held,
                                                pack_equal)
from repro_torch.kernels.qmatmul.ops import packed_k
from repro_torch.precision import FORMAT_LIST, chop

TENSOR_CORE_FIDS = [0, 1, 2, 3, 4]      # e5m2, e4m3, bf16, fp16, tf32


def _format_edges(fid):
    """The format's smallest subnormal and normal, largest value, and the
    values just beside them, both signs."""
    f = FORMAT_LIST[fid]
    vals = []
    for v in (f.xmin_sub, f.xmin, min(f.xmax, float(np.finfo(np.float32).max))):
        v32 = np.float32(v)
        vals += [v32, np.nextafter(v32, np.float32(0)),
                 np.nextafter(v32, np.float32(np.inf)), v * 1.5]
    with np.errstate(over="ignore"):    # 1.5 float32's max is inf
        vals = np.asarray(vals, np.float32)
    return torch.from_numpy(np.concatenate([vals, -vals]))


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("fid", TENSOR_CORE_FIDS)
def test_pack_ref_is_chop_in_the_operand_type(fid):
    x = torch.cat([float32_patterns(fid), _format_edges(fid)])
    packed = pack_ref(x, fid)
    assert packed.dtype == ROUTES[fid][0]
    back, want = packed.float(), chop(x, fid)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(back), nan)
    assert torch.equal(_bits(back[~nan]), _bits(want[~nan]))


def test_tf32_chop_clears_the_low_13_bits():
    x = torch.cat([float32_patterns(4), _format_edges(4)])
    c = chop(x, 4)
    assert bool(((_bits(c[~torch.isnan(c)]) & 0x1FFF) == 0).all())
    # A NaN keeps a NaN pattern in the top 19 bits, the ones tf32 reads.
    top = _bits(pack_ref(x, 4)) & ~0x1FFF
    assert torch.equal(torch.isnan(top.view(torch.float32)), torch.isnan(c))


@pytest.mark.parametrize("fid", TENSOR_CORE_FIDS)
def test_products_of_packed_values_are_exact_in_float32(fid):
    """A float32 product of two packed values is the exact product, where
    it lies in float32's normal range: the operand types have at most 11
    significand bits, and 11 + 11 <= 24."""
    rng = np.random.default_rng(10 + fid)
    f = FORMAT_LIST[fid]
    lo = max(f.emin, -60)
    hi = min(int(np.floor(np.log2(f.xmax))), 60)
    mag = 2.0 ** rng.uniform(lo, hi, (2, 4096)) * rng.choice([-1.0, 1.0],
                                                             (2, 4096))
    a, b = (pack_ref(torch.tensor(m, dtype=torch.float32), fid).double()
            for m in mag)
    exact = a * b       # float64 holds a 22-bit product exactly
    assert torch.equal(exact.float().double(), exact)


def test_route_table_sends_fp32_and_fp64_to_ffma():
    names = {f.name: fid for fid, f in enumerate(FORMAT_LIST)}
    assert set(ROUTES) == set(range(len(FORMAT_LIST)))
    assert {fid for fid, (_, route) in ROUTES.items() if route == "ffma"} \
        == {names["fp32"], names["fp64"]}
    assert {fid: dtype for fid, (dtype, route) in ROUTES.items()
            if route == "wgmma"} == {
        names["e5m2"]: torch.bfloat16, names["e4m3"]: torch.bfloat16,
        names["bf16"]: torch.bfloat16, names["fp16"]: torch.float16,
        names["tf32"]: torch.float32}


@pytest.mark.parametrize("dtype,k_tile", [(torch.bfloat16, 64),
                                          (torch.float16, 64),
                                          (torch.float32, 32)])
def test_packed_k_rounds_to_the_k_tile(dtype, k_tile):
    for K in (0, 1, 63, 64, 65, 129, 300, 3584):
        Kp = packed_k(K, dtype)
        assert Kp % k_tile == 0 and 0 <= Kp - max(K, 1) < k_tile
        assert Kp * dtype.itemsize % 128 == 0


def test_held_accepts_the_order_tolerance_and_nothing_more():
    """`held` takes a last-bit change inside Kp 2^-24 sum|a||b| (+ the
    output rounding), a NaN where the plain version has one and an equal
    infinity; it rejects a difference past the tolerance, a NaN or an
    infinity against a finite value, and an infinity of the other sign."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(8, 64, generator=g), torch.randn(64, 8, generator=g)
    want = chop(chop(a, 2) @ chop(b, 2), 2)
    ok, err, share = held(want.clone(), want, a, b, 2, 64, True)
    assert ok and err == 0.0 and share == 0.0
    near = want.clone()
    near[0, 0] = torch.nextafter(near[0, 0], torch.tensor(np.inf))
    ok, err, share = held(near, want, a, b, 2, 64, False)
    assert ok and err > 0 and 0 < share <= 1
    for bad in (want[0, 0] + 1e3, np.nan, np.inf):
        got = want.clone()
        got[0, 0] = bad
        ok, err, _ = held(got, want, a, b, 2, 64, True)
        assert not ok and err > 1
    nan_want, inf_want = want.clone(), want.clone()
    nan_want[1, 1], inf_want[2, 2] = np.nan, np.inf
    assert held(nan_want.clone(), nan_want, a, b, 2, 64, True)[0]
    assert held(inf_want.clone(), inf_want, a, b, 2, 64, True)[0]
    flipped = inf_want.clone()
    flipped[2, 2] = -np.inf
    assert not held(flipped, inf_want, a, b, 2, 64, True)[0]


@pytest.mark.parametrize("fid", TENSOR_CORE_FIDS)
def test_pack_equal_takes_pack_ref_and_rejects_one_flipped_bit(fid):
    """`pack_equal` on the plain pack's own output (what the kernel must
    write) is True; with one bit of one element flipped, or a row of
    padding not zero, it is False."""
    x = float32_patterns(fid)
    a = x.repeat(2)[:129 * 130].reshape(129, 130)
    b = x.flip(0).repeat(2)[:130 * 127].reshape(130, 127)
    Kp = packed_k(130, ROUTES[fid][0])
    pa = pack_ref(torch.nn.functional.pad(a, (0, Kp - 130)), fid)
    pb = pack_ref(torch.nn.functional.pad(b, (0, 0, 0, Kp - 130)).t()
                  .contiguous(), fid)
    assert pack_equal(pa, pb, a, b, fid)
    bits = torch.int16 if pa.element_size() == 2 else torch.int32
    flipped = pa.clone()
    flipped.view(bits)[3, 5] ^= 1 << 10
    assert not pack_equal(flipped, pb, a, b, fid)
    padded = pb.clone()
    padded[:, -1] = 1.0
    assert not pack_equal(pa, padded, a, b, fid)
