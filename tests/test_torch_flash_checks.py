"""The premise of flash attention's wgmma route, on the CPU, before any
card: `checks.flash_tiled_ref`, the plain float32 model of that route's
numerics (key tiles of 64 or 128, the online softmax, P rounded to bf16
before P V, l from the unrounded p), stays within `within_bf16_rows` (two
bf16 ulps of each output row's largest |want|) of the plain version
`flash_ref` and of the JAX package's `flash_attention_op` in interpret
mode with bf16 inputs and outputs. Every kind, a softcap of 50, GQA
groups 1, 2 and 5, ragged S (1, 63, 65, 200), Sq != Sk (128 against 320)
and every head dim, at small sizes; one JAX compile per shape serves
every case (kind, window, chunk and softcap are runtime arguments of the
Pallas kernel). Planted faults fail the same check, and `ROUTES` sends
bf16 at D 64, 128 and 256 to the wgmma kernel and everything else to the
SIMT kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_op as jflash_op
from repro_torch.kernels import library
from repro_torch.kernels.flash_attention import (HEAD_DIMS, ROUTES, WGMMA_BK,
                                                 flash_attention_op,
                                                 flash_ref)
from repro_torch.kernels.flash_attention.checks import (flash_tiled_ref,
                                                        round_significant,
                                                        within_bf16_rows)

CASES = [
    dict(kind="attn"),
    dict(kind="local", window=64),
    dict(kind="local", window=100),
    dict(kind="chunked", chunk=48),
    dict(kind="chunked", chunk=128),
    dict(kind="attn", softcap=50.0),
    dict(kind="local", window=100, softcap=50.0),
]
# (B, Sq, Sk, Hq, Hkv): groups 2, 5, 1, 2, 5; Sq < Sk in the last (a row
# past Sk + window would see no key, where the kernels and the oracle
# differ by design).
SHAPES = [(1, 1, 1, 2, 1), (1, 63, 63, 5, 1), (2, 65, 65, 2, 2),
          (1, 200, 200, 4, 2), (1, 128, 320, 5, 1)]


def _qkv(shape, d, seed):
    """bf16 q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) from numpy."""
    b, sq, sk, hq, hkv = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)).to(torch.bfloat16)
        for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))


def _heads(x):
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _jax_heads(q, k, v, case):
    """The JAX op (Pallas kernel in interpret mode) on the same bf16
    operands, heads first like `flash_ref`'s output."""
    j = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
         for x in (q, k, v)]
    o = np.array(jflash_op(*j, bq=q.shape[1], bk=k.shape[1],
                           interpret=True, **case).astype(jnp.float32))
    return _heads(torch.from_numpy(o)).to(torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiled_model_within_bf16_rows_of_plain_and_jax(d, shape):
    q, k, v = _qkv(shape, d, seed=d + shape[1])
    groups = shape[3] // shape[4]
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    for case in CASES:
        want = flash_ref(qf, kf, vf, groups=groups, **case)
        jgot = _jax_heads(q, k, v, case)
        for bk in (64, 128):
            got = flash_tiled_ref(qf, kf, vf, groups=groups, bk=bk, **case)
            assert got.dtype == torch.bfloat16
            assert within_bf16_rows(got, want)[0], (case, bk)
            assert within_bf16_rows(got, jgot)[0], (case, bk)


@pytest.mark.parametrize("fault", ["skipped key tile", "P in e4m3's 4 bits",
                                   "P with 8 bits fewer than bf16"])
def test_planted_fault_fails_the_row_check(fault):
    shape, d, bk = (1, 200, 200, 4, 2), 64, 64
    q, k, v = _qkv(shape, d, seed=7)
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    for case in CASES:
        want = flash_ref(qf, kf, vf, groups=2, **case)
        good = flash_tiled_ref(qf, kf, vf, groups=2, bk=bk, **case)
        if fault == "skipped key tile":   # the last tile, live in every kind
            bad = flash_tiled_ref(qf, kf, vf, groups=2, bk=bk,
                                  tiles=range(200 // bk), **case)
        else:
            bits = 4 if "e4m3" in fault else 0
            bad = flash_tiled_ref(qf, kf, vf, groups=2, bk=bk, p_bits=bits,
                                  **case)
        assert within_bf16_rows(good, want)[0], case
        assert not within_bf16_rows(bad, want)[0], case


def test_p_rounding_to_8_bits_is_bf16():
    x = torch.from_numpy(np.random.default_rng(3).random(100000)
                         .astype(np.float32))
    assert torch.equal(round_significant(x, 8), x.bfloat16().float())


def test_routes_send_bf16_at_64_128_256_to_wgmma():
    want = {(dt, d): "wgmma" if dt == torch.bfloat16 and d >= 64 else "simt"
            for dt in (torch.float32, torch.bfloat16) for d in HEAD_DIMS}
    assert ROUTES == want
    assert set(WGMMA_BK) == {d for (dt, d), r in ROUTES.items()
                             if r == "wgmma"}


def test_cpu_runs_the_plain_version_on_any_route():
    q, k, v = _qkv((1, 64, 64, 2, 1), 64, seed=1)
    library.reset_launches()
    want = flash_attention_op(q, k, v, kind="local", window=16)
    for route in ("simt", "wgmma"):
        got = flash_attention_op(q, k, v, kind="local", window=16,
                                 route=route)
        assert torch.equal(got, want)
    assert sum(library.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        flash_attention_op(q, k, v, route="tensor")
