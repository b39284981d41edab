"""Torch port vs the JAX package: the flash attention forward
`flash_attention_op`, run on the CPU (its plain version, `flash_ref`).

Held against the JAX package's `flash_attention_op` (the Pallas kernel
in interpret mode) and its oracle `flash_ref`, on the cases of
tests/test_kernels_flash.py: causal, local windows of 64 and 100, chunks
of 128 and a logit softcap of 50, at the GQA shapes (2, 256, 4, 2, 64)
and (1, 384, 8, 8, 32) (B, S, Hq, Hkv, D); with Sq != Sk; over several
block sizes; against the model's einsum attention (`_sdpa`) at the
gemma2-9b smoke config; and with bf16 inputs and outputs.

Tolerances are those of the JAX package's own tests: float32 2e-5
(rtol and atol; the two sides sum the same terms in another order and
the online softmax rescales), 3e-5 against `_sdpa` (which also rounds
the probabilities before the value product), bf16 2e-2 (one bf16
rounding of the output, 2^-8 relative, plus the order).

The CUDA kernel is held against the same plain version on the card in
test_torch_cuda.py and in chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_op as jflash_op
from repro.kernels.flash_attention import flash_ref as jflash_ref
from repro_torch.kernels import library
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention_op,
                                                 flash_ref)

CASES = [
    dict(kind="attn"),
    dict(kind="local", window=64),
    dict(kind="local", window=100),
    dict(kind="chunked", chunk=128),
    dict(kind="attn", softcap=50.0),
]
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, sq, hq, hkv, d, sk=None, seed=5):
    rng = np.random.default_rng(seed)
    sk = sk or sq
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


def _jref(q, k, v, **kw):
    """The JAX oracle in the model layout (as tests/test_kernels_flash.py)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.transpose(0, 2, 1, 3).reshape(b * hq, sq, d)
    kf = k.transpose(0, 2, 1, 3).reshape(b * hkv, k.shape[1], d)
    vf = v.transpose(0, 2, 1, 3).reshape(b * hkv, v.shape[1], d)
    o = jflash_ref(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf),
                   groups=hq // hkv, **kw)
    return np.asarray(o).reshape(b, hq, sq, d).transpose(0, 2, 1, 3)


def _port(q, k, v, **kw):
    return flash_attention_op(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", [(2, 256, 4, 2, 64), (1, 384, 8, 8, 32)])
def test_flash_matches_jax_op_and_oracle(case, shape):
    b, s, hq, hkv, d = shape
    q, k, v = _qkv(b, s, hq, hkv, d)
    got = _port(q, k, v, bq=128, bk=128, **case)
    assert got.shape == q.shape and got.dtype == np.float32
    want_op = np.asarray(jflash_op(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), bq=128, bk=128,
                                   interpret=True, **case))
    np.testing.assert_allclose(got, want_op, **TOL)
    np.testing.assert_allclose(got, _jref(q, k, v, **case), **TOL)


@pytest.mark.parametrize("sq,sk", [(128, 256), (256, 128)])
def test_flash_with_sq_not_sk(sq, sk):
    q, k, v = _qkv(1, sq, 4, 2, 32, sk=sk, seed=sq)
    for case in (dict(kind="attn"), dict(kind="local", window=64)):
        if sq > sk and case["kind"] == "local":
            continue   # rows past Sk + window would see no key at all
        got = _port(q, k, v, **case)
        want = np.asarray(jflash_op(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True, **case))
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, _jref(q, k, v, **case), **TOL)


def test_flash_block_size_sweep():
    q, k, v = _qkv(1, 256, 2, 1, 32)
    want = _jref(q, k, v, kind="attn")
    for bq, bk in [(64, 64), (128, 64), (256, 128), (64, 256)]:
        got = _port(q, k, v, bq=bq, bk=bk)
        np.testing.assert_allclose(got, want, **TOL)
        jgot = np.asarray(jflash_op(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), bq=bq, bk=bk,
                                    interpret=True))
        np.testing.assert_allclose(got, jgot, **TOL)


def test_flash_matches_model_attention():
    """Cross-check against the model's einsum attention path."""
    from repro.configs import get_smoke
    from repro.models.attention import _sdpa, attn_mask
    cfg = get_smoke("gemma2-9b")
    b, s, d = 2, 128, cfg.head_dim
    q, k, v = _qkv(b, s, cfg.n_heads, cfg.n_kv_heads, d, seed=9)
    pos = jnp.arange(s)
    mask = attn_mask(pos, pos, "local", cfg.window, 0)[None]
    want = np.asarray(_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask, 1.0 / np.sqrt(d), cfg.attn_softcap))
    got = _port(q, k, v, kind="local", window=cfg.window,
                softcap=cfg.attn_softcap, bq=64, bk=64)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_flash_bf16_io():
    q, k, v = _qkv(1, 128, 2, 2, 64, seed=11)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_attention_op(qb, kb, vb, bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    jb = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (qb, kb, vb)]
    jgot = np.asarray(jflash_op(*jb, interpret=True, bq=64, bk=64))
    want = _jref(*(x.float().numpy() for x in (qb, kb, vb)), kind="attn")
    for ref in (jgot.astype(np.float32), want):
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   rtol=2e-2, atol=2e-2)


def test_flash_ref_uses_the_finite_sentinel():
    """A fully masked row of the oracle is a softmax over equal sentinels
    (a mean of v), not NaN."""
    assert NEG_INF == -2.0 ** 30
    q = torch.randn(1, 4, 8)
    k = torch.randn(1, 2, 8)
    v = torch.arange(16, dtype=torch.float32).reshape(1, 2, 8)
    out = flash_ref(q, k, v, kind="local", window=2)  # row 3 sees no key
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 3], v[0].mean(0))


@pytest.mark.parametrize("kw", [
    dict(kind="local", window=0),
    dict(kind="local", window=-3),
    dict(kind="chunked", chunk=0),
    dict(kind="attn", softcap=-1.0),
    dict(kind="sliding"),
    dict(bq=96),          # 128 % 96: the JAX op asserts
    dict(bk=0),
])
def test_flash_raises_where_the_kernel_and_oracle_disagree(kw):
    q, k, v = _qkv(1, 128, 2, 1, 16)
    with pytest.raises(ValueError):
        _port(q, k, v, **kw)


def test_flash_plain_launches_nothing():
    q, k, v = _qkv(1, 64, 2, 1, 16)
    library.reset_launches()
    _port(q, k, v, kind="chunked", chunk=32)
    assert sum(library.LAUNCHES.values()) == 0
