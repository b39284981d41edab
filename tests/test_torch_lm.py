"""The torch port's LM serving stack (`repro_torch.configs`, `models`,
`serve`, `launch`) against the JAX package's on the CPU.

Weights are the JAX package's `init_params` tree carried over by
`models.params_from_reference`; tokens and prefix embeddings come from a
numpy seed. Everything runs in float32 on both sides.

Tolerances (stated once, used throughout):
  * float32 logits, losses and hidden values within `TOL` = 1e-5 of the
    reference's scale (max |want| of the compared tensor): the same
    arithmetic in another order of float32 sums (the einsums, cuBLAS or
    MKL against XLA; the Mamba scan's doubling tree against
    `lax.associative_scan`; the reference multiplies scores by a float64
    scale under x64 and rounds back);
  * greedy tokens equal;
  * integer bookkeeping (cache lengths, capacity, configs' parameter
    counts) equal.

On the CPU the full-sequence attention takes the flash route's plain
version (`flash_ref`) wherever the kernel has a route, so these tests
hold the route's mask mapping, padding and head grouping against the
reference's einsum too. Each arch's reference outputs are computed once
per module, under one `jax.jit` (op-by-op dispatch of the reference
costs several times its compile).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as ref_all_archs
from repro.configs import get_smoke as ref_get_smoke
from repro.models import attention as ref_attn
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_caches as ref_init_caches
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.models import mamba as ref_mamba
from repro.models import moe as ref_moe
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import generate as ref_generate
from repro_torch.configs import ARCHS, get_arch, get_smoke
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, loss_fn, params_from_reference)
from repro_torch.models import attention, mamba, moe
from repro_torch.models.transformer import tree_leaves
from repro_torch.precision import FORMAT_ID
from repro_torch.serve import ServeConfig, generate

TOL = 1e-5
KEY = jax.random.PRNGKey(0)
ARCH_NAMES = sorted(ARCHS)
B, S = 2, 64
CPU = "cpu"


def close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max err {err:.3e} > {tol} x {scale:.3e}"


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    prefix = None
    if cfg.frontend == "vision_stub":
        prefix = rng.standard_normal(
            (b, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return tokens, prefix


@pytest.fixture(scope="module")
def arch():
    """name -> (cfg, reference params tree, port params, tokens, prefix,
    reference outputs), built once per arch per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = ref_get_smoke(name)
            tree = jax.jit(lambda k: ref_init_params(cfg, k, jnp.float32))(KEY)
            params = params_from_reference(to_np(tree), get_smoke(name), CPU)
            tokens, prefix = _inputs(cfg)
            pe = None if prefix is None else jnp.asarray(prefix)

            @jax.jit
            def outputs(tree, tokens, pe):
                batch = {"tokens": tokens}
                if pe is not None:
                    batch["prefix_embeds"] = pe
                logits = ref_forward(tree, tokens, cfg, jnp.float32,
                                     prefix_embeds=pe)
                loss, aux = ref_loss_fn(tree, batch, cfg, jnp.float32)
                caches = ref_init_caches(cfg, B, 8, jnp.float32)
                dec = ref_decode_step(tree, tokens[:, :1], caches, cfg,
                                      jnp.float32)
                return logits, loss, aux["ntokens"], dec

            logits, loss, ntokens, (dlogits, dcaches) = outputs(
                tree, jnp.asarray(tokens), pe)
            cache[name] = dict(
                cfg=cfg, tree=tree, params=params, tokens=tokens,
                prefix=prefix, logits=np.asarray(logits), loss=float(loss),
                ntokens=float(ntokens), dlogits=np.asarray(dlogits),
                dcaches=to_np(dcaches))
        return cache[name]
    return get


def test_configs_are_the_references():
    """Every arch's config and smoke config equal the reference's field
    for field, and so do their analytic parameter counts and cells."""
    ref = ref_all_archs()
    assert sorted(ref) == ARCH_NAMES
    for name in ARCH_NAMES:
        for mine, theirs in ((get_arch(name), ref[name]),
                             (get_smoke(name), ref_get_smoke(name))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert mine.params_total() == theirs.params_total()
            assert mine.params_active() == theirs.params_active()
            assert mine.pattern_len == theirs.pattern_len
    from repro.configs import valid_cells as ref_cells
    from repro_torch.configs import valid_cells
    for name in ARCH_NAMES:
        assert [c.name for c in valid_cells(get_arch(name))] == \
            [c.name for c in ref_cells(ref[name])]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_matches_reference(arch, name):
    a = arch(name)
    got = forward(a["params"], torch.from_numpy(a["tokens"]),
                  get_smoke(name), torch.float32,
                  prefix_embeds=None if a["prefix"] is None
                  else torch.from_numpy(a["prefix"]), device=CPU)
    assert got.dtype == torch.float32
    close(got, a["logits"])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_matches_reference(arch, name):
    a = arch(name)
    batch = {"tokens": torch.from_numpy(a["tokens"])}
    if a["prefix"] is not None:
        batch["prefix_embeds"] = torch.from_numpy(a["prefix"])
    loss, aux = loss_fn(a["params"], batch, get_smoke(name), torch.float32,
                        device=CPU)
    close(loss.item(), a["loss"])
    assert aux["ntokens"].item() == a["ntokens"]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_step_matches_reference(arch, name):
    """One decode step from `init_caches`: the logits, and every cache
    leaf (K/V rows, latent rows, conv windows, SSM states, lengths)."""
    a = arch(name)
    cfg = get_smoke(name)
    caches = init_caches(cfg, B, 8, torch.float32, device=CPU)
    logits, caches = decode_step(a["params"],
                                 torch.from_numpy(a["tokens"][:, :1]),
                                 caches, cfg, torch.float32, device=CPU)
    close(logits, a["dlogits"])
    got = tree_leaves(caches)
    want = jax.tree_util.tree_leaves(a["dcaches"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            close(g, w) if np.abs(w).max() > 0 else \
                np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name,kv", [("granite-3-2b", None),
                                     ("gemma2-9b", "e4m3")])
def test_generate_greedy_matches_reference(arch, name, kv):
    """Greedy float32 generation, with the KV cache in float32 and rounded
    to e4m3 (the chop's plain version here): the same tokens."""
    a = arch(name)
    prompts = a["tokens"][:, :6]
    fmt = None if kv is None else FORMAT_ID[kv]
    want = np.asarray(ref_generate(
        a["tree"], jnp.asarray(prompts), a["cfg"],
        RefServeConfig(max_new_tokens=5, compute_dtype=jnp.float32,
                       cache_fmt=fmt), KEY))
    got = generate(a["params"], torch.from_numpy(prompts), get_smoke(name),
                   ServeConfig(max_new_tokens=5, compute_dtype=torch.float32,
                               cache_fmt=fmt), device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_needs_a_generator_and_stays_in_range(arch):
    a = arch("musicgen-large")
    cfg = get_smoke("musicgen-large")
    scfg = ServeConfig(max_new_tokens=4, temperature=1.0,
                       compute_dtype=torch.float32)
    prompts = torch.from_numpy(a["tokens"][:, :3])
    with pytest.raises(ValueError, match="Generator"):
        generate(a["params"], prompts, cfg, scfg, device=CPU)
    toks = generate(a["params"], prompts, cfg, scfg,
                    torch.Generator().manual_seed(0), device=CPU)
    again = generate(a["params"], prompts, cfg, scfg,
                     torch.Generator().manual_seed(0), device=CPU)
    assert toks.shape == (B, 4) and torch.equal(toks, again)
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size


def test_moe_ffn_drops_over_capacity_as_the_reference():
    """A router that sends most tokens to one expert, capacity factor
    0.5: slots drop, and the same ones as in the reference (the stable
    sort), so the outputs agree; the auxiliary loss too."""
    cfg = dataclasses.replace(ref_get_smoke("jamba-v0.1-52b"),
                              capacity_factor=0.5)
    p = ref_moe.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    router = np.asarray(p["router"]).copy()
    router[:, 1] += 0.5                     # expert 1 is everyone's first
    p = dict(p, router=jnp.asarray(router))
    x = np.random.default_rng(5).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_moe.moe_ffn(p, jnp.asarray(x), cfg))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    tcfg = dataclasses.replace(get_smoke("jamba-v0.1-52b"),
                               capacity_factor=0.5)
    got = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    close(got, want)
    # Over capacity: an expert is picked by more slots than it holds.
    probs = moe._router_probs(tp, torch.from_numpy(x))
    top = torch.topk(probs, tcfg.top_k, dim=-1).indices
    per_expert = torch.bincount(top[0].reshape(-1), minlength=tcfg.n_experts)
    assert moe.capacity(32, tcfg) == ref_moe.capacity(32, cfg)
    assert int(per_expert.max()) > moe.capacity(32, tcfg)
    close(moe.aux_load_balance_loss(tp, torch.from_numpy(x), tcfg).item(),
          float(ref_moe.aux_load_balance_loss(p, jnp.asarray(x), cfg)))


def test_mamba_forward_matches_stepped_decode_and_reference():
    """At S = 256 (two chunks of `CHUNK`): the chunked scan against the
    JAX package's, and against `mamba_decode` stepped token by token."""
    cfg = ref_get_smoke("falcon-mamba-7b")
    p = ref_mamba.init_mamba(jax.random.PRNGKey(4), cfg, jnp.float32)
    x = (0.5 * np.random.default_rng(6).standard_normal(
        (2, 256, cfg.d_model))).astype(np.float32)
    want = np.asarray(ref_mamba.mamba_forward(p, jnp.asarray(x), cfg))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    tcfg = get_smoke("falcon-mamba-7b")
    got = mamba.mamba_forward(tp, torch.from_numpy(x), tcfg)
    close(got, want)
    cache = mamba.init_mamba_cache(2, tcfg, torch.float32, CPU)
    steps = []
    for t in range(x.shape[1]):
        y, cache = mamba.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      cache, tcfg)
        steps.append(y)
    close(torch.cat(steps, dim=1), want)


@pytest.mark.parametrize("kind,field", [("local", "window"),
                                        ("chunked", "attn_chunk")])
def test_degenerate_masks_run_causal(kind, field):
    """`local` with window 0 and `chunked` with chunk 0 are plain causal
    in the reference's `attn_mask`; the flash route maps them to kind
    "attn" (the wrapper refuses both) and gives the reference's output."""
    cfg = dataclasses.replace(ref_get_smoke("gemma2-9b"), **{field: 0})
    tcfg = dataclasses.replace(get_smoke("gemma2-9b"), **{field: 0})
    assert attention.flash_mask(kind, tcfg) == ("attn", 0, 0)
    p = ref_attn.init_gqa(jax.random.PRNGKey(7), cfg, jnp.float32)
    x = np.random.default_rng(8).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    want = np.asarray(ref_attn.gqa_forward(p, jnp.asarray(x), cfg, kind,
                                           jnp.asarray(pos)))
    causal = np.asarray(ref_attn.gqa_forward(p, jnp.asarray(x), cfg, "attn",
                                             jnp.asarray(pos)))
    np.testing.assert_array_equal(want, causal)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    got = attention.gqa_forward(tp, torch.from_numpy(x), tcfg, kind,
                                torch.from_numpy(pos).long())
    close(got, want)
    with attention.plain_attention():
        plain = attention.gqa_forward(tp, torch.from_numpy(x), tcfg, kind,
                                      torch.from_numpy(pos).long())
    close(plain, want)


@pytest.mark.parametrize("kind", ["attn", "local", "chunked"])
def test_flash_route_pads_to_the_block_and_groups_heads(kind):
    """S = 200 pads to 256 at its end: the flash route's output equals
    the plain einsum's (the reference's `_sdpa_full`) on the same q, k, v,
    with 4 query heads over 2 kv heads (h reads kv head h // 2)."""
    cfg = dataclasses.replace(get_smoke("gemma2-9b"), window=48,
                              attn_chunk=64, attn_softcap=50.0)
    g = torch.Generator().manual_seed(9)
    q = torch.randn(2, 200, 4, 16, generator=g)
    k, v = (torch.randn(2, 200, 2, 16, generator=g) for _ in range(2))
    pos = torch.arange(200)
    got = attention.sdpa_flash(q, k, v, kind, cfg, 0.25)
    mask = attention.attn_mask(pos, pos, kind, cfg.window,
                               cfg.attn_chunk)[None]
    want = attention.sdpa_plain(q, k, v, mask, 0.25, cfg.attn_softcap)
    close(got, want)
    ref = ref_attn._sdpa_full(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              jnp.asarray(mask.numpy()), 0.25, 50.0)
    close(got, np.asarray(ref))


def test_flash_rule():
    """Which forwards take the flash route: float32 and bf16 at the
    kernel's head dims; not float16 or float64, not head dim 96
    (phi-3-vision) or 12, not inside `plain_attention()`."""
    for d in HEAD_DIMS:
        assert attention.flash_rule(torch.float32, d)
        assert attention.flash_rule(torch.bfloat16, d)
        assert not attention.flash_rule(torch.float16, d)
        assert not attention.flash_rule(torch.float64, d)
    for d in (12, 96):
        assert not attention.flash_rule(torch.float32, d)
        assert not attention.flash_rule(torch.bfloat16, d)
    assert get_arch("phi-3-vision-4.2b").head_dim == 96
    with attention.plain_attention():
        assert not attention.flash_rule(torch.bfloat16, 256)
    assert attention.flash_rule(torch.bfloat16, 256)


def test_params_from_reference_checks_the_tree(arch):
    a = arch("gemma-2b")
    tree = to_np(a["tree"])
    bad = jax.tree_util.tree_map(lambda v: v, tree)
    bad["final_norm"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(bad, get_smoke("gemma-2b"), CPU)
    del bad["final_norm"]
    with pytest.raises(ValueError, match="tree"):
        params_from_reference(bad, get_smoke("gemma-2b"), CPU)
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(tree, get_smoke("granite-3-2b"), CPU)


def test_init_params_draws_from_the_generator():
    """Same seed, same parameters; the tree has the reference's structure
    and shapes; pinned leaves stay float32 under a bf16 model."""
    cfg = get_smoke("jamba-v0.1-52b")
    a = init_params(cfg, torch.Generator().manual_seed(1), torch.bfloat16,
                    CPU)
    b = init_params(cfg, torch.Generator().manual_seed(1), torch.bfloat16,
                    CPU)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
    ref = jax.eval_shape(
        lambda k: ref_init_params(ref_get_smoke("jamba-v0.1-52b"), k,
                                  jnp.bfloat16), KEY)
    dtypes = {jnp.dtype(jnp.float32): torch.float32,
              jnp.dtype(jnp.bfloat16): torch.bfloat16}
    mine = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), a)
    theirs = jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), dtypes[jnp.dtype(x.dtype)]), ref)
    assert mine == theirs
    mixer = a["layers"]["l0"]["mixer"]
    assert mixer["A_log"].dtype == torch.float32
    assert a["layers"]["l1"]["ffn"]["router"].dtype == torch.float32


def test_residual_sharding_waits_for_the_sharded_executor(arch):
    """Sequence parallelism needs `distributed/` (ROADMAP Queue 1 item 7):
    any `residual_sharding` but None raises and says so."""
    a = arch("granite-3-2b")
    cfg = get_smoke("granite-3-2b")
    tokens = torch.from_numpy(a["tokens"])
    for call in (lambda: forward(a["params"], tokens, cfg, torch.float32,
                                 residual_sharding="data", device=CPU),
                 lambda: loss_fn(a["params"], {"tokens": tokens}, cfg,
                                 torch.float32, residual_sharding="data",
                                 device=CPU)):
        with pytest.raises(NotImplementedError, match="item 7"):
            call()
