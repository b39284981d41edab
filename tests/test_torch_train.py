"""The torch port's training stack (`repro_torch.train`, `data.tokens`,
`checkpoint`, `launch.train` and the differentiable `models.loss_fn`)
against the JAX package's on the CPU.

Every comparison starts both packages from the same numpy state: the
JAX package's `init_params` / `init_train_state` tree carried over by
`models.params_from_reference` / `train.train_state_from_reference`,
tokens from `TokenPipeline` or a numpy seed. Float32 throughout unless a
test says otherwise.

Tolerances (stated once, used throughout):
  * `quantize_int8` codes and scales, `dequantize_int8`, token batches,
    the controller's decisions, rewards and Q-table: equal (the same
    float32 operations, rounding half to even on both sides, and the same
    numpy generator);
  * `cosine_with_warmup` within `LR_RTOL` = 1e-6 relative (float32 cos
    of XLA and of torch may differ by an ulp);
  * `adamw_update` within `OPT_TOL` = 1e-6 of each leaf's scale (max
    |want|): the same float32 operations, the global norm summed in
    another order; with int8 moments within `STEP_TOL` (below), since a
    moment an ulp from a code's half-way point rounds to either side and
    that code's step (the block's absmax / 127) enters the update;
  * the loss and each gradient leaf within `TOL` = 1e-5 of the
    reference's scale: the forward's float32 sums in another order
    (tests/test_torch_lm.py) carried through the backward. A leaf whose
    gradient is zero in exact arithmetic is held to `ZERO_TOL` = 1e-6 of
    the gradient tree's largest value on both sides instead: with top-1
    routing the normalised gate is p / p = 1, so the router's gradient
    is rounding noise (about 1e-9 against gradients of about 1e-2) whose
    sign differs between the packages;
  * 3 train steps: losses within `TOL` of the loss, parameters and
    float32 moments within `STEP_TOL` = 1e-4 of each leaf's scale
    (AdamW's m / sqrt(v) normalises each gradient to about 1, so a
    gradient near zero turns a 1e-5 difference into a larger one);
    int8 moment codes within one code (a float32 moment a rounding away
    from a code's half-way point rounds to either side). With int8
    moments each step starts from the reference's state before it, and
    after the first step only the entries whose second-moment code
    before the step is not 0 are held to it: the reference's int8 second
    moment rounds small entries to the code 0, and the next step divides
    their first moment by about |g| (sqrt of 0.05 g^2), so both packages
    throw those entries to |p| of 10-30 within two steps at lr 3e-3, and
    there a 1e-6 difference in a small gradient is a large difference in
    the update (ROADMAP Queue 3). Loss and gradient norm are held on
    every step.

On the CPU the full-sequence attention runs the flash wrapper's plain
version through its autograd Function, so the gradients here hold the
Function's backward (the gradient of `flash_ref`) against the
reference's differentiated einsum. Each JAX program is compiled once
under `jax.jit` and shared within the file.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_smoke as ref_get_smoke
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import LMPrecisionPolicy as RefLMPrecisionPolicy
from repro.train import TrainPrecisionController as RefController
from repro.train import TrainStepConfig as RefTrainStepConfig
from repro.train import adamw_init as ref_adamw_init
from repro.train import adamw_update as ref_adamw_update
from repro.train import cosine_with_warmup as ref_cosine
from repro.train import dequantize_int8 as ref_dequantize
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro.train import quantize_int8 as ref_quantize
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_smoke
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import loss_fn, params_from_reference
from repro_torch.models.transformer import tree_leaves
from repro_torch.precision import FORMAT_ID
from repro_torch.train import (AdamWConfig, LMPrecisionPolicy, QTensor,
                               TrainPrecisionController, TrainStepConfig,
                               adamw_init, adamw_update, cast_params,
                               cosine_with_warmup, dequantize_int8,
                               init_train_state, make_train_step,
                               quantize_int8, train_state_from_reference)

TOL = 1e-5
ZERO_TOL = 1e-6
OPT_TOL = 1e-6
STEP_TOL = 1e-4
LR_RTOL = 1e-6
KEY = jax.random.PRNGKey(0)
CPU = "cpu"
GRAD_ARCHS = ("granite-3-2b", "gemma2-9b", "deepseek-v2-236b",
              "llama4-scout-17b-16e", "falcon-mamba-7b")
STEP_ARCH = "granite-3-2b"
B, S = 2, 64
F32 = dict(compute_dtype=jnp.float32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def scaled(got, want):
    """max |got - want| over max |want| (1e-30 floor)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def flat_state(state, port):
    """{key: numpy array} of a train state, in the checkpoints' keys."""
    return ckpt._flatten(state) if port else ref_ckpt._flatten(state)


def assert_states_close(got, want, tol=STEP_TOL, keep=None):
    """Two flattened train states: the same keys; step counts equal;
    float leaves within `tol` of each leaf's scale; int8 codes within one
    code of each other. `keep` ({key: bool mask}) limits a parameter
    leaf's comparison to the masked entries."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if keep is not None and k in keep:
            g, w = g[keep[k]], w[keep[k]]
        if w.dtype.kind in "iu":
            diff = np.abs(g.astype(np.int64) - w.astype(np.int64))
            assert diff.max(initial=0) <= (1 if k.endswith("__qcodes")
                                           else 0), k
        else:
            assert scaled(g, w) <= tol, (k, scaled(g, w))


def kept_by_int8_v(rstate):
    """{parameter key: entries whose int8 second-moment code in the
    reference's state `rstate` is not 0} (module docstring)."""
    flat = flat_state(rstate, False)
    return {"/params" + k[len("/opt/v"):-len("/__qcodes")]: v != 0
            for k, v in flat.items()
            if k.startswith("/opt/v/") and k.endswith("/__qcodes")}


@pytest.fixture(scope="module")
def ref_step():
    """(arch, tcfg fields as a tuple) -> the reference's jitted train step,
    compiled once for the file."""
    cache = {}

    def get(name, opt, **fields):
        key = (name, repr(sorted(opt.items())), repr(sorted(fields.items())))
        if key not in cache:
            cfg = ref_get_smoke(name)
            tcfg = RefTrainStepConfig(opt=RefAdamWConfig(**opt), **fields)
            cache[key] = (tcfg, jax.jit(ref_make_train_step(cfg, tcfg)))
        return cache[key]
    return get


# ---------------------------------------------------------------------------
# quantize, schedule, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [((700,), 256), ((3, 100), 256),
                                         ((5, 7, 9), 32), ((1,), 256)])
def test_quantize_int8_codes_and_scales_equal_the_reference(shape, block):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 2, shape)
         ).astype(np.float32)
    flat = x.reshape(-1)
    if flat.size > block:
        flat[block:2 * block] = 0.0          # a block of zeros
    if flat.size > 3:
        flat[1] = flat[0] * 0.5 / 127.0 * 127  # a code at a half-way point
    want = ref_quantize(jnp.asarray(x), block)
    got = quantize_int8(torch.tensor(x), block)
    assert got.codes.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(
        dequantize_int8(got, block).numpy(),
        np.asarray(ref_dequantize(want, block)))
    if flat.size > block:
        assert float(got.scales[1]) == 0.0


def test_cosine_with_warmup_equals_the_reference():
    for peak, warm, total in ((3e-4, 100, 1000), (3e-3, 5, 60),
                              (1e-2, 0, 10)):
        steps = np.arange(total + 6)
        want = np.array([float(ref_cosine(s, peak_lr=peak, warmup=warm,
                                          total=total)) for s in steps])
        got = np.array([float(cosine_with_warmup(
            torch.tensor(s, dtype=torch.int32), peak_lr=peak, warmup=warm,
            total=total)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0)


@pytest.fixture(scope="module")
def granite_tree():
    cfg = ref_get_smoke(STEP_ARCH)
    return cfg, to_np(jax.jit(lambda k: ref_init_params(cfg, k,
                                                        jnp.float32))(KEY))


@pytest.mark.parametrize("quant,grad_scale", [(False, 1.0), (True, 1.0),
                                              (False, 1e-3), (True, 1e-3)])
def test_adamw_update_equals_the_reference(granite_tree, quant, grad_scale):
    """Three updates from the same parameters and gradients, with the
    moments in float32 or int8, and with clipping active (gradients of
    norm far above 1) or not (norm below 1)."""
    cfg, tree = granite_tree
    rng = np.random.default_rng(2)
    ocfg = dict(quantize_moments=quant)
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    rstate = ref_adamw_init(rparams, RefAdamWConfig(**ocfg))
    params = params_from_reference(tree, get_smoke(STEP_ARCH), CPU)
    state = adamw_init(params, AdamWConfig(**ocfg))
    update = jax.jit(lambda p, g, s, lr: ref_adamw_update(
        p, g, s, lr, RefAdamWConfig(**ocfg)))
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * grad_scale
                       ).astype(np.float32), tree)
        lr = np.float32(1e-3 * (i + 1))
        rparams, rstate, rstats = update(rparams, jax.tree_util.tree_map(
            jnp.asarray, g), rstate, jnp.asarray(lr))
        params, state, stats = adamw_update(
            params, params_from_reference(g, get_smoke(STEP_ARCH), CPU),
            state, torch.tensor(lr), AdamWConfig(**ocfg))
        assert scaled(float(stats["grad_norm"]),
                      float(rstats["grad_norm"])) <= OPT_TOL
    gn = float(rstats["grad_norm"])
    assert (gn > 1.0) == (grad_scale == 1.0)        # clipping active
    assert int(state.step) == int(rstate.step) == 3
    assert_states_close(ckpt._flatten((params, state)),
                        ref_ckpt._flatten((rparams, rstate)),
                        STEP_TOL if quant else OPT_TOL)
    if quant:
        assert isinstance(state.m["embed"]["embedding"], QTensor)


def test_adamw_reads_a_missing_gradient_as_zero(granite_tree):
    cfg, tree = granite_tree
    params = params_from_reference(tree, get_smoke(STEP_ARCH), CPU)
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    grads = params_from_reference(zeros, get_smoke(STEP_ARCH), CPU)
    grads["layers"]["l0"]["mixer"]["wq"] = None
    grads["final_norm"] = None
    p1, s1, st1 = adamw_update(params_from_reference(
        tree, get_smoke(STEP_ARCH), CPU), grads,
        adamw_init(params), 1e-2)
    p2, s2, st2 = adamw_update(params, params_from_reference(
        zeros, get_smoke(STEP_ARCH), CPU), adamw_init(params), 1e-2)
    assert float(st1["grad_norm"]) == float(st2["grad_norm"]) == 0.0
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)
    # Zero gradient: the update is the decay, p (1 - lr wd).
    w = torch.tensor(tree["layers"]["l0"]["mixer"]["wq"])
    torch.testing.assert_close(p1["layers"]["l0"]["mixer"]["wq"],
                               w - 1e-2 * (0.1 * w), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# TokenPipeline
# ---------------------------------------------------------------------------

def test_token_pipeline_equals_the_reference_with_resume_and_shards():
    kw = dict(vocab_size=512, seq_len=64, batch_size=4, seed=3)
    mine, ref = TokenPipeline(**kw), RefTokenPipeline(**kw)
    for _ in range(3):
        a, b = mine.next_batch(), ref.next_batch()
        for k in ("tokens", "loss_mask"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # Resume from the state dict, in each package from the other's.
    resumed = TokenPipeline(**{**kw, "seed": 0})
    resumed.load_state_dict(ref.state_dict())
    ref_resumed = RefTokenPipeline(**{**kw, "seed": 0})
    ref_resumed.load_state_dict(mine.state_dict())
    np.testing.assert_array_equal(resumed.next_batch()["tokens"],
                                  ref_resumed.next_batch()["tokens"])
    # Shards draw disjoint batches; an elastic resize keeps the cursor.
    shards = [TokenPipeline(**kw, shard=i, n_shards=2) for i in range(2)]
    refs = [RefTokenPipeline(**kw, shard=i, n_shards=2) for i in range(2)]
    got = [p.next_batch()["tokens"] for p in shards]
    for g, r in zip(got, refs):
        np.testing.assert_array_equal(g, r.next_batch()["tokens"])
    assert not np.array_equal(got[0], got[1])
    grown = TokenPipeline(**kw)
    grown.load_state_dict(shards[1].state_dict(), new_shard=2,
                          new_n_shards=3)
    ref_grown = RefTokenPipeline(**kw)
    ref_grown.load_state_dict(refs[1].state_dict(), new_shard=2,
                              new_n_shards=3)
    assert grown.state_dict() == ref_grown.state_dict() == {
        "cursor": 1, "seed": 3, "shard": 2, "n_shards": 3}
    np.testing.assert_array_equal(grown.next_batch()["tokens"],
                                  ref_grown.next_batch()["tokens"])


# ---------------------------------------------------------------------------
# loss_fn and its gradient
# ---------------------------------------------------------------------------

def _zero_leaves(cfg):
    """Leaves whose gradient is zero in exact arithmetic (module
    docstring): the routers of a top-1 MoE."""
    return {"router"} if cfg.n_experts and cfg.top_k == 1 else set()


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_loss_and_gradient_equal_the_reference(name):
    cfg = ref_get_smoke(name)
    tree = jax.jit(lambda k: ref_init_params(cfg, k, jnp.float32))(KEY)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.9).astype(np.float32)
    (rloss, raux), rgrads = jax.jit(jax.value_and_grad(
        lambda p, t, m: ref_loss_fn(p, {"tokens": t, "loss_mask": m}, cfg,
                                    jnp.float32), has_aux=True))(
        tree, jnp.asarray(tokens), jnp.asarray(mask))
    params = params_from_reference(to_np(tree), get_smoke(name), CPU)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = loss_fn(params, {"tokens": torch.tensor(tokens),
                                 "loss_mask": torch.tensor(mask)},
                        get_smoke(name), torch.float32, device=CPU)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert scaled(float(loss.detach()), float(rloss)) <= TOL
    assert float(aux["ntokens"]) == float(raux["ntokens"])
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rgrads)[0]]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(rgrads)]
    assert len(want) == len(grads)
    top = max(np.abs(w).max() for w in want)
    zero = _zero_leaves(cfg)
    for path, g, w in zip(paths, grads, want):
        assert g is not None, path
        g = g.detach().numpy()
        if any(f"'{z}'" in path for z in zero):
            assert np.abs(g).max() <= ZERO_TOL * top, path
            assert np.abs(w).max() <= ZERO_TOL * top, path
        else:
            assert scaled(g, w) <= TOL, (path, scaled(g, w))


def test_forward_without_autograd_runs_straight_through(monkeypatch):
    """Remat only under autograd: under `torch.no_grad` the groups and
    loss chunks run without `torch.utils.checkpoint`, with it they run
    under it, and both give the same loss."""
    from repro_torch.models import transformer
    cfg = get_smoke(STEP_ARCH)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     torch.float32, CPU)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    calls = []
    real = transformer.checkpoint

    def counting(fn, ctx, group_fn, *args, **kw):
        calls.append(group_fn)
        return real(fn, ctx, group_fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counting)
    with torch.no_grad():
        plain, _ = loss_fn(params, {"tokens": tokens}, cfg, torch.float32,
                           device=CPU)
    assert calls == []
    remat, _ = loss_fn(params, {"tokens": tokens}, cfg, torch.float32,
                       device=CPU)
    n_groups = cfg.n_layers // cfg.pattern_len
    assert [c.__name__ for c in calls] == \
        ["_group_forward"] * n_groups + ["_chunk_nll"] * 8
    assert float(remat) == float(plain)


def test_the_recompute_keeps_the_forwards_attention_route(monkeypatch):
    """A loss taken under `plain_attention()` and differentiated outside
    it (as autograd's device thread does on the card, where the context
    variable is not set) recomputes each group on the plain attention:
    the flash wrapper is never called, and the gradient equals the one
    taken inside the block."""
    from repro_torch.models import attention
    cfg = get_smoke(STEP_ARCH)
    params = init_train_state(cfg, torch.Generator().manual_seed(0),
                              TrainStepConfig(), CPU).params
    leaves = tree_leaves(params)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    for p in leaves:
        p.requires_grad_(True)
    with attention.plain_attention():
        loss, _ = loss_fn(params, {"tokens": tokens}, cfg, torch.float32,
                          device=CPU)
        inside = torch.autograd.grad(loss, leaves)
        loss, _ = loss_fn(params, {"tokens": tokens}, cfg, torch.float32,
                          device=CPU)
    flash = []
    real = attention.flash_attention_op
    monkeypatch.setattr(attention, "flash_attention_op",
                        lambda *a, **kw: flash.append(1) or real(*a, **kw))
    outside = torch.autograd.grad(loss, leaves)
    assert flash == []
    for a, b in zip(outside, inside):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

def _both_states(name, tcfg_ref, tcfg):
    cfg = ref_get_smoke(name)
    rstate = jax.jit(lambda k: ref_init_train_state(cfg, k, tcfg_ref))(KEY)
    state = train_state_from_reference(to_np(rstate), get_smoke(name), CPU)
    return rstate, state


def _batches(cfg, n, b=B, s=S):
    pipe = TokenPipeline(cfg.vocab_size, s, b, seed=5)
    return [pipe.next_batch() for _ in range(n)]


@pytest.mark.parametrize("variant", ["plain", "quantize_moments",
                                     "cast_params_for_compute"])
def test_train_steps_equal_the_reference(ref_step, variant):
    """Three steps of the port's `make_train_step` against the reference's
    jitted step from the same state and batches. `cast_params_for_compute`
    runs in float32 on both sides (the cast keeps every leaf; the
    reference's bf16 compute rounds elsewhere than torch's)."""
    opt = {"quantize_moments": True} if variant == "quantize_moments" else {}
    fields = dict(peak_lr=3e-3, warmup=2, total_steps=10)
    if variant == "cast_params_for_compute":
        fields["cast_params_for_compute"] = True
    rtcfg, rstep = ref_step(STEP_ARCH, opt=opt, **F32, **fields)
    tcfg = TrainStepConfig(opt=AdamWConfig(**opt),
                           compute_dtype=torch.float32, **fields)
    rstate, state = _both_states(STEP_ARCH, rtcfg, tcfg)
    step = make_train_step(get_smoke(STEP_ARCH), tcfg)
    for i, batch in enumerate(_batches(ref_get_smoke(STEP_ARCH), 3)):
        keep = None
        if opt:        # int8 moments: from the reference's state (above)
            state = train_state_from_reference(
                to_np(rstate), get_smoke(STEP_ARCH), CPU)
            keep = kept_by_int8_v(rstate) if i else None
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        assert scaled(float(m["loss"]), float(rm["loss"])) <= TOL
        assert scaled(float(m["lr"]), float(rm["lr"])) <= LR_RTOL
        assert scaled(float(m["grad_norm"]), float(rm["grad_norm"])) <= TOL
        assert_states_close(flat_state(state, True),
                            flat_state(rstate, False), keep=keep)
    assert all(not p.requires_grad for p in tree_leaves(state.params))


def test_cast_params_keeps_the_router_in_float32():
    cfg = get_smoke("llama4-scout-17b-16e")
    params = init_train_state(cfg, torch.Generator().manual_seed(0),
                              TrainStepConfig(), CPU).params
    cast = cast_params(params, torch.bfloat16)
    ffn = cast["layers"]["l0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["wi_gate"].dtype == torch.bfloat16
    assert cast["embed"]["embedding"].dtype == torch.bfloat16


def test_emulated_policy_gradient_is_zero_and_the_step_equals_the_reference(
        ref_step):
    """Under an emulated `LMPrecisionPolicy` the reference's gradient
    through `chop` is zero, so every weight reached only through a policy
    matmul moves by AdamW's decay alone; the port's step (the chopped
    operands carrying no gradient, a missing gradient read as zero) gives
    the reference's state."""
    name = STEP_ARCH
    cfg = ref_get_smoke(name)
    fmt = FORMAT_ID["e4m3"]
    rpolicy = RefLMPrecisionPolicy(jnp.asarray(fmt, jnp.int32))
    fields = dict(peak_lr=3e-3, warmup=2, total_steps=10)
    rtcfg = RefTrainStepConfig(**F32, **fields)
    rstep = jax.jit(ref_make_train_step(cfg, rtcfg, policy=rpolicy))
    tcfg = TrainStepConfig(compute_dtype=torch.float32, **fields)
    rstate, state = _both_states(name, rtcfg, tcfg)
    batch = _batches(cfg, 1)[0]
    rgrads = jax.jit(jax.grad(lambda p: ref_loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, cfg, jnp.float32,
        rpolicy)[0]))(rstate.params)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rgrads)[0]]
    zero = {p for p, g in zip(paths, jax.tree_util.tree_leaves(rgrads))
            if not np.any(np.asarray(g))}
    # Every matmul weight and every norm feeding only matmuls: zero.
    assert {p for p in paths if "'mixer'" in p or "'ffn'" in p
            or "'ln" in p} <= zero
    assert "['embed']['embedding']" not in zero      # residual + unembed
    step = make_train_step(get_smoke(name), tcfg,
                           policy=LMPrecisionPolicy(fmt))
    before = {k: v.copy() for k, v in flat_state(state, True).items()}
    rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, batch)
    assert scaled(float(m["loss"]), float(rm["loss"])) <= TOL
    after = flat_state(state, True)
    assert_states_close(after, flat_state(rstate, False))
    # Decay alone on the zero-gradient leaves: p (1 - lr wd), lr at step 0.
    lr = float(m["lr"])
    for path in zero:
        key = "/params" + path.replace("['", "/").replace("']", "")
        p0 = before[key]
        np.testing.assert_allclose(after[key], p0 - lr * (0.1 * p0),
                                   rtol=1e-6, atol=1e-12)


def test_a_loss_that_reaches_no_parameter_is_not_differentiated():
    """A policy whose matmuls carry no gradient at all, on a config whose
    unembedding is a plain matmul too: the step still runs, every
    gradient is read as zero."""
    cfg = get_smoke(STEP_ARCH)
    tcfg = TrainStepConfig(compute_dtype=torch.float32, peak_lr=1e-2,
                           warmup=0, total_steps=10)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), tcfg,
                             CPU)
    p0 = [p.clone() for p in tree_leaves(state.params)]

    def detached_loss(params, batch, *args, **kw):
        loss, aux = loss_fn(params, batch, *args, **kw)
        return loss.detach(), aux

    from repro_torch.train import train_step as ts
    real = ts.loss_fn
    ts.loss_fn = detached_loss
    try:
        state, m = make_train_step(cfg, tcfg)(state, _batches(cfg, 1)[0])
    finally:
        ts.loss_fn = real
    assert float(m["grad_norm"]) == 0.0
    lr = float(m["lr"])
    for a, b in zip(tree_leaves(state.params), p0):
        torch.testing.assert_close(a, b - lr * (0.1 * b), rtol=1e-6,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# TrainPrecisionController
# ---------------------------------------------------------------------------

def test_precision_controller_equals_the_reference():
    mine = TrainPrecisionController(total_decisions=60, interval=1, seed=3)
    ref = RefController(total_decisions=60, interval=1, seed=3)
    rng = np.random.default_rng(6)
    for _ in range(80):
        feats = mine.features(10 ** rng.uniform(-2.5, 2.5),
                              10 ** rng.uniform(-5, 0.5))
        a, b = mine.act(feats), ref.act(feats)
        assert a.matmul_fmt == int(b.matmul_fmt)
        assert (a.comm_fmt, a.opt_8bit) == (b.comm_fmt, b.opt_8bit)
        before, after = 2.0, 2.0 + rng.normal(0, 0.3)
        diverged = bool(rng.random() < 0.1)
        mine.observe(before, after, diverged)
        ref.observe(before, after, diverged)
    assert mine.history == ref.history
    np.testing.assert_array_equal(mine.qt.Q, ref.qt.Q)
    np.testing.assert_array_equal(mine.qt.N, ref.qt.N)


def test_default_policy_and_native_matmul():
    pol = LMPrecisionPolicy(FORMAT_ID["bf16"], emulate=False)
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    w = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(pol.matmul(x, w, "attn"), x @ w, rtol=0,
                               atol=0)
    from repro_torch.train import default_policy
    assert default_policy("e4m3").matmul_fmt == FORMAT_ID["e4m3"]


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _small_state(quant=False, seed=0):
    cfg = get_smoke(STEP_ARCH)
    tcfg = TrainStepConfig(opt=AdamWConfig(quantize_moments=quant),
                           compute_dtype=torch.float32, peak_lr=1e-2,
                           warmup=0, total_steps=10)
    state = init_train_state(cfg, torch.Generator().manual_seed(seed), tcfg,
                             CPU)
    state, _ = make_train_step(cfg, tcfg)(state, _batches(cfg, 1)[0])
    return cfg, tcfg, state


@pytest.mark.parametrize("quant", [False, True])
def test_checkpoint_round_trip(tmp_path, quant):
    cfg, tcfg, state = _small_state(quant)
    save_checkpoint(str(tmp_path), 1, state, {"pipeline": {"cursor": 1}})
    template = init_train_state(cfg, torch.Generator().manual_seed(9), tcfg,
                                CPU)
    got, meta = restore_checkpoint(str(tmp_path), template)
    assert meta == {"step": 1, "pipeline": {"cursor": 1}}
    assert type(got) is type(state)
    want, have = ckpt._flatten(state), ckpt._flatten(got)
    assert sorted(want) == sorted(have)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k])
        assert have[k].dtype == want[k].dtype
    if quant:
        assert isinstance(got.opt.m["embed"]["embedding"], QTensor)
        assert any(k.endswith("|__qcodes") for k in np.load(
            os.path.join(tmp_path, "step_00000001", "arrays.npz")).files)


def test_checkpoint_latest_after_several_saves_and_an_interrupted_one(
        tmp_path, monkeypatch):
    d = str(tmp_path)
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, {"x": torch.zeros(2)})
    for step in (3, 6, 9):
        save_checkpoint(d, step, {"x": torch.full((2,), float(step))})
    assert latest_step(d) == 9
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read() == "step_00000009"

    # A save cut after its step directory, before LATEST moves.
    def cut(*args, **kw):
        raise KeyboardInterrupt("cut before LATEST")

    monkeypatch.setattr(ckpt.tempfile, "NamedTemporaryFile", cut)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(d, 12, {"x": torch.full((2,), 12.0)})
    monkeypatch.undo()
    assert os.path.isdir(os.path.join(d, "step_00000012"))
    assert latest_step(d) == 9
    got, meta = restore_checkpoint(d, {"x": torch.zeros(2)})
    assert meta["step"] == 9 and torch.equal(got["x"], torch.full((2,), 9.))
    # A save cut while writing its arrays leaves no step and no temp dir.
    monkeypatch.setattr(ckpt.np, "savez", cut)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(d, 15, {"x": torch.zeros(2)})
    monkeypatch.undo()
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000003",
                                     "step_00000006", "step_00000009",
                                     "step_00000012"]
    # bf16 leaves go through float32 and come back in the template's dtype.
    save_checkpoint(d, 18, {"x": torch.tensor([1.5, -2.25],
                                              dtype=torch.bfloat16)})
    z = np.load(os.path.join(d, "step_00000018", "arrays.npz"))
    assert z["|x"].dtype == np.float32
    got, _ = restore_checkpoint(d, {"x": torch.zeros(2,
                                                     dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16
    assert got["x"].tolist() == [1.5, -2.25]


@pytest.mark.parametrize("quant", [False, True])
def test_checkpoints_restore_across_the_packages(tmp_path, ref_step, quant):
    """A reference checkpoint restores into the port's `TrainState` and a
    port checkpoint into the reference's; one step from each restored
    state equals the other package's step from its own."""
    opt = {"quantize_moments": True} if quant else {}
    fields = dict(peak_lr=3e-3, warmup=2, total_steps=10)
    rtcfg, rstep = ref_step(STEP_ARCH, opt=opt, **F32, **fields)
    tcfg = TrainStepConfig(opt=AdamWConfig(**opt),
                           compute_dtype=torch.float32, **fields)
    cfg = ref_get_smoke(STEP_ARCH)
    b1, b2 = _batches(cfg, 2)
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    rstate = jax.jit(lambda k: ref_init_train_state(cfg, k, rtcfg))(KEY)
    rstate, _ = rstep(rstate, jb(b1))
    step = make_train_step(get_smoke(STEP_ARCH), tcfg)

    # Reference -> port.
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1, rstate)
    template = init_train_state(get_smoke(STEP_ARCH),
                                torch.Generator().manual_seed(0), tcfg, CPU)
    state, meta = restore_checkpoint(str(tmp_path / "ref"), template)
    assert meta["step"] == 1 and int(state.step) == 1
    assert_states_close(flat_state(state, True), flat_state(rstate, False),
                        0.0)
    keep = kept_by_int8_v(rstate) if quant else None
    state, m = step(state, b2)
    rnext, rm = rstep(rstate, jb(b2))
    assert scaled(float(m["loss"]), float(rm["loss"])) <= TOL
    assert_states_close(flat_state(state, True), flat_state(rnext, False),
                        keep=keep)

    # Port -> reference.
    save_checkpoint(str(tmp_path / "port"), 2, state)
    rtemplate = jax.jit(lambda k: ref_init_train_state(cfg, k, rtcfg))(
        jax.random.PRNGKey(1))
    rback, meta = ref_ckpt.restore_checkpoint(str(tmp_path / "port"),
                                              rtemplate)
    assert meta["step"] == 2 and int(rback.step) == 2
    assert_states_close(flat_state(rback, False), flat_state(state, True),
                        0.0)
    b3 = _batches(cfg, 3)[2]
    keep = kept_by_int8_v(rback) if quant else None
    rfinal, rm = rstep(rback, jb(b3))
    state, m = step(state, b3)
    assert scaled(float(m["loss"]), float(rm["loss"])) <= TOL
    assert_states_close(flat_state(state, True), flat_state(rfinal, False),
                        keep=keep)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", STEP_ARCH, "--smoke", "--batch", "2", "--seq", "32",
          "--lr", "3e-3"]


class Killed(BaseException):
    """Stands for the process being killed."""


def test_launcher_resumes_to_the_uninterrupted_run(tmp_path, capsys,
                                                   monkeypatch):
    """A 9-step run killed right after its step-6 checkpoint, relaunched
    over the same directory, resumes from step 6 (parameters, moments,
    step and the pipeline's cursor) and ends where an uninterrupted
    9-step run ends. (A run launched with `--steps 6` would not do: the
    learning rate's cosine runs to `--steps`.)"""
    from repro_torch.launch import train as launch
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    real = launch.save_checkpoint

    def save_then_die(ckpt_dir, step, *args, **kw):
        out = real(ckpt_dir, step, *args, **kw)
        if step == 6:
            raise Killed
        return out

    monkeypatch.setattr(launch, "save_checkpoint", save_then_die)
    with pytest.raises(Killed):
        launch.main(LAUNCH + ["--steps", "9", "--ckpt-every", "3",
                              "--ckpt-dir", d1], device=CPU)
    monkeypatch.undo()
    assert latest_step(d1) == 6
    assert sorted(x for x in os.listdir(d1) if x.startswith("step_")) == [
        "step_00000003", "step_00000006"]
    with open(os.path.join(d1, "step_00000006", "meta.json")) as f:
        assert json.load(f)["pipeline"]["cursor"] == 6
    capsys.readouterr()
    resumed, loss = launch.main(LAUNCH + ["--steps", "9", "--ckpt-dir", d1],
                                device=CPU)
    out = capsys.readouterr().out
    assert "[train] resumed from step 6" in out
    assert "[train] done at step 9" in out
    whole, whole_loss = launch.main(
        LAUNCH + ["--steps", "9", "--ckpt-dir", d2], device=CPU)
    assert int(resumed.step) == int(whole.step) == 9
    assert abs(loss - whole_loss) <= TOL * abs(whole_loss)
    assert_states_close(flat_state(resumed, True), flat_state(whole, True),
                        TOL)


def test_launcher_autotune_and_quantized_moments_and_the_mesh_flags(
        tmp_path, capsys):
    from repro_torch.launch import train as launch
    state, loss = launch.main(
        LAUNCH + ["--steps", "12", "--ckpt-every", "100", "--autotune",
                  "--quant-moments", "--ckpt-dir", str(tmp_path)],
        device=CPU)
    assert int(state.step) == 12 and np.isfinite(loss)
    assert isinstance(state.opt.m["embed"]["embedding"], QTensor)
    assert latest_step(str(tmp_path)) == 12
    # The production meshes need 256 / 512 ranks: on a world of one they
    # raise, as the reference's do on a one-device host.
    for flag, need in ((["--production-mesh"], 256),
                       (["--production-mesh", "--multi-pod"], 512)):
        with pytest.raises(RuntimeError, match=f"needs {need} devices"):
            launch.main(LAUNCH + flag + ["--ckpt-dir", str(tmp_path)],
                        device=CPU)
    # --multi-pod alone keeps the host mesh, and --grad-sync has no
    # effect (the reference never reads it): both resume and finish.
    for flag in (["--multi-pod"], ["--grad-sync", "int8"]):
        again, _ = launch.main(
            LAUNCH + ["--steps", "12", "--quant-moments", "--ckpt-dir",
                      str(tmp_path)] + flag, device=CPU)
        assert int(again.step) == 12
    # The launcher ends the world of one it started.
    assert not torch.distributed.is_initialized()
