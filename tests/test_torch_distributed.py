"""The multi-device layer of the LM stack on the CPU: the sharding rules
(`repro_torch.distributed`), the mesh constructors (`launch.mesh`), the
cross-pod gradient sync (`train.grad_sync`) and the train launcher's
mesh, against the JAX package's.

  * The reference's `test_param_specs_rules` and `test_cache_specs_rules`
    cases, on a (4, 4) `DeviceMesh`.
  * Every leaf of every arch's parameter tree, AdamW state (float and
    int8 moments) and caches (batch 32, and batch 1 for the
    long-context rules), from the port's own `init_train_state` /
    `init_caches` at the smoke configs: its path and its spec equal the
    reference's, from `jax.eval_shape` of the same trees, on (4, 4),
    (16, 16) and (2, 16, 16) meshes. The port's meshes are DeviceMeshes
    over PyTorch's fake process group (`fake_world`, destroyed after
    each test); the reference's are built from `jax.devices() * k`, as
    its own test builds them. A reference spec compares with the port's
    through its own `__eq__` (JAX writes `("data",)` as "data").
  * `named`'s placements; `make_production_mesh` raises on a small
    world and builds on a world of 256 / 512; `make_host_mesh` starts a
    world of one without a process group; the launcher refuses a state
    that a world of several ranks would shard.
  * `sync_leaf` and `sync_grads` in gloo worlds of 2 and 4 ranks (one
    process a rank, started from this test), each rank's leaves drawn
    from a numpy seed, against the reference's `sync_leaf` under
    `jax.vmap(..., axis_name="pod")` on the stacked leaves. The int8
    mode and every mode at 2 ranks are bit-equal. At 4 ranks the
    reference sums left to right and gloo in its own order, so fp32 and
    bf16 are held to the rounding of a 4-term sum: |port - ref| <=
    3 eps sum_r |g_r| / n, eps of float32 or of bf16 (each order is
    within 3 u sum |g_r| of the exact sum, u = eps / 2; bf16 rounds the
    leaves first, the same in both, and n is a power of two).
"""
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_smoke as ref_get_smoke
from repro.distributed.sharding import _path_str as ref_path_str
from repro.distributed.sharding import cache_specs as ref_cache_specs
from repro.distributed.sharding import param_specs as ref_param_specs
from repro.models import init_caches as ref_init_caches
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import TrainStepConfig as RefTrainStepConfig
from repro.train import init_train_state as ref_init_train_state
from repro.train import sync_grads as ref_sync_grads
from repro.train import sync_leaf as ref_sync_leaf
from repro_torch.configs import ARCHS, get_smoke
from repro_torch.distributed import (cache_spec, cache_specs, named,
                                     param_specs, spec_for_param)
from repro_torch.distributed.sharding import (PartitionSpec as P,
                                              tree_map_with_path)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_caches
from repro_torch.train import (AdamWConfig, TrainStepConfig,
                               init_train_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ARCH_NAMES = sorted(ARCHS)
MESHES = {"4x4": ((4, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def fake_world():
    """`fake_world(n)`: a fake process group of `n` ranks (this process
    rank 0), destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()

    def start(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(fake_world, key):
    shape, names = MESHES[key]
    fake_world(math.prod(shape))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(CPU, shape, mesh_dim_names=names)


def _ref_mesh(key):
    shape, names = MESHES[key]
    devs = np.array(jax.devices() * math.prod(shape))[:math.prod(shape)]
    return Mesh(devs.reshape(shape), names)


# ---------------------------------------------------------------------------
# The reference's rule cases
# ---------------------------------------------------------------------------

def test_param_specs_rules(fake_world):
    mesh = _mesh(fake_world, "4x4")
    s = spec_for_param("embed/embedding", (256, 64), mesh)
    assert s == P("model", ("data",))
    s = spec_for_param("layers/l0/mixer/wq", (2, 64, 128), mesh)
    assert s == P(None, ("data",), "model")
    s = spec_for_param("layers/l0/ffn/wi_gate", (2, 8, 64, 128), mesh)
    assert s == P(None, "model", ("data",), None)   # MoE expert bank
    s = spec_for_param("prefix/[0]/ffn/wi_gate", (64, 128), mesh)
    assert s == P(("data",), "model")               # dense FFN
    s = spec_for_param("layers/l0/ln1", (64,), mesh)
    assert s == P()
    # Divisibility: a dim not divisible by the axis drops the axis.
    s = spec_for_param("layers/l0/mixer/wq", (2, 63, 130), mesh)
    assert s == P(None, None, None)
    # Quantized moment leaves inherit the parent param's rule.
    s = spec_for_param("opt/m/layers/l0/mixer/wq/codes", (2, 64, 128), mesh)
    assert s == P(None, ("data",), "model")


def test_cache_specs_rules(fake_world):
    mesh = _mesh(fake_world, "4x4")
    # batch shardable -> batch over data, heads over model
    assert cache_spec("layers/l0/k", (8, 1024, 4, 64), mesh) == \
        P(("data",), None, "model", None)
    # batch=1 long context -> sequence over data
    assert cache_spec("layers/l0/k", (1, 4096, 4, 64), mesh) == \
        P(None, ("data",), "model", None)
    # MLA latent cache
    assert cache_spec("layers/l0/ckv", (8, 1024, 32), mesh) == \
        P(("data",), None, None)
    # mamba state
    assert cache_spec("layers/l0/h", (8, 128, 4), mesh) == \
        P(("data",), "model", None)


# ---------------------------------------------------------------------------
# Every leaf of every arch's trees against the reference
# ---------------------------------------------------------------------------

def _port_specs(specs):
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__("/".join(path), s),
                       specs, is_leaf=lambda x: isinstance(x, P))
    return out


def _ref_specs(specs):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {ref_path_str(path): s for path, s in leaves}


def _trees(name):
    """The port's trees and the reference's shapes of the same trees:
    train states with float and int8 moments, caches at batch 32 and 1."""
    cfg, ref_cfg = get_smoke(name), ref_get_smoke(name)
    port, ref = {}, {}
    for q in (False, True):
        port[f"state-q{q}"] = init_train_state(
            cfg, torch.Generator().manual_seed(0),
            TrainStepConfig(opt=AdamWConfig(quantize_moments=q)),
            device=CPU)
        ref[f"state-q{q}"] = jax.eval_shape(
            lambda: ref_init_train_state(
                ref_cfg, jax.random.PRNGKey(0),
                RefTrainStepConfig(opt=RefAdamWConfig(quantize_moments=q))))
    for b in (32, 1):
        port[f"cache-b{b}"] = init_caches(cfg, b, 64, torch.float32,
                                          device=CPU)
        ref[f"cache-b{b}"] = jax.eval_shape(
            lambda: ref_init_caches(ref_cfg, b, 64, jnp.float32))
    return port, ref


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_leaf_spec_equals_the_reference(fake_world, name):
    port, ref = _trees(name)
    for key in MESHES:
        mesh, ref_mesh = _mesh(fake_world, key), _ref_mesh(key)
        for tree in port:
            fn, ref_fn = ((param_specs, ref_param_specs)
                          if tree.startswith("state")
                          else (cache_specs, ref_cache_specs))
            got = _port_specs(fn(port[tree], mesh))
            want = _ref_specs(ref_fn(ref[tree], ref_mesh))
            assert sorted(got) == sorted(want), (name, key, tree)
            for path, spec in got.items():
                assert want[path] == tuple(spec), (name, key, tree, path,
                                                   spec, want[path])
        dist.destroy_process_group()


def test_named_gives_one_placement_per_mesh_dimension(fake_world):
    mesh = _mesh(fake_world, "2x16x16")
    tree = {"a": P(("pod", "data"), "model"), "b": [P(), P(None, "data")],
            "c": P(None, ("data",), None)}
    got = named(tree, mesh)
    assert got["a"] == (Shard(0), Shard(0), Shard(1))
    assert got["b"][0] == (Replicate(),) * 3
    assert got["b"][1] == (Replicate(), Shard(1), Replicate())
    assert got["c"] == (Replicate(), Shard(1), Replicate())


# ---------------------------------------------------------------------------
# Meshes and the launcher's mesh
# ---------------------------------------------------------------------------

def test_make_production_mesh_raises_on_a_small_world(fake_world):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 256 devices, have 1"):
        make_production_mesh(device=CPU)
    assert not dist.is_initialized()       # raising made no group
    fake_world(16)
    with pytest.raises(RuntimeError, match="needs 512 devices, have 16"):
        make_production_mesh(multi_pod=True, device=CPU)
    dist.destroy_process_group()
    fake_world(512)
    m = make_production_mesh(multi_pod=True, device=CPU)
    assert (m.mesh_dim_names, tuple(m.shape)) == (
        ("pod", "data", "model"), (2, 16, 16))
    assert tuple(make_production_mesh(device=CPU).shape) == (16, 16)


def test_make_host_mesh(fake_world):
    assert not dist.is_initialized()
    m = make_host_mesh(device=CPU)       # a world of one, started here
    assert (m.mesh_dim_names, tuple(m.shape)) == (("data", "model"),
                                                  (1, 1))
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    dist.destroy_process_group()
    fake_world(16)
    assert tuple(make_host_mesh(4, device=CPU).shape) == (4, 4)
    assert tuple(make_host_mesh(64, device=CPU).shape) == (1, 16)


def test_launcher_refuses_a_state_sharded_over_ranks(fake_world, tmp_path):
    from repro_torch.launch import train as launch
    fake_world(16)
    with pytest.raises(NotImplementedError, match="item 9"):
        launch.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)], device=CPU)
    assert dist.is_initialized()          # the caller's world is kept


# ---------------------------------------------------------------------------
# Gradient sync in gloo worlds of 2 and 4 ranks
# ---------------------------------------------------------------------------

SHAPES = {"w": (7, 100), "b": (300,)}
MODES = ("fp32", "bf16", "int8")

RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.train import sync_grads, sync_leaf
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
rng = np.random.default_rng(rank)
leaves = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in %r.items()}
res = {}
for mode in %r:
    g = torch.from_numpy(leaves["w"])
    res[f"leaf-{mode}"] = sync_leaf(g, mode).numpy()
    tree = sync_grads({"w": g, "rest": [torch.from_numpy(leaves["b"]),
                                        None]}, mode)
    assert tree["rest"][1] is None
    res[f"tree-{mode}-w"] = tree["w"].numpy()
    res[f"tree-{mode}-b"] = tree["rest"][0].numpy()
np.savez(out, **res)
dist.destroy_process_group()
""" % (SHAPES, MODES)

_WORLDS = {}


def _world_results(world, tmp_path_factory):
    """Each rank's results of a gloo world of `world` ranks (one process
    a rank, all started together; run once per world)."""
    if world not in _WORLDS:
        tmp = tmp_path_factory.mktemp(f"gloo{world}")
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK, str(r), str(world),
             str(tmp / "store"), str(tmp / f"rank{r}.npz")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        try:
            errs = [p.communicate(timeout=240)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, e in zip(procs, errs):
            assert p.returncode == 0, e[-3000:]
        _WORLDS[world] = [dict(np.load(tmp / f"rank{r}.npz"))
                          for r in range(world)]
    return _WORLDS[world]


def _leaves(world):
    out = []
    for r in range(world):
        rng = np.random.default_rng(r)
        out.append({k: rng.standard_normal(s).astype(np.float32)
                    for k, s in SHAPES.items()})
    return out


def _bound(stacked, mode, world):
    x = torch.from_numpy(stacked)
    if mode == "bf16":
        x = x.to(torch.bfloat16).float()
    eps = {"fp32": 2.0 ** -23, "bf16": 2.0 ** -7}[mode]
    return (3 * eps * x.abs().sum(0) / world).numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_sync_leaf_against_the_reference(tmp_path_factory, world, mode):
    got = _world_results(world, tmp_path_factory)
    leaves = _leaves(world)
    stacked = {k: np.stack([l[k] for l in leaves]) for k in SHAPES}
    want_leaf = np.asarray(jax.vmap(lambda g: ref_sync_leaf(g, mode),
                                    axis_name="pod")(stacked["w"]))
    want_tree = jax.vmap(
        lambda w, b: ref_sync_grads({"w": w, "rest": [b, None]}, mode),
        axis_name="pod")(stacked["w"], stacked["b"])
    want = {"leaf": want_leaf[0], "tree-w": np.asarray(want_tree["w"])[0],
            "tree-b": np.asarray(want_tree["rest"][0])[0]}
    for r in range(world):
        assert np.array_equal(got[r][f"leaf-{mode}"], got[0][f"leaf-{mode}"])
        for key, ref in want.items():
            name = key.replace("tree-", f"tree-{mode}-") \
                if key.startswith("tree") else f"leaf-{mode}"
            port = got[r][name]
            assert port.dtype == np.float32 and port.shape == ref.shape
            if world == 2 or mode == "int8":
                assert np.array_equal(port, ref), (world, mode, key)
            else:
                leaf = "b" if key == "tree-b" else "w"
                bound = _bound(stacked[leaf], mode, world)
                assert np.all(np.abs(port - ref) <= bound), (world, mode,
                                                             key)


def test_sync_leaf_rejects_an_unknown_mode(fake_world):
    from repro_torch.train import sync_leaf
    fake_world(2)
    with pytest.raises(ValueError):
        sync_leaf(torch.zeros(4), "fp16")
