"""Package rules of the torch port.

  * Importing every module of `repro_torch` loads neither `jax` nor any
    module of the JAX package `repro` (checked in a fresh interpreter).
  * `chip_smoke.py` imports neither, and on a host without CUDA it exits
    non-zero without printing a result.
  * Entry points called without `device` run on CUDA, so on a host
    without CUDA they raise instead of running on the CPU.
  * The serving entry points (`serve_http`, `ShadowServer`,
    `recover_server`) and the `GMRESIREnv` shim, called without a task
    or device, build CUDA tasks, so they raise on such a host too.
  * The kernel wrappers run their kernel or raise for any tensor that is
    not on the CPU; the library build raises when nvcc is missing.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(names), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 30
    assert bad == "[]"


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_and_fails_without_cuda():
    path = os.path.join(REPO, "chip_smoke.py")
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    out = subprocess.run([sys.executable, path], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_without_device_raise_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    from repro_torch.core import TrainConfig, W1, train_policy
    from repro_torch.precision import backend_for, resolve_device
    from repro_torch.solvers import gmres_ir, gmres_ir_batch
    from repro_torch.tasks import GMRESIRTask
    A = np.eye(4)
    b = np.ones(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        backend_for(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        gmres_ir(A, b, b, [6, 6, 6, 6])
    with pytest.raises(RuntimeError, match="CUDA"):
        gmres_ir_batch(A[None], b[None], b[None], [[6, 6, 6, 6]])
    with pytest.raises(RuntimeError, match="CUDA"):
        GMRESIRTask()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_policy(None, W1, TrainConfig(episodes=1))
    # Asked for the CPU, the same calls run the plain versions.
    from repro_torch.data.matrices import randsvd_dense
    s = randsvd_dense(8, 10.0, np.random.default_rng(0))
    st = gmres_ir(s.A, s.b, s.x_true, [6, 6, 6, 6], device="cpu")
    assert int(st.status) == 0 and float(st.ferr) < 1e-12


def test_serving_entry_points_without_device_raise_on_a_host_without_cuda(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    from repro_torch.core import GMRESIREnv, reduced_action_space
    from repro_torch.core.bandit import QTable
    from repro_torch.core.discretize import Discretizer
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data.matrices import randsvd_dense
    from repro_torch.precision import chop_stochastic
    from repro_torch.service import (PolicyRegistry, ShadowServer,
                                     recover_server)
    from repro_torch.service.http import serve_http
    from repro_torch.solvers import IRConfig
    space = reduced_action_space()
    disc = Discretizer.fit(np.random.default_rng(0).uniform(0, 1, (8, 2)),
                           (2, 2))
    reg = PolicyRegistry(str(tmp_path / "reg"))
    reg.promote(reg.publish(PrecisionPolicy(
        space, disc, QTable(disc.n_states, space.n_actions, 0.5, 0))))
    log = tmp_path / "traj.jsonl"
    log.write_text("")
    s = randsvd_dense(8, 10.0, np.random.default_rng(0))
    for call in (lambda: serve_http(ShadowServer(reg)),
                 lambda: ShadowServer(reg, IRConfig()),
                 lambda: recover_server(reg, str(log)),
                 lambda: GMRESIREnv([s], space, IRConfig())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # A tensor off the CPU launches the chop_sr kernel or raises.
    x = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        chop_stochastic(x, 2, torch.empty(4, dtype=torch.int32,
                                          device="meta"))
    # Asked for the CPU, the shim runs the plain versions.
    env = GMRESIREnv([s], space, IRConfig(), device="cpu")
    assert int(env.outcome(0, space.n_actions - 1).status) == 0


def test_wrappers_raise_for_tensors_off_the_cpu_without_a_kernel():
    from repro_torch.kernels.chop import chop_op, chop_sr_op
    from repro_torch.kernels.flash_attention import flash_attention_op
    from repro_torch.kernels.qmatmul import qgemm_op, qmatmul_op, qmv_op
    from repro_torch.kernels.trisolve import trisolve_op
    x = torch.empty((8, 8), device="meta")
    h = torch.empty((1, 8, 2, 16), device="meta")
    w = torch.empty((8, 8), dtype=torch.int32, device="meta")
    for call in (lambda: chop_op(x, 2), lambda: chop_sr_op(x, 2, w),
                 lambda: qmv_op(x, x[0], 2),
                 lambda: qgemm_op(x, x, 2),
                 lambda: qmatmul_op(x, x, 2),
                 lambda: trisolve_op(x, x[0], 2, lower=True),
                 lambda: flash_attention_op(h, h, h)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_library_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import library
    if library.shutil.which("nvcc") is not None:
        pytest.skip("checks the behaviour on a host without nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(library, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        library.build()
    assert library.library_path().name.startswith("librepro_torch_")


def test_lm_entry_points_without_device_raise_on_a_host_without_cuda():
    """The LM stack's entry points (`init_params`, `forward`,
    `init_caches`, `decode_step`, `generate`, `launch.serve.main`) run on
    CUDA unless asked for the CPU; asked for it, they run."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import (decode_step, forward, init_caches,
                                    init_params)
    from repro_torch.serve import ServeConfig, generate
    cfg = get_smoke("gemma-2b")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, gen)
    params = init_params(cfg, gen, torch.float32, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="CUDA"):
        forward(params, tokens, cfg, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_caches(cfg, 1, 8, torch.float32)
    caches = init_caches(cfg, 1, 8, torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_step(params, tokens[:, :1], caches, cfg, torch.float32)
    scfg = ServeConfig(max_new_tokens=2, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(params, tokens, cfg, scfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "gemma-2b", "--smoke", "--batch", "1",
                           "--prompt-len", "2", "--new", "1"])
    assert forward(params, tokens, cfg, torch.float32,
                   device="cpu").shape == (1, 4, cfg.vocab_size)
    assert generate(params, tokens, cfg, scfg, device="cpu").shape == (1, 2)


def test_lm_modules_load_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.models, repro_torch.serve, repro_torch.configs\n"
        "import repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_lm_attention_off_the_cpu_launches_or_raises():
    """The flash route has no fallback: a full-sequence forward of a
    tensor off the CPU goes to the kernel's wrapper, which raises for a
    tensor it cannot launch on (here a meta tensor), and `sdpa_flash`
    does the same; the decode step's plain einsum runs anywhere."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import attention
    cfg = get_smoke("gemma2-9b")
    params = attention.init_gqa(None, cfg, torch.float32, "meta")
    x = torch.empty((1, 8, cfg.d_model), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention.gqa_forward(params, x, cfg, "local",
                              torch.arange(8, device="meta"))
    q = torch.empty((1, 200, 4, 16), device="meta")
    k = torch.empty((1, 200, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention.sdpa_flash(q, k, k, "attn", cfg, 0.25)
    cache = attention.init_kv_cache(1, 8, cfg, torch.float32, "meta")
    out, cache = attention.gqa_decode(params, x[:, :1], cache, cfg, "local")
    assert out.shape == (1, 1, cfg.d_model)


def test_training_modules_load_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.train, repro_torch.checkpoint\n"
        "import repro_torch.data.tokens, repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for rel in ("train", "checkpoint", "launch/train.py", "data/tokens.py"):
        path = os.path.join(SRC, "repro_torch", rel)
        files = [path] if path.endswith(".py") else [
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".py")]
        for f in files:
            assert not _imported_roots(f) & {"jax", "jaxlib", "repro"}, f


def test_training_entry_points_without_device_raise_on_a_host_without_cuda(
        tmp_path):
    """`init_train_state` and `launch.train.main` run on CUDA unless asked
    for the CPU; asked for it, they run."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as launch_train
    from repro_torch.train import TrainStepConfig, init_train_state
    cfg = get_smoke("granite-3-2b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, torch.Generator().manual_seed(0),
                         TrainStepConfig())
    argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "1", "--batch",
            "1", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(argv)
    assert not os.listdir(tmp_path)
    state, loss = launch_train.main(argv, device="cpu")
    assert int(state.step) == 1 and np.isfinite(loss)
