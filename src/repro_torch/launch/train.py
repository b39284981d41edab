"""Training launcher (port of `repro.launch.train`, the same flags), on
the CUDA device:

    python -m repro_torch.launch.train --arch granite-3-2b --smoke \\
        --steps 40 --ckpt-every 10 --ckpt-dir DIR

  * parameters drawn in float32 from a generator seeded 0 on the card,
    as `launch.serve` draws them; the compute dtype is float32, as the
    reference's path without the production mesh;
  * fault tolerance: atomic checkpoints every --ckpt-every steps and at
    the end, automatic resume from LATEST with the token pipeline's
    cursor (kill the process anywhere and relaunch);
  * straggler watchdog: a step over --step-deadline-s is reported;
  * --quant-moments: int8 AdamW moments;
  * --autotune: the bandit (`train.TrainPrecisionController`) acts every
    10 steps and observes the loss after, as in the reference, whose step
    never receives the policy it acts (ROADMAP Queue 3): the step runs
    with policy None here too.

  * the mesh: `launch.mesh.make_host_mesh()` over the current world (a
    world of one, started here and ended on return, when there is no
    process group), or with --production-mesh `make_production_mesh`
    ((16, 16), or (2, 16, 16) with --multi-pod), which raises on a world
    smaller than 256 or 512 ranks, as the reference does on a host with
    fewer devices. The state's specs come from `distributed.param_specs`
    on that mesh, as in the reference; on a world of one every placement
    is `Replicate()` and the state stays plain tensors. A state sharded
    over several ranks (DTensors) is not ported: a placement other than
    `Replicate()` raises (ROADMAP Queue 1 item 9);
  * --grad-sync is parsed and has no effect, as in the reference, which
    never reads it (ROADMAP Queue 3); `train.sync_grads` is the sync.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch, get_smoke
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed.sharding import (PartitionSpec, param_specs,
                                              tree_map_with_path)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.precision.backend import resolve_device
from repro_torch.train import (AdamWConfig, TrainPrecisionController,
                               TrainStepConfig, init_train_state,
                               make_train_step)


def main(argv=None, device=None):
    """Train; returns (final state, last loss)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--grad-sync", default=None,
                    choices=[None, "fp32", "bf16", "int8"])
    ap.add_argument("--step-deadline-s", type=float, default=600.0)
    ap.add_argument("--quant-moments", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    started = not dist.is_initialized()
    try:
        mesh = (make_production_mesh(multi_pod=args.multi_pod, device=dev)
                if args.production_mesh else make_host_mesh(device=dev))
        return _train(args, dev, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev, mesh):
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    tcfg = TrainStepConfig(
        peak_lr=args.lr, warmup=min(20, args.steps // 10 + 1),
        total_steps=args.steps,
        opt=AdamWConfig(quantize_moments=args.quant_moments),
        compute_dtype=torch.float32 if not args.production_mesh
        else torch.bfloat16)
    controller = (TrainPrecisionController(total_decisions=args.steps // 10)
                  if args.autotune else None)

    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(cfg, gen, tcfg, device=dev)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0)

    # Resume (fault tolerance): restore params/opt/step + pipeline cursor.
    if latest_step(args.ckpt_dir) is not None:
        state, meta = restore_checkpoint(args.ckpt_dir, state)
        pipe.load_state_dict(meta["pipeline"])
        print(f"[train] resumed from step {int(state.step)}", flush=True)

    step_fn = make_train_step(cfg, tcfg, policy=None)
    specs = param_specs(state, mesh)
    sharded = []
    tree_map_with_path(
        lambda path, spec: sharded.append("/".join(path))
        if any(e is not None for e in spec) else None,
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    if sharded:
        raise NotImplementedError(
            f"a train state sharded over the {tuple(mesh.shape)} mesh "
            "(DTensors) is not ported (ROADMAP Queue 1 item 9: the "
            "dry-run slice); run in a world of one")
    prev_loss = None
    loss = float("nan")
    while int(state.step) < args.steps:
        t0 = time.time()
        batch = pipe.next_batch()
        if controller is not None and int(state.step) % 10 == 0:
            gn = 1.0  # grad-norm ratio proxy before first step
            controller.act(controller.features(gn, 1e-3))
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        step = int(state.step)
        if dt > args.step_deadline_s:
            print(f"[watchdog] step {step} took {dt:.1f}s "
                  f"(> {args.step_deadline_s}s) — straggler suspected; "
                  "a fleet controller would re-slice here", flush=True)
        if controller is not None and prev_loss is not None and \
                step % 10 == 1:
            controller.observe(prev_loss, loss,
                               diverged=not np.isfinite(loss))
        prev_loss = loss
        if step % 10 == 0 or step == args.steps:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({dt:.2f}s/step)", flush=True)
        if step % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step, state,
                            {"pipeline": pipe.state_dict()})
    save_checkpoint(args.ckpt_dir, int(state.step), state,
                    {"pipeline": pipe.state_dict()})
    print(f"[train] done at step {int(state.step)}; final loss {loss:.8f}",
          flush=True)
    return state, loss


if __name__ == "__main__":
    main()
