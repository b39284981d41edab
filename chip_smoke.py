#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure ends the run with a non-zero exit and no result line):

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/csrc (one nvcc run);
  3. hold each kernel against its plain torch version on the card, at the
     main path's shapes (n_pad 128..512, qgemm with K = 64), for all seven
     format ids: chop, qmv and trisolve bit for bit; chop on each of its
     routes ("block", "vector", "strided"; `kernels.chop.chop_route`) at
     sizes on both sides of the route bounds, aligned and off 16-byte
     alignment, and every fused form of `kernels.chop.FORMS` (chop(a op
     b), chop(a - chop(b c)), chop(chop(a - b) / c), chop(a + chop(b
     c))) on the solver's
     broadcast shapes with the special operands and division by zero
     (`kernels.chop.checks.expr_cases`), on every route that takes them,
     into a fresh tensor and into output views (contiguous, strided,
     transposed, `a` itself), and with live ranges at both ends of a
     vector result; qmv and trisolve on
     each of their routes ("shfl", the tree in registers and shuffles;
     "smem", the tree in shared memory) and also at M/K in {1, 31, 33,
     300, 384, 1000} with lda != K (a row-strided view, and a transposed
     view the wrapper copies), trisolve at n in {1, 37, 300, 512} with
     block 128 and at n 1, 37 and 300 with the other widths of each
     route (1..64; 3, 48, 100 on "smem"), both with signed zeros, NaN,
     infinities and subnormals; qgemm (at K = 64, the main path's
     panel, and at K = 32 and 128, the sweep's other widths) within
     ulp_fmt(|want|) + Kp 2^-24 sum_k |a_ik||b_kj| per element (two
     summation orders of the same products plus one flipped output
     rounding; where the plain version gives an infinity or a NaN, the
     same infinity or a NaN), also with operands in each format's
     subnormal range, near its largest value and with infinities, which
     shows whether the tensor cores keep them as the float32 reference
     does; and qgemm's chop-and-pack kernel (the tensor-core route's
     first launch) bit for bit against `pack_ref` on every float32
     exponent field; then the stochastic-rounding kernel `chop_sr`
     (`csrc/chop_sr.cu`, no TPU counterpart: the JAX package's
     `chop_stochastic` is plain jnp) bit for bit against `chop_sr_ref`
     for every format id at 0-dim, (128,), (512,) and (512, 512) and on
     every float32 exponent field with each format's edges, specials,
     subnormals and deep underflow, each with drawn words and with the
     words 0 and 2^32 - 1; and the JAX package's unbiasedness test on
     the card through `chop_stochastic` (64 draws at bf16, bias under
     0.35 x the RNE error), its launches counted;
  4. run the main path on the card: the paper's dense generator
     (n in [100, 500], buckets 128..512), the reduced action space, W1,
     `train_policy` for a few episodes, then `evaluate_policy`, with every
     kernel's launch count set to 0 just before and read just after (each
     must be > 0, every qmv and trisolve launch on the "shfl" route, every
     chop form launched, qmv, qgemm and trisolve at the launches and the
     episode rewards of `MAIN_PATH_LAUNCHES` and `MAIN_PATH_REWARDS`, and
     chop's total, by route and form, that of `MAIN_PATH_CHOP`, below
     the `UNFUSED_CHOP_LAUNCHES` of one launch a rounding); then the
     paper's baseline column, `evaluate_fixed_action` under the all-fp64
     action (fp32 on the card's float32 carrier), its launches counted
     apart and its table printed beside `evaluate_policy`'s; then
     (4b) check one strict and one blocked solve on the card against the
     same solve on the CPU;
  9. (right after 4b) the online server `repro_torch.service.AutotuneServer`
     on the card, from phase 4's policy published into a
     `PolicyRegistry` in a temporary directory: stream A, 8 strict
     requests (`generate_dense_set(8, rng(3), n_range=(100, 128))`,
     bucket 128, `BatcherConfig(max_batch=4)`, seed 0, a clock that
     moves 0.01 s a request) served on the card and, by a second server,
     on the CPU (float32 carrier, plain versions): action, state, status,
     iteration counts, ferr, nbe, res_norm, reward and the Q/N tables
     bit for bit; stream B, 16 requests over buckets 128..512 (rng(4), n
     in [100, 500]) on the card alone, arriving as one burst on the real
     clock, with the launch counts set to 0 just before and read just
     after (chop, qmv, qgemm and trisolve must each launch), each
     response polled exactly once, 16 Q-updates; its latency p50/p99
     and each flush's rows and seconds printed; then `snapshot()` (v2),
     its reload with equal tables, and one scrape of `/metrics` and
     `/healthz` on 127.0.0.1 (the request counter must read 16);
  4c. CG-IR's loop on the card: the paper's sparse SPD generator (n in
     [200, 500], buckets 256..512, all blocked) at log10 kappa 2..6,
     which the float32 carrier resolves, `CGIRTask`, `train_policy`,
     `evaluate_policy` and `evaluate_fixed_action`, each timed, with the
     launches by kernel, form and route counted as in phase 4 (chop,
     qmv, qgemm and trisolve must each launch; every chop form must have
     launched in phase 4 or here: only CG runs `add_mul`); then CG's 4b:
     a strict solve (n_pad 128) bit for bit against the CPU, a blocked
     one with a bf16 factorization held as GMRES's, and two systems at
     the paper's kappa 1e8..1e10 under the all-fp64 action, which fail
     on this carrier on the card and on the CPU alike; then the
     panel-width sweep `tuned_blocking` twice at n_pad 512, the sweep's
     caches cleared in between, each width timed on the device (the
     replays of one CUDA graph of its pipeline) and printed; the two
     winners must agree unless the first sweep's two fastest widths are
     within 3%;
  5. time each kernel at those shapes, chop also at 0-dim (the launch
     floor), (128,), (512,), (128, 128) and its fused form chop(a -
     chop(b c)) at (512,) (b 0-dim, as in GMRES's w update) and (512,
     512), and chop(a + chop(b c)) at (512,) (CG's z and p updates),
     each with its route and, beside it, `x.to(torch.bfloat16)
     .float()` (two launches: a reference point, not a yardstick): per
     call with CUDA events around
     back-to-back calls (`ms`, what a caller in Python sees; the median
     of five runs of 200 calls) and its
     device time alone from torch.profiler (`device_ms`); beside it the
     plain version, a one-call PyTorch yardstick where one exists, and
     the kernel's bound (bytes over 3.35 TB/s or operations over the
     rate of the kernel's route, the larger: float32's 67 TFLOP/s, and
     for qgemm in bf16 the bf16 tensor cores' 989, with its yardstick
     `torch.matmul` on bf16 operands), qgemm also at K = 32 and 128
     (the sweep's other panel widths) after a check; trisolve in both
     directions,
     beside `torch.linalg.solve_triangular` on the pre-chopped factor and
     its chain bound (`scripts/chain_bound.py`: n_pad x the latencies,
     measured here, of the operations each row must wait for); `chop_sr`
     at (512, 512), (512,) and 0-dim against its bound of 12 bytes an
     element, beside the RNE chop kernel at the same shape;
  6. profile one strict and one blocked GMRES-IR solve and one blocked
     CG-IR solve: wall time, device busy time and the kernels that take
     it;
  7. the K-blocked chopped matmul `qmatmul_op`: held against its plain
     version `qmatmul_ref_blocked` (TF32 off) within the same tolerance,
     for all seven format ids on the wrapper's route and on the FFMA
     kernel (the launcher's route argument), at ragged M/N/K (1, 63, 65,
     129, 300), at K blocks of 96 and 100 (not multiples of every K
     tile), with the special operands of phase 3, and for bf16 inputs;
     then driven at gemma2-9b's FFN width, x (4096, 3584) . w (3584,
     14336), bk 256 (14 K blocks), in formats e4m3, bf16, fp16 (tensor
     cores), tf32 (tensor cores) and fp32 (FFMA), with the launch counts
     set to 0 just before and read just after, each checked against the
     plain version (its error printed as a share of the tolerance) and
     timed beside one `torch.matmul` on the pre-chopped operands: e4m3
     and bf16 on bf16 operands, fp16 on fp16 operands, tf32 on float32
     operands with TF32 on, fp32 on float32 operands with TF32 off; each
     against its own bound (fp8 1979, bf16 and fp16 989, TF32 495,
     float32 67 TFLOP/s; the kernel runs e4m3 at the bf16 rate). On the
     tensor cores one wrapper call is two device kernels (pack, GEMM),
     counted as one launch; device times sum both;
  8. flash attention `flash_attention_op` on both of its routes
     (`ROUTES`: bf16 at D 64-256 on the wgmma kernel, float32 on the
     SIMT kernel): small cases of every kind, float32 on SIMT against
     `flash_ref` (2e-5), bf16 on wgmma and, through `route="simt"`, on
     SIMT within two bf16 ulps of each output row, and wgmma within one
     ulp of `flash_tiled_ref` (the plain model of its numerics); then the
     three full-width bf16 cases of the repo's configs on the wgmma
     route, driven with the counts set to 0 just before and read just
     after: (a) gemma2-9b local layer (S 8192, 16 q heads, 8 kv heads, D
     256, window 4096, softcap 50), (b) its global layer (causal), (c)
     llama4-scout (S 16384, 40 q heads, 8 kv heads, D 128, chunk 8192);
     each held against `flash_ref` (computed one kv head at a time)
     within two bf16 ulps of the largest |want| of each output row, a
     tolerance scaled to the output (a row averages thousands of values
     at this length, so its entries are ~0.02), the SIMT route too, and
     timed (device time, TFLOP/s on live pairs, share of the bf16 peak)
     beside the SIMT route and one `scaled_dot_product_attention` call
     where one computes the same function: (b) causal, (c) causal on
     the sequence folded into S / chunk sequences (the boolean-mask call
     timed on a line before it); none has the softcap of (a).

  10. (right after phase 5) the float64 carrier, the paper's own x64
     setting: the solver kernels' float64 instantiations (`chop_f64`,
     `qmv_f64`, `qgemm_f64` on its DFMA route, `trisolve_f64`) held
     against their plain versions on float64 operands: chop over every
     float64 exponent field and each format's edges on every route, and
     every form x format on the call sites' shapes with the special
     operands; qmv at n_pad 128..512 and trisolve lower and upper (n 512
     block 128, n 37 block 16) on both routes; all bit for bit, every NaN
     read as one NaN (the card's float64 arithmetic keeps a NaN operand's
     payload); qgemm at the trailing update and with each format's edge
     operands within the order tolerance with float64's unit roundoff.
     Then the main path on `carrier_dtype="float64"`, the counts set to
     0 just before and read just after (each float64 kernel must launch,
     no float32 solver kernel may): `train_policy` on phase 4's dense data
     for `F64_EPISODES` episodes and its all-fp64 baseline, and CG-IR's
     all-fp64 baseline on the paper's sparse set at its own kappa
     (`generate_sparse_set` defaults, log10 kappa 8..10, n in [200, 500]),
     every system of which must converge, as the JAX package's x64 solves
     do on the CPU; each system's status and ferr and the walls printed.
     Then card vs CPU on float64 (the plain versions): phase 4c's two
     strict systems at the paper's kappa and a strict GMRES-IR solve bit
     for bit, a blocked CG-IR solve with status and iteration counts
     equal. Then each float64 kernel timed as in phase 5 beside
     `torch.mv`, `torch.matmul` and `torch.linalg.solve_triangular` on
     float64, its bound at 8 bytes a value and float64's 67 TFLOP/s, and
     trisolve's chain bound on float64; phase 6 profiles a blocked
     GMRES-IR and a blocked CG-IR solve on float64 (device busy share).

  11. (right after phase 10) the production serving path at full width:
     a `PolicyRegistry` warm-started from phase 4's policy, a
     `ShadowServer` on `GMRESIRTask(carrier_dtype="float64")` on the card
     (bucket_step 128, max_batch 4), `serve_http` on 127.0.0.1 with
     `HttpConfig(max_n=512)`; requests from the paper's dense generator
     (n in [100, 500]) one at a time, fire-and-poll and sync in turns.
     Stage A (primary only), after which the front door closes and
     `recover_server` rebuilds the primary from the registry and its
     trajectory log alone, the tail re-solved on the card by
     `eval.replay`: Q/N, epsilon and the WAL sequence bit-equal to the
     live ones. Then, on a new front door, a degraded candidate (Q
     pinned to the all-bf16 arm) that must roll back and a healthy copy
     that must promote (the gates of examples/serve_http.py with the
     windows cut), and a burst of 16 concurrent clients (half sync,
     half fire-and-poll, in a client process of their own) to the
     promoted policy. The primary slice over HTTP is bit-identical to an
     in-process `AutotuneServer` fed the same requests; the OPE gate
     scores the degraded candidate on the primary's logged stream.
     Printed: requests/s, wire latency p50/p99, the decision trail, the
     launches (every float64 solver kernel > 0, every float32 one 0);
     any failed response, front-door error, flush restart or launch
     error fails the run.
  12. (last, after phase 6) the batched program: GMRES-IR on 16 dense
     systems at bucket 128 (strict) and 8 at bucket 512 (blocked), CG-IR
     on 8 sparse SPD systems at bucket 512 (float32), and on the float64
     carrier GMRES-IR on 8 dense systems at bucket 512 and CG-IR on the
     paper's sparse set (`F64_CG`, padded to 512); the actions cycle
     through the reduced action space (`BATCH_CASES`). Each case runs as
     one batched call (`gmres_ir_batch` / `cg_ir_batch`) and as B = 1
     calls one row after another; every row must be bit-equal to its
     B = 1 solve. Printed for both: the wall and the launches by kernel
     (counts set to 0 just before, read just after), then the device
     busy time and device operations of one more run under
     torch.profiler (of the B = 1 calls, the first
     `BATCH_PROFILED_ROWS` rows: a profiled loop of sixteen strict
     solves takes minutes).

  13. (after phase 16) AOT warmup, each server in a fresh process
     (`scripts/warm_boot.py`) on the float64 carrier at buckets 128
     (strict) and 512 (blocked), `WARM_REQUESTS` dense requests a bucket
     one at a time, the first of each bucket first, then each bucket's
     first request twice more (its latency in a warm process): a cold
     server (no warmup), a `warmup="sync"` server over a fresh build
     directory (its warmup runs the one nvcc build), and a
     `warmup="background"` server over that directory (the restart: no
     nvcc). Printed for each: boot-to-ready seconds, each bucket's first
     request's latency (and its repeats') and cold launches (kernel
     instances launched for the first time,
     `kernels.library.COLD_LAUNCHES`), the p50 of the rest,
     `cache_stats()`. Every request of the warmed servers must make 0
     cold launches, 0 nvcc runs, 0 cold cells and 0 dispatcher builds,
     their warmup reports no error, the cold server's first request
     some cold launches, the restart 0 misses, and all three servers the
     same outcomes bit for bit;
  14. (right after phase 8) the LM serving path, `repro_torch.models`
     and `repro_torch.serve`, on gemma2-9b (42 layers, d 3584, 16 heads
     over 8 kv heads at head dim 256, vocab 256000, local and global
     layers, softcaps): (a) full width and depth in bf16, `init_params`
     on the card and one `forward` at B 1, S 4096, the flash kernel's
     launches counted by mask kind (21 local, 21 attn, all on "wgmma")
     and each kind's attention output held against the plain attention
     on the same q, k, v (rtol = atol = 2e-2), the forward's wall, device
     span and busy time; (b) full width in float32 cut to 4 layers:
     `forward` at S 4200 (past the window, padded to 4224) through the
     "simt" route against the plain forward (`plain_attention()`) within
     1e-4 of the logits' scale, greedy `generate` (B 4, prompt 32, 16
     new) equal to argmax over repeated forwards (a flip passes only as
     a tie, a gap under 1e-4 of the scale), then with the KV cache in
     e4m3: 2 x layers x steps chop launches, tokens equal to the same
     generate with the chop's plain version; (c) `python -m
     repro_torch.launch.serve --arch gemma2-9b --batch 4 --new 16
     --kv-format bf16` at full width and depth (float32) in a process of
     its own, its tok/s; (d) every arch's smoke config, `forward`, one
     `decode_step` and a short `generate` on the card against the CPU
     (within 1e-4 of the logits' scale, tokens equal but for ties);
  15. (right after phase 14) LM training, `repro_torch.train`,
     `checkpoint`, `data.tokens` and `launch.train`, on granite-3-2b
     (40 layers, d 2048, 32 heads over 8 kv heads at head dim 64, d_ff
     8192, vocab 49155, tied): (a) full width and depth, float32 masters
     and moments on the card, `make_train_step` with `TrainStepConfig`'s
     defaults (bf16 compute) at B 4, S 1024 from `TokenPipeline(seed=0)`:
     one gradient through the flash kernel's wgmma route (40 launches in
     the forward, 40 in the layer groups' remat), every leaf's gradient
     finite and nonzero (wq, wk, wv included) and held against the same
     gradient under `plain_attention()` (each leaf's cosine >= 0.99, the
     global norms within 2%); `adamw_update` alone timed; one layer's
     attention forward and backward (the plain version's recompute)
     beside SDPA's; then 3 steps (80 flash launches each, all wgmma),
     finite losses, the step's wall and tokens/s, a fourth step under
     torch.profiler (device busy, operations, largest items) and
     `max_memory_allocated`; (b) the smoke config in float32 (the simt
     route at D 16): 40 steps from a state drawn on the CPU, the loss
     falling by more than 0.5 (the reference's
     `test_train_loss_decreases_smoke`), the first 3 card against CPU
     (within 1e-4 of each leaf's scale), one step under an emulated e4m3
     `LMPrecisionPolicy` with its chop launches counted, card against CPU,
     the policy matmuls' weights moved by decay alone (the reference's
     chop has a zero gradient); (c) `python -m repro_torch.launch.train
     --arch granite-3-2b --smoke --steps 12 --ckpt-every 3` killed right
     after its step-6 checkpoint, relaunched (it resumes from step 6),
     its final loss against an uninterrupted run's (within 1e-5).
  16. (right after phase 12) the sharded solve executor
     (`core.executor.ShardedExecutor`): (a) over the host's cards (data =
     the device count), the engine's `prefill_all` for `GMRESIRTask` on
     two of phase 4's dense systems and for `CGIRTask` on two of phase
     4c's sparse ones, under four actions, on both carriers, every
     outcome bit-equal to `LocalExecutor`'s, `summarize()["n_devices"]`
     the device count, a mesh one device larger raising; (b) the same
     rows split over four shards of cuda:0 through the device-list seam
     (`core.executor.mesh_devices`), bit-equal to (a), with the launches
     of the local executor run on the same shards' rows (chunk 2) and
     counted with the counts set to 0 just before and read just after;
     (c) an `AutotuneServer(executor="sharded")` from phase 4's policy on
     phase 9's stream A, its responses (action, status, metrics,
     reward) equal to a local server's; (d) with two cards or more, data
     = 2 on real devices against (a), else a line saying the two-card
     run waits; (e) `train.sync_leaf` in fp32, bf16 and int8 over an
     NCCL world of one (`launch.mesh.make_host_mesh()` on cuda) against
     the plain formula, and `make_production_mesh()` raising on it.

Phase 3 also holds the batched kernels: each solver kernel over a batch
whose rows mix all seven format ids (`BATCH_IDS`), on both carriers and
every route that takes the case (chop at the batched program's call
sites: per-row scalars, rows of V, the LU's in-place update, live
ranges, output views and slots), against its plain version with the
same per-row ids (chop, qmv, trisolve bit for bit, qgemm within its
order tolerance) and each row bit for bit against the single-format
launch on that row.

Phases 7, 8, 14 and 15 run between phases 5 and 6 (after phase 6's
profile of whole solves, torch.profiler records no device activity). The line
before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device, or run
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 and fp16 tensor cores, dense
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
FP8_FLOP_PER_S = 1979e12       # H100 SXM fp8 tensor cores, dense
N_PADS = (128, 256, 384, 512)
SEED = 2                       # 8 systems covering buckets 128..512
N_SYSTEMS = 8
EPISODES = 4

KERNELS = {
    "chop": ("src/repro_torch/csrc/chop.cu",
             "src/repro/kernels/chop/chop.py:48"),
    "qmv": ("src/repro_torch/csrc/qmv.cu",
            "src/repro/kernels/qmatmul/qmatmul.py:89"),
    "qgemm": ("src/repro_torch/csrc/qgemm.cu",
              "src/repro/kernels/qmatmul/qmatmul.py:113"),
    "trisolve": ("src/repro_torch/csrc/trisolve.cu",
                 "src/repro/kernels/trisolve/trisolve.py:57"),
    "qmatmul": ("src/repro_torch/csrc/qgemm.cu",
                "src/repro/kernels/qmatmul/qmatmul.py:113"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash.py:95"),
}
SOLVER_KERNELS = ("chop", "qmv", "qgemm", "trisolve")   # phases 3-6
# The CG phase (phase 4c): the paper's sparse SPD generator at the
# conditions the float32 carrier resolves (log10 kappa 2..6; the paper's
# 8..10 fails on it, as the JAX package's float32 kernels do), n in [200,
# 500] (buckets 256, 384, 512: the blocked path, all four kernels).
CG_SEED = 0
CG_SYSTEMS = 8
CG_EPISODES = 6
CG_KAPPA = (2.0, 6.0)
# qgemm's trailing update at the sweep's other panel widths (phases 3, 5).
QGEMM_PANELS = (32, 128)
# Phase 4's launches and episode rewards. The chop total is that of the
# fused forms; one launch a rounding, as before them, gave
# UNFUSED_CHOP_LAUNCHES. Since the batched program (PR 25) an engine
# chunk is one call, its launches those of its longest row: 434 / 120 /
# 780 and 63765 before, as one call a row.
MAIN_PATH_LAUNCHES = {"qmv": 276, "qgemm": 87, "trisolve": 464}
MAIN_PATH_REWARDS = (6.234, 4.668, 7.414, 7.517)
UNFUSED_CHOP_LAUNCHES = 80192
MAIN_PATH_CHOP = 42808
# Phase 9, the server: stream A, strict requests served on the card and
# on the CPU (bit for bit); stream B, requests over buckets 128..512 on
# the card only, on the real clock.
SERVE_A = (3, 8, (100, 128))      # (seed, requests, n range)
SERVE_B = (4, 16, (100, 500))
SERVE_MAX_BATCH = 4
HTTP_TIMEOUT_S = 30
# Two sweeps whose winners differ pass only when the first sweep's two
# fastest widths are within this share of each other.
SWEEP_TIE = 0.03

# Phase 7: gemma2-9b's FFN up-projection (configs/gemma2_9b.py: d_model
# 3584, d_ff 14336) for 4096 tokens.
QMATMUL_SHAPE = (4096, 3584, 14336)
QMATMUL_ROW = "fp32"  # the format whose numbers stand in the kernels line
# (format id, name, yardstick operand type, TF32 on in the yardstick,
# rate of the bound). e4m3's bound is at the fp8 rate; the kernel feeds
# e4m3 to the tensor cores as bf16 (csrc/qgemm.cu).
QMATMUL_FORMATS = (
    (1, "e4m3", torch.bfloat16, False, FP8_FLOP_PER_S),
    (2, "bf16", torch.bfloat16, False, BF16_FLOP_PER_S),
    (3, "fp16", torch.float16, False, BF16_FLOP_PER_S),
    (4, "tf32", torch.float32, True, TF32_FLOP_PER_S),
    (5, "fp32", torch.float32, False, F32_FLOP_PER_S),
)
# Phase 8: (name, B, S, Hq, Hkv, D, keyword arguments of the op).
FLASH_CASES = (
    ("a gemma2-9b local", 1, 8192, 16, 8, 256,
     dict(kind="local", window=4096, softcap=50.0)),
    ("b gemma2-9b global", 1, 8192, 16, 8, 256, dict(kind="attn")),
    ("c llama4-scout chunked", 1, 16384, 40, 8, 128,
     dict(kind="chunked", chunk=8192)),
)
FLASH_ROW = 1       # the case whose numbers stand in the kernels line
# Phase 10: the float64 carrier (the paper's own x64 setting): the solver
# kernels' float64 instantiations, which `CudaBackend(torch.float64)`
# launches. Each counts under its own name (`library.kernel_name`).
F64_KERNELS = {
    "chop_f64": ("src/repro_torch/csrc/chop.cu", KERNELS["chop"][1]),
    "qmv_f64": ("src/repro_torch/csrc/qmv.cu", KERNELS["qmv"][1]),
    "qgemm_f64": ("src/repro_torch/csrc/qgemm_f64.cu", KERNELS["qgemm"][1]),
    "trisolve_f64": ("src/repro_torch/csrc/trisolve.cu",
                     KERNELS["trisolve"][1]),
}
# H100 SXM float64 peak (NVIDIA's data sheet): 67 TFLOP/s on the tensor
# cores, 34 on the FMA units; the bound takes the larger, the least time.
F64_FLOP_PER_S = 67e12
F64_EPISODES = 2       # phase 4's GMRES data at a reduced depth
# The paper's sparse set at its own conditions (the generator's defaults,
# log10 kappa 8..10, lambda_s 0.01), n in [200, 500]: seed, systems, n.
F64_CG = (0, 8, (200, 500))
# chop_sr, stochastic rounding (csrc/chop_sr.cu; the JAX package's
# chop_stochastic, plain jnp, has no Pallas kernel): held bit for bit at
# these shapes, timed at the last; the unbiasedness run's draws; bytes an
# element (x, its random word, the result).
SR_SHAPES = ((), (128,), (512,), (512, 512))
SR_DRAWS = 64
SR_BYTES = 12
SR_SOURCE = "src/repro_torch/csrc/chop_sr.cu"
SR_REPLACES = "src/repro/precision/chop.py:237"
# Phase 11, the HTTP front door over a ShadowServer on the float64
# carrier: the dense generator's seed and systems, the requests' n, the
# requests of stage A, the burst's concurrent clients, the fire-and-poll
# clients' poll interval, and the rollout gates of
# examples/serve_http.py:137-141 with the windows cut (decision_window
# 24 -> 12, min_samples 20 -> 10) to keep the phase near two minutes.
HTTP_SEED = (11, 80)
HTTP_N = (100, 500)
HTTP_A = 8
HTTP_BURST = 16
HTTP_POLL_S = 0.01
HTTP_OPE_MIN = 16      # logged records the OPE gate needs to score
HTTP_ROLLOUT = dict(canary_frac=0.3, decision_window=12, min_samples=10,
                    promote_windows=2, reward_margin=10.0,
                    pass_rate_floor=0.12, pass_rate_margin=0.9,
                    p99_bound=50.0)
# Phase 3, batches: the per-row format ids of the batched kernel checks
# (all seven ids, two repeated), and the chop cases' row shapes.
BATCH_IDS = (3, 0, 6, 1, 5, 2, 4, 2, 0)
# Phase 12, the batched program: each case one batched call and its rows
# as B = 1 calls, bit for bit. (name, solver, carrier, generator, seed,
# systems, n range, bucket.) The actions cycle through the reduced space.
BATCH_CASES = (
    ("GMRES-IR strict", "gmres", "float32", "dense", 12, 16, (100, 128),
     128),
    ("GMRES-IR blocked", "gmres", "float32", "dense", 13, 8, (400, 500),
     512),
    ("CG-IR blocked", "cg", "float32", "sparse", 14, 8, (400, 500), 512),
    ("GMRES-IR blocked, float64", "gmres", "float64", "dense", 13, 8,
     (400, 500), 512),
    ("CG-IR, float64, the paper's sparse set", "cg", "float64", "paper",
     F64_CG[0], F64_CG[1], F64_CG[2], 512),
)
# Phase 12 profiles the batched call and, of the B = 1 calls, the first
# rows (a profiled B = 1 loop of 16 strict solves takes minutes).
BATCH_PROFILED_ROWS = 2
# Phase 13, AOT warmup: fresh server processes on the float64 carrier,
# the buckets they serve and warm, and the requests a bucket.
WARM_BUCKETS = (128, 512)
WARM_REQUESTS = 3
WARM_BOOT_TIMEOUT_S = 300
# Phase 14, the LM serving path: gemma2-9b (src/repro/configs/gemma2_9b.py)
# at full width. (a) bf16, full depth, `forward` at (B, S); (b) float32,
# cut to LM_DEPTH layers, `forward` at (B, S) past the 4096 window (padded
# to 4224 for the flash wrapper), then greedy `generate` (B, prompt, new)
# with the KV cache in float32 and in LM_KV_FMT; (c) the launcher in a
# process of its own; (d) every arch's smoke config, card against CPU
# (B, S, prompt, new).
LM_ARCH = "gemma2-9b"
LM_SEED = 14
LM_FORWARD = (1, 4096)
LM_DEPTH = 4
LM_F32_FORWARD = (1, 4200)
LM_GEN = (4, 32, 16)
LM_KV_FMT = "e4m3"
LM_SERVE_ARGS = ("--batch", "4", "--new", "16", "--kv-format", "bf16")
LM_SERVE_TIMEOUT_S = 400
LM_SMOKE = (2, 64, 6, 4)
# Tolerances: the reference's own bf16 flash tolerance, rtol = atol
# (tests/test_kernels_flash.py:76-83); a float32 forward of LM_DEPTH
# layers against the plain one, and card against CPU at the smoke
# configs, as a share of the logits' scale (max |want|): float32 attention
# to 2e-5 a call (the JAX flash tests'), carried through the blocks and
# the unembed; a greedy token that differs from the forward's argmax
# passes only as a tie, a logit gap under LM_TIE of the logits' scale.
LM_BF16_TOL = 2e-2
LM_F32_TOL = 1e-4
LM_SMOKE_TOL = 1e-4
LM_TIE = 1e-4
# Phase 15, LM training: granite-3-2b (src/repro/configs/granite_3_2b.py).
# (a) full width and depth, `TrainStepConfig` defaults (bf16 compute),
# (B, S, steps) from `TokenPipeline(seed=0)`; its gradient held against the
# plain attention's: the flash route's bf16 attention is within rtol =
# atol = 2e-2 of the plain one (phase 14a's tolerance), and such
# differences, summed over 40 layers and 4096 tokens into each weight's
# gradient, should leave each leaf's direction (cosine) and the global
# norm nearly unmoved: cosine >= TRAIN_COS, norms within TRAIN_NORM_RTOL.
# (b) the smoke config in float32: (B, S, steps) at the reference's
# `test_train_loss_decreases_smoke` schedule, the first TRAIN_CPU_STEPS
# on the CPU too, card against CPU within TRAIN_SMOKE_TOL of each leaf's
# scale (float32 sums in another order, through AdamW's m / sqrt(v)).
# (c) the launcher, killed after its TRAIN_KILL_AT checkpoint, resumed,
# against an uninterrupted run within TRAIN_RESUME_TOL of the loss (the
# embedding's backward sums with atomics, in an order that changes from
# run to run).
TRAIN_ARCH = "granite-3-2b"
TRAIN_SEED = 15
TRAIN_FULL = (4, 1024, 3)
TRAIN_COS = 0.99
TRAIN_NORM_RTOL = 0.02
TRAIN_SMOKE = (8, 64, 40)
TRAIN_SMOKE_TCFG = dict(peak_lr=3e-3, warmup=5, total_steps=60)
TRAIN_CPU_STEPS = 3
TRAIN_SMOKE_TOL = 1e-4
TRAIN_LAUNCH_ARGS = ("--arch", TRAIN_ARCH, "--smoke", "--steps", "12",
                     "--ckpt-every", "3", "--batch", "8", "--seq", "64",
                     "--lr", "3e-3")
TRAIN_KILL_AT = 6
TRAIN_RESUME_TOL = 1e-5
TRAIN_LAUNCH_TIMEOUT_S = 300
# Phase 16 (the sharded executor): the two systems of phase 4's dense
# data at n 307 and 357 (bucket 384) and of phase 4c's sparse data at n
# 201 and 203 (bucket 256), under a subsample of the action space (its
# extremes and two more), so that each engine chunk holds 8 rows of one
# bucket and splits 2, 2, 2, 2 over four shards; the server (16c) takes
# phase 9's stream A.
SHARD_DENSE = (2, 3)               # indices into phase 4's systems, by n
SHARD_SPARSE = (0, 1)              # into phase 4c's, by n
SHARD_ACTIONS = 4                  # reduced_action_space(subsample=4)
SHARD_SPLIT = 4                    # shards of one card in 16b
# What each phase's timing tuple holds, in order.
TIMING_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
               "device_ms", "library_device_ms", "plain_device_ms")


def say(*args):
    print(*args, flush=True)


class Failed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failed(what)


def card_line():
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def int_view(x):
    """x's bit patterns (int32 for float32, int64 for float64)."""
    return x.contiguous().view(torch.int64 if x.dtype == torch.float64
                               else torch.int32)


def same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(int_view(a), int_view(b))


def abs_err(a, b):
    """Largest |a - b| over the finite pairs; 0 where both are the same
    non-finite value (a NaN matches any NaN), inf elsewhere."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    d = (a.double() - b.double()).abs()
    same = same_bits_mask(a, b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(fin, d, torch.where(same, torch.zeros_like(d),
                                        torch.full_like(d, float("inf"))))
    return float(d.max()) if d.numel() else 0.0


def same_bits_mask(a, b):
    return int_view(a) == int_view(b)


def stratified(n, dev, seed):
    """n float32 values: every exponent field, both signs, plus specials."""
    rng = np.random.default_rng(seed)
    exps = rng.integers(0, 256, n, dtype=np.uint32)
    pats = (rng.integers(0, 2, n, dtype=np.uint32) << 31) | (exps << 23) \
        | rng.integers(0, 1 << 23, n, dtype=np.uint32)
    x = pats.view(np.float32).copy()
    x[:11] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 448.0,
              464.0, 57344.0, 61440.0]
    return torch.from_numpy(x).to(dev)


def held_gemm(got, want, a, b, fid, Kp, chop_out, what):
    """(max abs error, largest share of the tolerance) of a chopped GEMM
    against its plain version; fails outside the order tolerance
    (`kernels.qmatmul.checks.held`)."""
    from repro_torch.kernels.qmatmul.checks import held
    ok, err, share = held(got, want, a, b, fid, Kp, chop_out)
    check(ok, f"{what} outside the order tolerance")
    return err, share


def gemm_route(fid):
    """(operand type of a one-call torch.matmul yardstick, TF32 on in it,
    the bound's rate) for format `fid` on the GEMM's route
    (`kernels.qmatmul.ROUTES`): the bf16/fp16 tensor-core rate for the
    formats packed to bf16 or fp16, TF32's for tf32, float32's outside
    the tensor cores for the FFMA route."""
    from repro_torch.kernels.qmatmul import ROUTES
    dtype, kind = ROUTES[fid]
    if kind == "ffma":
        return torch.float32, False, F32_FLOP_PER_S
    if dtype == torch.float32:
        return torch.float32, True, TF32_FLOP_PER_S
    return dtype, False, BF16_FLOP_PER_S


def factor_like(n, dev, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) * 0.3
    M[np.diag_indices(n)] = rng.choice([-1.0, 1.0], n) * (2.0 + rng.random(n))
    return torch.tensor(M, dtype=torch.float32, device=dev)


def check_kernels(dev):
    """Phase 3: every kernel against its plain version on the card.
    Returns the max abs errors and qgemm's largest share of its
    tolerance."""
    from repro_torch.kernels.chop import chop_op, chop_ref
    from repro_torch.kernels.qmatmul import ROUTES, qgemm_op, qgemm_ref, \
        qmv_op, qmv_ref
    from repro_torch.kernels.qmatmul.checks import (SPECIAL_KINDS,
                                                    float32_patterns,
                                                    pack_equal,
                                                    special_operands)
    from repro_torch.kernels.qmatmul.ops import _pack
    from repro_torch.precision import FORMAT_LIST
    err = {k: 0.0 for k in KERNELS}
    fids = range(len(FORMAT_LIST))
    g = torch.Generator().manual_seed(0)
    for n in N_PADS:
        A = (torch.randn(n, n, generator=g) * 10.0 ** torch.randint(
            -3, 4, (n, n), generator=g)).to(dev)
        v = torch.randn(n, generator=g).to(dev)
        s = stratified(n * n, dev, n).reshape(n, n)
        Lu = factor_like(n, dev, n)
        for fid in fids:
            for x in (A, v, s):
                got, want = chop_op(x, fid), chop_ref(x, fid)
                check(same_bits(got, want), f"chop n={n} fid={fid}")
                err["chop"] = max(err["chop"], abs_err(got, want))
            for chop_out in (True, False):
                want = qmv_ref(A, v, fid, chop_out=chop_out)
                for route in QMV_ROUTES:
                    got = qmv_op(A, v, fid, chop_out=chop_out, route=route)
                    check(same_bits(got, want),
                          f"qmv n={n} fid={fid} route={route}")
                    err["qmv"] = max(err["qmv"], abs_err(got, want))
            for lower in (True, False):
                hold_trisolve(Lu, v, fid, lower, 128, err, f"n={n}")
        torch.cuda.synchronize()
    check_chop_forms(dev, err)
    check_matvec_edges(dev, err)
    check_trisolve_edges(dev, err)
    # qgemm at the blocked LU's trailing updates: (n_pad - k1, 64) x
    # (64, n_pad - k1) for k1 = 64, 128, ... (largest 448 at n_pad 512),
    # then the largest with operands at each format's edges.
    cases = [(f"m={m}", fid, torch.randn(m, 64, generator=g),
              torch.randn(64, m, generator=g))
             for m in (448, 320, 192, 64) for fid in fids]
    # ... and at the panel widths the sweep also tries (K = 32 and 128:
    # m = n_pad - k1 at n_pad 512 and 384).
    cases += [(f"m={m} K={k}", fid, torch.randn(m, k, generator=g),
               torch.randn(k, m, generator=g))
              for k in QGEMM_PANELS for m in (512 - k, 384 - k, 256 - k)
              for fid in fids]
    cases += [(kind, fid, *special_operands(kind, fid, 448, 64, 448, g))
              for fid in fids for kind in SPECIAL_KINDS]
    # The tensor-core route's pack kernel, bit for bit against pack_ref:
    # every float32 exponent field and the specials at ragged M/N/K, and
    # the largest trailing update's operands.
    for fid in (f for f in fids if ROUTES[f][1] == "wgmma"):
        x = float32_patterns(fid)
        a = x.repeat(2)[:129 * 130].reshape(129, 130)
        b = x.flip(0).repeat(2)[:130 * 127].reshape(130, 127)
        for a, b in ((a, b), (torch.randn(448, 64, generator=g),
                              torch.randn(64, 448, generator=g))):
            pa, pb = _pack(a.to(dev), b.to(dev), fid)
            check(pack_equal(pa, pb, a, b, fid),
                  f"qgemm pack {tuple(a.shape)} x {tuple(b.shape)} fid={fid}")
    share = 0.0
    for what, fid, a, b in cases:
        a, b = a.to(dev), b.to(dev)
        got, want = qgemm_op(a, b, fid), qgemm_ref(a, b, fid)
        e, sh = held_gemm(got, want, a, b, fid, 128, True,
                          f"qgemm {what} fid={fid}")
        err["qgemm"], share = max(err["qgemm"], e), max(share, sh)
    torch.cuda.synchronize()
    return err, share


# Phase 3, chop: sizes on both sides of the route bound (BLOCK_MAX in
# kernels.chop), with and without a tail of n mod 4, and the forms' call
# site shapes at sizes that take each route.
CHOP_SIZES = (1, 5, 256, 259, 512, 4099, 262144, 262147)
CHOP_EXPR_SIZES = (40, 256, 4099, 262147)


def check_chop_forms(dev, err):
    """Phase 3, chop: every route, forced and chosen, bit for bit against
    the plain version: the plain chop over every float32 exponent field
    and the special values at CHOP_SIZES, aligned and off 16-byte
    alignment (where the vector route must refuse); every form on the
    call sites' broadcast shapes (`kernels.chop.checks.expr_cases`) with
    signed zeros, infinities, NaN, each format's largest value and its
    neighbours, subnormals and division by zero, into a fresh tensor,
    into every view of `out_views` and into `a` itself, and for a vector
    result with every live range of `live_ranges`."""
    from repro_torch.kernels.chop import (ARITY, BLOCK_MAX, FORMS,
                                          chop_expr_op, chop_expr_ref,
                                          chop_op, chop_ref)
    from repro_torch.kernels.chop.checks import (expr_cases, live_ranges,
                                                 out_views,
                                                 to_keeping_layout)
    from repro_torch.kernels.chop.ops import expr_layout, vector_ready
    from repro_torch.precision import FORMAT_LIST
    t0, calls = time.perf_counter(), collections.Counter()

    def routes(tensors, M, N):
        ptrs = [t.data_ptr() for t in tensors]
        aligned = vector_ready(ptrs, expr_layout(tensors)[3], M, N)
        return [None, "strided"] + (["block"] if M * N <= BLOCK_MAX
                                    else []) + (["vector"] if aligned
                                                else [])

    def hold(got, want, what):
        check(same_bits(got, want), what)
        err["chop"] = max(err["chop"], abs_err(got, want))

    for fid in range(len(FORMAT_LIST)):
        base = stratified(max(CHOP_SIZES) + 1, dev, 100 + fid)
        for n in CHOP_SIZES:
            for x in (base[:n], base[1:n + 1]):
                want = chop_ref(x, fid)
                for route in routes([x], 1, n):
                    hold(chop_op(x, fid, route=route), want,
                         f"chop n={n} fid={fid} offset "
                         f"{x.data_ptr() % 16} route={route}")
                    calls["x " + str(route)] += 1
                if "vector" not in routes([x], 1, n):
                    try:
                        chop_op(x, fid, route="vector")
                        check(False, "chop: the vector route took a view "
                              "off 16-byte alignment")
                    except ValueError:
                        pass
        for name, *ops in expr_cases(fid, 20 + fid, sizes=CHOP_EXPR_SIZES):
            ops = [to_keeping_layout(t, dev) for t in ops]
            for form in FORMS:
                mine = ops[:ARITY[form]]
                want = chop_expr_ref(form, *mine, fmt_id=fid)
                shape, M, N, _ = expr_layout(mine)
                what = f"chop {form} {name} fid={fid}"
                for route in routes(mine, M, N):
                    hold(chop_expr_op(form, *mine, fmt_id=fid, route=route),
                         want, f"{what} route={route}")
                    calls[f"{form} {route}"] += 1
                views = out_views(tuple(shape), want)
                if mine[0].shape == shape:
                    views.append(("a itself", mine[0].clone()))
                for view, out in views:
                    args = [out] + mine[1:] if view == "a itself" else mine
                    for route in routes(args + [out], M, N):
                        if view == "a itself":
                            out.copy_(mine[0])
                        got = chop_expr_op(form, *args, fmt_id=fid, out=out,
                                           route=route)
                        check(got is out, f"{what}: out not returned")
                        hold(out, want, f"{what} out {view} route={route}")
                        calls["out " + view] += 1
                if len(shape) != 1:
                    continue
                idx = torch.arange(N, device=dev)
                for lo, hi in live_ranges(N):
                    masked = torch.where((idx >= lo) & (idx < hi), want,
                                         torch.zeros((), device=dev))
                    for route in routes(mine, M, N):
                        hold(chop_expr_op(form, *mine, fmt_id=fid,
                                          live=(lo, hi), route=route),
                             masked, f"{what} live=({lo}, {hi}) "
                             f"route={route}")
                        calls["live"] += 1
    torch.cuda.synchronize()
    say(f"chop checks ({sum(calls.values())} calls by form and route, output"
        f" view and live range {json.dumps(dict(calls))}; plain chop at "
        f"{CHOP_SIZES}, the forms' shapes at {CHOP_EXPR_SIZES}) passed in "
        f"{time.perf_counter() - t0:.1f} s")


QMV_ROUTES = ("shfl", "smem")
QMV_SIZES = (1, 31, 33, 300, 384, 1000)
# (n, block): the solver's block at every n, every other "shfl" width
# (and the "smem"-only widths 3, 48, 100) at small n, the wider at 300.
TRISOLVE_CASES = ([(n, 128) for n in (1, 37, 300)]
                  + [(n, blk) for n in (1, 37)
                     for blk in (1, 2, 3, 4, 8, 16, 32, 48, 64, 100)]
                  + [(300, blk) for blk in (16, 32, 64, 100)])
TRISOLVE_SPECIAL = ((37, 16), (37, 128), (200, 64))


def hold_trisolve(Lu, b, fid, lower, block, err, what):
    """trisolve on each route that takes `block`, bit for bit against one
    call of the plain version."""
    from repro_torch.kernels.trisolve import ROUTES, trisolve_op, \
        trisolve_ref
    want = trisolve_ref(Lu, b, fid, lower=lower, block=block)
    for route in ("smem", "shfl") if block in ROUTES else ("smem",):
        got = trisolve_op(Lu, b, fid, lower=lower, block=block, route=route)
        check(same_bits(got, want), f"trisolve {what} block={block} "
              f"lower={lower} fid={fid} route={route}")
        err["trisolve"] = max(err["trisolve"], abs_err(got, want))


def check_matvec_edges(dev, err):
    """Phase 3, qmv: every M and K of QMV_SIZES (Kp 128..1024), lda != K
    through a row-strided view and a transposed view that the wrapper
    copies, and the special operands, on both routes."""
    from repro_torch.kernels.lanes import SPECIAL_KINDS, special_matvec
    from repro_torch.kernels.qmatmul import qmv_op, qmv_ref
    from repro_torch.precision import FORMAT_LIST
    g = torch.Generator().manual_seed(10)
    t0, n = time.perf_counter(), 0
    cases = []
    for M in QMV_SIZES:
        for K in QMV_SIZES:
            wide = torch.randn(M, K + 3, generator=g).to(dev)
            v = torch.randn(K, generator=g).to(dev)
            cases += [(f"{M}x{K} lda={K + 3}", wide[:, :K], v),
                      (f"{M}x{K} transposed", wide[:, :K].t().contiguous().t(),
                       v)]
    for fid in range(len(FORMAT_LIST)):
        special = [(f"{kind} {M}x{K}",
                    *(x.to(dev) for x in special_matvec(kind, fid, M, K,
                                                        fid + K)))
                   for kind in SPECIAL_KINDS
                   for M, K in ((33, 128), (33, 100), (31, 384), (17, 300))]
        for what, a, v in cases + special:
            for chop_out in (True, False):
                want = qmv_ref(a, v, fid, chop_out=chop_out)
                for route in QMV_ROUTES:
                    got = qmv_op(a, v, fid, chop_out=chop_out, route=route)
                    check(same_bits(got, want), f"qmv {what} fid={fid} "
                          f"route={route} chop_out={chop_out}")
                    err["qmv"] = max(err["qmv"], abs_err(got, want))
                    n += 1
    torch.cuda.synchronize()
    say(f"qmv edge checks ({n} calls: M/K in {QMV_SIZES}, strided and "
        f"copied views, {', '.join(SPECIAL_KINDS)}, both routes) passed in "
        f"{time.perf_counter() - t0:.1f} s")


def check_trisolve_edges(dev, err):
    """Phase 3, trisolve: n in {1, 37, 300} (512 is in the main loop) at
    every block width of each route, and the special operands."""
    from repro_torch.kernels.lanes import SPECIAL_KINDS
    from repro_torch.kernels.trisolve.checks import special_system
    from repro_torch.precision import FORMAT_LIST
    t0 = time.perf_counter()
    for fid in range(len(FORMAT_LIST)):
        for n, block in TRISOLVE_CASES:
            Lu, b = factor_like(n, dev, n + block), \
                torch.randn(n, generator=torch.Generator().manual_seed(
                    n)).to(dev)
            for lower in (True, False):
                hold_trisolve(Lu, b, fid, lower, block, err, f"n={n}")
        for kind in SPECIAL_KINDS:
            for n, block in TRISOLVE_SPECIAL:
                Lu, b = (x.to(dev) for x in special_system(kind, fid, n,
                                                           fid + n))
                for lower in (True, False):
                    hold_trisolve(Lu, b, fid, lower, block, err,
                                  f"{kind} n={n}")
    torch.cuda.synchronize()
    say(f"trisolve edge checks ((n, block) in {TRISOLVE_CASES}, and "
        f"{', '.join(SPECIAL_KINDS)} at {TRISOLVE_SPECIAL}; both "
        f"directions, each route) passed in {time.perf_counter() - t0:.1f} "
        "s")


def batch_cases(B, dt, dev, g):
    """chop's batched cases at the batched program's call sites: (what,
    form, operands, out factory or None, live or None). Operands are
    (B, ...) with per-row scalars as (B, 1) columns."""
    def rnd(*shape):
        x = torch.randn(*shape, generator=g, dtype=torch.float64)
        x = x * 10.0 ** torch.randint(-3, 4, shape, generator=g)
        x.view(-1)[::97] = float("nan")
        x.view(-1)[5::89] = float("inf")
        x.view(-1)[7::83] = 0.0
        return x.to(dt).to(dev)
    n, m = 512, 40
    V = rnd(B, m + 1, n)
    A = rnd(B, 128, 128)
    return [
        ("x (B, n)", "x", (rnd(B, n),), None, None),
        ("x (B, n, n)", "x", (A,), None, None),
        ("x (B,)", "x", (rnd(B),), None, None),
        ("div (B, n) by (B, 1)", "div", (rnd(B, n), rnd(B, 1)), None, None),
        ("mul (B,) (Givens)", "mul", (rnd(B), rnd(B)), None, None),
        ("mul of two rows of V (MGS)", "mul", (V[:, 3], V[:, 5]), None,
         None),
        ("sub_mul into a, a row of V", "sub_mul",
         (V[:, 7], rnd(B, 1), V[:, 2]), "a", None),
        ("sub_mul LU update (B, m, w) into a", "sub_mul",
         (A[:, 9:, 9:64], A[:, 9:, 8, None], A[:, 8, None, 9:64]), "a",
         None),
        ("div LU column into a", "div", (A[:, 9:, 8], rnd(B, 1)), "a", None),
        ("sub into a strided view", "sub", (rnd(B, n), rnd(B, n)),
         "strided", None),
        ("mul live (B, m)", "mul", (rnd(B, m), rnd(B, m)), None, (11, m)),
        ("mul live (B, n)", "mul", (rnd(B, n), rnd(B, n)), None, (0, 300)),
        ("sub_div into y's slot", "sub_div", (rnd(B), rnd(B), rnd(B)),
         "slot", None),
        ("add_mul (B, n) by (B, 1)", "add_mul",
         (rnd(B, n), rnd(B, 1), rnd(B, n)), None, None),
        ("mul V y (B, m, n)", "mul", (V[:, :m], rnd(B, m, 1)), None, None),
        ("add (B, n)", "add", (rnd(B, n), rnd(B, n)), None, None),
    ]


def check_batched_kernels(dev):
    """Phase 3, batches: each solver kernel over a batch whose rows mix
    all seven format ids (`BATCH_IDS`, per-row formats through the ids),
    on both carriers and on every route that takes the case: against its
    plain version with the same per-row ids (chop, qmv and trisolve bit
    for bit, qgemm within its order tolerance, row by row), and each row
    bit for bit against the single-format launch on that row (float64
    with every NaN read as one NaN)."""
    from repro_torch.kernels.chop import chop_expr_op, chop_expr_ref
    from repro_torch.kernels.qmatmul import (qgemm_op, qgemm_ref, qmv_op,
                                             qmv_ref)
    from repro_torch.kernels.qmatmul.checks import held
    from repro_torch.kernels.trisolve import trisolve_op, trisolve_ref
    from repro_torch.precision import RowFormats
    t0, n_checks = time.perf_counter(), 0
    ids = np.array(BATCH_IDS, np.int32)
    B = len(ids)
    err = {}
    for dt in (torch.float32, torch.float64):
        rows = RowFormats(ids, dev)
        same = same_bits if dt == torch.float32 else same_nan_bits
        tag = "" if dt == torch.float32 else " float64"
        g = torch.Generator().manual_seed(7)
        e = err.setdefault(dt, collections.Counter())
        for what, form, ops, out_kind, live in batch_cases(B, dt, dev, g):
            want = chop_expr_ref(form, *ops, fmt_id=rows, live=live)
            n = want.numel()
            routes = ["block"] if n <= 256 else []
            routes += [None, "strided", "vector"]
            for route in routes:
                if out_kind is None:
                    out = None
                elif out_kind == "a":
                    # a itself, as the solver's in-place updates pass it:
                    # the same view of a copy of its base.
                    a0 = ops[0]
                    base = (a0._base if a0._base is not None else a0).clone()
                    out = torch.as_strided(base, a0.size(), a0.stride(),
                                           a0.storage_offset())
                elif out_kind == "slot":
                    out = torch.zeros((B, 5), dtype=dt, device=dev)[:, 2]
                else:
                    out = torch.zeros((B, 2 * ops[0].shape[-1]), dtype=dt,
                                      device=dev)[:, ::2]
                args = ((out,) + tuple(ops[1:])) if out_kind == "a" else ops
                try:
                    got = chop_expr_op(form, *args, fmt_id=rows, out=out,
                                       live=live, route=route)
                except ValueError:
                    check(route == "vector",
                          f"chop batch {what}{tag}: route {route} refused")
                    continue
                check(same(got, want),
                      f"chop batch {what}{tag} route={route}")
                e["chop"] = max(e["chop"], abs_err(got, want))
                n_checks += 1
            for k in range(B):
                one = chop_expr_op(form, *(o[k] for o in ops),
                                   fmt_id=int(ids[k]),
                                   live=None if live is None else live)
                check(same(got[k], one),
                      f"chop batch {what}{tag}: row {k} against its "
                      "single-format launch")
        for M, K in ((128, 128), (512, 512), (33, 300)):
            wide = torch.randn(B, M, K + 3, generator=g,
                               dtype=torch.float64).to(dt).to(dev)
            a = wide[:, :, :K]
            v = torch.randn(B, K, generator=g,
                            dtype=torch.float64).to(dt).to(dev)
            for chop_out in (True, False):
                want = qmv_ref(a, v, rows, chop_out=chop_out)
                for route in QMV_ROUTES:
                    got = qmv_op(a, v, rows, chop_out=chop_out, route=route)
                    check(same(got, want), f"qmv batch {M}x{K}{tag} "
                          f"route={route} chop_out={chop_out}")
                    e["qmv"] = max(e["qmv"], abs_err(got, want))
                    for k in range(B):
                        one = qmv_op(a[k], v[k], int(ids[k]),
                                     chop_out=chop_out, route=route)
                        check(same(got[k], one), f"qmv batch {M}x{K}{tag} "
                              f"route={route}: row {k}")
                    n_checks += 1
        for n in (128, 512, 37):
            Lu = torch.stack([factor_like(n, dev, n + k) for k in range(B)]
                             ).to(dt)
            b = torch.randn(B, n, generator=g,
                            dtype=torch.float64).to(dt).to(dev)
            for lower in (True, False):
                want = trisolve_ref(Lu, b, rows, lower=lower, block=128)
                for route in ("shfl", "smem"):
                    got = trisolve_op(Lu, b, rows, lower=lower, block=128,
                                      route=route)
                    check(same(got, want), f"trisolve batch n={n}{tag} "
                          f"lower={lower} route={route}")
                    e["trisolve"] = max(e["trisolve"], abs_err(got, want))
                    for k in range(B):
                        one = trisolve_op(Lu[k], b[k], int(ids[k]),
                                          lower=lower, block=128,
                                          route=route)
                        check(same(got[k], one), f"trisolve batch n={n}"
                              f"{tag} lower={lower} route={route}: row {k}")
                    n_checks += 1
        for m, kk in ((448, 64), (64, 64), (480, 32), (384, 128)):
            a = torch.randn(B, m, kk, generator=g,
                            dtype=torch.float64).to(dt).to(dev)
            b = torch.randn(B, kk, m, generator=g,
                            dtype=torch.float64).to(dt).to(dev)
            got = qgemm_op(a, b, rows)
            for k in range(B):
                fid = int(ids[k])
                want = qgemm_ref(a[k], b[k], fid)
                ok, ek, _ = held(got[k], want, a[k], b[k], fid, 128, True)
                check(ok, f"qgemm batch ({m}, {kk}){tag}: row {k} fid={fid}"
                      " outside the order tolerance")
                e["qgemm"] = max(e["qgemm"], ek)
                check(same(got[k], qgemm_op(a[k], b[k], fid)),
                      f"qgemm batch ({m}, {kk}){tag}: row {k} against its "
                      "single-format launch")
            n_checks += 1
    torch.cuda.synchronize()
    say(f"batched kernel checks ({n_checks} batched calls of {B} rows, ids "
        f"{list(BATCH_IDS)}, each row also against its single-format "
        f"launch; float32 and float64) passed in "
        f"{time.perf_counter() - t0:.1f} s; max abs err "
        + json.dumps({str(dt)[6:]: dict(c) for dt, c in err.items()}))
    return err


def run_main_path(dev):
    """Phase 4: the bandit loop on the card, counting kernel launches."""
    from repro_torch.core import (AutotuneEngine, TrainConfig, W1,
                                  evaluate_policy, reduced_action_space,
                                  train_policy)
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.solvers import IRConfig
    from repro_torch.tasks import GMRESIRTask
    t0 = time.perf_counter()
    systems = generate_dense_set(N_SYSTEMS, np.random.default_rng(SEED),
                                 n_range=(100, 500))
    task = GMRESIRTask(systems, reduced_action_space(), IRConfig(tau=1e-6),
                       device=dev)
    engine = AutotuneEngine(task, chunk=8)
    buckets = sorted({task.bucket_key(s) for s in systems})
    say(f"main path: {N_SYSTEMS} systems, n = "
        f"{sorted(s.n for s in systems)}, buckets {buckets}, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    check(buckets == list(N_PADS), f"buckets {buckets}")

    library.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy, hist = train_policy(engine, W1, TrainConfig(
        episodes=EPISODES, n_bins=(4, 4), seed=0))
    t1 = time.perf_counter()
    ev = evaluate_policy(policy, engine, tau_base=1e-6)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(library.LAUNCHES)
    routes = {k: dict(v) for k, v in library.ROUTE_LAUNCHES.items()}
    say(f"train_policy: {EPISODES} episodes, {hist.n_solves} solves, "
        f"{t1 - t0:.1f} s; evaluate_policy: {t2 - t1:.1f} s")
    say("episode reward:", [round(r, 3) for r in hist.episode_reward])
    say("format usage per solve:", ev["usage_per_solve"])
    say("kernels", json.dumps(launches))
    say("routes", json.dumps(routes))
    for name in SOLVER_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched")
    for name in ("qmv", "trisolve"):
        check(routes[name] == {"shfl": launches[name]},
              f"{name} launches off the shfl route: {routes[name]}")
    by = chop_by(routes["chop"])
    say(f"chop: {launches['chop']} launches (one a rounding: "
        f"{UNFUSED_CHOP_LAUNCHES}); by form {json.dumps(dict(by['form']))}, "
        f"by route {json.dumps(dict(by['route']))}")
    check(launches["chop"] < UNFUSED_CHOP_LAUNCHES,
          f"chop: {launches['chop']} launches, not below "
          f"{UNFUSED_CHOP_LAUNCHES}")
    check(launches["chop"] == MAIN_PATH_CHOP,
          f"chop: {launches['chop']} launches, not {MAIN_PATH_CHOP}")
    for name, want in MAIN_PATH_LAUNCHES.items():
        check(launches[name] == want,
              f"{name}: {launches[name]} launches, not {want}")
    got = [round(r, 3) for r in hist.episode_reward]
    check(got == list(MAIN_PATH_REWARDS),
          f"episode rewards {got}, not {MAIN_PATH_REWARDS}")
    for i, a in ev["actions"]:
        o = engine.outcome(i, a)
        check(o.status in (0, 1, 2, 3), f"status {o.status}")
        if o.status != 3:
            check(np.isfinite(o.ferr) and np.isfinite(o.nbe),
                  f"non-finite ferr/nbe on a solve that did not fail: {o}")
    check(all(np.isfinite(ev["ferr"])), "evaluation ferr")
    base_launches = run_baseline(engine, ev, "main path")
    return launches, routes, systems, set(by["form"]), base_launches, policy


def chop_by(chop_routes):
    """chop's launches by form and by route, from its "<form>/<route>"
    counts."""
    by = {"form": collections.Counter(), "route": collections.Counter()}
    for key, count in chop_routes.items():
        form, route = key.split("/")
        by["form"][form] += count
        by["route"][route] += count
    return by


def run_baseline(engine, ev, what):
    """The paper's baseline column: `evaluate_fixed_action` under the
    all-fp64 action (the last of the reduced space), its launches counted
    apart from the path's (counts set to 0 just before, read just
    after), its table printed beside `evaluate_policy`'s. The card's
    carrier is float32 (`CudaBackend`), so fp64 rounds nothing and the
    action runs as fp32 throughout."""
    from repro_torch.core import evaluate_fixed_action
    from repro_torch.kernels import library
    a = engine.action_space.n_actions - 1
    fmts = engine.action_space.actions[a].tolist()
    solves = engine.n_solves
    library.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = evaluate_fixed_action(engine, a, 1e-6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(library.LAUNCHES)
    new = engine.n_solves - solves
    say(f"{what}: evaluate_fixed_action(action {a} = format ids {fmts}, "
        "all fp64; on the card's float32 carrier it runs as fp32): "
        f"{wall:.1f} s, {new} new solves, launches {json.dumps(launches)}")
    say(f"{what}: table evaluate_policy      {json.dumps(ev['table'])}")
    say(f"{what}: table evaluate_fixed_action {json.dumps(base['table'])}")
    statuses = collections.Counter(engine.outcome(i, a).status
                                   for i in range(len(engine.instances)))
    say(f"{what}: baseline status counts {json.dumps(dict(statuses))} "
        "(0 converged, 1 stagnated, 2 max-iter, 3 failed)")
    check(base["table"] and len(base["ferr"]) == len(engine.instances),
          f"{what}: baseline table")
    check(set(statuses) <= {0, 1, 2, 3}, f"{what}: baseline status")
    if new:     # every solve rounds and runs the residual's matvec
        for name in ("chop", "qmv"):
            check(launches[name] > 0,
                  f"{what}: baseline never launched {name}")
    return launches


def run_cg_path(dev):
    """Phase 4c: CG-IR's bandit loop on the card at full width, counting
    kernel launches: `train_policy`, `evaluate_policy` and the baseline,
    each timed, with the counts set to 0 just before the loop and read
    just after (the baseline's counted apart)."""
    from repro_torch.core import (AutotuneEngine, TrainConfig, W1,
                                  evaluate_policy, reduced_action_space,
                                  train_policy)
    from repro_torch.data.matrices import generate_sparse_set
    from repro_torch.kernels import library
    from repro_torch.solvers import CGConfig
    from repro_torch.tasks import CGIRTask
    t0 = time.perf_counter()
    systems = generate_sparse_set(CG_SYSTEMS, np.random.default_rng(CG_SEED),
                                  n_range=(200, 500), lambda_s=0.01,
                                  log10_kappa_range=CG_KAPPA)
    task = CGIRTask(systems, reduced_action_space(), CGConfig(tau=1e-6),
                    device=dev)
    engine = AutotuneEngine(task, chunk=8)
    buckets = sorted({task.bucket_key(s) for s in systems})
    say(f"CG path: {CG_SYSTEMS} sparse SPD systems, n = "
        f"{sorted(s.n for s in systems)}, kappa_est = "
        f"{[float(f'{k:.3g}') for k in sorted(task.kappas)]}, buckets "
        f"{buckets}, set-up {time.perf_counter() - t0:.1f} s")
    check(buckets == [256, 384, 512], f"CG buckets {buckets}")

    library.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy, hist = train_policy(engine, W1, TrainConfig(
        episodes=CG_EPISODES, n_bins=(4, 4), seed=0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = evaluate_policy(policy, engine, tau_base=1e-6)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(library.LAUNCHES)
    routes = {k: dict(v) for k, v in library.ROUTE_LAUNCHES.items()}
    statuses = collections.Counter(engine.outcome(i, a).status
                                   for i, a in ev["actions"])
    say(f"CG train_policy: {CG_EPISODES} episodes, {hist.n_solves} solves, "
        f"{t1 - t0:.1f} s; evaluate_policy: {t2 - t1:.1f} s")
    say("CG episode reward:", [round(r, 3) for r in hist.episode_reward])
    say(f"CG evaluation status counts {json.dumps(dict(statuses))}; CG "
        f"iterations per solve {ev['n_inner'].tolist()}")
    say("CG kernels", json.dumps(launches))
    say("CG routes", json.dumps(routes))
    by = chop_by(routes["chop"])
    say(f"CG chop: {launches['chop']} launches; by form "
        f"{json.dumps(dict(by['form']))}, by route "
        f"{json.dumps(dict(by['route']))}")
    for name in SOLVER_KERNELS:
        check(launches[name] > 0, f"CG path: kernel {name} never launched")
    check(by["form"]["add_mul"] > 0, "CG path: add_mul never launched")
    for i, a in ev["actions"]:
        o = engine.outcome(i, a)
        check(o.status in (0, 1, 2, 3), f"CG status {o.status}")
        if o.status != 3:
            check(np.isfinite(o.metrics["ferr"])
                  and np.isfinite(o.metrics["nbe"]),
                  f"CG: non-finite ferr/nbe on a solve that did not fail: "
                  f"{o}")
    check(statuses[0] + statuses[1] + statuses[2] > 0,
          "CG path: every evaluated solve failed")
    base_launches = run_baseline(engine, ev, "CG path")
    return {"launches": launches, "routes": routes, "forms": set(by["form"]),
            "baseline_launches": base_launches, "systems": systems,
            "train_s": t1 - t0, "evaluate_s": t2 - t1,
            "solves": hist.n_solves}


def check_cg_against_cpu(cg_systems, dev):
    """Phase 4b for CG: solves on the card against the same solves on the
    CPU (float32 carrier, plain versions). One strict solve (n_pad 128)
    under an action that converges in a few CG iterations (the strict
    substitution costs ~2,500 host operations an `lu_solve`), bit for bit
    in all six fields; one blocked solve (the CG path's best-conditioned
    system of bucket 256) with a bf16 factorization, held as
    `check_against_cpu` holds
    GMRES's; and two systems at the paper's condition numbers (the
    generator's default log10 kappa 8..10, n_pad 128) under the all-fp64
    action, which on this carrier fail as the reference's do: the card
    and the CPU must agree bit for bit."""
    from repro_torch.core.batching import pad_to_bucket
    from repro_torch.data.matrices import generate_sparse_set, sparse_spd
    from repro_torch.solvers import CGConfig, cg_ir
    cfg = CGConfig(tau=1e-6)
    strict = sparse_spd(120, 0.01, np.random.default_rng(CG_SEED), 1e3)
    # n <= 128: the strict path, which the reference pins, so the card
    # and the CPU must agree bit for bit.
    paper = generate_sparse_set(2, np.random.default_rng(CG_SEED + 1),
                                n_range=(100, 128))
    blocked = min((s for s in cg_systems if s.n <= 256),
                  key=lambda s: s.kappa)
    cases = [(strict, [5, 5, 5, 6], "strict"),
             (blocked, [2, 4, 5, 5], "blocked")]
    cases += [(s, [6, 6, 6, 6], "paper kappa") for s in paper]
    for sys_, action, what in cases:
        A, b, x = pad_to_bucket(sys_)
        t0 = time.perf_counter()
        gpu = cg_ir(A, b, x, action, cfg, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = cg_ir(A, b, x, action, cfg, device="cpu",
                    carrier_dtype="float32")
        t2 = time.perf_counter()
        say(f"CG {what} n={sys_.n} n_pad={A.shape[0]} kappa_est="
            f"{sys_.kappa:.3g} action={action}: card "
            f"{[float(v) for v in gpu]} ({t1 - t0:.2f} s), cpu "
            f"{[float(v) for v in cpu]} ({t2 - t1:.2f} s)")
        for f in ("status", "n_outer", "n_cg"):
            check(int(getattr(gpu, f)) == int(getattr(cpu, f)),
                  f"CG {what}: {f} card vs cpu at n_pad={A.shape[0]}")
        if A.shape[0] < 256:
            for f, g_, c_ in zip(gpu._fields, gpu, cpu):
                check(torch.equal(g_.cpu(), c_),
                      f"CG {what}: {f} card vs cpu, strict")
        elif what == "blocked":
            for f in ("ferr", "nbe"):
                g_, c_ = float(getattr(gpu, f)), float(getattr(cpu, f))
                check(abs(g_ - c_) <= 1e-3 * abs(c_),
                      f"CG {what}: {f} card vs cpu: {g_} vs {c_}")
        if what == "strict":
            check(int(gpu.status) != 3 and int(gpu.n_cg) <= 10,
                  f"CG strict: not a short solve: {gpu}")


def run_tuned_blocking(dev):
    """The panel-width sweep at n_pad 512 on the card, twice, with the
    sweep's caches cleared in between: each width's device time (the
    replays of one CUDA graph of its pipeline). The two winners must
    agree unless the first sweep's two fastest widths are within
    `SWEEP_TIE` of each other."""
    from repro_torch.solvers import BlockingPolicy
    from repro_torch.solvers import block_autotune
    sweeps = []
    for _ in range(2):
        block_autotune._CACHE.clear()
        block_autotune._TIMINGS.clear()
        t0 = time.perf_counter()
        pol = block_autotune.tuned_blocking(512, device=dev,
                                            base=BlockingPolicy())
        wall = time.perf_counter() - t0
        (times,) = block_autotune.sweep_timings().values()
        ms = {w: round(t * 1e3, 4) for w, t in sorted(times.items())}
        say(f"tuned_blocking(512), sweep {len(sweeps) + 1}: lu_block "
            f"{pol.lu_block} in {wall:.2f} s; device ms per blocked LU + "
            f"both substitutions, by panel width (best of 3 CUDA graph "
            f"replays): {json.dumps(ms)}")
        check(pol.lu_block in (32, 64, 128), f"tuned lu_block {pol.lu_block}")
        sweeps.append((pol.lu_block, ms))
    (w1, ms1), (w2, _) = sweeps
    first, second = sorted(ms1.values())[:2]
    check(w1 == w2 or second - first <= SWEEP_TIE * first,
          f"the sweep's winner moved from {w1} to {w2} while its two "
          f"fastest widths are {first} and {second} ms apart")
    return [ms for _, ms in sweeps]


def check_against_cpu(systems, dev):
    """Phase 4b: one strict and one blocked solve, card vs CPU (float32
    carrier, plain versions). The strict path is pinned op for op, so it
    must agree bit for bit; the blocked path has the LU's unpinned dots
    (cuBLAS and the qgemm kernel vs the CPU's matmul), so it is held to
    equal status and iteration counts and ferr/nbe within 1e-3 relative,
    on an action whose factorization format (bf16) rounds every dot."""
    from repro_torch.core.batching import pad_to_bucket
    from repro_torch.solvers import IRConfig, gmres_ir
    cfg = IRConfig(tau=1e-6)
    strict = min(systems, key=lambda s: s.n)
    blocked = min((s for s in systems if s.n > 256), key=lambda s: s.n)
    for sys_, action, exact in ((strict, [2, 4, 5, 6], True),
                                (blocked, [2, 4, 5, 5], False)):
        A, b, x = pad_to_bucket(sys_)
        t0 = time.perf_counter()
        gpu = gmres_ir(A, b, x, action, cfg, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = gmres_ir(A, b, x, action, cfg, device="cpu",
                       carrier_dtype="float32")
        t2 = time.perf_counter()
        say(f"n_pad={A.shape[0]} action={action}: card "
            f"{[float(v) for v in gpu]} ({t1 - t0:.2f} s), cpu "
            f"{[float(v) for v in cpu]} ({t2 - t1:.2f} s)")
        for f in ("status", "n_outer", "n_gmres"):
            check(int(getattr(gpu, f)) == int(getattr(cpu, f)),
                  f"{f} card vs cpu at n_pad={A.shape[0]}")
        if exact:
            for f, g_, c_ in zip(gpu._fields, gpu, cpu):
                check(torch.equal(g_.cpu(), c_), f"{f} card vs cpu, strict")
        else:
            for f in ("ferr", "nbe"):
                g_, c_ = float(getattr(gpu, f)), float(getattr(cpu, f))
                check(abs(g_ - c_) <= 1e-3 * abs(c_),
                      f"{f} card vs cpu, blocked: {g_} vs {c_}")


class StepClock:
    """A clock that moves only when told (stream A: the card's and the
    CPU's servers flush the same batches)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def serve(server, requests, clock=None, flushes=None):
    """Submit `requests` in order (a step clock moves 0.01 s a request),
    then drain; every response must be polled exactly once. Returns the
    responses by request id, and the flushes in `flushes`."""
    if flushes is not None:
        pump = server.batcher.pump

        def recording_pump(force=False):
            out = pump(force)
            flushes.extend(out)
            return out
        server.batcher.pump = recording_pump
    ids = []
    for sys_ in requests:
        if clock is not None:
            clock.t += 0.01
        ids.append(server.submit(sys_))
    server.drain()
    got = {}
    for rid in ids:
        resp = server.poll(rid)
        check(resp is not None, f"request {rid} was never answered")
        check(server.poll(rid) is None, f"request {rid} polled twice")
        got[rid] = resp
    check(server.pending == 0, f"{server.pending} requests left queued")
    return got


def same_tables(a, b):
    return (np.array_equal(a.qtable.Q, b.qtable.Q)
            and np.array_equal(a.qtable.N, b.qtable.N))


def run_serve(dev, policy):
    """Phase 9: the online server on the card, from phase 4's policy
    published into a registry. Stream A (strict requests) on the card and
    on the CPU (float32 carrier), bit for bit; stream B (buckets
    128..512) on the card with the launch counts set to 0 just before
    and read just after, then a snapshot, its reload, and one scrape of
    /metrics and /healthz on 127.0.0.1."""
    import tempfile
    import urllib.request
    from repro_torch.core import W1
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.obs import MetricsRegistry, Observability
    from repro_torch.service import (AutotuneServer, BatcherConfig,
                                     PolicyRegistry)
    from repro_torch.solvers import IRConfig
    from repro_torch.tasks import GMRESIRTask
    cfg = IRConfig(tau=1e-6)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        reg = PolicyRegistry(root)
        v1 = reg.publish(policy, note="phase 4's policy")
        reg.promote(v1)

        seed, n, n_range = SERVE_A
        reqs = generate_dense_set(n, np.random.default_rng(seed),
                                  n_range=n_range)
        streams = {}
        for where, task in (
                ("card", GMRESIRTask(ir_cfg=cfg, device=dev)),
                ("cpu", GMRESIRTask(ir_cfg=cfg, device="cpu",
                                    carrier_dtype="float32"))):
            clock = StepClock()
            server = AutotuneServer(
                reg, task, W1, BatcherConfig(max_batch=SERVE_MAX_BATCH),
                clock=clock, seed=0, obs=False)
            t0 = time.perf_counter()
            streams[where] = (serve(server, reqs, clock), server)
            torch.cuda.synchronize()
            say(f"serve stream A on the {where}: {n} requests (n = "
                f"{sorted(s.n for s in reqs)}, bucket 128) in "
                f"{time.perf_counter() - t0:.2f} s")
        (card, card_srv), (cpu, cpu_srv) = streams["card"], streams["cpu"]
        check(card.keys() == cpu.keys(), "stream A: request ids")
        for rid in card:
            g, c = card[rid], cpu[rid]
            for f in ("action", "state", "reward", "bucket", "seq"):
                check(getattr(g, f) == getattr(c, f),
                      f"stream A request {rid}: {f} card "
                      f"{getattr(g, f)} vs cpu {getattr(c, f)}")
            for f in ("status", "n_outer", "n_gmres"):
                check(int(getattr(g.record, f)) == int(getattr(c.record, f)),
                      f"stream A request {rid}: {f} card vs cpu")
            check(g.record.metrics == c.record.metrics,
                  f"stream A request {rid}: {g.record.metrics} vs "
                  f"{c.record.metrics}")
            check(g.bucket == 128, f"stream A request {rid}: bucket "
                  f"{g.bucket}")
        check(same_tables(card_srv.live, cpu_srv.live),
              "stream A: Q/N tables card vs cpu")
        say("serve stream A: actions "
            f"{[card[r].action for r in sorted(card)]}, rewards "
            f"{[round(card[r].reward, 4) for r in sorted(card)]}: card and "
            "cpu equal bit for bit (action, state, status, n_outer, "
            "n_gmres, ferr, nbe, res_norm, reward, Q/N tables)")

        seed, n, n_range = SERVE_B
        reqs = generate_dense_set(n, np.random.default_rng(seed),
                                  n_range=n_range)
        server = AutotuneServer(
            reg, GMRESIRTask(ir_cfg=cfg, device=dev), W1,
            BatcherConfig(max_batch=SERVE_MAX_BATCH), seed=0,
            obs=Observability(registry=MetricsRegistry()))
        n_before = int(server.live.qtable.N.sum())
        flushes = []
        library.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = serve(server, reqs, flushes=flushes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(library.LAUNCHES)
        tel = server.telemetry.snapshot()
        buckets = sorted({server.task.bucket_key(s) for s in reqs})
        say(f"serve stream B: {n} requests, n = "
            f"{sorted(s.n for s in reqs)}, buckets {buckets}, "
            f"max_batch {SERVE_MAX_BATCH}: {wall:.2f} s, "
            f"{n / wall:.2f} requests/s")
        say("serve stream B flushes (bucket, requests, rows, solve s): "
            + json.dumps([(f.bucket, len(f.req_ids), f.n_rows,
                           round(f.solve_s, 4)) for f in flushes]))
        say("serve stream B latency s: " + json.dumps(tel["latency_s"])
            + "; per bucket " + json.dumps(tel["latency_s_per_bucket"]))
        say(f"serve stream B status counts {json.dumps(tel['status_counts'])}"
            f"; kernels {json.dumps(launches)}")
        check(len(got) == n and tel["responses"] == n,
              f"stream B: {len(got)} responses of {n}")
        check(tel["updates"] == n and server.quarantined_updates == 0,
              f"stream B: {tel['updates']} Q-updates, "
              f"{server.quarantined_updates} quarantined")
        check(int(server.live.qtable.N.sum()) - n_before == n,
              "stream B: the Q-table's visit counts did not grow by "
              f"{n}")
        check(set(buckets) == set(N_PADS), f"stream B buckets {buckets}")
        for name in SOLVER_KERNELS:
            check(launches[name] > 0,
                  f"stream B: kernel {name} never launched")
        for resp in got.values():
            check(resp.record.status in (0, 1, 2, 3)
                  and np.isfinite(resp.reward),
                  f"stream B: response {resp}")

        v2 = server.snapshot()
        back = PolicyRegistry(root).load()
        check(v2 == "v0002" and reg.current_version() == v2,
              f"snapshot version {v2}")
        check(same_tables(back, server.live),
              "the reloaded snapshot's tables differ from the server's")
        meta = reg.verify(v2)
        check(meta["wal"]["seq"] == n, f"snapshot wal {meta['wal']}")
        say(f"serve snapshot {v2}: reloaded, tables equal, verified "
            f"(sha256 {sorted(meta['checksums'])})")

        http = server.serve_obs()
        try:
            scraped = {}
            for path in ("/metrics", "/healthz"):
                with urllib.request.urlopen(http.url + path,
                                            timeout=HTTP_TIMEOUT_S) as r:
                    scraped[path] = (r.status, r.read().decode())
        finally:
            server.obs.close()
        status, text = scraped["/metrics"]
        served = sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                     if ln.startswith("repro_service_requests_total{"))
        health = json.loads(scraped["/healthz"][1])
        say(f"serve /metrics on {http.host}: HTTP {status}, "
            f"{len(text.splitlines())} lines, "
            f"repro_service_requests_total {served:g}; /healthz "
            f"{scraped['/healthz'][0]} {health['status']}")
        check(status == 200 and served == n,
              f"/metrics: HTTP {status}, requests counter {served}")
        check(scraped["/healthz"][0] == 200 and health["status"] == "ok",
              f"/healthz: {scraped['/healthz']}")
        out.update(launches=launches, latency_s=tel["latency_s"],
                   flushes=[(f.bucket, len(f.req_ids), f.solve_s)
                            for f in flushes], wall_s=wall)
    return out


def time_ms(fn, reps, warmup=2, rounds=1):
    """ms per call: CUDA events around `reps` back-to-back calls; the
    median of `rounds` such runs (a call that the host's cost bounds
    varies with the host, which the card's machine shares)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def device_kernels(fn, reps, sessions=3):
    """Run fn reps times under torch.profiler; return {kernel name: total
    device microseconds} over the CUDA-side events, {kernel name: number
    of events}, and the wall time. A session that records no device
    activity (CUPTI on the chip machine does so now and then) is run
    again, up to `sessions` in all; None when none recorded any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(sessions):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out, count = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
                count[e.name] = count.get(e.name, 0) + 1
        if sum(out.values()) > 0:
            return out, count, wall
        say("profiler: a session recorded no device activity")
    return None


def device_ms(fn, reps):
    """Device time per call from torch.profiler: every device operation
    of a call counts (the qgemm/qmatmul wrappers launch two kernels a
    call on the tensor cores, the pack and the GEMM). A session may drop
    a record (one kernel name then shows fewer operations than `reps`
    calls made), so each name counts its mean time per operation times
    its operations per call, rounded. Where no session records device
    activity, CUDA events around the `reps` calls stand in (as the
    per-call time does), and the line says so."""
    prof = device_kernels(fn, reps)
    if prof is None:
        say("profiler: no device activity in any session; CUDA events "
            "instead")
        return time_ms(fn, reps, warmup=0)
    kern, count, _ = prof
    if any(c % reps for c in count.values()):
        say(f"profiler: {sum(count.values())} device operations for {reps}"
            " calls, not the same number a call for every kernel; each "
            "kernel's mean time per operation is used")
    return sum(kern[k] / count[k] * max(1, round(count[k] / reps))
               for k in kern) / 1e3


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def time_kernels(dev):
    """Phase 5: each kernel at the main path's largest shape, format bf16;
    chop also at its other shapes and in a fused form. Returns the
    timing rows, trisolve's chain bound, and chop's route and bf16
    round-trip times by shape."""
    from repro_torch.kernels.chop import (chop_expr_op, chop_expr_ref,
                                          chop_op, chop_ref, chop_route)
    from repro_torch.kernels.qmatmul import qgemm_op, qgemm_ref, qmv_op, \
        qmv_ref
    from repro_torch.kernels.trisolve import trisolve_op, trisolve_ref
    from repro_torch.precision import chop
    fid, n, m = 2, 512, 448
    g = torch.Generator().manual_seed(1)
    A = torch.randn(n, n, generator=g).to(dev)
    v = torch.randn(n, generator=g).to(dev)
    a = torch.randn(m, 64, generator=g).to(dev)
    b = torch.randn(64, m, generator=g).to(dev)
    Lu = factor_like(n, dev, 7)
    Ac, vc, ac, bc = (chop(t, fid) for t in (A, v, a, b))
    # qgemm's yardstick and bound follow its route: format bf16 runs on
    # the bf16 tensor cores, so one torch.matmul on bf16 operands and
    # the bf16 rate.
    ltype, tf32, gemm_rate = gemm_route(fid)
    check(not tf32, "phase 5 times qgemm in a format without TF32")
    acl, bcl = ac.to(ltype), bc.to(ltype)
    rows = {}
    rows["chop"] = (lambda: chop_op(A, fid), lambda: chop_ref(A, fid), None,
                    2 * n * n * 4, 0, F32_FLOP_PER_S, f"x ({n}, {n})")
    # chop at the main path's other shapes: the 0-dim launch floor (most
    # of the path's launches), short vectors, the strict LU's matrix, and
    # the fused chop(a - chop(b c)) as GMRES's w update (b 0-dim) and on
    # three matrices. Beside each, x.to(bfloat16).float(): two torch
    # launches that round to bf16, a reference point.
    B, C = (torch.randn(n, n, generator=g).to(dev) for _ in range(2))
    chop_shapes = {"chop": ("x", (A,))}
    for label, x in (("0-dim", v[7].clone()), ("(128,)", v[:128].clone()),
                     (f"({n},)", v), ("(128, 128)",
                                      A[:128, :128].contiguous())):
        chop_shapes["chop " + label] = ("x", (x,))
    chop_shapes[f"chop sub_mul ({n},)"] = ("sub_mul", (B[0], v[3].clone(),
                                                       C[0]))
    chop_shapes[f"chop sub_mul ({n}, {n})"] = ("sub_mul", (A, B, C))
    # CG's z + chop(alpha p) and y + chop(beta p) (alpha 0-dim).
    chop_shapes[f"chop add_mul ({n},)"] = ("add_mul", (B[1], v[5].clone(),
                                                       C[1]))
    chop_extra = {}
    for name, (form, ops) in chop_shapes.items():
        numel = ops[0].numel()
        if name != "chop":
            rows[name] = (
                lambda form=form, ops=ops: chop_expr_op(form, *ops,
                                                        fmt_id=fid),
                lambda form=form, ops=ops: chop_expr_ref(form, *ops,
                                                         fmt_id=fid),
                None, (sum(t.numel() for t in ops) + numel) * 4,
                0 if form == "x" else 2 * numel, F32_FLOP_PER_S,
                f"{form}, " + ", ".join(str(tuple(t.shape)) for t in ops))
        x = ops[0]
        chop_extra[name] = {
            "chop_route": chop_route(numel, True, form),
            "bf16_roundtrip": lambda x=x: x.to(torch.bfloat16).float()}
    rows["qmv"] = (lambda: qmv_op(A, v, fid), lambda: qmv_ref(A, v, fid),
                   lambda: torch.mv(Ac, vc), (n * n + 2 * n) * 4,
                   2 * n * n, F32_FLOP_PER_S, f"A ({n}, {n}) x v ({n},)")
    rows["qgemm"] = (lambda: qgemm_op(a, b, fid),
                     lambda: qgemm_ref(a, b, fid),
                     lambda: torch.matmul(acl, bcl),
                     (2 * m * 64 + m * m) * 4, 2 * m * m * 64, gemm_rate,
                     f"({m}, 64) x (64, {m}); library on {ltype} operands")
    # qgemm at the trailing update of the sweep's other panel widths,
    # its first (largest) at n_pad 512, held before it is timed.
    for k in QGEMM_PANELS:
        mk = n - k
        ak = torch.randn(mk, k, generator=g).to(dev)
        bk_ = torch.randn(k, mk, generator=g).to(dev)
        held_gemm(qgemm_op(ak, bk_, fid), qgemm_ref(ak, bk_, fid), ak, bk_,
                  fid, 128, True, f"qgemm K={k}")
        akl, bkl = chop(ak, fid).to(ltype), chop(bk_, fid).to(ltype)
        rows[f"qgemm K={k}"] = (
            lambda ak=ak, bk_=bk_: qgemm_op(ak, bk_, fid),
            lambda ak=ak, bk_=bk_: qgemm_ref(ak, bk_, fid),
            lambda akl=akl, bkl=bkl: torch.matmul(akl, bkl),
            (2 * mk * k + mk * mk) * 4, 2 * mk * mk * k, gemm_rate,
            f"({mk}, {k}) x ({k}, {mk}); library on {ltype} operands")
    # trisolve's yardstick: one solve_triangular on the pre-chopped
    # factor (unit lower, or upper with its diagonal) and rhs.
    Lc, vcol = chop(Lu, fid), vc[:, None]
    for lower in (True, False):
        tri = n * (n - 1) // 2 if lower else n * (n + 1) // 2
        rows["trisolve" if lower else "trisolve upper"] = (
            lambda lower=lower: trisolve_op(Lu, v, fid, lower=lower),
            lambda lower=lower: trisolve_ref(Lu, v, fid, lower=lower),
            lambda lower=lower: torch.linalg.solve_triangular(
                Lc, vcol, upper=not lower, unitriangular=lower),
            (tri + 2 * n) * 4, 2 * tri, F32_FLOP_PER_S,
            f"Lu ({n}, {n}), {'lower' if lower else 'upper'}, block 128; "
            "library torch.linalg.solve_triangular on the chopped factor")
    chain = chain_bound(n, 128)
    out = {}
    for name, (kern, plain, lib, nbytes, flops, rate, shape) in rows.items():
        ms = time_ms(kern, 200, rounds=5)
        plain_ms = time_ms(plain, 3 if name.startswith("trisolve") else 50,
                           warmup=1)
        lib_ms = time_ms(lib, 200, rounds=5) if lib is not None else None
        # Device time alone (the per-call times above include the host's
        # cost of issuing the call when that exceeds the kernel's).
        dev_ms = device_ms(kern, 50)
        lib_dev_ms = device_ms(lib, 50) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops, rate)
        out[name] = (ms, plain_ms, lib_ms, b_ms, b_by, dev_ms, lib_dev_ms)
        chain_ms = chain["upper" if name.endswith("upper") else "lower"]
        extra = ""
        if name in chop_extra:
            rt = chop_extra[name].pop("bf16_roundtrip")
            chop_extra[name]["bf16_roundtrip_ms"] = time_ms(rt, 200,
                                                            rounds=5)
            chop_extra[name]["bf16_roundtrip_device_ms"] = device_ms(rt, 50)
            extra = (f", route {chop_extra[name]['chop_route']}; "
                     "x.to(bfloat16).float() "
                     f"{chop_extra[name]['bf16_roundtrip_ms']:.4f} ms per "
                     "call, "
                     f"{fmt_ms(chop_extra[name]['bf16_roundtrip_device_ms'])}"
                     " on the device")
        say(f"time {name} [{shape}, bf16{extra}]: kernel {ms:.4f} ms per "
            "call, "
            f"{fmt_ms(dev_ms)} on the device; plain {plain_ms:.4f} ms; "
            "library " + ("-" if lib_ms is None else
                          f"{lib_ms:.4f} ms per call, {fmt_ms(lib_dev_ms)} "
                          "on the device")
            + f"; bound {b_ms:.3g} ms ({b_by}; operations at "
            f"{rate / 1e12:.0f} TFLOP/s)"
            + (f"; chain bound {chain_ms:.4f} ms"
               if name.startswith("trisolve") else ""))
    say("trisolve chain bound: " + chain["text"])
    return out, chain, chop_extra


def chain_bound(n_pad, block, dtype=torch.float32):
    """trisolve's chain bound (`scripts/chain_bound.py`) on the carrier
    `dtype`, from latencies measured on this card."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chain_bound", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "scripts", "chain_bound.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bound(n_pad, block, dtype=dtype)


def profile_solves(systems, cg_systems, f64_cg_systems, dev):
    """Phase 6: where a solve's time goes — one strict (n_pad 128) and one
    blocked (n_pad 512) GMRES-IR solve and one blocked CG-IR solve (the
    CG path's largest system) under the profiler, after a warm-up
    solve; then phase 10's: the blocked GMRES-IR solve and the largest
    of the paper's sparse systems (n_pad 512) on the float64 carrier
    under the all-fp64 action."""
    from repro_torch.core.batching import pad_to_bucket
    from repro_torch.solvers import CGConfig, IRConfig, cg_ir, gmres_ir
    mixed, fp64 = [2, 4, 5, 6], [6, 6, 6, 6]
    solves = [(gmres_ir, IRConfig(tau=1e-6), min(systems, key=lambda s: s.n),
               mixed, "float32"),
              (gmres_ir, IRConfig(tau=1e-6), max(systems, key=lambda s: s.n),
               mixed, "float32"),
              (cg_ir, CGConfig(tau=1e-6), max(cg_systems, key=lambda s: s.n),
               mixed, "float32"),
              (gmres_ir, IRConfig(tau=1e-6), max(systems, key=lambda s: s.n),
               fp64, "float64"),
              (cg_ir, CGConfig(tau=1e-6), max(f64_cg_systems,
                                              key=lambda s: s.n),
               fp64, "float64")]
    for fn, cfg, sys_, action, carrier in solves:
        A, b, x = pad_to_bucket(sys_)

        def solve():
            return fn(A, b, x, action, cfg, device=dev,
                      carrier_dtype=carrier)
        stats = solve()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = device_kernels(solve, 1)
        if prof is None:
            say(f"profile {fn.__name__} {carrier} n_pad={A.shape[0]} "
                f"action={action}: wall {wall * 1e3:.1f} ms; device busy not "
                "measured (the profiler recorded no device activity)")
            continue
        kern, count, wall_prof = prof
        count = sum(count.values())
        busy = sum(kern.values()) / 1e3
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        say(f"profile {fn.__name__} {carrier} n_pad={A.shape[0]} "
            f"action={action} "
            f"({int(stats.n_outer)} outer, {int(stats[3])} inner iterations):"
            f" wall {wall * 1e3:.1f}"
            f" ms ({wall_prof * 1e3:.1f} ms under the profiler), device busy "
            f"{busy:.1f} ms = {100 * busy / (wall * 1e3):.1f}% of the wall "
            f"without the profiler; {count} device operations; "
            "top kernels (ms): "
            + "; ".join(f"{k[:40]} {v / 1e3:.2f}" for k, v in top))


def batch_systems(kind, seed, count, n_range, bucket):
    """(A, b, x) of `count` systems padded to `bucket`, stacked: the dense
    generator, the sparse SPD one at the CG path's conditions, or the
    paper's sparse set at its own (log10 kappa 8..10)."""
    from repro_torch.data.matrices import (generate_dense_set,
                                           generate_sparse_set, pad_system)
    rng = np.random.default_rng(seed)
    if kind == "dense":
        systems = generate_dense_set(count, rng, n_range=n_range)
    elif kind == "sparse":
        systems = generate_sparse_set(count, rng, n_range=n_range,
                                      lambda_s=0.01,
                                      log10_kappa_range=CG_KAPPA)
    else:
        systems = generate_sparse_set(count, rng, n_range=n_range)
    rows = [pad_system(s, bucket) for s in systems]
    return tuple(np.stack(f) for f in zip(*rows)), \
        sorted(s.n for s in systems)


def same_stats(a, b, k, carrier):
    """Row k of the batched stats `a` against the B = 1 stats `b`, every
    field bit for bit (float64 with every NaN read as one NaN)."""
    same = same_bits if carrier == "float32" else same_nan_bits
    for field, x, y in zip(a._fields, a, b):
        x, y = x[k:k + 1].reshape(()), y.reshape(())
        if not (same(x, y) if x.is_floating_point() else torch.equal(x, y)):
            return field
    return None


def device_busy(fn):
    """(device busy ms, device operations) of one run of fn under
    torch.profiler, recording the device's activity only and reading the
    profiler's raw records (a B = 1 loop makes a million of them); None
    when the session recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        raw = getattr(prof.profiler, "kineto_results", None)
        if raw is not None:
            evs = [e for e in raw.events()
                   if e.device_type() == DeviceType.CUDA]
            busy = sum(e.duration_ns() for e in evs) / 1e6
        else:
            evs = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
        if evs:
            return busy, len(evs)
        say("profiler: a session recorded no device activity")
    return None


def run_batched_program(dev):
    """Phase 12: the batched program on the card. Each case of
    `BATCH_CASES` runs as one batched call (`gmres_ir_batch` /
    `cg_ir_batch`) and as B = 1 calls one row after another (`gmres_ir`
    / `cg_ir`), the actions cycling through the reduced action space;
    every row must be bit-equal to its B = 1 solve. For both: the wall
    (CUDA-synchronised), the launches by kernel (counts set to 0 just
    before, read just after), then the device busy time and device
    operations of one more run under torch.profiler."""
    from repro_torch.core import reduced_action_space
    from repro_torch.kernels import library
    from repro_torch.solvers import (CGConfig, IRConfig, cg_ir, cg_ir_batch,
                                     gmres_ir, gmres_ir_batch)
    actions = reduced_action_space().actions
    t_phase = time.perf_counter()
    out = {}
    for name, solver, carrier, kind, seed, count, n_range, bucket in \
            BATCH_CASES:
        (A, b, x), ns = batch_systems(kind, seed, count, n_range, bucket)
        acts = np.stack([actions[k % len(actions)] for k in range(count)])
        if solver == "gmres":
            batch, single, cfg = gmres_ir_batch, gmres_ir, IRConfig(tau=1e-6)
        else:
            batch, single, cfg = cg_ir_batch, cg_ir, CGConfig(tau=1e-6)

        def run_batch():
            return batch(A, b, x, acts, cfg, device=dev,
                         carrier_dtype=carrier)

        def run_rows():
            return [single(A[k], b[k], x[k], acts[k], cfg, device=dev,
                           carrier_dtype=carrier) for k in range(count)]
        def run_first_rows():
            for k in range(BATCH_PROFILED_ROWS):
                single(A[k], b[k], x[k], acts[k], cfg, device=dev,
                       carrier_dtype=carrier)
        row = {}
        for how, fn, prof_fn, rows in (
                ("batched", run_batch, run_batch, count),
                ("B = 1", run_rows, run_first_rows, BATCH_PROFILED_ROWS)):
            library.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in library.LAUNCHES.items() if v}
            t0 = time.perf_counter()
            prof = device_busy(prof_fn)
            busy, ops = (None, None) if prof is None else prof
            row[how] = {"wall_s": wall, "busy_ms": busy,
                        "device_operations": ops, "profiled_rows": rows,
                        "profile_s": time.perf_counter() - t0,
                        "launches": launches, "result": res}
        stats, ones = row["batched"].pop("result"), row["B = 1"].pop("result")
        for k in range(count):
            field = same_stats(stats, ones[k], k, carrier)
            check(field is None, f"phase 12 {name}: row {k} field {field} "
                  "differs from its B = 1 solve")
        inner = stats[3].tolist()
        say(f"phase 12 {name}: {count} systems, n = {ns}, n_pad {bucket}, "
            f"{carrier}; status {stats.status.tolist()}, outer "
            f"{stats.n_outer.tolist()}, inner {inner}; every row bit-equal "
            "to its B = 1 solve")
        for how in ("batched", "B = 1"):
            r = row[how]
            n = r["profiled_rows"]
            prof = "device busy not measured (no device activity recorded)" \
                if r["busy_ms"] is None else (
                    f"device busy {r['busy_ms']:.1f} ms and "
                    f"{r['device_operations']} device operations over "
                    f"{n} rows ({r['busy_ms'] / n:.2f} ms and "
                    f"{r['device_operations'] / n:.0f} a solve; profile "
                    f"{r['profile_s']:.1f} s)")
            say(f"phase 12 {name}, {how}: wall {r['wall_s'] * 1e3:.1f} ms "
                f"({r['wall_s'] * 1e3 / count:.1f} ms a solve); {prof}; "
                f"launches {json.dumps(r['launches'])}")
        out[name] = row
    say(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return out


def run_qmatmul(dev):
    """Phase 7: the K-blocked chopped matmul, checked on both routes,
    driven at gemma2-9b's FFN width in five formats with the launch counts
    read around it, and timed."""
    import torch.nn.functional as F
    from repro_torch.kernels import library
    from repro_torch.kernels.qmatmul import qmatmul_op, qmatmul_ref_blocked
    from repro_torch.kernels.qmatmul.checks import SPECIAL_KINDS, \
        special_operands
    from repro_torch.kernels.qmatmul.ops import _gemm
    from repro_torch.precision import FORMAT_LIST, chop
    g = torch.Generator().manual_seed(3)
    err = 0.0
    share = {True: 0.0, False: 0.0}    # by chop_out
    n_checks = 0
    t0 = time.perf_counter()

    def hold(a, b, fid, bk, route, chop_out, what):
        """qmatmul_op (route None) or the launcher on `route`, against
        qmatmul_ref_blocked with K zero-padded to a multiple of bk."""
        nonlocal err, share, n_checks
        K = a.shape[1]
        bk_ = min(bk or 256, max(128, 1 << max(K - 1, 0).bit_length()))
        Kp = -(-K // bk_) * bk_
        if route is None:
            got = qmatmul_op(a, b, fid, chop_out=chop_out, bk=bk)
        else:
            got = _gemm("qmatmul", a, b, fid, bk_, chop_out, route)
        want = qmatmul_ref_blocked(F.pad(a.float(), (0, Kp - K)),
                                   F.pad(b.float(), (0, 0, 0, Kp - K)),
                                   fid, bk_, chop_out=chop_out)
        e, sh = held_gemm(got, want, a, b, fid, Kp, chop_out,
                          f"qmatmul {what} fid={fid} route={route} "
                          f"chop_out={chop_out} bk={bk}")
        err, n_checks = max(err, e), n_checks + 1
        share[chop_out] = max(share[chop_out], sh)

    shapes = ((200, 300, 130, None), (64, 512, 96, 128), (1, 1, 1, None),
              (63, 65, 129, None), (129, 300, 1, None), (300, 63, 65, None),
              (65, 129, 300, 100), (63, 300, 129, 96))
    ragged = [(f"{M}x{K}x{N}", torch.randn(M, K, generator=g) * 10.0 **
               torch.randint(-2, 3, (M, K), generator=g),
               torch.randn(K, N, generator=g), bk) for M, K, N, bk in shapes]
    for fid in range(len(FORMAT_LIST)):
        cases = ragged + [(kind, *special_operands(kind, fid, 65, 129, 63, g),
                           None) for kind in SPECIAL_KINDS]
        for what, a, b, bk in cases:
            for route in (None, "ffma"):
                for chop_out in (True, False):
                    hold(a.to(dev), b.to(dev), fid, bk, route, chop_out,
                         what)
    for what, a, b, bk in ragged[:2]:
        hold(a.to(dev, torch.bfloat16), b.to(dev, torch.bfloat16), 2, bk,
             None, True, what + " bf16 inputs")
    torch.cuda.synchronize()
    say(f"qmatmul checks ({n_checks}: 7 formats on the wrapper's route and "
        f"on FFMA, ragged, bk 96 and 100, subnormal, largest and infinite "
        f"operands, bf16 inputs) passed in {time.perf_counter() - t0:.1f} "
        f"s, max abs err {err}; largest share of the tolerance "
        f"{share[False]:.4f} without the output rounding (the summation "
        f"order alone), {share[True]:.4f} with it")

    M, K, N = QMATMUL_SHAPE
    gd = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(M, K, generator=gd, device=dev)
    w = torch.randn(K, N, generator=gd, device=dev) / K ** 0.5
    fids = [row[0] for row in QMATMUL_FORMATS]
    library.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = {fid: qmatmul_op(x, w, fid) for fid in fids}
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    launches = dict(library.LAUNCHES)
    routes = dict(library.ROUTE_LAUNCHES["qmatmul"])
    say(f"qmatmul path: x {tuple(x.shape)} . w {tuple(w.shape)}, bk 256, "
        f"formats {fids}: {drive_s:.3f} s; kernels {json.dumps(launches)}")
    check(launches["qmatmul"] > 0, "kernel qmatmul never launched")
    rows, extra = {}, {}
    nbytes, flops = (M * K + K * N + M * N) * 4, 2 * M * N * K
    for fid, name, ltype, tf32, rate in QMATMUL_FORMATS:
        got = outs.pop(fid)
        check(got.shape == (M, N) and bool(torch.isfinite(got).all()),
              f"qmatmul output fid={fid}")
        want = qmatmul_ref_blocked(x, w, fid, 256)
        e, sh = held_gemm(got, want, x, w, fid, K, True,
                          f"qmatmul full width {name}")
        del got, want
        err, share[True] = max(err, e), max(share[True], sh)
        xc, wc = chop(x, fid).to(ltype), chop(w, fid).to(ltype)

        def kern(fid=fid):
            return qmatmul_op(x, w, fid)

        def plain(fid=fid):
            return qmatmul_ref_blocked(x, w, fid, 256)

        def lib(xc=xc, wc=wc):
            return torch.matmul(xc, wc)
        ms = time_ms(kern, 5, warmup=1)
        dev_ms = device_ms(kern, 3)
        split = device_kernels(kern, 3)
        say(f"qmatmul {name} device kernels (ms per call): " + (
            "not measured" if split is None else "; ".join(
                f"{k[:48]} {v / 3e3:.4f}" for k, v in split[0].items())))
        plain_ms = time_ms(plain, 10, warmup=2)
        plain_dev_ms = device_ms(plain, 3)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            lib_ms = time_ms(lib, 10)
            lib_dev_ms = device_ms(lib, 3)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        b_ms, b_by = bound(nbytes, flops, rate)
        say(f"time qmatmul [({M}, {K}) x ({K}, {N}), bk 256, {name}]: "
            f"kernel {ms:.4f} ms per call, {fmt_ms(dev_ms)} on the device; "
            f"plain {plain_ms:.4f} ms per call, {fmt_ms(plain_dev_ms)} on "
            f"the device; torch.matmul on {ltype} operands"
            + (" (TF32 on)" if tf32 else "") + f" {lib_ms:.4f} ms per "
            f"call, {fmt_ms(lib_dev_ms)} on the device; bound {b_ms:.4f} ms "
            f"({b_by}: {flops:.3e} operations at {rate / 1e12:.0f} TFLOP/s, "
            f"{nbytes / 1e9:.3f} GB); max abs err {e}, {sh:.4f} of the "
            "tolerance")
        rows[name] = (ms, plain_ms, lib_ms, b_ms, b_by, dev_ms, lib_dev_ms,
                      plain_dev_ms)
        extra[name] = {"max_abs_err": e, "share_of_tolerance": sh,
                       "bound_tflops": rate / 1e12,
                       "library": f"torch.matmul on {ltype} operands"
                       + (", TF32 on" if tf32 else "")}
        if name == "e4m3":
            extra[name]["note"] = ("bound at the fp8 rate; the kernel feeds "
                                   "e4m3 to the tensor cores as bf16")
        del xc, wc
    del x, w
    torch.cuda.empty_cache()
    return (launches["qmatmul"], routes, err, max(share.values()), rows,
            extra)


def heads_first(x):
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def live_pairs(sq, sk, kind="attn", window=0, chunk=0, **_):
    """Unmasked (query, key) pairs of one head."""
    qp = torch.arange(sq, dtype=torch.int64)
    lo = torch.zeros_like(qp)
    if kind == "local":
        lo = (qp - window + 1).clamp(min=0)
    if kind == "chunked":
        lo = qp // chunk * chunk
    hi = torch.minimum(qp, torch.full_like(qp, sk - 1))
    return int((hi - lo + 1).clamp(min=0).sum())


def flash_plain(q, k, v, groups, case, ref=None, **kw):
    """flash_ref (or `ref`, with its keywords `kw`) over the model layout,
    one kv head at a time (a single head's float32 scores at S = 16384
    are 1 GiB)."""
    from repro_torch.kernels.flash_attention import flash_ref
    ref = ref or flash_ref
    qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
    out = torch.empty_like(qf)
    for h in range(kf.shape[0]):
        sl = slice(h * groups, (h + 1) * groups)
        out[sl] = ref(qf[sl], kf[h:h + 1], vf[h:h + 1], groups=groups,
                      **case, **kw)
    b, s, hq, d = q.shape
    return out.reshape(b, hq, s, d).permute(0, 2, 1, 3)


def flash_err(got, want, what, tol=None, ulps=2):
    """Max abs error and its largest share of the tolerance; fails outside
    it. float32: `tol` + `tol` |want| per element, the JAX tests'. bf16:
    `within_bf16_rows`, `ulps` bf16 ulps of the largest |want| in each
    output row (one query of one head): two against the plain version
    (both sides round a float32 result that agrees to ~1e-5 of the row,
    P rounded to bf16 included), one against `flash_tiled_ref`, which
    rounds the same P."""
    from repro_torch.kernels.flash_attention.checks import within_bf16_rows
    check(bool(torch.isfinite(got).all()), f"{what}: output not finite")
    if tol is None:
        ok, err, share = within_bf16_rows(got, want, ulps)
    else:
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        share = float((diff / (tol + tol * want.float().abs())).max())
        ok = share <= 1.0
    check(ok, f"{what} outside its tolerance: max abs err {err}, {share} "
          "of the tolerance")
    return err, share


def sdpa_call(q, k, v, case, masked=False):
    """One scaled_dot_product_attention call computing the same function,
    or None (no PyTorch call has the logit softcap). Causal: is_causal
    with enable_gqa. Chunked, S a multiple of the chunk: S / chunk
    independent causal attentions, so one is_causal call on the sequence
    folded into chunks; with `masked`, the same function as one call with
    a boolean mask over the whole sequence (kv repeated first: GQA with a
    mask may take the math path, which holds every head's scores)."""
    import torch.nn.functional as F
    if case.get("softcap"):
        return None
    if case["kind"] == "chunked" and not masked:
        b, s, _, d = q.shape
        c = case["chunk"]
        qh, kh, vh = (x.reshape(b * s // c, c, x.shape[2], d)
                      .permute(0, 2, 1, 3) for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    if case["kind"] == "attn":
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)
    groups = q.shape[2] // k.shape[2]
    kr = kh.repeat_interleave(groups, dim=1)
    vr = vh.repeat_interleave(groups, dim=1)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[:, None] >= pos[None, :]) & (
        pos[:, None] // case["chunk"] == pos[None, :] // case["chunk"])
    return lambda: F.scaled_dot_product_attention(qh, kr, vr, attn_mask=mask)


def check_flash_small(dev):
    """Phase 8, first part: small cases of every kind on both routes:
    float32 on SIMT within 2e-5; bf16 on wgmma and, forced, on SIMT within
    two bf16 ulps of each row of the plain version, and wgmma within one
    ulp of `flash_tiled_ref` at its key tile."""
    from repro_torch.kernels.flash_attention import WGMMA_BK, \
        flash_attention_op
    from repro_torch.kernels.flash_attention.checks import flash_tiled_ref
    g = torch.Generator(device=dev).manual_seed(4)
    t0 = time.perf_counter()
    err, share, n = 0.0, {"simt f32": 0.0, "wgmma": 0.0, "simt bf16": 0.0,
                          "wgmma vs tiled": 0.0}, 0
    for b, s, hq, hkv, d in ((1, 512, 4, 2, 64), (2, 256, 2, 1, 256),
                             (1, 384, 4, 4, 128), (1, 200, 10, 2, 128)):
        q = torch.randn(b, s, hq, d, generator=g, device=dev)
        k = torch.randn(b, s, hkv, d, generator=g, device=dev)
        v = torch.randn(b, s, hkv, d, generator=g, device=dev)
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        for case in (dict(kind="attn"), dict(kind="local", window=100),
                     dict(kind="chunked", chunk=128),
                     dict(kind="chunked", chunk=48),
                     dict(kind="attn", softcap=50.0)):
            what = f"flash small {(b, s, hq, hkv, d)} {case}"
            op = dict(case, bq=s, bk=s)   # S need not be a block multiple
            runs = (
                ("simt f32", flash_attention_op(q, k, v, **op),
                 flash_plain(q, k, v, hq // hkv, case), dict(tol=2e-5)),
                ("wgmma", flash_attention_op(qb, kb, vb, route="wgmma", **op),
                 flash_plain(qb, kb, vb, hq // hkv, case), {}),
                ("simt bf16", flash_attention_op(qb, kb, vb, route="simt",
                                                 **op),
                 flash_plain(qb, kb, vb, hq // hkv, case), {}))
            for route, got, want, kw in runs:
                e, sh = flash_err(got, want, f"{what} {route}", **kw)
                err, share[route] = max(err, e), max(share[route], sh)
                n += 1
            tiled = flash_plain(qb, kb, vb, hq // hkv, case, flash_tiled_ref,
                                bk=WGMMA_BK[d])
            e, sh = flash_err(runs[1][1], tiled, f"{what} wgmma vs tiled",
                              ulps=1)
            share["wgmma vs tiled"] = max(share["wgmma vs tiled"], sh)
    say(f"flash small checks ({n} calls: float32 on SIMT, bf16 on wgmma and "
        f"on SIMT) passed in {time.perf_counter() - t0:.1f} s, max abs err "
        f"{err}; largest share of the tolerance " + ", ".join(
            f"{k} {v:.3f}" for k, v in share.items()))
    return err


def run_flash(dev):
    """Phase 8: flash attention driven at the full width of the repo's
    configs in bf16 (the wgmma route) with the launch counts read around
    it, checked against the plain version and timed beside the SIMT
    route, the plain version and one SDPA call where one exists."""
    from repro_torch.kernels import library
    from repro_torch.kernels.flash_attention import ROUTES, \
        flash_attention_op
    from repro_torch.kernels.flash_attention.checks import within_bf16_rows
    g = torch.Generator(device=dev).manual_seed(5)
    inputs = []
    for name, b, s, hq, hkv, d, case in FLASH_CASES:
        if inputs and inputs[-1][0][1:] == (b, s, hq, hkv, d):
            inputs.append(((name, b, s, hq, hkv, d), inputs[-1][1], case))
            continue
        qkv = tuple(torch.randn(b, s, h, d, generator=g, device=dev,
                                dtype=torch.bfloat16) for h in (hq, hkv, hkv))
        inputs.append(((name, b, s, hq, hkv, d), qkv, case))
    library.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [flash_attention_op(*qkv, **case) for _, qkv, case in inputs]
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    launches = dict(library.LAUNCHES)
    route_launches = dict(library.ROUTE_LAUNCHES["flash_attention"])
    routes = [ROUTES[(torch.bfloat16, spec[5])] for spec, _, _ in inputs]
    say(f"flash path: {len(inputs)} full-width bf16 calls on routes "
        f"{routes}, {drive_s:.3f} s; kernels {json.dumps(launches)}")
    check(launches["flash_attention"] > 0,
          "kernel flash_attention never launched")
    check(all(r == "wgmma" for r in routes),
          "a full-width case is not on the wgmma route")

    err, rows, extra = 0.0, [], {}
    for ((name, b, s, hq, hkv, d), (q, k, v), case), got, route in zip(
            inputs, outs, routes):
        groups = hq // hkv
        want = flash_plain(q, k, v, groups, case)
        check(got.shape == q.shape and got.dtype == torch.bfloat16,
              f"flash {name} output")
        e, ratio = flash_err(got, want, f"flash {name} {route}")
        simt_out = flash_attention_op(q, k, v, route="simt", **case)
        simt_e, simt_ratio = flash_err(simt_out, want, f"flash {name} simt")
        err = max(err, e, simt_e)
        del simt_out

        def kern(q=q, k=k, v=v, case=case):
            return flash_attention_op(q, k, v, **case)

        def simt(q=q, k=k, v=v, case=case):
            return flash_attention_op(q, k, v, route="simt", **case)
        ms = time_ms(kern, 5, warmup=1)
        dev_ms = device_ms(kern, 3)
        simt_ms = time_ms(simt, 2, warmup=1)
        simt_dev_ms = device_ms(simt, 1)
        plain_ms = time_ms(lambda: flash_plain(q, k, v, groups, case), 2,
                           warmup=1)
        lib_ms = lib_dev_ms = None
        lib = sdpa_call(q, k, v, case)
        if lib is not None:
            lib_share = within_bf16_rows(   # reported, not checked
                lib().permute(0, 2, 1, 3).reshape(q.shape), want)[2]
            lib_ms = time_ms(lib, 5, warmup=1)
            lib_dev_ms = device_ms(lib, 3)
        if case["kind"] == "chunked":
            masked = sdpa_call(q, k, v, case, masked=True)
            say(f"time flash [{name}]: SDPA with a boolean mask over the "
                f"whole sequence {time_ms(masked, 2, warmup=1):.4f} ms per "
                f"call, {fmt_ms(device_ms(masked, 1))} on the device")
            del masked
        del want
        pairs = live_pairs(s, s, **case)
        flops = 4 * d * pairs * b * hq
        nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        f32_ms = bound(nbytes, flops)[0]
        tflops = flops / dev_ms / 1e9
        say(f"time flash [{name}: B {b}, S {s}, Hq {hq}, Hkv {hkv}, D {d}, "
            f"{case}, bf16, route {route}]: kernel {ms:.4f} ms per call, "
            f"{fmt_ms(dev_ms)} on the device, {tflops:.1f} TFLOP/s on live "
            f"pairs ({tflops / (BF16_FLOP_PER_S / 1e12):.3f} of the bf16 "
            f"peak); SIMT route {simt_ms:.4f} ms per call, "
            f"{fmt_ms(simt_dev_ms)} on the device; plain {plain_ms:.4f} ms; "
            f"sdpa " + ("none" if lib_ms is None else
                        f"{lib_ms:.4f} ms per call, {fmt_ms(lib_dev_ms)} on "
                        f"the device ({lib_share:.3f} of the row tolerance)")
            + f"; bound {b_ms:.4f} ms ({b_by}: {flops:.3e} operations on "
            f"{pairs} live pairs a head, {nbytes / 1e9:.3f} GB; float32 "
            f"rate {f32_ms:.4f} ms); max abs err {e}, {ratio:.3f} of the "
            f"row tolerance (SIMT {simt_ratio:.3f})")
        rows.append((ms, plain_ms, lib_ms, b_ms, b_by, dev_ms, lib_dev_ms))
        extra[name] = {"flash_route": route, "tflops": tflops,
                       "share_of_peak": tflops / (BF16_FLOP_PER_S / 1e12),
                       "share_of_tolerance": ratio, "simt_ms": simt_ms,
                       "simt_device_ms": simt_dev_ms,
                       "library": None if lib is None else
                       "scaled_dot_product_attention, is_causal"
                       + (" on the sequence folded into chunks"
                          if case["kind"] == "chunked" else "")}
        del lib
    # The float32 launchers' route at the kernels line's case: the SIMT
    # kernel on float32 operands beside SDPA on the same float32 operands
    # (TF32 off), the fair PyTorch call for that route.
    (name, b, s, hq, hkv, d), (q, k, v), case = inputs[FLASH_ROW]
    q, k, v = q.float(), k.float(), v.float()
    want = flash_plain(q, k, v, hq // hkv, case)
    got = flash_attention_op(q, k, v, **case)
    e32 = flash_err(got, want, f"flash {name} float32 simt", tol=2e-5)[0]
    lib = sdpa_call(q, k, v, case)
    lib_e = float((lib().permute(0, 2, 1, 3).reshape(q.shape)
                   - want).abs().max())
    del got, want

    def simt32():
        return flash_attention_op(q, k, v, **case)
    f32 = {"simt_f32_ms": time_ms(simt32, 2, warmup=1),
           "simt_f32_device_ms": device_ms(simt32, 1),
           "sdpa_f32_ms": time_ms(lib, 3, warmup=1),
           "sdpa_f32_device_ms": device_ms(lib, 2)}
    extra[name].update(f32)
    say(f"time flash [{name}, float32 operands]: SIMT kernel "
        f"{f32['simt_f32_ms']:.4f} ms per call, "
        f"{fmt_ms(f32['simt_f32_device_ms'])} on the device (max abs err "
        f"{e32:.3e}); sdpa on the float32 operands {f32['sdpa_f32_ms']:.4f} "
        f"ms per call, {fmt_ms(f32['sdpa_f32_device_ms'])} on the device "
        f"(max abs err {lib_e:.3e} against the plain version)")
    del inputs, outs, q, k, v, lib
    torch.cuda.empty_cache()
    return launches["flash_attention"], route_launches, err, rows, extra


def same_nan_bits(a, b):
    """Equal bit patterns, every NaN read as one NaN: the card's float64
    arithmetic keeps a NaN operand's payload (its float32 arithmetic
    returns one canonical NaN), so a float64 NaN's bits follow the order
    of the operands, which the reference does not fix."""
    from repro_torch.kernels.chop.checks import same_bits_any_nan
    return a.dtype == b.dtype and same_bits_any_nan(a, b)


def check_f64_kernels(dev):
    """Phase 10, kernels: each float64 kernel against its plain version on
    the card, on float64 operands. chop: the plain rounding over every
    float64 exponent field and each format's edges (carrier subnormals,
    NaN, infinities, signed zeros, e4m3/e5m2 saturation; fp64 the
    identity) on every route, and all eight forms x seven formats on the
    call sites' shapes with the special operands (`expr_cases`) on every
    route and into `a` itself; qmv at n_pad 128..512 on both routes;
    trisolve lower and upper at n 512 (block 128: "shfl" with its packed
    diagonal blocks, and "smem") and n 37 (block 16); all bit for bit,
    every NaN read as one NaN. qgemm at the trailing update (448, 64) x
    (64, 448) and with each format's edge operands, within the order
    tolerance with float64's unit roundoff (`checks.held`). Returns the
    max abs errors and qgemm's largest share of its tolerance."""
    from repro_torch.kernels.chop import (ARITY, BLOCK_MAX, FORMS,
                                          chop_expr_op, chop_expr_ref,
                                          chop_op, chop_ref)
    from repro_torch.kernels.chop.checks import expr_cases, to_keeping_layout
    from repro_torch.kernels.chop.ops import expr_layout, vector_ready
    from repro_torch.kernels.qmatmul import qgemm_op, qgemm_ref, qmv_op, \
        qmv_ref
    from repro_torch.kernels.qmatmul.checks import (SPECIAL_KINDS,
                                                    float64_patterns, held,
                                                    special_operands)
    from repro_torch.kernels.trisolve import trisolve_op, trisolve_ref
    from repro_torch.precision import FORMAT_LIST
    f64 = torch.float64
    err = {k: 0.0 for k in F64_KERNELS}
    calls = collections.Counter()
    t0 = time.perf_counter()

    def hold(name, got, want, what):
        check(same_nan_bits(got, want), f"{name} {what}")
        err[name] = max(err[name], abs_err(got, want))
        calls[name] += 1

    def routes(tensors, M, N):
        ptrs = [t.data_ptr() for t in tensors]
        aligned = vector_ready(ptrs, expr_layout(tensors)[3], M, N)
        return [None, "strided"] + (["block"] if M * N <= BLOCK_MAX
                                    else []) + (["vector"] if aligned
                                                else [])

    g = torch.Generator().manual_seed(40)
    for fid in range(len(FORMAT_LIST)):
        pats = float64_patterns(fid).to(dev)
        for x in (pats, pats[1:], pats[:BLOCK_MAX],
                  pats[:128 * 128].reshape(128, 128)):
            M, N = (1, x.numel()) if x.dim() == 1 else tuple(x.shape)
            want = chop_ref(x, fid)
            for route in routes([x], M, N):
                hold("chop_f64", chop_op(x, fid, route=route), want,
                     f"x {tuple(x.shape)} fid={fid} route={route}")
        for name, *ops in expr_cases(fid, 50 + fid, dtype=f64,
                                     sizes=(40, 4099)):
            ops = [to_keeping_layout(t, dev) for t in ops]
            for form in FORMS:
                mine = ops[:ARITY[form]]
                want = chop_expr_ref(form, *mine, fmt_id=fid)
                shape, M, N, _ = expr_layout(mine)
                what = f"{form} {name} fid={fid}"
                for route in routes(mine, M, N):
                    hold("chop_f64", chop_expr_op(form, *mine, fmt_id=fid,
                                                  route=route), want,
                         f"{what} route={route}")
                if mine[0].shape == shape:
                    out = mine[0].clone()
                    chop_expr_op(form, out, *mine[1:], fmt_id=fid, out=out)
                    hold("chop_f64", out, want, f"{what} out a itself")
        for n in N_PADS:
            A = (torch.randn(n, n, generator=g, dtype=f64) * 10.0 **
                 torch.randint(-3, 4, (n, n), generator=g)).to(dev)
            v = torch.randn(n, generator=g, dtype=f64).to(dev)
            for chop_out in (True, False):
                want = qmv_ref(A, v, fid, chop_out=chop_out)
                for route in QMV_ROUTES:
                    hold("qmv_f64", qmv_op(A, v, fid, chop_out=chop_out,
                                           route=route), want,
                         f"n={n} fid={fid} route={route}")
        for n, block in ((512, 128), (37, 16)):
            Lu = factor_like(n, dev, 60 + n).double()
            b = torch.randn(n, generator=g, dtype=f64).to(dev)
            for lower in (True, False):
                want = trisolve_ref(Lu, b, fid, lower=lower, block=block)
                for route in ("shfl", "smem"):
                    hold("trisolve_f64",
                         trisolve_op(Lu, b, fid, lower=lower, block=block,
                                     route=route), want,
                         f"n={n} block={block} lower={lower} fid={fid} "
                         f"route={route}")
    torch.cuda.synchronize()
    share = 0.0
    for fid in range(len(FORMAT_LIST)):
        cases = [("trailing update", torch.randn(448, 64, generator=g,
                                                 dtype=f64),
                  torch.randn(64, 448, generator=g, dtype=f64))]
        cases += [(kind, *(t.double() for t in special_operands(
            kind, fid, 448, 64, 448, g))) for kind in SPECIAL_KINDS]
        for what, a, b in cases:
            a, b = a.to(dev), b.to(dev)
            got, want = qgemm_op(a, b, fid), qgemm_ref(a, b, fid)
            ok, e, sh = held(got, want, a, b, fid, 128, True)
            check(ok and got.dtype == f64,
                  f"qgemm_f64 {what} fid={fid} outside the order tolerance")
            err["qgemm_f64"] = max(err["qgemm_f64"], e)
            share = max(share, sh)
            calls["qgemm_f64"] += 1
    torch.cuda.synchronize()
    say(f"float64 kernel checks ({json.dumps(dict(calls))} calls) passed in "
        f"{time.perf_counter() - t0:.1f} s, max abs err {err}; qgemm_f64 "
        f"{share:.4f} of its tolerance")
    return err, share


def run_f64_path(dev):
    """Phase 10, the main path on the float64 carrier: GMRES-IR's bandit
    loop (`train_policy`) on phase 4's dense data at a reduced depth and
    its all-fp64 baseline (`evaluate_fixed_action`), then CG-IR's all-fp64
    baseline on the paper's sparse set at its own kappa (1e8..1e10),
    both tasks built with `carrier_dtype="float64"`. Every count is set
    to 0 just before and read just after: each float64 kernel must
    launch, and no float32 solver kernel (no path changes the carrier).
    Every sparse system must converge under the all-fp64 action, as the
    JAX package's x64 solve does on the CPU (held in
    tests/test_torch_f64_carrier.py)."""
    from repro_torch.core import (AutotuneEngine, TrainConfig, W1,
                                  evaluate_fixed_action,
                                  reduced_action_space, train_policy)
    from repro_torch.data.matrices import (generate_dense_set,
                                           generate_sparse_set)
    from repro_torch.kernels import library
    from repro_torch.solvers import CGConfig, IRConfig
    from repro_torch.tasks import CGIRTask, GMRESIRTask
    systems = generate_dense_set(N_SYSTEMS, np.random.default_rng(SEED),
                                 n_range=(100, 500))
    seed, count, n_range = F64_CG
    cg_systems = generate_sparse_set(count, np.random.default_rng(seed),
                                     n_range=n_range)
    engine = AutotuneEngine(GMRESIRTask(
        systems, reduced_action_space(), IRConfig(tau=1e-6), device=dev,
        carrier_dtype="float64"), chunk=8)
    cg_engine = AutotuneEngine(CGIRTask(
        cg_systems, reduced_action_space(), CGConfig(tau=1e-6), device=dev,
        carrier_dtype="float64"), chunk=8)
    a = engine.action_space.n_actions - 1
    fmts = engine.action_space.actions[a].tolist()
    check(fmts == [6, 6, 6, 6], f"the last action is {fmts}, not all fp64")
    say(f"float64 path: GMRES-IR on phase 4's {len(systems)} dense systems;"
        f" CG-IR on {count} sparse SPD systems, n = "
        f"{sorted(s.n for s in cg_systems)}, kappa_est = "
        f"{[float(f'{k:.3g}') for k in sorted(cg_engine.kappas)]}")
    library.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = train_policy(engine, W1, TrainConfig(
        episodes=F64_EPISODES, n_bins=(4, 4), seed=0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    base = evaluate_fixed_action(engine, a, 1e-6)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cg_base = evaluate_fixed_action(cg_engine, a, 1e-6)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(library.LAUNCHES)
    routes = {k: dict(v) for k, v in library.ROUTE_LAUNCHES.items()}
    say(f"float64 train_policy: {F64_EPISODES} episodes, {hist.n_solves} "
        f"solves, {t1 - t0:.1f} s; episode reward "
        f"{[round(r, 3) for r in hist.episode_reward]}")
    walls = {"gmres_train_s": t1 - t0, "gmres_baseline_s": t2 - t1,
             "cg_baseline_s": t3 - t2}
    out = {}
    for what, eng, ev in (("GMRES-IR", engine, base), ("CG-IR", cg_engine,
                                                       cg_base)):
        rows = []
        for i in range(len(eng.instances)):
            o = eng.outcome(i, a)
            rows.append((eng.instances[i].n, float(f"{eng.kappas[i]:.3g}"),
                         o.status, o.metrics["ferr"], o.metrics["n_outer"]))
        statuses = collections.Counter(r[2] for r in rows)
        say(f"float64 {what} all-fp64 baseline (n, kappa_est, status, ferr, "
            f"n_outer): {rows}; status counts {json.dumps(dict(statuses))}"
            f" (0 converged, 1 stagnated, 2 max-iter, 3 failed); table "
            f"{json.dumps(ev['table'])}")
        check(all(r[2] != 3 and np.isfinite(r[3]) for r in rows),
              f"float64 {what} baseline: a solve failed")
        out[what] = rows
    check(all(r[2] == 0 and r[3] < 1e-6 for r in out["CG-IR"]),
          "float64 CG-IR: the paper's sparse set did not converge under the "
          "all-fp64 action")
    say(f"float64 walls (s): {json.dumps(walls)}")
    say("float64 kernels", json.dumps(launches))
    say("float64 routes", json.dumps({k: routes[k] for k in F64_KERNELS}))
    for name in F64_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched")
    for name in SOLVER_KERNELS:
        check(launches[name] == 0, f"the float64 path launched {name} "
              f"(float32) {launches[name]} times")
    return {"launches": launches, "routes": routes, "systems": systems,
            "cg_systems": cg_systems, "walls": walls, "baseline": out}


def check_f64_against_cpu(systems, cg_systems, dev):
    """Phase 10, card vs CPU on the float64 carrier (the CPU's plain
    versions on float64): phase 4c's two strict systems at the paper's
    kappa under the all-fp64 action, CG-IR, and one strict GMRES-IR
    solve (n_pad 128), bit for bit in every field; one blocked CG-IR
    solve (the sparse set's smallest, n_pad 256), with status, n_outer
    and n_cg equal (the blocked LU's carrier dots are not pinned)."""
    from repro_torch.core.batching import pad_to_bucket
    from repro_torch.data.matrices import generate_sparse_set
    from repro_torch.solvers import CGConfig, IRConfig, cg_ir, gmres_ir
    paper = generate_sparse_set(2, np.random.default_rng(CG_SEED + 1),
                                n_range=(100, 128))
    cases = [(cg_ir, CGConfig(tau=1e-6), s, "paper kappa") for s in paper]
    cases += [(gmres_ir, IRConfig(tau=1e-6), min(systems, key=lambda s: s.n),
               "strict"),
              (cg_ir, CGConfig(tau=1e-6), min(cg_systems, key=lambda s: s.n),
               "blocked")]
    for fn, cfg, sys_, what in cases:
        A, b, x = pad_to_bucket(sys_)
        t0 = time.perf_counter()
        gpu = fn(A, b, x, [6, 6, 6, 6], cfg, device=dev,
                 carrier_dtype="float64")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = fn(A, b, x, [6, 6, 6, 6], cfg, device="cpu",
                 carrier_dtype="float64")
        t2 = time.perf_counter()
        say(f"float64 {fn.__name__} {what} n={sys_.n} n_pad={A.shape[0]} "
            f"kappa_est={sys_.kappa:.3g}: card {[float(v) for v in gpu]} "
            f"({t1 - t0:.2f} s), cpu {[float(v) for v in cpu]} "
            f"({t2 - t1:.2f} s)")
        check(gpu[0].dtype == torch.float64, f"float64 {what}: ferr dtype")
        for f in gpu._fields[2:5]:
            check(int(getattr(gpu, f)) == int(getattr(cpu, f)),
                  f"float64 {fn.__name__} {what}: {f} card vs cpu")
        if A.shape[0] < 256:
            for f, g_, c_ in zip(gpu._fields, gpu, cpu):
                check(torch.equal(g_.cpu(), c_),
                      f"float64 {fn.__name__} {what}: {f} card vs cpu")


def time_f64_kernels(dev):
    """Phase 10, timing: each float64 kernel at the main path's shapes
    (format bf16, as phase 5): chop at (512, 512) and (512,), qmv at
    (512, 512), qgemm at the trailing update (448, 64) x (64, 448),
    trisolve lower and upper at n 512, block 128; per call and on the
    device, beside the plain version, the float64 library call (torch.mv,
    torch.matmul, torch.linalg.solve_triangular on the chopped operands)
    and the bound: bytes at 8 a value over 3.35 TB/s or operations over
    float64's 67 TFLOP/s, the larger; trisolve also beside its chain
    bound on float64 (`scripts/chain_bound.py --dtype float64`)."""
    from repro_torch.kernels.chop import chop_op, chop_ref
    from repro_torch.kernels.qmatmul import qgemm_op, qgemm_ref, qmv_op, \
        qmv_ref
    from repro_torch.kernels.trisolve import trisolve_op, trisolve_ref
    from repro_torch.precision import chop
    fid, n, m, f64 = 2, 512, 448, torch.float64
    g = torch.Generator().manual_seed(41)
    A = torch.randn(n, n, generator=g, dtype=f64).to(dev)
    v = torch.randn(n, generator=g, dtype=f64).to(dev)
    a = torch.randn(m, 64, generator=g, dtype=f64).to(dev)
    b = torch.randn(64, m, generator=g, dtype=f64).to(dev)
    Lu = factor_like(n, dev, 7).double()
    Ac, vc, ac, bc, Lc = (chop(t, fid) for t in (A, v, a, b, Lu))
    rows = {
        "chop_f64": (lambda: chop_op(A, fid), lambda: chop_ref(A, fid), None,
                     2 * n * n * 8, 0, f"x ({n}, {n})"),
        "chop_f64 (512,)": (lambda: chop_op(v, fid), lambda: chop_ref(v, fid),
                            None, 2 * n * 8, 0, f"x ({n},)"),
        "qmv_f64": (lambda: qmv_op(A, v, fid), lambda: qmv_ref(A, v, fid),
                    lambda: torch.mv(Ac, vc), (n * n + 2 * n) * 8,
                    2 * n * n, f"A ({n}, {n}) x v ({n},)"),
        "qgemm_f64": (lambda: qgemm_op(a, b, fid),
                      lambda: qgemm_ref(a, b, fid),
                      lambda: torch.matmul(ac, bc),
                      (2 * m * 64 + m * m) * 8, 2 * m * m * 64,
                      f"({m}, 64) x (64, {m})")}
    vcol = vc[:, None]
    for lower in (True, False):
        tri = n * (n - 1) // 2 if lower else n * (n + 1) // 2
        rows["trisolve_f64" if lower else "trisolve_f64 upper"] = (
            lambda lower=lower: trisolve_op(Lu, v, fid, lower=lower),
            lambda lower=lower: trisolve_ref(Lu, v, fid, lower=lower),
            lambda lower=lower: torch.linalg.solve_triangular(
                Lc, vcol, upper=not lower, unitriangular=lower),
            (tri + 2 * n) * 8, 2 * tri,
            f"Lu ({n}, {n}), {'lower' if lower else 'upper'}, block 128")
    chain = chain_bound(n, 128, torch.float64)
    out = {}
    for name, (kern, plain, lib, nbytes, flops, shape) in rows.items():
        ms = time_ms(kern, 200, rounds=5)
        plain_ms = time_ms(plain, 3 if name.startswith("trisolve") else 50,
                           warmup=1)
        lib_ms = time_ms(lib, 200, rounds=5) if lib is not None else None
        dev_ms = device_ms(kern, 50)
        lib_dev_ms = device_ms(lib, 50) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops, F64_FLOP_PER_S)
        out[name] = (ms, plain_ms, lib_ms, b_ms, b_by, dev_ms, lib_dev_ms)
        chain_ms = chain["upper" if name.endswith("upper") else "lower"]
        say(f"time {name} [{shape}, bf16, float64]: kernel {ms:.4f} ms per "
            f"call, {fmt_ms(dev_ms)} on the device; plain {plain_ms:.4f} ms;"
            " library " + ("-" if lib_ms is None else
                           f"{lib_ms:.4f} ms per call, {fmt_ms(lib_dev_ms)} "
                           "on the device")
            + f"; bound {b_ms:.3g} ms ({b_by}; operations at "
            f"{F64_FLOP_PER_S / 1e12:.0f} TFLOP/s)"
            + (f"; chain bound {chain_ms:.4f} ms"
               if name.startswith("trisolve") else ""))
    say("trisolve_f64 chain bound: " + chain["text"])
    return out, chain


# ---------------------------------------------------------------------------
# chop_sr: stochastic rounding (no TPU counterpart)
# ---------------------------------------------------------------------------

def check_chop_sr(dev):
    """Phase 3, chop_sr: the kernel bit for bit against its plain version
    `chop_sr_ref` (run on the CPU on the same inputs and words), for
    every format id, at SR_SHAPES (standard normal values times 10^k, k
    in -3..3) and on `kernels.chop.checks.sr_patterns` (every float32
    exponent field, each format's edges, specials, subnormals and deep
    underflow), each with words drawn on the card and with the words 0
    and 2^32 - 1. Then the JAX package's unbiasedness test on the card
    through `chop_stochastic`, with the counts set to 0 just before and
    read just after: the mean of SR_DRAWS draws at bf16 has a bias under
    0.35 x the RNE chop's error. Returns the max abs error, the launches
    and routes of that run, and the two errors."""
    from repro_torch.kernels import library
    from repro_torch.kernels.chop import chop_op, chop_sr_op, chop_sr_ref
    from repro_torch.kernels.chop.checks import sr_patterns
    from repro_torch.precision import (FORMAT_LIST, chop_stochastic,
                                       stochastic_bits)
    gen = torch.Generator(device=dev).manual_seed(11)
    g = torch.Generator().manual_seed(12)
    err, cases = 0.0, 0
    pats = sr_patterns().to(dev)
    for fid in range(len(FORMAT_LIST)):
        xs = [(torch.randn(s, generator=g) * 10.0 ** torch.randint(
            -3, 4, s, generator=g)).to(dev) for s in SR_SHAPES] + [pats]
        for x in xs:
            for w in (stochastic_bits(x, gen),
                      torch.zeros_like(x, dtype=torch.int32),
                      torch.full_like(x, -1, dtype=torch.int32)):
                got = chop_sr_op(x, fid, w)
                want = chop_sr_ref(x.cpu(), fid, w.cpu())
                check(same_bits(got.cpu(), want),
                      f"chop_sr fid={fid} shape={tuple(x.shape)}")
                err = max(err, abs_err(got.cpu(), want))
                cases += 1
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(8000).astype(np.float32)).to(dev)
    fid = 2
    gen.manual_seed(0)
    words = [stochastic_bits(x, gen) for _ in range(SR_DRAWS)]
    torch.cuda.synchronize()
    library.reset_launches()
    draws = [chop_stochastic(x, fid, w) for w in words]
    torch.cuda.synchronize()
    launches = dict(library.LAUNCHES)
    routes = {k: dict(v) for k, v in library.ROUTE_LAUNCHES.items()}
    mean = torch.stack(draws).double().mean(0)
    bias = float((mean - x.double()).abs().mean())
    rne = float((chop_op(x, fid) - x).abs().double().mean())
    say(f"chop_sr checks: {cases} calls bit for bit against chop_sr_ref "
        f"(7 formats; shapes {list(SR_SHAPES)} and {pats.numel()} edge "
        f"patterns; drawn words, all 0, all 1), max abs err {err}; "
        f"unbiasedness at bf16 over {SR_DRAWS} draws of 8000 values: mean "
        f"|E[sr(x)] - x| {bias:.4g} vs the RNE chop's mean error {rne:.4g} "
        f"({bias / rne:.4f} of it, bound 0.35); launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    check(bias < 0.35 * rne, f"chop_sr bias {bias} not under 0.35 x {rne}")
    check(launches["chop_sr"] == SR_DRAWS
          and sum(launches.values()) == SR_DRAWS,
          f"chop_stochastic's run launched {launches}")
    for y in draws[:4]:
        check(same_bits(chop_op(y, fid), y), "chop_sr: a draw is not "
              "representable in bf16")
    return err, launches["chop_sr"], routes["chop_sr"], bias, rne


def time_chop_sr(dev):
    """Phase 5, chop_sr: per call (CUDA events) and on the device
    (torch.profiler) at SR_SHAPES' last shape, (512,) and 0-dim, beside
    its plain version and the RNE chop kernel at the same shape; bound
    SR_BYTES bytes an element over the memory rate (no PyTorch call
    computes a stochastic rounding: library none)."""
    from repro_torch.kernels.chop import chop_op, chop_sr_op, chop_sr_ref
    from repro_torch.precision import stochastic_bits
    gen = torch.Generator(device=dev).manual_seed(5)
    fid = 2
    out, rne = {}, {}
    for shape in (SR_SHAPES[-1], (512,), ()):
        x = torch.randn(shape, device=dev)
        w = stochastic_bits(x, gen)
        n = x.numel()
        ms = time_ms(lambda: chop_sr_op(x, fid, w), 200, rounds=5)
        dev_ms = device_ms(lambda: chop_sr_op(x, fid, w), 50)
        plain_ms = time_ms(lambda: chop_sr_ref(x, fid, w), 20, warmup=1)
        b_ms, b_by = bound(SR_BYTES * n, 0)
        rne_ms = time_ms(lambda: chop_op(x, fid), 200, rounds=5)
        rne_dev = device_ms(lambda: chop_op(x, fid), 50)
        label = str(tuple(shape)) if shape else "0-dim"
        out[label] = (ms, plain_ms, None, b_ms, b_by, dev_ms, None, None)
        rne[label] = {"rne_chop_ms": rne_ms, "rne_chop_device_ms": rne_dev}
        say(f"time chop_sr [x {label}, bf16]: kernel {ms:.4f} ms per call, "
            f"{fmt_ms(dev_ms)} on the device; plain {plain_ms:.4f} ms; "
            f"library none; RNE chop kernel at the same shape {rne_ms:.4f} "
            f"ms per call, {fmt_ms(rne_dev)} on the device; bound "
            f"{b_ms:.3g} ms ({b_by}: {SR_BYTES} bytes an element)")
    return out, rne


# ---------------------------------------------------------------------------
# Phase 11: the HTTP front door over a ShadowServer, float64 carrier
# ---------------------------------------------------------------------------

HTTP_CODES = collections.Counter()     # phase 11's answers, by status code


def http_call(method, url, body=None, codes=None):
    """One HTTP exchange on 127.0.0.1: (code, JSON body), the code counted
    in `codes` (HTTP_CODES by default)."""
    import urllib.error
    import urllib.request
    codes = HTTP_CODES if codes is None else codes
    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            codes[r.status] += 1
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        codes[e.code] += 1
        try:
            return e.code, json.loads(e.read().decode() or "{}")
        finally:
            e.close()


def wire_solve(url, body, sync, codes=None):
    """One request over the wire, sync (`/v1/solve:sync`) or fire and
    poll (`/v1/solve`, then `/v1/result/<id>` every HTTP_POLL_S, and once
    more after the result, which must answer 404): (result, wire
    seconds). Any other code than 200 (202 while pending) fails."""
    t0 = time.perf_counter()
    if sync:
        code, res = http_call("POST", url + "/v1/solve:sync", body, codes)
        check(code == 200 and res.get("status") == "done",
              f"sync solve: HTTP {code} {str(res)[:300]}")
        return res, time.perf_counter() - t0
    code, acc = http_call("POST", url + "/v1/solve", body, codes)
    check(code == 202 and acc.get("status") == "queued",
          f"fire-and-poll: HTTP {code} {str(acc)[:300]}")
    rid = acc["request_id"]
    deadline = time.monotonic() + 5 * HTTP_TIMEOUT_S
    while time.monotonic() < deadline:
        code, res = http_call("GET", f"{url}/v1/result/{rid}", None, codes)
        if code == 200:
            check(res.get("status") == "done",
                  f"result {rid}: {str(res)[:300]}")
            wall = time.perf_counter() - t0
            code, _ = http_call("GET", f"{url}/v1/result/{rid}", None, codes)
            check(code == 404, f"result {rid} retrievable twice ({code})")
            return res, wall
        check(code == 202, f"result {rid}: HTTP {code} {str(res)[:300]}")
        time.sleep(HTTP_POLL_S)
    raise Failed(f"request {rid} never completed")


def burst_threads(url, bodies):
    """Concurrent clients, as the JAX package's front-door burst test
    (tests/test_http_front_door.py:230) sends them: one thread a body,
    all started together, each calling in one of the README's two ways
    ("Serving over HTTP"), sync for odd k and fire-and-poll for even k
    (`wire_solve`). Returns (rows, codes, seconds): rows[k] is (result,
    wire seconds, None) or (None, None, error), codes the HTTP codes
    counted, seconds the burst's wall from the threads' start to the
    last answer."""
    import threading
    rows, codes = [None] * len(bodies), []

    def client(k):
        mine = collections.Counter()
        codes.append(mine)
        try:
            res, sec = wire_solve(url, bodies[k], sync=k % 2 == 1,
                                  codes=mine)
            rows[k] = (res, sec, None)
        except Exception as e:
            rows[k] = (None, None, f"{type(e).__name__}: {e}"[:300])

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return rows, sum(codes, collections.Counter()), time.perf_counter() - t0


def _burst_child(url, bodies, conn):
    """The client process of `wire_burst`: ready, wait for the go, send
    back what `burst_threads` returns."""
    conn.send("ready")
    conn.recv()
    conn.send(burst_threads(url, bodies))
    conn.close()


def wire_burst(url, bodies, in_process=False):
    """`burst_threads` run in a client process of its own (spawned, so
    its clients share no interpreter lock with the front door's event
    loop and worker, as real clients do not), or, with `in_process`, in
    this process. The same (rows, codes, seconds); the process is
    stopped whatever happens."""
    if in_process:
        return burst_threads(url, bodies)
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    here, there = ctx.Pipe()
    proc = ctx.Process(target=_burst_child, args=(url, bodies, there),
                       daemon=True)
    proc.start()
    try:
        there.close()
        check(here.poll(120) and here.recv() == "ready",
              "burst: the client process did not start")
        here.send("go")
        check(here.poll(10 * HTTP_TIMEOUT_S),
              "burst: the client process did not answer")
        return here.recv()
    finally:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join()


def sys_body(system):
    return json.dumps({"A": system.A.tolist(), "b": system.b.tolist(),
                       "x_true": system.x_true.tolist()}).encode()


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def run_http_rollout(dev, policy):
    """Phase 11: the production serving path at full width. A
    `PolicyRegistry` warm-started from phase 4's policy; a `ShadowServer`
    on `GMRESIRTask(carrier_dtype="float64")` on the card (bucket_step
    128, `BatcherConfig(max_batch=4)`, its primary with a trajectory log);
    `serve_http` on 127.0.0.1 with `HttpConfig(max_n=512)`; requests from
    the paper's dense generator (n in [100, 500], HTTP_SEED), sent one at
    a time, fire-and-poll and sync in turns. Stage A: HTTP_A requests,
    primary only; the front door closed, and the primary's state rebuilt
    by `recover_server` from the registry and the trajectory log alone,
    the tail verified through `eval.replay` on the card: Q/N, epsilon and
    the WAL sequence bit-equal to the live ones. Then a new front door:
    a degraded candidate (Q pinned to the all-bf16 arm) staged, which
    must roll back; a healthy copy, which must promote; a burst of
    HTTP_BURST concurrent clients, half sync and half fire-and-poll, in
    a client process of their own (`wire_burst`), for the promoted
    policy.
    The primary slice's responses over HTTP (stage A and the rollouts'
    primary slice) bit-identical to an in-process `AutotuneServer` on
    the card fed the same requests in the same order; the OPE gate on
    the primary's logged stream, through a second `ShadowServer` with
    `ope_gate=True`, scoring the degraded candidate against the
    incumbent. The launches of the serving stages (counts set to 0 just
    before each, summed) must include every float64 solver kernel and no
    float32 one; any failed response, front-door error, flush restart
    or launch error fails the phase."""
    import shutil
    import tempfile
    from repro_torch.core import W1
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.obs import MetricsRegistry, Observability, TrajectoryLog
    from repro_torch.obs.metrics import default_registry
    from repro_torch.service import (AutotuneServer, BatcherConfig,
                                     OPEGateRejected, PolicyRegistry,
                                     RolloutConfig, ShadowServer,
                                     recover_server)
    from repro_torch.service.http import HttpConfig, serve_http
    from repro_torch.solvers import IRConfig
    from repro_torch.tasks import GMRESIRTask
    cfg = IRConfig(tau=1e-6)
    bcfg = BatcherConfig(max_batch=SERVE_MAX_BATCH, bucket_step=128,
                         min_bucket=128)
    hcfg = HttpConfig(max_n=512, flush_interval_s=0.002)

    def task():
        return GMRESIRTask(ir_cfg=cfg, device=dev, carrier_dtype="float64",
                           bucket_step=128, min_bucket=128)

    seed, count = HTTP_SEED
    reqs = generate_dense_set(count, np.random.default_rng(seed),
                              n_range=HTTP_N)
    bodies = {}

    def body(i):
        if i not in bodies:
            bodies[i] = sys_body(reqs[i])
        return bodies[i]

    launches = collections.Counter()
    wire, log_rows, sent = [], [], []   # per request: seconds, (stage, ...)
    serving_s = 0.0

    def serve_stage(url, stage, shadow, until=None, start=0):
        """Send requests from `start` one at a time until `until(shadow)`
        or the stream ends; returns the next index."""
        nonlocal serving_s
        library.reset_launches()
        t0 = time.perf_counter()
        i = start
        while i < len(reqs):
            res, sec = wire_solve(url, body(i), sync=i % 2 == 1)
            wire.append(sec)
            sent.append((stage, i, res))
            i += 1
            if until is not None and until(shadow):
                break
        torch.cuda.synchronize()
        serving_s += time.perf_counter() - t0
        launches.update(library.LAUNCHES)
        return i

    with tempfile.TemporaryDirectory() as root:
        reg = PolicyRegistry(os.path.join(root, "reg"))
        v1 = reg.publish(policy, note="phase 4's policy")
        reg.promote(v1)
        shutil.copytree(os.path.join(root, "reg"),
                        os.path.join(root, "inproc"))
        log = os.path.join(root, "traj.jsonl")
        trail = os.path.join(root, "decisions.jsonl")
        obs = Observability(registry=MetricsRegistry(), trajectory_path=log)
        shadow = ShadowServer(
            reg, task(), W1, bcfg, rollout_cfg=RolloutConfig(**HTTP_ROLLOUT),
            seed=0, obs=obs, decision_log_path=trail)
        t_phase = time.perf_counter()
        HTTP_CODES.clear()
        errors0 = default_registry().errors
        original = shadow.primary
        fd = serve_http(shadow, cfg=hcfg)
        try:
            check(fd.host == "127.0.0.1", f"front door on {fd.host}")
            nxt = serve_stage(fd.url, "A", shadow, start=0,
                              until=lambda s: len(sent) >= HTTP_A)
        finally:
            fd.close()
        check(fd.flush_restarts == 0, "stage A: the flush loop restarted")
        # Stage A's primary, rebuilt from the registry and the log alone.
        t0 = time.perf_counter()
        library.reset_launches()
        live = shadow.primary
        ids = {res["request_id"]: reqs[i] for _, i, res in sent}
        rec = recover_server(reg, log, verify_with=ids, task=task(),
                             reward_cfg=W1, batcher_cfg=bcfg, obs=False)
        torch.cuda.synchronize()
        rec_launches = {k: v for k, v in library.LAUNCHES.items() if v}
        report = rec.last_recovery
        check(np.array_equal(rec.live.qtable.Q, live.live.qtable.Q)
              and np.array_equal(rec.live.qtable.N, live.live.qtable.N),
              "recovered Q/N tables differ from the live ones")
        check(rec.learner.epsilon._level == live.learner.epsilon._level
              and rec.learner.epsilon._t == live.learner.epsilon._t
              and rec.update_seq == live.update_seq,
              "recovered epsilon or WAL sequence differs")
        check(report["replayed"] + report["skipped_quarantined"] == HTTP_A
              and report["version"] == v1, f"recovery report {report}")
        say(f"phase 11 recovery: {json.dumps(report)}; tail of {HTTP_A} "
            f"re-solved on the card by eval.replay, bit-identical; Q/N, "
            f"epsilon, update_seq {rec.update_seq} equal to the live "
            f"primary's; {time.perf_counter() - t0:.1f} s, launches "
            f"{json.dumps(rec_launches)}")

        fd = serve_http(shadow, cfg=hcfg)
        try:
            vbad = reg.publish(pinned_bf16(reg.load()),
                               note="degraded: pinned to all-bf16")
            shadow.start_rollout(vbad)
            nxt = serve_stage(fd.url, "B", shadow, start=nxt,
                              until=lambda s: s.phase != "canary")
            say(f"phase 11 stage B: {sum(1 for s in sent if s[0] == 'B')} "
                f"requests, phase {shadow.phase}, decisions "
                f"{decision_list(shadow)}")
            check(shadow.phase == "rolled_back",
                  f"degraded candidate: phase {shadow.phase}")
            check(reg.current_version() == v1,
                  f"after the rollback CURRENT is {reg.current_version()}")
            vgood = reg.publish(reg.load(), note="healthy: copy of v1")
            shadow.start_rollout(vgood)
            nxt = serve_stage(fd.url, "C", shadow, start=nxt,
                              until=lambda s: s.phase != "canary")
            say(f"phase 11 stage C: {sum(1 for s in sent if s[0] == 'C')} "
                f"requests, phase {shadow.phase}, decisions "
                f"{decision_list(shadow)}")
            check(shadow.phase == "promoted",
                  f"healthy candidate: phase {shadow.phase}")
            check(reg.current_version() == vgood
                  and shadow.policy_version == vgood,
                  f"after the promotion CURRENT is {reg.current_version()}")
            code, pol = http_call("GET", fd.url + "/v1/policy")
            check(code == 200 and pol["rollout"]["phase"] == "promoted"
                  and pol["current"] == vgood, f"/v1/policy: {pol}")
            # Concurrent clients, answered by the promoted policy.
            burst = list(range(nxt, min(nxt + HTTP_BURST, len(reqs))))
            check(len(burst) == HTTP_BURST, "the stream ran out before "
                  f"the burst ({nxt} of {len(reqs)} requests used)")
            burst_bodies = [body(i) for i in burst]
            library.reset_launches()
            rows, burst_codes, burst_s = wire_burst(fd.url, burst_bodies)
            torch.cuda.synchronize()
            launches.update(library.LAUNCHES)
            HTTP_CODES.update(burst_codes)
            bad = [f"{burst[k]}: {err}" for k, (_, _, err) in enumerate(rows)
                   if err is not None]
            check(not bad, f"burst: {bad}")
            burst_wire = [sec for _, sec, _ in rows]
            check(all(r["policy_version"] == vgood for r, _, _ in rows),
                  "burst: answered by another policy than the promoted one")
        finally:
            fd.close()
        shadow.close()
        obs.close()
        phase_s = time.perf_counter() - t_phase
        check(fd.flush_restarts == 0, "the flush loop restarted")
        # The front door counts into its server's obs registry, and, once
        # the promoted candidate (built without obs) fronts the traffic,
        # into the process default.
        errors = obs.registry.errors + default_registry().errors - errors0
        check(errors == 0, f"{errors} errors counted by the front door/obs")
        # 202 answers a poll while pending; each fire-and-poll result of
        # the stages is claimed twice on purpose, the second time 404.
        codes = dict(HTTP_CODES)
        polled = (sum(1 for _, i, _ in sent if i % 2 == 0)
                  + sum(1 for k in range(len(burst)) if k % 2 == 0))
        check(set(codes) <= {200, 202, 404} and codes.get(404) == polled,
              f"HTTP codes {codes}")

        # The primary slice against an in-process server fed the same
        # requests in the same order (one flush each, as served).
        ref = AutotuneServer(PolicyRegistry(os.path.join(root, "inproc")),
                             task(), W1, bcfg, seed=0, obs=False)
        primary = [(i, res) for stage, i, res in sent
                   if res["policy_version"] == v1]
        check(len(primary) > HTTP_A, "the rollouts sent no request to the "
              "primary slice")
        for i, res in primary:
            rid = ref.submit(reqs[i])
            ref.drain()
            want = ref.poll(rid)
            m = want.record.metrics
            for key, a, b in (
                    ("action", res["action"], want.action),
                    ("state", res["state"], want.state),
                    ("eps", res["eps"], want.eps),
                    ("reward", res["reward"], want.reward),
                    ("status", res["outcome"]["status"], want.record.status),
                    ("ferr", res["outcome"]["ferr"], m["ferr"]),
                    ("nbe", res["outcome"]["nbe"], m["nbe"]),
                    ("n_outer", res["outcome"]["n_outer"], m["n_outer"]),
                    ("n_gmres", res["outcome"]["n_gmres"], m["n_gmres"]),
                    ("res_norm", res["outcome"]["res_norm"], m["res_norm"])):
                check(a == b or (a != a and b != b),
                      f"primary slice request {i}: {key} over HTTP {a} vs "
                      f"in-process {b}")
        check(same_tables(ref.live, original.live),
              "in-process Q/N tables differ from the primary's")

        # The OPE gate on the primary's logged stream.
        records = TrajectoryLog.read_complete(log, task="gmres_ir")
        gate = ShadowServer(reg, task(), W1, bcfg, rollout_cfg=RolloutConfig(
            **dict(HTTP_ROLLOUT, ope_gate=True, ope_min_records=HTTP_OPE_MIN)),
            seed=0, obs=False)
        try:
            gate.start_rollout(vbad, trajectories=records)
            refused = False
        except OPEGateRejected:
            refused = True
        ev = gate.decisions[-1].evidence
        check(ev["reason"] in ("cleared", "lcb_below_floor"),
              f"OPE gate did not score: {ev['reason']}")
        cand_dr, inc_dr = ev["candidate"]["dr"], ev["incumbent"]["dr"]
        check(cand_dr["value"] < inc_dr["value"],
              "OPE: the degraded candidate scored at or above the incumbent")
        check(reg.meta(vbad)["ope_gate"]["reason"] == ev["reason"],
              "OPE verdict not annotated into the registry")

        trail_rows = [json.loads(ln) for ln in open(trail) if ln.strip()]
        stages = collections.Counter(stage for stage, _, _ in sent)
        n_http = len(sent) + len(burst)
        lat = wire + burst_wire
        say(f"phase 11 stream: {n_http} requests over HTTP (n = "
            f"{sorted(reqs[i].n for _, i, _ in sent)} + burst "
            f"{sorted(reqs[i].n for i in burst)}); stages "
            f"{json.dumps(dict(stages))} + burst {len(burst)}")
        say(f"phase 11 one at a time: {len(sent)} requests in "
            f"{serving_s:.2f} s = {len(sent) / serving_s:.3f} requests/s; "
            f"wire latency p50 {pct(wire, 50):.4f} s, p99 "
            f"{pct(wire, 99):.4f} s")
        say(f"phase 11 burst: {len(burst)} concurrent clients ("
            f"{len(burst) // 2} sync, {len(burst) - len(burst) // 2} "
            f"fire-and-poll) in a client process, answered in "
            f"{burst_s:.2f} s = {len(burst) / burst_s:.3f} requests/s; "
            f"wire latency p50 {pct(burst_wire, 50):.4f} s, p99 "
            f"{pct(burst_wire, 99):.4f} s; all {n_http}: p50 "
            f"{pct(lat, 50):.4f} s, p99 {pct(lat, 99):.4f} s; HTTP codes "
            f"{json.dumps(codes)}")
        say("phase 11 decision trail: " + json.dumps(
            [{k: e.get(k) for k in ("event", "outcome", "responses",
                                    "windows_passed", "failures",
                                    "candidate", "baseline")
              if e.get(k) is not None} for e in trail_rows]))
        say(f"phase 11 OPE gate on {len(records)} logged records: "
            f"{'refused' if refused else 'admitted'} the degraded "
            f"candidate ({ev['reason']}): DR {cand_dr['value']:.4g} "
            f"[{cand_dr['ci'][0]:.4g}, {cand_dr['ci'][1]:.4g}] vs the "
            f"incumbent's {inc_dr['value']:.4g}, floor {ev['floor']:.4g}")
        say(f"phase 11 primary slice: {len(primary)} responses over HTTP "
            "bit-identical to the in-process server (action, state, eps, "
            "reward, status, ferr, nbe, n_outer, n_gmres, res_norm; Q/N)")
        say(f"phase 11 kernels (serving stages and burst) "
            f"{json.dumps({k: v for k, v in launches.items() if v})}; "
            f"phase {phase_s:.1f} s")
        for name in F64_KERNELS:
            check(launches[name] > 0, f"phase 11: {name} never launched")
        for name in SOLVER_KERNELS:
            check(launches[name] == 0,
                  f"phase 11 launched {name} (float32) {launches[name]} "
                  "times")
    return {"launches": dict(launches), "requests": n_http,
            "serial_rps": len(sent) / serving_s,
            "burst_rps": len(burst) / burst_s,
            "p50_s": pct(lat, 50), "p99_s": pct(lat, 99), "phase_s": phase_s}


def warm_boot(*args):
    """One server in a fresh process (`scripts/warm_boot.py`): its
    RESULT object."""
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(
            [sys.executable, os.path.join(root, "scripts", "warm_boot.py"),
             *args], capture_output=True, text=True,
            timeout=WARM_BOOT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise Failed(f"warm_boot {' '.join(args)}: no result in "
                     f"{WARM_BOOT_TIMEOUT_S} s")
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("RESULT ")]
    check(out.returncode == 0 and lines,
          f"warm_boot {' '.join(args)}: rc {out.returncode}: "
          f"{out.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def run_sharded(dev, card, policy, systems, cg_systems):
    """Phase 16: the sharded solve executor on the card (module
    docstring). Returns the launches of (b)'s split runs by kernel."""
    from repro_torch.core import (AutotuneEngine, LocalExecutor,
                                  ShardedExecutor, W1, reduced_action_space)
    from repro_torch.core import executor as EX
    from repro_torch.data.matrices import generate_dense_set
    from repro_torch.kernels import library
    from repro_torch.service import AutotuneServer, BatcherConfig
    from repro_torch.solvers import CGConfig, IRConfig
    from repro_torch.tasks import CGIRTask, GMRESIRTask
    t_phase = time.perf_counter()
    n_dev = torch.cuda.device_count()
    space = reduced_action_space(subsample=SHARD_ACTIONS)
    dense = sorted(systems, key=lambda s: s.n)
    sparse = sorted(cg_systems, key=lambda s: s.n)
    cases = (("GMRES-IR", GMRESIRTask, "ir_cfg", IRConfig(tau=1e-6),
              [dense[i] for i in SHARD_DENSE]),
             ("CG-IR", CGIRTask, "cg_cfg", CGConfig(tau=1e-6),
              [sparse[i] for i in SHARD_SPARSE]))
    check(ShardedExecutor().device_count() == n_dev,
          "ShardedExecutor() does not span the host's cards")
    try:
        ShardedExecutor(data=n_dev + 1).mesh()
        check(False, f"a mesh of {n_dev + 1} devices did not raise")
    except ValueError:
        pass

    def prefill(cls, kw, cfg, rows, carrier, ex, chunk=8):
        task = cls(rows, space, device=dev, carrier_dtype=carrier,
                   executor=ex, **{kw: cfg})
        eng = AutotuneEngine(task, chunk=chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill_all()
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    def outcomes(eng):
        return [(o.status, o.metrics) for o in (
            eng.outcome(i, a) for i in range(len(eng.task.instances))
            for a in range(space.n_actions))]

    def same(a, b):
        # Every float bit for bit, every NaN one NaN (float64 NaN
        # payloads follow operand order, ROADMAP Queue 3).
        def key(o):
            return (o[0], {k: ("nan" if v != v else np.float64(v).tobytes())
                           for k, v in o[1].items()})
        return [key(o) for o in a] == [key(o) for o in b]

    split = collections.Counter()
    seam = EX.mesh_devices
    for name, cls, kw, cfg, rows in cases:
        for carrier in ("float32", "float64"):
            what = f"phase 16 {name} {carrier}"
            loc, t_loc = prefill(cls, kw, cfg, rows, carrier, None)
            sh, t_sh = prefill(cls, kw, cfg, rows, carrier,
                               ShardedExecutor())
            want = outcomes(loc)
            check(same(outcomes(sh), want), f"{what} (a): sharded outcomes "
                  "differ from the local executor's")
            summ = sh.summarize()
            check(summ["n_devices"] == n_dev and summ["n_pad_solves"] == 0,
                  f"{what} (a): summarize {summ}")
            # (b): one card split four ways, against the local executor
            # on the same shards' rows (chunk 2: the 8-row chunk's split).
            library.reset_launches()
            _, t_in_turn = prefill(cls, kw, cfg, rows, carrier,
                                   LocalExecutor(), chunk=8 // SHARD_SPLIT)
            in_turn = dict(library.LAUNCHES)
            EX.mesh_devices = lambda t: [dev] * SHARD_SPLIT
            try:
                library.reset_launches()
                four, t_four = prefill(cls, kw, cfg, rows, carrier,
                                       ShardedExecutor(data=SHARD_SPLIT))
                got = dict(library.LAUNCHES)
            finally:
                EX.mesh_devices = seam
            check(same(outcomes(four), want), f"{what} (b): the four-shard "
                  "split differs from (a)")
            check(got == in_turn, f"{what} (b): launches {got} vs the "
                  f"shards run in turn {in_turn}")
            kernels = {k: v for k, v in got.items() if v}
            suffix = "_f64" if carrier == "float64" else ""
            for k in SOLVER_KERNELS:
                check(got[k + suffix] > 0, f"{what} (b): {k + suffix} "
                      "never launched")
            split.update(kernels)
            say(f"{what}: {len(rows)} systems (n = {[r.n for r in rows]}) x "
                f"{space.n_actions} actions; local {t_loc:.2f} s, sharded "
                f"over {n_dev} card(s) {t_sh:.2f} s (a), one card split "
                f"{SHARD_SPLIT} ways {t_four:.2f} s (b; the local executor "
                f"on the same shards in turn {t_in_turn:.2f} s), outcomes "
                f"bit-equal; (b) launches {json.dumps(kernels)} [{card}]")
            if n_dev >= 2:
                two, t_two = prefill(cls, kw, cfg, rows, carrier,
                                     ShardedExecutor(data=2))
                check(same(outcomes(two), want), f"{what} (d): data = 2 "
                      "on two cards differs from (a)")
                say(f"{what} (d): data = 2 on cuda:0 and cuda:1 "
                    f"{t_two:.2f} s, outcomes bit-equal [{card}]")
    if n_dev < 2:
        say(f"phase 16d: {n_dev} CUDA device, the two-card run waits")

    # (c): the server through the sharded executor.
    seed, n, n_range = SERVE_A
    reqs = generate_dense_set(n, np.random.default_rng(seed),
                              n_range=n_range)
    resp = {}
    for how, ex in (("local", "local"), ("sharded", "sharded")):
        task = GMRESIRTask(ir_cfg=IRConfig(tau=1e-6), device=dev)
        clock = StepClock()
        server = AutotuneServer(policy, task, W1,
                                BatcherConfig(max_batch=SERVE_MAX_BATCH),
                                clock=clock, seed=0, obs=False, executor=ex)
        check(server.executor.name == how, f"16c: executor {how}")
        t0 = time.perf_counter()
        resp[how] = serve(server, reqs, clock)
        torch.cuda.synchronize()
        say(f"phase 16c: {how} server, {n} requests in "
            f"{time.perf_counter() - t0:.2f} s [{card}]")
    for rid, g in resp["sharded"].items():
        w = resp["local"][rid]
        check((g.action, g.record.status, g.record.metrics, g.reward) ==
              (w.action, w.record.status, w.record.metrics, w.reward),
              f"16c: request {rid} differs between the sharded and the "
              "local server")

    # (e): the gradient sync and the meshes over an NCCL world of one.
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.train import dequantize_int8, quantize_int8, sync_leaf
    check(not dist.is_initialized(), "16e: a process group exists already")
    try:
        mesh = make_host_mesh(device=dev)
        check(dist.get_backend() == ("nccl" if dev.type == "cuda"
                                     else "gloo")
              and tuple(mesh.shape) == (1, 1), f"16e: host mesh {mesh}")
        g = torch.randn(7, 300, generator=torch.Generator().manual_seed(16))
        g = g.to(dev)
        plain = {"fp32": g.float(), "bf16": g.bfloat16().float(),
                 "int8": dequantize_int8(quantize_int8(g))}
        for mode, want in plain.items():
            got = sync_leaf(g, mode)
            check(torch.equal(got, want), f"16e: sync_leaf {mode}")
        try:
            make_production_mesh(device=dev)
            check(False, "16e: make_production_mesh did not raise")
        except RuntimeError:
            pass
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    say(f"phase 16e: sync_leaf fp32, bf16, int8 over NCCL (world of one) "
        f"equal to the plain formula; make_production_mesh raises")
    say(f"phase 16: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return dict(split)


def run_warmup(card):
    """Phase 13: AOT warmup, each server in a fresh process (module
    docstring). Returns each arm's RESULT."""
    from repro_torch.kernels import library
    t_phase = time.perf_counter()
    common = ("--carrier", "float64", "--buckets",
              *map(str, WARM_BUCKETS), "--requests", str(WARM_REQUESTS))
    cache = tempfile.mkdtemp(prefix="restart-", dir=library.BUILD_DIR)
    try:
        arms = {
            "cold": warm_boot("--warmup", "none", *common),
            "sync, fresh build directory": warm_boot(
                "--warmup", "sync", "--cache-dir", cache, *common),
            "background, restart over it": warm_boot(
                "--warmup", "background", "--cache-dir", cache, *common),
        }
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    for name, r in arms.items():
        reqs = r["requests"]
        firsts = [next(q for q in reqs if q["bucket"] == b)
                  for b in WARM_BUCKETS]
        rest = sorted(q["latency_s"] for q in reqs if q not in firsts)
        say(f"phase 13 {name}: boot to ready {r['boot_to_ready_s']:.3f} s "
            f"(imports {r['imports_s']:.3f} s before it); first request "
            + "; ".join(f"at {q['bucket']} {q['latency_s']:.4f} s "
                        "(the same request again: " + ", ".join(
                            f"{p['latency_s']:.4f}" for p in r["repeats"]
                            if p["bucket"] == q["bucket"]) + " s), "
                        f"{q['cold_launches']} cold launches, "
                        f"{q['nvcc_runs']} nvcc runs"
                        for q in firsts)
            + f"; p50 of the other {len(rest)} {pct(rest, 50):.4f} s; "
            f"cold launches in the process {r['cold_launches_in_process']}"
            f"; cache {json.dumps(r['cache'])}; warmup "
            f"{json.dumps(r['report'])}; digest {r['digest']} ({card})")
        if r["warmup"] == "none":
            check(reqs[0]["cold_launches"] > 0,
                  "phase 13: the cold server's first request launched "
                  "nothing for the first time")
            continue
        check(r["ready"] and r["report"]["done"]
              and not r["report"]["errors"],
              f"phase 13 {name}: warmup {r['report']}")
        for q in reqs:
            check((q["cold_launches"], q["nvcc_runs"], q["cold_cells"],
                   q["wrap_builds"]) == (0, 0, 0, 0),
                  f"phase 13 {name}: a request after warmup {q}")
    check(all(p["cold_launches"] == 0 for r in arms.values()
              for p in r["repeats"]),
          "phase 13: a repeated request launched a cold kernel instance")
    fresh = arms["sync, fresh build directory"]["cache"]
    restart = arms["background, restart over it"]["cache"]
    check(fresh["misses"] == 1 and restart["misses"] == 0
          and restart["hits"] > 0,
          f"phase 13: build cache {fresh} then {restart}")
    digests = {r["digest"] for r in arms.values()}
    check(len(digests) == 1, f"phase 13: outcomes differ {digests}")
    say(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return arms


# ---------------------------------------------------------------------------
# Phase 14: the LM serving path (configs/gemma2_9b.py at full width)
# ---------------------------------------------------------------------------

def lm_free():
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def scaled_err(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(float(want.double().abs().max()), 1e-30)


def run_lm_bf16(dev):
    """Phase 14 (a): gemma2-9b at full width and depth in bf16, one
    `forward` at B 1, S 4096 through the flash kernel's wgmma route, its
    launches counted by mask kind; each kind's attention output held
    against the plain attention on the same q, k and v; the forward's
    wall and device time."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import library
    from repro_torch.models import attention, forward, init_params
    from repro_torch.models.transformer import tree_leaves
    cfg = get_arch(LM_ARCH)
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    b, s = LM_FORWARD
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, g, torch.bfloat16, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    # The configs' analytic count leaves out the post-norms' gains.
    counted = cfg.params_total() + 2 * cfg.n_layers * cfg.d_model
    check(n_params == counted, f"{LM_ARCH}: {n_params} parameters, the "
          f"configs' count and the post-norms {counted}")
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev)
    seen = {}
    real = attention.flash_attention_op

    def record(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if kw["kind"] not in seen:
            seen[kw["kind"]] = (q.clone(), k.clone(), v.clone(), kw,
                                out.clone())
        return out

    def fwd():
        return forward(params, tokens, cfg, torch.bfloat16, device=dev)

    attention.flash_attention_op = record
    try:
        library.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = fwd()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(library.LAUNCHES)
        kinds = dict(library.FLASH_KIND_LAUNCHES)
        routes = dict(library.ROUTE_LAUNCHES["flash_attention"])
    finally:
        attention.flash_attention_op = real
    half = cfg.n_layers // 2
    say(f"LM (14a): {LM_ARCH} full width and depth ({cfg.n_layers} layers, "
        f"{n_params} parameters) in bf16, init {init_s:.2f} s; forward at "
        f"B {b}, S {s}: flash launches by kind {json.dumps(kinds)}, routes "
        f"{json.dumps(routes)}, kernels {json.dumps(launches)}; first "
        f"forward {first_s:.3f} s")
    check(kinds == {"attn": half, "local": half, "chunked": 0},
          f"14a: flash launches by kind {kinds}, expected {half} local and "
          f"{half} attn")
    check(routes == {"wgmma": cfg.n_layers}, f"14a: flash routes {routes}")
    check(sum(launches.values()) == cfg.n_layers,
          f"14a: kernels other than flash launched: {launches}")
    check(logits.shape == (b, s, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "14a: logits")
    err = 0.0
    shares = {}
    for kind, (q, k, v, kw, out) in sorted(seen.items()):
        pos = torch.arange(s, device=dev)
        mask = attention.attn_mask(pos, pos, kw["kind"], kw["window"],
                                   kw["chunk"])[None]
        want = attention.sdpa_plain(q, k, v, mask, kw["scale"],
                                    kw["softcap"])
        d = (out.float() - want.float()).abs()
        allowed = LM_BF16_TOL + LM_BF16_TOL * want.float().abs()
        shares[kind] = float((d / allowed).max())
        e = float(d.max())
        err = max(err, e)
        say(f"LM (14a) attention [{kind}, window {kw['window']}, softcap "
            f"{kw['softcap']}]: flash against the plain attention on the "
            f"same q, k, v: max abs err {e:.3e}, {shares[kind]:.3f} of the "
            f"tolerance (rtol = atol = {LM_BF16_TOL})")
        check(shares[kind] <= 1.0, f"14a: {kind} attention beyond "
              f"rtol = atol = {LM_BF16_TOL}")
    del seen, logits
    lm_free()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fwd()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0, start.elapsed_time(end)))
        del out
    prof = device_kernels(fwd, 1, sessions=3)
    busy = flash_ms = None
    # The flash launches' bound: live pairs of each kind (one of each per
    # group), bytes of q, k, v and o in bf16.
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    flash_flops = sum(4 * hd * b * hq * live_pairs(s, s, **kw) for kw in (
        dict(kind="attn"), dict(kind="local", window=cfg.window))) * half
    nbytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd) * cfg.n_layers
    flash_bound = bound(nbytes, flash_flops, BF16_FLOP_PER_S)
    if prof is not None:
        kern, count, _ = prof
        busy = (sum(kern.values()) / 1e3, sum(count.values()))
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
        say("LM (14a) forward's largest device items (ms, operations): "
            + "; ".join(f"{name[:90]} {us / 1e3:.2f} ({count[name]})"
                        for name, us in top))
        fl = [k for k in kern if "flash_" in k]
        flash_ms = sum(kern[k] for k in fl) / 1e3
        say(f"LM (14a) flash kernel in the forward: {flash_ms:.3f} ms on "
            f"the device over {sum(count[k] for k in fl)} launches "
            f"({flash_ms / cfg.n_layers:.4f} ms a launch); bound "
            f"{flash_bound[0]:.3f} ms (by {flash_bound[1]}; "
            f"{flash_flops:.3e} operations on live pairs, "
            f"{nbytes / 1e9:.3f} GB)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = 2 * n_params * b * s
    say(f"time LM (14a) forward, {LM_ARCH} bf16, B {b}, S {s}: wall "
        + ", ".join(f"{w:.4f} s" for w, _ in walls) + "; device span "
        + ", ".join(f"{e:.2f} ms" for _, e in walls) + "; device busy "
        + ("not measured" if busy is None else
           f"{busy[0]:.2f} ms in {busy[1]} device operations")
        + f"; matmul operations {flops:.3e} "
        f"({flops / BF16_FLOP_PER_S * 1e3:.2f} ms at the bf16 peak); peak "
        f"memory allocated {peak:.1f} GiB")
    del params
    lm_free()
    return {"launches": launches["flash_attention"], "kinds": kinds,
            "err": err, "shares": shares, "init_s": init_s,
            "first_s": first_s, "walls": walls,
            "busy_ms": None if busy is None else busy[0],
            "flash_device_ms": flash_ms, "flash_bound_ms": flash_bound[0]}


def greedy_flips(params, prompts, toks, cfg, dev):
    """The reference's own property (tests/test_serve.py:15-33): each
    greedy token is the argmax of a full `forward` over the prompt and
    the tokens before it. Returns, for each token that differs, (step,
    row, the forward's logit gap between its argmax and the token, the
    forward's top-2 gap, the logits' scale)."""
    from repro_torch.models import forward
    flips = []
    seq = prompts
    for i in range(toks.shape[1]):
        lg = forward(params, seq, cfg, torch.float32, device=dev)[:, -1]
        want = lg.argmax(-1)
        for r in torch.nonzero(want != toks[:, i]).flatten().tolist():
            top2 = torch.topk(lg[r], 2).values
            flips.append((i, r, float(lg[r, want[r]] - lg[r, toks[r, i]]),
                          float(top2[0] - top2[1]),
                          float(lg[r].abs().max())))
        seq = torch.cat([seq, toks[:, i:i + 1]], dim=1)
    return flips


def check_flips(flips, what):
    for i, r, gap, top2, scale in flips:
        say(f"{what}: step {i}, row {r}: the forward's argmax differs, "
            f"logit gap {gap:.3e} (top-2 gap {top2:.3e}), {gap / scale:.2e} "
            f"of the logits' scale {scale:.3f}")
        check(gap < LM_TIE * scale, f"{what}: step {i}, row {r}: a flip "
              f"with a gap of {gap / scale:.2e} of the scale, not a tie "
              f"(< {LM_TIE})")


def run_lm_f32(dev):
    """Phase 14 (b): gemma2-9b at full width in float32, cut to
    `LM_DEPTH` layers: `forward` through the flash kernel's simt route
    (S past the window, padded to a multiple of 128) against the plain
    forward on the card; greedy `generate` against argmax over repeated
    forwards; the same with the KV cache rounded to e4m3 through the chop
    kernel, its launches counted."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import library
    from repro_torch.models import attention, forward, init_params
    from repro_torch.precision import FORMAT_ID, chop
    from repro_torch.serve import ServeConfig, generate
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LM_DEPTH)
    g = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    params = init_params(cfg, g, torch.float32, dev)
    b, s = LM_F32_FORWARD
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev)
    library.reset_launches()
    t0 = time.perf_counter()
    logits = forward(params, tokens, cfg, torch.float32, device=dev)
    torch.cuda.synchronize()
    flash_s = time.perf_counter() - t0
    launches = dict(library.LAUNCHES)
    kinds = dict(library.FLASH_KIND_LAUNCHES)
    routes = dict(library.ROUTE_LAUNCHES["flash_attention"])
    t0 = time.perf_counter()
    with attention.plain_attention():
        plain = forward(params, tokens, cfg, torch.float32, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err, share = scaled_err(logits, plain)
    say(f"LM (14b): {LM_ARCH} full width in float32, {LM_DEPTH} layers (a "
        f"depth cut), forward at B {b}, S {s} (padded to "
        f"{-(-s // 128) * 128}): flash by kind {json.dumps(kinds)}, routes "
        f"{json.dumps(routes)}, {flash_s:.3f} s; the plain forward "
        f"{plain_s:.3f} s; logits max abs err {err:.3e}, {share:.2e} of their "
        f"scale (tolerance {LM_F32_TOL})")
    check(launches["flash_attention"] == LM_DEPTH
          and routes == {"simt": LM_DEPTH}
          and kinds == {"attn": LM_DEPTH // 2, "local": LM_DEPTH // 2,
                        "chunked": 0}, f"14b: flash launches {kinds}, "
          f"{routes}")
    check(library.LAUNCHES["flash_attention"] == LM_DEPTH,
          "14b: the plain forward launched the flash kernel")
    check(bool(torch.isfinite(logits).all()) and share <= LM_F32_TOL,
          f"14b: forward {share:.2e} of the scale from the plain forward")
    del logits, plain
    lm_free()

    bsz, plen, new = LM_GEN
    prompts = torch.randint(0, cfg.vocab_size, (bsz, plen), generator=g,
                            device=dev)
    scfg = ServeConfig(max_new_tokens=new, compute_dtype=torch.float32)
    library.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(params, prompts, cfg, scfg, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = dict(library.LAUNCHES)
    check(sum(gen_launches.values()) == 0,
          f"14b: generate without a KV format launched {gen_launches}")
    busy = device_busy(
        lambda: generate(params, prompts, cfg, scfg, device=dev))
    say(f"LM (14b) greedy generate under torch.profiler: device busy "
        + ("not measured" if busy is None else
           f"{busy[0]:.2f} ms in {busy[1]} device operations, "
           f"{busy[1] / (plen + new) / LM_DEPTH:.1f} a layer a step; "
           f"{busy[0] / (gen_s * 1e3):.3f} of the unprofiled run's wall"))
    flips = greedy_flips(params, prompts, toks, cfg, dev)
    check_flips(flips, "14b greedy")
    say(f"LM (14b): greedy generate B {bsz}, prompt {plen}, {new} new "
        f"tokens: {gen_s:.3f} s ({bsz * new / gen_s:.1f} tok/s, prefill "
        f"included), equal to argmax over repeated forwards "
        f"{toks.numel() - len(flips)} of {toks.numel()}")

    fmt = FORMAT_ID[LM_KV_FMT]
    scfg8 = ServeConfig(max_new_tokens=new, compute_dtype=torch.float32,
                        cache_fmt=fmt)
    library.reset_launches()
    toks8 = generate(params, prompts, cfg, scfg8, device=dev)
    torch.cuda.synchronize()
    chop_launches = library.LAUNCHES["chop"]
    chop_routes = dict(library.ROUTE_LAUNCHES["chop"])
    want = 2 * LM_DEPTH * (plen + new)
    real = attention.chop_op
    attention.chop_op = lambda x, f: chop(x, f)
    try:
        library.reset_launches()
        toks8_plain = generate(params, prompts, cfg, scfg8, device=dev)
        check(library.LAUNCHES["chop"] == 0, "14b: the plain chop launched")
    finally:
        attention.chop_op = real
    agree = float((toks8 == toks).float().mean())
    say(f"LM (14b): greedy generate with the KV cache in {LM_KV_FMT}: chop "
        f"launches {chop_launches} (2 x {LM_DEPTH} layers x {plen + new} "
        f"steps = {want}), routes {json.dumps(chop_routes)}; tokens equal "
        f"to the same generate with the chop's plain version: "
        f"{bool(torch.equal(toks8, toks8_plain))}; agreement with the "
        f"float32 cache {agree:.3f}")
    check(chop_launches == want, f"14b: {chop_launches} chop launches, "
          f"expected {want}")
    check(torch.equal(toks8, toks8_plain),
          "14b: e4m3 KV cache through the kernel differs from the plain "
          "chop's")
    del params
    lm_free()
    return {"launches": launches["flash_attention"], "kinds": kinds,
            "share": share, "flips": len(flips), "gen_s": gen_s,
            "gen_busy": busy,
            "chop_launches": chop_launches, "kv_agree": agree}


def run_lm_serve():
    """Phase 14 (c): `python -m repro_torch.launch.serve` at gemma2-9b's
    full width and depth (float32, as the launcher runs it) with a bf16
    KV cache, in a process of its own; its tok/s."""
    import re
    lm_free()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           LM_ARCH, *LM_SERVE_ARGS]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, env=env, cwd=root, capture_output=True,
                             text=True, timeout=LM_SERVE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise Failed(f"14c: launch.serve gave no result in "
                     f"{LM_SERVE_TIMEOUT_S} s")
    proc_s = time.perf_counter() - t0
    check(out.returncode == 0, f"14c: launch.serve rc {out.returncode}: "
          f"{out.stderr[-3000:]}")
    found = re.search(r"\[serve\] .*\(([0-9.]+) tok/s\)", out.stdout)
    check(found is not None, f"14c: no tok/s line: {out.stdout[-2000:]}")
    line = found.group(0)
    say(f"LM (14c): {' '.join(cmd[1:])}: {line}; the process took "
        f"{proc_s:.1f} s")
    return {"tok_s": float(found.group(1)), "line": line, "proc_s": proc_s}


def run_lm_smoke(dev):
    """Phase 14 (d): every arch at its `smoke_config()` on the card
    against the same calls on the CPU (the plain versions): `forward`,
    one `decode_step` from `init_caches`, and a short greedy `generate`,
    float32, the weights drawn on the CPU and copied."""
    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.kernels import library
    from repro_torch.models import (decode_step, forward, init_caches,
                                    init_params)
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve import ServeConfig, generate
    b, s, plen, new = LM_SMOKE
    worst = 0.0
    flash = 0
    for i, name in enumerate(sorted(ARCHS)):
        cfg = get_smoke(name)
        g = torch.Generator().manual_seed(LM_SEED + 10 + i)
        cpu = init_params(cfg, g, torch.float32, "cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
        pe = None
        if cfg.frontend == "vision_stub":
            pe = torch.randn((b, cfg.n_prefix_embeds, cfg.d_model),
                             generator=g)
        library.reset_launches()
        got = forward(card, tokens.to(dev), cfg, torch.float32,
                           prefix_embeds=None if pe is None else pe.to(dev),
                           device=dev)
        flash += library.LAUNCHES["flash_attention"]
        want = forward(cpu, tokens, cfg, torch.float32,
                            prefix_embeds=pe, device="cpu")
        f_err = scaled_err(got.cpu(), want)[1]
        caches = init_caches(cfg, b, 8, torch.float32, device=dev)
        dgot, _ = decode_step(card, tokens[:, :1].to(dev), caches, cfg,
                              torch.float32, device=dev)
        caches = init_caches(cfg, b, 8, torch.float32, device="cpu")
        dwant, _ = decode_step(cpu, tokens[:, :1], caches, cfg,
                               torch.float32, device="cpu")
        d_err = scaled_err(dgot.cpu(), dwant)[1]
        scfg = ServeConfig(max_new_tokens=new, compute_dtype=torch.float32)
        tgot = generate(card, tokens[:, :plen].to(dev), cfg, scfg,
                        device=dev).cpu()
        twant = generate(cpu, tokens[:, :plen], cfg, scfg, device="cpu")
        differ = int((tgot != twant).sum())
        if differ:
            flips = greedy_flips(cpu, tokens[:, :plen], tgot, cfg, "cpu")
            check_flips(flips, f"14d {name}, card tokens on the CPU forward")
        worst = max(worst, f_err, d_err)
        say(f"LM (14d) {name} smoke ({cfg.n_layers} layers, d {cfg.d_model},"
            f" head dim {cfg.head_dim}): card against CPU, forward "
            f"{f_err:.2e} and decode_step {d_err:.2e} of the logits' scale "
            f"(tolerance {LM_SMOKE_TOL}); generate tokens differing "
            f"{differ} of {tgot.numel()}; flash launches in the forward "
            f"{library.LAUNCHES['flash_attention']}")
        check(f_err <= LM_SMOKE_TOL and d_err <= LM_SMOKE_TOL,
              f"14d {name}: card against CPU beyond {LM_SMOKE_TOL}")
        del card, cpu
    lm_free()
    return {"worst": worst, "flash": flash}


def run_lm(dev):
    """Phase 14: the LM serving path on the card (a)-(d)."""
    t_phase = time.perf_counter()
    with torch.inference_mode():
        a = run_lm_bf16(dev)
        b = run_lm_f32(dev)
    c = run_lm_serve()
    with torch.inference_mode():
        d = run_lm_smoke(dev)
    phase_s = time.perf_counter() - t_phase
    say(f"LM phase (14): {phase_s:.1f} s")
    return {"a": a, "b": b, "c": c, "d": d, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# Phase 15: LM training (configs/granite_3_2b.py at full width and depth)
# ---------------------------------------------------------------------------

def leaf_paths(tree, prefix=""):
    """Names of a parameter tree's leaves in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in leaf_paths(t, f"{prefix}/[{i}]")]
    return [prefix]


def grads_of(params, batch, cfg, dtype, dev):
    """(loss, the gradient of each leaf in `tree_leaves` order) of
    `models.loss_fn` at `params`, as the train step takes them."""
    from repro_torch.models import loss_fn
    from repro_torch.models.transformer import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = loss_fn(params, batch, cfg, dtype, device=dev)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(loss.detach()), grads


def flash_counts():
    from repro_torch.kernels import library
    return (library.LAUNCHES["flash_attention"],
            dict(library.ROUTE_LAUNCHES["flash_attention"]),
            dict(library.FLASH_KIND_LAUNCHES))


def run_train_full(dev):
    """Phase 15 (a): granite-3-2b at full width and depth, `init_train_state`
    on the card and `make_train_step` with `TrainStepConfig`'s defaults
    (bf16 compute, float32 masters and moments), B 4, S 1024 from
    `TokenPipeline(seed=0)`: the gradient of every leaf against the same
    state and batch under `plain_attention()`, then `TRAIN_FULL` steps
    with the flash launches of each counted, their wall, one more step
    under torch.profiler, and the peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import library
    from repro_torch.models import attention
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import (TrainStepConfig, init_train_state,
                                   make_train_step)
    lm_free()
    cfg = get_arch(TRAIN_ARCH)
    tcfg = TrainStepConfig()
    b, s, steps = TRAIN_FULL
    g = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    t0 = time.perf_counter()
    state = init_train_state(cfg, g, tcfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    names = leaf_paths(state.params)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    check(n_params == cfg.params_total(), f"15a: {n_params} parameters, "
          f"the configs' count {cfg.params_total()}")
    pipe = TokenPipeline(cfg.vocab_size, s, b, seed=0)
    batches = [pipe.next_batch() for _ in range(steps + 1)]
    say(f"train (15a): {TRAIN_ARCH} full width and depth ({cfg.n_layers} "
        f"layers, {n_params} parameters, {len(names)} leaves), float32 "
        f"masters, bf16 compute, B {b}, S {s}; init {init_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated (masters "
        f"and moments, {12 * n_params / 1e9:.2f} GB reckoned)")

    # One step's gradient, flash route against the plain attention.
    torch.cuda.reset_peak_memory_stats()
    library.reset_launches()
    t0 = time.perf_counter()
    loss_f, g_flash = grads_of(state.params, batches[0], cfg,
                               tcfg.compute_dtype, dev)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    n_flash, routes, kinds = flash_counts()
    say(f"train (15a) gradient on the flash route: loss {loss_f:.6f}, "
        f"{grad_s:.2f} s; flash launches {n_flash} (routes "
        f"{json.dumps(routes)}, kinds {json.dumps(kinds)}: the forward and "
        f"the group remat's recompute, {cfg.n_layers} each)")
    check(routes == {"wgmma": 2 * cfg.n_layers},
          f"15a: flash launches {routes} in the gradient, expected "
          f"{2 * cfg.n_layers} on wgmma")
    for name, gl in zip(names, g_flash):
        check(gl is not None, f"15a: no gradient for {name}")
        check(bool(torch.isfinite(gl).all()), f"15a: {name} gradient not "
              "finite")
        check(float(gl.abs().max()) > 0, f"15a: {name} gradient is zero")
    with attention.plain_attention():
        loss_p, g_plain = grads_of(state.params, batches[0], cfg,
                                   tcfg.compute_dtype, dev)
    torch.cuda.synchronize()
    check(library.LAUNCHES["flash_attention"] == n_flash,
          "15a: the plain attention launched the flash kernel")
    grad_peak = torch.cuda.max_memory_allocated() / 1e9
    cos = {}
    sq_f = sq_p = 0.0
    for name, a, w in zip(names, g_flash, g_plain):
        a, w = a.reshape(-1), w.reshape(-1)
        na, nw = float(torch.linalg.vector_norm(a)), \
            float(torch.linalg.vector_norm(w))
        cos[name] = float(torch.dot(a, w)) / max(na * nw, 1e-30)
        sq_f, sq_p = sq_f + na * na, sq_p + nw * nw
    norm_f, norm_p = sq_f ** 0.5, sq_p ** 0.5
    norm_rel = abs(norm_f - norm_p) / norm_p
    worst = min(cos, key=cos.get)
    attn = {k: round(v, 6) for k, v in cos.items()
            if k.rsplit("/", 1)[1] in ("wq", "wk", "wv")}
    say(f"train (15a) gradient against the plain attention (loss "
        f"{loss_p:.6f}): global norm {norm_f:.6e} / {norm_p:.6e}, "
        f"{norm_rel:.3e} apart (tolerance {TRAIN_NORM_RTOL}); leaf cosine "
        f"min {cos[worst]:.6f} at {worst} (tolerance {TRAIN_COS}); wq, wk, "
        f"wv {json.dumps(attn)}; peak memory allocated {grad_peak:.2f} GB")
    check(all(c >= TRAIN_COS for c in cos.values()),
          f"15a: leaf cosine {cos[worst]:.6f} at {worst} below {TRAIN_COS}")
    check(norm_rel <= TRAIN_NORM_RTOL, f"15a: global norms {norm_rel:.3e} "
          "apart")
    del g_plain
    # AdamW alone over the whole tree with these gradients, at lr 0 (the
    # parameters keep their bits; the moments are zeroed again after).
    from repro_torch.train import adamw_update
    from repro_torch.train.train_step import _unflatten
    grads = _unflatten(state.params, iter(g_flash))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    adamw_update(state.params, grads, state.opt, 0.0, tcfg.opt)
    end.record()
    torch.cuda.synchronize()
    opt_ms = start.elapsed_time(end)
    for t in tree_leaves(state.opt.m) + tree_leaves(state.opt.v):
        t.zero_()
    opt_bound = 28 * n_params / HBM_BYTES_PER_S * 1e3
    say(f"time train (15a) adamw_update alone, {n_params} float32 "
        f"parameters: {opt_ms:.2f} ms (CUDA events, one call); bound "
        f"{opt_bound:.2f} ms (bytes: p, g, m, v read and p, m, v written, "
        f"{28 * n_params / 1e9:.1f} GB)")
    del g_flash, grads
    lm_free()
    attn_bwd = time_flash_backward(dev, cfg, b, s)

    # The train steps.
    step = make_train_step(cfg, tcfg)
    torch.cuda.reset_peak_memory_stats()
    losses, walls, per_step = [], [], []
    for batch in batches[:steps]:
        library.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append(flash_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i, (n, routes, kinds) in enumerate(per_step):
        check(routes == {"wgmma": 2 * cfg.n_layers},
              f"15a: step {i + 1} flash launches {routes}")
    check(all(np.isfinite(losses)), f"15a: losses {losses}")
    holder = [state]

    def one_more():
        holder[0], _ = step(holder[0], batches[steps])
    prof = device_kernels(one_more, 1, sessions=3)
    busy = None
    if prof is not None:
        kern, count, _ = prof
        busy = (sum(kern.values()) / 1e3, sum(count.values()))
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
        say("train (15a) step's largest device items (ms, operations): "
            + "; ".join(f"{name[:90]} {us / 1e3:.2f} ({count[name]})"
                        for name, us in top))
    wall = float(np.mean(walls[1:]))
    tok_s = b * s / wall
    flops = 8 * n_params * b * s     # forward, remat, backward (2 + 2 + 4)
    say(f"time train (15a) step, {TRAIN_ARCH} bf16, B {b}, S {s}: losses "
        + ", ".join(f"{x:.6f}" for x in losses) + "; wall "
        + ", ".join(f"{w:.4f} s" for w in walls)
        + f"; after the first {wall:.4f} s ({tok_s:.1f} tokens/s); device "
        + ("busy not measured" if busy is None else
           f"busy {busy[0]:.2f} ms in {busy[1]} device operations a step, "
           f"{busy[0] / (wall * 1e3):.3f} of the unprofiled step's wall")
        + f"; flash launches a step {per_step[-1][0]}; matmul operations "
        f"{flops:.3e} ({flops / BF16_FLOP_PER_S * 1e3:.1f} ms at the bf16 "
        f"peak); peak memory allocated {peak:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")
    del state, holder, batches
    lm_free()
    return {"flash_a_step": per_step[-1][0], "grad_flash": n_flash,
            "steps": steps, "losses": losses, "walls": walls,
            "tok_s": tok_s, "busy_ms": None if busy is None else busy[0],
            "ops": None if busy is None else busy[1], "peak_gb": peak,
            "grad_peak_gb": grad_peak, "min_cos": cos[worst],
            "norm_rel": norm_rel, "opt_ms": opt_ms, "opt_bound_ms": opt_bound,
            "attention_backward": attn_bwd}


def time_flash_backward(dev, cfg, b, s):
    """One layer's attention at the step's shape (bf16, causal, B, S,
    Hq over Hkv at D): the flash kernel's forward, the wrapper's forward
    and backward (the plain version's recompute), and SDPA's forward and
    backward on the same operands as the yardstick; the backward as the
    difference of the two. Its bound: 2.5x the forward's operations on
    live pairs (five products against two), bf16 bytes of q, k, v, o
    and dO read and dq, dk, dv written."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_op
    g = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 2)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)
               for h in (hq, hkv, hkv))
    go = torch.randn(b, s, hq, d, generator=g, device=dev,
                     dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            return flash_attention_op(q, k, v)

    def fwd_bwd():
        return torch.autograd.grad(flash_attention_op(q, k, v), (q, k, v),
                                   go)
    qs, ks, vs = (t.detach().permute(0, 2, 1, 3).contiguous()
                  .requires_grad_(True) for t in (q, k, v))
    gos = go.permute(0, 2, 1, 3).contiguous()

    def lib_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                  enable_gqa=True)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qs, ks, vs), gos)
    out = {"fwd_ms": time_ms(fwd, 5), "fwd_bwd_ms": time_ms(fwd_bwd, 3),
           "sdpa_fwd_ms": time_ms(lib_fwd, 5),
           "sdpa_fwd_bwd_ms": time_ms(lib_fwd_bwd, 3)}
    out["bwd_ms"] = out["fwd_bwd_ms"] - out["fwd_ms"]
    out["sdpa_bwd_ms"] = out["sdpa_fwd_bwd_ms"] - out["sdpa_fwd_ms"]
    flops = 2.5 * 4 * d * b * hq * live_pairs(s, s)
    nbytes = 2 * (3 * b * s * hq * d + 4 * b * s * hkv * d
                  + b * s * hq * d)
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOP_PER_S)
    say(f"time train (15a) one layer's attention, bf16, B {b}, S {s}, Hq "
        f"{hq}, Hkv {hkv}, D {d}: flash kernel forward {out['fwd_ms']:.4f} "
        f"ms; forward and backward {out['fwd_bwd_ms']:.4f} ms, so the "
        f"backward (the plain recompute) {out['bwd_ms']:.4f} ms, x "
        f"{cfg.n_layers} layers {out['bwd_ms'] * cfg.n_layers:.1f} ms a "
        f"step; bound {out['bwd_bound_ms']:.4f} ms ({out['bwd_bound_by']}); "
        f"sdpa forward {out['sdpa_fwd_ms']:.4f} ms, backward "
        f"{out['sdpa_bwd_ms']:.4f} ms")
    del q, k, v, qs, ks, vs, go, gos
    lm_free()
    return out


def states_apart(got, want):
    """Largest |got - want| over each float leaf's scale (max |want|) of
    two train states (any devices)."""
    from repro_torch.models.transformer import tree_leaves
    worst = 0.0
    for a, w in zip(tree_leaves(got), tree_leaves(want)):
        if a.is_floating_point():
            worst = max(worst, scaled_err(a.cpu(), w.cpu())[1])
        else:
            check(torch.equal(a.cpu(), w.cpu()), "15b: integer leaves "
                  "differ")
    return worst


def run_train_smoke(dev):
    """Phase 15 (b): granite-3-2b's smoke config in float32 (the simt
    route at D 16): `TRAIN_SMOKE` steps on the card from a state drawn on
    the CPU, the loss falling by more than 0.5 (the reference's
    `test_train_loss_decreases_smoke`); the first `TRAIN_CPU_STEPS` of
    them on the CPU from the same state; one step under an emulated
    e4m3 `LMPrecisionPolicy`, card against CPU, its chop launches
    counted and the policy matmuls' weights moved by decay alone."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import library
    from repro_torch.models.transformer import tree_map
    from repro_torch.precision import FORMAT_ID
    from repro_torch.train import (LMPrecisionPolicy, TrainStepConfig,
                                   init_train_state, make_train_step)
    cfg = get_smoke(TRAIN_ARCH)
    tcfg = TrainStepConfig(compute_dtype=torch.float32, **TRAIN_SMOKE_TCFG)
    b, s, steps = TRAIN_SMOKE
    cpu = init_train_state(cfg, torch.Generator().manual_seed(TRAIN_SEED),
                           tcfg, "cpu")
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    pipe = TokenPipeline(cfg.vocab_size, s, b, seed=0)
    batches = [pipe.next_batch() for _ in range(steps)]
    step = make_train_step(cfg, tcfg)
    library.reset_launches()
    t0 = time.perf_counter()
    losses, snap = [], None
    for i, batch in enumerate(batches):
        card, m = step(card, batch)
        losses.append(float(m["loss"]))
        if i + 1 == TRAIN_CPU_STEPS:
            snap = tree_map(lambda t: t.to("cpu", copy=True), card), \
                list(losses)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    n_flash, routes, kinds = flash_counts()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    say(f"train (15b): {TRAIN_ARCH} smoke ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, head dim {cfg.head_dim}), float32, {steps} steps "
        f"at B {b}, S {s}, {TRAIN_SMOKE_TCFG}: {card_s:.2f} s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}; flash launches {n_flash} "
        f"(routes {json.dumps(routes)})")
    check(routes == {"simt": 2 * cfg.n_layers * steps},
          f"15b: flash launches {routes}")
    check(last < first - 0.5, f"15b: the loss fell {first - last:.4f}, "
          "not more than 0.5")
    cpu_losses = []
    for batch in batches[:TRAIN_CPU_STEPS]:
        cpu, m = step(cpu, batch)
        cpu_losses.append(float(m["loss"]))
    loss_err = max(abs(a - w) / abs(w) for a, w in zip(snap[1], cpu_losses))
    state_err = states_apart(snap[0], cpu)
    say(f"train (15b): the first {TRAIN_CPU_STEPS} steps card against CPU: "
        f"losses {loss_err:.2e} apart (relative), states {state_err:.2e} "
        f"of each leaf's scale (tolerance {TRAIN_SMOKE_TOL})")
    check(loss_err <= TRAIN_SMOKE_TOL and state_err <= TRAIN_SMOKE_TOL,
          f"15b: card against CPU beyond {TRAIN_SMOKE_TOL}")

    # One step under an emulated e4m3 policy.
    etcfg = TrainStepConfig(compute_dtype=torch.float32,
                            **{**TRAIN_SMOKE_TCFG, "warmup": 0})
    pol = LMPrecisionPolicy(FORMAT_ID["e4m3"])
    e_cpu = init_train_state(cfg, torch.Generator().manual_seed(
        TRAIN_SEED + 1), etcfg, "cpu")
    e_card = tree_map(lambda t: t.to(dev, copy=True), e_cpu)
    before = tree_map(lambda t: t.clone(), e_cpu.params)
    estep = make_train_step(cfg, etcfg, policy=pol)
    library.reset_launches()
    e_card, m_card = estep(e_card, batches[0])
    torch.cuda.synchronize()
    chop_launches = library.LAUNCHES["chop"]
    chop_routes = dict(library.ROUTE_LAUNCHES["chop"])
    e_flash = library.LAUNCHES["flash_attention"]
    e_cpu, m_cpu = estep(e_cpu, batches[0])
    e_err = states_apart(e_card, e_cpu)
    lr = float(m_cpu["lr"])
    decay_err = 0.0
    names = leaf_paths(before)
    from repro_torch.models.transformer import tree_leaves
    for name, p0, p1 in zip(names, tree_leaves(before),
                            tree_leaves(e_card.params)):
        if "/mixer/" in name or "/ffn/" in name or "/ln" in name:
            want = p0 - lr * (0.1 * p0)
            decay_err = max(decay_err, scaled_err(p1.cpu(), want)[1])
    say(f"train (15b): one step under an emulated {pol}: chop launches "
        f"{chop_launches} (routes {json.dumps(chop_routes)}), flash "
        f"{e_flash}; loss card {float(m_card['loss']):.6f}, CPU "
        f"{float(m_cpu['loss']):.6f}; state card against CPU {e_err:.2e} of "
        f"each leaf's scale; the policy matmuls' weights and norms against "
        f"decay alone, p (1 - lr wd), {decay_err:.2e}")
    check(chop_launches > 0, "15b: the emulated step launched no chop")
    check(e_err <= TRAIN_SMOKE_TOL, "15b: emulated step card against CPU")
    check(decay_err <= 1e-6, "15b: the emulated step moved a policy "
          "matmul's weight by more than its decay")
    del card, cpu, e_card, e_cpu
    lm_free()
    return {"flash": n_flash, "losses": losses, "loss_drop": first - last,
            "cpu_err": max(loss_err, state_err), "chop": chop_launches,
            "emulated_flash": e_flash, "card_s": card_s}


def launch_train(ckpt_dir, kill_at=None):
    """`python -m repro_torch.launch.train` with `TRAIN_LAUNCH_ARGS` over
    `ckpt_dir` in a process of its own; with `kill_at`, killed (SIGKILL)
    as soon as its LATEST names that step. Returns (returncode, stdout,
    stderr, seconds)."""
    from repro_torch.checkpoint import latest_step
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           *TRAIN_LAUNCH_ARGS, "--ckpt-dir", ckpt_dir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        if kill_at is not None:
            while proc.poll() is None and \
                    time.perf_counter() - t0 < TRAIN_LAUNCH_TIMEOUT_S:
                if latest_step(ckpt_dir) == kill_at:
                    proc.kill()
                    break
                time.sleep(0.0005)
        out, err = proc.communicate(timeout=TRAIN_LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise Failed(f"15c: launch.train gave no result in "
                     f"{TRAIN_LAUNCH_TIMEOUT_S} s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err, time.perf_counter() - t0


def run_train_launch():
    """Phase 15 (c): the launcher at the smoke config in processes of its
    own: a run killed right after its step-6 checkpoint, the same command
    again over its directory (resumes from step 6), and an uninterrupted
    run; the resumed run's final loss against the uninterrupted one's."""
    import re
    from repro_torch.checkpoint import latest_step
    lm_free()
    final = re.compile(r"\[train\] done at step (\d+); final loss ([0-9.]+)")
    with tempfile.TemporaryDirectory() as tmp:
        a, whole = os.path.join(tmp, "a"), os.path.join(tmp, "whole")
        rc, out, err, kill_s = launch_train(a, kill_at=TRAIN_KILL_AT)
        check(rc == -9 and latest_step(a) == TRAIN_KILL_AT,
              f"15c: the run to kill ended with {rc}, LATEST "
              f"{latest_step(a)}: {out[-1500:]} {err[-1500:]}")
        rc, out, err, resume_s = launch_train(a)
        check(rc == 0, f"15c: the resumed run rc {rc}: {err[-3000:]}")
        check(f"[train] resumed from step {TRAIN_KILL_AT}" in out,
              f"15c: no resume line: {out[-1500:]}")
        got = final.search(out)
        rc, out2, err, whole_s = launch_train(whole)
        check(rc == 0, f"15c: the uninterrupted run rc {rc}: {err[-3000:]}")
        want = final.search(out2)
        check(got is not None and want is not None,
              f"15c: no final loss: {out[-800:]} {out2[-800:]}")
    l_res, l_whole = float(got.group(2)), float(want.group(2))
    rel = abs(l_res - l_whole) / abs(l_whole)
    say(f"train (15c): python -m repro_torch.launch.train "
        f"{' '.join(TRAIN_LAUNCH_ARGS)}: killed after its step-"
        f"{TRAIN_KILL_AT} checkpoint ({kill_s:.1f} s), relaunched: "
        f"'[train] resumed from step {TRAIN_KILL_AT}', final loss "
        f"{l_res:.8f} ({resume_s:.1f} s); uninterrupted {l_whole:.8f} "
        f"({whole_s:.1f} s); {rel:.2e} apart (tolerance {TRAIN_RESUME_TOL})")
    check(int(got.group(1)) == int(want.group(1)) and rel <= TRAIN_RESUME_TOL,
          "15c: the resumed run's final loss differs from the "
          "uninterrupted run's")
    return {"resumed": l_res, "whole": l_whole, "rel": rel}


def run_train(dev):
    """Phase 15: LM training on the card (a)-(c)."""
    t_phase = time.perf_counter()
    a = run_train_full(dev)
    b = run_train_smoke(dev)
    c = run_train_launch()
    phase_s = time.perf_counter() - t_phase
    say(f"train phase (15): {phase_s:.1f} s")
    return {"a": a, "b": b, "c": c, "phase_s": phase_s}


def decision_list(shadow):
    return [(d.outcome, d.responses, d.failures) for d in shadow.decisions]


def pinned_bf16(policy):
    """A candidate whose greedy action is always action 0 (all bf16)."""
    policy.qtable.Q[:] = 0.0
    policy.qtable.Q[:, 0] = 1.0
    return policy


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch", "csrc")):
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(root, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    try:
        card = card_line()
        say(card)
        from repro_torch.kernels import library
        library.load()
        built = library.BUILD_SECONDS
        say("build: " + (f"nvcc {built:.1f} s, one process per source "
                         "(seconds to each object: " + ", ".join(
                             f"{k} {v:.1f}" for k, v in sorted(
                                 library.SOURCE_SECONDS.items(),
                                 key=lambda kv: -kv[1])) + ")"
                         if built is not None else "found an existing build")
            + f" ({library.library_path().name})")
        t0 = time.perf_counter()
        err, qgemm_share = check_kernels(dev)
        say(f"kernel checks passed in {time.perf_counter() - t0:.1f} s, "
            f"max abs err {err}; qgemm {qgemm_share:.4f} of its tolerance")
        batch_err = check_batched_kernels(dev)
        sr_err, sr_launches, sr_routes, sr_bias, sr_rne = check_chop_sr(dev)
        launches, routes, systems, forms, base_launches, policy = \
            run_main_path(dev)
        check_against_cpu(systems, dev)
        t0 = time.perf_counter()
        served = run_serve(dev, policy)
        say(f"serve phase (9): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cg = run_cg_path(dev)
        check_cg_against_cpu(cg["systems"], dev)
        say(f"CG phase (4c and its 4b checks): "
            f"{time.perf_counter() - t0:.1f} s")
        # Every chop form launched on one of the two paths (only CG runs
        # add_mul).
        from repro_torch.kernels.chop import FORMS
        check(forms | cg["forms"] == set(FORMS),
              f"chop forms never launched: {set(FORMS) - forms - cg['forms']}")
        sweep = run_tuned_blocking(dev)
        timing, chain, chop_extra = time_kernels(dev)
        sr_timing, sr_ref_times = time_chop_sr(dev)
        t0 = time.perf_counter()
        f64_err, f64_share = check_f64_kernels(dev)
        f64 = run_f64_path(dev)
        check_f64_against_cpu(f64["systems"], f64["cg_systems"], dev)
        f64_timing, f64_chain = time_f64_kernels(dev)
        say(f"float64 phase (10): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        served_http = run_http_rollout(dev, policy)
        say(f"HTTP phase (11): {time.perf_counter() - t0:.1f} s")
        # Phases 7 and 8 run before phase 6: a profile of a whole solve
        # (tens of thousands of device operations) can leave later
        # profiler sessions without device records.
        (launches["qmatmul"], routes["qmatmul"], err["qmatmul"],
         qmatmul_share, qmatmul_rows, qmatmul_extra) = run_qmatmul(dev)
        timing["qmatmul"] = qmatmul_rows[QMATMUL_ROW]
        err_small = check_flash_small(dev)
        (launches["flash_attention"], routes["flash_attention"],
         err["flash_attention"], flash_rows, flash_extra) = run_flash(dev)
        err["flash_attention"] = max(err["flash_attention"], err_small)
        timing["flash_attention"] = flash_rows[FLASH_ROW]
        lm = run_lm(dev)
        trained = run_train(dev)
        profile_solves(systems, cg["systems"], f64["cg_systems"], dev)
        batched = run_batched_program(dev)
        sharded = run_sharded(dev, card, policy, systems, cg["systems"])
        run_warmup(card)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    entries = {}
    for name, (source, replaces) in KERNELS.items():
        entries[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": launches[name],
                         "max_abs_err": err[name],
                         **dict(zip(TIMING_KEYS, timing[name])),
                         "routes": routes[name]}
    for name, (source, replaces) in F64_KERNELS.items():
        entries[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "carrier": "float64",
                         "launches": f64["launches"][name],
                         "max_abs_err": f64_err[name],
                         **dict(zip(TIMING_KEYS, f64_timing[name])),
                         "routes": f64["routes"][name]}
    for name in F64_KERNELS:
        entries[name]["http_launches"] = served_http["launches"].get(name, 0)
    entries["chop_sr"] = {
        "name": "chop_sr", "route": "cuda", "source": SR_SOURCE,
        "replaces": SR_REPLACES,
        "replaces_note": "the JAX package's chop_stochastic, plain jnp: no "
                         "TPU kernel; the port's first kernel beside them",
        "launches": sr_launches, "launches_from":
            f"chop_stochastic's unbiasedness run ({SR_DRAWS} draws)",
        "max_abs_err": sr_err,
        **dict(zip(TIMING_KEYS, sr_timing[str(SR_SHAPES[-1])])),
        "routes": sr_routes, "shape": f"x {SR_SHAPES[-1]}",
        **sr_ref_times[str(SR_SHAPES[-1])],
        "shapes": {k: {**dict(zip(TIMING_KEYS, v)), **sr_ref_times[k]}
                   for k, v in sr_timing.items()
                   if k != str(SR_SHAPES[-1])},
        "bias_share_of_rne_error": sr_bias / sr_rne}
    entries["chop_f64"]["shape"] = "x (512, 512)"
    entries["chop_f64"]["shapes"] = {"(512,)": dict(zip(
        TIMING_KEYS, f64_timing["chop_f64 (512,)"]))}
    entries["qgemm_f64"]["share_of_tolerance"] = f64_share
    entries["trisolve_f64"]["direction"] = "lower"
    entries["trisolve_f64"]["chain_bound"] = f64_chain["text"]
    for lower in (True, False):
        key = "lower" if lower else "upper"
        row = timing["trisolve" if lower else "trisolve upper"]
        entries["trisolve"].setdefault("directions", {})[key] = {
            **dict(zip(TIMING_KEYS, row)), "chain_bound_ms": chain[key]}
        row = f64_timing["trisolve_f64" if lower else "trisolve_f64 upper"]
        entries["trisolve_f64"].setdefault("directions", {})[key] = {
            **dict(zip(TIMING_KEYS, row)), "chain_bound_ms": f64_chain[key]}
    entries["chop"]["shape"] = "x (512, 512)"
    entries["chop"].update(chop_extra["chop"])
    entries["chop"]["shapes"] = {
        name[5:]: {**dict(zip(TIMING_KEYS, timing[name])),
                   **chop_extra[name]}
        for name in chop_extra if name != "chop"}
    entries["trisolve"]["direction"] = "lower"
    entries["trisolve"]["chain_bound"] = chain["text"]
    for name in SOLVER_KERNELS:
        for carrier_name in (name, name + "_f64"):
            dt = torch.float64 if carrier_name != name else torch.float32
            entries[carrier_name]["batch_max_abs_err"] = \
                batch_err[dt].get(name, 0.0)
            entries[carrier_name]["batch_launches"] = {
                case: {how: r["launches"].get(carrier_name, 0)
                       for how, r in row.items()}
                for case, row in batched.items()}
    for name in SOLVER_KERNELS:
        for carrier_name in (name, name + "_f64"):
            entries[carrier_name]["sharded_launches"] = sharded.get(
                carrier_name, 0)
        entries[name]["fixed_action_launches"] = base_launches[name]
        entries[name]["cg_launches"] = cg["launches"][name]
        entries[name]["cg_routes"] = cg["routes"][name]
        entries[name]["cg_fixed_action_launches"] = \
            cg["baseline_launches"][name]
        entries[name]["serve_launches"] = served["launches"][name]
    entries["qgemm"]["shapes"] = {
        name[6:]: dict(zip(TIMING_KEYS, timing[name]))
        for name in timing if name.startswith("qgemm K=")}
    entries["qgemm"]["sweep_ms"] = sweep
    entries["qgemm"]["share_of_tolerance"] = qgemm_share
    entries["qmatmul"]["share_of_tolerance"] = qmatmul_share
    entries["qmatmul"]["format"] = QMATMUL_ROW
    entries["qmatmul"]["formats"] = {
        name: {**dict(zip(TIMING_KEYS, row)), **qmatmul_extra[name]}
        for name, row in qmatmul_rows.items()}
    entries["flash_attention"]["phase8_launches"] = \
        entries["flash_attention"]["launches"]
    entries["flash_attention"]["launches"] = lm["a"]["launches"] + \
        lm["b"]["launches"]
    entries["flash_attention"]["lm_launches"] = {
        "forward_bf16_full_depth": lm["a"]["kinds"],
        f"forward_f32_{LM_DEPTH}_layers": lm["b"]["kinds"],
        "smoke_forwards": lm["d"]["flash"]}
    entries["flash_attention"]["launches"] += \
        trained["a"]["flash_a_step"] * trained["a"]["steps"]
    entries["flash_attention"]["train_launches"] = {
        "granite_full_step": trained["a"]["flash_a_step"],
        "granite_full_steps": trained["a"]["steps"],
        "granite_full_gradient_check": trained["a"]["grad_flash"],
        "smoke_steps_f32": trained["b"]["flash"],
        "smoke_emulated_step": trained["b"]["emulated_flash"]}
    entries["chop"]["train_launches"] = trained["b"]["chop"]
    entries["flash_attention"]["lm_share_of_tolerance"] = lm["a"]["shares"]
    entries["flash_attention"]["lm_forward_device_ms"] = \
        lm["a"]["flash_device_ms"]
    entries["flash_attention"]["lm_forward_bound_ms"] = \
        lm["a"]["flash_bound_ms"]
    entries["chop"]["lm_launches"] = lm["b"]["chop_launches"]
    entries["flash_attention"]["shape"] = FLASH_CASES[FLASH_ROW][0]
    entries["flash_attention"]["flash_route"] = \
        flash_extra[FLASH_CASES[FLASH_ROW][0]]["flash_route"]
    entries["flash_attention"]["cases"] = {
        case[0]: {**dict(zip(TIMING_KEYS, row)), **flash_extra[case[0]]}
        for case, row in zip(FLASH_CASES, flash_rows)}
    say(card)
    say(json.dumps({"kernels": list(entries.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
