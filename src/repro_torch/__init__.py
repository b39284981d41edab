"""PyTorch + CUDA port of the precision-autotuning system.

Mirrors `repro/` path for path (`precision/`, `kernels/<name>/`,
`solvers/`, `core/`, `tasks/`, `data/`, and the serving stack's
`service/`, `obs/` and `faults/`); the CUDA sources of the kernels live
in `csrc/`. The package imports torch, numpy and scipy, never jax and
nothing of the JAX package. Entry points run on CUDA unless the caller
passes `device="cpu"`.
"""
