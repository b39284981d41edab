"""Cross-pod gradient synchronization with bandit-controlled compression
(port of `repro.train.grad_sync`).

The cross-pod axis is the low-bandwidth link and syncs explicitly here,
so its format is a precision knob:

  fp32 : all-reduce sum over "pod", then divide by the pods
  bf16 : cast before the all-reduce (halves the collective's bytes);
         the sum and the divide in bf16, then back to float32
  int8 : blockwise-quantized all-gather of codes and scales, then each
         pod's dequantization and the average, in pod order (a quarter
         of the bytes plus scales; summing int8 codes directly would
         overflow and mis-round, so reduce-after-gather is the correct
         primitive)

The reduction runs over the process group of the mesh dimension `axis`
(`mesh.get_group(axis)` of a `DeviceMesh`), or, with no mesh, over the
whole default group, each rank one pod. Every rank returns the same
tensor. The JAX package reduces its bf16 sum and its fp32 sum left to
right over the pods; gloo and NCCL may sum in another order beyond two
pods, so there the result agrees with the reference to the rounding of
a sum, not bit for bit (int8's sum is this module's own, in pod order).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.transformer import tree_map

from .quantize import QTensor, dequantize_int8, quantize_int8


def sync_leaf(g: torch.Tensor, mode: str, axis: str = "pod",
              mesh=None) -> torch.Tensor:
    group = None if mesh is None else mesh.get_group(axis)
    n = dist.get_world_size(group)
    if mode == "fp32":
        out = g.float().clone()
        dist.all_reduce(out, group=group)
        return out / n
    if mode == "bf16":
        out = g.to(torch.bfloat16)
        dist.all_reduce(out, group=group)
        return (out / n).float()
    if mode == "int8":
        q = quantize_int8(g, block=256)
        codes = [torch.empty_like(q.codes) for _ in range(n)]
        scales = [torch.empty_like(q.scales) for _ in range(n)]
        dist.all_gather(codes, q.codes, group=group)
        dist.all_gather(scales, q.scales, group=group)
        deq = [dequantize_int8(QTensor(codes[i], scales[i]), 256)
               for i in range(n)]
        return sum(deq) / n
    raise ValueError(mode)


def sync_grads(grads, mode: str, axis: str = "pod", mesh=None):
    """`sync_leaf` over every tensor of a gradient tree (a None leaf, a
    gradient the loss does not reach, stays None). Every rank walks the
    same tree in the same order, so the collectives pair up."""
    return tree_map(lambda g: None if g is None
                    else sync_leaf(g, mode, axis, mesh), grads)
