"""Blockwise int8 quantization of optimizer moments (port of
`repro.train.quantize`).

Absmax scheme: per contiguous block of `block` elements (on the flattened
tensor, the tail padded with zeros), code = round(x / s * 127) with
s = absmax(block), rounded half to even as `jnp.round` and `torch.round`
both do. So codes and scales equal the JAX package's for the same float32
input. Used for the 8-bit Adam moments (`train.optimizer`) and the
cross-pod gradient compression (`train.grad_sync`)."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class QTensor(NamedTuple):
    codes: torch.Tensor     # int8, original shape
    scales: torch.Tensor    # float32, (n_blocks,)
    # static metadata lives in the shapes; block is implied by scales size


def _blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    return F.pad(flat, (0, -flat.shape[0] % block)).view(-1, block)


def quantize_int8(x: torch.Tensor, block: int = 256) -> QTensor:
    blocks = _blocks(x.float().reshape(-1), block)
    scales = blocks.abs().amax(dim=1)
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(blocks / safe[:, None] * 127.0),
                        -127, 127).to(torch.int8)
    return QTensor(codes.view(-1)[:x.numel()].view(x.shape), scales)


def dequantize_int8(q: QTensor, block: int = 256) -> torch.Tensor:
    flat = _blocks(q.codes.float().reshape(-1), block)
    out = flat * (q.scales[:, None] / 127.0)
    return out.view(-1)[:q.codes.numel()].view(q.codes.shape)
