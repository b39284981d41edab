"""Per-row format ids of a batch of solves.

A batched solve (`solvers.gmres_ir_batch`, `solvers.cg_ir_batch`) runs
every row of a bucket in one program, each row under its own precision
action. Each of the action's four roles is then a column of format ids,
one per row: `RowFormats` holds such a column twice, on the host (numpy
int32, from which the GEMM's route and the plain versions' grouping are
chosen without a device read) and on the device (a (B,) int32 tensor,
which the kernels index by the row of each element, made at the first
launch that needs it and then kept).

The precision ops (`backend.PrecisionBackend`, the kernel wrappers and
their plain versions) take a format either as one int, the whole operand
in one format as before, or per row, as a `RowFormats` or a (B,) integer
tensor: the operand's dim 0 is then the batch, and element e belongs to
row e's index along it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .formats import FORMAT_LIST


class RowFormats:
    """The format ids of the B rows of a batch (see the module
    docstring). `uniform` is the one id every row shares, or None."""

    __slots__ = ("host", "device", "uniform", "_ids", "cache")

    def __init__(self, ids, device=None):
        host = np.asarray(ids, dtype=np.int32).reshape(-1)
        if host.size and (host.min() < 0 or host.max() >= len(FORMAT_LIST)):
            raise ValueError(f"format ids {host.tolist()} outside "
                             f"[0, {len(FORMAT_LIST)})")
        self.host = host
        self.device = torch.device("cpu" if device is None else device)
        first = int(host[0]) if host.size else 0
        self.uniform: Optional[int] = (first if host.size == 0
                                       or bool((host == first).all())
                                       else None)
        self._ids = None
        self.cache = {}     # what the plain versions derive from the ids

    def __len__(self) -> int:
        return int(self.host.size)

    def __repr__(self) -> str:
        return f"RowFormats({self.host.tolist()}, device={self.device})"

    @property
    def ids(self) -> torch.Tensor:
        """The ids as a (B,) int32 tensor on `device` (one copy, made at
        the first call)."""
        if self._ids is None:
            self._ids = torch.as_tensor(self.host, device=self.device)
        return self._ids

    def ids_on(self, device) -> torch.Tensor:
        """The ids as a (B,) int32 tensor on `device` (kept once made)."""
        device = torch.device(device)
        if device == self.device or (device.type == self.device.type
                                     and device.index is None):
            return self.ids
        self.device, self._ids = device, None
        return self.ids


def as_rows(fmt_id, device=None) -> Optional[RowFormats]:
    """None for one int format id (the whole operand in one format); the
    `RowFormats` of per-row ids: a `RowFormats` as it is, a (B,) integer
    tensor or array read once into one."""
    if isinstance(fmt_id, RowFormats):
        return fmt_id
    if isinstance(fmt_id, (int, np.integer)):
        return None
    if torch.is_tensor(fmt_id):
        if fmt_id.dim() == 0:
            return None
        if fmt_id.dim() != 1 or fmt_id.dtype.is_floating_point:
            raise TypeError("per-row format ids are a (B,) integer tensor, "
                            f"not {fmt_id.dtype} of shape "
                            f"{tuple(fmt_id.shape)}")
        rows = RowFormats(fmt_id.detach().cpu().numpy(),
                          fmt_id.device if device is None else device)
        if fmt_id.device == rows.device:
            rows._ids = fmt_id.to(torch.int32)
        return rows
    arr = np.asarray(fmt_id)
    if arr.ndim == 0:
        return None
    return RowFormats(arr, device)


def row_formats(fmt_id, batch: int, device=None) -> RowFormats:
    """Per-row formats of a batch of `batch` rows: an int repeated, or
    per-row ids (`as_rows`) of that length."""
    rows = as_rows(fmt_id, device)
    if rows is None:
        rows = RowFormats(np.full(batch, int(fmt_id), np.int32), device)
    if len(rows) != batch:
        raise ValueError(f"{len(rows)} format ids for a batch of {batch}")
    return rows


def check_rows(rows: RowFormats, shape, what: str) -> None:
    """Raise unless a result of `shape` has the rows' batch as dim 0."""
    if len(shape) == 0 or shape[0] != len(rows):
        raise ValueError(f"{what}: {len(rows)} per-row format ids for a "
                         f"result of shape {tuple(shape)}; dim 0 is the "
                         "batch")
