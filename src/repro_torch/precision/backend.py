"""Precision backends of the torch port, chosen by device (DESIGN.md §6).

Every precision action is applied by five ops on the solver hot path:
an elementwise round-to-format (`chop`); the same rounding fused with
the arithmetic that produces its operand and the store that takes its
result (`chop_expr`: `chop(a op b)` for op in add, sub, mul, div,
`chop(a - chop(b * c))`, `chop(chop(a - b) / c)`,
`chop(a + chop(b * c))`, into a slot or a
block given as `out`, with positions outside a live range stored as +0);
a fused chopped matvec (`chop_mv`); a fused chopped matmul
(`chop_matmul`, the blocked-LU trailing update); and a blocked
triangular substitution (`chop_trisolve`). Two backends implement them:

  * `TorchBackend` — the plain torch versions (`precision.chop` and the
    kernels' `ref` modules), on any float carrier. It keeps the
    caller's carrier unless `carrier_dtype` is given, like the JAX
    package's `JnpBackend`. It serves the CPU.
  * `CudaBackend` — the hand-written CUDA kernels (`kernels/chop`,
    `kernels/qmatmul`, `kernels/trisolve`), on the float32 carrier by
    default, like the JAX package's `PallasBackend`, or on the float64
    one (`carrier_dtype=torch.float64`: the kernels' float64
    instantiations, the paper's own x64 setting). It serves the GPU.
    Every `chop` and `chop_expr` of a CUDA tensor launches the chop
    kernel, whatever its size: `chop_expr` evaluates its whole form in
    that one launch, as XLA fuses a short rounding into its producer and
    consumer in the JAX package.

Every op takes its format as one id or as one id per row of a batch
(`precision.rows`: a `RowFormats`, or a (B,) integer tensor): the
operands' dim 0 is then the batch, every row in its own format. The
solver keeps the ids on the host too, so that a route chosen by the
format (the GEMM's) needs no device read; on the GPU one launch covers
every row (the GEMM one launch per route present in the batch), on the
CPU the plain versions group the rows by format.

There is no registry, environment variable or fallback between them:
`backend_for(device, carrier_dtype)` picks one from the device, and an
entry point asked for the GPU on a host without one raises. No path
changes the carrier on its own: a float64 CUDA tensor launches a float64
kernel, a float32 one a float32 kernel, and any other raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import library
from repro_torch.kernels.chop.ops import chop_expr_op, chop_op
from repro_torch.kernels.chop.ref import chop_expr_ref
from repro_torch.kernels.qmatmul.ops import qgemm_op, qmv_op
from repro_torch.kernels.qmatmul.ref import qgemm_ref, qmv_ref
from repro_torch.kernels.trisolve.ops import trisolve_op
from repro_torch.kernels.trisolve.ref import trisolve_ref

from .chop import chop as _plain_chop


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (explicitly or by default) and
    no CUDA device is present; never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain torch versions on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _as_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


class PrecisionBackend:
    """Interface shared by the two backends. `carrier_dtype` is the float
    dtype the solver entry points coerce operands to (None = keep the
    caller's carrier)."""

    name: str = "abstract"
    carrier_dtype: Optional[torch.dtype] = None

    def chop(self, x, fmt_id):
        raise NotImplementedError

    def chop_expr(self, form, a, b=None, c=None, *, fmt_id, out=None,
                  live=None):
        """One of the chop kernel's forms (`kernels.chop.FORMS`), with
        torch's broadcasting (up to two dimensions on the GPU, after the
        batch with per-row formats): the result, or `out` filled with it;
        `live = (lo, hi)` stores +0 outside positions [lo, hi) of a 1-D
        result (with per-row formats, of each row of a (B, N) one)."""
        raise NotImplementedError

    def chop_mv(self, A, v, fmt_id, *, chop_output: bool = True):
        raise NotImplementedError

    def chop_matmul(self, a, b, fmt_id, *, chop_output: bool = True):
        raise NotImplementedError

    def chop_trisolve(self, Lu, b, fmt_id, *, lower: bool,
                      block: int = 128):
        """Blocked triangular substitution on the combined LU matrix
        (strictly-lower + unit diagonal when `lower`, upper triangle
        including the diagonal otherwise) — DESIGN.md §6.4."""
        raise NotImplementedError

    def coerce(self, *tensors):
        """Cast float tensors to this backend's carrier dtype (no-op when
        `carrier_dtype` is None)."""
        dt = _as_dtype(self.carrier_dtype)
        out = tuple(t.to(dt) if dt is not None and torch.is_floating_point(t)
                    else t for t in tensors)
        return out if len(out) != 1 else out[0]


@dataclasses.dataclass(frozen=True)
class TorchBackend(PrecisionBackend):
    """The plain torch versions, on any float carrier (the CPU backend)."""

    name: str = dataclasses.field(default="torch", init=False)
    carrier_dtype: Optional[torch.dtype] = None

    chop = staticmethod(_plain_chop)
    chop_expr = staticmethod(chop_expr_ref)

    def chop_mv(self, A, v, fmt_id, *, chop_output: bool = True):
        return qmv_ref(A, v, fmt_id, chop_out=chop_output)

    def chop_matmul(self, a, b, fmt_id, *, chop_output: bool = True):
        return qgemm_ref(a, b, fmt_id, chop_out=chop_output)

    def chop_trisolve(self, Lu, b, fmt_id, *, lower: bool,
                      block: int = 128):
        return trisolve_ref(Lu, b, fmt_id, lower=lower, block=block)


@dataclasses.dataclass(frozen=True)
class CudaBackend(PrecisionBackend):
    """The CUDA kernels (the GPU backend), on the carrier `carrier_dtype`:
    float32 (the default) or float64.

    The wrappers launch their kernel for a CUDA tensor or raise; they run
    the plain version only for a tensor that lies on the CPU."""

    name: str = dataclasses.field(default="cuda", init=False)
    carrier_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.carrier_dtype not in library.CARRIERS:
            raise ValueError("the CUDA kernels take the float32 and the "
                             f"float64 carrier; got {self.carrier_dtype}")

    # The wrappers themselves: the hot path's most frequent calls pay
    # for no extra Python frame.
    chop = staticmethod(chop_op)
    chop_expr = staticmethod(chop_expr_op)

    def chop_mv(self, A, v, fmt_id, *, chop_output: bool = True):
        return qmv_op(A.contiguous(), v, fmt_id, chop_out=chop_output)

    def chop_matmul(self, a, b, fmt_id, *, chop_output: bool = True):
        return qgemm_op(a.contiguous(), b.contiguous(), fmt_id,
                        chop_out=chop_output)

    def chop_trisolve(self, Lu, b, fmt_id, *, lower: bool,
                      block: int = 128):
        return trisolve_op(Lu.contiguous(), b.contiguous(), fmt_id,
                           lower=lower, block=block)


def backend_for(device, carrier_dtype=None) -> PrecisionBackend:
    """The backend a device uses: `CudaBackend(carrier_dtype)` for CUDA
    (float32, the default, or float64; any other carrier raises),
    `TorchBackend(carrier_dtype)` for the CPU (None keeps the caller's
    carrier)."""
    dev = resolve_device(device)
    carrier_dtype = _as_dtype(carrier_dtype)
    if dev.type == "cuda":
        return CudaBackend(torch.float32 if carrier_dtype is None
                           else carrier_dtype)
    return TorchBackend(carrier_dtype)
