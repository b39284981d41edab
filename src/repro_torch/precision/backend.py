"""Precision backends of the torch port, chosen by device (DESIGN.md §6).

Every precision action is applied by four ops on the solver hot path:
an elementwise round-to-format (`chop`), a fused chopped matvec
(`chop_mv`), a fused chopped matmul (`chop_matmul`, the blocked-LU
trailing update) and a blocked triangular substitution
(`chop_trisolve`). Two backends implement them:

  * `TorchBackend` — the plain torch versions (`precision.chop` and the
    kernels' `ref` modules), on any float carrier. It keeps the
    caller's carrier unless `carrier_dtype` is given, like the JAX
    package's `JnpBackend`. It serves the CPU.
  * `CudaBackend` — the hand-written CUDA kernels (`kernels/chop`,
    `kernels/qmatmul`, `kernels/trisolve`), float32 carrier, like the
    JAX package's `PallasBackend`. It serves the GPU. Every `chop` of a
    CUDA tensor launches the chop kernel, whatever its size.

There is no registry, environment variable or fallback between them:
`backend_for(device)` picks one from the device, and an entry point
asked for the GPU on a host without one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import chop as _chop


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

    def chop(self, x, fmt_id):
        return _chop.chop(x, fmt_id)

    def chop_mv(self, A, v, fmt_id, *, chop_output: bool = True):
        from repro_torch.kernels.qmatmul.ref import qmv_ref
        return qmv_ref(A, v, fmt_id, chop_out=chop_output)

    def chop_matmul(self, a, b, fmt_id, *, chop_output: bool = True):
        from repro_torch.kernels.qmatmul.ref import qgemm_ref
        return qgemm_ref(a, b, fmt_id, chop_out=chop_output)

    def chop_trisolve(self, Lu, b, fmt_id, *, lower: bool,
                      block: int = 128):
        from repro_torch.kernels.trisolve.ref import trisolve_ref
        return trisolve_ref(Lu, b, fmt_id, lower=lower, block=block)


@dataclasses.dataclass(frozen=True)
class CudaBackend(PrecisionBackend):
    """The CUDA kernels, float32 carrier (the GPU backend).

    The wrappers launch their kernel for a CUDA tensor or raise; they run
    the plain version only for a tensor that lies on the CPU."""

    name: str = dataclasses.field(default="cuda", init=False)
    carrier_dtype: Optional[torch.dtype] = torch.float32

    def chop(self, x, fmt_id):
        from repro_torch.kernels.chop import chop_op
        return chop_op(x.contiguous(), fmt_id)

    def chop_mv(self, A, v, fmt_id, *, chop_output: bool = True):
        from repro_torch.kernels.qmatmul import qmv_op
        return qmv_op(A.contiguous(), v.contiguous(), fmt_id,
                      chop_out=chop_output)

    def chop_matmul(self, a, b, fmt_id, *, chop_output: bool = True):
        from repro_torch.kernels.qmatmul import qgemm_op
        return qgemm_op(a.contiguous(), b.contiguous(), fmt_id,
                        chop_out=chop_output)

    def chop_trisolve(self, Lu, b, fmt_id, *, lower: bool,
                      block: int = 128):
        from repro_torch.kernels.trisolve import trisolve_op
        return trisolve_op(Lu.contiguous(), b.contiguous(), fmt_id,
                           lower=lower, block=block)


def backend_for(device, carrier_dtype=None) -> PrecisionBackend:
    """The backend a device uses: `CudaBackend` for CUDA (float32 carrier;
    the kernels take no other), `TorchBackend(carrier_dtype)` for the CPU
    (None keeps the caller's carrier)."""
    dev = resolve_device(device)
    carrier_dtype = _as_dtype(carrier_dtype)
    if dev.type == "cuda":
        if carrier_dtype not in (None, torch.float32):
            raise ValueError("the CUDA kernels take the float32 carrier "
                             f"only; got {carrier_dtype}")
        return CudaBackend()
    return TorchBackend(carrier_dtype)
