"""Floating-point format descriptors (paper Table 1, plus ML fp8 formats).

Each format is described by:
  t     — number of significand bits including the implicit leading bit
  emin  — exponent of the smallest positive normalized number
  emax  — exponent of the largest finite number
  xmax  — largest finite value (may deviate from (2-2^(1-t))·2^emax, e.g. OCP e4m3)
  saturate — on overflow, clamp to ±xmax instead of rounding to ±inf

Formats are addressable two ways:
  * by name / FloatFormat object;
  * by integer format id indexing the runtime tables below
    (precision-as-runtime-data: one compiled kernel applies any format,
    so the bandit explores actions without rebuilding anything).

A copy of `repro.precision.formats` with its table helper
`runtime_tables` on torch tensors: the torch package never imports the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    name: str
    t: int          # significand bits incl. implicit bit
    emin: int
    emax: int
    xmax: float
    saturate: bool = False
    native_dtype: Optional[str] = None  # dtype name where hardware has it

    @property
    def unit_roundoff(self) -> float:
        return 2.0 ** (-self.t)

    @property
    def xmin(self) -> float:
        """Smallest positive normalized value."""
        return 2.0 ** self.emin

    @property
    def xmin_sub(self) -> float:
        """Smallest positive subnormal value."""
        return 2.0 ** (self.emin - (self.t - 1))

    @property
    def significand_bits(self) -> int:
        return self.t


def _ieee_xmax(t: int, emax: int) -> float:
    return float((2.0 - 2.0 ** (1 - t)) * 2.0 ** emax)


# ---------------------------------------------------------------------------
# Registry. Order defines the integer format id AND the precision ordering
# used by the paper's action-space reduction (Eq. 11): ids are sorted by
# increasing significand bits within the solver ladder.
# ---------------------------------------------------------------------------

E4M3 = FloatFormat("e4m3", t=4, emin=-6, emax=8, xmax=448.0, saturate=True)
E5M2 = FloatFormat("e5m2", t=3, emin=-14, emax=15, xmax=_ieee_xmax(3, 15), saturate=True)
BF16 = FloatFormat("bf16", t=8, emin=-126, emax=127, xmax=_ieee_xmax(8, 127),
                   native_dtype="bfloat16")
FP16 = FloatFormat("fp16", t=11, emin=-14, emax=15, xmax=_ieee_xmax(11, 15),
                   native_dtype="float16")
TF32 = FloatFormat("tf32", t=11, emin=-126, emax=127, xmax=_ieee_xmax(11, 127))
FP32 = FloatFormat("fp32", t=24, emin=-126, emax=127, xmax=_ieee_xmax(24, 127),
                   native_dtype="float32")
FP64 = FloatFormat("fp64", t=53, emin=-1022, emax=1023,
                   xmax=_ieee_xmax(53, 1023), native_dtype="float64")

# Id order: increasing significand bits (ties broken by range).
FORMAT_LIST: List[FloatFormat] = [E5M2, E4M3, BF16, FP16, TF32, FP32, FP64]
FORMATS: Dict[str, FloatFormat] = {f.name: f for f in FORMAT_LIST}
FORMAT_ID: Dict[str, int] = {f.name: i for i, f in enumerate(FORMAT_LIST)}

# The paper's solver precision ladder (Section 5.1), ordered by increasing
# significand bits — the ordering relation of Eq. 11.
SOLVER_LADDER: List[str] = ["bf16", "tf32", "fp32", "fp64"]
# The fp8-extended solver ladder: the ML fp8 formats prepended below the
# paper's four rungs (still ordered by significand bits — e5m2 t=3,
# e4m3 t=4). Their saturating overflow (clamp to +-xmax instead of inf)
# is what makes u_f = fp8 a *viable* arm on well-conditioned systems:
# an overflowed LU clamps rather than poisoning the factors with inf,
# so the refinement loop can still converge and the bandit can learn
# where the cheap factorization pays off.
SOLVER_LADDER_FP8: List[str] = ["e5m2", "e4m3"] + SOLVER_LADDER
# The TPU-native ladder used by the LM-framework integration (DESIGN.md §3.3).
TPU_LADDER: List[str] = ["e4m3", "bf16", "fp32"]


def get_format(fmt: Union[str, FloatFormat, int]) -> FloatFormat:
    if isinstance(fmt, FloatFormat):
        return fmt
    if isinstance(fmt, (int, np.integer)):
        return FORMAT_LIST[int(fmt)]
    return FORMATS[fmt]


def format_id(fmt: Union[str, FloatFormat, int]) -> int:
    if isinstance(fmt, (int, np.integer)):
        return int(fmt)
    return FORMAT_ID[get_format(fmt).name]


# ---------------------------------------------------------------------------
# Runtime tables, indexed by format id. The chop kernel reads its
# parameters from these rows, so one build serves every format.
# ---------------------------------------------------------------------------

FMT_T = np.array([f.t for f in FORMAT_LIST], dtype=np.int32)
FMT_EMIN = np.array([f.emin for f in FORMAT_LIST], dtype=np.int32)
FMT_EMAX = np.array([f.emax for f in FORMAT_LIST], dtype=np.int32)
FMT_XMAX = np.array([f.xmax for f in FORMAT_LIST], dtype=np.float64)
FMT_SATURATE = np.array([f.saturate for f in FORMAT_LIST], dtype=np.bool_)
FMT_UNIT_ROUNDOFF = np.array([f.unit_roundoff for f in FORMAT_LIST],
                             dtype=np.float64)



def runtime_tables(dtype=torch.float32, device=None):
    """The format parameter tables as tensors (t, emin, emax, xmax,
    saturate), indexed by format id: int32, int32, int32, `dtype` (an
    xmax beyond its range reads inf) and bool, on `device` (torch's
    default device when None)."""
    return (
        torch.as_tensor(FMT_T, device=device),
        torch.as_tensor(FMT_EMIN, device=device),
        torch.as_tensor(FMT_EMAX, device=device),
        torch.as_tensor(FMT_XMAX, device=device).to(dtype),
        torch.as_tensor(FMT_SATURATE, device=device),
    )
