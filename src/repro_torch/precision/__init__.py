"""Precision substrate of the torch port: format descriptors, the plain
round-to-format versions, and the device-chosen backend (DESIGN.md §6).

The backends sit above the kernels, whose wrappers and plain versions
import this package's `chop` and `formats`; so the backend's names load
on first use (`backend_for`, ...), and importing a kernel module never
imports the backends."""
from .chop import (chop, chop_matmul, chop_static, chop_stochastic,
                   chop_tree, fma_barrier, fmt_params, rounding_unit,
                   simulate_dtype, stochastic_bits, tree_sum)
from .formats import (BF16, E4M3, E5M2, FORMAT_ID, FORMAT_LIST, FORMATS, FP16,
                      FP32, FP64, SOLVER_LADDER, SOLVER_LADDER_FP8, TF32,
                      TPU_LADDER, FloatFormat, format_id, get_format,
                      runtime_tables)
from .rows import RowFormats, as_rows, row_formats

__all__ = [
    "chop", "chop_matmul", "chop_static", "chop_stochastic", "chop_tree",
    "fma_barrier", "fmt_params", "tree_sum", "rounding_unit",
    "simulate_dtype", "stochastic_bits", "runtime_tables",
    "RowFormats", "as_rows", "row_formats",
    "FloatFormat", "get_format", "format_id",
    "FORMATS", "FORMAT_LIST", "FORMAT_ID", "SOLVER_LADDER",
    "SOLVER_LADDER_FP8", "TPU_LADDER",
    "BF16", "FP16", "TF32", "FP32", "FP64", "E4M3", "E5M2",
    "PrecisionBackend", "TorchBackend", "CudaBackend", "backend_for",
    "resolve_device",
]

_BACKEND_NAMES = ("CudaBackend", "PrecisionBackend", "TorchBackend",
                  "backend_for", "resolve_device")


def __getattr__(name):
    if name in _BACKEND_NAMES:
        from . import backend
        return getattr(backend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
