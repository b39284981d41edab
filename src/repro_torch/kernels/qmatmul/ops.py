"""Wrappers of the CUDA chopped-matvec and chopped-GEMM kernels
(`csrc/qmv.cu`, `csrc/qgemm.cu`), the ports of
`repro/kernels/qmatmul/qmatmul.py::qmv_pallas` and of `qmatmul_pallas`
as `ops.qgemm_op` calls it (single K block).

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version. Both kernels take every K: qmv reduces over the lane-padded Kp
like `ref.qmv_ref`, qgemm has no upper bound on K.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library
from repro_torch.precision.chop import fmt_params

from .ref import qgemm_ref, qmv_ref


def qmv_op(a: torch.Tensor, v: torch.Tensor, fmt_id, *,
           chop_out: bool = True) -> torch.Tensor:
    """Fused chopped matvec of (M, K) x (K,) float32 operands -> (M,)."""
    if a.device.type == "cpu":
        return qmv_ref(a, v, fmt_id, chop_out=chop_out)
    library.check_cuda_f32("qmv", a, v)
    if a.dim() != 2 or v.dim() != 1 or v.shape[0] != a.shape[1]:
        raise ValueError(f"qmv: shapes {tuple(a.shape)} x {tuple(v.shape)}")
    M, K = a.shape
    out = torch.empty(M, dtype=a.dtype, device=a.device)
    if M == 0:
        return out
    t, emin, xmax_bits, sat = fmt_params(fmt_id, torch.float32)
    rc = library.load().repro_qmv_f32(
        a.data_ptr(), v.data_ptr(), out.data_ptr(), M, K, K, t, emin,
        xmax_bits, int(sat), int(chop_out), library.stream_of(a))
    library.check(rc, "qmv")
    library.count_launch("qmv")
    return out


def qgemm_op(a: torch.Tensor, b: torch.Tensor, fmt_id, *,
             chop_out: bool = True) -> torch.Tensor:
    """Chopped GEMM of (M, K) x (K, N) float32 operands -> (M, N)."""
    if a.device.type == "cpu":
        return qgemm_ref(a, b, fmt_id, chop_out=chop_out)
    library.check_cuda_f32("qgemm", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"qgemm: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    t, emin, xmax_bits, sat = fmt_params(fmt_id, torch.float32)
    rc = library.load().repro_qgemm_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, t, emin,
        xmax_bits, int(sat), int(chop_out), library.stream_of(a))
    library.check(rc, "qgemm")
    library.count_launch("qgemm")
    return out
