"""Wrappers of the CUDA chopped-matvec and chopped-GEMM kernels
(`csrc/qmv.cu`, `csrc/qgemm.cu`), the ports of
`repro/kernels/qmatmul/qmatmul.py::qmv_pallas` and of `qmatmul_pallas`
as `ops.qgemm_op` (single K block) and `ops.qmatmul_op` (K blocks of
`bk`) call it. `qgemm_op` and `qmatmul_op` launch the same kernel; each
counts its launches under its own name.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version. Every kernel takes every K: qmv reduces over the lane-padded Kp
like `ref.qmv_ref`, the GEMM has no upper bound on K.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import library
from repro_torch.precision.chop import fmt_params

from .ref import qgemm_ref, qmatmul_ref_blocked, qmv_ref

DEFAULT_BK = 256    # the JAX op's default K block (`qmatmul.DEFAULT_BK`)


def qmv_op(a: torch.Tensor, v: torch.Tensor, fmt_id, *,
           chop_out: bool = True) -> torch.Tensor:
    """Fused chopped matvec of (M, K) x (K,) float32 operands -> (M,)."""
    if a.device.type == "cpu":
        return qmv_ref(a, v, fmt_id, chop_out=chop_out)
    library.check_cuda("qmv", a, v)
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
    library.check_cuda("qgemm", a, b)
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
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, max(K, 1), t,
        emin, xmax_bits, int(sat), int(chop_out), library.stream_of(a))
    library.check(rc, "qgemm")
    library.count_launch("qgemm")
    return out


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def qmatmul_op(a: torch.Tensor, b: torch.Tensor, fmt_id, *,
               chop_out: bool = True, bm: int | None = None,
               bn: int | None = None, bk: int | None = None) -> torch.Tensor:
    """Chopped matmul of (M, K) x (K, N) operands of any float dtype ->
    (M, N) float32, summed in float32 per K block of `bk`, the blocks
    added in order (`ref.qmatmul_ref_blocked`).

    `bk` is chosen as the JAX op chooses it, min(bk or 256,
    max(128, next_pow2(K))); it decides which products share a partial
    sum, so it is part of the result. `bm` and `bn` are accepted for the
    JAX op's signature and ignored: they only tile M and N there."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"qmatmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if bk is not None and int(bk) < 1:
        raise ValueError(f"qmatmul: bk={bk} must be positive")
    M, K = a.shape
    N = b.shape[1]
    bk = min(int(bk or DEFAULT_BK), max(128, _next_pow2(max(K, 1))))
    if a.device.type == "cpu":
        pad = -K % bk
        return qmatmul_ref_blocked(F.pad(a.to(torch.float32), (0, pad)),
                                   F.pad(b.to(torch.float32), (0, 0, 0, pad)),
                                   fmt_id, bk, chop_out=chop_out)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    library.check_cuda("qmatmul", a, b)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    t, emin, xmax_bits, sat = fmt_params(fmt_id, torch.float32)
    rc = library.load().repro_qgemm_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, bk, t, emin,
        xmax_bits, int(sat), int(chop_out), library.stream_of(a))
    library.check(rc, "qmatmul")
    library.count_launch("qmatmul")
    return out
