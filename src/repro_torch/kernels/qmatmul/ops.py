"""Wrappers of the CUDA chopped-matvec and chopped-GEMM kernels
(`csrc/qmv.cu`, `csrc/qgemm.cu`), the ports of
`repro/kernels/qmatmul/qmatmul.py::qmv_pallas` and of `qmatmul_pallas`
as `ops.qgemm_op` (single K block) and `ops.qmatmul_op` (K blocks of
`bk`) call it. `qgemm_op` and `qmatmul_op` make the same call into the
GEMM's C launcher; each counts its calls under its own name.

The GEMM's launcher takes the route that `ROUTES` gives the format id: on
the tensor cores it launches two device kernels (the chop-and-pack pass,
then the TMA + wgmma GEMM), on the FFMA route one. A launcher call counts
as one launch either way. The matvec takes the route that `QMV_ROUTES`
gives its lane-padded K: "shfl" (the tree in registers and shuffles) or
"smem" (the tree in shared memory). A failed launch raises: no route
gives way to another or to the plain version.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version. Every kernel takes every K: qmv reduces over the lane-padded Kp
like `ref.qmv_ref`, the GEMM has no upper bound on K.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import library
from repro_torch.kernels.chop import chop_op

from .ref import LANE, padded_k, qgemm_ref, qmatmul_ref_blocked, qmv_ref

DEFAULT_BK = 256    # the JAX op's default K block (`qmatmul.DEFAULT_BK`)

# Format id -> (operand type, route) of the GEMM. The chopped values of
# e5m2, e4m3 and bf16 are exact in bf16, of fp16 in fp16, of tf32 in
# tf32 (float32 with the low 13 mantissa bits zero), so their products
# run on the tensor cores; fp32 and fp64 go to the FFMA kernel. e5m2 and
# e4m3 are fed as bf16, not to the fp8 tensor cores (see `qgemm.cu`).
ROUTES = {
    0: (torch.bfloat16, "wgmma"),   # e5m2
    1: (torch.bfloat16, "wgmma"),   # e4m3
    2: (torch.bfloat16, "wgmma"),   # bf16
    3: (torch.float16, "wgmma"),    # fp16
    4: (torch.float32, "wgmma"),    # tf32
    5: (torch.float32, "ffma"),     # fp32
    6: (torch.float32, "ffma"),     # fp64
}
# The launcher's route codes (`enum Route` in qgemm.cu).
_FFMA = 0
_WGMMA = {torch.bfloat16: 1, torch.float16: 2, torch.float32: 3}
K_TILE_BYTES = 128  # the wgmma kernel's K tile
FFMA_K_TILE = 16    # the FFMA kernel's K tile (`FM_BK` in qgemm.cu)

# Lane-padded K -> route of the matvec: "shfl" holds a row in registers
# (Kp / 32 per lane, up to 32) and reduces it by in-lane adds and the xor
# butterfly, finishing in shared memory where the in-lane levels stop at
# an odd multiple of 32 (Kp = 384, 640, 768, 896); every other Kp (K = 0,
# K > 1024) takes "smem", the shared-memory tree. Both keep `tree_sum`'s
# order (`kernels.lanes` is the plain model of "shfl").
QMV_ROUTES = {kp: "shfl" for kp in range(LANE, 1024 + 1, LANE)}
_QMV_CODES = {"smem": 0, "shfl": 1}
_QMV_SMEM_ROWS = 4    # rows per block of the "smem" kernel
SMEM_LIMIT = 232448   # shared memory a block can use


def qmv_route(K: int) -> str:
    """The route `qmv_op` takes for a K-wide row."""
    return QMV_ROUTES.get(padded_k(K), "smem")


def packed_k(K: int, dtype: torch.dtype) -> int:
    """Kp of the packed operands: K rounded up to the wgmma kernel's K
    tile of 128 bytes of `dtype` (64 bf16/fp16 values, 32 tf32 values),
    at least one tile. The pack writes zeros past K."""
    k_tile = K_TILE_BYTES // dtype.itemsize
    return max(-(-K // k_tile), 1) * k_tile


def qmv_op(a: torch.Tensor, v: torch.Tensor, fmt_id, *,
           chop_out: bool = True, route: str | None = None) -> torch.Tensor:
    """Fused chopped matvec of (M, K) x (K,) float32 operands -> (M,).

    `a` may be a view whose rows are strided (its row stride goes to the
    kernel as lda); any other layout is copied. `route` None takes
    `qmv_route(K)`; "smem" sends any K to the shared-memory kernel, and
    "shfl" raises where it cannot take K. Only tests and chip_smoke pass
    it."""
    if route not in (None, *_QMV_CODES):
        raise ValueError(f"qmv: unknown route {route!r}")
    if a.dim() != 2 or v.dim() != 1 or v.shape[0] != a.shape[1]:
        raise ValueError(f"qmv: shapes {tuple(a.shape)} x {tuple(v.shape)}")
    if a.device.type == "cpu":
        return qmv_ref(a, v, fmt_id, chop_out=chop_out)
    M, K = a.shape
    if a.stride(1) != 1 or (M > 1 and a.stride(0) < K):
        a = a.contiguous()
    v = v.contiguous()
    library.check_cuda("qmv", a, v, contiguous=False)
    taken = route or qmv_route(K)
    if taken == "shfl" and qmv_route(K) != "shfl":
        raise ValueError(f"qmv: the shfl route takes Kp 128..1024, not "
                         f"K={K}")
    if taken == "smem" and 4 * _QMV_SMEM_ROWS * padded_k(K) > SMEM_LIMIT:
        raise ValueError(f"qmv: K={K} needs more shared memory than a "
                         "block has")
    out = torch.empty(M, dtype=a.dtype, device=a.device)
    if M == 0:
        return out
    lda = a.stride(0) if M > 1 else K
    library.call("repro_qmv_f32", "qmv", a, a.data_ptr(), v.data_ptr(),
                 out.data_ptr(), M, K, lda, *library.fmt_args(fmt_id),
                 int(chop_out), _QMV_CODES[taken])
    library.count_launch("qmv", taken)
    return out


def _gemm(name: str, a: torch.Tensor, b: torch.Tensor, fmt_id, bk: int,
          chop_out: bool, route: str | None = None) -> torch.Tensor:
    """The GEMM launcher on contiguous float32 CUDA operands, each launch
    counted under `name`. `route` None takes `ROUTES`; "ffma" sends any
    format to the FFMA kernel. The wrappers never pass it: the card tests
    hold the FFMA kernel for all seven ids through it, so that a format
    the tensor cores failed could move there by a change of `ROUTES`
    alone.

    The kernels close a K block's partial only at a multiple of their K
    tile. For bk < K off that grid, each K block is a launch of its own
    and the partials are added in order from 0, then rounded once by the
    chop kernel: the order of `qmatmul_ref_blocked`."""
    if route not in (None, "ffma"):
        raise ValueError(f"{name}: unknown route {route!r}")
    M, K = a.shape
    N = b.shape[1]
    fid = int(fmt_id)
    dtype, kind = ROUTES[fid]
    if route == "ffma":
        kind = "ffma"
    k_tile = FFMA_K_TILE if kind == "ffma" else K_TILE_BYTES // dtype.itemsize
    if bk < K and bk % k_tile and M and N:
        acc = torch.zeros((M, N), dtype=torch.float32, device=a.device)
        for k0 in range(0, K, bk):
            acc = acc + _gemm(name, a[:, k0:k0 + bk].contiguous(),
                              b[k0:k0 + bk], fid, bk, False, route)
        return chop_op(acc, fid) if chop_out else acc
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    pa = pb = None
    Kp, code = K, _FFMA
    if kind == "wgmma":
        # The packed operands' scratch in one allocation: A as (M, Kp),
        # then B transposed as (N, Kp), K-major (each starts on a 128-byte
        # boundary: Kp is a multiple of 128 bytes). Held until both
        # kernels are on the stream, whose order then keeps it until the
        # GEMM has read it.
        Kp = packed_k(K, dtype)
        scratch = torch.empty((M + N) * Kp, dtype=dtype, device=a.device)
        pa = scratch.data_ptr()
        pb, code = pa + M * Kp * dtype.itemsize, _WGMMA[dtype]
    library.call("repro_qgemm", name, a, a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), pa, pb, M, N, K, Kp, bk,
                 *library.fmt_args(fid), int(chop_out), code)
    library.count_launch(name, kind)
    return out


def _pack(a: torch.Tensor, b: torch.Tensor, fmt_id):
    """The pack kernel alone on float32 CUDA operands of a tensor-core
    format: (chop(A) as (M, Kp), chop(B) transposed as (N, Kp)) in the
    route's type, K zero-padded. For the card checks against `pack_ref`;
    no launch count (the GEMM's call counts it)."""
    library.check_cuda("qgemm pack", a, b)
    fid = int(fmt_id)
    dtype, kind = ROUTES[fid]
    if kind != "wgmma":
        raise ValueError(f"qgemm pack: format {fid} takes no pack")
    M, K = a.shape
    N = b.shape[1]
    Kp = packed_k(K, dtype)
    buf = torch.empty((M + N) * Kp, dtype=dtype, device=a.device)
    pa, pb = buf[:M * Kp].view(M, Kp), buf[M * Kp:].view(N, Kp)
    library.call("repro_qgemm_pack", "qgemm pack", a, a.data_ptr(),
                 b.data_ptr(), pa.data_ptr(), pb.data_ptr(), M, N, K, Kp,
                 *library.fmt_args(fid), _WGMMA[dtype])
    return pa, pb


def qgemm_op(a: torch.Tensor, b: torch.Tensor, fmt_id, *,
             chop_out: bool = True) -> torch.Tensor:
    """Chopped GEMM of (M, K) x (K, N) float32 operands -> (M, N)."""
    if a.device.type == "cpu":
        return qgemm_ref(a, b, fmt_id, chop_out=chop_out)
    library.check_cuda("qgemm", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"qgemm: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return _gemm("qgemm", a, b, fmt_id, max(a.shape[1], 1), chop_out)


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
    sum, so it is part of the result, on the card too (`_gemm`). `bm` and
    `bn` are accepted for the JAX op's signature and ignored: they only
    tile M and N there."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"qmatmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if bk is not None and int(bk) < 1:
        raise ValueError(f"qmatmul: bk={bk} must be positive")
    K = a.shape[1]
    bk = min(int(bk or DEFAULT_BK), max(128, _next_pow2(max(K, 1))))
    if a.device.type == "cpu":
        pad = -K % bk
        return qmatmul_ref_blocked(F.pad(a.to(torch.float32), (0, pad)),
                                   F.pad(b.to(torch.float32), (0, 0, 0, pad)),
                                   fmt_id, bk, chop_out=chop_out)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    library.check_cuda("qmatmul", a, b)
    return _gemm("qmatmul", a, b, fmt_id, bk, chop_out)
