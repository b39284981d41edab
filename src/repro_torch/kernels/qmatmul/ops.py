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

The solver's two, `qmv_op` and `qgemm_op`, take the float32 and the
float64 carrier. qmv has a float64 instantiation of both routes
(`repro_qmv_f64`); the GEMM's float64 carrier sums in float64, as the
reference's float64 dot does, so every format id there takes its one
route, the DFMA kernel of `csrc/qgemm_f64.cu` (`ROUTES_F64`). Their
float64 launches count as "qmv_f64" and "qgemm_f64". `qmatmul_op` (the
LM stack's) computes in float32 whatever its inputs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import library
from repro_torch.kernels.chop import chop_op
from repro_torch.precision.rows import as_rows

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
# Format id -> (operand type, route) of the GEMM on the float64 carrier:
# every id sums in float64 on the DFMA kernel (`csrc/qgemm_f64.cu`); no
# tensor-core route accumulates in float64 at these widths.
ROUTES_F64 = {fid: (torch.float64, "dfma") for fid in ROUTES}
_SOLVER_DTYPES = tuple(library.CARRIERS)
_QMV_ENTRY = {torch.float32: "repro_qmv_f32", torch.float64: "repro_qmv_f64"}
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
    """Fused chopped matvec of (M, K) x (K,) operands of one carrier,
float32 or float64 -> (M,); or of a batch, (B, M, K) x (B, K) -> (B, M),
    in one launch, with one format id or one per row (`precision.rows`).

    `a` may be a view whose rows are strided (its row stride goes to the
    kernel as lda, its batch stride as another); any other layout is
    copied. `route` None takes `qmv_route(K)`; "smem" sends any K to the
    shared-memory kernel, and "shfl" raises where it cannot take K. Only
    tests and chip_smoke pass it."""
    if route not in (None, *_QMV_CODES):
        raise ValueError(f"qmv: unknown route {route!r}")
    batched = a.dim() == 3
    rows = as_rows(fmt_id)
    if (a.dim() != v.dim() + 1 or v.dim() not in (1, 2)
            or v.shape[-1] != a.shape[-1]
            or (batched and v.shape[0] != a.shape[0])
            or (rows is not None and (not batched
                                      or len(rows) != a.shape[0]))):
        raise ValueError(f"qmv: shapes {tuple(a.shape)} x {tuple(v.shape)}"
                         + ("" if rows is None else
                            f" with {len(rows)} per-row formats"))
    if a.device.type == "cpu":
        return qmv_ref(a, v, fmt_id, chop_out=chop_out)
    B = a.shape[0] if batched else 1
    M, K = a.shape[-2:]
    if a.stride(-1) != 1 or (M > 1 and a.stride(-2) < K) or (
            batched and B > 1 and a.stride(0) < M * K):
        a = a.contiguous()
    if v.stride(-1) != 1:
        v = v.contiguous()
    library.check_cuda("qmv", a, v, contiguous=False, dtypes=_SOLVER_DTYPES)
    taken = route or qmv_route(K)
    if taken == "shfl" and qmv_route(K) != "shfl":
        raise ValueError(f"qmv: the shfl route takes Kp 128..1024, not "
                         f"K={K}")
    if taken == "smem" and \
            a.element_size() * _QMV_SMEM_ROWS * padded_k(K) > SMEM_LIMIT:
        raise ValueError(f"qmv: K={K} needs more shared memory than a "
                         "block has")
    out = torch.empty(a.shape[:-1], dtype=a.dtype, device=a.device)
    if M == 0 or B == 0:
        return out
    lda = a.stride(-2) if M > 1 else K
    a_b = a.stride(0) if batched and B > 1 else 0
    v_b = v.stride(0) if batched and B > 1 else 0
    fmt, ids, table = library.row_args(fmt_id, rows, a.dtype, a.device)
    dev = library.call(_QMV_ENTRY[a.dtype], "qmv", a, a.data_ptr(),
                       v.data_ptr(), out.data_ptr(), B, M, K, lda, a_b, v_b,
                       *fmt, ids, table, int(chop_out), _QMV_CODES[taken])
    library.count_launch(library.kernel_name("qmv", a.dtype), taken, dev,
                         ids is not None,
                         padded_k(K) if taken == "shfl" else None)
    return out


def _gemm(name: str, a: torch.Tensor, b: torch.Tensor, fmt_id, bk: int,
          chop_out: bool, route: str | None = None,
          rows=None) -> torch.Tensor:
    """The GEMM launcher on contiguous float32 CUDA operands, (M, K) x
    (K, N), or a batch (B, M, K) x (B, K, N), each launch counted under
    `name`. `route` None takes `ROUTES`; "ffma" sends any format to the
    FFMA kernel. The wrappers never pass it: the card tests hold the FFMA
    kernel for all seven ids through it, so that a format the tensor
    cores failed could move there by a change of `ROUTES` alone.

    `rows` (per-row formats of a batch): the route follows each row's
    format, so the rows are split by route, one launch per route present,
    each over every row of the batch with the ids of its route in its
    mask (the kernel's blocks of the other rows return at once).

    The kernels close a K block's partial only at a multiple of their K
    tile. For bk < K off that grid, each K block is a launch of its own
    and the partials are added in order from 0, then rounded once by the
    chop kernel: the order of `qmatmul_ref_blocked`."""
    if route not in (None, "ffma"):
        raise ValueError(f"{name}: unknown route {route!r}")
    batched = a.dim() == 3
    B = a.shape[0] if batched else 1
    M, K = a.shape[-2:]
    N = b.shape[-1]
    if rows is not None and rows.uniform is not None:
        fmt_id, rows = rows.uniform, None
    if rows is None:
        groups = [(int(fmt_id), ROUTES[int(fmt_id)], 0)]
    else:
        by_route = {}
        for fid in np.unique(rows.host).tolist():
            by_route.setdefault(ROUTES[fid], []).append(fid)
        groups = [(fids[0], key, sum(1 << f for f in fids))
                  for key, fids in by_route.items()]
    out = torch.empty(a.shape[:-1] + (N,), dtype=torch.float32,
                      device=a.device)
    for fid, (dtype, kind), fmask in groups:
        if route == "ffma":
            kind = "ffma"
        k_tile = FFMA_K_TILE if kind == "ffma" else \
            K_TILE_BYTES // dtype.itemsize
        if bk < K and bk % k_tile and M and N:
            if batched:
                raise ValueError(f"{name}: a K block off the kernel's K "
                                 "tile takes one product, not a batch")
            acc = torch.zeros((M, N), dtype=torch.float32, device=a.device)
            for k0 in range(0, K, bk):
                acc = acc + _gemm(name, a[:, k0:k0 + bk].contiguous(),
                                  b[k0:k0 + bk], fid, bk, False, route)
            return chop_op(acc, fid) if chop_out else acc
        if M == 0 or N == 0 or B == 0:
            return out
        pa = pb = None
        Kp, code = K, _FFMA
        if kind == "wgmma":
            # The packed operands' scratch in one allocation: A as
            # (B M, Kp), then B transposed as (B N, Kp), K-major (each
            # starts on a 128-byte boundary: Kp is a multiple of 128
            # bytes). Held until both kernels are on the stream, whose
            # order then keeps it until the GEMM has read it.
            Kp = packed_k(K, dtype)
            scratch = torch.empty(B * (M + N) * Kp, dtype=dtype,
                                  device=a.device)
            pa = scratch.data_ptr()
            pb, code = pa + B * M * Kp * dtype.itemsize, _WGMMA[dtype]
        fmt, ids, table = library.row_args(fid, rows, torch.float32,
                                           a.device)
        dev = library.call("repro_qgemm", name, a, a.data_ptr(),
                           b.data_ptr(), out.data_ptr(), pa, pb, B, M, N, K,
                           Kp, bk, *fmt, ids, table, fmask, int(chop_out),
                           code)
        library.count_launch(name, kind, dev, ids is not None, code)
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


def _gemm_f64(a: torch.Tensor, b: torch.Tensor, fmt_id, chop_out: bool,
              rows=None) -> torch.Tensor:
    """The float64 carrier's GEMM (`ROUTES_F64`: the DFMA kernel for every
    format id) on contiguous float64 CUDA operands, one K block, (M, K) x
    (K, N) or a batch, every row in one launch (per-row formats `rows`
    through the ids)."""
    batched = a.dim() == 3
    B = a.shape[0] if batched else 1
    M, K = a.shape[-2:]
    N = b.shape[-1]
    _, kind = ROUTES_F64[int(fmt_id) if rows is None else int(rows.host[0])]
    out = torch.empty(a.shape[:-1] + (N,), dtype=torch.float64,
                      device=a.device)
    if M == 0 or N == 0 or B == 0:
        return out
    fmt, ids, table = library.row_args(fmt_id, rows, torch.float64, a.device)
    dev = library.call("repro_qgemm_f64", "qgemm", a, a.data_ptr(),
                       b.data_ptr(), out.data_ptr(), B, M, N, K, *fmt, ids,
                       table, int(chop_out))
    library.count_launch("qgemm_f64", kind, dev, ids is not None)
    return out


def qgemm_op(a: torch.Tensor, b: torch.Tensor, fmt_id, *,
             chop_out: bool = True) -> torch.Tensor:
    """Chopped GEMM of (M, K) x (K, N) operands of one carrier, float32
    (`ROUTES`) or float64 (`ROUTES_F64`) -> (M, N); or of a batch,
    (B, M, K) x (B, K, N) -> (B, M, N), with one format id or one per row
    (`precision.rows`): one launch per route the rows' formats take."""
    rows = as_rows(fmt_id)
    if a.device.type == "cpu":
        return qgemm_ref(a, b, fmt_id, chop_out=chop_out)
    library.check_cuda("qgemm", a, b, dtypes=_SOLVER_DTYPES)
    if a.dim() not in (2, 3) or b.dim() != a.dim() or \
            a.shape[-1] != b.shape[-2] or \
            (a.dim() == 3 and a.shape[0] != b.shape[0]) or \
            (rows is not None and (a.dim() != 3 or len(rows) != a.shape[0])):
        raise ValueError(f"qgemm: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}"
                         + ("" if rows is None else
                            f" with {len(rows)} per-row formats"))
    if a.dtype == torch.float64:
        return _gemm_f64(a, b, fmt_id, chop_out, rows)
    return _gemm("qgemm", a, b, fmt_id, max(a.shape[-1], 1), chop_out,
                 rows=rows)


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
