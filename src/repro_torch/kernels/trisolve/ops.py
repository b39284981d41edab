"""Wrapper of the CUDA blocked-trisolve kernels (`csrc/trisolve.cu`), the
port of `repro/kernels/trisolve/trisolve.py::trisolve_pallas`.

One thread block runs the whole blocked substitution, and one launch
solves a batch (one block a row of the batch). The
identity padding of `ref.pad_unit` happens inside the kernel (entries
past n read as the identity, the rhs as 0), so no padded copy of the
factor is made. A CUDA tensor launches a kernel or raises; a CPU tensor
runs the plain version. Unlike the TPU kernel (`MAX_N`), the factor
streams from device memory, so every n whose solution vector fits in
shared memory is taken.

Two routes, by block width (`ROUTES`): "shfl" for the powers of two up
to 128 (the solver's block is 128), where one warp runs each diagonal
block's row chain in registers and shuffles while the other warps
prepare the next block row; "smem" for any other width, the chain's
trees in shared memory. Both are bit-exact against the plain version;
`checks.trisolve_lanes` is the plain model of the "shfl" route's order.

Both routes take the float32 and the float64 carrier (`repro_trisolve_f32`,
`repro_trisolve_f64`); a float64 launch counts as "trisolve_f64". On
float64 the "shfl" route keeps its diagonal blocks as packed triangles
(`smem_bytes`), so that the solver's block of 128 fits in shared memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import library
from repro_torch.precision.rows import as_rows

from .ref import trisolve_ref

# Block width -> route ("shfl"); every other width takes "smem".
ROUTES = {1 << k: "shfl" for k in range(8)}
_CODES = {"smem": 0, "shfl": 1}
_ENTRY = {torch.float32: "repro_trisolve_f32",
          torch.float64: "repro_trisolve_f64"}
SMEM_LIMIT = 232448   # shared memory a block can use


def diag_entries(block: int, dtype=torch.float32) -> int:
    """Entries of one diagonal block in the "shfl" route's shared memory:
    block^2 on float32, the packed triangle block (block + 1) / 2 on
    float64 (`diag_size` in trisolve.cu)."""
    if dtype == torch.float64:
        return block * (block + 1) // 2
    return block * block


def smem_bytes(n: int, block: int, route: str, dtype=torch.float32) -> int:
    """Shared memory a route asks for on the carrier `dtype`. "shfl": two
    diagonals' reciprocals in double (2 block), then in the carrier the
    solution vector and the tile sums (n_pad each), t (block), two
    diagonal blocks (`diag_entries` each) and 32 values of slack.
    "smem": the solution vector, one diagonal block, t, and a tree buffer
    of `block` values for each of 8 warps."""
    n_pad = -(-n // block) * block
    size = torch.finfo(dtype).bits // 8
    if route == "shfl":
        return 16 * block + size * (2 * n_pad + block
                                    + 2 * diag_entries(block, dtype) + 32)
    return size * (n_pad + block * block + block + 8 * block)


def trisolve_route(n: int, block: int, dtype=torch.float32) -> str:
    """The route `trisolve_op` takes: "shfl" for a width in `ROUTES` whose
    buffers fit, else "smem"."""
    if ROUTES.get(block) == "shfl" and \
            smem_bytes(n, block, "shfl", dtype) <= SMEM_LIMIT:
        return "shfl"
    return "smem"


def trisolve_op(Lu: torch.Tensor, b: torch.Tensor, fmt_id, *,
                lower: bool, block: int = 128,
                route: str | None = None) -> torch.Tensor:
    """Blocked triangular solve on the combined (n, n) LU factor; b: (n,),
    float32 or float64. Batched: Lu (B, n, n) and b (B, n), one block a
    row in one launch, with one format id or one per row
    (`precision.rows`).

    `route` None takes `trisolve_route(n, block)`; "smem" sends any block
    to the shared-memory kernel, and "shfl" raises where it cannot take
    the block. Only tests and chip_smoke pass it."""
    if route not in (None, *_CODES):
        raise ValueError(f"trisolve: unknown route {route!r}")
    rows = as_rows(fmt_id)
    if Lu.device.type == "cpu":
        return trisolve_ref(Lu, b, fmt_id, lower=lower, block=block)
    library.check_cuda("trisolve", Lu, b, dtypes=tuple(_ENTRY))
    n = Lu.shape[-1]
    batched = Lu.dim() == 3
    B = Lu.shape[0] if batched else 1
    if Lu.dim() not in (2, 3) or Lu.shape[-2] != n or \
            b.shape != Lu.shape[:-1] or \
            (rows is not None and (not batched or len(rows) != B)):
        raise ValueError(f"trisolve: shapes {tuple(Lu.shape)}, "
                         f"{tuple(b.shape)}"
                         + ("" if rows is None else
                            f" with {len(rows)} per-row formats"))
    if block < 1:
        raise ValueError(f"trisolve: block={block}")
    dt = Lu.dtype
    taken = route or trisolve_route(n, block, dt)
    if taken == "shfl" and ROUTES.get(block) != "shfl":
        raise ValueError(f"trisolve: the shfl route takes blocks "
                         f"{sorted(ROUTES)}, not {block}")
    if smem_bytes(n, block, taken, dt) > SMEM_LIMIT:
        raise ValueError(f"trisolve: n={n}, block={block} needs "
                         f"{smem_bytes(n, block, taken, dt)} B of shared "
                         f"memory on route {taken}")
    y = torch.empty_like(b)
    if n == 0 or B == 0:
        return y
    fmt, ids, table = library.row_args(fmt_id, rows, dt, Lu.device)
    dev = library.call(_ENTRY[dt], "trisolve", Lu, Lu.data_ptr(),
                       b.data_ptr(), y.data_ptr(), B, n, block, int(lower),
                       *fmt, ids, table, _CODES[taken])
    library.count_launch(library.kernel_name("trisolve", dt), taken, dev,
                         ids is not None, (bool(lower), block))
    return y
