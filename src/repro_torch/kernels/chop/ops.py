"""Wrappers of the CUDA chop kernel (`csrc/chop.cu`), the port of
`repro/kernels/chop/chop.py::chop_pallas` and of the fusion into
producers and consumers that its design relies on.

`chop_expr_op(form, a, b, c, fmt_id=..., out=..., live=...)` evaluates
one form of `FORMS` in one launch: `chop(a)` ("x"), `chop(a op b)` for
op in "add", "sub", "mul", "div", `chop(a - chop(b * c))` ("sub_mul"),
`chop(chop(a - b) / c)` ("sub_div") and `chop(a + chop(b * c))`
("add_mul"). The operands are tensors of one carrier, float32 or
float64, of up to two dimensions that broadcast as torch broadcasts them
(a 0-dim tensor is a scalar), with any strides. The result goes into a
fresh contiguous tensor, or into `out`: a view of the result's shape in
the same carrier with any strides, which may be `a` itself element for
element (no other overlap with an operand is allowed). `live = (lo, hi)` stores +0
outside positions [lo, hi) of a 1-D result (or of one row, (1, N)).
`chop_op(x, fmt_id)` is the
form "x" (a tensor of more than two dimensions must be contiguous).

A CUDA tensor launches the kernel or raises; CPU tensors run the plain
version (`ref.chop_expr_ref`). Format parameters are runtime arguments,
so one build serves every format id (DESIGN.md §3.4) on each carrier:
the kernel's float and double instantiations, chosen by the operands'
dtype. Any other dtype raises.

Routes (`chop_route`): "block", one block for at most `BLOCK_MAX`
elements; "vector", 16-byte accesses for larger operands that are dense
in the output's layout (or a broadcast scalar), with a dense output, all
16-byte aligned; "strided", every other layout. The bound is measured on
the H100 by `scripts/chop_routes.py`: one block is the fastest launch up
to 256 elements, and from 512 up the vector route beats the strided one
(for three dense operands it is within 0.07 us of it at 4096-16384
elements). A launch counts in `library.ROUTE_LAUNCHES["chop"]` (float64:
`["chop_f64"]`) under "<form>/<route>".

Per-row formats (`precision.rows`: a `RowFormats` or a (B,) integer
tensor as `fmt_id`): the result's dim 0 is the batch, with up to two
dimensions after it, each row rounded to its own format in the same one
launch (the ids go to the kernel, which reads each row's parameters from
the carrier's format table); `live` then applies to the last dimension of
a (B, N) result. The vector route takes such a batch when every operand is
dense in the result's layout (or a scalar) and, with ids, a row holds a
whole number of 16-byte vectors (and no live range spans rows).

The launch path is the host's cost of every call, and a solve makes tens
of thousands of short ones, so the C entry takes its arguments packed in
one 224-byte struct (`_ARGS`, one `struct.pack_into` into a buffer of the
calling thread) through a single pointer.
"""
from __future__ import annotations

import ctypes
import struct
import threading

import torch

from repro_torch.kernels import library

from repro_torch.precision.rows import as_rows

from .ref import (FORMS, check_operands, chop_expr_ref, chop_sr_ref,
                  sr_words)

BLOCK_MAX = 256         # elements one block takes (csrc/chop.cu)
ROUTES = ("block", "vector", "strided")
_FORM_CODES = {f: k for k, f in enumerate(FORMS)}
_ROUTE_CODES = {r: k for k, r in enumerate(ROUTES)}
_COUNT_KEYS = {(f, r): f"{f}/{r}" for f in FORMS for r in ROUTES}
# csrc/chop.cu `ExprArgs`: a, b, c and out (a pointer and two element
# strides each), M, N, lo, hi; B and the four batch strides; the stream,
# the ids, the format table; form, route, t, emin; the 64-bit xmax_bits;
# saturate, the carrier's code (`DTYPE_CODES`).
_ARGS = struct.Struct("<24q4iQ2i")
DTYPE_CODES = {dt: k for k, dt in enumerate(library.CARRIERS)}
_COUNT_NAMES = {dt: library.kernel_name("chop", dt) for dt in DTYPE_CODES}
_TLS = threading.local()
# The pointer and strides of the operands a form does not take, by how
# many fields the ones it takes fill.
_ABSENT = {3: (0,) * 6, 6: (0,) * 3, 9: ()}


def chop_route(numel: int, aligned: bool, form: str) -> str:
    """The route a chop of `numel` output elements takes in `form`.
    `aligned`: every operand dense in the output's layout or a broadcast
    scalar, the output dense, all 16-byte aligned. The measured bounds
    are the same for every form."""
    if form not in _FORM_CODES:
        raise ValueError(f"chop: unknown form {form!r}; one of {FORMS}")
    if numel <= BLOCK_MAX:
        return "block"
    return "vector" if aligned else "strided"


def _buffer():
    """This thread's argument buffer and its address: the C entry reads
    it before the call returns, and ctypes lets other threads run while
    it does."""
    try:
        return _TLS.buf
    except AttributeError:
        buf = ctypes.create_string_buffer(_ARGS.size)
        _TLS.buf = buf, ctypes.addressof(buf)
        return _TLS.buf


def _broadcast(sa, sb):
    """torch's broadcast of two shapes (`torch.broadcast_shapes` costs
    tens of microseconds a call)."""
    if len(sa) < len(sb):
        sa, sb = sb, sa
    sb = (1,) * (len(sa) - len(sb)) + tuple(sb)
    out = []
    for x, y in zip(sa, sb):
        if x != y and x != 1 and y != 1:
            raise ValueError(f"chop: shapes {tuple(sa)} and {sb} do not "
                             "broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _strides(shape, stride, dims: int):
    """Element strides of a tensor of `shape` and `stride` read as the
    (M, N) result of `dims` dimensions: (row, column), 0 along a
    dimension of size 1 or one the tensor lacks."""
    d = len(shape)
    if d == 0:
        return 0, 0
    col = stride[-1] if shape[-1] != 1 else 0
    if d == 1 or dims == 1:
        return 0, col
    return (stride[0] if shape[0] != 1 else 0), col


def _dense(ptr, s0, s1, M, N):
    if s0 == 0 and s1 == 0:
        return True
    return s1 == 1 and (M == 1 or s0 == N) and ptr % 16 == 0


def vector_ready(ptrs, strides, M, N) -> bool:
    """Whether the vector route takes the tensors at `ptrs` (operands and
    output) read with `strides` (`expr_layout`) as the (M, N) result:
    each a scalar broadcast to every element, or in the result's own
    contiguous layout at a 16-byte aligned address."""
    return all(_dense(p, s0, s1, M, N) for p, (s0, s1) in zip(ptrs, strides))


def expr_layout(ops):
    """How the kernel reads the operands `ops`: the result's shape, its
    (M, N) (a vector is one row, a 0-dim result one element), and each
    operand's element strides in (M, N), 0 along a broadcast dimension.
    Raises for shapes that do not broadcast and for a result of more
    than two dimensions."""
    metas = [(t.shape, t.stride()) for t in ops]
    shape = metas[0][0]
    for s, _ in metas[1:]:
        if s != shape:
            shape = _broadcast(shape, s)
    dims = len(shape)
    if dims > 2:
        raise ValueError(f"chop: operands of {dims} dimensions; the kernel "
                         "takes up to two")
    M, N = shape if dims == 2 else (1, shape[0] if dims else 1)
    return shape, M, N, [_strides(s, st, dims) for s, st in metas]


def batch_layout(ops, B: int):
    """`expr_layout` of a batch of B rows: the result's shape (B, ...) with
    up to two dimensions after the batch, its per-row (M, N), and each
    operand's element strides (batch, row, column), 0 along a dimension
    it is broadcast over (or of size 1)."""
    shape = ops[0].shape
    for t in ops[1:]:
        if t.shape != shape:
            shape = _broadcast(shape, t.shape)
    dims = len(shape)
    if dims == 0 or shape[0] != B:
        raise ValueError(f"chop: {B} per-row format ids for a result of "
                         f"shape {tuple(shape)}; dim 0 is the batch")
    if dims > 3:
        raise ValueError(f"chop: a batch of operands of {dims - 1} "
                         "dimensions; the kernel takes up to two a row")
    rest = shape[1:]
    M, N = rest if dims == 3 else (1, rest[0] if dims == 2 else 1)
    strides = []
    for t in ops:
        d = t.dim()
        full = (1,) * (dims - d) + tuple(t.shape)
        st = (0,) * (dims - d) + tuple(t.stride())
        st = [0 if n == 1 else x for n, x in zip(full, st)]
        strides.append((st[0], *(([0, 0] + st[1:])[-2:])))
    return shape, M, N, strides


def _batch_dense(ptr, st, B, M, N):
    """Whether an operand of strides `st` (batch, row, column) is a scalar
    broadcast to every element, or dense in the (B, M, N) result's own
    layout at a 16-byte aligned address."""
    if st == (0, 0, 0):
        return True
    want = (M * N if B > 1 else 0, N if M > 1 else 0, 1 if N > 1 else 0)
    return tuple(st) == want and ptr % 16 == 0


def _check_tensors(tensors):
    """The tensors' device and carrier: CUDA tensors on one device, all
    float32 or all float64."""
    dev, dt = tensors[0].get_device(), tensors[0].dtype
    if dt in DTYPE_CODES:
        for t in tensors:
            if not t.is_cuda or t.dtype is not dt or t.get_device() != dev:
                break
        else:
            return dev, dt
    library.check_cuda("chop", *tensors, contiguous=False,
                       dtypes=tuple(DTYPE_CODES))
    raise ValueError("chop: the kernel takes float32 or float64 CUDA "
                     "tensors on one device")


def chop_expr_op(form: str, a: torch.Tensor, b=None, c=None, *, fmt_id,
                 out=None, live=None, route: str | None = None
                 ) -> torch.Tensor:
    """One launch of `form` (module docstring); returns the result, or
    `out` when given. `route` None takes `chop_route`; only tests and
    chip_smoke force one."""
    check_operands(form, a, b, c)
    ops = (a,) if b is None else ((a, b) if c is None else (a, b, c))
    if a.is_cpu and all(t.is_cpu for t in ops) and (out is None
                                                    or out.is_cpu):
        return chop_expr_ref(form, a, b, c, fmt_id=fmt_id, out=out,
                             live=live)
    dev, dt = _check_tensors(ops if out is None else ops + (out,))
    rows = as_rows(fmt_id)
    if rows is not None and len(rows) == 1:
        # A batch of one row: the launch of one format, on the (1, N)
        # result, live range and all, or on the row of a (1, M, N) one.
        dims = max(t.dim() for t in ops)
        if dims == 3:
            res = chop_expr_op(form, *(t[0] if t.dim() == 3 else t
                                       for t in ops),
                               fmt_id=rows.uniform,
                               out=None if out is None else out[0],
                               live=live, route=route)
            return res.unsqueeze(0) if out is None else out
        fmt_id, rows = rows.uniform, None
    if rows is None:
        shape, M, N, strides = expr_layout(ops)
        B = 1
        strides = [(0, *st) for st in strides]
    else:
        B = len(rows)
        shape, M, N, strides = batch_layout(ops, B)
    n = B * M * N
    ptrs = [t.data_ptr() for t in ops]
    if out is None:
        # torch.empty_like costs a third of new_empty(shape) a call.
        out = torch.empty_like(a) if shape == a.shape and \
            a.is_contiguous() else a.new_empty(shape)
        ostr = (0, N, 1) if rows is None else \
            (M * N if B > 1 else 0, N if M > 1 else 0, 1 if N > 1 else 0)
        optr = out.data_ptr()
    else:
        oshape = out.shape
        if oshape != shape:
            raise ValueError(f"chop: out has shape {tuple(oshape)}, the "
                             f"result {tuple(shape)}")
        if rows is None:
            ostr = (0, *_strides(oshape, out.stride(), len(shape)))
        else:
            ostr = batch_layout((out,), B)[3][0]
        if (B > 1 and ostr[0] == 0) or (M > 1 and ostr[1] == 0) or \
                (N > 1 and ostr[2] == 0):
            raise ValueError("chop: out repeats an element (a stride 0)")
        optr = out.data_ptr()
        if optr == ptrs[0] and ostr != strides[0]:
            raise ValueError("chop: out may share memory with a only "
                             "element for element")
    if n == 0:
        return out
    if live is None:
        lo, hi = 0, (n if rows is None else N)
    else:
        if not (len(shape) == 1 or (len(shape) == 2
                                    and (rows is not None or M == 1))):
            raise ValueError("chop: a live range takes a 1-D result or one "
                             "row (with per-row formats a (B, N) one), not "
                             f"a {len(shape)}-D one of {M} rows")
        lo, hi = live
        if lo < 0:
            raise ValueError(f"chop: live range {live} starts below 0")
        hi = min(hi, N)
    fmt, ids, table = library.row_args(fmt_id, rows, dt, dev)
    if rows is None:
        aligned = (n > BLOCK_MAX or route is not None) and vector_ready(
            ptrs + [optr], [st[1:] for st in strides] + [ostr[1:]], M, N)
    else:
        aligned = (n > BLOCK_MAX or route is not None) and all(
            _batch_dense(p, st, B, M, N)
            for p, st in zip(ptrs + [optr], strides + [ostr])) and (
            ids is None or (M * N) % (16 // a.element_size()) == 0) and (
            live is None or B == 1)
    if route is None:
        route = chop_route(n, aligned, form)
    elif route not in _ROUTE_CODES:
        raise ValueError(f"chop: unknown route {route!r}")
    elif route == "block" and n > BLOCK_MAX:
        raise ValueError(f"chop: the block route takes at most {BLOCK_MAX} "
                         f"elements, not {n}")
    elif route == "vector" and not aligned:
        raise ValueError("chop: the vector route takes operands dense in the "
                         "output's layout or scalars, a dense output, all "
                         "16-byte aligned")
    if route == "vector":
        # Flat rows: a dense operand is M N contiguous elements a row, a
        # scalar has strides 0; the kernel reads the live range on the
        # flat index.
        M, N, ostr = 1, (n if rows is None else M * N), (0, 0, 1)
        strides = [(0, 0, int(st != (0, 0, 0))) for st in strides]
        if live is None:
            hi = n
    args = []
    for p, st in zip(ptrs, strides):
        args += p, *st[1:]
    args += _ABSENT[len(args)]
    sb = [st[0] for st in strides] + [0] * (3 - len(strides))
    buf, addr = _buffer()
    _ARGS.pack_into(buf, 0, *args, optr, *ostr[1:], M, N, lo, hi,
                    B, *sb, ostr[0], library.raw_stream(dev), ids or 0,
                    table or 0, _FORM_CODES[form], _ROUTE_CODES[route],
                    *fmt, DTYPE_CODES[dt])
    library.call_packed("repro_chop_expr", "chop", dev, addr)
    library.count_launch(_COUNT_NAMES[dt], _COUNT_KEYS[form, route], dev,
                         ids is not None)
    return out


def chop_op(x: torch.Tensor, fmt_id, *, route: str | None = None
            ) -> torch.Tensor:
    """Round `x` (float32 or float64, any shape; contiguous above two
    dimensions, or above three with per-row formats) to the format of the
    runtime id, or each row x[k] to its own: the form "x" into a fresh
    contiguous tensor."""
    if as_rows(fmt_id) is not None:
        if x.ndim > 3 and not x.is_cpu:
            if not x.is_contiguous():
                raise ValueError("chop: a batch of more than two dimensions "
                                 "a row must be contiguous")
            return chop_expr_op("x", x.view(x.shape[0], -1), fmt_id=fmt_id,
                                route=route).view(x.shape)
        return chop_expr_op("x", x, fmt_id=fmt_id, route=route)
    if x.ndim > 2 and not x.is_cpu:
        if not x.is_contiguous():
            raise ValueError("chop: a tensor of more than two dimensions "
                             "must be contiguous")
        return chop_expr_op("x", x.view(-1), fmt_id=fmt_id,
                            route=route).view(x.shape)
    return chop_expr_op("x", x, fmt_id=fmt_id, route=route)


def chop_sr_op(x: torch.Tensor, fmt_id, bits: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of float32 `x` (any shape) to the format of
    the runtime id, with the random words `bits` (int32 or uint32
    patterns of x's shape), into a fresh tensor: one launch of the
    `chop_sr` kernel (`csrc/chop_sr.cu`) for CUDA tensors, counted in
    `library.LAUNCHES["chop_sr"]`; the plain version `chop_sr_ref` for
    CPU tensors. Any other dtype raises `TypeError`."""
    if x.dtype != torch.float32:
        raise TypeError("chop_stochastic targets the f32 carrier")
    words = sr_words(bits)
    if x.is_cpu and words.is_cpu:
        return chop_sr_ref(x, fmt_id, words)
    x, words = x.contiguous(), words.contiguous()
    library.check_cuda("chop_sr", x)
    library.check_cuda("chop_sr", words, dtypes=(torch.int32,))
    if words.device != x.device:
        raise ValueError(f"chop_sr: tensors on {x.device} and "
                         f"{words.device}")
    if words.shape != x.shape:
        raise ValueError(f"chop_stochastic: random words of shape "
                         f"{tuple(words.shape)} for x of {tuple(x.shape)}")
    out = torch.empty_like(x)
    dev = library.call("repro_chop_sr", "chop_sr", x, x.data_ptr(),
                       words.data_ptr(), out.data_ptr(), x.numel(),
                       *library.fmt_args(int(fmt_id), torch.float32))
    library.count_launch("chop_sr", "elementwise", dev)
    return out
