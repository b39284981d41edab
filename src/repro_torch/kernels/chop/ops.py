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
outside positions [lo, hi) of a 1-D result. `chop_op(x, fmt_id)` is the
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

The launch path is the host's cost of every call, and a solve makes tens
of thousands of short ones, so the C entry takes its arguments packed in
one 168-byte struct (`_ARGS`, one `struct.pack_into` into a buffer of the
calling thread) through a single pointer.
"""
from __future__ import annotations

import ctypes
import struct
import threading

import torch

from repro_torch.kernels import library

from .ref import FORMS, check_operands, chop_expr_ref

BLOCK_MAX = 256         # elements one block takes (csrc/chop.cu)
ROUTES = ("block", "vector", "strided")
_FORM_CODES = {f: k for k, f in enumerate(FORMS)}
_ROUTE_CODES = {r: k for k, r in enumerate(ROUTES)}
_COUNT_KEYS = {(f, r): f"{f}/{r}" for f in FORMS for r in ROUTES}
# csrc/chop.cu `ExprArgs`: a, b, c and out (a pointer and two element
# strides each), M, N, lo, hi, the stream; form, route, t, emin; the
# 64-bit xmax_bits; saturate, the carrier's code (`DTYPE_CODES`).
_ARGS = struct.Struct("<17q4iQ2i")
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
    shape, M, N, strides = expr_layout(ops)
    n = M * N
    ptrs = [t.data_ptr() for t in ops]
    if out is None:
        # torch.empty_like costs a third of new_empty(shape) a call.
        out = torch.empty_like(a) if shape == a.shape and \
            a.is_contiguous() else a.new_empty(shape)
        ostr = N, 1
        optr = out.data_ptr()
    else:
        oshape = out.shape
        if oshape != shape:
            raise ValueError(f"chop: out has shape {tuple(oshape)}, the "
                             f"result {tuple(shape)}")
        ostr = _strides(oshape, out.stride(), len(shape))
        if (M > 1 and ostr[0] == 0) or (N > 1 and ostr[1] == 0):
            raise ValueError("chop: out repeats an element (a stride 0)")
        optr = out.data_ptr()
        if optr == ptrs[0] and ostr != strides[0]:
            raise ValueError("chop: out may share memory with a only "
                             "element for element")
    if n == 0:
        return out
    if live is None:
        lo, hi = 0, n
    else:
        if len(shape) != 1:
            raise ValueError("chop: a live range takes a 1-D result, not "
                             f"{len(shape)}-D")
        lo, hi = live
        if lo < 0:
            raise ValueError(f"chop: live range {live} starts below 0")
        hi = min(hi, n)
    aligned = (n > BLOCK_MAX or route is not None) and vector_ready(
        ptrs + [optr], strides + [ostr], M, N)
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
        # Flat: a dense operand is n contiguous elements, a scalar has
        # strides (0, 0).
        M, N, ostr = 1, n, (0, 1)
        strides = [(0, int(s != (0, 0))) for s in strides]
    args = []
    for p, st in zip(ptrs, strides):
        args += p, *st
    args += _ABSENT[len(args)]
    buf, addr = _buffer()
    _ARGS.pack_into(buf, 0, *args, optr, *ostr, M, N, lo, hi,
                    library.raw_stream(dev), _FORM_CODES[form],
                    _ROUTE_CODES[route], *library.fmt_args(fmt_id, dt),
                    DTYPE_CODES[dt])
    library.call_packed("repro_chop_expr", "chop", dev, addr)
    library.count_launch(_COUNT_NAMES[dt], _COUNT_KEYS[form, route])
    return out


def chop_op(x: torch.Tensor, fmt_id, *, route: str | None = None
            ) -> torch.Tensor:
    """Round `x` (float32 or float64, any shape; contiguous above two
    dimensions) to the format of the runtime id: the form "x" into a
    fresh contiguous tensor."""
    if x.ndim > 2 and not x.is_cpu:
        if not x.is_contiguous():
            raise ValueError("chop: a tensor of more than two dimensions "
                             "must be contiguous")
        return chop_expr_op("x", x.view(-1), fmt_id=fmt_id,
                            route=route).view(x.shape)
    return chop_expr_op("x", x, fmt_id=fmt_id, route=route)

