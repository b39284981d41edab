"""Plain torch versions of the chop kernel: `repro_torch.precision.chop`
(itself held bit for bit against `repro.precision.chop`), alone and in
the fused forms of `csrc/chop.cu`, on any carrier and device."""
from __future__ import annotations

import operator

import torch

from repro_torch.precision.chop import chop

# The kernel's forms, in the order of its form codes, and how many
# operands each takes.
FORMS = ("x", "add", "sub", "mul", "div", "sub_mul", "sub_div", "add_mul")
ARITY = {"x": 1, "add": 2, "sub": 2, "mul": 2, "div": 2, "sub_mul": 3,
         "sub_div": 3, "add_mul": 3}
_BINARY = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
           "div": operator.truediv}


def chop_ref(x: torch.Tensor, fmt_id) -> torch.Tensor:
    return chop(x, fmt_id)


def check_operands(form, a, b, c):
    """Raise unless `form` is one of FORMS and exactly its operands are
    given, `a` first."""
    n = ARITY.get(form)
    if n is None:
        raise ValueError(f"chop: unknown form {form!r}; one of {FORMS}")
    if a is None or (b is None) != (n < 2) or (c is None) != (n < 3):
        raise ValueError(f"chop: form {form!r} takes {n} operand(s)")


def chop_expr_ref(form: str, a: torch.Tensor, b=None, c=None, *, fmt_id,
                  out=None, live=None) -> torch.Tensor:
    """The form's value, torch's operations and the plain rounding in
    the kernel's order:

      x        chop(a)
      add..div chop(a op b)
      sub_mul  chop(a - chop(b * c))
      sub_div  chop(chop(a - b) / c)
      add_mul  chop(a + chop(b * c))

    with torch's broadcasting. `live = (lo, hi)` (a 1-D result only)
    stores +0 outside positions [lo, hi). `out`, a tensor of the result's
    shape (it may be `a` itself), receives the result and is returned."""
    check_operands(form, a, b, c)
    if form == "x":
        r = chop(a, fmt_id)
    elif form == "sub_mul":
        r = chop(a - chop(b * c, fmt_id), fmt_id)
    elif form == "sub_div":
        r = chop(chop(a - b, fmt_id) / c, fmt_id)
    elif form == "add_mul":
        r = chop(a + chop(b * c, fmt_id), fmt_id)
    else:
        r = chop(_BINARY[form](a, b), fmt_id)
    if live is not None:
        if r.ndim != 1:
            raise ValueError("chop: a live range takes a 1-D result, not "
                             f"{r.ndim}-D")
        lo, hi = live
        if lo < 0:
            raise ValueError(f"chop: live range {live} starts below 0")
        kept = torch.zeros_like(r)
        kept[lo:hi] = r[lo:hi]
        r = kept
    if out is None:
        return r
    if out.shape != r.shape:
        raise ValueError(f"chop: out has shape {tuple(out.shape)}, the "
                         f"result {tuple(r.shape)}")
    return out.copy_(r)
