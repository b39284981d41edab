"""Plain torch version of the chop kernel: `repro_torch.precision.chop`
(itself held bit for bit against `repro.precision.chop`)."""
from __future__ import annotations

import torch

from repro_torch.precision.chop import chop


def chop_ref(x: torch.Tensor, fmt_id) -> torch.Tensor:
    return chop(x, fmt_id)
