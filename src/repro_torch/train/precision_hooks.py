"""LM-side precision policy: the paper's bandit driving the training
stack (port of `repro.train.precision_hooks`).

`LMPrecisionPolicy` is the object `models.layers.dot` routes through. An
action is a monotone tuple over the ladder e4m3 <= bf16 <= fp32 for three
step groups, the LM analogue of (u_f, u, u_g, u_r):

  step "attn"/"ffn"/"ssm" : matmul operand format (emulated through the
                            chop kernel's wrapper, or a native cast)
  step "comm"             : cross-pod gradient-sync format
                            (`train.grad_sync`)
  step "opt"              : optimizer-moment format (int8 when below bf16)

Context features (the kappa/norm analogues): log10 grad-norm ratio and
log10 update-to-weight ratio. Rewards follow Eq. 21's shape: precision
savings, accuracy = -loss-degradation, penalty = divergence.

Under emulation the matmul's operands are rounded by
`kernels.chop.chop_op` (on a CUDA tensor one launch of the chop kernel
each, on a CPU tensor its plain version) and carry no gradient: the
reference's `chop` has a zero derivative (its bitcast chain), so a loss
under an emulated policy reaches no weight through a policy matmul
(`train.train_step` reads the missing gradients as zeros).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.action_space import reduced_action_space
from repro_torch.core.bandit import QTable, epsilon_schedule
from repro_torch.core.discretize import Discretizer
from repro_torch.kernels.chop import chop_op
from repro_torch.precision import FORMAT_ID, FORMATS

TPU_LADDER = ("e4m3", "bf16", "fp32")
STEP_GROUPS = ("matmul", "comm", "opt")


def _chop(x: torch.Tensor, fmt: int) -> torch.Tensor:
    return chop_op(x.detach().contiguous(), fmt)


@dataclasses.dataclass
class LMPrecisionPolicy:
    """Per-train-step matmul routing. The format id is runtime data (an
    int handed to the chop kernel), so switching it rebuilds nothing."""
    matmul_fmt: int              # format id
    comm_fmt: int = FORMAT_ID["bf16"]
    opt_8bit: bool = False
    emulate: bool = True         # chop-based emulation vs native casts

    def matmul(self, x: torch.Tensor, w: torch.Tensor,
               step: str) -> torch.Tensor:
        w = w.to(x.dtype)
        if self.emulate:
            fmt = int(self.matmul_fmt)
            out = torch.matmul(_chop(x.float(), fmt), _chop(w.float(), fmt))
            return out.to(x.dtype)
        return torch.matmul(x, w)


def default_policy(fmt: str = "bf16") -> LMPrecisionPolicy:
    return LMPrecisionPolicy(FORMAT_ID[fmt])


class TrainPrecisionController:
    """Online contextual bandit over train-step precision actions.

    Reuses the paper's exact core (reduced action space, binned context,
    tabular Q, eps-greedy with linear decay): the port's copies of
    `core.action_space`, `core.bandit` and `core.discretize`, whose numpy
    generator gives the JAX package's decisions for a seed. One decision
    every `interval` steps; the reward for the previous interval is
    observed before the next action is chosen."""

    def __init__(self, total_decisions: int, interval: int = 20,
                 n_bins=(6, 6), alpha: float = 0.5, eps_min: float = 0.05,
                 seed: int = 0, w_accuracy: float = 1.0,
                 w_precision: float = 0.2):
        self.space = reduced_action_space(TPU_LADDER, k=len(STEP_GROUPS))
        self.disc = Discretizer(np.array([-2.0, -4.0]),
                                np.array([2.0, 0.0]), tuple(n_bins))
        self.qt = QTable(self.disc.n_states, self.space.n_actions, alpha,
                         seed)
        self.interval = interval
        self.total = total_decisions
        self.eps_min = eps_min
        self.decision = 0
        self.w_acc = w_accuracy
        self.w_prec = w_precision
        self._pending = None      # (state, action)
        self.history = []

    # -- feature extraction -------------------------------------------------
    @staticmethod
    def features(grad_norm_ratio: float, update_weight_ratio: float):
        return np.array([np.log10(max(grad_norm_ratio, 1e-2)),
                         np.log10(max(update_weight_ratio, 1e-4))])

    def act(self, feats: np.ndarray) -> LMPrecisionPolicy:
        s = int(self.disc(feats))
        eps = epsilon_schedule(self.decision, self.total, self.eps_min)
        a = self.qt.select(s, eps)
        self._pending = (s, a)
        self.decision += 1
        fmt_ids = self.space.actions[a]
        return LMPrecisionPolicy(
            matmul_fmt=int(fmt_ids[0]), comm_fmt=int(fmt_ids[1]),
            opt_8bit=bool(self.space.ladder_idx[a][2] == 0))

    def observe(self, loss_before: float, loss_after: float,
                diverged: bool = False):
        """Close the loop for the last action (Eq. 21-shaped reward)."""
        if self._pending is None:
            return
        s, a = self._pending
        t_bits = np.array([FORMATS[self.space.ladder[i]].t
                           for i in self.space.ladder_idx[a]])
        prec = float(np.sum(FORMATS["fp32"].t / t_bits)) / len(t_bits)
        d = loss_after - loss_before
        acc = -10.0 * max(d, 0.0) + min(-d, 0.1) * 10.0
        r = self.w_prec * prec + self.w_acc * acc
        if diverged or not np.isfinite(loss_after):
            r = -30.0
        rpe = self.qt.update(s, a, r)
        self.history.append({"state": s, "action": a, "reward": r,
                             "rpe": rpe})
        self._pending = None
