"""The premise of the "shfl" routes of the qmv and trisolve kernels, on the
CPU, before any card: the plain models of their order hold bit for bit
against both packages.

  * `kernels.lanes.lane_tree_sum`, the register tree (lane layout, in-lane
    levels, xor butterfly with swapped operands on the upper lanes, the
    shared-memory tail), on every lane, against the port's `tree_sum` and
    the JAX package's, at widths 1-33, 48, 96, 100, 128, 256, 384, 512
    and 640; and the chopped matvec summed by it against `qmv_ref` of
    both packages.
  * `kernels.trisolve.checks.trisolve_lanes`, the solve reorganised as the
    kernel runs it (tiles summed ahead, acc = 0 + T_first + ..., the chain
    row by row on the owner lane), against `trisolve_ref` of both
    packages, both directions, blocks 16, 32 and 128.

Inputs: numpy from a seed, magnitudes spread over six decades (so that
two orders differ in the last bits), and the special operands of
`lanes.special_matvec` / `trisolve.checks.special_system` (signed zeros,
NaN, infinities, subnormals). Bit for bit with one exception: every NaN
reads as one NaN. The card returns one canonical NaN whatever the
operands, while the CPU keeps a NaN operand's payload and picks the
first operand's, so the butterfly's swapped operands give other NaN bits
here. The JAX package is left out where the subnormal operands reach
float32's subnormal range (formats with emin -126: bf16, tf32, fp32,
fp64): XLA on the CPU flushes float32 subnormals to zero, the torch
versions and the card keep them. Planted faults (acc = T_first, a
masked +0 skipped, a reordered level) fail the same comparison. No
solver is compiled.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.qmatmul.ref import qmv_ref as jqmv_ref
from repro.kernels.trisolve.ref import trisolve_ref as jtrisolve_ref
from repro.precision.chop import tree_sum as jtree_sum
from repro_torch.kernels import library
from repro_torch.kernels.lanes import (SPECIAL_KINDS, butterfly_offsets,
                                       lane_tree_sum, special_matvec)
from repro_torch.kernels.qmatmul import (LANE, QMV_ROUTES, qmv_op, qmv_ref,
                                         qmv_route)
from repro_torch.kernels.trisolve import (ROUTES, trisolve_op, trisolve_ref,
                                          trisolve_route)
from repro_torch.kernels.trisolve.checks import (fold_from_zero, lane_sum,
                                                 special_system,
                                                 trisolve_lanes)
from repro_torch.precision import FORMAT_LIST, chop
from repro_torch.precision.chop import tree_sum

WIDTHS = list(range(1, 34)) + [48, 96, 100, 128, 256, 384, 512, 640]
KINDS = ("random",) + SPECIAL_KINDS
_jqmv = jax.jit(jqmv_ref, static_argnames=("chop_out",))


def _bits(x) -> torch.Tensor:
    """int32 bit patterns of float32 `x`, every NaN as one NaN."""
    x = torch.tensor(np.array(x))
    x[torch.isnan(x)] = float("nan")
    return x.view(torch.int32)


def _jax_holds(kind, fid):
    """Whether the JAX package computes this case as the card does: not
    where XLA's flush of float32 subnormals on the CPU reaches it."""
    return kind != "subnormal" or FORMAT_LIST[fid].emin > -126


def _rows(width, seed):
    """Rows that tell orders apart: six decades of magnitude; one row of
    -0 and +0; one of -0 only; one with NaN, +-inf and subnormals."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, width))
         * 10.0 ** rng.integers(-3, 4, (6, width))).astype(np.float32)
    x[3] = np.where(rng.random(width) < 0.5, -0.0, 0.0)
    x[4] = -0.0
    x[5, rng.integers(0, width, 2)] = [np.nan, np.inf]
    x[5, rng.integers(0, width, 2)] = [-np.inf, 1e-40]
    return x


@pytest.mark.parametrize("width", WIDTHS)
def test_lane_tree_sum_is_tree_sum_on_every_lane(width):
    x = _rows(width, seed=width)
    want = tree_sum(torch.from_numpy(x))
    assert torch.equal(_bits(want), _bits(jtree_sum(jnp.asarray(x))))
    for lane in range(32):
        got = lane_tree_sum(torch.from_numpy(x), lane=lane)
        assert torch.equal(_bits(got), _bits(want)), lane


def _qmv_lanes(a, v, fid, chop_out):
    """The "shfl" kernel's matvec: rounded operands, products zero-padded
    to Kp, lane 0 of the register tree, the output rounded."""
    pad = -a.shape[1] % LANE
    p = chop(F.pad(a, (0, pad)), fid) * chop(F.pad(v, (0, pad)), fid)
    s = lane_tree_sum(p)
    return chop(s, fid) if chop_out else s


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K", [100, 128, 300, 384, 640, 1000])
def test_qmv_in_lane_order_equals_qmv_ref(K, kind):
    for fid in range(len(FORMAT_LIST)):
        if kind == "random":
            rng = np.random.default_rng(K + fid)
            a = torch.from_numpy((rng.standard_normal((9, K)) * 10.0 **
                                  rng.integers(-2, 3, (9, K)))
                                 .astype(np.float32))
            v = torch.from_numpy(rng.standard_normal(K).astype(np.float32))
        else:
            a, v = special_matvec(kind, fid, 9, K, seed=K + fid)
        for chop_out in (True, False):
            got = _qmv_lanes(a, v, fid, chop_out)
            assert torch.equal(_bits(got),
                               _bits(qmv_ref(a, v, fid, chop_out=chop_out)))
            if _jax_holds(kind, fid):
                assert torch.equal(_bits(got), _bits(_jqmv(
                    jnp.asarray(a.numpy()), jnp.asarray(v.numpy()), fid,
                    chop_out=chop_out)))


# (block, n): three block rows or more, the last one ragged.
BLOCK_N = {16: 37, 32: 70, 128: 150}


def _system(kind, fid, n, seed):
    if kind != "random":
        return special_system(kind, fid, n, seed)
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) * 10.0 ** rng.integers(-2, 2, (n, n))
    M[np.diag_indices(n)] = rng.choice([-1.0, 1.0], n) * (2.0 + rng.random(n))
    return (torch.from_numpy(M.astype(np.float32)),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)))


@functools.lru_cache(maxsize=None)
def _jax_solver(lower, block):
    return functools.partial(jtrisolve_ref, lower=lower, block=block)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block", sorted(BLOCK_N))
@pytest.mark.parametrize("lower", [True, False])
def test_trisolve_in_kernel_order_equals_trisolve_ref(lower, block, kind):
    n = BLOCK_N[block]
    for fid in sorted({2, block % 7, (block + len(kind)) % 7}):
        Lu, b = _system(kind, fid, n, seed=block + fid)
        got = trisolve_lanes(Lu, b, fid, lower=lower, block=block)
        want = trisolve_ref(Lu, b, fid, lower=lower, block=block)
        assert torch.equal(_bits(got), _bits(want)), fid
        if _jax_holds(kind, fid):
            jwant = _jax_solver(lower, block)(jnp.asarray(Lu.numpy()),
                                              jnp.asarray(b.numpy()), fid)
            assert torch.equal(_bits(got), _bits(jwant)), fid


def _skip_masked(p, live, lane):
    """A planted fault: the lane tree that skips the add of a masked +0
    (and of any subtree of them) instead of adding it."""
    if live is None:
        return lane_sum(p, live, lane)
    v = p.reshape(-1, 32) if p.numel() >= 32 else p[None]
    m = live.reshape(v.shape)
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        a, b, ma, mb = v[:h], v[h:], m[:h], m[h:]
        v = torch.where(ma & mb, a + b, torch.where(ma, a, b))
        m = ma | mb
    v, m = v[0], m[0]
    idx = torch.arange(v.shape[0])
    for o in butterfly_offsets(v.shape[0]):
        a, b, ma, mb = v, v[idx ^ o], m, m[idx ^ o]
        v = torch.where(ma & mb, a + b, torch.where(ma, a, b))
        m = ma | mb
    return torch.where(m, v, torch.zeros(()))[lane % v.shape[0]]


def _acc_from_first(tiles, width):
    """A planted fault: the accumulator starts at the first tile's sum."""
    if not tiles:
        return torch.zeros(width)
    acc = tiles[0]
    for t in tiles[1:]:
        acc = acc + t
    return acc


def _reordered(p, live, lane):
    """A planted fault: the butterfly's levels in the reverse order."""
    return lane_tree_sum(p, lane=lane, offsets=(1, 2, 4, 8, 16))


# fault -> (operands, format id, hooks). The sign faults show on signed
# zeros; a reordered level shows in fp32, whose chop keeps every bit of
# the sum (a bf16 rounding of the subtraction hides most of them).
FAULTS = {"acc = T_first": ("signed zeros", 2, dict(fold=_acc_from_first)),
          "skipped masked +0": ("signed zeros", 2, dict(tree=_skip_masked)),
          "reordered level": ("random", 5, dict(tree=_reordered))}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("lower", [True, False])
def test_planted_fault_fails(fault, lower):
    kind, fid, hooks = FAULTS[fault]
    # n 256: no padding, whose +0 right-hand side would add a +0 to the
    # upper solve's tiles.
    Lu, b = _system(kind, fid, 256, seed=3)
    want = _bits(trisolve_ref(Lu, b, fid, lower=lower, block=128))
    good = trisolve_lanes(Lu, b, fid, lower=lower, block=128, tree=lane_sum,
                          fold=fold_from_zero)
    bad = trisolve_lanes(Lu, b, fid, lower=lower, block=128, **hooks)
    assert torch.equal(_bits(good), want)
    assert not torch.equal(_bits(bad), want)


def test_reordered_butterfly_fails_tree_sum():
    x = torch.from_numpy(_rows(128, seed=1)[:3])
    assert not torch.equal(_bits(lane_tree_sum(x, offsets=(1, 2, 4, 8, 16))),
                           _bits(tree_sum(x)))


def test_routes_take_the_main_path_on_shfl():
    """qmv: Kp 128..1024 on "shfl", K = 0 and Kp > 1024 on "smem"; trisolve:
    the powers of two up to 128 on "shfl" while their buffers fit, other
    widths on "smem". The main path's shapes (Kp and n_pad 128..512,
    block 128) are all on "shfl"."""
    assert QMV_ROUTES == {kp: "shfl" for kp in range(128, 1025, 128)}
    assert [qmv_route(k) for k in (0, 1, 384, 1000, 1024, 1025)] == \
        ["smem", "shfl", "shfl", "shfl", "shfl", "smem"]
    assert ROUTES == {w: "shfl" for w in (1, 2, 4, 8, 16, 32, 64, 128)}
    for n_pad in (128, 256, 384, 512):
        assert qmv_route(n_pad) == "shfl"
        assert trisolve_route(n_pad, 128) == "shfl"
    assert trisolve_route(512, 100) == "smem"
    assert trisolve_route(12288, 128) == "shfl"
    assert trisolve_route(12289, 128) == "smem"


def test_cpu_takes_any_route_and_runs_the_plain_version():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((20, 40)).astype(np.float32))
    library.reset_launches()
    for route in (None, "shfl", "smem"):
        assert torch.equal(qmv_op(a, a[0], 2, route=route),
                           qmv_ref(a, a[0], 2))
        assert torch.equal(
            trisolve_op(a[:, :20], a[0, :20], 2, lower=True, block=8,
                        route=route),
            trisolve_ref(a[:, :20], a[0, :20], 2, lower=True, block=8))
    assert sum(library.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        qmv_op(a, a[0], 2, route="tensor")
    with pytest.raises(ValueError):
        trisolve_op(a[:, :20], a[0, :20], 2, lower=True, route="tensor")
