"""Sharding rules: parameter, optimizer, input and cache specs (port of
`repro.distributed.sharding`).

Uniform strategy (DESIGN.md §5): tensor-parallel on the "model" axis
(attention heads, FFN hidden, MoE experts, vocab) x ZeRO-3-style FSDP on
the data axes (("pod", "data") when multi-pod) on each parameter's
non-TP dimension; batch over the data axes; sequence-parallel residual
stream (S over "model") between scan groups.

Rules are name-based over the tree paths and divisibility-checked: an
axis that does not divide a dimension is dropped (predictable layouts
beat padded ones at this scale).

A mesh is anything with `mesh_dim_names` and `shape` (a tuple of
sizes), as `torch.distributed.device_mesh.DeviceMesh` has; the rules
read nothing else. A spec (`PartitionSpec`) keeps the JAX package's
form: one entry per tensor dimension (fewer when the trailing ones are
unsharded), each None, an axis name or a tuple of names. `named` turns a
spec into DTensor placements, one per mesh dimension.

The trees are the port's: nested dicts, lists, tuples and NamedTuples
(`TrainState`, `AdamWState`, `QTensor`, the caches), whose leaves have
a `.shape`. `_path_str` names a leaf as the JAX package names the same
leaf of its tree: dict keys, `[i]` for a list or tuple position, field
names for a NamedTuple, joined by "/".
"""
from __future__ import annotations

import math
import re
from typing import Tuple


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis
    name, or a tuple of names (the dimension split over all of them, in
    that order). A frozen tuple, so it compares entry for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def _fit(dim: int, axes, mesh):
    """Return axes if they divide dim (and dim is nontrivial), else None."""
    if axes is None or dim <= 1:
        return None
    size = axes_size(mesh, axes)
    if size > 1 and dim % size == 0:
        return axes
    return None


# (regex on the leaf path, role per trailing dimension)
# roles: "fsdp", "model", None; applied to the LAST len(roles) dims.
_PARAM_RULES = [
    (r"embedding$", ("model", "fsdp")),
    (r"unembed$", ("fsdp", "model")),
    # MoE expert banks (E, d, f) / (E, f, d): expert-parallel on model.
    (r"ffn/(wi_gate|wi_up)$/3d", ("model", "fsdp", None)),
    (r"ffn/wo$/3d", ("model", None, "fsdp")),
    (r"router$", ("fsdp", None)),
    # Dense FFN (d, f) / (f, d).
    (r"(wi_gate|wi_up)$", ("fsdp", "model")),
    (r"ffn/wo$", ("model", "fsdp")),
    (r"shared/wo$", ("model", "fsdp")),
    # Attention.
    (r"(wq|wk|wv)$", ("fsdp", "model")),
    (r"mixer/wo$", ("model", "fsdp")),
    # MLA.
    (r"w_dkv$", ("fsdp", None)),
    (r"w_kr$", ("fsdp", None)),
    (r"w_dq$", ("fsdp", None)),
    (r"(w_uk|w_uv|w_uq)$", (None, "model", None)),
    # Mamba.
    (r"in_proj$", ("fsdp", "model")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"x_proj$", ("model", None)),
    (r"dt_proj$", (None, "model")),
    (r"dt_bias$", ("model",)),
    (r"A_log$", ("model", None)),
    (r"D$", ("model",)),
    (r"out_proj$", ("model", "fsdp")),
]


def _path_str(path) -> str:
    return "/".join(path)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn, tree, path=(), is_leaf=None):
    """`fn(path, leaf)` over the leaves of `tree` (module docstring),
    `path` the tuple of the leaf's keys, the structure kept; None stays
    None, as in a JAX pytree. `is_leaf(x)` true stops the walk at x."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),), is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_path(fn, v, path + (f,), is_leaf)
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, path + (f"[{i}]",), is_leaf)
            for i, v in enumerate(tree))
    return fn(path, tree)


def spec_for_param(path_str: str, shape: Tuple[int, ...], mesh) -> P:
    fsdp = data_axes(mesh) or None
    ndim = len(shape)
    # QTensor leaves: codes share the param's shape; scales share its rank.
    core = re.sub(r"/(codes|scales)$", "", path_str)
    # Scan-stacked layer params carry a leading group dim (never sharded).
    stacked = core.startswith("layers") or "/layers/" in core
    base_ndim = ndim - (1 if stacked else 0)
    for pat, roles in _PARAM_RULES:
        want3d = pat.endswith("/3d")
        pat_core = pat[:-3] if want3d else pat
        if not re.search(pat_core, core):
            continue
        # 3d rules target MoE expert banks (E, d, f); dense FFN leaves with
        # the same names have base rank 2 and fall through to the 2d rule.
        if want3d and base_ndim != 3:
            continue
        nr = len(roles)
        if ndim < nr:
            continue
        entries = [None] * (ndim - nr)
        for dim, role in zip(shape[ndim - nr:], roles):
            ax = {"fsdp": fsdp, "model": "model", None: None}[role]
            entries.append(_fit(dim, ax, mesh))
        return P(*entries)
    return P()  # replicate (norms, scalars, step counters)


def param_specs(params_shapes, mesh):
    """PartitionSpec tree mirroring a params / optimizer-state tree."""
    def leaf_spec(path, leaf):
        return spec_for_param(_path_str(path), tuple(leaf.shape), mesh)
    return tree_map_with_path(leaf_spec, params_shapes)


def named(tree_specs, mesh):
    """Each spec as DTensor placements, one per mesh dimension: `Shard(d)`
    on every mesh dimension that tensor dimension `d` is split over (a
    dimension over ("pod", "data") is `Shard(d)` on both), `Replicate()`
    on a mesh dimension no tensor dimension uses."""
    from torch.distributed.tensor import Replicate, Shard

    def placements(_, spec):
        out = []
        for name in mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)
    return tree_map_with_path(placements, tree_specs,
                          is_leaf=lambda x: isinstance(x, PartitionSpec))


# ---------------------------------------------------------------------------
# Batch + cache specs
# ---------------------------------------------------------------------------

def batch_spec(shape: Tuple[int, ...], mesh) -> P:
    """(B, S, ...) host batch: B over the data axes when divisible."""
    dp = data_axes(mesh) or None
    first = _fit(shape[0], dp, mesh)
    return P(first, *([None] * (len(shape) - 1)))


def batch_specs(batch_shapes, mesh):
    return tree_map_with_path(lambda _, l: batch_spec(tuple(l.shape), mesh),
                          batch_shapes)


def cache_spec(path_str: str, shape: Tuple[int, ...], mesh) -> P:
    dp = data_axes(mesh) or None
    if path_str.endswith("length") or len(shape) <= 1:
        return P()
    b_ax = _fit(shape[0], dp, mesh)
    if re.search(r"/(k|v)$", path_str) and len(shape) == 4:
        b, s, h, d = shape
        h_ax = _fit(h, "model", mesh)
        s_ax = None
        if b_ax is None:                 # long-context: shard sequence
            s_ax = _fit(s, dp, mesh)
        if h_ax is None and s_ax is None:
            s_ax = _fit(s, "model", mesh)
        return P(b_ax, s_ax, h_ax, None)
    if re.search(r"/ckv$|/k_rope$", path_str) and len(shape) == 3:
        b, s, r = shape
        s_ax = _fit(s, dp, mesh) if b_ax is None else None
        return P(b_ax, s_ax, None)
    if re.search(r"/h$", path_str) and len(shape) == 3:   # mamba state
        b, di, ds = shape
        return P(b_ax, _fit(di, "model", mesh), None)
    if re.search(r"/conv$", path_str) and len(shape) == 3:
        b, k, di = shape
        return P(b_ax, None, _fit(di, "model", mesh))
    # stacked (group, ...) cache entries: recurse on trailing dims
    if len(shape) >= 2:
        inner = cache_spec(path_str, shape[1:], mesh)
        return P(None, *inner)
    return P()


def cache_specs(cache_shapes, mesh):
    def leaf(path, l):
        ps = _path_str(path)
        shape = tuple(l.shape)
        # Stacked scan caches carry a leading group dim.
        if ps.startswith("layers"):
            inner = cache_spec(ps, shape[1:], mesh)
            return P(None, *inner)
        return cache_spec(ps, shape, mesh)
    return tree_map_with_path(leaf, cache_shapes)


def residual_spec(mesh) -> P:
    """Sequence-parallel residual stream between scan groups (B, S, d)."""
    dp = data_axes(mesh) or None
    return P(dp, "model", None)
