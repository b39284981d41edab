"""Atomic, versioned checkpointing for fault-tolerant training (port of
`repro.checkpoint.checkpoint`), in the JAX package's on-disk layout.

Layout: <dir>/step_<N>/{arrays.npz, meta.json}, plus <dir>/LATEST written
last (atomic rename), so a crash mid-save never corrupts the restore
path. Keys are the reference's: the tree flattened with dict keys sorted,
list items as `[i]`, NamedTuple fields by name, "/" stored as "|", and a
`QTensor` as its `__qcodes` and `__qscales`. A bf16 tensor is written as
float32 (numpy has no bf16) and restored in the template's dtype, as
`models.params_from_reference` carries the reference's bf16 leaves. So a
checkpoint that either package writes restores into the other's
`TrainState`.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.quantize import QTensor


def _array(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, QTensor):
        out[prefix + "/__qcodes"] = _array(tree.codes)
        out[prefix + "/__qscales"] = _array(tree.scales)
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/[{i}]"))
        return out
    if hasattr(tree, "_fields"):          # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}/{k}"))
        return out
    out[prefix] = _array(tree)
    return out


def _tensor(arr: np.ndarray, like: torch.Tensor, key: str):
    """`arr` as a tensor in the dtype and on the device of the template
    leaf `like`."""
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint {key}: shape {arr.shape}, the "
                         f"template's {tuple(like.shape)}")
    return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, QTensor):
        return QTensor(
            _tensor(flat[prefix + "/__qcodes"], template.codes,
                    prefix + "/__qcodes"),
            _tensor(flat[prefix + "/__qscales"], template.scales,
                    prefix + "/__qscales"))
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}/{k}")
                for k in template}
    if isinstance(template, (list, tuple)) and not hasattr(template,
                                                           "_fields"):
        vals = [_unflatten_into(v, flat, f"{prefix}/[{i}]")
                for i, v in enumerate(template)]
        return type(template)(vals)
    if hasattr(template, "_fields"):
        vals = {k: _unflatten_into(getattr(template, k), flat,
                                   f"{prefix}/{k}")
                for k in template._fields}
        return type(template)(**vals)
    return _tensor(flat[prefix], template, prefix)


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    extra_meta: Optional[Dict] = None) -> str:
    """Atomic save. `state` is any tree (dicts/lists/NamedTuples/QTensor)
    of tensors or arrays."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        flat = _flatten(state)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "|"): v for k, v in flat.items()})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(extra_meta or {})}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # LATEST pointer written last, atomically.
    ptr = os.path.join(ckpt_dir, "LATEST")
    with tempfile.NamedTemporaryFile("w", dir=ckpt_dir, delete=False) as f:
        f.write(os.path.basename(final))
        tmp_ptr = f.name
    os.replace(tmp_ptr, ptr)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure, dtypes and devices of `template`.
    Returns (state, meta)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k.replace("|", "/"): z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return _unflatten_into(template, flat), meta
