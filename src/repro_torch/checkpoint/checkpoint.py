"""``.npz`` checkpoints with a manifest, in the reference's layout.

Port of ``repro/checkpoint/checkpoint.py``.  Layout:
``<dir>/step_<N>/arrays.npz`` + ``manifest.json``.  A tree of nested
dicts, lists and tuples is flattened to path-keyed arrays, the keys
joined with ``/`` as the reference joins its pytree paths
(``params/groups/0/attn/wq``), so a checkpoint of the reference's
parameter layout (``models/params.py::params_to_numpy``) loads in either
package.  Writes are atomic (a temp dir, then a rename) and a ``latest``
symlink tracks the newest step.  npz cannot store bf16: a bf16 leaf is
stored as f32, which holds it exactly, and the manifest records the
leaf's own dtype (the reference's records the stored one); restoring
casts to the target's dtype in either package.  The reference's
``restore_sharded`` places each leaf with a sharding; on one card
:func:`restore` places it on the target leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any, prefix: str = ""):
    """(path, leaf) in the reference's order: dict keys sorted, as JAX
    flattens a dict, lists and tuples by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array to store, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), name
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array, as the reference holds
        return arr.astype(np.float32), "bfloat16"
    return arr, arr.dtype.name


def save_checkpoint(directory: str, step: int, tree: Any, metadata: Optional[dict] = None) -> str:
    """Write ``tree`` (leaves: tensors or numpy arrays) as step ``step``;
    returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        flat, dtypes = {}, {}
        for key, leaf in _leaves(tree):
            flat[key], dtypes[key] = _to_numpy(leaf)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    latest = os.path.join(directory, "latest")
    if os.path.islink(latest):
        os.unlink(latest)
    os.symlink(os.path.basename(final), latest)
    return final


def load_checkpoint(directory: str, step: Optional[int] = None) -> Tuple[Dict[str, np.ndarray], dict]:
    """(the flat path-keyed arrays, the manifest) of step ``step``, or of
    the ``latest`` link."""
    path = (
        os.path.join(directory, f"step_{step:08d}")
        if step is not None
        else os.path.join(directory, "latest")
    )
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = dict(z)
    return arrays, manifest


def _rebuild(tree: Any, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, leaves) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return next(leaves)


def restore(directory: str, target: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``target``: each leaf a tensor (the
    value comes back as a tensor of its dtype on its device) or a numpy
    array (a numpy array of its dtype).  A key the checkpoint lacks
    raises ``KeyError``, a shape that differs ``ValueError``, as the
    reference's ``restore_sharded``."""
    arrays, _ = load_checkpoint(directory, step)
    out = []
    for key, leaf in _leaves(target):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != target {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            out.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
        else:
            out.append(arr.astype(leaf.dtype))
    return _rebuild(target, iter(out))
