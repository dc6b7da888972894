"""Carry parameters across from and back to the JAX package.

``init_params`` in the two packages draws different random numbers from
the same seed, so parity runs take the reference's parameter pytree,
converted to numpy by the caller (``jax.tree.map(np.asarray, params)``),
and load it into the port's modules here: the top-level ``embed`` (``[K,
V, D]`` with codebooks), ``vision_proj``, ``meta_tokens``, ``heads`` or
``lm_head`` and ``final_norm`` as they are.  Layouts are the same
(``[d, h, dh]`` projections, ``[in, out]`` matrices; the mLSTM's
``wq_m``/``wk_m``/``wv_m`` ``[d, h, dh]``, the sLSTM's ``wx`` ``[d, h,
4dh]``, ``r`` ``[h, dh, 4dh]`` and ``b`` ``[h, 4dh]``), so nothing is
transposed; the reference stacks each layer group's parameters ``[n,
...]``, and layer ``i`` of group ``g`` is ``groups.{g}.{i}`` here (a MoE
layer's expert stacks ``[n, E, D, F]`` become ``[E, D, F]``).  Each
value takes the port's parameter's dtype: a MoE router stays f32, as in
the reference; the blocks' copy in the compute dtype
(``CausalLM.compute_blocks``) rounds it, as the reference's per-block
cast does.  In the serving form (``serving=True``) each block parameter
is read in the dtype it has in that form, then cast to the compute dtype
on load, one at a time: the bits of that copy, and no f32 block held.
:func:`params_to_numpy` is the inverse: the model's
parameters as the reference's pytree of numpy arrays, each group's
layers stacked ``[n, ...]`` again, which is also the layout of a
checkpoint that either package loads (``checkpoint/checkpoint.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.config import DeviceLike, resolve_device
from .config import ModelConfig
from .model import CausalLM, abstract_params, layer_groups


def tree_leaf(tree: Mapping[str, Any], name: str) -> Tuple[Any, Optional[int]]:
    """The reference pytree's leaf for the port's parameter ``name`` (the
    whole stack for a layer parameter) and the index into its layer axis,
    or None: ``groups.0.3.attn.wq`` -> (``tree["groups"][0]["attn"]["wq"]``,
    3)."""
    parts = name.split(".")
    layer = None
    if parts[0] == "groups":
        keys, layer = ("groups", int(parts[1]), *parts[3:]), int(parts[2])
    else:
        keys = tuple(parts)
    node: Any = tree
    for k in keys:
        node = node[k]
    return node, layer


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], device: DeviceLike = None,
                      serving: bool = False) -> CausalLM:
    """The reference's parameters as numpy arrays -> a :class:`CausalLM` on
    ``device`` (``None`` means the card) holding the same values (the
    serving form with ``serving``: its blocks cast on load)."""
    dev = resolve_device(device)
    model = CausalLM(cfg, dev, serving=serving)
    # the dtype each value is read in: the two-copy form's, which casts
    # the serving form's blocks as compute_blocks would
    read = {n: p.dtype for n, p in (abstract_params(cfg) if serving else model).named_parameters()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            try:
                leaf, layer = tree_leaf(tree, name)
            except (KeyError, IndexError) as e:
                raise ValueError(f"{name} {tuple(p.shape)}: not in the reference's tree "
                                 f"(top-level keys {sorted(tree)})") from e
            arr = np.asarray(leaf if layer is None else leaf[layer])
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {arr.shape}, port {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=read[name]))
    return model


def params_to_numpy(cfg: ModelConfig,
                    params: Union[CausalLM, Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """The model's parameters, or any tensors keyed by its parameter names
    (gradients, the optimizer's moments), as the reference's pytree of
    numpy arrays: the top-level leaves as they are, ``final_norm`` a dict,
    ``groups`` a list with one dict a layer group whose leaves stack its
    layers ``[n, ...]`` (a MoE layer's expert stacks ``[n, E, D, F]``).
    Each array has its tensor's dtype (bf16 comes back as f32, which holds
    it exactly)."""
    tree: Dict[str, Any] = {"groups": [{} for _ in layer_groups(cfg)]}
    stacks: List[Dict[Tuple[str, ...], list]] = [{} for _ in layer_groups(cfg)]
    named = params.named_parameters() if isinstance(params, CausalLM) else params.items()
    for name, p in named:
        t = p.detach()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        parts = name.split(".")
        if parts[0] == "groups":
            stacks[int(parts[1])].setdefault(tuple(parts[3:]), []).append(arr)
            continue
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = arr
    for group, leaves in zip(tree["groups"], stacks):
        for path, layers in leaves.items():
            node = group
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.stack(layers)
    return tree
