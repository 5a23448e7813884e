"""Carry GPT and BERT weights between the JAX package and the port.

The JAX ``GPTModel`` / ``BertModel`` ``init_master`` / ``shard_master(...,
0)`` tree is a nested dict of arrays whose transformer leaves are stacked
on a leading layer axis (``transformer.layers.<leaf>`` of shape [L,
...]); the port has one module per layer (``transformer.layers.<i>.
<leaf>``).  Every other name is the same path joined with dots (BERT's
``lm_head.{dense,layernorm}.*``, ``lm_head.bias``, ``pooler``,
``binary_head`` and ``tokentype_embeddings`` are the port's submodule
names), and every layout is the same ([out, in] weights, [vocab, hidden]
embedding), so nothing is transposed.  Arrays travel as numpy.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_LAYERS = "transformer.layers"


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``GPTModel`` or ``BertModel`` state_dict from a JAX GPT
    or BERT param tree."""
    sd = {}
    for name, arr in _flatten(tree).items():
        if name.startswith(_LAYERS + "."):
            leaf = name[len(_LAYERS) + 1:]
            for i, a in enumerate(arr):
                sd[f"{_LAYERS}.{i}.{leaf}"] = torch.from_numpy(np.array(a))
        else:
            sd[name] = torch.from_numpy(np.array(arr))
    return sd


def jax_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The JAX GPT or BERT param tree (numpy leaves, layers stacked) from
    the port's state_dict or a dict of its gradients under the same
    names."""
    flat, stacks = {}, {}
    for name, t in sd.items():
        a = t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()
        if name.startswith(_LAYERS + "."):
            i, leaf = name[len(_LAYERS) + 1:].split(".", 1)
            stacks.setdefault(leaf, {})[int(i)] = a
        else:
            flat[name] = a
    for leaf, per_layer in stacks.items():
        flat[f"{_LAYERS}.{leaf}"] = np.stack(
            [per_layer[i] for i in range(len(per_layer))])
    return nest(flat)


def nest(flat: Mapping[str, object]) -> dict:
    """The nested dict of a ``{"a.b.c": leaf}`` mapping (the inverse of
    joining a JAX tree's path with dots)."""
    tree: dict = {}
    for name, a in flat.items():
        node = tree
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = a
    return tree
