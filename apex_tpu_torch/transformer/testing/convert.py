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

:func:`dense_state_dict_from_jax` carries the parameters of the JAX
``FusedDense`` / ``FusedDenseGeluDense`` (a dict) and ``MLP`` (a list of
layer dicts) ``init`` onto the port's modules of :mod:`apex_tpu_torch.ops.
fused_dense` and :mod:`apex_tpu_torch.ops.mlp`.

Pipeline stages: :func:`stage_state_dict` cuts a whole model's
``state_dict`` to one stage's (its layer slice, renumbered from 0; the
word and position embeddings on the first stage; the final LayerNorm and
a copy of the word embedding on the last), as the JAX tests and bench.py
slice a master for ``make_gpt_stage_fns``; :func:`stage_state_dict_from_jax`
does so from a JAX master.

Tensor-parallel trees: the JAX example stacks the ``shard_master`` trees
of its tp ranks on a leading axis (``examples/gpt/pretrain_gpt.py``);
:func:`rank_state_dict_from_jax` takes tp rank r's ``state_dict`` out of
such a tree and :func:`stacked_jax_tree` stacks the ranks' state dicts
back into it.

Mixture-of-Experts leaves travel as any other: the JAX stacked
``transformer.layers.mlp.gate.weight`` [L, H, E] and
``transformer.layers.mlp.experts.{w1, b1, w2, b2}`` [L, E, ...] are the
port's ``transformer.layers.<i>.mlp.gate.weight`` and
``...mlp.experts.w1`` per layer (a bare ``SwitchMLP``'s tree is its
``state_dict`` under the same names).  :func:`expert_state_dict_from_jax`
cuts an expert rank's experts out of such a tree (the JAX
``SwitchMLP.shard_master``) and :func:`jax_tree_from_expert_ranks` puts
the ranks' back together.

The ZeRO flagship: its ``params`` are JAX's master tree itself (nested
dicts, layers stacked), carried by :func:`master_from_jax` and
:func:`master_to_jax`; its optimizer state is JAX's
``ShardedOptState`` with leading stack axes (``[n]`` or ``[dp, pp, tp]``)
of which each port rank holds its block: :func:`zero_state_from_jax`
takes rank r's block (leading dims of 1) out of JAX's stacks and
:func:`zero_state_to_jax` stacks the ranks' blocks back.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

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


def stage_state_dict(sd: Mapping[str, torch.Tensor], stage: int, pp: int,
                     *, chunk: int = 0, vpp: int = 1
                     ) -> Dict[str, torch.Tensor]:
    """Virtual stage ``stage + pp * chunk``'s ``state_dict`` out of a whole
    GPT's (the port's names; any tp rank's shard): layers ``[v n, (v + 1)
    n)`` renumbered from 0 (``n = layers / (pp * vpp)``), plus the word
    and position embeddings on the first virtual stage and the final
    LayerNorm and the word embedding (the head's own copy) on the
    last."""
    n_layers = 1 + max(int(k[len(_LAYERS) + 1:].split(".", 1)[0])
                       for k in sd if k.startswith(_LAYERS + "."))
    V = pp * vpp
    if n_layers % V:
        raise ValueError(f"{n_layers} layers do not split into {V} stages")
    n = n_layers // V
    v = stage + pp * chunk
    out = {}
    for name, t in sd.items():
        if name.startswith(_LAYERS + "."):
            i, leaf = name[len(_LAYERS) + 1:].split(".", 1)
            if v * n <= int(i) < (v + 1) * n:
                out[f"{_LAYERS}.{int(i) - v * n}.{leaf}"] = t
        elif name.startswith("embedding."):
            if v == 0 or v == V - 1:
                out[name] = t
        elif name.startswith("position_embeddings."):
            if v == 0:
                out[name] = t
        elif name.startswith("final_layernorm."):
            if v == V - 1:
                out[name] = t
        else:
            raise ValueError(f"{name}: not a GPT parameter")
    return out


def stage_state_dict_from_jax(master: Mapping, stage: int, pp: int,
                              tp_rank: Optional[int] = None, *,
                              chunk: int = 0, vpp: int = 1
                              ) -> Dict[str, torch.Tensor]:
    """:func:`stage_state_dict` of a JAX GPT master: an ``init_master`` /
    ``shard_master(..., 0)`` tree, or with ``tp_rank`` a tree whose leaves
    carry a leading tp axis (the ranks' ``shard_master`` trees
    stacked)."""
    sd = (state_dict_from_jax(master) if tp_rank is None
          else rank_state_dict_from_jax(master, tp_rank))
    return stage_state_dict(sd, stage, pp, chunk=chunk, vpp=vpp)


def rank_state_dict_from_jax(stacked: Mapping, rank: int
                             ) -> Dict[str, torch.Tensor]:
    """Tensor-parallel rank ``rank``'s ``state_dict`` from a JAX tree whose
    every leaf has a leading tp axis."""
    return state_dict_from_jax(
        nest({k: a[rank] for k, a in _flatten(stacked).items()}))


def stacked_jax_tree(state_dicts: Sequence[Mapping[str, torch.Tensor]]
                     ) -> dict:
    """The JAX tree with a leading tp axis from the tp ranks' state dicts
    (rank order)."""
    flats = [_flatten(jax_tree_from_state_dict(sd)) for sd in state_dicts]
    return nest({k: np.stack([f[k] for f in flats]) for k in flats[0]})


def dense_state_dict_from_jax(params: Union[Mapping, Sequence[Mapping]]
                              ) -> Dict[str, torch.Tensor]:
    """The state_dict of the port's ``FusedDense`` or ``FusedDenseGeluDense``
    (a JAX ``init`` dict: the same paths) or ``MLP`` (a JAX ``init`` list:
    layer i's ``weight`` / ``bias`` as ``weight_<i>`` / ``bias_<i>``)."""
    if isinstance(params, Mapping):
        flat = _flatten(params)
    else:
        flat = {f"{leaf}_{i}": a for i, layer in enumerate(params)
                for leaf, a in _flatten(layer).items()}
    return {k: torch.from_numpy(np.array(a)) for k, a in flat.items()}


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


def expert_state_dict_from_jax(tree: Mapping, rank: int, world: int
                               ) -> Dict[str, torch.Tensor]:
    """Expert rank ``rank``'s ``state_dict`` (of ``world``) from a JAX MoE
    GPT or ``SwitchMLP`` tree: each layer's experts ``[rank·E/w,
    (rank+1)·E/w)``, the gate and every other leaf whole."""
    from apex_tpu_torch.transformer.moe import shard_master

    return shard_master(state_dict_from_jax(tree), rank, world)


def jax_tree_from_expert_ranks(state_dicts: Sequence[Mapping[str,
                                                             torch.Tensor]]
                               ) -> dict:
    """The JAX tree (numpy leaves, layers stacked) from the expert ranks'
    state dicts or gradients (rank order): the experts concatenated, the
    other leaves rank 0's."""
    from apex_tpu_torch.transformer.moe import unshard_master

    return jax_tree_from_state_dict(unshard_master(
        [dict(sd) for sd in state_dicts]))


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


def _np32(a) -> np.ndarray:
    """An array as numpy, a bf16 (ml_dtypes) one as fp32 (exact)."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        a = a.astype(np.float32)
    return a


def master_from_jax(tree, *, device="cpu", dtype: Optional[torch.dtype]
                    = None):
    """A JAX master tree (nested dicts of arrays) as the same tree of
    tensors on ``device`` (in ``dtype``, default the arrays' own, bf16
    kept bf16)."""
    if isinstance(tree, Mapping):
        return {k: master_from_jax(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=dtype or tree.dtype)
    bf16 = str(np.asarray(tree).dtype) == "bfloat16"
    t = torch.from_numpy(np.array(_np32(tree)))
    return t.to(device=device, dtype=dtype or (torch.bfloat16 if bf16
                                               else t.dtype))


def _bits_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def master_to_jax(params) -> dict:
    """The port flagship's master tree as nested dicts of numpy arrays
    (bf16 leaves as fp32, exact; cast with the JAX plan's dtype)."""
    if isinstance(params, Mapping):
        return {k: master_to_jax(v) for k, v in params.items()}
    return _bits_np(params)


def zero_state_from_jax(opt_state, rank: int, *, device="cpu"):
    """Rank ``rank``'s block of a JAX ``ShardedOptState`` whose leaves
    carry leading stack axes (``step`` is ``[n]`` or ``[dp, pp, tp]``):
    each leaf indexed at the rank's coordinate (C order over the stack
    axes, the ``parallel_state`` layout) keeping a dim of 1 per axis."""
    from apex_tpu_torch.contrib.optimizers import ShardedOptState

    step = _np32(opt_state.step)
    lead = step.shape
    c = np.unravel_index(rank, lead)
    idx = tuple(slice(int(i), int(i) + 1) for i in c)

    def take(leaf, dtype=None):
        raw = np.asarray(leaf)
        t = torch.from_numpy(np.array(_np32(raw)[idx]))
        if str(raw.dtype) == "bfloat16":
            t = t.to(torch.bfloat16)
        return t.to(device=device, dtype=dtype or t.dtype)

    return ShardedOptState(take(opt_state.step, torch.int32),
                           take(opt_state.exp_avg),
                           take(opt_state.exp_avg_sq))


def zero_state_to_jax(states: Sequence, lead_shape) -> tuple:
    """The ranks' ``ShardedOptState`` blocks (rank order) stacked into
    JAX's ``[*lead_shape, ...]`` leaves: a ``ShardedOptState`` of numpy
    arrays (bf16 moments as fp32, exact)."""
    from apex_tpu_torch.contrib.optimizers import ShardedOptState

    lead_shape = tuple(int(x) for x in lead_shape)
    n = len(lead_shape)

    def stack(field):
        blocks = [_bits_np(getattr(s, field)).reshape(
            getattr(s, field).shape[n:]) for s in states]
        return np.stack(blocks).reshape(lead_shape + blocks[0].shape)

    return ShardedOptState(*(stack(f) for f in ShardedOptState._fields))
