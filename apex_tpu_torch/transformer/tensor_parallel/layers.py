"""Tensor-parallel layers at tensor-parallel size 1: column- and
row-parallel linear, vocab-parallel embedding.

PyTorch port of the JAX package's
``apex_tpu/transformer/tensor_parallel/layers.py`` as ``nn.Module``s.
Parameter names and layouts are the JAX package's (``weight`` [out, in],
``bias`` [out]; the embedding's ``weight`` [vocab, hidden]), so a JAX
master tree maps onto a ``state_dict`` name for name
(:mod:`apex_tpu_torch.transformer.testing.convert`).  With one shard the
master weight is the shard and the collectives are identities; a
``tp_size`` above 1 is not ported and raises.

The products keep the JAX rule: x @ W^T accumulated in fp32 from x's
dtype (the weight cast to it), ``ColumnParallelLinear`` adds its bias in
fp32 and then casts to x's dtype; ``RowParallelLinear`` casts first and
adds its bias in fp32 after (the bias follows the all-reduce).  The JAX
layers' shard-routing flags (``gather_output``, ``input_is_parallel``)
and ``skip_bias_add`` have no effect or no caller at one shard and are
not taken.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.ops._gemm import linear_f32

#: init_method(shape, generator, device) -> fp32 tensor
InitMethod = Callable[..., torch.Tensor]


def normal_init(std: float) -> InitMethod:
    def init(shape, generator, device):
        return torch.randn(shape, generator=generator, device=device) * std

    return init


def _one_shard(tp_size: int) -> None:
    if tp_size != 1:
        raise NotImplementedError(
            f"tensor parallelism (tp_size={tp_size}) is not ported; the "
            "layers run at tp_size=1 (ROADMAP.md)")


class _Linear(nn.Module):
    """weight [output_size, input_size] drawn by ``init_method`` (the
    master weight, which at one shard is the shard) and a zero bias."""

    def __init__(self, input_size: int, output_size: int, *,
                 init_method: InitMethod, tp_size: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _one_shard(tp_size)
        self.weight = nn.Parameter(init_method((output_size, input_size),
                                               generator, device))
        self.bias = nn.Parameter(torch.zeros(output_size, device=device))


class ColumnParallelLinear(_Linear):
    """Y = X W^T + b (reference layers.py:243): bias added in fp32, then
    cast to x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (linear_f32(x, self.weight) + self.bias.float()).to(x.dtype)


class RowParallelLinear(_Linear):
    """Y = X W^T + b (reference layers.py:365): the product is cast to x's
    dtype before the bias is added in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = linear_f32(x, self.weight).to(x.dtype)
        return (y.float() + self.bias.float()).to(y.dtype)


class VocabParallelEmbedding(nn.Module):
    """Embedding table [num_embeddings, embedding_dim] (reference
    layers.py:127); ids outside the table are clipped into it, as the JAX
    package's lookup clips them."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 init_method: InitMethod, tp_size: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _one_shard(tp_size)
        self.num_embeddings = num_embeddings
        self.weight = nn.Parameter(init_method(
            (num_embeddings, embedding_dim), generator, device))

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        ids = token_ids.long().clamp(0, self.num_embeddings - 1)
        return nn.functional.embedding(ids, self.weight)
