"""Tensor-parallel layers: column- and row-parallel linear, vocab-parallel
embedding.

PyTorch port of the JAX package's
``apex_tpu/transformer/tensor_parallel/layers.py`` as ``nn.Module``s.
Parameter names and layouts are the JAX package's (``weight`` [out, in],
``bias`` [out]; the embedding's ``weight`` [vocab, hidden]), so a JAX
tree maps onto a ``state_dict`` name for name
(:mod:`apex_tpu_torch.transformer.testing.convert`).

At ``tp_size`` above 1 each layer holds this rank's shard of the master
weight: every rank draws the whole master from the same generator state
and keeps its slice, as the JAX ``init_master`` then ``shard_master``
do, so tp ranks start from the tp = 1 weights.  ``ColumnParallelLinear``
keeps rows [r o, (r + 1) o) of the weight and of the bias (o = out / tp)
and, with ``gather_output``, all-gathers its output; ``RowParallelLinear``
keeps columns [r i, (r + 1) i) of the weight (i = in / tp) and the whole
bias, scatters its input unless ``input_is_parallel``, and reduces its
partial outputs; ``VocabParallelEmbedding`` keeps vocab rows [r n, (r +
1) n), zeroes the lookups of ids outside them and reduces.  The
collectives are the regions of :mod:`.mappings` over the registered
tensor group (:mod:`apex_tpu_torch.transformer.parallel_state`).

The products keep the JAX rounding rule: x @ W^T accumulated in fp32
from x's dtype (the weight cast to it); ``ColumnParallelLinear`` adds its
bias in fp32 and then casts to x's dtype; ``RowParallelLinear`` casts
the product to x's dtype, all-reduces those partials (at tp above 1), then
adds its bias in fp32 and rounds once.  Each product is one
``torch.library`` custom op, ``apex_tpu_torch::parallel_linear``
(:data:`PARALLEL_LINEAR_OP`), carrying the layer's ``name``: a selective
activation checkpoint sees the product, the bias and the cast as one op
it can save by name (the remat policies of
:mod:`apex_tpu_torch.transformer.testing.standalone_gpt`), where the JAX
package names the tensor with ``checkpoint_name``.  At tp above 1 a
row-parallel layer's op is the product and the cast only, and the reduce
and the bias follow it, so a checkpoint that saves the op recomputes the
reduce (on every rank, in the same order).  ``skip_bias_add`` returns
``(output, bias)`` with the bias left out, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.ops._gemm import mm_f32
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    divide, split_tensor_along_last_dim)

#: init_method(shape, generator, device) -> fp32 tensor
InitMethod = Callable[..., torch.Tensor]


def normal_init(std: float) -> InitMethod:
    def init(shape, generator, device):
        return torch.randn(shape, generator=generator, device=device) * std

    return init


@torch.library.custom_op("apex_tpu_torch::parallel_linear", mutates_args=())
def _parallel_linear_op(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], bias_after_cast: bool,
                        name: str) -> torch.Tensor:
    x2d = x.reshape(-1, x.shape[-1])
    y = mm_f32(x2d, weight.to(x.dtype).t()).reshape(*x.shape[:-1],
                                                    weight.shape[0])
    if bias is None:
        return y.to(x.dtype)
    if bias_after_cast:
        y = y.to(x.dtype)
    return (y.float() + bias.float()).to(x.dtype)


@_parallel_linear_op.register_fake
def _(x, weight, bias, bias_after_cast, name):
    return x.new_empty(*x.shape[:-1], weight.shape[0])


def _parallel_linear_setup(ctx, inputs, output):
    x, weight, bias = inputs[:3]
    ctx.save_for_backward(x, weight)
    ctx.bias_meta = None if bias is None else (bias.shape, bias.dtype)


def _parallel_linear_backward(ctx, g):
    # the cast to x's dtype and the fp32 bias add pass the gradient on
    # unchanged in value (g is in x's dtype), so both orders share it
    x, weight = ctx.saved_tensors
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    g2d = g.reshape(-1, g.shape[-1]).to(x.dtype)
    dx = dw = db = None
    if need_x:
        dx = mm_f32(g2d, weight.to(x.dtype)).to(x.dtype).reshape(x.shape)
    if need_w:
        dw = mm_f32(g2d.t(), x.reshape(-1, x.shape[-1])).to(weight.dtype)
    if need_b and ctx.bias_meta is not None:
        shape, dtype = ctx.bias_meta
        db = g.float().sum_to_size(shape).to(dtype)
    return dx, dw, db, None, None


_parallel_linear_op.register_autograd(_parallel_linear_backward,
                                      setup_context=_parallel_linear_setup)

#: the op a selective checkpoint sees for every parallel linear layer; its
#: last argument is the layer's ``name``
PARALLEL_LINEAR_OP = torch.ops.apex_tpu_torch.parallel_linear.default


def _tp_of(tp_size: int):
    """(rank, group) of this process in the registered tensor group; a
    ``tp_size`` other than the registered one raises."""
    if tp_size == 1:
        return 0, None
    registered = (parallel_state.get_tensor_model_parallel_world_size()
                  if parallel_state.model_parallel_is_initialized() else 1)
    if registered != tp_size:
        raise RuntimeError(
            f"tp_size={tp_size} but the registered tensor-parallel size is "
            f"{registered}: call parallel_state.initialize_model_parallel("
            f"{tp_size}) in each of the {tp_size} ranks first")
    return (parallel_state.get_tensor_model_parallel_rank(),
            parallel_state.get_tensor_model_parallel_group())


class _Linear(nn.Module):
    """weight [output_size, input_size] drawn whole by ``init_method``
    (the master weight), of which this rank keeps its shard, and a zero
    bias; ``name`` labels the layer's op for a selective checkpoint."""

    def __init__(self, input_size: int, output_size: int, *,
                 init_method: InitMethod, tp_size: int = 1, device=None,
                 generator: Optional[torch.Generator] = None,
                 name: str = "", skip_bias_add: bool = False):
        super().__init__()
        self.tp_size = tp_size
        self.tp_rank, self.tp_group = _tp_of(tp_size)
        self.name = name
        self.skip_bias_add = skip_bias_add
        master = init_method((output_size, input_size), generator, device)
        self.weight = nn.Parameter(self._shard(master))
        self.bias = nn.Parameter(torch.zeros(self._bias_size(output_size),
                                             device=device))
        set_tensor_model_parallel_attributes(self.weight, True,
                                             self._partition_dim)
        set_tensor_model_parallel_attributes(
            self.bias, self._partition_dim == 0, 0)

    def _op(self, x: torch.Tensor, bias: Optional[torch.Tensor]):
        return _parallel_linear_op(x, self.weight, bias,
                                   self._bias_after_cast, self.name)


class ColumnParallelLinear(_Linear):
    """Y = X W^T + b with W sharded along its output (reference
    layers.py:243): bias added in fp32, then cast to x's dtype.  The input
    enters the copy region (its gradient is all-reduced);
    ``gather_output`` all-gathers Y, else Y stays sharded for a following
    ``RowParallelLinear``."""

    _bias_after_cast = False
    _partition_dim = 0

    def __init__(self, input_size: int, output_size: int, *,
                 gather_output: bool = True, **kw):
        self.gather_output = gather_output
        super().__init__(input_size, output_size, **kw)

    def _shard(self, master):
        return split_tensor_along_last_dim(
            master.t(), self.tp_size)[self.tp_rank].t().contiguous()

    def _bias_size(self, output_size):
        return divide(output_size, self.tp_size)

    def forward(self, x: torch.Tensor):
        x = copy_to_tensor_model_parallel_region(x, self.tp_group)
        y = self._op(x, None if self.skip_bias_add else self.bias)
        if self.gather_output:
            y = gather_from_tensor_model_parallel_region(y, self.tp_group)
        return (y, self.bias) if self.skip_bias_add else y


class RowParallelLinear(_Linear):
    """Y = X W^T + b with W sharded along its input (reference
    layers.py:365): the product is cast to x's dtype, the partials
    all-reduced, then the bias added in fp32.  ``input_is_parallel``: X
    is already this rank's shard (a ``ColumnParallelLinear``'s output
    without ``gather_output``), else it is scattered."""

    _bias_after_cast = True
    _partition_dim = 1

    def __init__(self, input_size: int, output_size: int, *,
                 input_is_parallel: bool = False, **kw):
        self.input_is_parallel = input_is_parallel
        super().__init__(input_size, output_size, **kw)

    def _shard(self, master):
        return split_tensor_along_last_dim(
            master, self.tp_size)[self.tp_rank].contiguous()

    def _bias_size(self, output_size):
        return output_size

    def forward(self, x: torch.Tensor):
        if self.tp_size == 1:
            y = self._op(x, None if self.skip_bias_add else self.bias)
            return (y, self.bias) if self.skip_bias_add else y
        if not self.input_is_parallel:
            x = scatter_to_tensor_model_parallel_region(x, self.tp_group)
        y = reduce_from_tensor_model_parallel_region(self._op(x, None),
                                                     self.tp_group)
        if self.skip_bias_add:
            return y, self.bias
        return (y.float() + self.bias.float()).to(y.dtype)


class VocabParallelEmbedding(nn.Module):
    """Embedding table [num_embeddings, embedding_dim] sharded along the
    vocab (reference layers.py:127).  At one shard ids outside the table
    are clipped into it, as the JAX lookup clips them; at tp above 1 an
    id outside this rank's rows looks up zeros and the ranks' lookups
    are summed."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 init_method: InitMethod, tp_size: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tp_size = tp_size
        self.tp_rank, self.tp_group = _tp_of(tp_size)
        self.num_embeddings = num_embeddings
        self.num_embeddings_per_partition = divide(num_embeddings, tp_size)
        master = init_method((num_embeddings, embedding_dim), generator,
                             device)
        n = self.num_embeddings_per_partition
        self.weight = nn.Parameter(
            master[self.tp_rank * n:(self.tp_rank + 1) * n].contiguous())
        set_tensor_model_parallel_attributes(self.weight, True, 0)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        if self.tp_size == 1:
            ids = token_ids.long().clamp(0, self.num_embeddings - 1)
            return nn.functional.embedding(ids, self.weight)
        n = self.num_embeddings_per_partition
        local = token_ids.long() - self.tp_rank * n
        in_range = (local >= 0) & (local < n)
        emb = nn.functional.embedding(local.clamp(0, n - 1), self.weight)
        emb = torch.where(in_range[..., None], emb, 0.0).to(emb.dtype)
        return reduce_from_tensor_model_parallel_region(emb, self.tp_group)


# Parameter metadata (reference layers.py:37-75): attributes on the
# parameter, as the reference sets them

def set_tensor_model_parallel_attributes(param: torch.Tensor,
                                         is_parallel: bool, dim: int,
                                         stride: int = 1) -> torch.Tensor:
    param.tensor_model_parallel = is_parallel
    param.partition_dim = dim
    param.partition_stride = stride
    return param


def param_is_not_tensor_parallel_duplicate(param: torch.Tensor) -> bool:
    """A parameter every tp rank holds a different shard of, or any
    parameter on tp rank 0 (the canonical copy of a replicated one)."""
    if getattr(param, "tensor_model_parallel", False):
        return True
    return (not parallel_state.model_parallel_is_initialized()
            or parallel_state.get_tensor_model_parallel_rank() == 0)
