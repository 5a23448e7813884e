"""GPT-1.3B flagship: configuration + the ZeRO-fit train step.

PyTorch port of the JAX package's ``apex_tpu/transformer/testing/
flagship.py``: hidden 2048 in 16 heads of 128, 24 layers, vocab 51200,
2048 positions, bf16, flash attention, remat ``attn_res`` (~1.32 B
parameters), and its train step: the model's gradient packed into one
flat superblock and stepped by
:class:`~apex_tpu_torch.contrib.optimizers.DistributedFusedAdam` —
reduce-scatter, the update of this rank's shard, all-gather — so the
moments live once per shard group.  The same step runs at world 1 (no
process group: the collectives are the identity, the dtype plan does the
fitting) and over the ranks of a ``torch.distributed`` world.

Fit plans (bytes at 1.32 B parameters, world 1, in GB):

=============  ======  =====  =========  ==================
plan           params  grads  m / v      optimizer-phase
                                         peak (see note)
=============  ======  =====  =========  ==================
fp32           5.3     5.3    5.3 / 5.3  26.4
bf16_fp32m     2.6     2.6    5.3 / 5.3  18.5
bf16_fit       2.6     2.6    2.6 / 5.3  15.8
=============  ======  =====  =========  ==================

Peak note: the optimizer phase holds m + v + the flat grads + the old
and new flat params (:func:`flagship_state_bytes`).  JAX donates the old
trees; here ``donate=True`` frees the gradient tree once it is packed,
keeps the parameter tree as views of its flat buffer (no repack), and
writes the moments (and at world 1 the parameters) over their old values.

The state is the JAX step's: ``params`` is the master tree of the JAX
``GPTModel`` (nested dicts in sorted key order, the layers stacked on a
leading axis, every leaf whole: replicated on every rank, bitwise), and
``opt_state`` a :class:`~apex_tpu_torch.contrib.optimizers.
ShardedOptState` whose leaves carry this rank's block of JAX's stacks:
``[1, shard]`` and ``[1]`` on the single-axis path (JAX: ``[n_shards,
...]``), ``[1, 1, 1, shard]`` on the ``mesh_shape=(dp, tp, pp)`` path
(JAX: ``[dp, pp, tp, ...]``).  At world 1 the block is the whole stack.
The flat schema is JAX's ``make_schema`` over that master tree, so rank r
owns the elements JAX's rank r owns and the sharded checkpoints of
:mod:`apex_tpu_torch.checkpoint` are JAX's files.

The model that computes is the port's :class:`GPTModel` at the step's
tp, its parameters bound to the master at each step (views at tp 1, this
rank's contiguous slice at tp > 1, the slice JAX's ``_tp_slice_tables``
takes).  Gradient normalization: the port's tensor-parallel regions give
TRUE gradients (a sharded leaf's on its slice, a replicated leaf's whole
on every tp rank), where JAX's bucketed step takes partials carrying a
uniform x tp.  Before packing, each tp-sharded slice is scaled by tp
(exact for a power of two), so the world sum of the master-shaped
buffers is world x the data-mean gradient on every element, and
``grad_average`` divides the world back out, as in JAX.

The bucketed step (``bucket_bytes``) runs one reduce-scatter and one
all-gather per :func:`~apex_tpu_torch.multi_tensor.plan_buckets` bucket,
after the backward (no overlap with it yet); the serialized control
(``bucket_bytes=None``) one of each.  The reduce-scatter sums each
element in rank order, so the two give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                               ShardedOptState)
from apex_tpu_torch.multi_tensor.buckets import (DEFAULT_BUCKET_BYTES,
                                                 plan_buckets)
from apex_tpu_torch.multi_tensor.flat import (PartitionSpec as P,
                                              flatten, unflatten)
from apex_tpu_torch.parallel import comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.testing.standalone_gpt import (GPTConfig,
                                                               GPTModel)

__all__ = ["GPT1P3B_KW", "ZeroFitPlan", "FIT_PLANS", "gpt1p3b_config",
           "gpt_param_count", "flagship_state_bytes",
           "build_flagship_train_step", "flagship_elastic_build",
           "FlagshipSetup", "master_shapes"]

GPT1P3B_KW = dict(
    num_layers=24,
    hidden_size=2048,
    num_attention_heads=16,
    vocab_size=51200,
    max_position_embeddings=2048,
    bf16=True,
    use_flash_attention=True,
    remat=True,
    remat_policy="attn_res",
)

_LAYERS = ("transformer", "layers")


def gpt1p3b_config(**overrides) -> GPTConfig:
    """The 1.3B flagship :class:`GPTConfig`; ``overrides`` for toy-depth
    variants (keep ``hidden_size / num_attention_heads = 128`` so the
    head dim the kernels are built for stays the one under test)."""
    return GPTConfig(**{**GPT1P3B_KW, **overrides})


def gpt_param_count(cfg: GPTConfig) -> int:
    """Analytic parameter count of the standalone GPT (biases and
    layernorms included): per layer 12h^2 GEMM weights + 13h vectors,
    plus word/position embeddings and the final layernorm."""
    h, L = cfg.hidden_size, cfg.num_layers
    per_layer = 12 * h * h + 13 * h
    return (L * per_layer
            + (cfg.vocab_size + cfg.max_position_embeddings) * h
            + 2 * h)


@dataclasses.dataclass(frozen=True)
class ZeroFitPlan:
    """Storage dtypes for the ZeRO step (see module table)."""

    name: str
    param_dtype: torch.dtype
    exp_avg_dtype: torch.dtype
    scatter_dtype: Optional[torch.dtype]  # flat-grad / reduce-scatter
    gather_dtype: Optional[torch.dtype]   # updated-shard all-gather


FIT_PLANS = {
    "fp32": ZeroFitPlan("fp32", torch.float32, torch.float32, None, None),
    "bf16_fp32m": ZeroFitPlan("bf16_fp32m", torch.bfloat16, torch.float32,
                              torch.bfloat16, torch.bfloat16),
    "bf16_fit": ZeroFitPlan("bf16_fit", torch.bfloat16, torch.bfloat16,
                            torch.bfloat16, torch.bfloat16),
}


def flagship_state_bytes(cfg: GPTConfig, plan: ZeroFitPlan,
                         n_shards: int = 1) -> dict:
    """Analytic persistent-state + grad bytes (the JAX function's
    numbers); activations and logits excluded.  ``step_peak`` is the
    optimizer phase's live set of the peak note."""
    n = gpt_param_count(cfg)

    def it(d):
        return torch.empty((), dtype=d).element_size()

    out = {
        "params": n * it(plan.param_dtype),
        "grads": n * it(plan.scatter_dtype or torch.float32),
        "exp_avg": n * it(plan.exp_avg_dtype) // n_shards,
        "exp_avg_sq": n * 4 // n_shards,
    }
    out["total"] = sum(out.values())
    flat_param = n * it(plan.gather_dtype or torch.float32)
    out["step_peak"] = (out["exp_avg"] + out["exp_avg_sq"]
                        + out["grads"] + 2 * flat_param)
    return out


class FlagshipSetup(NamedTuple):
    """Everything a caller needs from one flagship construction."""

    step: Any          # (params, opt_state, tokens, labels) -> ...
    params: Any        # the master tree in plan.param_dtype
    opt_state: Any     # this rank's ShardedOptState block
    mesh: Any          # parallel_state's rank grid [dp, pp, tp]
    schema: Any
    opt: DistributedFusedAdam
    model: GPTModel
    plan: ZeroFitPlan
    # structure-prefix specs of (params, opt_state): params replicated,
    # the opt leaves led by "data" (or by all three axes, whose sizes
    # mesh_axes carries): what a sharded save wants
    shardings: Any = None
    mesh_axes: Any = None
    bucket_plan: Any = None
    group: Any = None  # the ZeRO process group (None: world 1)


# -- the master tree and the model ------------------------------------------

def _master_path(name: str):
    """(path in the master tree, layer index or None) of a parameter
    name of the port's GPTModel."""
    parts = name.split(".")
    if tuple(parts[:2]) == _LAYERS:
        return tuple(parts[:2]) + tuple(parts[3:]), int(parts[2])
    return tuple(parts), None


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _master_from_model(model: GPTModel, dtype: torch.dtype) -> dict:
    """The JAX master tree of a tp = 1 port model: nested dicts, the
    layers stacked, leaves in ``dtype`` on the model's device."""
    flat, stacks = {}, {}
    for name, p in model.named_parameters():
        path, layer = _master_path(name)
        if layer is None:
            flat[path] = p.detach().to(dtype)
        else:
            stacks.setdefault(path, {})[layer] = p.detach().to(dtype)
    for path, per in stacks.items():
        flat[path] = torch.stack([per[i] for i in range(len(per))])
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t
    return tree


def master_shapes(cfg: GPTConfig, dtype: torch.dtype = torch.float32
                  ) -> dict:
    """The master tree of ``cfg`` as ``meta`` tensors (shapes and dtype
    alone, nothing allocated): what a flat schema of the full-size model
    is built from."""
    h, L, f = cfg.hidden_size, cfg.num_layers, cfg.ffn

    def m(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    def ln(*lead):
        return {"weight": m(*lead, h), "bias": m(*lead, h)}

    return {
        "embedding": {"weight": m(cfg.vocab_size, h)},
        "position_embeddings": {"weight": m(cfg.max_position_embeddings, h)},
        "final_layernorm": ln(),
        "transformer": {"layers": {
            "input_layernorm": ln(L),
            "attention": {"qkv": {"weight": m(L, 3 * h, h),
                                  "bias": m(L, 3 * h)},
                          "proj": {"weight": m(L, h, h), "bias": m(L, h)}},
            "post_attention_layernorm": ln(L),
            "mlp": {"dense_h_to_4h": {"weight": m(L, f, h), "bias": m(L, f)},
                    "dense_4h_to_h": {"weight": m(L, h, f),
                                      "bias": m(L, h)}}}},
    }


def _slice_table(model: GPTModel, master) -> dict:
    """Per model parameter: (master path, layer, dim, size), ``dim`` -1 for
    a replicated leaf, else the one dim the tp shard slices (rank t's
    slice starts at ``t * size``: the contiguous-equal-chunk contract of
    the tensor-parallel layers, JAX's ``_tp_slice_tables``)."""
    table = {}
    for name, p in model.named_parameters():
        path, layer = _master_path(name)
        full = _get(master, path)
        shape = tuple(full.shape[1:] if layer is not None else full.shape)
        if shape == tuple(p.shape):
            table[name] = (path, layer, -1, 0)
            continue
        diffs = [i for i, (a, b) in enumerate(zip(shape, p.shape)) if a != b]
        if len(shape) != p.dim() or len(diffs) != 1:
            raise ValueError(f"{name}: the tp shard {tuple(p.shape)} of "
                             f"{shape} is not one contiguous slice")
        table[name] = (path, layer, diffs[0], int(p.shape[diffs[0]]))
    return table


def _bind_model(model: GPTModel, params, table: dict, t_idx: int) -> None:
    """Point the model's parameters at ``params`` (views at tp 1; this tp
    rank's slice, copied, at tp > 1)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            path, layer, dim, size = table[name]
            full = _get(params, path)
            src = full[layer] if layer is not None else full
            if dim >= 0:
                src = src.narrow(dim, t_idx * size, size).contiguous()
            p.data = src


def _pack_grads(model: GPTModel, table: dict, schema, dtype, tp: int,
                t_idx: int) -> torch.Tensor:
    """The model's gradients in the master layout: a flat buffer of the
    schema in ``dtype``, every tp-sharded slice at its place and scaled
    by tp, zeros elsewhere; the gradient tree is freed as it is packed."""
    dev = next(model.parameters()).device
    flat = torch.zeros(schema.total, dtype=dtype, device=dev)
    views = unflatten(flat, schema)
    for name, p in model.named_parameters():
        path, layer, dim, size = table[name]
        dst = _get(views, path)
        dst = dst[layer] if layer is not None else dst
        g = p.grad
        if dim >= 0:
            dst = dst.narrow(dim, t_idx * size, size)
        dst.copy_(g)
        if dim >= 0 and tp > 1:
            dst.mul_(tp)
        p.grad = None
    return flat


def _flat_of(params, schema, dtype) -> torch.Tensor:
    """``params`` packed: the buffer its leaves are views of when they
    already lie in the schema's layout in ``dtype`` (the step's own
    output), else a new flatten."""
    from apex_tpu_torch.multi_tensor.flat import _tree_flatten

    leaves = _tree_flatten(params)[0]
    if leaves and all(isinstance(x, torch.Tensor) and x.dtype == dtype
                      and x.is_contiguous() for x in leaves):
        store = leaves[0].untyped_storage()
        start = leaves[0].storage_offset() - schema.offsets[0]
        size = leaves[0].element_size()
        if start >= 0 and store.nbytes() >= (start + schema.total) * size \
                and all(x.untyped_storage().data_ptr() == store.data_ptr()
                        and x.storage_offset() - off == start
                        for x, off in zip(leaves, schema.offsets)):
            return torch.empty(0, dtype=dtype, device=leaves[0].device
                               ).set_(store, start, (schema.total,))
    return flatten(params, schema, dtype=dtype)[0]


def _rows(t: torch.Tensor, d: int, dp: int) -> torch.Tensor:
    b = t.shape[0]
    if b % dp:
        raise ValueError(f"global batch {b} does not divide the data-"
                         f"parallel size {dp}")
    n = b // dp
    return t[d * n:(d + 1) * n]


# -- the step ----------------------------------------------------------------

def build_flagship_train_step(
    cfg: GPTConfig,
    *,
    plan="bf16_fit",
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    donate: bool = True,
    seed: int = 0,
    mesh_shape=None,
    bucket_bytes: Any = "auto",
    device=None,
    master=None,
) -> FlagshipSetup:
    """One flagship construction: the model + ZeRO-sharded FusedAdam over
    the world of the default process group (one process without one),
    on ``device`` (default: the card).

    ``step(params, opt_state, tokens, labels)`` takes the GLOBAL batch on
    every rank (its rows must divide the data-parallel size), computes on
    this rank's data-parallel rows, and returns ``(params, opt_state,
    loss)``: the new master tree (bitwise the same on every rank), the
    new state block, the data-mean loss.  ``donate=True`` lets the step
    overwrite the state it is given (the JAX step's donation: keep only
    what it returns).

    ``mesh_shape=(dp, tp, pp)`` — the multi-axis form: tensor parallelism
    shards the compute (each rank runs its tp slice of the replicated
    master) and ZeRO shards the optimizer state over the linearized
    world (the opt leaves are ``[1, 1, 1, shard]`` blocks of JAX's ``[dp,
    pp, tp, shard]`` stack).  ``pp`` must be 1.  ``bucket_bytes`` (this
    path only): ``"auto"`` the bucketed step at
    :data:`~apex_tpu_torch.multi_tensor.DEFAULT_BUCKET_BYTES`, an int
    another cap, ``None`` the serialized control (one monolithic
    reduce-scatter and all-gather).

    ``master`` — a JAX master tree (nested dicts of arrays or tensors,
    JAX's ``init_master`` layout) to start from; by default the port's
    GPTModel draws one from ``seed``.
    """
    if isinstance(plan, str):
        plan = FIT_PLANS[plan]
    dev = resolve_device(device)
    on = torch.distributed.is_available() and torch.distributed.is_initialized()
    world = torch.distributed.get_world_size() if on else 1
    if mesh_shape is None:
        if bucket_bytes != "auto":
            raise ValueError(
                "bucket_bytes applies to the mesh_shape=(dp, tp, pp) step; "
                "the single-axis path keeps the historical layout")
        dp, tp, pp = world, 1, 1
    else:
        dp, tp, pp = (int(x) for x in mesh_shape)
        if pp != 1:
            raise NotImplementedError(
                "the 3-D flagship train step supports pp=1 (pipeline "
                "schedules run in transformer.pipeline_parallel); the "
                "checkpoint / reshard machinery handles pp > 1 states")
        if dp * tp * pp != world:
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} needs "
                             f"{dp * tp * pp} ranks, the world has {world}")
        if cfg.num_attention_heads % tp or cfg.hidden_size % tp \
                or cfg.vocab_size % tp:
            raise ValueError(
                f"tp={tp} must divide heads/hidden/vocab "
                f"({cfg.num_attention_heads}/{cfg.hidden_size}/"
                f"{cfg.vocab_size})")
    # the registered layout is kept when it is this one: an earlier
    # construction's model keeps its (live) groups
    if not (parallel_state.model_parallel_is_initialized()
            and parallel_state.mesh_axis_sizes() == {
                parallel_state.DATA_AXIS: dp,
                parallel_state.PIPELINE_AXIS: pp,
                parallel_state.TENSOR_AXIS: tp}):
        parallel_state.destroy_model_parallel()
        parallel_state.initialize_model_parallel(tp, pp)
    grid = parallel_state.get_mesh()
    group = torch.distributed.group.WORLD if world > 1 else None

    # the master: the tp = 1 model's weights (drawn from seed) or the
    # given tree, in the plan's storage dtype
    if master is None:
        m1 = GPTModel(dataclasses.replace(cfg, tp_size=1), device=dev,
                      seed=seed)
        master = _master_from_model(m1, plan.param_dtype)
        del m1
    else:
        from apex_tpu_torch.transformer.testing.convert import (
            master_from_jax)
        master = master_from_jax(master, device=dev, dtype=plan.param_dtype)
    opt = DistributedFusedAdam(
        lr=lr, weight_decay=weight_decay, scatter_dtype=plan.scatter_dtype,
        gather_dtype=plan.gather_dtype, exp_avg_dtype=plan.exp_avg_dtype)
    schema = opt.make_schema(master, world)
    flat_dtype = opt.flat_param_dtype
    # the parameter tree as views of its flat buffer: the step reads the
    # buffer without repacking it
    params = unflatten(flatten(master, schema, dtype=flat_dtype)[0], schema)
    del master
    model = GPTModel(dataclasses.replace(cfg, tp_size=tp), device=dev,
                     seed=seed)
    table = _slice_table(model, params)
    t_idx = parallel_state.get_tensor_model_parallel_rank()
    d_idx = parallel_state.get_data_parallel_rank()
    _bind_model(model, params, table, t_idx)   # frees the drawn weights
    state0 = opt.init(params, schema, world, device=dev)
    n_lead = 1 if mesh_shape is None else 3
    lead = (None,) * n_lead
    opt_state = ShardedOptState(*(a[lead] for a in state0))
    data_group = parallel_state.get_data_parallel_group()
    bplan = None
    if mesh_shape is not None and bucket_bytes is not None:
        bb = DEFAULT_BUCKET_BYTES if bucket_bytes == "auto" \
            else int(bucket_bytes)
        bplan = plan_buckets(
            schema, world, bucket_bytes=bb,
            itemsize=torch.empty((), dtype=plan.scatter_dtype
                                 or torch.float32).element_size())

    def step(params, opt_state, tokens, labels):
        flat_p = _flat_of(params, schema, flat_dtype)
        if not donate:
            flat_p = flat_p.clone()
            opt_state = ShardedOptState(*(a.clone() for a in opt_state))
        _bind_model(model, unflatten(flat_p, schema), table, t_idx)
        tok = _rows(tokens, d_idx, dp).to(dev)
        lab = _rows(labels, d_idx, dp).to(dev)
        loss = model(tok, labels=lab).mean()
        loss.backward()
        flat_g = _pack_grads(model, table, schema,
                             plan.scatter_dtype or torch.float32, tp, t_idx)
        state = ShardedOptState(*(a[(0,) * n_lead] for a in opt_state))
        if bplan is not None:
            new_flat, new_state = opt.step_buckets_flat(
                flat_g, state, flat_p, bplan, group, inplace=True)
        else:
            new_flat, new_state = opt.step_flat(flat_g, state, flat_p,
                                                group, inplace=True)
        del flat_g
        loss = comm.all_reduce(loss.detach(), data_group) / dp
        new_params = unflatten(new_flat, schema)
        return (new_params, ShardedOptState(*(a[lead] for a in new_state)),
                loss)

    if mesh_shape is None:
        shardings = (P(), P(parallel_state.DATA_AXIS))
        mesh_axes = None
    else:
        shardings = (P(), P(*parallel_state.MESH_AXES))
        mesh_axes = {parallel_state.DATA_AXIS: dp,
                     parallel_state.PIPELINE_AXIS: pp,
                     parallel_state.TENSOR_AXIS: tp}
    return FlagshipSetup(step, params, opt_state, grid, schema, opt, model,
                         plan, shardings=shardings, mesh_axes=mesh_axes,
                         bucket_plan=bplan, group=group)


@dataclasses.dataclass(frozen=True)
class _ElasticBuild:
    """The picklable ``build`` of :func:`flagship_elastic_build`."""

    cfg: GPTConfig
    plan: Any
    lr: float
    seed: int
    donate: bool
    bucket_bytes: Any
    device: Any
    master: Any = None

    def __call__(self, mesh_shape=None):
        fs = build_flagship_train_step(
            self.cfg, plan=self.plan, lr=self.lr, seed=self.seed,
            donate=self.donate, mesh_shape=mesh_shape,
            bucket_bytes=self.bucket_bytes if mesh_shape is not None
            else "auto", device=self.device, master=self.master)
        losses: list = []

        def step_fn(state, batch):
            p, s = state
            tokens, labels = batch
            p, s, loss = fs.step(p, s, tokens, labels)
            losses.append(float(loss))
            return (p, s), None

        step_fn.losses = losses
        step_fn.setup = fs
        return step_fn, (fs.params, fs.opt_state), fs.shardings


def flagship_elastic_build(cfg: GPTConfig, *, plan="bf16_fit",
                           lr: float = 1e-4, seed: int = 0,
                           donate: bool = False, bucket_bytes="auto",
                           device=None, master=None):
    """``build(mesh_shape=None)`` for
    :func:`apex_tpu_torch.resilience.run_elastic_training`: called in each
    rank of a fresh world, it stands up the ZeRO flagship step on that
    world and adapts it to the resilient-loop contract — ``state`` is the
    ``(params, opt_state)`` tuple (also the cross-topology restore
    target), ``step_fn(state, (tokens, labels))`` returns ``(state,
    None)`` and appends each step's loss to ``step_fn.losses``.  The
    build is a picklable object (the ranks are spawned processes)."""
    return _ElasticBuild(cfg, plan, lr, seed, donate, bucket_bytes, device,
                         master)
