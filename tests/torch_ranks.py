"""Rank bodies of the port's multi-process CPU tests.

Each function runs in one process of a :func:`apex_tpu_torch.parallel.
multiproc.spawn` launch (a gloo process group on a ``file://`` store, one
CPU thread), computes what its test file checks, and writes it with
``torch.save`` to ``<out>/rank<r>.pt``; the test process loads the ranks'
results and holds them against JAX.  Spawned ranks import this module by
name, so it imports neither ``jax`` nor the JAX package (a test pins
that): inputs arrive as numpy arrays or tensors in the ``case`` dict.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.parallel.multiproc import init_file_group
from apex_tpu_torch.transformer import parallel_state, tensor_parallel as tpl


def _join(rank, world, init_file, tp=1, pp=1):
    init_file_group("gloo", rank, world, init_file)
    parallel_state.initialize_model_parallel(tp, pp)


def _write(out, rank, res):
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def load_ranks(out, world):
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _fixed(master):
    """An init_method returning the given master weight."""
    def init(shape, generator, device):
        assert tuple(shape) == tuple(master.shape)
        return torch.from_numpy(np.array(master, np.float32))
    return init


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


# -- tests/test_torch_tensor_parallel.py --------------------------------------

def tensor_parallel_checks(rank, world, init_file, out, case):
    """Every check of the tensor-parallel regions, layers, cross entropy,
    broadcast and RNG at tp = world (one tensor group)."""
    tp = world
    _join(rank, world, init_file, tp)
    res = {"sizes": (parallel_state.get_tensor_model_parallel_world_size(),
                     parallel_state.get_pipeline_model_parallel_world_size(),
                     parallel_state.get_data_parallel_world_size(),
                     parallel_state.get_tensor_model_parallel_rank(),
                     parallel_state.get_tensor_model_parallel_src_rank(),
                     parallel_state.get_rank_info())}
    try:
        parallel_state.initialize_model_parallel(3)
    except RuntimeError:
        res["invalid_raises"] = True
    parallel_state.destroy_model_parallel()
    try:
        parallel_state.get_tensor_model_parallel_world_size()
    except RuntimeError:
        res["uninitialized_raises"] = True
    parallel_state.initialize_model_parallel(tp)

    # copy: identity forward, the ranks' cotangents summed backward
    x = _t(case["x86"], grad=True)
    y = tpl.copy_to_tensor_model_parallel_region(x)
    loss = tpl.reduce_from_tensor_model_parallel_region(
        y.sum() * (rank + 1.0))
    loss.backward()
    res["copy"] = (y.detach(), loss.detach(), x.grad)
    # scatter / gather round trip, reduce
    z = _t(case["x_roundtrip"])
    s = tpl.scatter_to_tensor_model_parallel_region(z)
    res["roundtrip"] = (tuple(s.shape),
                        tpl.gather_from_tensor_model_parallel_region(s))
    res["reduce"] = tpl.reduce_from_tensor_model_parallel_region(
        torch.ones(4, 4))

    # column-parallel (gather_output) and row-parallel (scatter) layers
    def layer_case(cls, m, xin, **kw):
        layer = cls(m["weight"].shape[1], m["weight"].shape[0],
                    init_method=_fixed(m["weight"]), tp_size=tp, **kw)
        with torch.no_grad():
            b = torch.from_numpy(np.array(m["bias"], np.float32))
            layer.bias.copy_(b if layer.bias.numel() == b.numel()
                             else tpl.split_tensor_along_last_dim(
                                 b, tp)[rank])
        xi = _t(xin, grad=True)
        o = layer(xi)
        (o ** 2).sum().backward()
        return o.detach(), xi.grad, layer.weight.grad, layer.bias.grad

    res["column"] = layer_case(tpl.ColumnParallelLinear, case["col"],
                               case["x_col"], gather_output=True)
    res["row"] = layer_case(tpl.RowParallelLinear, case["row"],
                            case["x_row"], input_is_parallel=False)
    # the Megatron MLP pair: column (no gather) -> gelu -> row
    col = tpl.ColumnParallelLinear(8, 16, gather_output=False, tp_size=tp,
                                   init_method=_fixed(case["pair_c"]))
    row = tpl.RowParallelLinear(16, 8, input_is_parallel=True, tp_size=tp,
                                init_method=_fixed(case["pair_r"]))
    xp = _t(case["x_pair"], grad=True)
    yp = row(F.gelu(col(xp), approximate="tanh"))
    lp = (yp ** 2).sum()
    lp.backward()
    res["pair"] = (lp.detach(), xp.grad, col.weight.grad, row.weight.grad)
    # vocab-parallel embedding
    emb = tpl.VocabParallelEmbedding(32, 12, tp_size=tp,
                                     init_method=_fixed(case["emb"]))
    e = emb(_t(case["ids"]))
    (e * _t(case["emb_dy"])).sum().backward()
    res["embedding"] = (e.detach(), emb.weight.grad)
    # vocab-parallel cross entropy and its gradient
    logits = _t(case["logits"], grad=True)
    local = tpl.scatter_to_tensor_model_parallel_region(logits)
    ce = tpl.vocab_parallel_cross_entropy(local, _t(case["target"]))
    ce.mean().backward()
    res["ce"] = (ce.detach(), logits.grad)
    # broadcast_data: only tp rank 0 holds the payload
    tok = _t(case["tokens"]) if rank == 0 else torch.full((3, 4), -1,
                                                         dtype=torch.int32)
    res["broadcast"] = tpl.broadcast_data(["tokens"], {"tokens": tok},
                                          torch.int32)["tokens"]
    try:
        tpl.broadcast_data(["x"], {"x": torch.ones(2)}, torch.int32)
    except ValueError:
        res["broadcast_dtype_raises"] = True
    # the model-parallel stream differs per rank, the default does not
    tpl.model_parallel_cuda_manual_seed(1234)
    tracker = tpl.get_cuda_rng_tracker()
    res["seeds"] = (tracker.fork("default"), tracker.fork())
    tpl.model_parallel_cuda_manual_seed(1234)
    res["seeds_again"] = tracker.fork()
    # 1-D split and gather
    flat = _t(case["x_1d"])
    c = tpl.split_tensor_into_1d_equal_chunks(flat)
    res["split_1d"] = (c, tpl.gather_split_1d_tensor(c))
    _write(out, rank, res)


# -- tests/test_torch_distributed.py ------------------------------------------

def distributed_checks(rank, world, init_file, out, case):
    """all_reduce_grads under each option set, broadcast_params, DDP and
    Reducer over the data group (dp = world), and the model-parallel
    GradScaler over a tensor group of world ranks."""
    from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                         all_reduce_grads, broadcast_params)
    from apex_tpu_torch.transformer.amp import GradScaler

    _join(rank, world, init_file)     # tp 1: dp = world
    grads = {k: _t(v[rank]).to(getattr(torch, case["dtypes"][k]))
             for k, v in case["grads"].items()}
    res = {"table": {name: all_reduce_grads(grads, **kw)
                     for name, kw in case["options"]}}
    params = [torch.full((3,), float(rank + 1)), torch.arange(4.) * (rank + 1)]
    broadcast_params(params)
    res["broadcast"] = params
    ddp = DistributedDataParallel(gradient_predivide_factor=2.0,
                                  allreduce_always_fp32=True)
    res["ddp"] = (ddp(grads), ddp.reduce(grads))
    res["reducer"] = Reducer().reduce(grads)
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(world)   # one tensor group
    scaler = GradScaler()
    ok = [torch.ones(3), torch.ones(2, 2)]
    bad = [torch.ones(3), torch.tensor([[1.0, float("inf")], [0.0, 0.0]])]
    res["found_inf"] = (scaler.found_inf(ok),
                        scaler.found_inf(bad if rank == world - 1 else ok))
    _write(out, rank, res)


def ddp_example(rank, world, init_file, out, case):
    """The port of examples/simple/distributed/distributed_data_parallel.py
    on the given weights and global batch."""
    from apex_tpu_torch.examples.simple.distributed import (
        distributed_data_parallel as ex)

    init_file_group("gloo", rank, world, init_file)
    loss = ex.main([], device="cpu",
                   params={k: _t(v) for k, v in case["params"].items()},
                   data=(_t(case["x"]), _t(case["y"])))
    _write(out, rank, {"loss": loss})


# -- tests/test_torch_parallel_gpt.py -----------------------------------------

def _gpt_grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def parallel_models(rank, world, init_file, out, case):
    """The toy GPT and BERT at tp = world on rank r's shard of the JAX
    masters: losses and gradients; the GPT's hidden state with dropout on;
    the clip norm of pretrain_gpt over the GPT's gradients."""
    from apex_tpu_torch.examples.gpt import pretrain_gpt
    from apex_tpu_torch.transformer.testing import (BertConfig, BertModel,
                                                    GPTConfig, GPTModel)
    from apex_tpu_torch.transformer.testing.convert import (
        rank_state_dict_from_jax)

    tp = world
    _join(rank, world, init_file, tp)
    res = {}
    for name, over in case["gpt_variants"]:
        m = GPTModel(GPTConfig(**case["gpt_cfg"], tp_size=tp, **over),
                     device="cpu")
        m.load_state_dict(rank_state_dict_from_jax(case["gpt_master"], rank))
        loss = m(_t(case["tokens"]), labels=_t(case["labels"])).mean()
        loss.backward()
        res[name] = (loss.detach(), _gpt_grads(m))
        if name == "plain":
            res["clip_norm"] = pretrain_gpt.clip_grads(m, 1e9)
    drop = GPTModel(GPTConfig(**case["gpt_cfg"], tp_size=tp,
                              attention_dropout=0.3, hidden_dropout=0.25),
                    device="cpu")
    drop.load_state_dict(rank_state_dict_from_jax(case["gpt_master"], rank))
    with torch.no_grad():
        h, _ = drop.transformer(drop.embed(_t(case["tokens"])),
                                dropout_seed=11)
        h0, _ = drop.transformer(drop.embed(_t(case["tokens"])))
    res["dropout_hidden"] = (h, h0)
    bert = BertModel(BertConfig(**case["bert_cfg"], tp_size=tp), device="cpu")
    bert.load_state_dict(rank_state_dict_from_jax(case["bert_master"], rank))
    lm, binary = bert(_t(case["tokens"]),
                      attention_mask=_t(case["bert_mask"]),
                      tokentype_ids=_t(case["tokentypes"]),
                      lm_labels=_t(case["labels"]))
    bl = lm.mean() + binary.float().pow(2).mean()
    bl.backward()
    res["bert"] = (lm.detach(), binary.detach(), _gpt_grads(bert))
    _write(out, rank, res)


def pretrain_runs(rank, world, init_file, out, case):
    """pretrain_gpt at tp x dp on shards of the JAX master: an
    uninterrupted run, a run that saves, its resume, and a resume of the
    JAX example's checkpoint; per-step losses and, for the uninterrupted
    run, the replicated and dp-replicated parameters after each step."""
    from apex_tpu_torch.examples.gpt import pretrain_gpt
    from apex_tpu_torch.transformer.testing.convert import (
        rank_state_dict_from_jax)

    init_file_group("gloo", rank, world, init_file)
    res = {}
    for name, argv, inject in case["runs"]:
        losses, params = {}, {}

        def on_step(it, loss, model):
            losses[it + 1] = float(loss)
            params[it + 1] = {n: p.detach().clone()
                              for n, p in model.named_parameters()}

        sd = None
        if inject:
            tp_rank = parallel_state.coordinates(
                rank, world, case["tp"])[0]
            sd = rank_state_dict_from_jax(case["master"], tp_rank)
        pretrain_gpt.main(case["base"] + argv, device="cpu", state_dict=sd,
                          on_step=on_step)
        res[name] = (losses, params if name == "uninterrupted" else None)
    _write(out, rank, res)


# -- tests/test_torch_gpt.py: the tp and world cases that now run -----------

def gpt_runs_at_tp2(rank, world, init_file, out, case):
    """The toy GPT at tp_size 2, pretrain_gpt's setup at
    --tensor-model-parallel-size 2 and at --world-size 2 (one step each),
    and the three layers at tp_size 2."""
    from apex_tpu_torch.examples.gpt import pretrain_gpt
    from apex_tpu_torch.transformer.testing import GPTConfig, GPTModel

    init_file_group("gloo", rank, world, init_file)
    parallel_state.initialize_model_parallel(2)
    res = {}
    m = GPTModel(GPTConfig(**case["toy"], tp_size=2), device="cpu")
    tokens = torch.arange(2 * 8).reshape(2, 8) % case["toy"]["vocab_size"]
    loss = m(tokens, labels=tokens).mean()
    loss.backward()
    res["model"] = (loss.detach(),
                    all(p.grad is not None for p in m.parameters()))
    for name, flags in case["flags"]:
        args, model, opt = pretrain_gpt.setup(case["argv"] + flags,
                                              device="cpu")
        b = args.global_batch_size
        ids = torch.arange(b * (args.seq_length + 1)).reshape(b, -1) % 97
        toks, labs = pretrain_gpt.dp_rows((ids[:, :-1], ids[:, 1:]))
        step = pretrain_gpt.train_step(args, model, opt, toks, labs, 0)
        res[name] = (args.tensor_model_parallel_size,
                     args.data_parallel_size, float(step),
                     [p.detach().clone() for p in model.parameters()])
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(2)
    init = tpl.normal_init(0.02)
    x = torch.ones(3, 8)
    layers = (tpl.ColumnParallelLinear(8, 8, init_method=init, tp_size=2),
              tpl.RowParallelLinear(8, 8, init_method=init, tp_size=2))
    res["layers"] = [tuple(lay(x).shape) for lay in layers] + [
        tuple(tpl.VocabParallelEmbedding(8, 8, init_method=init, tp_size=2)(
            torch.arange(8)).shape)]
    _write(out, rank, res)


# -- tests/test_torch_pipeline.py ---------------------------------------------

class _Toy(torch.nn.Module):
    """A toy stage (or chunk): one dense layer of the given weights."""

    def __init__(self, w, b=None):
        super().__init__()
        self.w = torch.nn.Parameter(_t(w).float())
        self.b = None if b is None else torch.nn.Parameter(_t(b).float())

    def forward(self, x):
        y = x @ self.w
        return torch.tanh(y if self.b is None else y + self.b)


def _toy_stage_fn(stage, h, mb):
    first = parallel_state.get_rank_info()[1] == 0
    return stage(mb["x"] if first else h)


def _toy_chunk_fn(stage, h, mb, k):
    first = parallel_state.get_pipeline_model_parallel_rank() == 0 and k == 0
    return stage(mb["x"] if first else h)


def _toy_loss_fn(stage, y, mb):
    return ((y - mb["y"]) ** 2).mean()


def _p2p_checks(case, dtype):
    """The eight wrappers on this rank's tensors: what each received, and
    the transfers counted."""
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p)

    r = parallel_state.get_pipeline_model_parallel_rank()
    x = _t(case["p2p_x"][r]).to(dtype)
    g = _t(case["p2p_g"][r]).to(dtype)
    shape = tuple(x.shape)
    kw = dict(dtype=dtype)
    got = {}
    comm.STATS.reset()
    p2p.send_forward(x)
    got["recv_forward"] = p2p.recv_forward(shape, device="cpu", **kw)
    p2p.send_backward(g)
    got["recv_backward"] = p2p.recv_backward(shape, device="cpu", **kw)
    got["send_forward_recv_backward"] = p2p.send_forward_recv_backward(
        x, shape, **kw)
    got["send_backward_recv_forward"] = p2p.send_backward_recv_forward(
        g, shape, **kw)
    got["send_forward_recv_forward"] = p2p.send_forward_recv_forward(
        x, True, shape, **kw)
    got["send_backward_recv_backward"] = p2p.send_backward_recv_backward(
        g, True, shape, **kw)
    return got, comm.STATS.as_dict()


def _saved_peaks(run, ms):
    from apex_tpu_torch.transformer.pipeline_parallel import schedules

    out = {}
    for m in ms:
        run(m)
        out[m] = list(schedules.STATS.peak_saved_inputs)
    return out


def _gpt_stage(case, tp, pp, cfg_kw, vpp=1, chunk=0):
    from apex_tpu_torch.transformer.testing import GPTConfig, GPTModel
    from apex_tpu_torch.transformer.testing.convert import (
        stage_state_dict_from_jax)

    rank = parallel_state.get_pipeline_model_parallel_rank()
    v = rank + pp * chunk
    V = pp * vpp
    cfg = GPTConfig(**cfg_kw, tp_size=tp)
    m = GPTModel(cfg, cfg.num_layers // V, device="cpu",
                 pre_process=v == 0, post_process=v == V - 1)
    master = case["gpt_master"] if tp == 1 else case["gpt_stacked"]
    m.load_state_dict(stage_state_dict_from_jax(
        master, rank, pp, None if tp == 1 else
        parallel_state.get_tensor_model_parallel_rank(), chunk=chunk,
        vpp=vpp))
    return cfg, m


def _gpt_pipeline_run(case, tp, pp, steps, plant_at=None):
    """The toy GPT at tp x pp through 1F1B: FusedAdam steps on this rank's
    stage (the amp recipe with a dynamic scaler when ``plant_at`` is set:
    an inf planted in the last stage's gradients at that step); per step
    the loss, and after step 1 the gradients; the parameters after every
    step."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import all_reduce_grads
    from apex_tpu_torch.transformer.amp import GradScaler
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_without_interleaving)
    from apex_tpu_torch.transformer.testing import make_gpt_stage_fns

    cfg, model = _gpt_stage(case, tp, pp, case["gpt_cfg"])
    stage_fn, loss_fn = make_gpt_stage_fns(cfg, pp)
    opt = FusedAdam(list(model.parameters()), lr=case["lr"])
    mb = {"tokens": _t(case["tokens"]), "labels": _t(case["labels"])}
    shape = (case["mbs"], case["seq"], cfg.hidden_size)
    scaler = GradScaler() if plant_at else None
    ss = scaler.init() if scaler else None
    out = {"losses": [], "params": [], "scales": [], "names": [
        n for n, _ in model.named_parameters()]}
    last = parallel_state.is_pipeline_last_stage()
    for step in range(1, steps + 1):
        lf = loss_fn
        if scaler:
            def lf(st, y, b, ss=ss):
                return scaler.scale(loss_fn(st, y, b), ss)
        loss, grads = forward_backward_pipelining_without_interleaving(
            stage_fn, lf, model, mb, n_microbatches=case["n_micro"],
            tensor_shape=shape)
        if scaler:
            loss = loss / ss.loss_scale
            grads = list(scaler.unscale(grads, ss)[0])
            if step == plant_at and last:
                grads[0] = grads[0].clone()
                grads[0].view(-1)[0] = float("inf")
        grads = all_reduce_grads(grads)
        if step == 1:
            out["grads"] = [g.clone() for g in grads]
        if scaler:
            found = scaler.found_inf(grads)
            opt.step_if_finite(~found, grads)
            ss = scaler.update(ss, ~found)
            out["scales"].append(float(ss.loss_scale))
        else:
            opt.step(grads=grads)
        out["losses"].append(float(loss))
        out["params"].append([p.detach().clone()
                              for p in model.parameters()])
    return out


def pipeline_checks(rank, world, init_file, out, case):
    """Every rank-side check of tests/test_torch_pipeline.py in one launch
    of four gloo ranks: the p2p wrappers at pp 4 and pp 2 (dp 2), the toy
    1F1B at pp 4 and the toy interleaved schedule at pp 4 x vpp 2 (loss,
    gradients, forward-only, the saved inputs held), build_model's flags,
    and the toy GPT at pp 2 (dp 2) and tp 2 x pp 2 (step-1 loss and
    gradients, three FusedAdam steps, the amp skip of a planted
    overflow)."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        build_model, forward_backward_pipelining_with_interleaving,
        forward_backward_pipelining_without_interleaving)

    init_file_group("gloo", rank, world, init_file)
    res = {}
    data = {k: _t(v).float() for k, v in case["toy_data"].items()}

    # pp 4: the wrappers, 1F1B, the saved inputs
    parallel_state.initialize_model_parallel(1, 4)
    for dt in (torch.float32, torch.bfloat16):
        res[f"p2p4_{dt}"] = _p2p_checks(case, dt)
    stage = _Toy(case["toy_w"][rank], case["toy_b"][rank])
    shape = case["toy_shape"]

    def one_f_one_b(m, d=data, fwd_only=False):
        return forward_backward_pipelining_without_interleaving(
            _toy_stage_fn, _toy_loss_fn, stage, d, n_microbatches=m,
            tensor_shape=shape, forward_only=fwd_only)

    res["1f1b"] = one_f_one_b(case["n_toy"])
    res["1f1b_fwd"] = one_f_one_b(case["n_toy"], fwd_only=True)
    zeros = {k: torch.zeros(32, *v.shape[1:]) for k, v in data.items()}
    res["1f1b_peaks"] = _saved_peaks(
        lambda m: one_f_one_b(m, {k: v[:m] for k, v in zeros.items()}),
        case["peak_ms"])

    def flags(pre_process=False, post_process=False, tag=None):
        m = torch.nn.Linear(1, 1)
        m.flags = (pre_process, post_process, tag,
                   parallel_state.get_virtual_pipeline_model_parallel_rank())
        return m

    res["build_pp4"] = [m.flags for m in build_model(flags, False, tag="m")]
    parallel_state.destroy_model_parallel()

    # pp 4 x vpp 2: the interleaved schedule, build_model's chunks
    parallel_state.initialize_model_parallel(1, 4, 2)
    built = build_model(flags, True, 2, tag="v")
    res["build_vpp"] = ([m.flags for m in built],
                        [type(m).__name__ for m in built],
                        parallel_state.get_virtual_pipeline_model_parallel_rank())
    chunks = [_Toy(case["toy_full_w"][rank + 4 * k]) for k in range(2)]

    def interleaved(m, d=data, fwd_only=False):
        return forward_backward_pipelining_with_interleaving(
            _toy_chunk_fn, _toy_loss_fn, chunks, d, n_microbatches=m,
            num_model_chunks=2, tensor_shape=shape, forward_only=fwd_only)

    res["vpp"] = interleaved(case["n_toy"])
    res["vpp_fwd"] = interleaved(case["n_toy"], fwd_only=True)
    res["vpp_peaks"] = _saved_peaks(
        lambda m: interleaved(m, {k: v[:m] for k, v in zeros.items()}),
        case["peak_ms"])
    parallel_state.destroy_model_parallel()

    # pp 2 (dp 2): the wrappers between two ranks, the toy GPT
    parallel_state.initialize_model_parallel(1, 2)
    for dt in (torch.float32, torch.bfloat16):
        res[f"p2p2_{dt}"] = _p2p_checks(case, dt)
    res["gpt_pp2"] = _gpt_pipeline_run(case, 1, 2, case["steps"])
    parallel_state.destroy_model_parallel()

    # tp 2 x pp 2: the toy GPT, and the amp skip of a planted overflow
    parallel_state.initialize_model_parallel(2, 2)
    res["gpt_tp2pp2"] = _gpt_pipeline_run(case, 2, 2, case["steps"])
    res["amp_tp2pp2"] = _gpt_pipeline_run(case, 2, 2, case["steps"],
                                          plant_at=2)
    res["coords"] = parallel_state.get_rank_info()
    parallel_state.destroy_model_parallel()
    _write(out, rank, res)


# -- tests/test_torch_zero.py ---------------------------------------------------

def _tree_t(tree, dtype=None):
    """A nested dict of numpy arrays as tensors (``dtype`` if given)."""
    if isinstance(tree, dict):
        return {k: _tree_t(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t if dtype is None else t.to(dtype)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy().copy() if tree.dtype in (
        torch.bfloat16, torch.float16) else tree.detach().numpy().copy()


def _opt_runs(group, world, rank, case):
    """Every optimizer case of ``case["opt_cases"]`` at this world: three
    (or the case's) steps from fresh state over per-rank gradients."""
    from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                                   DistributedFusedLAMB)
    out = {}
    for name, kind, kw, steps, dtype in case["opt_cases"]:
        kw = dict(kw)
        for k in ("scatter_dtype", "gather_dtype", "exp_avg_dtype"):
            if k in kw:
                kw[k] = getattr(torch, kw[k])
        cls = DistributedFusedAdam if kind == "adam" else DistributedFusedLAMB
        opt = cls(**kw)
        dt = getattr(torch, dtype)
        p = _tree_t(case["params"], dt)
        schema = opt.make_schema(p, world)
        state = opt.init(p, schema, world)
        for s in range(steps):
            g = _tree_t(case["grads"][world][s][rank], dt)
            p, state = opt.step(g, state, p, schema, group)
        out[name] = (_np_tree(p), tuple(
            (a.float() if a.dtype == torch.bfloat16 else a).numpy().copy()
            for a in state))
    return out


def _flagship_run(case, run):
    """One flagship trajectory of ``case``: losses, final params (this
    rank's), opt block, bucket count, and the collectives a step ran."""
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer.testing import (build_flagship_train_step,
                                                    gpt1p3b_config)
    name, shape, bb, plan, steps = run[:5]
    switch = run[5] if len(run) > 5 else None
    cfg = gpt1p3b_config(**case["toy_kw"])
    kw = {} if shape is None else dict(mesh_shape=shape, bucket_bytes=bb)
    fs = build_flagship_train_step(cfg, plan=plan, lr=case["lr"],
                                   device="cpu", master=case["master"], **kw)
    fs2 = None
    if switch is not None:   # the plan B of a cross-plan resume
        fs2 = build_flagship_train_step(cfg, plan=plan, lr=case["lr"],
                                        device="cpu", master=case["master"],
                                        mesh_shape=shape, bucket_bytes=switch)
    tokens = torch.from_numpy(case["tokens"]).long()
    labels = torch.from_numpy(case["labels"]).long()
    p, s = fs.params, fs.opt_state
    losses, ops = [], []
    for i in range(steps):
        comm.STATS.reset()
        stepper = fs2 if (fs2 is not None and i >= steps // 2) else fs
        p, s, loss = stepper.step(p, s, tokens, labels)
        losses.append(float(loss))
        ops.append(dict(comm.STATS.by_op))
    return dict(losses=losses, params=_np_tree(p), opt=tuple(
        (a.float() if a.dtype == torch.bfloat16 else a).numpy().copy()
        for a in s), n_buckets=(fs.bucket_plan.num_buckets
                                if fs.bucket_plan is not None else None),
        ops=ops, schema_total=fs.schema.total)


def zero_checks(rank, world, init_file, out, case):
    """The optimizers at world 2 (ranks 0-1 in a subgroup) and 4, the
    comm pair, and the flagship runs of ``case["runs"]``."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import comm
    init_file_group("gloo", rank, world, init_file)
    pair = dist.new_group([0, 1])
    res = {"opt": {}}
    res["opt"][world] = _opt_runs(None if world == 1 else dist.group.WORLD,
                                  world, rank, case)
    if rank < 2:
        res["opt"][2] = _opt_runs(pair, 2, rank, case)
    # the comm pair over the world: every dtype, bucket-cut independence
    x = torch.from_numpy(case["rs_x"][rank])
    res["rs"] = {name: comm.reduce_scatter(x.to(getattr(torch, name)),
                                           dist.group.WORLD)
                 for name in ("float32", "bfloat16", "float16")}
    n = x.numel() // world
    cut = [comm.reduce_scatter(x.reshape(world, n)[:, a:b].reshape(-1),
                               dist.group.WORLD)
           for a, b in ((0, 3), (3, n))]
    res["rs_cut"] = torch.cat(cut)
    res["ag"] = {name: comm.all_gather_tiled(
        x[:4].to(getattr(torch, name)), dist.group.WORLD)
        for name in ("float32", "bfloat16", "float8_e5m2", "int32")}
    res["flagship"] = {run[0] + (f"_{run[5]}" if len(run) > 5 else ""):
                       _flagship_run(case, run) for run in case["runs"]}
    parallel_state.destroy_model_parallel()
    _write(out, rank, res)


# -- tests/test_torch_flagship.py ----------------------------------------------

def flagship_runs(rank, world, init_file, out, case):
    """The flagship toy at each of ``case["runs"]`` on this world."""
    init_file_group("gloo", rank, world, init_file)
    res = {run[0]: _flagship_run(case, run) for run in case["runs"]}
    if case.get("resume") is not None:
        # JAX's state after its first step, carried in: this rank's block
        from apex_tpu_torch.transformer.testing import (
            build_flagship_train_step, gpt1p3b_config)
        from apex_tpu_torch.transformer.testing.convert import (
            master_from_jax, zero_state_from_jax)
        shape, jp, js = case["resume"]
        fs = build_flagship_train_step(
            gpt1p3b_config(**case["toy_kw"]), plan="fp32", lr=case["lr"],
            device="cpu", master=case["master"], mesh_shape=shape)
        p, s, loss = fs.step(master_from_jax(jp), zero_state_from_jax(js, rank),
                             torch.from_numpy(case["tokens"]).long(),
                             torch.from_numpy(case["labels"]).long())
        res["resume"] = dict(loss=float(loss), params=_np_tree(p), opt=s)
    parallel_state.destroy_model_parallel()
    _write(out, rank, res)


# -- tests/test_torch_elastic.py -----------------------------------------------

def sharded_saves(rank, world, init_file, out, case):
    """Each rank saves its block of the synthetic states of ``case`` (format
    3 and 4), then restores blocks of JAX's and its own saves onto the
    targets of ``case["restores"]``."""
    import torch.distributed as dist

    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.multi_tensor.flat import PartitionSpec as P

    init_file_group("gloo", rank, world, init_file)
    g = dist.group.WORLD
    res = {"wrote": {}}
    cur = []
    ckpt.checkpoint.set_fault_hook(
        lambda event, path: cur.append(os.path.basename(path))
        if event == "write_shard" else None)
    for name, state, fmt, axes in case["saves"]:
        cur = res["wrote"][name] = []
        lead = tuple(axes.values())
        c = np.unravel_index(rank, lead)
        idx = tuple(slice(int(i), int(i) + 1) for i in c)
        params, opt = state
        block = ({"w": torch.from_numpy(params["w"])},
                 {k: torch.from_numpy(np.ascontiguousarray(v[idx]))
                  for k, v in opt.items()})
        specs = (P(), P(*axes)) if fmt == 4 else (P(), P("data"))
        kw = dict(shard_axes=axes) if fmt == 4 else dict(shard_axis="data")
        ckpt.save_checkpoint(os.path.join(case["root"], name), block, step=3,
                             shardings=specs, group=g, **kw)
    for name, src, axes, shard in case["restores"]:
        lead = tuple(axes.values())
        tgt = ({"w": torch.zeros(16)},
               {"step": torch.zeros((1,) * len(lead), dtype=torch.int32),
                "exp_avg": torch.zeros((1,) * len(lead) + (shard,)),
                "exp_avg_sq": torch.zeros((1,) * len(lead) + (shard,))})
        try:
            got, step = ckpt.restore_checkpoint(
                os.path.join(case["root"], src), tgt, verify=True,
                shardings=(P(), P(*axes)), shard_axes=axes, group=g)
            res[name] = (got, step)
        except Exception as e:
            res[name] = (type(e).__name__, str(e))
    ckpt.checkpoint.set_fault_hook(None)
    _write(out, rank, res)


class ListIterator:
    """A picklable checkpointable iterator over a list of batches (the
    protocol of ``apex_tpu_torch.data``: ``state_dict`` /
    ``load_state_dict``), for the elastic loop's ``data_iter``."""

    def __init__(self, batches):
        self.batches = list(batches)
        self.pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.pos >= len(self.batches):
            raise StopIteration
        self.pos += 1
        return self.batches[self.pos - 1]

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, state):
        self.pos = int(state["pos"])


def elastic_golden(rank, world, init_file, out, case):
    """The golden of a recovery: the flagship built on ``case["shape"]``,
    the checkpoint of ``case["step"]`` restored across the ranks, then the
    remaining batches without interruption (losses and final state)."""
    import torch.distributed as dist

    from apex_tpu_torch.resilience import restore_zero_checkpoint
    from apex_tpu_torch.resilience.elastic import _host_tree

    init_file_group("gloo", rank, world, init_file)
    step_fn, state, shardings = case["build"](mesh_shape=case["shape"])
    dp, tp, pp = case["shape"]
    state, step = restore_zero_checkpoint(
        case["ckpt_dir"], state, shardings=shardings,
        shard_axes={"data": dp, "pipeline": pp, "tensor": tp},
        group=dist.group.WORLD, step=case["step"])
    for batch in case["batches"][step:]:
        state, _ = step_fn(state, batch)
    _write(out, rank, {"losses": step_fn.losses, "state": _host_tree(state),
                       "shardings": shardings})


# -- tests/test_torch_serving_tp.py ---------------------------------------------

def _tp_engine(case, params, **kw):
    """The serving toy engine of test_serving_modes.py (pages of 8, batch
    4, the whole prefill row, a SimClock) on the CPU."""
    from apex_tpu_torch import serving as tsv

    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_budget", case["cfg"]["max_position"])
    kw.setdefault("clock", tsv.SimClock())
    return tsv.ServingEngine(tsv.ServingModelConfig(**case["cfg"]), params,
                             device="cpu", **kw)


def _tp_streams(eng, prompts, budget=3):
    reqs = [eng.submit(p, max_new_tokens=budget + i)
            for i, p in enumerate(prompts)]
    eng.run()
    return [list(r.generated) for r in reqs]


def _tp_sequential(case, params, prompts, **kw):
    out = []
    for i, p in enumerate(prompts):
        eng = _tp_engine(case, params, **kw)
        r = eng.submit(p, max_new_tokens=3 + i)
        eng.run()
        out.append(list(r.generated))
    return out


def _raised(fn):
    """The type name and message of what ``fn()`` raised (None if it
    returned)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (reported to the test)
        return type(e).__name__, str(e)
    return None


def _tp_model_steps(case, tp, rank, group):
    """One prefill, decode and extend of rank ``rank``'s part, on the
    rank's head slice of the given pools; K/V and pools gathered over the
    heads."""
    from apex_tpu_torch import serving as tsv
    from apex_tpu_torch.parallel import comm

    m = case["model"]
    params = tsv.rank_params_from_jax(case["jparams"], tp, rank, "cpu")
    dec = tsv.PagedDecoder(tsv.ServingModelConfig(**case["cfg"]))
    hl = case["cfg"]["num_heads"] // tp

    def mine(a):   # [L, pages, ps, H, D] -> the rank's heads
        return torch.from_numpy(
            np.array(a[:, :, :, rank * hl:(rank + 1) * hl]))

    def whole(t):
        return comm.all_gather(t, group, dim=3)

    out = {}
    logits, k, v = dec.prefill(params, *(_t(a) for a in m["prefill"]),
                               tp_group=group)
    out["prefill"] = (logits, whole(k), whole(v))
    kp, vp = mine(m["k0"]), mine(m["v0"])
    logits = dec.decode(params, kp, vp, *(_t(a) for a in m["decode"]),
                        tp_group=group)
    out["decode"] = (logits, whole(kp), whole(vp))
    kp, vp = mine(m["k0"]), mine(m["v0"])
    logits = dec.extend(params, kp, vp, *(_t(a) for a in m["extend"]),
                        tp_group=group)
    out["extend"] = (logits, whole(kp), whole(vp))
    return out


def _tp_replica0(case, rank, group, params):
    """Replica 0 of the tp 2 launch: the model steps, the fp32 streams
    (telemetry on), batched == sequential, int8, kill-mid-decode with the
    injector on the group's first rank only, and snapshot/restore."""
    import json

    from apex_tpu_torch import serving as tsv
    from apex_tpu_torch import telemetry as ttel
    from apex_tpu_torch.resilience import chaos

    prompts = case["prompts"]
    res = {"model": _tp_model_steps(case, 2, rank, group)}
    mem = ttel.MemorySink()
    bus = ttel.TelemetryBus(run_id="tp", sinks=[mem])
    eng = _tp_engine(case, params, tp=2, telemetry=bus)
    res["fp"] = _tp_streams(eng, prompts)
    res["events"] = mem.events
    res["tp1"] = _tp_streams(_tp_engine(case, params), prompts)
    res["pool"] = (tuple(eng.cache.k.shape), eng.cache.num_heads)
    res["seq"] = _tp_sequential(case, params, prompts, tp=2)
    modes = dict(tp=2, kv_quant="int8")
    ctrl = _tp_streams(_tp_engine(case, params, **modes), prompts)
    res["int8"] = ctrl
    cache = _tp_engine(case, params, **modes).cache
    res["int8_pool"] = (str(cache.k.dtype), tuple(cache.k.shape),
                        tuple(cache.k_scale.shape))
    # the injector lives in the group's first rank alone
    if rank == 0:
        with chaos.ServingDeviceLoss(at_step=3, device_ids=[0]) as dl:
            eng = _tp_engine(case, params, **modes)
            got = _tp_streams(eng, prompts)
        fired = dl.fired
    else:
        eng = _tp_engine(case, params, **modes)
        got = _tp_streams(eng, prompts)
        fired = None
    res["kill"] = dict(streams=got, recoveries=eng.recoveries, fired=fired,
                       ctrl=ctrl)
    # snapshot -> JSON -> restore into sentinel-poisoned pools
    src = _tp_engine(case, params, **modes)
    for i, p in enumerate(prompts):
        src.submit(p, max_new_tokens=3 + i)
    for _ in range(4):
        src.step()
    snap = json.loads(json.dumps(src.snapshot()))
    dst = _tp_engine(case, params, **modes)
    dst.cache.k.fill_(101)
    dst.cache.v.fill_(102)
    dst.cache.k_scale.fill_(1e3)
    dst.cache.v_scale.fill_(1e3)
    restored = dst.restore(snap)
    dst.run()
    res["snap"] = dict(snapshot=snap, streams={
        r.rid: list(r.generated) for r in restored})
    return res


def _jax_shipments(case, timeout_s=120.0):
    """JAX's payloads, which the test process writes while the ranks run
    (waited for, up to ``timeout_s``)."""
    path = case["jax_ship_file"]
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def _tp_replica1(case, rank, params):
    """Replica 1 of the tp 2 launch: speculation plus chunking against
    its tp 1 control, prefix sharing with int8, page shipping across
    packages and tp sizes, a rank-dependent clock, and one rank's faults
    at the agreement point."""
    from apex_tpu_torch import serving as tsv
    from apex_tpu_torch.resilience import chaos

    prompts = case["prompts"]
    res = {}
    spec = tsv.SpecConfig(k=2, chunk_size=8)
    res["spec"] = (_tp_streams(_tp_engine(case, params, spec=spec, tp=2),
                               prompts),
                   _tp_streams(_tp_engine(case, params, spec=spec), prompts))

    # prefix sharing composed with tp 2 and int8, against its unshared
    # control (test_serving_modes.py's TestPrefixSharingEngine)
    pfx = tsv.SpecConfig(k=0, chunk_size=8)
    prompt = case["prefix_prompt"]

    def twice(**kw):
        eng = _tp_engine(case, params, spec=pfx, tp=2, kv_quant="int8", **kw)
        r1 = eng.submit(list(prompt), max_new_tokens=6)
        eng.run()
        r2 = eng.submit(list(prompt), max_new_tokens=6)
        eng.run()
        return [list(r1.generated), list(r2.generated)], [
            r1.prefix_hit, r2.prefix_hit]

    res["prefix"] = (twice(prefix_sharing=True), twice())

    # page shipping: a tp 2 prefill's export, landed in a tp 1 engine that
    # decodes on and exports the page back; JAX's tp 2 payload landed in
    # a tp 2 engine and exported again
    for quant in (None, "int8"):
        col = _tp_engine(case, params, tp=2, kv_quant=quant)
        want = col.submit(case["ship_prompt"], 9)
        col.run()
        src = _tp_engine(case, params, tp=2, kv_quant=quant,
                         prefill_only=True)
        src.warmup()
        r = src.submit(case["ship_prompt"], 9)
        src.step()
        record, pages, kv_len = src.export_request(r.rid)
        one = _tp_engine(case, params, kv_quant=quant, kv_import=True,
                         validate_pages=True)
        got = one.adopt_prefilled(record, pages, kv_len)
        back = [one.cache.export_page_bytes(p) for p in got.pages]
        one.run()
        jrec, jpages, jlen = _jax_shipments(case)[quant]
        dec = _tp_engine(case, params, tp=2, kv_quant=quant, kv_import=True,
                         validate_pages=True)
        landed = dec.adopt_prefilled(jrec, jpages, jlen)
        again = [dec.cache.export_page_bytes(p) for p in landed.pages]
        crc_ok = _raised(lambda: dec.cache.verify_pages([landed.pages]))
        dec.run()
        res[f"ship_{quant}"] = dict(
            pages=pages, back=back, want=list(want.generated),
            tp1_stream=list(got.generated), jax_again=again,
            jax_landed_stream=list(landed.generated), crc=crc_ok)

    # a rank-dependent clock: rank r's SimClock ticks 1 + 4 r a step, the
    # deadlines shed and time requests out; the decisions are rank 0's
    def clocked(clock, tp=2):
        eng = _tp_engine(case, params, tp=tp, clock=clock, max_batch=2,
                         shed_min_service_s=2.0)
        reqs = [eng.submit(q, max_new_tokens=6, deadline_s=dl)
                for q, dl in zip(prompts, (3.5, 9.0, 4.0, 12.0))]
        eng.run()
        return [(list(r.generated), r.finish_reason) for r in reqs]

    res["clock"] = (clocked(tsv.SimClock(tick=1.0 + 4 * (rank % 2))),
                    clocked(tsv.SimClock(tick=1.0), tp=1),
                    clocked(tsv.SimClock(tick=5.0), tp=1))

    # one rank's fault at the agreement point: a page corrupted in one
    # rank's slice makes the group recover once; any other error there
    # stops every rank
    ctrl = _tp_streams(_tp_engine(case, params, tp=2), prompts)
    eng = _tp_engine(case, params, tp=2, validate_pages=True)
    if rank % 2 == 1:
        with chaos.CorruptLivePage(eng.cache, at_step=2):
            got = _tp_streams(eng, prompts)
    else:
        got = _tp_streams(eng, prompts)
    res["corrupt"] = dict(streams=got, ctrl=ctrl, recoveries=eng.recoveries)

    def boom(event, info):
        if event == "decode" and info == 1:
            raise ValueError("injected")

    eng = _tp_engine(case, params, tp=2)
    prev = None
    if rank % 2 == 1:
        prev = tsv.set_fault_hook(boom)
    try:
        res["other_error"] = _raised(lambda: _tp_streams(eng, prompts))
    finally:
        if rank % 2 == 1:
            tsv.set_fault_hook(prev)
    res["after_error"] = _tp_streams(_tp_engine(case, params, tp=2), prompts)
    return res


def serving_tp_checks(rank, world, init_file, out, case):
    """Every check of the port's tensor-parallel serving in one launch of
    four ranks: two tp 2 replicas (groups [0, 1] and [2, 3]) that split
    the checks between them, then tp 4 over all four, then a tp 2 group
    with a short timeout whose ranks part ways."""
    import datetime

    from apex_tpu_torch import serving as tsv

    init_file_group("gloo", rank, world, init_file)
    full = tsv.params_from_jax(case["jparams"], device="cpu")
    res = {}
    parallel_state.initialize_model_parallel(2)
    group = parallel_state.get_tensor_model_parallel_group()
    res["refused"] = [_raised(lambda: _tp_engine(case, full, tp=tp))
                      for tp in (3, 4)]
    if rank < 2:
        res.update(_tp_replica0(case, rank, group, full))
    else:
        res.update(_tp_replica1(case, rank, full))
    parallel_state.destroy_model_parallel()

    parallel_state.initialize_model_parallel(4)
    eng = _tp_engine(case, full, tp=4)
    res["tp4"] = _tp_streams(eng, case["prompts"])
    res["tp4_pool"] = tuple(eng.cache.k.shape)
    parallel_state.destroy_model_parallel()

    # an error outside the agreement point: rank 1's second decode step
    # raises before its all-reduce, and rank 0 waits in its all-reduce
    # until the group's timeout stops it
    parallel_state.initialize_model_parallel(
        2, timeout=datetime.timedelta(seconds=case["timeout_s"]))
    if rank < 2:
        eng = _tp_engine(case, full, tp=2)
        if rank == 1:
            real, calls = eng.decoder.decode, [0]

            def failing(*a, **kw):
                calls[0] += 1
                if calls[0] == 2:
                    raise RuntimeError("injected device error")
                return real(*a, **kw)

            eng.decoder.decode = failing
        t0 = time.perf_counter()
        res["timeout"] = (_raised(lambda: _tp_streams(eng, case["prompts"])),
                          time.perf_counter() - t0)
        if rank == 1:
            # a server that carries on: its peer must not wait on it
            time.sleep(case["timeout_s"] + 0.5)
    _write(out, rank, res)


# -- tests/test_torch_moe.py and tests/test_torch_ring_attention.py ----------

def _collective_names(rank, world):
    """Each public collective of ``comm`` once over the whole group: the
    names it adds to ``comm.STATS.by_op`` and whether its calls are all
    named (sum of ``by_op`` == ``calls``)."""
    from apex_tpu_torch.parallel import comm

    group = torch.distributed.group.WORLD
    x = torch.arange(world * 2, dtype=torch.float32) + rank
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    calls = {
        "all_reduce": lambda: comm.all_reduce(x, group),
        "all_gather": lambda: comm.all_gather(x, group),
        "all_gather_tiled": lambda: comm.all_gather_tiled(x, group),
        "reduce_scatter": lambda: comm.reduce_scatter(x, group),
        "all_to_all": lambda: comm.all_to_all(x, group),
        "broadcast": lambda: comm.broadcast(x, 0, group),
        "gather": lambda: comm.gather(x, group),
        "exchange": lambda: comm.exchange(
            [(x, nxt, 0)], [comm.Recv(prv, tuple(x.shape), x.dtype,
                                      x.device, 0)], group),
        "send_recv": lambda: (comm.send(x, nxt, group) if rank % 2 == 0
                              else comm.recv(x.shape, x.dtype, "cpu", prv,
                                             group),
                              comm.recv(x.shape, x.dtype, "cpu", prv, group)
                              if rank % 2 == 0 else comm.send(x, nxt, group)),
    }
    out = {}
    for name, fn in calls.items():
        comm.STATS.reset()
        fn()
        st = comm.STATS.as_dict()
        out[name] = (st["by_op"], st["calls"])
    return out


def _moe_run(case, cf, group, tokens):
    """One SwitchMLP of ``case``'s master at capacity factor ``cf`` over
    the expert ``group`` on this rank's ``tokens``: outputs, aux, expert
    ids, the gradients of sum(out^2) + 0.01 aux."""
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer import moe as tmoe

    cfg = tmoe.MoEConfig(**case["cfg"], capacity_factor=cf)
    m = tmoe.SwitchMLP(cfg, group=group, device="cpu")
    m.load_state_dict(tmoe.shard_master(
        {k: _t(v) for k, v in case["master"].items()},
        comm.group_rank(group), comm.group_size(group)))
    h = _t(tokens, grad=True)
    out, aux = m(h)
    (out.pow(2).sum() + 0.01 * aux).backward()
    return {"out": out.detach(), "aux": aux.detach(), "dh": h.grad,
            "expert": m.route(h.detach())[0],
            "grads": {k: p.grad for k, p in m.named_parameters()}}


def _tp_ep_run(case, rank, tp_group, ep_group):
    """bench.py's tp x ep leg: a column/row-sharded dense block feeding a
    Switch MoE sharded over the expert group (tensor rank t = rank // ep,
    expert rank e = rank % ep); the loss, and every parameter's gradient
    of this rank's sum(out^2) and of its 0.01 aux, each alone."""
    from apex_tpu_torch.parallel import comm
    from apex_tpu_torch.transformer import moe as tmoe

    tp, ep = comm.group_size(tp_group), comm.group_size(ep_group)
    t, e = comm.group_rank(tp_group), comm.group_rank(ep_group)
    H = case["cfg"]["hidden_size"]
    col = _t(np.array(case["col_w"]).reshape(H, tp, -1)[:, t], grad=True)
    row = _t(np.array(case["row_w"]).reshape(tp, -1, H)[t], grad=True)
    cfg = tmoe.MoEConfig(**case["cfg"], capacity_factor=case["cf"])
    m = tmoe.SwitchMLP(cfg, group=ep_group, device="cpu")
    m.load_state_dict(tmoe.shard_master(
        {k: _t(v) for k, v in case["master"].items()}, e, ep))
    h = _t(case["h"])
    a = F.gelu(h @ col, approximate="tanh")
    y = tpl.reduce_from_tensor_model_parallel_region(a @ row, tp_group)
    out, aux = m(y)
    params = {"col_w": col, "row_w": row,
              **{f"moe.{k}": p for k, p in m.named_parameters()}}
    # the two terms' gradients apart: JAX's psums scale them differently
    sq = torch.autograd.grad(out.pow(2).sum(), list(params.values()),
                             retain_graph=True)
    ax = torch.autograd.grad(0.01 * aux, list(params.values()),
                             allow_unused=True)
    return {"out": out.detach(), "aux": aux.detach(),
            "loss": comm.all_reduce(out.detach().pow(2).sum(),
                                    torch.distributed.group.WORLD) / tp
            + 0.01 * aux.detach(),
            "grads_sq": dict(zip(params, sq)),
            "grads_aux": {k: torch.zeros_like(p) if g is None else g
                          for (k, p), g in zip(params.items(), ax)}}


def moe_checks(rank, world, init_file, out, case):
    """Every rank check of tests/test_torch_moe.py over four gloo ranks:
    the collectives' names, SwitchMLP at ep 4 (the whole group) and ep 2
    (pairs [0, 1] and [2, 3], each on its ranks' tokens) at each capacity
    factor, and bench.py's tp 2 x ep 2 leg (tensor groups [0, 2] and [1,
    3], expert groups [0, 1] and [2, 3])."""
    init_file_group("gloo", rank, world, init_file)
    with parallel_state.uninitialized_scope():
        res = {"collectives": _collective_names(rank, world)}
        new = torch.distributed.new_group
        pairs = [new([0, 1]), new([2, 3])]
        cols = [new([0, 2]), new([1, 3])]
        n = case["tokens_per_rank"]
        mine = np.array(case["h"])[rank * n:(rank + 1) * n]
        for cf in case["cfs"]:
            res[("ep4", cf)] = _moe_run(case, cf,
                                        torch.distributed.group.WORLD, mine)
            res[("ep2", cf)] = _moe_run(case, cf, pairs[rank // 2], mine)
        res["tp_ep"] = _tp_ep_run(case["tp_ep"], rank, cols[rank % 2],
                                  pairs[rank // 2])
    _write(out, rank, res)


def ring_checks(rank, world, init_file, out, case):
    """tests/test_torch_ring_attention.py's rank checks over four gloo
    ranks: ring attention at sp 4 (the whole group) and sp 2 (pairs [0, 1]
    and [2, 3], each on its own sequence), causal and not, output and
    (dq, dk, dv) of sum(o^2); and the bytes its backward saves, counted
    with ``saved_tensors_hooks``, at sp 4 and sp 2 on one ``s_local``."""
    from apex_tpu_torch.ops import ring_attention

    init_file_group("gloo", rank, world, init_file)
    pairs = [torch.distributed.new_group([0, 1]),
             torch.distributed.new_group([2, 3])]
    groups = {4: torch.distributed.group.WORLD, 2: pairs[rank // 2]}
    res = {}
    for sp, group in groups.items():
        r = rank % sp
        for causal in (False, True):
            qkv = [np.array(case[f"sp{sp}"][rank // sp][i]) for i in range(3)]
            n = qkv[0].shape[1] // sp
            q, k, v = (_t(a[:, r * n:(r + 1) * n], grad=True) for a in qkv)
            o = ring_attention(q, k, v, group, causal=causal)
            o.pow(2).sum().backward()
            res[(sp, causal)] = (o.detach(), q.grad, k.grad, v.grad)
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t

        q, k, v = (torch.randn(2, case["s_local"], 16, requires_grad=True)
                   for _ in range(3))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            o = ring_attention(q, k, v, group, causal=True)
        o.sum().backward()
        res[("saved_bytes", sp)] = sum(saved)
    _write(out, rank, res)


# -- tests/test_torch_syncbn.py ------------------------------------------------

def _bn_leg(x, dy, case, group, module=False):
    """One batch norm over ``group`` on this rank's rows ``x``: y, the new
    running statistics and the gradients of sum(dy * y)."""
    from apex_tpu_torch.parallel import SyncBatchNorm, sync_batch_norm

    tx = _t(x, grad=True)
    if module:
        bn = SyncBatchNorm(x.shape[-1], momentum=0.1, process_group=group,
                           device="cpu")
        with torch.no_grad():
            bn.weight.copy_(_t(case["w"]))
            bn.bias.copy_(_t(case["b"]))
            bn.running_mean.copy_(_t(case["rm"]))
            bn.running_var.copy_(_t(case["rv"]))
        y = bn(tx)
        rm, rv, w, b = bn.running_mean, bn.running_var, bn.weight, bn.bias
    else:
        w, b = _t(case["w"], grad=True), _t(case["b"], grad=True)
        y, rm, rv = sync_batch_norm(tx, w, b, _t(case["rm"]), _t(case["rv"]),
                                    axis_name=group, training=True,
                                    momentum=0.1)
    (y * _t(dy)).sum().backward()
    return {"y": y.detach(), "rm": rm.detach().clone(),
            "rv": rv.detach().clone(), "dx": tx.grad, "dw": w.grad,
            "db": b.grad}


def _groupbn_leg(case, group, rank, with_z):
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

    n = case["x"].shape[0] // 2
    rows = slice(rank * n, (rank + 1) * n)
    bn = BatchNorm2d_NHWC(case["x"].shape[-1], bn_group=2, axis_name=group,
                          device="cpu")
    x, z = _t(case["x"][rows], grad=True), _t(case["z"][rows], grad=True)
    y = bn(x, z if with_z else None)
    (y * _t(case["dy"][rows])).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dz": z.grad if with_z else None,
            "dw": bn.weight.grad, "db": bn.bias.grad,
            "state": {k: getattr(bn, k).clone() for k in (
                "running_mean", "running_var", "minibatch_mean",
                "minibatch_riv")}}


def _spatial_legs(case, group, rank, world):
    """The halo rows, spatial_conv2d at each (stride, k) and
    SpatialBottleneck, this rank's H shard of each input."""
    from apex_tpu_torch.contrib import bottleneck as bn

    def shard(a):
        h = a.shape[1] // world
        return a[:, rank * h:(rank + 1) * h]

    res = {}
    x = _t(shard(case["rows"]), grad=True)
    halo = bn.halo_exchange(x, group, 1, 1)
    weight = _t(case["halo_w"][world][rank])
    (halo * weight).sum().backward()
    res["halo"] = (halo.detach(), x.grad)
    for s, k in case["convs"]:
        xs = _t(shard(case["conv_x"]), grad=True)
        w = _t(case["conv_w"][k], grad=True)
        y = bn.spatial_conv2d(xs, w, stride=s, axis_name=group)
        h_out = y.shape[1]
        dy = _t(case["conv_dy"][(s, k)][:, rank * h_out:(rank + 1) * h_out])
        (y * dy).sum().backward()
        res[("conv", s, k)] = (y.detach(), xs.grad, w.grad)
    for name, kw in case["blocks"].items():
        blk = bn.SpatialBottleneck(**kw, axis_name=group, device="cpu")
        blk.load_state_dict({k: _t(v).contiguous(
            memory_format=torch.channels_last) if v.ndim == 4 else _t(v)
            for k, v in case["block_params"][name].items()})
        xs = _t(shard(case["block_x"][name]), grad=True)
        y = blk(xs)
        h_out = y.shape[1]
        dy = _t(case["block_dy"][name][:, rank * h_out:(rank + 1) * h_out])
        (y * dy).sum().backward()
        res[("block", name)] = (y.detach(), xs.grad,
                                {k: p.grad for k, p in
                                 blk.named_parameters()})
    return res


def syncbn_checks(rank, world, init_file, out, case):
    """tests/test_torch_syncbn.py's rank checks over four gloo ranks:
    SyncBN over the registered "data" group (all four), over the pairs
    [0, 1] / [2, 3] of ``create_syncbn_process_group(2, 4)`` as a module,
    with unequal rows (3 + 5) on the pairs, GroupBN at ``bn_group`` 2 on
    the pairs, the halo exchange, ``spatial_conv2d`` and
    ``SpatialBottleneck`` with H over all four and over the pairs."""
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.parallel import (create_syncbn_process_group,
                                         resolve_group)

    init_file_group("gloo", rank, world, init_file)
    res = {}
    with parallel_state.uninitialized_scope():
        res["unregistered"] = _raised(lambda: resolve_group("data"))
        res["bad_world"] = _raised(
            lambda: create_syncbn_process_group(2, 8))
        pair = create_syncbn_process_group(2, world)
        res["pair_ranks"] = torch.distributed.get_process_group_ranks(pair)
        res["bn_group_4_on_pair"] = _raised(
            lambda: BatchNorm2d_NHWC(4, bn_group=4, axis_name=pair,
                                     device="cpu"))
        parallel_state.initialize_model_parallel(1)    # "data": all four
        n4 = case["bn4"]["x"].shape[0] // world
        rows = slice(rank * n4, (rank + 1) * n4)
        res["bn4"] = _bn_leg(case["bn4"]["x"][rows], case["bn4"]["dy"][rows],
                             case["bn4"], "data")
        p, r = rank // 2, rank % 2
        two = case["bn2"][p]
        n2 = two["x"].shape[0] // 2
        rows = slice(r * n2, (r + 1) * n2)
        res["bn2"] = _bn_leg(two["x"][rows], two["dy"][rows], two, pair,
                             module=True)
        cut = case["unequal"]["cut"]
        rows = slice(0, cut) if r == 0 else slice(cut, None)
        res["unequal"] = _bn_leg(case["unequal"]["x"][rows],
                                 case["unequal"]["dy"][rows],
                                 case["unequal"], pair)
        for with_z in (False, True):
            res[("groupbn", with_z)] = _groupbn_leg(case["groupbn"][p], pair,
                                                    r, with_z)
        res["spatial4"] = _spatial_legs(case["spatial"], "data", rank, world)
        res["spatial2"] = _spatial_legs(case["spatial"], pair, r, 2)
        parallel_state.destroy_model_parallel()
    _write(out, rank, res)


# -- tests/test_torch_imagenet_dp.py -------------------------------------------

def _dp_trajectory(case, cfg):
    """``run_trajectory``'s ResNet cell at dp = world: the JAX init and
    batches, this rank's rows of each, SyncBN over "data", the gradients'
    mean; the per-step losses (the ranks' mean)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.imagenet import main_amp as tmain
    from apex_tpu_torch.models import ResNetConfig
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD

    make = {"adam": lambda p: FusedAdam(p, lr=1e-2, weight_decay=1e-4),
            "lamb": lambda p: FusedLAMB(p, lr=1e-2, weight_decay=1e-4),
            "sgd": lambda p: FusedSGD(p, lr=1e-2, momentum=0.9)}
    group = parallel_state.get_data_parallel_group()
    tr = tmain.Trainer(
        ResNetConfig(**case["tiny"], bn_axis_name="data"),
        amp.initialize(cfg["opt_level"], loss_scale=cfg["loss_scale"]),
        make[cfg["optimizer"]], torch.device("cpu"),
        state_dict={k: _t(v) for k, v in case["traj_sd"].items()},
        group=group)
    losses = []
    for x, y in case["traj_batches"]:
        loss, _, _ = tr.train_step(tmain.my_rows(_t(x), group),
                                   tmain.my_rows(_t(y).long(), group))
        losses.append(float(loss))
    return losses


def imagenet_dp_runs(rank, world, init_file, out, case):
    """tests/test_torch_imagenet_dp.py's ranks (two, gloo): the ImageNet
    example at --n-devices 2 without and with --sync_bn (saving), resumed
    at world 2 from a world-1 checkpoint, and run_trajectory's ResNet cell
    at dp 2 twice per configuration; rank 0's printed lines kept."""
    import contextlib
    import io

    from apex_tpu_torch.examples.imagenet import main_amp as tmain

    init_file_group("gloo", rank, world, init_file)
    batches = case["batches"]

    def batcher(epoch, step, train=True):
        x, y = batches[(epoch, step, train)]
        return _t(x), _t(y).long()

    sd = {k: _t(v) for k, v in case["state_dict"].items()}
    res = {}
    for name, argv in case["runs"].items():
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            state = tmain.main(argv, device="cpu", state_dict=sd,
                               batcher=batcher)
        res[name] = {"out": text.getvalue(), "step": int(state.step),
                     "model_state": {k: v.clone() for k, v in
                                     state.model_state.items()}}
    parallel_state.initialize_model_parallel(1)
    for name, cfg in case["trajectories"].items():
        res[("traj", name)] = [_dp_trajectory(case, cfg) for _ in range(2)]
    parallel_state.destroy_model_parallel()
    _write(out, rank, res)
