#!/usr/bin/env python
"""ImageNet training — the canonical amp workload, on one card or
data-parallel over ranks.

PyTorch port of the JAX package's ``examples/imagenet/main_amp.py``
(reference examples/imagenet/main_amp.py): ResNet under an amp opt
level, a fused optimizer and a dynamic loss scale, train and eval loops
with ``Prec@1``/``Prec@5`` and ``Speed ... img/s``, checkpoint and
resume, with the JAX example's flags and output lines::

    python -m apex_tpu_torch.examples.imagenet.main_amp --arch resnet50 \\
        --opt-level O2 --optimizer lamb -b 128 --epochs 2 \\
        --steps-per-epoch 20 --save-dir ckpt/

Data: synthetic batches drawn on the card from ``--seed`` by default; a
``--data`` directory of ``train*.rec`` (and optional ``val*.rec``) record
files — uint8 HWC image then an int32 label, written with
:func:`apex_tpu_torch.data.write_records` — streams through the native
prefetching :class:`~apex_tpu_torch.data.NativeRecordLoader`; any other
directory is an ImageFolder tree read through ``torchvision``, which
must be installed (there is no fallback to synthetic data).

Each step is the JAX step: forward and backward through the scaled loss
(:func:`~apex_tpu_torch.amp.scaled_value_and_grad`), the optimizer's
``step_if_finite`` on the fp32 masters, the masters rounded into the
model, the scale updated.  A skipped step keeps parameters and optimizer
state bitwise, but the batch norms' running statistics move (the JAX
step keeps the forward's new statistics either way).  ``Speed`` is
measured as the JAX example does: the card is synchronised only at a
print, and the clock restarts there.

Checkpoints are :class:`~apex_tpu_torch.checkpoint.TrainState` trees
(the fp32 parameters, the optimizer's state, the loss scale, and the
batch norms' statistics in ``model_state``), saved after each epoch as
step ``epoch``; ``--resume DIR`` continues after the newest.

``--n-devices N`` trains data-parallel over N ranks, one process a rank,
as the JAX example's ``shard_map`` over ``"data"`` does over N devices::

    python -m apex_tpu_torch.parallel.multiproc --nproc 2 \
        -m apex_tpu_torch.examples.imagenet.main_amp --n-devices 2 \
        --sync_bn --distributed-backend gloo -b 128 ...

(or the caller joins ``torch.distributed`` first).  N must be the
world's size and ``-b`` (the global batch) must divide by it
(``ValueError``).  Every rank draws the whole global batch and keeps its
contiguous rows, ``P("data")``'s split, so the sample stream is the JAX
example's.  The gradients are averaged over the ranks
(:func:`~apex_tpu_torch.parallel.all_reduce_grads`, packed into one
buffer), the finite flag is their minimum and the reported loss their
mean.  ``--sync_bn`` pools the batch norms' statistics over the ranks
(``bn_axis_name="data"``); without it each rank keeps its own running
statistics, as each JAX device does under ``check_rep=False``, and rank
0's are the ones evaluated and saved (the JAX example reads and saves
device 0's).  So a checkpoint taken at one world resumes at any other.
Rank 0 prints, evaluates (the whole eval batch) and saves.
``--distributed-backend`` names the transport and is never switched:
ranks that share a card need ``gloo`` (the JAX example has no such flag;
its mesh needs no transport named).  With one device ``--sync_bn``
changes nothing, as in the JAX example.
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp.scaler import LossScaleState
from apex_tpu_torch.models import (ResNet, ResNetConfig, resnet18_config,
                                   resnet50_config)
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
from apex_tpu_torch.parallel import all_reduce_grads, comm
from apex_tpu_torch.parallel.multiproc import initialize_distributed
from apex_tpu_torch.transformer import parallel_state

ARCHS = {
    "resnet18": resnet18_config,
    "resnet50": resnet50_config,
    # the tiny configuration of the smoke tests
    "resnet_tiny": lambda **kw: ResNetConfig(block_sizes=(1, 1), width=8,
                                             **kw),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="apex_tpu_torch ImageNet "
                                            "training")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic', a directory of train*.rec files, or "
                        "an ImageFolder directory (needs torchvision)")
    p.add_argument("--arch", default="resnet50", choices=sorted(ARCHS))
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("-b", "--batch-size", type=int, default=64,
                   help="global batch size")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adam", "lamb"])
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--resume", default="", help="checkpoint dir to resume "
                                                "from")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--opt-level", default="O0",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--keep-batchnorm-fp32", default=None,
                   type=lambda s: s == "True")
    p.add_argument("--loss-scale", default=None,
                   help="'dynamic' or a float; default per opt level")
    p.add_argument("--sync_bn", action="store_true",
                   help="BN statistics across the data-parallel ranks")
    p.add_argument("--n-devices", type=int, default=1,
                   help="data-parallel width: the number of ranks")
    p.add_argument("--distributed-backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="the collectives' transport at --n-devices above 1: "
                        "nccl across cards; gloo where ranks share a card "
                        "(NCCL refuses them)")
    p.add_argument("--steps-per-epoch", type=int, default=100,
                   help="synthetic-data epoch length")
    p.add_argument("--eval-steps", type=int, default=10)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--save-dir", default="",
                   help="checkpoint directory ('' = no checkpoints)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


class AverageMeter:
    """Reference main_amp.py AverageMeter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def accuracy(logits: torch.Tensor, target: torch.Tensor, topk=(1,)):
    """prec@k (reference main_amp.py:398-410), ties ordered as the JAX
    example's reversed stable argsort orders them."""
    order = torch.argsort(logits.float(), dim=-1, stable=True).flip(-1)
    res = []
    for k in topk:
        correct = (order[:, :k] == target[:, None]).any(dim=1)
        res.append(float(correct.float().mean()) * 100.0)
    return res


# -- the step ----------------------------------------------------------------


def make_optimizer(args, params):
    if args.optimizer == "sgd":
        return FusedSGD(params, lr=args.lr, momentum=args.momentum,
                        weight_decay=args.weight_decay)
    if args.optimizer == "adam":
        return FusedAdam(params, lr=args.lr, weight_decay=args.weight_decay)
    return FusedLAMB(params, lr=args.lr, weight_decay=args.weight_decay)


class Trainer:
    """A ResNet trained under amp, the JAX example's ``TrainState`` in
    the port's idiom: the model (cast in place to the level's dtype, the
    norms fp32 under O2), the fp32 masters the optimizer steps (the
    parameters themselves without master weights), the loss-scale state
    on the device, and the step count.  ``state_dict`` replaces the
    seeded initial weights (the JAX tree through
    :func:`~apex_tpu_torch.models.resnet_state_dict_from_jax`).  ``group``
    (a process group) makes the step data-parallel over its ranks, each
    stepping on its own rows of the global batch."""

    def __init__(self, cfg: ResNetConfig, amp_state: amp.AmpState,
                 make_opt: Callable, device, *, seed: int = 0,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 group=None):
        self.group = group
        self.amp = amp_state
        self.scaler = amp_state.scaler
        self.model = ResNet(cfg, device=device, seed=seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.device = device
        self.masters = amp_state.master_params(self.model)
        amp_state.cast_model(self.model)
        self.params = list(self.model.parameters())
        self.names = [n for n, _ in self.model.named_parameters()]
        self.opt = make_opt(self.masters)
        self.scale_state = self.scaler.init(device)
        self.step = 0
        model = self.model   # not self: no reference cycle keeps a trainer

        def loss_fn(x, y):
            logits = model(x)
            return softmax_cross_entropy_loss(logits.float(), y).mean(), \
                logits
        self.grad_fn = amp.scaled_value_and_grad(loss_fn, self.scaler,
                                                 self.params, has_aux=True)

    def train_step(self, x: torch.Tensor, y: torch.Tensor):
        """One step on this rank's rows; returns (loss, logits, finite),
        device tensors: over a group the loss is the ranks' mean and
        ``finite`` holds where every rank's gradients are finite, the
        logits this rank's.  At one rank nothing here reads the device
        on the host."""
        self.model.train()
        (loss, logits), grads, finite = self.grad_fn(
            self.scale_state, self.amp.cast_inputs(x), y)
        world = comm.group_size(self.group)
        if world > 1:
            grads = mean_over_ranks(grads, self.group)
            finite = comm.all_reduce(finite.to(torch.int32), self.group,
                                     op="min") > 0
            loss = comm.all_reduce(loss, self.group) / world
        self.opt.step_if_finite(finite, grads)
        del grads
        amp.copy_masters(self.params, self.masters)
        self.scale_state = self.scaler.update(self.scale_state, finite)
        self.step += 1
        return loss, logits.detach(), finite

    @torch.no_grad()
    def eval_step(self, x: torch.Tensor, y: torch.Tensor):
        """(loss, logits) with the running statistics."""
        self.model.eval()
        logits = self.model(self.amp.cast_inputs(x))
        self.model.train()
        return softmax_cross_entropy_loss(logits.float(), y).mean(), logits

    # -- the checkpoint tree ---------------------------------------------

    def _opt_state(self) -> dict:
        states = [self.opt.state[m] for m in self.masters]
        if all(states):
            step = states[0]["step"]
            return {"step": step, **{k: {n: s[k] for n, s in
                                         zip(self.names, states)}
                                     for k in self.opt.STATE}}
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=self.device),
                **{k: {n: torch.zeros_like(m, dtype=torch.float32)
                       for n, m in zip(self.names, self.masters)}
                   for k in self.opt.STATE}}

    def state_tree(self) -> ckpt.TrainState:
        """The :class:`~apex_tpu_torch.checkpoint.TrainState` of this
        trainer (live tensors; ``save_checkpoint`` copies them)."""
        return ckpt.TrainState(
            step=torch.tensor(self.step, dtype=torch.int32),
            params={n: m for n, m in zip(self.names, self.masters)},
            opt_state=self._opt_state(),
            scaler_state=self.scale_state,
            model_state=dict(self.model.named_buffers()))

    @torch.no_grad()
    def load_state_tree(self, tree: ckpt.TrainState) -> None:
        """Put a restored :meth:`state_tree` into the trainer."""
        for n, m in zip(self.names, self.masters):
            m.copy_(tree.params[n])
        amp.copy_masters(self.params, self.masters)
        # 0-d leaves come back as [1]
        step = tree.opt_state["step"].to(self.device, torch.int32) \
            .reshape(()).clone()
        for n, m in zip(self.names, self.masters):
            self.opt.state[m] = {"step": step, **{
                k: tree.opt_state[k][n].to(self.device, torch.float32)
                .clone() for k in self.opt.STATE}}
        self.scale_state = LossScaleState(*(
            t.to(self.device).reshape(()).clone()
            for t in tree.scaler_state))
        for n, b in self.model.named_buffers():
            b.copy_(tree.model_state[n])
        self.step = int(tree.step)


def mean_over_ranks(grads, group) -> list:
    """The gradients' mean over ``group``'s ranks (the JAX step's
    ``pmean``), as one all-reduce of the gradients packed flat (each
    element's sum is the same as tensor by tensor)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = all_reduce_grads([flat], group)[0]
    return [t.view_as(g) for t, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def build(args, device, state_dict=None) -> Trainer:
    """The trainer of ``args``, data-parallel over the registered data
    group (``--sync_bn``: its statistics too)."""
    loss_scale = args.loss_scale
    if isinstance(loss_scale, str) and loss_scale != "dynamic":
        loss_scale = float(loss_scale)
    amp_state = amp.initialize(args.opt_level, loss_scale=loss_scale,
                               keep_batchnorm_fp32=args.keep_batchnorm_fp32)
    # --sync_bn over one device is the local batch norm
    bn_axis = "data" if (args.sync_bn and args.n_devices > 1) else None
    cfg = ARCHS[args.arch](num_classes=args.num_classes, bn_axis_name=bn_axis)
    return Trainer(cfg, amp_state, lambda p: make_optimizer(args, p), device,
                   seed=args.seed, state_dict=state_dict,
                   group=parallel_state.get_data_parallel_group())


# -- data --------------------------------------------------------------------


def make_batcher(args, device):
    """``batch(epoch, step, train=True) -> (x NHWC fp32, labels)`` on
    ``device``: synthetic, native records, or an ImageFolder tree."""
    if args.data != "synthetic":
        if not os.path.isdir(args.data):
            raise FileNotFoundError(f"--data {args.data}: no such directory")
        if glob.glob(os.path.join(args.data, "train*.rec")):
            return _native_records_batcher(args, device)
        if glob.glob(os.path.join(args.data, "*.rec")):
            raise ValueError(
                f"{args.data} has .rec files but none matching train*.rec "
                "— the native backend expects train*.rec (+ optional "
                "val*.rec)")
        return _directory_batcher(args, device)
    shape = (args.batch_size, args.image_size, args.image_size, 3)
    gen = torch.Generator(device=device)

    def batch(epoch, step, train=True):
        gen.manual_seed((args.seed + (0 if train else 10_000)) * 1_000_003
                        + epoch * 100_000 + step)
        x = torch.randn(shape, generator=gen, device=device)
        y = torch.randint(0, args.num_classes, (args.batch_size,),
                          generator=gen, device=device)
        return x, y

    return batch


def _native_records_batcher(args, device):
    """The native prefetching loader over packed record files (the
    reference's DALI data-backend role): ``<data>/train*.rec`` shuffled,
    ``<data>/val*.rec`` in order (the train files when absent)."""
    from apex_tpu_torch.data import NativeRecordLoader

    rb = args.image_size * args.image_size * 3 + 4

    def decode(b):
        imgs = b[:, :-4].reshape(-1, args.image_size, args.image_size, 3)
        labels = b[:, -4:].copy().view(np.int32).ravel()
        x = imgs.astype(np.float32) / 255.0 * 2.0 - 1.0
        return (torch.from_numpy(x).to(device),
                torch.from_numpy(labels.astype(np.int64)).to(device))

    train_paths = sorted(glob.glob(os.path.join(args.data, "train*.rec")))
    val_paths = (sorted(glob.glob(os.path.join(args.data, "val*.rec")))
                 or train_paths)
    train_loader = NativeRecordLoader(train_paths, rb, args.batch_size,
                                      shuffle=True, seed=args.seed,
                                      decode=decode)
    val_loader = NativeRecordLoader(val_paths, rb, args.batch_size,
                                    shuffle=False, decode=decode)

    def batch(epoch, step, train=True):
        return (train_loader if train else val_loader).next_batch()

    # main() closes this at exit to reap the C++ worker threads
    batch.close = lambda: (train_loader.close(), val_loader.close())
    return batch


def _directory_batcher(args, device):
    """Reference layout (main_amp.py:205-231): ``<data>/train`` with
    augmented shuffled loading, ``<data>/val`` resized and center-cropped;
    a flat ImageFolder directory serves both when ``train/`` is absent.
    Needs ``torchvision`` (an ImportError says so)."""
    try:
        import torchvision.datasets as datasets
        import torchvision.transforms as transforms
    except ImportError as e:
        raise ImportError(
            f"--data {args.data} is an ImageFolder directory, which needs "
            "torchvision (not installed); write train*.rec files with "
            "apex_tpu_torch.data.write_records instead") from e

    traindir = os.path.join(args.data, "train")
    valdir = os.path.join(args.data, "val")
    if not os.path.isdir(traindir):
        traindir = valdir = args.data

    def make_loader(path, train):
        if train:
            tf = transforms.Compose([
                transforms.RandomResizedCrop(args.image_size),
                transforms.RandomHorizontalFlip(),
                transforms.ToTensor()])
        else:
            tf = transforms.Compose([
                transforms.Resize(int(args.image_size * 1.14)),
                transforms.CenterCrop(args.image_size),
                transforms.ToTensor()])
        return torch.utils.data.DataLoader(
            datasets.ImageFolder(path, tf), batch_size=args.batch_size,
            shuffle=train, drop_last=True)

    loaders = {True: make_loader(traindir, True),
               False: make_loader(valdir, False)}
    its = {True: iter(loaders[True]), False: iter(loaders[False])}

    def batch(epoch, step, train=True):
        try:
            x, y = next(its[train])
        except StopIteration:
            its[train] = iter(loaders[train])
            x, y = next(its[train])
        return (x.permute(0, 2, 3, 1).contiguous().to(device),
                y.to(device))

    return batch


# -- the loops ---------------------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def my_rows(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous rows of a global batch (``P("data")``)."""
    n = comm.group_size(group)
    if n == 1:
        return t
    m = t.shape[0] // n
    r = comm.group_rank(group)
    return t[r * m:(r + 1) * m]


def train_epoch(epoch, trainer: Trainer, batcher, args):
    batch_time, losses, top1, top5 = (AverageMeter() for _ in range(4))
    group = trainer.group
    lead = comm.group_rank(group) == 0
    end = time.time()
    steps_since_print = 0
    for i in range(args.steps_per_epoch):
        x, y = batcher(epoch, i, train=True)
        loss, logits, _ = trainer.train_step(my_rows(x, group),
                                             my_rows(y, group))
        steps_since_print += 1
        if i % args.print_freq == 0:
            loss = float(loss)  # the sync point, as the reference's .item()
            logits = comm.all_gather(logits, group, dim=0)
            if not lead:
                continue
            p1, p5 = accuracy(logits, y, topk=(1, 5))
            n = x.shape[0]
            # elapsed covers every step queued since the last print
            batch_time.update(time.time() - end)
            losses.update(loss, n)
            top1.update(p1, n)
            top5.update(p5, n)
            speed = n * steps_since_print / max(batch_time.val, 1e-9)
            print(f"Epoch: [{epoch}][{i}/{args.steps_per_epoch}]\t"
                  f"Speed {speed:.1f} img/s\tLoss {losses.val:.4f} "
                  f"({losses.avg:.4f})\tPrec@1 {top1.val:.2f}\t"
                  f"Prec@5 {top5.val:.2f}", flush=True)
            end = time.time()
            steps_since_print = 0
    return losses.avg


def validate(trainer: Trainer, batcher, args):
    losses, top1, top5 = (AverageMeter() for _ in range(3))
    for i in range(args.eval_steps):
        x, y = batcher(0, i, train=False)
        loss, logits = trainer.eval_step(x, y)
        p1, p5 = accuracy(logits, y, topk=(1, 5))
        n = x.shape[0]
        losses.update(float(loss), n)
        top1.update(p1, n)
        top5.update(p5, n)
    print(f" * Prec@1 {top1.avg:.3f} Prec@5 {top5.avg:.3f} "
          f"Loss {losses.avg:.4f}", flush=True)
    return top1.avg


def main(argv=None, device=None, *,
         state_dict: Optional[Mapping[str, torch.Tensor]] = None,
         batcher=None) -> ckpt.TrainState:
    """Train (or ``--evaluate``) and return the final
    :class:`~apex_tpu_torch.checkpoint.TrainState` (on every rank).
    ``device`` defaults to the card (at ``--n-devices`` above 1 the
    launcher's ``cuda:LOCAL_RANK``); ``state_dict`` replaces the seeded
    initial weights and ``batcher(epoch, step, train)`` the data (global
    batches; tests hold the port against the JAX example through these).
    The data-parallel group is registered for the run and forgotten at
    its end, and a process group this call joined is left at its end."""
    args = parse_args(argv)
    if args.batch_size % args.n_devices:
        raise ValueError("batch size must divide across devices")
    owns_group = False
    if args.n_devices > 1 and not dist.is_initialized():
        launched = int(os.environ.get("WORLD_SIZE", "1"))
        if launched != args.n_devices:
            raise ValueError(
                f"--n-devices {args.n_devices} needs that many ranks: start "
                "it with python -m apex_tpu_torch.parallel.multiproc --nproc "
                f"{args.n_devices} -m apex_tpu_torch.examples.imagenet."
                f"main_amp ... (WORLD_SIZE is {launched})")
        card = initialize_distributed(args.distributed_backend)
        owns_group = True
        if device is None and card.type == "cuda":
            device = card
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.n_devices != world:
        raise ValueError(f"--n-devices {args.n_devices} but the process "
                         f"group has {world} ranks")
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    try:
        return _run(args, resolve_device(device), state_dict, batcher)
    finally:
        parallel_state.destroy_model_parallel()
        if owns_group:
            dist.destroy_process_group()


def _run(args, dev, state_dict, batcher) -> ckpt.TrainState:
    trainer = build(args, dev, state_dict)
    batcher = batcher or make_batcher(args, dev)
    lead = comm.group_rank(trainer.group) == 0
    say = functools.partial(print, flush=True) if lead else \
        (lambda *a, **k: None)

    start_epoch = args.start_epoch
    if args.resume:
        if ckpt.latest_step(args.resume) is not None:
            tree, epoch_saved = ckpt.restore_checkpoint(
                args.resume, target=trainer.state_tree())
            trainer.load_state_tree(tree)
            start_epoch = epoch_saved + 1
            say(f"=> resumed from '{args.resume}' (epoch {epoch_saved})")
        else:
            say(f"=> no checkpoint found at '{args.resume}'")

    try:
        if args.evaluate:
            if lead:
                validate(trainer, batcher, args)
            return trainer.state_tree()
        best_prec1 = 0.0
        for epoch in range(start_epoch, args.epochs):
            train_epoch(epoch, trainer, batcher, args)
            if not lead:
                continue
            prec1 = validate(trainer, batcher, args)
            best_prec1 = max(best_prec1, prec1)
            if args.save_dir:
                ckpt.save_checkpoint(args.save_dir, trainer.state_tree(),
                                     step=epoch, keep=3)
                say(f"=> saved checkpoint (epoch {epoch})")
        say(f"Best Prec@1: {best_prec1:.3f}")
        _sync(dev)
        if comm.group_size(trainer.group) > 1:
            # every rank leaves with rank 0's checkpoint whole
            dist.barrier(group=trainer.group)
        return trainer.state_tree()
    finally:
        # the native-record batcher's close() reaps its C++ worker threads
        getattr(batcher, "close", lambda: None)()


if __name__ == "__main__":
    main()
