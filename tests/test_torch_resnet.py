"""The port's ResNet path against the JAX package's, live on the CPU.

Each case runs the same numpy inputs (drawn from a seed) through the JAX
function and its port: batch norm (``sync_batch_norm`` in train and eval,
with and without running statistics, forward and backward, fp32 and
bf16), GroupBN's ``BatchNorm2d_NHWC`` (``fuse_relu`` and the ``z``
residual), the contrib ``Bottleneck`` (with and without the downsample,
strides 1 and 2), the TF "SAME" padding rule of the convolutions, and
``ResNet`` at ``resnet_tiny`` forward and backward.  Then the step: the
port's amp step held against ``tests/L1/common/harness.py``'s
``run_trajectory`` (O0 Adam and O2 LAMB with a dynamic scale, and O0
momentum SGD, which shows the step exact), the dynamic-vs-static bitwise contract inside the port, and the
ImageNet example against the JAX example's ``main`` (train, eval, resume,
evaluate-only, the bad batch split, the record backend).  The errors of
the arguments that work across ranks (the ranks themselves run in
tests/test_torch_syncbn.py and tests/test_torch_imagenet_dp.py).

Tolerances (x max(1, max|ref|) unless said): fp32 forward 1e-5 and
gradients 1e-4 (sums over the batch in another order, through
rsqrt(var + eps)); bf16 outputs 2^-7 (one bf16 ulp at the output's
scale: the fp32 values either side of a rounding boundary may round
apart) and their gradients 2^-6; convolutions 1e-5 (oneDNN and XLA sum
the taps in another order).  Trajectories over 12 steps, each loss: O0
momentum SGD 1e-6 relative (the step itself: read 2.6e-7); O0 Adam 5e-3
relative (read 1.4e-3: Adam divides by sqrt(v), so a gradient near zero
whose last bits differ with the order of the sums takes a step of up to
lr either way, and the losses drift apart from step 1 on, as the SGD
cell from the same gradients does not); O2 LAMB 2e-2 absolute on losses
near 2.3 (bf16 convolutions in two libraries).
"""

import functools
import importlib.util
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.bottleneck import Bottleneck as JBottleneck
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JGroupBN
from apex_tpu.models import ResNet as JResNet
from apex_tpu.models import ResNetConfig as JResNetConfig
from apex_tpu.parallel import sync_batchnorm as jsbn
from apex_tpu_torch import amp
from apex_tpu_torch.contrib import bottleneck as tbneck
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.examples.imagenet import main_amp as tmain
from apex_tpu_torch.models import ResNet, ResNetConfig, resnet_state_dict_from_jax
from apex_tpu_torch.models.resnet import conv_same, same_pads
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
from apex_tpu_torch.parallel import (SyncBatchNorm, bn_state_dict_from_jax,
                                     convert_syncbn_model,
                                     create_syncbn_process_group,
                                     sync_batch_norm)
from tests.L1.common.harness import RunConfig, _resnet_batch, run_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_FWD, FP32_GRAD = 1e-5, 1e-4
BF16_FWD, BF16_GRAD = 2.0 ** -7, 2.0 ** -6
SGD_TRAJ_RTOL = 1e-6
O0_TRAJ_RTOL = 5e-3
O2_TRAJ_ATOL = 2e-2
TINY = dict(block_sizes=(1, 1), width=8, num_classes=10)


@functools.lru_cache(maxsize=None)
def jax_init(seed=0):
    """The JAX ``ResNet.init`` at ``resnet_tiny`` (jitted, once a seed)."""
    return jax.jit(JResNet(JResNetConfig(**TINY)).init)(
        jax.random.PRNGKey(seed))


def close(got, ref, tol, what=""):
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bar = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= bar, f"{what}: max|err| {err} > {bar}"


def t(a, dtype=torch.float32, grad=False):
    out = torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)
    return out.requires_grad_(grad)


def tn(x):
    return x.detach().float().numpy()


# -- batch norm ----------------------------------------------------------------


BN_CASES = [(train, stats, dt) for train in (True, False)
            for stats in (True, False) for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("training,with_stats,dtype", BN_CASES)
def test_sync_batch_norm_matches_jax(training, with_stats, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 5, 3, 6)) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(6).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    rm = rng.standard_normal(6).astype(np.float32) if with_stats else None
    rv = rng.uniform(0.5, 2, 6).astype(np.float32) if with_stats else None
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)

    def jf(x, w, b):
        y, nrm, nrv = jsbn.sync_batch_norm(
            x, w, b, None if rm is None else jnp.asarray(rm),
            None if rv is None else jnp.asarray(rv), axis_name=None,
            training=training, momentum=0.1)
        return jnp.sum(y.astype(jnp.float32) * dy), (y, nrm, nrv)

    (_, (jy, jrm, jrv)), jg = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = t(x, tdt, True), t(w, grad=True), t(b, grad=True)
    ty, trm, trv = sync_batch_norm(
        tx, tw, tb, None if rm is None else t(rm),
        None if rv is None else t(rv), training=training, momentum=0.1)
    (ty.float() * t(dy)).sum().backward()
    fwd, grad = (FP32_FWD, FP32_GRAD) if dtype == "float32" else \
        (BF16_FWD, BF16_GRAD)
    assert ty.dtype == tdt
    close(tn(ty), jy, fwd, "y")
    for got, ref, n in ((tx.grad, jg[0], "dx"), (tw.grad, jg[1], "dw"),
                        (tb.grad, jg[2], "db")):
        close(tn(got), ref, grad, n)
    if jrm is None:
        assert trm is None and trv is None
    else:
        close(tn(trm), jrm, FP32_FWD, "running mean")
        close(tn(trv), jrv, FP32_FWD, "running var")


def test_sync_batchnorm_module_and_convert():
    """The module normalises the last axis (channel_last) and updates its
    buffers as the JAX module's state; ``convert_syncbn_model`` swaps a
    torch BatchNorm2d for it, weights and statistics carried."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3, 3, 5)).astype(np.float32)
    jm = jsbn.SyncBatchNorm(5, process_group=None)
    jv0 = jm.init()
    jv0["params"]["weight"] = jnp.linspace(0.5, 1.5, 5)
    jv0["state"]["running_var"] = jnp.linspace(1.0, 2.0, 5)
    jy, jv = jm.apply(jv0, jnp.asarray(x))
    m = SyncBatchNorm(5, device="cpu")
    m.load_state_dict(bn_state_dict_from_jax(jv0))
    y = m(t(x))
    close(tn(y), jy, FP32_FWD)
    close(tn(m.running_var), jv["state"]["running_var"], FP32_FWD)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1), torch.nn.BatchNorm2d(4))
    net[1].running_mean.fill_(0.25)
    net = convert_syncbn_model(net)
    assert isinstance(net[1], SyncBatchNorm) and net[1].channel_axis == 1
    assert float(net[1].running_mean[0]) == 0.25
    assert create_syncbn_process_group(1, 1) is None
    with pytest.raises(ValueError):
        create_syncbn_process_group(3, 8)


@pytest.mark.parametrize("variant", ["plain", "fuse_relu", "z"])
def test_groupbn_matches_jax(variant):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
    z = rng.standard_normal(x.shape).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jbn = JGroupBN(6, fuse_relu=variant == "fuse_relu")
    v = jbn.init()

    def jf(x, p, z):
        y, nv = jbn.apply({"params": p, "state": v["state"]}, x,
                          z if variant == "z" else None)
        return jnp.sum(y * dy), (y, nv)

    (_, (jy, jv)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(x), v["params"], jnp.asarray(z))
    bn = BatchNorm2d_NHWC(6, fuse_relu=variant == "fuse_relu", device="cpu")
    bn.load_state_dict(bn_state_dict_from_jax(v))
    tx, tz = t(x, grad=True), t(z, grad=True)
    y = bn(tx, tz if variant == "z" else None)
    (y * t(dy)).sum().backward()
    close(tn(y), jy, FP32_FWD, "y")
    close(tn(tx.grad), jg[0], FP32_GRAD, "dx")
    close(tn(bn.weight.grad), jg[1]["weight"], FP32_GRAD, "dweight")
    close(tn(bn.bias.grad), jg[1]["bias"], FP32_GRAD, "dbias")
    if variant == "z":
        close(tn(tz.grad), jg[2], FP32_GRAD, "dz")
    for k in ("running_mean", "running_var", "minibatch_mean",
              "minibatch_riv"):
        close(tn(getattr(bn, k)), jv["state"][k], FP32_FWD, k)
    bn.eval()
    jy_eval, _ = jbn.apply(jv, jnp.asarray(x), training=False)
    close(tn(bn(t(x))), jy_eval, FP32_FWD, "eval")


# -- convolutions ----------------------------------------------------------------


@pytest.mark.parametrize("k,s", [(7, 2), (3, 2), (3, 1), (1, 2)])
@pytest.mark.parametrize("n", [8, 9])
def test_same_padding_matches_jax(k, s, n):
    """TF "SAME": at 7x7/s2 on an even size 2 before and 3 after, at
    3x3/s2 0 and 1; ``conv_same`` equals the JAX convolution."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, n, n + 1, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    pads = jax.lax.padtype_to_pads((n, n + 1), (k, k), (s, s), "SAME")
    assert [same_pads(n, k, s), same_pads(n + 1, k, s)] == \
        [tuple(p) for p in pads]
    if (k, s) == (7, 2) and n == 8:
        assert same_pads(8, 7, 2) == (2, 3)
    if (k, s) == (3, 2) and n == 8:
        assert same_pads(8, 3, 2) == (0, 1)
    tw = t(w.transpose(3, 2, 0, 1)).contiguous(
        memory_format=torch.channels_last)
    got = conv_same(t(x).permute(0, 3, 1, 2), tw, s).permute(0, 2, 3, 1)
    close(tn(got), ref, FP32_FWD)


@pytest.mark.parametrize("cin,cout,stride", [(8, 8, 1), (8, 16, 1),
                                              (8, 16, 2), (16, 16, 2)])
def test_bottleneck_matches_jax(cin, cout, stride):
    blk = JBottleneck(cin, 4, cout, stride=stride)
    params = blk.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    params = {k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
              if k.startswith(("scale", "bias")) else v
              for k, v in params.items()}
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    dy = rng.standard_normal((2, 8 // stride, 8 // stride, cout)
                             ).astype(np.float32)
    out, vjp = jax.vjp(lambda p, x: blk.apply(p, x), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    tb = tbneck.Bottleneck(cin, 4, cout, stride=stride, device="cpu")
    tb.load_state_dict(tbneck.bottleneck_state_dict_from_jax(params))
    assert tb.has_downsample == ("conv4" in params)
    tx = t(x, grad=True)
    y = tb(tx)
    (y * t(dy)).sum().backward()
    close(tn(y), out, FP32_FWD, "y")
    close(tn(tx.grad), gx, FP32_GRAD, "dx")
    ref = tbneck.bottleneck_state_dict_from_jax(gp)
    for n, p in tb.named_parameters():
        close(tn(p.grad), ref[n].numpy(), FP32_GRAD, n)


def test_resnet_tiny_forward_backward_matches_jax():
    jm = JResNet(JResNetConfig(**TINY))
    params, state = jax_init(0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 17, 16, 3)).astype(np.float32)
    w = rng.standard_normal(10).astype(np.float32)

    def jf(p):
        logits, new = jm.apply(p, state, jnp.asarray(x), training=True)
        return jnp.sum(logits * w), (logits, new)

    (_, (jlogits, jnew)), jg = jax.jit(jax.value_and_grad(
        jf, has_aux=True))(params)
    model = ResNet(ResNetConfig(**TINY), device="cpu")
    model.load_state_dict(resnet_state_dict_from_jax(params, state))
    logits = model(t(x))
    (logits * t(w)).sum().backward()
    close(tn(logits), jlogits, FP32_FWD, "logits")
    ref = resnet_state_dict_from_jax(jg, jnew)
    for n, p in model.named_parameters():
        close(tn(p.grad), ref[n].numpy(), FP32_GRAD, n)
    for n, b in model.named_buffers():
        close(tn(b), ref[n].numpy(), FP32_FWD, n)
    model.eval()
    jeval, _ = jm.apply(params, jnew, jnp.asarray(x), training=False)
    with torch.no_grad():
        close(tn(model(t(x))), jeval, FP32_FWD, "eval logits")


def test_multi_rank_arguments_raise():
    """What the arguments that work across ranks refuse (the ranks
    themselves run in tests/test_torch_syncbn.py and
    tests/test_torch_imagenet_dp.py): a group name with no registered
    group above one rank (the world patched to 2 here), a ``bn_group``
    its group's size does not match, a local H the stride does not
    divide, ``-b`` that ``--n-devices`` does not divide, and
    ``--n-devices`` above the ranks started.  At a world of one a name
    is this rank alone, as JAX's axis of one device."""
    from apex_tpu_torch.parallel import sync_batchnorm as tsbn

    x = t(np.ones((2, 4, 4, 8)))
    with mock.patch.object(tsbn, "_world", return_value=2):
        for make in (
                lambda: sync_batch_norm(t(np.ones((2, 3))), None, None,
                                        axis_name="data"),
                lambda: SyncBatchNorm(3, process_group="data", device="cpu"),
                lambda: convert_syncbn_model(torch.nn.BatchNorm2d(3), "data"),
                lambda: ResNet(ResNetConfig(**TINY, bn_axis_name="data"),
                               device="cpu"),
                lambda: tbneck.SpatialBottleneck(8, 4, 8, axis_name="spatial",
                                                 device="cpu"),
                lambda: tbneck.halo_exchange(x, "spatial")):
            with pytest.raises(ValueError,
                               match="names no registered process group"):
                make()
    with pytest.raises(TypeError, match="process group"):
        sync_batch_norm(x, None, None, axis_name=("data_outer", "data_bn"))
    with pytest.raises(ValueError, match="group of 1 rank"):
        BatchNorm2d_NHWC(4, bn_group=2, axis_name="data_bn", device="cpu")
    with pytest.raises(ValueError, match="requires axis_name"):
        BatchNorm2d_NHWC(4, bn_group=2, device="cpu")
    with pytest.raises(ValueError, match="divisible by stride"):
        tbneck.SpatialBottleneck(8, 4, 16, stride=2, axis_name="spatial",
                                 device="cpu")(t(np.ones((1, 3, 4, 8))))
    with pytest.raises(ValueError, match="divisible by the stride"):
        tbneck.spatial_conv2d(t(np.ones((1, 3, 4, 2))),
                              t(np.ones((2, 2, 3, 3))), stride=2,
                              axis_name="spatial")
    with pytest.raises(ValueError, match="divide across devices"):
        tmain.main(["--arch", "resnet_tiny", "-b", "8", "--n-devices", "3"],
                   device="cpu")
    with pytest.raises(ValueError, match="needs that many ranks"):
        tmain.main(["--arch", "resnet_tiny", "-b", "8", "--n-devices", "2"],
                   device="cpu")
    # a world of one: the names are this rank alone
    ResNet(ResNetConfig(**TINY, bn_axis_name="data"), device="cpu")
    assert torch.equal(tbneck.halo_exchange(x, "spatial", 1, 2)[:, 1:5], x)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (lambda: ResNet(ResNetConfig(**TINY)),
                 lambda: SyncBatchNorm(4), lambda: BatchNorm2d_NHWC(4),
                 lambda: tbneck.Bottleneck(8, 4, 8),
                 lambda: tmain.main(["--arch", "resnet_tiny", "-b", "8"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# -- the step against run_trajectory ---------------------------------------------


def port_trajectory(opt_level, optimizer, loss_scale, steps=12, seed=0,
                    lr=1e-2):
    """``run_trajectory``'s ResNet cell in the port: the same initial
    weights (the JAX init, converted) and batches, the port's amp step."""
    params, state = jax_init(seed)
    amp_state = amp.initialize(opt_level, loss_scale=loss_scale)
    make = {"adam": lambda p: FusedAdam(p, lr=lr, weight_decay=1e-4),
            "lamb": lambda p: FusedLAMB(p, lr=lr, weight_decay=1e-4),
            "sgd": lambda p: FusedSGD(p, lr=lr, momentum=0.9)}[optimizer]
    tr = tmain.Trainer(ResNetConfig(**TINY), amp_state, make,
                       torch.device("cpu"),
                       state_dict=resnet_state_dict_from_jax(params, state))
    losses = []
    for i in range(steps):
        x, y = (np.asarray(a) for a in _resnet_batch(i, seed))
        loss, _, _ = tr.train_step(t(x), torch.from_numpy(np.array(y)).long())
        losses.append(float(loss))
    return losses, tr


@pytest.mark.parametrize("optimizer,rtol", [("adam", O0_TRAJ_RTOL),
                                             ("sgd", SGD_TRAJ_RTOL)])
def test_o0_trajectory_matches_run_trajectory(optimizer, rtol):
    ref = run_trajectory(RunConfig(model="resnet", opt_level="O0",
                                   optimizer=optimizer, loss_scale=1.0))
    got, _ = port_trajectory("O0", optimizer, 1.0)
    np.testing.assert_allclose(got, ref, rtol=rtol)
    assert got[-2] < got[0] and got[-1] < got[1]


def test_o2_lamb_dynamic_trajectory_and_static_bitwise():
    ref = run_trajectory(RunConfig(model="resnet", opt_level="O2",
                                   optimizer="lamb", loss_scale="dynamic"))
    dyn, tr = port_trajectory("O2", "lamb", "dynamic")
    np.testing.assert_allclose(dyn, ref, atol=O2_TRAJ_ATOL)
    assert dyn[-2] < dyn[0] and dyn[-1] < dyn[1]
    # O2 keeps the norms fp32 by name, the rest bf16
    dt = {n: p.dtype for n, p in tr.model.named_parameters()}
    assert dt["layer1.0.bn_ds.weight"] == torch.float32
    assert dt["layer1.0.conv2.w"] == torch.bfloat16
    assert dt["fc.w"] == torch.bfloat16
    # tests/L1/test_cross_product.py:44-53 inside the port: dynamic from
    # 2^16 with no overflow == static 2^16, bitwise
    static, _ = port_trajectory("O2", "lamb", 2.0 ** 16)
    assert dyn == static


# -- the ImageNet example against the JAX example ---------------------------------


def _jax_example():
    path = os.path.join(REPO, "examples", "imagenet", "main_amp.py")
    spec = importlib.util.spec_from_file_location("jax_imagenet_main", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARGS = ["--arch", "resnet_tiny", "--image-size", "16", "--num-classes", "10",
        "-b", "8", "--steps-per-epoch", "6", "--eval-steps", "2",
        "--print-freq", "3", "--lr", "0.01"]
LOSS_RE = re.compile(r"Loss (\S+)")


def _losses(text):
    return [float(v) for v in LOSS_RE.findall(text)]


def _port_inputs(jmod, argv):
    """The JAX example's initial weights and synthetic batches, for the
    port's ``main``."""
    args = jmod.parse_args(argv)
    assert jmod.ARCHS[args.arch](num_classes=args.num_classes) == \
        JResNetConfig(**TINY)
    params, state = jax_init(args.seed)
    jbatch = jmod.make_batcher(args)

    def batch(epoch, step, train=True):
        x, y = jbatch(epoch, step, train)
        return t(x), torch.from_numpy(np.array(y)).long()

    return resnet_state_dict_from_jax(params, state), batch


def _both(jmod, argv, capsys, data_from_jax=True):
    jstate = jmod.main(argv)
    jout = capsys.readouterr().out
    sd, batch = _port_inputs(jmod, argv)
    tstate = tmain.main(argv, device="cpu", state_dict=sd,
                        batcher=batch if data_from_jax else None)
    tout = capsys.readouterr().out
    return jstate, jout, tstate, tout


def test_imagenet_example_train_eval_resume_matches_jax(tmp_path, capsys):
    jmod = _jax_example()
    run1 = ARGS + ["--epochs", "1", "--opt-level", "O2", "--optimizer",
                   "lamb"]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jstate = jmod.main(run1 + ["--save-dir", jd])
    jout = capsys.readouterr().out
    sd, batch = _port_inputs(jmod, run1)
    tstate = tmain.main(run1 + ["--save-dir", td], device="cpu",
                        state_dict=sd, batcher=batch)
    tout = capsys.readouterr().out
    for out in (jout, tout):
        assert "Prec@1" in out and "img/s" in out and "saved" in out
    assert int(tstate.step) == int(jstate.step) == 6
    np.testing.assert_allclose(_losses(tout), _losses(jout),
                               atol=O2_TRAJ_ATOL)
    # resume: one more epoch on top of the saved one, in each package
    run2 = ARGS + ["--epochs", "2", "--opt-level", "O2", "--optimizer",
                   "lamb"]
    jstate = jmod.main(run2 + ["--save-dir", jd, "--resume", jd])
    jout = capsys.readouterr().out
    tstate = tmain.main(run2 + ["--save-dir", td, "--resume", td],
                        device="cpu", state_dict=sd, batcher=batch)
    tout = capsys.readouterr().out
    assert "resumed from" in tout and "(epoch 0)" in tout
    assert int(tstate.step) == int(jstate.step) == 12
    np.testing.assert_allclose(_losses(tout), _losses(jout),
                               atol=O2_TRAJ_ATOL)
    # evaluate only, from the resumed checkpoint
    tmain.main(ARGS + ["--epochs", "2", "--opt-level", "O2", "--optimizer",
                       "lamb", "--evaluate", "--resume", td], device="cpu")
    out = capsys.readouterr().out
    assert "Prec@1" in out and "Epoch" not in out and "resumed" in out


def test_imagenet_example_bad_batch_split_and_missing_data():
    with pytest.raises(ValueError):
        _jax_example().main(ARGS + ["--epochs", "1", "--n-devices", "3"])
    with pytest.raises(ValueError):
        tmain.main(ARGS + ["--epochs", "1", "--n-devices", "3"],
                   device="cpu")
    with pytest.raises(FileNotFoundError):
        tmain.main(ARGS + ["--data", "/nonexistent-dir"], device="cpu")


def test_imagenet_example_record_backend_matches_jax(tmp_path, capsys):
    """Both examples train from the same record files through their
    native loaders (the port's a copy of the JAX package's), from the
    same weights: the same batches, the same losses within the bar."""
    from apex_tpu_torch.data import native_available, write_records
    if not native_available():
        pytest.skip("native toolchain unavailable")
    img, classes, n = 16, 10, 48
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (n, img * img * 3), dtype=np.int64)
    labels = rng.integers(0, classes, (n,), dtype=np.int64)
    recs = np.concatenate(
        [imgs.astype(np.uint8),
         labels.astype(np.int32).view(np.uint8).reshape(n, 4)], axis=1)
    write_records(str(tmp_path / "train0.rec"), recs)
    argv = ARGS + ["--epochs", "1", "--data", str(tmp_path)]
    jstate, jout, tstate, tout = _both(_jax_example(), argv, capsys,
                                       data_from_jax=False)
    assert int(tstate.step) == int(jstate.step) == 6
    assert "Prec@1" in tout
    np.testing.assert_allclose(_losses(tout), _losses(jout),
                               rtol=O0_TRAJ_RTOL)
