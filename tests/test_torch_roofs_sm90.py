"""K10's Hopper route, ``csrc/attention_dots_sm90.cu``, as far as the CPU
can read it.

The kernel runs only on the card, where ``chip_smoke.py`` phase 12 holds
it against the plain version (and ``tests/test_torch_roofs.py`` holds the
plain version against the JAX bench's Pallas kernel).  Here:

* its walk, as :func:`roofs.dots_walk` states it (the 64-key steps each
  warpgroup of each q tile multiplies: 128-row tiles of two warpgroups at
  head dim 64, 192-row tiles of three at 128; with the 64-key tails of
  unequal blocks and the q tails past s), pair by pair against the skip
  rule (:func:`roofs.dots_keep`) and in sum against
  :func:`roofs.dots_pairs`; the walk's constants against the source, read
  as text;
* the wrapper's launch, with the ``Kernel`` objects replaced by recorders
  so that nothing is launched: it reaches ``ATTENTION_DOTS_SM90`` with the
  operands' pointers, the clipped blocks and ``visits``, and never the
  route before it, ``ATTENTION_DOTS``;
* CPU tensors launch nothing.

Everything is exact; no tolerance.
"""

import re
from pathlib import Path

import pytest
import torch

from apex_tpu_torch import kernels
from apex_tpu_torch.profiling import roofs

SOURCE = (Path(roofs.__file__).resolve().parent.parent / "csrc"
          / "attention_dots_sm90.cu").read_text()

# the three shapes chip_smoke.py times K10 at (bench.py's microbench,
# GPT-1.3B's attention at blocks of 64, Transformer-big's encoder), then
# the edges of the walk it also holds on the card, and a few more
WALKS = [
    (1024, 512, 512),
    (2048, 64, 64),
    (256, 64, 64),
    (192, 64, 64),       # q tail of a 128-row tile; none of a 192-row one
    (320, 64, 64),       # the last warpgroup of either tile past s
    (512, 64, 128),      # the prefix ends halfway through a 128-key block
    (512, 128, 64),      # warpgroups of a tile keeping one prefix
    (384, 192, 64),      # a tile whose warpgroups lie in two q blocks
    (320, 64, 320),      # one k block; a q tail
    (64, 64, 64),        # one warpgroup, one step
]
HEAD_DIMS = list(roofs.DOTS_HEAD_DIMS)


def walk_keep(s, block_q, block_k, d):
    """bool [s, s]: the pairs the walk multiplies, each at most once."""
    keep = torch.zeros(s, s, dtype=torch.int32)
    for t, wgs in enumerate(roofs.dots_walk(s, block_q, block_k, d)):
        for w, steps in enumerate(wgs):
            qw = t * roofs.dots_rows(d) + w * 64
            for k0 in steps:
                keep[qw:qw + 64, k0:k0 + roofs.DOTS_TILE] += 1
    assert int(keep.max()) <= 1
    return keep.bool()


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s,block_q,block_k", WALKS)
def test_walk_multiplies_exactly_the_rule_pairs(s, block_q, block_k, d):
    assert torch.equal(walk_keep(s, block_q, block_k, d),
                       roofs.dots_keep(s, block_q, block_k))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s,block_q,block_k", WALKS)
def test_walk_sums_to_the_pairs_count(s, block_q, block_k, d):
    walk = roofs.dots_walk(s, block_q, block_k, d)
    assert len(walk) == -(-s // roofs.dots_rows(d))
    assert all(len(wgs) == roofs.DOTS_SM90_WARPGROUPS[d] for wgs in walk)
    steps = sum(len(st) for wgs in walk for st in wgs)
    assert steps * roofs.DOTS_TILE ** 2 == roofs.dots_pairs(s, block_q,
                                                            block_k)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s,block_q,block_k", WALKS)
def test_walk_steps_are_a_prefix_in_key_order(s, block_q, block_k, d):
    """Each warpgroup adds its keys into one accumulator in key order, a
    prefix of 64-key steps; a later warpgroup of a tile walks at least as
    far as an earlier one unless its rows lie past s, where it walks
    nothing, and the block loads the longest walk only."""
    for t, wgs in enumerate(roofs.dots_walk(s, block_q, block_k, d)):
        for w, steps in enumerate(wgs):
            assert list(steps) == list(range(0, 64 * len(steps), 64))
            assert 64 * len(steps) <= s
            past_s = t * roofs.dots_rows(d) + 64 * w >= s
            assert (len(steps) == 0) == past_s
            if w and not past_s:
                assert len(steps) >= len(wgs[w - 1]) > 0


@pytest.mark.parametrize("d,s,lens", [
    (64, 192, [(1, 2), (3, 0)]),             # half the last tile past s
    (128, 192, [(1, 2, 3)]),                 # no tail
    (128, 320, [(1, 2, 3), (4, 5, 0)]),      # the last warpgroup past s
    (64, 320, [(1, 2), (3, 4), (5, 0)]),
])
def test_q_tail_warpgroups_multiply_nothing(d, s, lens):
    walk = roofs.dots_walk(s, 64, 64, d)
    assert [tuple(map(len, wgs)) for wgs in walk] == lens


@pytest.mark.parametrize("s,block_q,block_k", [(256, 96, 64), (256, 64, 32)])
def test_walk_refuses_blocks_off_the_step(s, block_q, block_k):
    with pytest.raises(ValueError):
        roofs.dots_walk(s, block_q, block_k, 64)


def _source_constant(name):
    """``name``'s value in a ``constexpr int`` declaration of the source."""
    return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)[,;]",
                         SOURCE).group(1))


def test_walk_constants_are_the_sources():
    for d in HEAD_DIMS:
        assert _source_constant(f"kWarpgroupsD{d}") == \
            roofs.DOTS_SM90_WARPGROUPS[d]
        assert _source_constant(f"kStagesD{d}") >= 3
    assert "rows_per_block(int d) { return 64 * warpgroups(d); }" in SOURCE
    assert _source_constant("kStep") == roofs.DOTS_TILE
    assert "int attention_dots_sm90(int device," in SOURCE
    assert kernels.ATTENTION_DOTS_SM90.source == "attention_dots_sm90.cu"
    assert kernels.ATTENTION_DOTS_SM90.symbol == "attention_dots_sm90"
    assert kernels.ATTENTION_DOTS_SM90 in kernels.KERNELS
    assert "ATTENTION_DOTS_SM90" in kernels.__all__
    # the route before stays built and registered, to be compared
    assert kernels.ATTENTION_DOTS in kernels.KERNELS


def test_visits_len_is_a_count_a_block():
    assert roofs.dots_visits_len(128, 1024, 64) == 128 * 8
    assert roofs.dots_visits_len(64, 2048, 128) == 64 * 11
    assert roofs.dots_visits_len(8, 192, 64) == 8 * 2
    assert roofs.dots_visits_len(8, 192, 128) == 8 * 1


# -- the wrapper's launch ----------------------------------------------------


class _Recorder:
    """Stands in for a ``Kernel``: keeps the arguments of each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)


@pytest.fixture
def recorders(monkeypatch):
    rec = {"ATTENTION_DOTS": _Recorder(), "ATTENTION_DOTS_SM90": _Recorder()}
    monkeypatch.setattr(kernels, "ATTENTION_DOTS", rec["ATTENTION_DOTS"])
    monkeypatch.setattr(roofs, "ATTENTION_DOTS_SM90",
                        rec["ATTENTION_DOTS_SM90"])
    monkeypatch.setattr(roofs, "_stream", lambda device: None)
    return rec


def _operands(bh, s, d):
    g = torch.Generator().manual_seed(bh + s + d)
    return [torch.randn(bh, s, d, generator=g).to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("bh,s,d,block_q,block_k,bq,bk", [
    (128, 1024, 64, 512, 512, 512, 512),    # bench.py's
    (4, 256, 128, 512, 512, 256, 256),      # blocks clipped to s
    (8, 192, 64, 64, 64, 64, 64),           # a q tail
    (2, 512, 128, 64, 128, 64, 128),
])
@pytest.mark.parametrize("with_visits", [False, True])
def test_wrapper_launches_the_sm90_entry(recorders, bh, s, d, block_q,
                                         block_k, bq, bk, with_visits):
    q, k, v = _operands(bh, s, d)
    visits = (torch.zeros(roofs.dots_visits_len(bh, s, d), dtype=torch.int32)
              if with_visits else None)
    o = roofs._attention_dots_cuda(q, k, v, block_q, block_k, visits=visits)
    assert recorders["ATTENTION_DOTS"].calls == []
    (args,) = recorders["ATTENTION_DOTS_SM90"].calls
    assert args == (q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(),
                    visits.data_ptr() if with_visits else None,
                    bh, s, d, bq, bk, None)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert o.is_contiguous() and o.data_ptr() % 16 == 0


@pytest.mark.parametrize("bad", ["int64", "short", "long"])
def test_wrapper_refuses_a_visits_it_cannot_fill(recorders, bad):
    q, k, v = _operands(2, 256, 64)
    n = roofs.dots_visits_len(2, 256, 64)
    visits = {"int64": torch.zeros(n, dtype=torch.int64),
              "short": torch.zeros(n - 1, dtype=torch.int32),
              "long": torch.zeros(n + 1, dtype=torch.int32)}[bad]
    with pytest.raises(ValueError, match="visits"):
        roofs._attention_dots_cuda(q, k, v, 64, 64, visits=visits)
    assert not any(r.calls for r in recorders.values())


@pytest.mark.parametrize("case", ["head dim", "blocks", "strided"])
def test_wrapper_refuses_before_any_launch(recorders, case):
    q, k, v = _operands(2, 256, 64 if case != "head dim" else 32)
    bq = 96 if case == "blocks" else 64
    if case == "blocks":
        q, k, v = _operands(2, 192, 64)
    if case == "strided":
        q = torch.randn(2, 64, 256).to(torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        roofs._attention_dots_cuda(q, k, v, bq, 64)
    assert not any(r.calls for r in recorders.values())


def test_cpu_tensors_launch_nothing():
    q, k, v = _operands(2, 256, 64)
    before = [kern.launches for kern in kernels.KERNELS]
    o = roofs.attention_dots(q, k, v, 64, 128)
    assert [kern.launches for kern in kernels.KERNELS] == before
    assert torch.equal(o, roofs._attention_dots_plain(q, k, v, 64, 128))
