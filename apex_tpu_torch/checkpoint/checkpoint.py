"""Checkpoint save/restore in the JAX package's on-disk format.

PyTorch port of the JAX package's ``apex_tpu/checkpoint/checkpoint.py``.
A checkpoint written here is one the JAX package restores, and the
reverse:

- **Format**: per-step directory ``step_<N>/`` holding ``arrays.npz``
  (flat ``keystr(path) -> ndarray``) + ``manifest.json`` (per-leaf
  dtype, shape and structured path, the step, the optional
  ``data_state``), or with ``packed=True`` one ``arrays.pack`` superblock
  gathered by the native threaded pack (format 2).  Atomic via tmp dir +
  rename; a ``latest`` marker names the newest step.
- **Leaf names** are ``jax.tree_util.keystr`` strings of the tree's paths
  (:func:`apex_tpu_torch.utils.tree.keystr`): dicts in sorted key order,
  ``[i]`` for sequence items, ``.field`` for namedtuple fields.
- **Precision portability**: bf16/fp16 leaves are stored as fp32
  (``fp32_portable``, the default) or as their raw 16 bits
  (``"uint16_bits"``), and restored to the target's dtype.
- **Integrity**: every stored array's CRC32 (of its C-order bytes) is in
  the manifest; ``verify=True`` re-hashes on restore and raises
  :class:`CheckpointCorruptionError` on any mismatch or unreadable file.

A tree is nested dicts, lists, tuples and namedtuples of
``torch.Tensor``\\ s, numpy arrays or Python numbers.  Tensors are copied
to the host before ``save_checkpoint`` returns (``blocking=False``
included), so the caller may update them in place at once; numpy leaves
are taken as they are, as the JAX package takes them.

Sharded saves write the JAX package's formats 3 (``shard_axis``: one
``shard_<r>.npz`` per rank) and 4 (``shard_axes``: one
``shard_<c0>_..._<ck>.npz`` per mesh coordinate), with per-shard CRC32
digests and the ``topology`` record; ``shardings`` (a structure-prefix
tree of :class:`~apex_tpu_torch.multi_tensor.flat.PartitionSpec`) names
the leaves that are stacks of per-rank partitions.  Two ways to hold
such a stack:

- **one process holds it whole** (``group`` None or of one rank: the
  one-card and CPU paths): a sharded leaf is the whole stack, its
  leading dims the mesh axes' sizes, exactly as JAX holds it;
- **each rank holds its block** (``group`` of several ranks, rank ``r``
  at mesh coordinate ``unravel(r, shard_axes sizes)``, the
  ``parallel_state`` layout): a sharded leaf has a leading dim of 1 for
  each axis its spec names.  Each rank writes only its own shard files
  (a rank whose coordinate on an axis the leaf is not sharded over is
  not 0 holds a replica and writes nothing of it); after a gather of
  the digests rank 0 writes the replicated leaves and the manifest and
  commits.  The commit is one rename, as on one process.  Such a save
  is blocking: its commit is a collective.

Restore reads every format the JAX package writes.  A sharded leaf comes
back as its stored stack, or re-partitioned to the target's shape (JAX's
``_reshard_stack``: the C-order flatten re-split, growth zero-filled,
only all-zero tail padding dropped).  Across ranks (``group``,
``shard_axes`` and the target's ``shardings``) each rank gets its own
block of that re-partition, reading only the shard files the block
overlaps (and those holding a dropped tail).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import re
import shutil
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from apex_tpu_torch.multi_tensor.flat import (expand_specs,
                                              is_replicated_stack,
                                              reshard_stack, spec_lead_axes)
from apex_tpu_torch.utils.tree import (keystr, path_parts,
                                       tree_flatten_with_path,
                                       tree_unflatten)

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_PACK = "arrays.pack"
_LATEST = "latest"
_PACK_ALIGN = 64


def shard_file(rank: int) -> str:
    """On-disk name of one shard's array file in a format-3 (single-axis)
    sharded checkpoint."""
    return f"shard_{int(rank):05d}.npz"


def shard_file_coords(coords) -> str:
    """On-disk name of one mesh coordinate's array file in a format-4
    (multi-axis) sharded checkpoint: ``shard_<c0>_<c1>_..._<ck>.npz``
    with one coordinate per mesh axis, in the manifest ``topology``'s
    ``mesh_axes`` order."""
    return "shard_" + "_".join(str(int(c)) for c in coords) + ".npz"


def _coord_key(coords) -> str:
    """Manifest key of one shard coordinate (per-leaf ``crc32_shards``
    dict): the leaf's own lead-axis coordinates joined with ``_``."""
    return "_".join(str(int(c)) for c in coords)


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint on disk failed integrity verification (missing files,
    unreadable archive, truncated arrays, or CRC32 digest mismatch)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential-backoff retry for storage I/O during save.

    Transient storage faults should not kill a training run mid-save;
    each save attempt rewrites its tmp dir from scratch, so retrying is
    idempotent."""

    max_attempts: int = 3
    base_delay: float = 0.05  # seconds; doubles per attempt
    max_delay: float = 2.0
    retryable: tuple = (OSError,)

    def delay(self, attempt: int) -> float:
        return min(self.base_delay * (2.0 ** attempt), self.max_delay)


# Test-only fault-injection point (see apex_tpu_torch.resilience.chaos).
# When set, called as hook(event, path) at each storage operation; it may
# raise to simulate a write failure or sleep to simulate slow storage.
# Events: "write_arrays", "write_shard" (once per shard file of a sharded
# save), "write_manifest", "commit", "read_arrays".
_fault_hook: Optional[Callable[[str, str], None]] = None


def set_fault_hook(hook: Optional[Callable[[str, str], None]]):
    """Install (or clear, with None) the storage fault hook. Returns the
    previous hook so tests can restore it."""
    global _fault_hook
    prev, _fault_hook = _fault_hook, hook
    return prev


def _fault(event: str, path: str) -> None:
    if _fault_hook is not None:
        _fault_hook(event, path)


# dtypes stored as fp32 on disk for precision portability
_HALF_DTYPES = ("bfloat16", "float16")


def _host_value(leaf) -> np.ndarray:
    """A leaf as a host numpy array: a tensor copied off its device (a
    snapshot: later in-place updates of the tensor do not reach it), a
    half tensor as fp32 or raw bits by the caller; numpy arrays and
    numbers as they are."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in (torch.bfloat16, torch.float16):
            return t          # the caller picks fp32 or the raw bits
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(val) -> str:
    if isinstance(val, torch.Tensor):
        return str(val.dtype).rsplit(".", 1)[1]
    return str(val.dtype)


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step):010d}")


def _complete_steps(ckpt_dir: str) -> list:
    """Steps with a complete (renamed, manifest-bearing) directory. Tolerant
    of crash artifacts: ``step_N.tmp`` leftovers and junk names are skipped."""
    steps = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            digits = name[len("step_"):]
            # only the exact zero-padded ASCII-decimal form save_checkpoint
            # writes counts as a checkpoint
            if not (digits.isascii() and digits.isdecimal()):
                continue
            if os.path.isfile(os.path.join(ckpt_dir, name, _MANIFEST)):
                steps.append(int(digits))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest complete checkpoint step in ``ckpt_dir``, or None."""
    marker = os.path.join(ckpt_dir, _LATEST)
    if os.path.exists(marker):
        try:
            with open(marker) as f:
                s = int(f.read().strip())
        except ValueError:
            s = None  # truncated marker from a crashed save — fall through
        if s is not None and os.path.exists(
            os.path.join(step_dir(ckpt_dir, s), _MANIFEST)
        ):
            return s
    steps = _complete_steps(ckpt_dir)
    return max(steps) if steps else None


def _spec_to_json(spec) -> Optional[list]:
    """A spec as the JAX manifest records it (a list; tuple entries as
    lists)."""
    if spec is None:
        return None
    return [list(p) if isinstance(p, (tuple, list)) else p for p in spec]


def _spec_leads_with(spec, axis: str) -> bool:
    """True when ``spec``'s first entry names ``axis`` (directly or inside
    a tuple): the leaf is a stack of per-rank partitions along dim 0."""
    if spec is None or len(spec) == 0:
        return False
    head = spec[0]
    if isinstance(head, (tuple, list)):
        return axis in head
    return head == axis


def _group_info(group):
    """(rank, size) of ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    import torch.distributed as dist
    return dist.get_rank(group), dist.get_world_size(group)


def _rank_coords(rank: int, axes: dict) -> tuple:
    """Mesh coordinate of group rank ``rank`` over ``axes`` (C order, the
    ``parallel_state`` layout ``reshape(dp, pp, tp)``)."""
    return tuple(int(c) for c in np.unravel_index(rank, tuple(axes.values())))


def save_checkpoint(
    ckpt_dir: str,
    tree: Any,
    *,
    step: int,
    shardings: Any = None,
    keep: Optional[int] = None,
    fp32_portable: bool = True,
    packed: bool = False,
    blocking: bool = True,
    retry: Optional[RetryPolicy] = None,
    shard_axis: Optional[str] = None,
    shard_axes: Optional[Any] = None,
    data_state: Optional[dict] = None,
    group: Any = None,
) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``ckpt_dir``.

    ``shardings`` — optional structure-prefix tree of ``PartitionSpec``
    (or None), recorded per leaf in the manifest.  ``keep`` — if set,
    delete all but the newest ``keep`` steps.  ``packed`` — store leaves
    in one flat superblock file gathered by the native threaded pack
    (:mod:`apex_tpu_torch._native`) instead of npz zip framing; restore
    detects either format.

    ``blocking=False`` — return as soon as the tree is copied to host
    memory; CRCs and the disk write run on the background writer thread
    (:mod:`apex_tpu_torch.resilience.async_checkpoint`), so the train loop
    keeps stepping, and may update its tensors in place, during the
    write.  Any save — async or blocking — first fences on a still
    in-flight async write, as does interpreter exit; a failed background
    write (after retries) re-raises at that fence.  ``retry`` —
    :class:`RetryPolicy` for transient storage errors.

    ``shard_axis`` — the mesh axis ZeRO state is sharded over (format 3):
    leaves whose spec leads with it are stacks of per-rank partitions
    along dim 0, each rank's to its own ``shard_<r>.npz`` with its own
    CRC32 (``crc32_shards``) and a ``topology`` record in the manifest.
    ``shard_axes`` — an ordered {mesh axis: size} mapping (format 4):
    leaves whose spec leads with one or more of those axes are stacks of
    per-coordinate partitions, each coordinate's to
    ``shard_<c0>_..._<ck>.npz``.  Both need ``shardings`` and are
    npz-only.  ``group`` — the process group whose ranks each hold their
    block of the sharded leaves (see the module docstring); None or one
    rank: this process holds every stack whole.

    ``data_state`` — optional JSON record of the input pipeline's
    position (the checkpointable-iterator ``state_dict()``), stored in
    the manifest atomically with the arrays and read back by
    :func:`load_data_state`.  Returns the checkpoint directory path.
    """
    # fence: at most one write in flight; a prior async save must land (or
    # surface its error) before this one starts
    from apex_tpu_torch.resilience import async_checkpoint as _async

    _async.wait_for_save()

    if shard_axis is not None and shard_axes is not None:
        raise ValueError("pass shard_axis (format 3) or shard_axes "
                         "(format 4), not both")
    sharded = shard_axis is not None or shard_axes is not None
    if sharded and shardings is None:
        raise ValueError(
            "shard_axis/shard_axes requires shardings: the PartitionSpec "
            "tree is what identifies which leaves are per-rank partitions")
    if sharded and packed:
        raise ValueError("sharded checkpoints are npz-only (packed=False)")
    if shard_axes is not None:
        shard_axes = {str(a): int(n) for a, n in dict(shard_axes).items()}
        if not shard_axes or any(n < 1 for n in shard_axes.values()):
            raise ValueError(f"invalid shard_axes {shard_axes!r}: need at "
                             "least one axis, every size >= 1")
    rank, world = _group_info(group)
    across = world > 1
    if across and not sharded:
        raise ValueError("a save across ranks (group of several) must be "
                         "sharded (shard_axis or shard_axes)")
    if across and shard_axes is not None and \
            int(np.prod(list(shard_axes.values()))) != world:
        raise ValueError(f"shard_axes {shard_axes} do not lay out the "
                         f"group's {world} ranks")
    coords = _rank_coords(rank, shard_axes) if across and shard_axes \
        else None

    if data_state is not None:
        try:
            data_state = json.loads(json.dumps(data_state))
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"data_state must be JSON-serializable (it rides the "
                f"manifest): {e}") from e

    leaves = tree_flatten_with_path(tree)[0]
    specs = (expand_specs(shardings, tree) if shardings is not None
             else [None] * len(leaves))
    # path_parts stringifies key components, so int key 0 and str key '0'
    # (or a dict key and a sequence index) alias: refuse at save time
    seen_paths = {}
    for path, _ in leaves:
        pt = tuple(path_parts(path))
        if pt in seen_paths:
            raise ValueError(
                f"checkpoint path collision: {keystr(path)} and "
                f"{seen_paths[pt]} both map to path tuple {pt} — rename "
                "the colliding keys (e.g. avoid int and str keys that "
                "stringify identically)")
        seen_paths[pt] = keystr(path)

    manifest = {"step": int(step), "format": 1, "leaves": {}}
    arrays = {}
    n_shards: Optional[int] = world if across and shard_axis else None
    shard_arrays: list = ([dict() for _ in range(world)] if n_shards
                          else [])
    # format 4: full mesh coordinate -> {leaf key: partition}
    shard_maps: dict = {}
    # scalar-content stacks held across ranks: their values, to decide
    # replicated_shards once every rank's is known
    scalars: dict = {}
    any_multi = False
    for (path, leaf), spec in zip(leaves, specs):
        key = keystr(path)
        # keystr can collide for keys containing quotes/brackets; the
        # structured "path" is the identity
        if key in manifest["leaves"]:
            i = 2
            while f"{key}#{i}" in manifest["leaves"]:
                i += 1
            key = f"{key}#{i}"
        val = _host_value(leaf)
        entry = {"kind": "array", "dtype": _dtype_name(val),
                 "shape": list(val.shape), "path": path_parts(path)}
        if entry["dtype"] in _HALF_DTYPES:
            if fp32_portable:
                val = (val.float().numpy() if isinstance(val, torch.Tensor)
                       else val.astype(np.float32))
                entry["stored_dtype"] = "float32"
            else:
                # npz cannot hold bf16: store the raw bits
                val = (val.view(torch.int16).numpy().view(np.uint16)
                       if isinstance(val, torch.Tensor)
                       else val.view(np.uint16))
                entry["stored_dtype"] = "uint16_bits"
        if spec is not None:
            entry["spec"] = _spec_to_json(spec)
        manifest["leaves"][key] = entry
        if shard_axes is not None:
            lead = spec_lead_axes(spec, shard_axes)
            if not lead:
                arrays[key] = val
                continue
            if val.ndim < len(lead):
                raise ValueError(
                    f"leaf {key} has spec leading with {len(lead)} "
                    f"mesh axes {lead} but only {val.ndim} dims to "
                    "partition")
            held = [1 if across else shard_axes[a] for a in lead]
            for i, ax in enumerate(lead):
                if val.shape[i] != held[i]:
                    raise ValueError(
                        f"leaf {key} dim {i} has size {val.shape[i]} but "
                        f"its spec shards it over {ax!r} (size "
                        f"{shard_axes[ax]}; "
                        + ("each rank holds its block of 1)" if across
                           else "this process holds the whole stack)"))
            entry["shard_axes"] = lead
            entry["shape"] = [shard_axes[a] for a in lead] + \
                list(val.shape[len(lead):])
            any_multi = True
            if across:
                if val.ndim == len(lead):
                    scalars[key] = val.reshape(()).item()
                mine = tuple(coords[list(shard_axes).index(a)]
                             for a in lead)
                fullc = _leaf_full_coord(entry, mine, shard_axes)
                if fullc == tuple(coords):   # not a replica holder
                    shard_maps.setdefault(fullc, {})[key] = \
                        val.reshape(val.shape[len(lead):])
            else:
                entry["replicated_shards"] = is_replicated_stack(
                    val, len(lead))
                for c in itertools.product(
                        *(range(shard_axes[a]) for a in lead)):
                    fullc = _leaf_full_coord(entry, c, shard_axes)
                    shard_maps.setdefault(fullc, {})[key] = val[c]
            continue
        if shard_axis is not None and _spec_leads_with(spec, shard_axis):
            if val.ndim == 0:
                raise ValueError(
                    f"leaf {key} has spec leading with {shard_axis!r} but "
                    "no leading axis to partition")
            if across:
                if val.shape[0] != 1:
                    raise ValueError(
                        f"leaf {key}: each rank holds its block of 1 along "
                        f"{shard_axis!r}, got a leading axis of "
                        f"{val.shape[0]}")
                entry["shape"][0] = world
                if val.ndim == 1:
                    scalars[key] = val.reshape(()).item()
                shard_arrays[rank][key] = val[0]
            else:
                if n_shards is None:
                    n_shards = int(val.shape[0])
                    shard_arrays = [dict() for _ in range(n_shards)]
                elif val.shape[0] != n_shards:
                    raise ValueError(
                        f"inconsistent shard counts in one save: leaf {key} "
                        f"has leading axis {val.shape[0]}, earlier sharded "
                        f"leaves have {n_shards}")
                # a per-rank REPLICATED stack re-broadcasts on reshard:
                # only 1-D [n_shards] stacks of equal scalars (the
                # broadcast step counter)
                entry["replicated_shards"] = bool(
                    val.ndim == 1 and all(np.array_equal(val[r], val[0])
                                          for r in range(1, n_shards)))
                for r in range(n_shards):
                    shard_arrays[r][key] = val[r]
            entry["shard_axis"] = shard_axis
            continue
        arrays[key] = val
    if n_shards is not None and any(
            "shard_axis" in e for e in manifest["leaves"].values()):
        manifest["format"] = 3
        manifest["topology"] = {"shard_axis": shard_axis,
                                "n_shards": n_shards}
    elif any_multi:
        manifest["format"] = 4
        manifest["topology"] = {"mesh_axes": dict(shard_axes)}
    else:
        shard_arrays = []
    if data_state is not None:
        manifest["data_state"] = data_state

    if across:
        if shard_axes is None:
            shard_arrays = [shard_arrays[rank] if shard_arrays else {}]
        _write_across_ranks(ckpt_dir, step, manifest, arrays, keep=keep,
                            retry=retry, group=group, rank=rank,
                            world=world, shard_arrays=shard_arrays,
                            shard_maps=shard_maps, shard_axes=shard_axes,
                            scalars=scalars)
        return step_dir(ckpt_dir, step)
    # everything below is host/disk work on the snapshot — safe to run on
    # the background writer thread
    write = functools.partial(
        _write_checkpoint_files, ckpt_dir, step, manifest, arrays,
        packed=packed, keep=keep, retry=retry, shard_arrays=shard_arrays,
        shard_maps=shard_maps, shard_axes=shard_axes)
    if blocking:
        write()
    else:
        _async.submit_save(write, label=f"{ckpt_dir}:step_{int(step)}")
    return step_dir(ckpt_dir, step)


def _leaf_full_coord(entry: dict, coords, shard_axes: dict) -> tuple:
    """Full mesh coordinate of one leaf shard: the leaf's own lead-axis
    ``coords`` placed at their axes' positions in ``shard_axes`` order,
    zeros elsewhere (the format-4 file-location rule)."""
    lead = entry["shard_axes"]
    return tuple(coords[lead.index(a)] if a in lead else 0
                 for a in shard_axes)


def _shard_crcs(shard_arrays, shard_maps) -> dict:
    """{leaf key: {shard id: crc32}} of the partitions in hand: format-3
    ids are the rank index into ``shard_arrays``, format-4 ids the full
    mesh coordinate."""
    out: dict = {}
    for r, sh in enumerate(shard_arrays):
        for k, a in sh.items():
            out.setdefault(k, {})[r] = _crc32(a)
    for fullc, sh in shard_maps.items():
        for k, a in sh.items():
            out.setdefault(k, {})[fullc] = _crc32(a)
    return out


def _fill_crcs(manifest: dict, arrays: dict, crcs: dict,
               shard_axes: Optional[dict]) -> None:
    """The manifest's digests: ``crc32`` of each stored array,
    ``crc32_shards`` (a list by rank, or a dict by the leaf's own lead
    coordinates) of each sharded leaf."""
    for k, entry in manifest["leaves"].items():
        if k in arrays:
            entry["crc32"] = _crc32(arrays[k])
        elif "shard_axes" in entry:
            lead = entry["shard_axes"]
            entry["crc32_shards"] = {
                _coord_key(c): crcs[k][_leaf_full_coord(entry, c,
                                                        shard_axes)]
                for c in itertools.product(
                    *(range(shard_axes[a]) for a in lead))}
        elif "shard_axis" in entry:
            entry["crc32_shards"] = [crcs[k][r]
                                     for r in range(entry["shape"][0])]


def _write_across_ranks(ckpt_dir, step, manifest, arrays, *, keep, retry,
                        group, rank, world, shard_arrays, shard_maps,
                        shard_axes, scalars) -> None:
    """A sharded save whose ranks each hold their block: rank 0 makes the
    tmp dir; every rank writes its own shard files; their digests (and
    the values of scalar stacks) are gathered to rank 0, which writes the
    replicated leaves and the manifest and commits.  Every attempt is
    collective, and its outcome is broadcast, so all ranks retry or raise
    together."""
    import torch.distributed as dist

    final = step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    retry = retry or RetryPolicy(max_attempts=1)

    def attempt_status(fn):
        try:
            fn()
            return None
        except Exception as e:   # reported to every rank below
            return (isinstance(e, retry.retryable), f"{type(e).__name__}: "
                    f"{e}", e)

    def decide(status) -> Optional[tuple]:
        box = [None if status is None else status[:2]]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                   group=group)
        return box[0]

    def prepare():
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    for attempt in range(retry.max_attempts):
        mine = attempt_status(prepare) if rank == 0 else None
        shared = decide(mine)
        if shared is None:
            def write_mine():
                if shard_axes is None:
                    p = os.path.join(tmp, shard_file(rank))
                    _fault("write_shard", p)
                    np.savez(p, **shard_arrays[0])
                for fullc in sorted(shard_maps):
                    p = os.path.join(tmp, shard_file_coords(fullc))
                    _fault("write_shard", p)
                    np.savez(p, **shard_maps[fullc])
            mine = attempt_status(write_mine)
            crcs = ({k: {rank: _crc32(a)} for k, a in shard_arrays[0].items()}
                    if shard_axes is None else _shard_crcs([], shard_maps))
            gathered = [None] * world if rank == 0 else None
            dist.gather_object((None if mine is None else mine[:2], crcs,
                                scalars), gathered,
                               dst=dist.get_global_rank(group, 0),
                               group=group)
            if rank == 0:
                errs = [g[0] for g in gathered if g[0] is not None]
                mine = (all(e[0] for e in errs), "; ".join(
                    e[1] for e in errs), None) if errs else None
                if mine is None:
                    def commit():
                        all_crcs: dict = {}
                        vals: dict = {}
                        for r, (_, c, sc) in enumerate(gathered):
                            for k, d in c.items():
                                all_crcs.setdefault(k, {}).update(d)
                            for k, v in sc.items():
                                vals.setdefault(k, []).append(v)
                        for k, entry in manifest["leaves"].items():
                            if "shard_axes" in entry or \
                                    "shard_axis" in entry:
                                v = vals.get(k)
                                entry["replicated_shards"] = bool(
                                    v is not None
                                    and all(x == v[0] for x in v))
                        _fill_crcs(manifest, arrays, all_crcs, shard_axes)
                        _fault("write_arrays", os.path.join(tmp, _ARRAYS))
                        np.savez(os.path.join(tmp, _ARRAYS), **arrays)
                        _commit(ckpt_dir, step, manifest, tmp, final, keep)
                    mine = attempt_status(commit)
            shared = decide(mine)
        if shared is None:
            return
        retryable, msg = shared
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        if not retryable or attempt + 1 >= retry.max_attempts:
            own = mine[2] if mine is not None and len(mine) > 2 else None
            if own is not None:
                raise own
            raise (OSError if retryable else RuntimeError)(
                f"sharded save of step {step} failed on a rank: {msg}")
        time.sleep(retry.delay(attempt))


def _commit(ckpt_dir, step, manifest, tmp, final, keep) -> None:
    """Manifest -> atomic rename -> latest marker -> keep-GC."""
    _fault("write_manifest", os.path.join(tmp, _MANIFEST))
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    _fault("commit", final)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, _LATEST), "w") as f:
        f.write(str(int(step)))
    _prune(ckpt_dir, step, keep)


def _prune(ckpt_dir, step, keep) -> None:
    if keep is not None:
        # prune by write recency, never the checkpoint just written — a
        # rollback-resume that saves a lower step than what is on disk
        # must not delete its own output
        others = [s for s in _complete_steps(ckpt_dir) if s != int(step)]
        others.sort(key=lambda s: os.path.getmtime(step_dir(ckpt_dir, s)))
        for s in others[: max(0, len(others) - (keep - 1))]:
            shutil.rmtree(step_dir(ckpt_dir, s), ignore_errors=True)


def _crc32(a: np.ndarray) -> int:
    """CRC32 of an array's C-order bytes (no copy when contiguous)."""
    a = np.ascontiguousarray(a)
    return zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF


def _write_checkpoint_files(ckpt_dir: str, step: int, manifest: dict,
                            arrays: dict, *, packed: bool,
                            keep: Optional[int],
                            retry: Optional[RetryPolicy],
                            shard_arrays: Optional[list] = None,
                            shard_maps: Optional[dict] = None,
                            shard_axes: Optional[dict] = None) -> str:
    """Disk phase of a save: CRCs -> tmp dir -> arrays + manifest ->
    atomic rename -> latest marker -> keep-GC.  Retries the whole tmp-dir
    write on transient storage errors."""
    # CRC32 of the bytes as STORED (what restore re-hashes off disk),
    # hashed here — on the writer thread for async saves
    _fill_crcs(manifest, arrays, _shard_crcs(shard_arrays or [],
                                             shard_maps or {}), shard_axes)
    retry = retry or RetryPolicy(max_attempts=1)
    final = step_dir(ckpt_dir, step)
    for attempt in range(retry.max_attempts):
        try:
            _write_step_dir_once(ckpt_dir, step, manifest, arrays,
                                 packed=packed, keep=keep,
                                 shard_arrays=shard_arrays,
                                 shard_maps=shard_maps)
            break
        except retry.retryable:
            shutil.rmtree(final + ".tmp", ignore_errors=True)
            if attempt + 1 >= retry.max_attempts:
                raise
            time.sleep(retry.delay(attempt))
    return final


def _write_step_dir_once(ckpt_dir: str, step: int, manifest: dict,
                         arrays: dict, *, packed: bool, keep,
                         shard_arrays: Optional[list] = None,
                         shard_maps: Optional[dict] = None) -> None:
    """One attempt at writing + committing ``step_<N>/``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # shard files first, each its own fault event, so a save can be killed
    # mid shard set (nothing is visible until the rename)
    for r, sh in enumerate(shard_arrays or []):
        p = os.path.join(tmp, shard_file(r))
        _fault("write_shard", p)
        np.savez(p, **sh)
    for coords in sorted(shard_maps or {}):
        p = os.path.join(tmp, shard_file_coords(coords))
        _fault("write_shard", p)
        np.savez(p, **shard_maps[coords])
    if packed:
        from apex_tpu_torch import _native

        manifest["format"] = 2
        contig, offsets, off = [], [], 0
        for k, a in arrays.items():
            a = np.ascontiguousarray(a)
            contig.append(a)
            manifest["leaves"][k]["offset"] = off
            offsets.append(off)
            off += -(-a.nbytes // _PACK_ALIGN) * _PACK_ALIGN
        buf = _native.pack_host(contig, offsets, off)
        _fault("write_arrays", os.path.join(tmp, _PACK))
        buf.tofile(os.path.join(tmp, _PACK))
    else:
        _fault("write_arrays", os.path.join(tmp, _ARRAYS))
        np.savez(os.path.join(tmp, _ARRAYS), **arrays)
    _commit(ckpt_dir, step, manifest, tmp, final, keep)


def _stored_dtype(entry: dict) -> np.dtype:
    """On-disk numpy dtype of a manifest leaf (the chaos harness reuses
    it to locate leaf bytes)."""
    sd = entry.get("stored_dtype")
    return np.dtype(sd if sd == "float32"
                    else "uint16" if sd == "uint16_bits"
                    else entry["dtype"])


def _load_manifest_and_data(d: str, *, verify: bool):
    """Read manifest + raw stored arrays from checkpoint dir ``d``.

    ``verify=True`` treats every read/parse failure as corruption (raising
    :class:`CheckpointCorruptionError`) and checks each array's stored
    bytes against the manifest's CRC32 digest.  ``verify=False`` keeps
    the raw exceptions."""
    try:
        _fault("read_arrays", d)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        if verify:
            raise CheckpointCorruptionError(
                f"unreadable manifest in {d}: {e}") from e
        raise
    pack_path = os.path.join(d, _PACK)
    shard_data: list = []
    coord_maps: dict = {}
    mesh_axes = dict(manifest.get("topology", {}).get("mesh_axes") or {})
    reading = [pack_path]   # the file in hand, named by a failure

    def load(name):
        reading[0] = os.path.join(d, name)
        with np.load(reading[0]) as npz:
            return {k: npz[k] for k in npz.files}

    try:
        if os.path.exists(pack_path):  # format 2: flat superblock
            buf = np.fromfile(pack_path, np.uint8)
            data = {}
            for k, e in manifest["leaves"].items():
                cnt = int(np.prod(e["shape"])) if e["shape"] else 1
                data[k] = np.frombuffer(buf, _stored_dtype(e), cnt,
                                        e["offset"]).reshape(e["shape"])
        else:
            data = {}
            if os.path.exists(os.path.join(d, _ARRAYS)):
                data = load(_ARRAYS)
            for r in range(manifest.get("topology", {}).get("n_shards", 0)):
                shard_data.append(load(shard_file(r)))
            if mesh_axes:  # format 4: per-mesh-coordinate files
                needed = set()
                for e in manifest["leaves"].values():
                    if "shard_axes" not in e:
                        continue
                    for c in itertools.product(
                            *(range(mesh_axes[a]) for a in e["shard_axes"])):
                        needed.add(_leaf_full_coord(e, c, mesh_axes))
                for fullc in sorted(needed):
                    coord_maps[fullc] = load(shard_file_coords(fullc))
    except Exception as e:
        # truncated pack, truncated/garbled npz, missing shard file: with
        # verify, all of these are one condition, a corrupt checkpoint
        if verify:
            raise CheckpointCorruptionError(
                f"unreadable arrays in {d}: {os.path.basename(reading[0])}: "
                f"{type(e).__name__}: {e}") from e
        raise
    problems = []
    for k, e in manifest["leaves"].items():
        if "shard_axis" not in e:
            continue
        # format 3: reassemble the logical [n_shards, ...] stack
        parts = []
        for r, sh in enumerate(shard_data):
            if k not in sh:
                problems.append(f"missing {k!r} in shard {r}")
                continue
            if verify and "crc32_shards" in e:
                got, want = _crc32(sh[k]), e["crc32_shards"][r]
                if got != want:
                    problems.append(
                        f"CRC32 mismatch for {k!r} shard {r}: stored "
                        f"digest {want}, bytes on disk hash to {got}")
            parts.append(sh[k])
        if len(parts) == len(shard_data):
            data[k] = np.stack(parts)
    for k, e in manifest["leaves"].items():
        if "shard_axes" not in e:
            continue
        # format 4: reassemble [n_a, n_b, ..., *content] (coordinates
        # iterate in C order over the leaf's lead axes)
        try:
            lead_shape = tuple(mesh_axes[a] for a in e["shard_axes"])
        except KeyError as exc:
            if verify:
                raise CheckpointCorruptionError(
                    f"checkpoint at {d}: leaf {k!r} is sharded over axis "
                    f"{exc} missing from topology mesh_axes "
                    f"{sorted(mesh_axes)}") from exc
            raise
        parts = []
        for c in itertools.product(*(range(n) for n in lead_shape)):
            sh = coord_maps.get(_leaf_full_coord(e, c, mesh_axes), {})
            if k not in sh:
                problems.append(f"missing {k!r} at mesh coordinate {c}")
                continue
            if verify and "crc32_shards" in e:
                got = _crc32(sh[k])
                want = e["crc32_shards"].get(_coord_key(c))
                if got != want:
                    problems.append(
                        f"CRC32 mismatch for {k!r} at mesh coordinate "
                        f"{c}: stored digest {want}, bytes on disk hash "
                        f"to {got}")
            parts.append(sh[k])
        if len(parts) == int(np.prod(lead_shape)):
            data[k] = np.stack(parts).reshape(
                lead_shape + tuple(parts[0].shape))
    if verify:
        for k, e in manifest["leaves"].items():
            if k not in data:
                if "shard_axis" not in e and "shard_axes" not in e:
                    problems.append(f"missing stored array {k!r}")
                continue
            want = e.get("crc32")
            if want is None:
                continue  # sharded leaf: checked above
            got = _crc32(data[k])
            if got != want:
                problems.append(
                    f"CRC32 mismatch for {k!r}: stored digest {want}, "
                    f"bytes on disk hash to {got}")
        if problems:
            raise CheckpointCorruptionError(
                f"checkpoint at {d} failed integrity verification: "
                + "; ".join(problems))
    elif problems:
        raise KeyError(
            f"sharded checkpoint at {d} is incomplete: " + "; ".join(problems))
    return manifest, data


def verify_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> int:
    """Check integrity of checkpoint ``step`` (default: latest) under
    ``ckpt_dir``: files readable, every manifest leaf present, CRC32
    digests match the bytes on disk.  Returns the verified step, or raises
    :class:`CheckpointCorruptionError` / :class:`FileNotFoundError`."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {ckpt_dir}")
    _load_manifest_and_data(step_dir(ckpt_dir, step), verify=True)
    return step


def load_data_state(ckpt_dir: str,
                    step: Optional[int] = None) -> Optional[dict]:
    """The ``data_state`` record saved with checkpoint ``step`` (default:
    latest), or None when that checkpoint was saved without one.  Model
    state and iterator position come from one atomic manifest, so they
    cannot disagree about the position."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {ckpt_dir}")
    with open(os.path.join(step_dir(ckpt_dir, step), _MANIFEST)) as f:
        return json.load(f).get("data_state")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def restore_checkpoint(
    ckpt_dir: str,
    target: Any = None,
    *,
    step: Optional[int] = None,
    device=None,
    verify: bool = False,
    shardings: Any = None,
    shard_axes: Any = None,
    group: Any = None,
):
    """Restore a checkpoint into (optionally) ``target``'s structure.

    - ``target`` given: every leaf path of ``target`` must exist in the
      checkpoint; the result has ``target``'s structure (namedtuples
      included).  A tensor leaf of the target gives a tensor of its dtype
      on its device (``"meta"`` tensors describe a leaf without holding
      it: the CPU); a numpy leaf gives a numpy array of its dtype; any
      other leaf a tensor of the saved dtype.
    - ``target=None``: a nested dict keyed by path components (dict keys,
      field names, sequence indices as strings) of tensors of the saved
      dtype.
    - ``device`` — where every tensor goes (default: as above, else the
      CPU).
    - ``verify=True``: re-hash every stored array against the manifest's
      CRC32 digests first, and surface any read failure as
      :class:`CheckpointCorruptionError` (see
      :func:`apex_tpu_torch.resilience.restore_resilient` for the fallback
      to an older intact checkpoint).

    Sharded leaves (formats 3 and 4) restore as their stored stack, or
    re-partitioned to the target leaf's shape when it differs (one
    process: the whole stack).  Across ranks (``group`` of several,
    ``shard_axes`` the target's {axis: size} and ``shardings`` its
    structure-prefix spec tree): a target leaf whose spec leads with
    axes of ``shard_axes`` is this rank's block (a leading dim of 1 per
    such axis), filled with its slice of the re-partitioned stack, and
    only the files that slice overlaps are read (and verified).
    Returns ``(tree, step)``.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {ckpt_dir}")
    d = step_dir(ckpt_dir, step)
    rank, world = _group_info(group)
    if world > 1:
        if target is None or shardings is None or shard_axes is None:
            raise ValueError("a restore across ranks needs the target, its "
                             "shardings and shard_axes")
        return _restore_blocks(d, target, shardings, dict(shard_axes),
                               rank, device, verify), step
    manifest, data = _load_manifest_and_data(d, verify=verify)

    def _materialize(key: str, entry: dict, tleaf=None):
        val = data[key]
        want_shape = getattr(tleaf, "shape", None)
        if (want_shape is not None
                and ("shard_axis" in entry or "shard_axes" in entry)
                and tuple(val.shape) != tuple(want_shape)):
            n_lead = (len(entry["shard_axes"]) if "shard_axes" in entry
                      else 1)
            val = reshard_stack(
                val, n_lead, tuple(want_shape),
                replicated=bool(entry.get("replicated_shards")),
                label=f"sharded leaf {key!r}")
        return _to_target(val, entry, tleaf, device)

    if target is None:
        nested: dict = {}
        for key, entry in manifest["leaves"].items():
            parts = entry.get("path") or _parse_keystr(key)
            node = nested
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _materialize(key, entry)
        return nested, step

    paths, treedef = tree_flatten_with_path(target)
    # primary lookup by structured path (collision-free); keystr is the
    # fallback for manifests written before the "path" field existed
    by_path = {tuple(e["path"]): k for k, e in manifest["leaves"].items()
               if "path" in e}
    keys = [by_path.get(tuple(path_parts(p)), keystr(p)) for p, _ in paths]
    missing = [k for k in keys if k not in manifest["leaves"]]
    if missing:
        present = sorted(manifest["leaves"])
        shown = ", ".join(repr(k) for k in present[:8])
        if len(present) > 8:
            shown += f", ... ({len(present)} total)"
        raise KeyError(
            f"checkpoint at {d} is missing {len(missing)} leaves required "
            f"by the restore target: {missing} — the checkpoint holds "
            f"[{shown}]. The target's structure does not match what was "
            "saved (wrong checkpoint dir, or the model/optimizer definition "
            "changed since the save).")
    leaves = [_materialize(k, manifest["leaves"][k], tleaf)
              for k, (_, tleaf) in zip(keys, paths)]
    return tree_unflatten(treedef, leaves), step


def _to_target(val: np.ndarray, entry: dict, tleaf, device):
    """A stored array as the target leaf wants it: a tensor of its dtype
    on its device (or ``device``), a numpy array of its dtype, or a
    tensor of the saved dtype."""
    val = np.ascontiguousarray(val)
    if not val.flags.writeable:     # a view of the packed superblock
        val = val.copy()
    if entry.get("stored_dtype") == "uint16_bits":
        t = torch.from_numpy(val.view(np.int16)).view(
            _torch_dtype(entry["dtype"]))
    else:
        t = torch.from_numpy(val)
    if isinstance(tleaf, np.ndarray):
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy().astype(tleaf.dtype, copy=False)
    if isinstance(tleaf, torch.Tensor):
        dev = device if device is not None else (
            "cpu" if tleaf.device.type == "meta" else tleaf.device)
        return t.to(device=dev, dtype=tleaf.dtype)
    t = t.to(_torch_dtype(entry["dtype"]))
    return t if device is None else t.to(device)


class _LazyShards:
    """The members of a checkpoint's files, each read (and, with
    ``verify``, checked against its digest) on first use."""

    def __init__(self, d: str, verify: bool):
        self.d, self.verify = d, verify
        self.files: dict = {}

    def close(self) -> None:
        for f in self.files.values():
            f.close()

    def read(self, name: str, key: str, crc: Optional[int]) -> np.ndarray:
        try:
            if name not in self.files:
                self.files[name] = np.load(os.path.join(self.d, name))
            a = self.files[name][key]
        except Exception as e:
            if self.verify:
                raise CheckpointCorruptionError(
                    f"unreadable {key!r} in {os.path.join(self.d, name)}: "
                    f"{type(e).__name__}: {e}") from e
            raise
        if self.verify and crc is not None and _crc32(a) != crc:
            raise CheckpointCorruptionError(
                f"checkpoint at {self.d} failed integrity verification: "
                f"CRC32 mismatch for {key!r} in {name}: stored digest "
                f"{crc}, bytes on disk hash to {_crc32(a)}")
        return a


def _stored_block(files: _LazyShards, manifest: dict, key: str, entry: dict,
                  i: int) -> np.ndarray:
    """Partition ``i`` (C-order over the leaf's lead axes) of a sharded
    leaf, as stored."""
    if "shard_axis" in entry:
        crcs = entry.get("crc32_shards")
        return files.read(shard_file(i), key, crcs[i] if crcs else None)
    mesh_axes = manifest["topology"]["mesh_axes"]
    lead_shape = tuple(mesh_axes[a] for a in entry["shard_axes"])
    c = tuple(int(x) for x in np.unravel_index(i, lead_shape))
    crcs = entry.get("crc32_shards")
    return files.read(
        shard_file_coords(_leaf_full_coord(entry, c, mesh_axes)), key,
        crcs.get(_coord_key(c)) if crcs else None)


def _stored_range(files: _LazyShards, manifest: dict, key: str, entry: dict,
                  lo: int, hi: int, new_size: int) -> np.ndarray:
    """Elements ``[lo, hi)`` of a sharded leaf's C-order flatten resized to
    ``new_size`` (the :func:`repartition_flat` contract: growth reads
    zeros, a shrink must drop only zeros — checked on every rank)."""
    n_lead = len(entry["shard_axes"]) if "shard_axes" in entry else 1
    shape = entry["shape"]
    per = int(np.prod(shape[n_lead:], dtype=np.int64))
    old = int(np.prod(shape, dtype=np.int64))
    dtype = _stored_dtype(entry)

    def block(i):
        return np.ascontiguousarray(
            _stored_block(files, manifest, key, entry, i)).reshape(-1)

    if new_size < old:
        for i in range(new_size // per, (old - 1) // per + 1):
            b = block(i)
            if np.any(b[max(0, new_size - i * per):] != 0):
                raise ValueError(
                    f"cannot repartition sharded leaf {key!r} from {old} to "
                    f"{new_size} elements: the {old - new_size} dropped "
                    "trailing elements are not all zero — that region "
                    "holds real state, not flat-schema padding (schema "
                    "mismatch?)")
    parts = []
    end = min(hi, old)
    if lo < end:
        for i in range(lo // per, (end - 1) // per + 1):
            b = block(i)
            parts.append(b[max(lo, i * per) - i * per:
                           min(end, (i + 1) * per) - i * per])
    if hi > max(lo, old):
        parts.append(np.zeros(hi - max(lo, old), dtype))
    return np.concatenate(parts) if parts else np.zeros(0, dtype)


def _restore_blocks(d: str, target, shardings, shard_axes: dict, rank: int,
                    device, verify: bool):
    """:func:`restore_checkpoint` across ranks: this rank's blocks."""
    try:
        _fault("read_arrays", d)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        if verify:
            raise CheckpointCorruptionError(
                f"unreadable manifest in {d}: {e}") from e
        raise
    if os.path.exists(os.path.join(d, _PACK)):
        raise ValueError("a restore across ranks reads npz checkpoints "
                         "(the packed format is not sharded)")
    coords = _rank_coords(rank, shard_axes)
    paths, treedef = tree_flatten_with_path(target)
    specs = expand_specs(shardings, target)
    by_path = {tuple(e["path"]): k for k, e in manifest["leaves"].items()
               if "path" in e}
    keys = [by_path.get(tuple(path_parts(p)), keystr(p)) for p, _ in paths]
    missing = [k for k in keys if k not in manifest["leaves"]]
    if missing:
        raise KeyError(f"checkpoint at {d} is missing {len(missing)} leaves "
                       f"required by the restore target: {missing}")
    files = _LazyShards(d, verify)
    out = []
    try:
        for k, (_, tleaf), spec in zip(keys, paths, specs):
            entry = manifest["leaves"][k]
            lead = spec_lead_axes(spec, shard_axes)
            stacked = "shard_axis" in entry or "shard_axes" in entry
            shape = tuple(tleaf.shape)
            if not lead:
                if stacked:
                    n = int(np.prod(entry["shape"], dtype=np.int64))
                    val = _stored_range(files, manifest, k, entry, 0, n, n)
                    val = reshard_stack(
                        val.reshape(entry["shape"]),
                        len(entry.get("shard_axes", [0])), shape,
                        replicated=bool(entry.get("replicated_shards")),
                        label=f"sharded leaf {k!r}")
                else:
                    val = files.read(_ARRAYS, k, entry.get("crc32"))
                out.append(_to_target(val, entry, tleaf, device))
                continue
            if any(shape[i] != 1 for i in range(len(lead))):
                raise ValueError(f"target leaf {k!r}: a rank's block has a "
                                 f"leading dim of 1 per axis of {lead}, got "
                                 f"{shape}")
            sizes = [shard_axes[a] for a in lead]
            mine = [coords[list(shard_axes).index(a)] for a in lead]
            per = int(np.prod(shape[len(lead):], dtype=np.int64))
            lin = int(np.ravel_multi_index(mine, sizes)) if sizes else 0
            if stacked and entry.get("replicated_shards"):
                val = _stored_block(files, manifest, k, entry, 0)
                if tuple(np.shape(val)) != shape[len(lead):]:
                    raise ValueError(
                        f"cannot reshard replicated sharded leaf {k!r}: "
                        f"per-rank shape {np.shape(val)} != target "
                        f"per-rank shape {shape[len(lead):]}")
                val = np.asarray(val).reshape(shape)
            elif stacked:
                val = _stored_range(files, manifest, k, entry, lin * per,
                                    (lin + 1) * per,
                                    per * int(np.prod(sizes))).reshape(shape)
            else:
                whole = files.read(_ARRAYS, k, entry.get("crc32"))
                val = reshard_stack(whole, 0, (int(np.prod(sizes)) * per,),
                                    label=f"leaf {k!r}")
                val = val[lin * per:(lin + 1) * per].reshape(shape)
            out.append(_to_target(val, entry, tleaf, device))
    finally:
        files.close()
    return tree_unflatten(treedef, out)


def _parse_keystr(key: str) -> list:
    """Path recovery for manifests without structured "path" entries:
    parse ``['a'][0].b`` keystrs (keys with quotes or brackets need the
    structured form)."""
    token = re.compile(r"\[\'([^\']*)\'\]|\[(\d+)\]|\.([A-Za-z_][A-Za-z_0-9]*)")
    parts = [m.group(1) or m.group(2) or m.group(3)
             for m in token.finditer(key)]
    return parts or [key]
