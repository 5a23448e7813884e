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

Restore reads every format the JAX package writes: 1 and 2, and the
sharded 3 (``shard_<r>.npz``) and 4 (``shard_<c0>_..._<ck>.npz``), whose
stacked leaves are brought whole onto one card: re-partitioned to the
target leaf's shape as the JAX package's ``_reshard_stack`` does at a
new shard count.  Saving a sharded format is not ported (ROADMAP.md):
``shard_axis`` and ``shard_axes`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
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

from apex_tpu_torch.multi_tensor.flat import reshard_stack
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
# Events: "write_arrays", "write_manifest", "commit", "read_arrays".
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


def save_checkpoint(
    ckpt_dir: str,
    tree: Any,
    *,
    step: int,
    keep: Optional[int] = None,
    fp32_portable: bool = True,
    packed: bool = False,
    blocking: bool = True,
    retry: Optional[RetryPolicy] = None,
    shard_axis: Optional[str] = None,
    shard_axes: Optional[Any] = None,
    data_state: Optional[dict] = None,
) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``ckpt_dir``.

    ``keep`` — if set, delete all but the newest ``keep`` steps.
    ``packed`` — store leaves in one flat superblock file gathered by the
    native threaded pack (:mod:`apex_tpu_torch._native`) instead of npz
    zip framing; restore detects either format.

    ``blocking=False`` — return as soon as the tree is copied to host
    memory; CRCs and the disk write run on the background writer thread
    (:mod:`apex_tpu_torch.resilience.async_checkpoint`), so the train loop
    keeps stepping, and may update its tensors in place, during the
    write.  Any save — async or blocking — first fences on a still
    in-flight async write, as does interpreter exit; a failed background
    write (after retries) re-raises at that fence.  ``retry`` —
    :class:`RetryPolicy` for transient storage errors.

    ``data_state`` — optional JSON record of the input pipeline's
    position (the checkpointable-iterator ``state_dict()``), stored in
    the manifest atomically with the arrays and read back by
    :func:`load_data_state`.

    ``shard_axis`` / ``shard_axes`` (sharded formats 3 and 4) are not
    ported and raise ``NotImplementedError``.  Returns the checkpoint
    directory path.
    """
    if shard_axis is not None or shard_axes is not None:
        raise NotImplementedError(
            "sharded checkpoint saves (shard_axis / shard_axes, formats 3 "
            "and 4) are not ported to apex_tpu_torch (ROADMAP.md); "
            "restore reads them")

    # fence: at most one write in flight; a prior async save must land (or
    # surface its error) before this one starts
    from apex_tpu_torch.resilience import async_checkpoint as _async

    _async.wait_for_save()

    if data_state is not None:
        try:
            data_state = json.loads(json.dumps(data_state))
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"data_state must be JSON-serializable (it rides the "
                f"manifest): {e}") from e

    leaves = tree_flatten_with_path(tree)[0]
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
    for path, leaf in leaves:
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
        manifest["leaves"][key] = entry
        arrays[key] = val
    if data_state is not None:
        manifest["data_state"] = data_state

    # everything below is host/disk work on the snapshot — safe to run on
    # the background writer thread
    if blocking:
        _write_checkpoint_files(ckpt_dir, step, manifest, arrays,
                                packed=packed, keep=keep, retry=retry)
    else:
        _async.submit_save(
            lambda: _write_checkpoint_files(ckpt_dir, step, manifest, arrays,
                                            packed=packed, keep=keep,
                                            retry=retry),
            label=f"{ckpt_dir}:step_{int(step)}")
    return step_dir(ckpt_dir, step)


def _crc32(a: np.ndarray) -> int:
    """CRC32 of an array's C-order bytes (no copy when contiguous)."""
    a = np.ascontiguousarray(a)
    return zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF


def _write_checkpoint_files(ckpt_dir: str, step: int, manifest: dict,
                            arrays: dict, *, packed: bool,
                            keep: Optional[int],
                            retry: Optional[RetryPolicy]) -> str:
    """Disk phase of a save: CRCs -> tmp dir -> arrays + manifest ->
    atomic rename -> latest marker -> keep-GC.  Retries the whole tmp-dir
    write on transient storage errors."""
    # CRC32 of the bytes as STORED (what restore re-hashes off disk),
    # hashed here — on the writer thread for async saves
    for k, entry in manifest["leaves"].items():
        entry["crc32"] = _crc32(arrays[k])
    retry = retry or RetryPolicy(max_attempts=1)
    final = step_dir(ckpt_dir, step)
    for attempt in range(retry.max_attempts):
        try:
            _write_step_dir_once(ckpt_dir, step, manifest, arrays,
                                 packed=packed)
            break
        except retry.retryable:
            shutil.rmtree(final + ".tmp", ignore_errors=True)
            if attempt + 1 >= retry.max_attempts:
                raise
            time.sleep(retry.delay(attempt))

    with open(os.path.join(ckpt_dir, _LATEST), "w") as f:
        f.write(str(int(step)))

    if keep is not None:
        # prune by write recency, never the checkpoint just written — a
        # rollback-resume that saves a lower step than what is on disk
        # must not delete its own output
        others = [s for s in _complete_steps(ckpt_dir) if s != int(step)]
        others.sort(key=lambda s: os.path.getmtime(step_dir(ckpt_dir, s)))
        for s in others[: max(0, len(others) - (keep - 1))]:
            shutil.rmtree(step_dir(ckpt_dir, s), ignore_errors=True)
    return final


def _write_step_dir_once(ckpt_dir: str, step: int, manifest: dict,
                         arrays: dict, *, packed: bool) -> None:
    """One attempt at writing + committing ``step_<N>/``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
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
    _fault("write_manifest", os.path.join(tmp, _MANIFEST))
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    _fault("commit", final)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _stored_dtype(entry: dict) -> np.dtype:
    """On-disk numpy dtype of a manifest leaf (the chaos harness reuses
    it to locate leaf bytes)."""
    sd = entry.get("stored_dtype")
    return np.dtype(sd if sd == "float32"
                    else "uint16" if sd == "uint16_bits"
                    else entry["dtype"])


def _leaf_full_coord(entry: dict, coords, shard_axes: dict) -> tuple:
    """Full mesh coordinate of one leaf shard: the leaf's own lead-axis
    ``coords`` placed at their axes' positions in ``shard_axes`` order,
    zeros elsewhere (the format-4 file-location rule)."""
    lead = entry["shard_axes"]
    return tuple(coords[lead.index(a)] if a in lead else 0
                 for a in shard_axes)


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
                with np.load(os.path.join(d, _ARRAYS)) as npz:
                    data = {k: npz[k] for k in npz.files}
            for r in range(manifest.get("topology", {}).get("n_shards", 0)):
                with np.load(os.path.join(d, shard_file(r))) as npz:
                    shard_data.append({k: npz[k] for k in npz.files})
            if mesh_axes:  # format 4: per-mesh-coordinate files
                needed = set()
                for e in manifest["leaves"].values():
                    if "shard_axes" not in e:
                        continue
                    for c in itertools.product(
                            *(range(mesh_axes[a]) for a in e["shard_axes"])):
                        needed.add(_leaf_full_coord(e, c, mesh_axes))
                for fullc in sorted(needed):
                    with np.load(os.path.join(
                            d, shard_file_coords(fullc))) as npz:
                        coord_maps[fullc] = {k: npz[k] for k in npz.files}
    except Exception as e:
        # truncated pack, truncated/garbled npz, missing shard file: with
        # verify, all of these are one condition, a corrupt checkpoint
        if verify:
            raise CheckpointCorruptionError(
                f"unreadable arrays in {d}: {type(e).__name__}: {e}") from e
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
    re-partitioned to the target leaf's shape when it differs (one card:
    the whole stack).  Returns ``(tree, step)``.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {ckpt_dir}")
    d = step_dir(ckpt_dir, step)
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


def _parse_keystr(key: str) -> list:
    """Path recovery for manifests without structured "path" entries:
    parse ``['a'][0].b`` keystrs (keys with quotes or brackets need the
    structured form)."""
    token = re.compile(r"\[\'([^\']*)\'\]|\[(\d+)\]|\.([A-Za-z_][A-Za-z_0-9]*)")
    parts = [m.group(1) or m.group(2) or m.group(3)
             for m in token.finditer(key)]
    return parts or [key]
