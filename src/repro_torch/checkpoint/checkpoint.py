"""Crash-safe tree checkpointing: flat-key npz + JSON manifest — the JAX
package's format and protocol, so that either package restores the
other's checkpoints.

Write protocol (a checkpoint must never be half-trusted):

  1. the npz is written to ``<name>.npz.tmp`` and ``os.replace``d into
     place — readers never observe a partially-written archive;
  2. the JSON manifest is written the same way, strictly AFTER the npz:
     the manifest is the **commit record**. A crash between the two
     leaves an orphaned ``ckpt_N.npz`` with no manifest — an uncommitted
     checkpoint that :func:`latest_step`/:func:`committed_steps` do not
     see;
  3. the manifest carries a per-array CRC32 of the stored bytes;
     :func:`restore` verifies it (and maps unreadable archives) into
     :class:`CheckpointCorruptError` so callers can fall back to the
     previous step. Manifests without the CRC field restore unverified.

Leaf keys join the path with ``/``: a dict key as ``str(key)``, a
sequence index as ``__i{idx}``; a ``None`` subtree stores nothing. A bf16
leaf is stored as the JAX package stores it, as raw 2-byte ``|V2``
records (numpy has no bf16), and restoring such a leaf is refused, as the
JAX package refuses it (ROADMAP.md queue 3). The manifest's ``treedef``
describes the port's tree; :func:`restore` never reads it.

``save(..., keep=k)`` rotates: only the newest k *committed* checkpoints
survive (manifest deleted first, so a crash mid-rotation can only create
uncommitted orphans).
"""
from __future__ import annotations

import json
import os
import re
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree as tree_lib
from ..engine import faults

_SEP = "/"


class CheckpointCorruptError(RuntimeError):
    """The checkpoint on disk is unreadable or fails its checksum."""


def _flatten_into(t, path: Tuple[str, ...], flat: Dict[str, Any]) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _flatten_into(t[k], path + (str(k),), flat)
    elif isinstance(t, (tuple, list)):
        for i, x in enumerate(t):
            _flatten_into(x, path + (f"__i{i}",), flat)
    elif t is not None:
        flat[_SEP.join(path)] = t


def _flatten(tree) -> Dict[str, Any]:
    """{"a/__i0/b": leaf} in the leaf order of ``repro_torch.tree``."""
    flat: Dict[str, Any] = {}
    _flatten_into(tree, (), flat)
    return flat


def _npz_name(step: int) -> str:
    return f"ckpt_{step:08d}.npz"


def _json_name(step: int) -> str:
    return f"ckpt_{step:08d}.json"


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:  # the bits, as numpy writes ml_dtypes' bf16
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save(directory: str, step: int, tree, *,
         keep: Optional[int] = None) -> str:
    """Write a committed checkpoint (see the module doc for the protocol);
    with ``keep``, rotate out all but the newest ``keep`` committed steps.
    Device tensors are copied to the host first."""
    os.makedirs(directory, exist_ok=True)
    faults.on_checkpoint_io(step)
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    path = os.path.join(directory, _npz_name(step))
    tmp = path + ".tmp"
    # np.savez appends ".npz" to bare string paths — hand it a file object
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    faults.on_checkpoint_commit(step)  # the torn-write crash window
    manifest = {"step": step,
                "treedef": "repro_torch " + str(tree_lib.flatten(tree)[1]),
                "keys": sorted(arrays),
                "crc": {k: _crc(v) for k, v in arrays.items()}}
    jpath = os.path.join(directory, _json_name(step))
    jtmp = jpath + ".tmp"
    with open(jtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(jtmp, jpath)  # <-- the commit point
    if keep is not None:
        rotate(directory, keep)
    return path


def committed_steps(directory: str) -> List[int]:
    """Ascending steps with BOTH the npz and its manifest present —
    uncommitted (torn) checkpoints are invisible."""
    if not os.path.isdir(directory):
        return []
    files = set(os.listdir(directory))
    steps = [int(m.group(1)) for f in files
             if (m := re.match(r"ckpt_(\d+)\.json$", f))]
    return sorted(s for s in steps if _npz_name(s) in files)


def latest_step(directory: str) -> Optional[int]:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def rotate(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` committed checkpoints (manifest
    first — mid-rotation crashes leave orphans, never committed garbage)."""
    for step in committed_steps(directory)[:-keep or None]:
        for name in (_json_name(step), _npz_name(step)):
            try:
                os.remove(os.path.join(directory, name))
            except FileNotFoundError:
                pass


def _load_manifest(directory: str, step: int) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(directory, _json_name(step))) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (json.JSONDecodeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest for step {step}: {e}") from e


def _to_tensor(key: str, arr: np.ndarray, leaf, device) -> torch.Tensor:
    if arr.dtype.kind == "V":
        raise ValueError(
            f"checkpoint leaf {key!r} is stored as raw {arr.dtype.str} "
            f"records (a bf16 leaf) and cannot be cast to {leaf.dtype}: "
            "the JAX package refuses the same leaf (ROADMAP.md queue 3)")
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                         f"the template {tuple(leaf.shape)}")
    dev = leaf.device if device is None else torch.device(device)
    arr = np.require(arr, requirements=["C", "W"])  # copies only if needed
    return torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)


def restore(directory: str, template, step: Optional[int] = None, *,
            device=None, verify: bool = True):
    """Restore into the structure of ``template`` (shapes must match), as
    tensors on ``device`` (default: each template leaf's device) in the
    template leaves' dtypes.

    Raises :class:`CheckpointCorruptError` for an uncommitted (no
    manifest), unreadable, or checksum-failing checkpoint — callers fall
    back to an earlier committed step (``Trainer.restore`` does) — and
    ``KeyError`` when the checkpoint lacks a key of the template."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    manifest = _load_manifest(directory, step)
    if manifest is None:
        raise CheckpointCorruptError(
            f"step {step} has no manifest (torn write?) in {directory}")
    crcs = manifest.get("crc") if verify else None  # pre-CRC manifests: skip
    flat_t = _flatten(template)
    npz_path = os.path.join(directory, _npz_name(step))
    try:
        with np.load(npz_path) as data:
            missing = set(flat_t) - set(data.files)
            if missing:
                raise KeyError(
                    f"checkpoint missing keys: {sorted(missing)[:5]}...")
            arrays = {k: data[k] for k in flat_t}
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"manifest for step {step} exists but {npz_path} is gone") from e
    except (zipfile.BadZipFile, zlib.error, EOFError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint archive {npz_path}: {e}") from e
    if crcs:
        for key, arr in arrays.items():
            want = crcs.get(key)
            if want is not None and _crc(arr) != want:
                raise CheckpointCorruptError(
                    f"checksum mismatch for {key!r} in {npz_path}")
    leaves, treedef = tree_lib.flatten(template)
    restored = [_to_tensor(k, arrays[k], leaf, device)
                for k, leaf in zip(flat_t, leaves)]
    return tree_lib.unflatten(treedef, restored)
