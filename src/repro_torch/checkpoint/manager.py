"""Checkpointing: sharded-chunk save/restore, HR-layout replicas, async;
the port's counterpart of ``repro.checkpoint.manager``, writing the
reference's on-disk format, so a checkpoint written by either package
restores in the other.

Fault-tolerance contract:
  * each leaf is split into chunks along axis 0 (one file per chunk), so
    restore works for any future mesh;
  * a checkpoint is written to ``<dir>.tmp`` and atomically renamed, with
    a manifest carrying the step, each leaf's path, shape, logical dtype
    and chunk count;
  * RF replicas are written, each with a *different manifest order*
    (heterogeneous replica, paper §2), which ``layouts.CheckpointRouter``
    costs restore queries against.

Trees are nested dicts keyed as the reference's: ``params/stack_<name>/
…`` (a stack's layers stacked on axis 0), ``opt/state/…/m`` and
``opt/step``. Leaves are numpy arrays (bfloat16 as its ``uint16`` bits,
``models.convert.to_numpy``) or tensors. A training step updates the
parameters in place, so ``save_checkpoint`` copies every leaf to the
host on the caller's thread, before the writer thread starts; restoring
copies into the live parameters and optimizer state under ``no_grad``.

On a mesh the leaves are DTensors: every rank makes the host copy (each
leaf whole, a collective), one rank writes the files (``write=False``
on the others), and restoring has every rank read the whole leaves and
keep its own shards (``convert.copy_whole``), so a checkpoint restores
onto any mesh, or onto one device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.keys import KeySchema, pack_columns
from repro_torch.models.convert import (
    copy_whole,
    load_lm_from_reference,
    lm_to_reference,
    nest,
    opt_from_reference,
    opt_to_reference,
    to_numpy,
)
from repro_torch.models.lm import LM

__all__ = [
    "CheckpointManager",
    "REPLICA_LAYOUTS",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "flatten",
    "unflatten",
    "train_tree",
    "load_train_tree",
    "manifest_key_columns",
]

_SAFE = re.compile(r"[^a-zA-Z0-9_.-]")

_NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16", "int8", "uint8", "uint32", "uint64", "bool")


def _to_storage(arr: np.ndarray) -> tuple[np.ndarray, str]:
    """(the array numpy saves, its logical dtype name): bfloat16, held as
    ``uint16`` bits (or numpy's extension type), is stored as those bits."""
    if arr.dtype.name in ("uint16", "bfloat16"):
        return arr.view(np.uint16), "bfloat16"
    if arr.dtype.name not in _NATIVE:
        raise TypeError(f"no storage for dtype {arr.dtype}")
    return arr, arr.dtype.name


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts → ``{"a/b/c": leaf}``, keys sorted at every level (the
    checkpoint's leaf paths and order)."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(flatten(tree[k], path) if isinstance(tree[k], dict) else {path: tree[k]})
    return out


def unflatten(flat: dict) -> dict:
    """``{"a/b/c": leaf}`` → nested dicts."""
    return nest({tuple(path.split("/")): leaf for path, leaf in flat.items()})


def _chunk(arr: np.ndarray, n_chunks: int):
    if arr.ndim == 0 or n_chunks <= 1 or arr.shape[0] < n_chunks:
        return [arr]
    return np.array_split(arr, n_chunks, axis=0)


#: manifest layouts for the HR checkpoint replicas (key orders over the
#: manifest columns); chosen so full / by-stack / by-kind restores each
#: have a cheap replica.
REPLICA_LAYOUTS = (
    ("stack_id", "layer", "kind_id"),
    ("kind_id", "stack_id", "layer"),
    ("layer", "kind_id", "stack_id"),
)


class _Writer(threading.Thread):
    """The writer thread; ``join_or_raise`` re-raises what it raised."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.error = fn, None

    def run(self):
        try:
            self.fn()
        except BaseException as e:  # noqa: BLE001  (re-raised on the caller's thread)
            self.error = e

    def join_or_raise(self) -> None:
        self.join()
        if self.error is not None:
            raise self.error


def save_checkpoint(
    directory: str,
    step: int,
    tree: dict,
    *,
    n_chunks: int = 4,
    replicas: int = 1,
    block: bool = True,
    write: bool = True,
) -> _Writer | None:
    """Write ``tree`` at ``directory/step_<k>`` (atomically). Every leaf is
    copied to the host before this returns; with ``block=False`` the files
    are written by a thread, returned. With ``replicas > 1`` the manifest
    entry order differs per replica (the data files are shared). With
    ``write=False`` only the host copy is made (a mesh's other ranks)."""
    host = [(p, to_numpy(v) if isinstance(v, torch.Tensor) else np.array(v)) for p, v in flatten(tree).items()]
    if not write:
        return None

    def _write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
        manifest = {"step": step, "leaves": [], "n_chunks": n_chunks}
        for path, arr in host:
            safe = _SAFE.sub("_", path)
            stored, logical = _to_storage(arr)
            chunks = _chunk(stored, n_chunks)
            entry = {"path": path, "file": safe, "shape": list(arr.shape), "dtype": logical, "chunks": len(chunks)}
            for ci, c in enumerate(chunks):
                np.save(os.path.join(tmp, "data", f"{safe}.{ci}.npy"), c)
            manifest["leaves"].append(entry)
        # replica manifests: same data files, different serialization order
        for r in range(max(1, replicas)):
            layout = REPLICA_LAYOUTS[r % len(REPLICA_LAYOUTS)]
            order = _replica_order(manifest["leaves"], layout)
            m = dict(manifest, replica=r, layout=list(layout), leaves=[manifest["leaves"][i] for i in order])
            with open(os.path.join(tmp, f"manifest_r{r}.json"), "w") as f:
                json.dump(m, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)

    if block:
        _write()
        return None
    t = _Writer(_write)
    t.start()
    return t


def manifest_key_columns(leaves) -> dict:
    """Per-FILE sortable keys: (stack_id, layer, kind_id). A chunk along
    axis 0 of a stacked-layer leaf covers a contiguous layer range, so
    the chunk index is the manifest's ``layer`` key."""
    stacks = sorted({e["path"].split("/")[0] for e in leaves})
    kinds = sorted({e["path"].split("/")[-1] for e in leaves})
    cols = {"stack_id": [], "layer": [], "kind_id": [], "file_idx": []}
    fi = 0
    for e in leaves:
        parts = e["path"].split("/")
        for ci in range(e["chunks"]):
            cols["stack_id"].append(stacks.index(parts[0]))
            cols["layer"].append(ci)
            cols["kind_id"].append(kinds.index(parts[-1]))
            cols["file_idx"].append(fi)
            fi += 1
    return {k: np.asarray(v, np.int64) for k, v in cols.items()}


def _replica_order(leaves, layout) -> list[int]:
    """Order of LEAF entries by the layout over (stack, first-chunk keys)."""
    cols = manifest_key_columns(leaves)
    # reduce per-file keys back to per-leaf (first chunk row of each leaf)
    first = []
    fi = 0
    for e in leaves:
        first.append(fi)
        fi += e["chunks"]
    per_leaf = {k: cols[k][first] for k in ("stack_id", "layer", "kind_id")}
    schema = KeySchema.for_columns({k: cols[k] for k in ("stack_id", "layer", "kind_id")})
    packed = pack_columns(per_leaf, layout, schema)
    return list(np.argsort(packed, kind="stable"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(n.split("_")[1])
        for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None, *, replica: int = 0) -> tuple[int, dict]:
    """Returns (step, flat ``{path: numpy array}``), bfloat16 leaves as
    their ``uint16`` bits."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    mpath = os.path.join(d, f"manifest_r{replica}.json")
    if not os.path.exists(mpath):
        mpath = os.path.join(d, "manifest_r0.json")
    with open(mpath) as f:
        manifest = json.load(f)
    flat = {}
    for e in manifest["leaves"]:
        parts = [np.load(os.path.join(d, "data", f"{e['file']}.{ci}.npy")) for ci in range(e["chunks"])]
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        want = np.uint16 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"])
        if arr.dtype != want:
            raise ValueError(f"{e['path']}: stored as {arr.dtype}, the manifest says {e['dtype']}")
        flat[e["path"]] = arr.reshape(e["shape"])
    return manifest["step"], flat


def train_tree(model: LM, opt_state: dict) -> dict:
    """The host copy of a training state, ``{"params", "opt"}`` in the
    reference's layout (``convert.lm_to_reference``, ``opt_to_reference``)."""
    return {"params": lm_to_reference(model), "opt": opt_to_reference(opt_state)}


def _same_layout(live: dict, restored: dict, where: str) -> None:
    if live.keys() != restored.keys():
        raise ValueError(f"{where}: the checkpoint holds {sorted(restored)}, the state {sorted(live)}")
    for k, v in live.items():
        if isinstance(v, dict):
            _same_layout(v, restored[k], f"{where}/{k}")
        elif v.shape != restored[k].shape or v.dtype != restored[k].dtype:
            raise ValueError(f"{where}/{k}: the checkpoint holds {tuple(restored[k].shape)} {restored[k].dtype}, "
                             f"the state {tuple(v.shape)} {v.dtype}")


def _copy_into(live: dict, restored: dict) -> None:
    for k, v in live.items():
        if isinstance(v, dict):
            _copy_into(v, restored[k])
        else:
            copy_whole(v, restored[k])


@torch.no_grad()
def load_train_tree(model: LM, opt_state: dict, tree: dict) -> None:
    """Copy a training state (``train_tree``'s layout, numpy or CPU
    tensors) into the live parameters and the tensors of ``opt_state``
    (each rank its own shards of DTensors)."""
    load_lm_from_reference(model, tree["params"])
    new = opt_from_reference(tree["opt"], device=model.device)
    _same_layout(opt_state["state"], new["state"], "opt/state")
    _copy_into(opt_state["state"], new["state"])
    opt_state["step"] = new["step"]


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    every: int = 50
    n_chunks: int = 4
    replicas: int = 3
    async_save: bool = True
    write: bool = True  # False on a mesh's ranks but the one that writes
    _pending: _Writer | None = None

    def maybe_save(self, step: int, model: LM, opt_state: dict) -> bool:
        """Save the state at every ``every``-th step; the host copy is made
        here, the files written in the background."""
        if step % self.every:
            return False
        self.wait()
        self._pending = save_checkpoint(
            self.directory, step, train_tree(model, opt_state),
            n_chunks=self.n_chunks, replicas=self.replicas, block=not self.async_save, write=self.write,
        )
        return True

    def wait(self) -> None:
        """Wait for the pending write; raises what it raised."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.join_or_raise()

    def restore_latest(self, model: LM, opt_state: dict) -> int | None:
        """Copy the latest checkpoint into ``model`` and ``opt_state``;
        returns its step, or None when there is none."""
        step = latest_step(self.directory)
        if step is None:
            return None
        s, flat = restore_checkpoint(self.directory, step)
        load_train_tree(model, opt_state, unflatten(flat))
        return s
