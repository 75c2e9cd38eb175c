"""Checkpoints in the reference's format, with async save
(``repro/checkpoint/store.py``).

A checkpoint is ``step_%08d/leaves.npz`` (one array per leaf, host
copies) plus ``manifest.json`` (step, each leaf's shape and dtype tag, a
checksum), written under ``.tmp_step_%08d`` and renamed into place, so a
crash mid-save never leaves a partial latest checkpoint.  The format is
the reference's to the byte, so either package reads what the other
writes:

- leaf names are jax's tree paths joined by ``/``: a dict key as itself
  (keys sorted), a NamedTuple field as ``.field``, a sequence index as
  its number; a ``None`` field holds no leaf.  A ``TrainState``'s names
  start ``.params/``, ``.opt/.m/``, ``.opt/.v/``, ``.opt/.step``,
  ``.step``, ``.rng`` (and ``.compress/.error/`` when it compresses);
- a bf16 tensor is stored as f32 and tagged ``"bfloat16"``; a threefry
  key (the port's pair of ints, the reference's raw key data) as
  ``uint32`` (2,); a Python int (the port's step counters, the
  reference's int32 scalars) as an int32 scalar;
- the checksum is sha256 over each name and the first 4096 bytes of its
  array, in flatten order.

:func:`load_checkpoint` restores into the structure of ``like``, a tree of
the port's (a ``TrainState`` or a parameter dict): tensors on ``like``'s
device (or ``device``), in ``like``'s dtypes and with its
``requires_grad``, ints as Python ints, keys as key pairs.  A name
``like`` has and the checkpoint lacks raises ``KeyError``, as in the
reference (so ``serve.py --ckpt-dir`` reads only params-only
checkpoints in both packages).

On a mesh (a tree whose tensors are DTensors, ``train.step.place_state``)
a save gathers every leaf whole with ``full_tensor()`` on the caller's
thread, a collective every rank joins; rank 0 alone writes, and every
rank waits for the write at a barrier (``CheckpointManager.wait``), so
the format does not change and either package reads a sharded run's
checkpoints.  A load with ``shardings`` (the port's ``{"params", "m",
"v", "error"}`` of ``launch.sharding.state_shardings``, or a parameter
tree's ``param_shardings``), or into a ``like`` of DTensors, has every
rank read the arrays and keep its own blocks (``parallel.place``): the
reference's elastic re-shard, so a checkpoint saved unsharded loads onto
any mesh and the reverse.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import parallel as PX


def _is_key(leaf: Any) -> bool:
    """A threefry key of the port: a tuple of two Python ints."""
    return (type(leaf) is tuple and len(leaf) == 2
            and all(isinstance(w, int) and not isinstance(w, bool) for w in leaf))


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _map_with_names(fn: Callable[[str, Any], Any], tree: Any, path: tuple = ()) -> Any:
    """``tree`` with every leaf replaced by ``fn(name, leaf)``, the leaves
    visited in jax's flatten order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_names(fn, getattr(tree, f), path + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not _is_key(tree):
        return type(tree)(_map_with_names(fn, x, path + (str(i),)) for i, x in enumerate(tree))
    return fn("/".join(path), tree)


def _flatten_with_names(tree: Any) -> list[tuple[str, Any]]:
    """(name, leaf) pairs in jax's flatten order."""
    out: list[tuple[str, Any]] = []
    _map_with_names(lambda name, leaf: out.append((name, leaf)), tree)
    return out


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """Host array + original dtype tag (npz stores no bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        a = t.numpy()
    elif _is_key(leaf):
        a = np.asarray(leaf, dtype=np.uint32)
    elif isinstance(leaf, int) and not isinstance(leaf, bool):
        a = np.asarray(leaf, dtype=np.int32)   # the reference's int32 counters
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Blocking atomic save; returns the checkpoint path.  A tree of
    DTensors is gathered whole on every rank, rank 0 writes, and every
    rank waits for it at a barrier."""
    if _gathers(tree):
        host = _map_with_names(lambda _n, leaf: _host_copy(leaf), tree)
        if dist.get_rank() == 0:
            save_checkpoint(directory, step, host)
        dist.barrier()
        return os.path.join(directory, f"step_{step:08d}")
    os.makedirs(directory, exist_ok=True)
    named = _flatten_with_names(tree)
    names = [n for n, _ in named]
    converted = [_to_numpy(leaf) for _, leaf in named]
    arrays = [c[0] for c in converted]
    dtypes = [c[1] for c in converted]
    tmp = os.path.join(directory, f".tmp_step_{step:08d}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "leaves.npz"), **dict(zip(names, arrays)))
    digest = hashlib.sha256()
    for n, a in zip(names, arrays):
        digest.update(n.encode())
        # the reference's ``tobytes()[:4096]``, without copying the array
        digest.update(np.ascontiguousarray(a).reshape(-1).view(np.uint8)[:4096].tobytes())
    manifest = {
        "step": step,
        "leaves": {
            n: {"shape": list(a.shape), "dtype": dt}
            for n, a, dt in zip(names, arrays, dtypes)
        },
        "checksum": digest.hexdigest(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in (re.match(r"step_(\d+)$", d)
                                            for d in os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


# a TrainState's name segments that select a part of state_shardings' dict
_STATE_PARTS = {".params": "params", ".m": "m", ".v": "v", ".error": "error"}


def _sharding_at(shardings: Any, name: str) -> Optional[PX.Sharding]:
    """The sharding ``shardings`` gives the leaf ``name``, or ``None``."""
    node = shardings
    for seg in name.split("/"):
        if isinstance(node, PX.Sharding) or node is None:
            break
        if seg in (".opt", ".compress"):
            continue
        node = node.get(_STATE_PARTS.get(seg, seg)) if isinstance(node, dict) else None
    return node if isinstance(node, PX.Sharding) else None


def _gathers(tree: Any) -> bool:
    """Whether ``tree`` holds a DTensor (a save every rank takes part in)."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(leaf, DTensor) for _, leaf in _flatten_with_names(tree))


def load_checkpoint(directory: str, step: int, like: Any, device=None,
                    shardings: Any = None) -> Any:
    """Restore the checkpoint at ``step`` into the structure of ``like``;
    a tensor leaf with a sharding (from ``shardings``, else a DTensor
    leaf's own placements) comes back as that rank's block of it."""
    from torch.distributed.tensor import DTensor

    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "leaves.npz"))

    def restore(name: str, leaf: Any) -> Any:
        a = data[name]
        want = manifest["leaves"][name]
        assert list(a.shape) == want["shape"], (name, a.shape, want)
        if hasattr(leaf, "shape") and tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {name} has shape {tuple(a.shape)}, the tree "
                             f"restored into has {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            sh = None if shardings is None else _sharding_at(shardings, name)
            if sh is None and isinstance(leaf, DTensor):
                sh = PX.Sharding(leaf.device_mesh, tuple(leaf.placements))
            t = torch.from_numpy(np.array(a)).to(
                device=leaf.device if device is None else device, dtype=leaf.dtype)
            if sh is not None:
                t = PX.place_local(t[PX.local_slices(sh, t.shape)].clone(), sh, t.shape)
            return t.requires_grad_(leaf.requires_grad)
        if _is_key(leaf):
            return int(a[0]), int(a[1])
        if isinstance(leaf, (int, float)):
            return type(leaf)(a)
        return a.astype(leaf.dtype) if hasattr(leaf, "dtype") else a

    return _map_with_names(restore, like)


def _host_copy(leaf: Any) -> Any:
    """A tensor's copy on the host, finished before it returns (the caller
    goes on updating the original in place)."""
    if isinstance(leaf, torch.Tensor):
        return PX.whole(leaf.detach()).to("cpu", copy=True)
    return leaf


class CheckpointManager:
    """Async checkpointing off the critical path + retention policy.

    ``saves`` records each save: its step, the seconds of the host gather
    (on the caller's thread) and of the write (in the background), and the
    checkpoint's bytes on disk.  A tree of DTensors is gathered whole on
    every rank; rank 0 alone writes, and :meth:`wait` holds every rank at
    a barrier until that write is done."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.saves: list[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._barrier = False

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        # Gather on the caller's thread: the training step updates
        # parameters and moments in place, so the copies must be complete
        # before the next step runs.  Write in the background.
        t0 = time.perf_counter()
        host_tree = _map_with_names(lambda _n, leaf: _host_copy(leaf), tree)
        record = {"step": step, "gather_s": time.perf_counter() - t0}
        self.saves.append(record)
        self._barrier = _gathers(tree)
        if self._barrier and dist.get_rank() != 0:
            return

        def work():
            t1 = time.perf_counter()
            path = save_checkpoint(self.directory, step, host_tree)
            record["write_s"] = time.perf_counter() - t1
            record["bytes"] = sum(e.stat().st_size for e in os.scandir(path))
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self) -> None:
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
