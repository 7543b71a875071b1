"""Fault-tolerant asynchronous checkpointing.

The port's copy of ``repro.checkpoint.checkpointer``, over nested dicts,
lists and tuples of torch tensors and numpy arrays.  ENEAC's interrupt
discipline applied to state persistence: ``save()`` snapshots device
tensors to host (the only synchronous part), hands the write to a
background thread, and returns; the completion event fires when the
manifest is on disk.  Restart-safety comes from write-to-temp + atomic
rename + manifest integrity hashes; the newest *complete* checkpoint wins
at restore, so a mid-write crash falls back to the previous step.

The format is the reference's, so either package restores the other's
checkpoints: a leaf's manifest ``path`` is the string
``jax.tree_util.keystr`` gives for it (``['coverage_done']``,
``['layers'][0]``; dict keys in sorted order, ``None`` holds no leaf),
files are numbered in that order, and the hash covers the leaf's bytes.
numpy has no bfloat16, so a bfloat16 leaf is written as its 16-bit
patterns under the header numpy writes for ``ml_dtypes.bfloat16``
(``'<V2'``) with ``"dtype": "bfloat16"`` in the manifest, and restored as
a ``torch.bfloat16`` tensor.

Layout (one directory per step):
    <dir>/step_000100.tmp/...      (in-flight)
    <dir>/step_000100/
        manifest.json              {step, leaves: [{path, file, shape, dtype, sha256}]}
        arr_00000.npy ...          one file per leaf
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.interrupts import CompletionEvent

__all__ = ["Checkpointer", "CheckpointInfo"]

BF16 = "bfloat16"


@dataclasses.dataclass(frozen=True)
class CheckpointInfo:
    step: int
    path: Path
    wall_time: float


def _map_tree(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(keystr path, leaf)``.

    Leaves are visited in the reference's flattening order (dict keys
    sorted), which numbers the checkpoint's files.
    """
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: _map_tree(tree[k], fn, f"{prefix}[{k!r}]") for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return fn(prefix, tree)


def _tree_paths(tree) -> List[Tuple[str, Any]]:
    leaves: List[Tuple[str, Any]] = []
    _map_tree(tree, lambda path, leaf: leaves.append((path, leaf)))
    return leaves


def _host_copy(leaf):
    """A host copy that later writes to ``leaf`` cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    return np.array(leaf, copy=True)


def _as_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype); bfloat16 as its bit patterns."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), BF16
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_npy(file: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(file, arr)
        return
    with open(file, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: List[threading.Thread] = []

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> CompletionEvent:
        """Async checkpoint; returns the completion event (interrupt analogue)."""
        # device→host snapshot must happen before the caller mutates buffers
        host_tree = _map_tree(tree, lambda _, leaf: _host_copy(leaf))
        done = CompletionEvent()
        t = threading.Thread(
            target=self._write, args=(step, host_tree, done),
            name=f"ckpt-{step}", daemon=True,
        )
        with self._lock:
            self._pending.append(t)
        t.start()
        if blocking:
            done.wait()
        return done

    def _write(self, step: int, host_tree, done: CompletionEvent) -> None:
        t0 = time.perf_counter()
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (path, leaf) in enumerate(_tree_paths(host_tree)):
            arr, dtype = _as_numpy(leaf)
            fname = f"arr_{i:05d}.npy"
            _save_npy(tmp / fname, arr, dtype)
            manifest["leaves"].append(
                {
                    "path": path,
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "sha256": _hash(arr),
                }
            )
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()
        done.fire(CheckpointInfo(step=step, path=final,
                                 wall_time=time.perf_counter() - t0))

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_????????"))
        for old in ckpts[: max(0, len(ckpts) - self.keep)]:
            shutil.rmtree(old, ignore_errors=True)

    def wait_all(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_????????"))
        for c in reversed(ckpts):
            if (c / "manifest.json").exists():
                return int(c.name.split("_")[1])
        return None

    def restore(self, step: Optional[int], like_tree, *, verify: bool = True):
        """Restore into the structure of ``like_tree``; returns (tree, step).

        A leaf comes back as a CPU tensor where ``like_tree`` holds a
        tensor, and as a numpy array where it holds an array, except that
        a bfloat16 leaf is always a ``torch.bfloat16`` tensor.  Shape
        mismatches raise.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        with open(path / "manifest.json") as f:
            manifest = json.load(f)
        by_path = {m["path"]: m for m in manifest["leaves"]}

        def load(key: str, like):
            meta = by_path.get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(path / meta["file"])
            if verify and _hash(arr) != meta["sha256"]:
                raise IOError(f"checksum mismatch for {key} in step {step}")
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != expected {tuple(like.shape)}"
                )
            if meta["dtype"] == BF16:
                return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            return torch.from_numpy(arr) if isinstance(like, torch.Tensor) else arr

        return _map_tree(like_tree, load), manifest["step"]
