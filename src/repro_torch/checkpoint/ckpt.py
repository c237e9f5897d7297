"""Integrity-checked checkpoints of nested dicts of tensors.

Port of ``repro/checkpoint/ckpt.py`` with the same files, so each package
restores what the other saved:

    <dir>/step_<N:08d>/
        manifest.json   {step, meta, leaves: {key: {shape, dtype, file,
                         bytes, sha256}}}
        leaf_<i:05d>.bin  raw little-endian bytes of one leaf, the leaves
                          in sorted key order

A leaf's key is its path of dict keys joined by ``/`` (``params/w1``,
``opt/m/w1``, ``opt/step``).  A Python ``int`` leaf (the AdamW ``step``) is
written as a 0-d int32, as the reference holds it, and restores as an
``int`` into a template whose leaf is one.  bf16 leaves are raw 2-byte
words under the dtype name ``"bfloat16"``, read back as ``torch.bfloat16``.

* **Async**: ``save_async`` copies the tree to host memory at once (a
  blocking copy, so the work the caller's stream queued on a tensor is
  done first) and writes on a thread.
* **Integrity**: a sha256 per leaf, checked on restore; a save becomes
  visible only when its directory is renamed into place.
* **Rotation**: ``CheckpointManager`` keeps the ``keep`` newest steps.
* **Placement**: ``restore`` puts each leaf on its template leaf's device,
  or on ``device`` when given (the reference re-shards onto a mesh there).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..annotations import guarded_by

__all__ = ["save", "save_async", "wait_for_async", "restore", "latest_step",
           "CheckpointManager"]

Tree = Any
Leaf = Tuple[np.ndarray, str]     # (little-endian words, dtype name)


def _leaf(x: Any) -> Leaf:
    """One leaf as a host copy of its bytes and its numpy dtype name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    elif isinstance(x, int) and not isinstance(x, bool):
        a = np.asarray(x, np.int32)
    else:
        a = np.array(x)
    return a, a.dtype.name


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, Leaf]:
    if not isinstance(tree, dict):
        return {prefix: _leaf(tree)}
    flat: Dict[str, Leaf] = {}
    for k in sorted(tree):
        flat.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _write(directory: str, step: int, flat: Dict[str, Leaf],
           meta: Optional[Dict[str, Any]]) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "meta": meta or {},
                                "leaves": {}}
    for i, (key, (arr, dtype)) in enumerate(sorted(flat.items())):
        fname = f"leaf_{i:05d}.bin"
        raw = np.ascontiguousarray(
            arr, arr.dtype.newbyteorder("<")).tobytes()
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(raw)
        manifest["leaves"][key] = {
            "shape": list(arr.shape), "dtype": dtype, "file": fname,
            "bytes": len(raw), "sha256": hashlib.sha256(raw).hexdigest(),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomic publish
    return final


def save(directory: str, step: int, tree: Tree,
         meta: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous checkpoint write; returns the checkpoint path."""
    return _write(directory, step, _flatten(tree), meta)


@guarded_by("_lock", "_thread")
class _AsyncSaver:
    """One in-flight background save at most.  The module-level instance
    is reachable from any thread, so the handle swap is locked; the join
    runs outside the lock, so a second caller never waits on the writer's
    disk time only to learn that there is nothing to wait for."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def submit(self, directory, step, tree, meta) -> None:
        self.wait()
        flat = _flatten(tree)          # snapshot now, write later
        t = threading.Thread(target=_write,
                             args=(directory, step, flat, meta), daemon=True)
        with self._lock:
            self._thread = t
        t.start()

    def wait(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join()


_SAVER = _AsyncSaver()


def save_async(directory: str, step: int, tree: Tree,
               meta: Optional[Dict[str, Any]] = None) -> None:
    _SAVER.submit(directory, step, tree, meta)


def wait_for_async() -> None:
    _SAVER.wait()


def _steps(directory: str):
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _read_leaf(raw: bytes, info: Dict[str, Any]) -> torch.Tensor:
    if info["dtype"] == "bfloat16":
        words = np.frombuffer(raw, np.dtype("<i2")).astype(np.int16)
        t = torch.from_numpy(words).view(torch.bfloat16)
    else:
        dt = np.dtype(info["dtype"]).newbyteorder("<")
        t = torch.from_numpy(np.frombuffer(raw, dt).astype(dt.newbyteorder(
            "=")))
    return t.reshape(info["shape"])


def _unflatten_into(template: Tree, flat: Dict[str, torch.Tensor],
                    device, prefix: str = "") -> Tree:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, device,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    t = flat[prefix]
    want = tuple(np.shape(template))
    if tuple(t.shape) != want:
        raise ValueError(f"{prefix}: checkpoint shape {tuple(t.shape)} != "
                         f"template {want}")
    if isinstance(template, int) and not isinstance(template, bool):
        return int(t)
    dev = device if device is not None else (
        template.device if isinstance(template, torch.Tensor) else "cpu")
    return t.to(dev)


def restore(directory: str, step: Optional[int], template: Tree,
            device=None, verify: bool = True) -> Tuple[int, Tree]:
    """Restore into ``template``'s structure: each leaf on the template
    leaf's device, or on ``device`` when given."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat: Dict[str, torch.Tensor] = {}
    for key, info in manifest["leaves"].items():
        with open(os.path.join(path, info["file"]), "rb") as f:
            raw = f.read()
        if verify and hashlib.sha256(raw).hexdigest() != info["sha256"]:
            raise IOError(f"checkpoint corruption in {key}: sha256 mismatch")
        flat[key] = _read_leaf(raw, info)
    return manifest["step"], _unflatten_into(template, flat, device)


class CheckpointManager:
    """Rotation + async orchestration for a training loop."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Tree,
             meta: Optional[Dict[str, Any]] = None) -> None:
        if self.async_save:
            save_async(self.directory, step, tree, meta)
        else:
            save(self.directory, step, tree, meta)
        self._rotate(step)

    def _rotate(self, step: int) -> None:
        """Keep the ``keep`` newest steps, counting ``step`` even while its
        async write has not been published yet."""
        steps = sorted(set(_steps(self.directory)) | {step})
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template: Tree, device=None
                       ) -> Optional[Tuple[int, Tree]]:
        wait_for_async()
        step = latest_step(self.directory)
        if step is None:
            return None
        return restore(self.directory, step, template, device)

    def finalize(self) -> None:
        wait_for_async()
