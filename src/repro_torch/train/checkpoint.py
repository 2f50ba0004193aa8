"""Checkpointing: atomic, asynchronous, keyed by path.

  * **atomic**: write to ``<dir>/tmp.<step>``, then rename to
    ``<dir>/step_<step:010d>``, so a preempted save never corrupts the
    latest checkpoint;
  * **async**: :class:`AsyncCheckpointer` copies the state to host memory
    on the caller's thread, then writes it on a background thread while
    training goes on;
  * **keep_last_k** garbage collection.

A checkpoint is ``arrays.npz`` plus ``meta.json``.  The state is a tree of
dicts, NamedTuples and tensors; each leaf is stored under its path, the
``str()`` of each step as the JAX reference writes its key paths
(``['params']`` for a dict key, ``.mu`` for a NamedTuple field, ``[0]``
for a sequence index) joined by ``|``.  A reference trainer's checkpoint
therefore has the same keys as this trainer's for the same model
(:func:`read_subtree` reads either).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "|"
_DICT_KEY = re.compile(r"^\['(.*)'\]$")


def _items(node) -> Optional[list]:
    """(path step, child) pairs of an inner node; None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", v) for k, v in sorted(node.items())]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    """Path-keyed host copies of every leaf."""
    items = _items(tree)
    if items is None:
        arr = tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree
        return {_SEP.join(prefix): np.array(arr, copy=True)}
    out = {}
    for step, child in items:
        out.update(_flatten(child, prefix + (step,)))
    return out


def _unflatten(target, data, prefix=()):
    """``target``'s structure with each leaf read from ``data`` onto the
    leaf's device and dtype."""
    items = _items(target)
    if items is None:
        arr = torch.from_numpy(np.asarray(data[_SEP.join(prefix)]))
        if torch.is_tensor(target):
            return arr.to(device=target.device, dtype=target.dtype)
        return arr
    kids = [_unflatten(child, data, prefix + (step,)) for step, child in items]
    if isinstance(target, dict):
        return dict(zip(sorted(target), kids))
    if hasattr(target, "_fields"):
        return type(target)(*kids)
    return type(target)(kids)


def _write(ckpt_dir: str, step: int, arrays: Dict[str, np.ndarray],
           keep_last_k: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "format": 1, "shards": None}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last_k)
    return final


class AsyncCheckpointer:
    """Snapshot on the training thread, write on a background thread."""

    def __init__(self, ckpt_dir: str, keep_last_k: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last_k = keep_last_k
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any):
        self.wait()  # one outstanding save at a time
        arrays = _flatten(tree)  # device -> host copies, on the caller's thread
        self._thread = threading.Thread(
            target=_write, args=(self.ckpt_dir, step, arrays, self.keep_last_k),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _step_dirs(ckpt_dir: str):
    return sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.isdir(os.path.join(ckpt_dir, d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in _step_dirs(ckpt_dir)]
    return max(steps) if steps else None


def _load(ckpt_dir: str, step: Optional[int]) -> Tuple[Dict[str, np.ndarray], int]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}, step


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None):
    """Restore into the structure of ``target``; each leaf lands on the
    device and dtype of ``target``'s.  Returns ``(tree, step)``."""
    data, step = _load(ckpt_dir, step)
    return _unflatten(target, data), step


def read_subtree(ckpt_dir: str, root: str, step: Optional[int] = None):
    """The nested dict of numpy arrays under the top-level dict key
    ``root`` (``"params"``), read by key path alone: no target structure
    needed.  Only dict keys are followed below ``root``.  Returns
    ``(tree, step)``."""
    data, step = _load(ckpt_dir, step)
    head = f"[{root!r}]"
    tree: Dict[str, Any] = {}
    for key, arr in data.items():
        parts = key.split(_SEP)
        if parts[0] != head:
            continue
        names = []
        for p in parts[1:]:
            m = _DICT_KEY.match(p)
            if m is None:
                raise ValueError(f"checkpoint key {key!r}: {p!r} is not a dict key")
            names.append(m.group(1))
        node = tree
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = arr
    if not tree:
        raise KeyError(f"no {head} entries in the checkpoint at step {step}")
    return tree, step


def _gc(ckpt_dir: str, keep_last_k: int):
    for d in _step_dirs(ckpt_dir)[:-keep_last_k]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
