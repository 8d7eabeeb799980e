"""Async, atomically committed checkpoints in the JAX package's on-disk
format (its ``ckpt/checkpoint.py``), so that a checkpoint either package
writes is restored by the other.

Layout (one directory per step)::

    <root>/step_00000100.tmp/      while writing
        manifest.json              step, time, extra, leaf paths, and each
                                   leaf's file, shape and dtype name
        arr_00000.npy ...          one file per leaf
    <root>/step_00000100/          atomic rename on commit

The leaves are those of the JAX package's tree: its flatten order (dict
keys sorted, tuples and lists by index, a ``NamedTuple`` by field) and its
``keystr`` paths (``[0]['layers']['attn']['wq']``, ``[1].step``).  The port
keeps layers apart where the JAX package stacks them, so the leaves under
``ckpt.convert.STACKED``'s keys are written stacked [L, ...] and read back
layer by layer.  Restore matches leaves by path, not by position.

- **bf16 without ml_dtypes.**  numpy has no bfloat16: the JAX package's
  ``np.save`` writes its bytes as void ``V2`` and names the type
  ``"bfloat16"`` in the manifest.  The port writes a bf16 leaf the same
  way and reads a void leaf by viewing its bytes as bf16; it never needs
  ``ml_dtypes``.
- **Scalars.**  A Python int leaf (the port's ``OptState.step``) is
  written as int32, as the JAX package's ``OptState.step`` is; a Python
  float as float32.
- **Restore in place.**  Each leaf is copied into the tensor of ``like``
  that it replaces (``copy_``), one file at a time from a memory map, so a
  device never holds two copies of the model.
- **Async.**  ``CheckpointManager.save_async`` copies the leaves to host
  memory on the caller's thread, so the step loop may overwrite its
  tensors as soon as it returns, and a background thread writes the
  files; ``wait()`` joins it (one outstanding save).
- **Retention.**  The newest ``keep`` committed steps stay; a crashed
  writer's ``.tmp`` directory is ignored by restore and removed by the
  next save.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt.convert import STACKED

_MANIFEST = "manifest.json"

# numpy has no bfloat16: a bf16 leaf's file holds its bytes as void V2
# and the manifest names the type
_BF16 = "bfloat16"


# ----------------------------------------------------------------------
# The JAX package's view of a tree
# ----------------------------------------------------------------------
def _walk(tree, visit: Callable, path: str = "", idx: Tuple[int, ...] = (),
          rule: Optional[dict] = None):
    """Rebuild ``tree`` with each leaf replaced by ``visit(path, idx,
    leaf)``: ``path`` is the JAX package's ``keystr`` of the leaf it
    belongs to and ``idx`` the layer indices under stacked keys (a stacked
    JAX leaf is every leaf with its path, stacked in ``idx`` order).

    ``rule`` holds the stacked keys of a dict at this level: outside a stack
    every dict takes :data:`STACKED`'s; a layer dict takes its key's own
    rule and the dicts below it none."""
    inside = rule is not None
    rule = STACKED if rule is None else rule
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            v, p = tree[k], f"{path}[{k!r}]"
            if k in rule and isinstance(v, list):
                out[k] = [_walk(lv, visit, p, idx + (i,), rule[k])
                          for i, lv in enumerate(v)]
            else:
                out[k] = _walk(v, visit, p, idx, {} if inside else None)
        return {k: out[k] for k in tree}          # the caller's key order
    sub = {} if inside else None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(getattr(tree, f), visit, f"{path}.{f}",
                                  idx, sub) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, visit, f"{path}[{i}]", idx, sub)
                          for i, v in enumerate(tree))
    if tree is None:
        return None                               # an empty subtree
    return visit(path, idx, tree)


def _leaves(tree) -> "OrderedDict[str, List[Tuple[Tuple[int, ...], Any]]]":
    """The JAX package's leaves of ``tree``: path -> [(layer indices,
    port leaf)], in its flatten order."""
    out: "OrderedDict[str, list]" = OrderedDict()

    def visit(path, idx, leaf):
        out.setdefault(path, []).append((idx, leaf))
        return leaf

    _walk(tree, visit)
    return out


def _as_tensor(leaf) -> torch.Tensor:
    """A leaf as a tensor: Python scalars as 32-bit (the JAX package's
    ``OptState.step`` is int32)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, bool):
        return torch.tensor(leaf)
    if isinstance(leaf, int):
        return torch.tensor(leaf, dtype=torch.int32)
    if isinstance(leaf, float):
        return torch.tensor(leaf, dtype=torch.float32)
    return torch.from_numpy(np.asarray(leaf))


def _snapshot(entries) -> Tuple[np.ndarray, str]:
    """One JAX leaf in host memory, in the file's layout (bf16 as void
    bytes), with its dtype name: the port leaf, or the layers' leaves
    stacked along their layer indices.  Each leaf is copied once, straight
    into the buffer (from the card, one device-to-host copy), so the
    snapshot never aliases a tensor the step loop may overwrite."""
    leaves = [(idx, _as_tensor(leaf)) for idx, leaf in entries]
    idx0, t0 = leaves[0]
    dims = tuple(max(i[d] for i, _ in leaves) + 1 for d in range(len(idx0)))
    out = torch.empty(dims + tuple(t0.shape), dtype=t0.dtype)
    for idx, t in leaves:
        out[idx].copy_(t)
    if out.dtype == torch.bfloat16:
        return out.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
    arr = out.numpy()
    return arr, str(arr.dtype)


def host_leaves(tree) -> List[Tuple[str, np.ndarray, str]]:
    """``tree``'s leaves in the JAX package's order as (path, host array,
    dtype name): the snapshot a save writes."""
    return [(path, *_snapshot(entries))
            for path, entries in _leaves(tree).items()]


# ----------------------------------------------------------------------
# save / restore
# ----------------------------------------------------------------------
def _write(root: Path, step: int, leaves, extra: Optional[dict]) -> Path:
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "paths": [p for p, _, _ in leaves], "leaves": []}
    for i, (_, arr, name) in enumerate(leaves):
        fname = f"arr_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({"file": fname, "shape": list(arr.shape),
                                   "dtype": name})
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # the commit point
    return final


def save_checkpoint(root: Path, step: int, tree: Any,
                    extra: Optional[dict] = None) -> Path:
    """Synchronous save with atomic commit.  Returns the committed dir."""
    return _write(root, step, host_leaves(tree), extra)


def latest_step(root: Path) -> Optional[int]:
    root = Path(root)
    if not root.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in root.iterdir()
             if d.is_dir() and d.name.startswith("step_")
             and not d.name.endswith(".tmp") and (d / _MANIFEST).exists()]
    return max(steps) if steps else None


def _load(path: Path, dtype_name: str) -> torch.Tensor:
    """A leaf's file as a CPU tensor over a copy-on-write memory map, void
    bytes viewed as the manifest's type."""
    arr = np.load(path, mmap_mode="c")
    if arr.dtype.kind == "V":
        if dtype_name != _BF16:
            raise ValueError(f"{path}: no torch type for raw {dtype_name!r}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _restore_leaf(src: torch.Tensor, like, device):
    """``src`` in the place of ``like``: copied into ``like`` when it is a
    tensor on ``device`` (its own by default), else a new tensor on
    ``device`` in ``like``'s type; a Python scalar leaf stays one."""
    if isinstance(like, torch.Tensor):
        if device is None or like.device == torch.device(device):
            with torch.no_grad():
                like.copy_(src)
            return like
        return src.to(device=device, dtype=like.dtype, copy=True)
    if isinstance(like, (bool, int, float)):
        return type(like)(src.item())
    return src.to(device=device, copy=True)


def restore_checkpoint(root: Path, like: Any, step: Optional[int] = None,
                       device=None) -> Any:
    """Restore step ``step`` (the newest by default) into the structure of
    ``like`` and return it.  Leaves are matched by path; each tensor of
    ``like`` on ``device`` (its own device when ``device`` is None) is
    filled in place, other tensors become new ones on ``device``."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / _MANIFEST).read_text())
    metas: Dict[str, dict] = dict(zip(manifest["paths"], manifest["leaves"]))
    want = _leaves(like)
    if set(want) != set(metas) or len(metas) != len(manifest["leaves"]):
        missing = sorted(set(want) - set(metas))[:5]
        extra = sorted(set(metas) - set(want))[:5]
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected "
            f"{len(want)} — architecture mismatch (missing {missing}, "
            f"unexpected {extra})")
    loaded: Dict[str, torch.Tensor] = {}
    for path, entries in want.items():
        meta = metas[path]
        src = _load(d / meta["file"], meta["dtype"])
        idx0, leaf0 = entries[0]
        inner = tuple(getattr(leaf0, "shape", np.shape(leaf0)))
        if idx0:
            dims = tuple(max(i[k] for i, _ in entries) + 1
                         for k in range(len(idx0)))
            inner = dims + inner
        if tuple(src.shape) != inner:
            raise ValueError(f"shape mismatch {tuple(src.shape)} != {inner} "
                             f"for {meta['file']} ({path})")
        loaded[path] = src

    def visit(path, idx, leaf):
        return _restore_leaf(loaded[path][idx] if idx else loaded[path],
                             leaf, device)

    out = _walk(like, visit)
    loaded.clear()
    return out


def _gc(root: Path, keep: int) -> None:
    root = Path(root)
    steps = sorted(
        int(d.name.split("_")[1]) for d in root.iterdir()
        if d.is_dir() and d.name.startswith("step_")
        and not d.name.endswith(".tmp") and (d / _MANIFEST).exists())
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(root / f"step_{s:08d}", ignore_errors=True)
    for d in root.iterdir():              # orphaned tmp dirs from crashes
        if d.name.endswith(".tmp"):
            shutil.rmtree(d, ignore_errors=True)


class CheckpointManager:
    """Async save + retention + restore-latest, one outstanding save.

    ``last_snapshot_s`` (the copy to host memory on the caller's thread),
    ``last_write_s`` (the background thread's files, commit and retention)
    and ``last_restore_s`` time the latest save and restore."""

    def __init__(self, root: Path, keep: int = 3):
        self.root = Path(root)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_snapshot_s: Optional[float] = None
        self.last_write_s: Optional[float] = None
        self.last_restore_s: Optional[float] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> None:
        self.wait()
        t0 = time.perf_counter()
        # Snapshot to host memory NOW, so the step loop can overwrite its
        # tensors in place as soon as this returns.
        leaves = host_leaves(tree)
        self.last_snapshot_s = time.perf_counter() - t0

        def _run():
            t1 = time.perf_counter()
            try:
                _write(self.root, step, leaves, extra)
                _gc(self.root, self.keep)
            except Exception as e:          # surfaced on the next wait()
                self._error = e
            self.last_write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def restore_latest(self, like: Any, device=None
                       ) -> Optional[Tuple[int, Any]]:
        step = latest_step(self.root)
        if step is None:
            return None
        t0 = time.perf_counter()
        out = restore_checkpoint(self.root, like, step, device)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.last_restore_s = time.perf_counter() - t0
        return step, out
