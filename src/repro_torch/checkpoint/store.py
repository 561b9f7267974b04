"""Checkpointing with atomic commits and credit-bounded async saves (the
port's counterpart of ``repro.checkpoint.store``, same on-disk layout).

Layout (one directory per step):

    <root>/step_<N>/
        manifest.json            # leaves: file, shape, dtype, crc32
        <leaf-name>.npy          # one file per leaf (full array)

A tree is nested dicts of tensors (or numpy arrays); a leaf's name is its
keys joined by ``__`` (the reference's, which flattens its pytree with
sorted dict keys), with ``/`` written ``@`` in the file name.  What the
reference keeps, the port keeps:

* **atomicity** — writes go to ``step_N.tmp/`` and the directory is
  renamed only after every leaf and the fsync'd manifest are written; a
  crashed save can never be mistaken for a complete one (``latest_step``
  scans for the newest *committed* step);
* **async with credits** (paper C3) — ``AsyncCheckpointer`` snapshots the
  tensors to host memory, returns, and a writer thread drains a bounded
  queue; ``fence()`` waits until every credit is back;
* **integrity** — every leaf carries a crc32 of its bytes; restore checks
  it before handing the tensors back.

bf16 has no numpy dtype: a bf16 leaf is stored as its raw ``uint16`` view
with ``"bfloat16"`` in the manifest, as the reference stores its
``ml_dtypes`` arrays, and read back by viewing the bits as
``torch.bfloat16`` (no ``ml_dtypes``).  Checkpoints written by either
package restore in the other.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer",
           "verify_manifest"]

_SEP = "__"  # flat key separator: ("a", "b") -> "a__b"
_BF16 = "bfloat16"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array written to disk, the dtype name in the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_numpy(raw: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == _BF16:
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(raw)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for k in sorted(tree):
        flat.update(_flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix
                             else str(k)))
    return flat


def _crc(raw: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(raw)) & 0xFFFFFFFF


def save(root: os.PathLike, step: int, tree: Any,
         extra: Optional[Dict] = None) -> Path:
    """Atomic synchronous save of ``tree`` at ``step``."""
    root = Path(root)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        for f in tmp.iterdir():
            f.unlink()
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        fname = f"{key.replace('/', '@')}.npy"   # keys may contain "/"
        raw, dtype_name = _to_numpy(leaf)
        np.save(tmp / fname, raw)
        manifest["leaves"][key] = {"file": fname, "shape": list(raw.shape),
                                   "dtype": dtype_name, "crc32": _crc(raw)}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():  # overwrite-retry after a partial failure
        shutil.rmtree(final)
    tmp.rename(final)   # the commit point
    return final


def latest_step(root: os.PathLike) -> Optional[int]:
    root = Path(root)
    if not root.exists():
        return None
    steps = []
    for d in root.iterdir():
        if d.is_dir() and d.name.startswith("step_") and \
                not d.name.endswith(".tmp") and (d / "manifest.json").exists():
            steps.append(int(d.name[5:]))
    return max(steps) if steps else None


def _check_leaf(key: str, meta: Dict, raw: np.ndarray) -> None:
    stored = "uint16" if meta["dtype"] == _BF16 else meta["dtype"]
    if list(raw.shape) != meta["shape"] or raw.dtype.name != stored:
        raise IOError(f"checkpoint leaf {key}: shape/dtype mismatch")
    if _crc(raw) != meta["crc32"]:
        raise IOError(f"checkpoint leaf {key}: crc mismatch "
                      f"(corrupt file {meta['file']})")


def verify_manifest(ckpt_dir: Path) -> Dict:
    """The manifest of ``ckpt_dir``, after checking every leaf's shape,
    dtype and crc32 (``IOError`` on a mismatch)."""
    with open(ckpt_dir / "manifest.json") as f:
        manifest = json.load(f)
    for key, meta in manifest["leaves"].items():
        _check_leaf(key, meta, np.load(ckpt_dir / meta["file"]))
    return manifest


def restore(root: os.PathLike, tree_like: Any, step: Optional[int] = None,
            device=None, verify: bool = True) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (nested dicts of
    tensors, e.g. on the ``meta`` device), each leaf as a tensor of the
    leaf's dtype on ``device`` (the CPU by default).  Returns (tree, step,
    extra)."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = root / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)

    def one(key, like):
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint {d} is missing leaf {key}")
        meta = manifest["leaves"][key]
        raw = np.load(d / meta["file"])
        if verify:
            _check_leaf(key, meta, raw)
        return _from_numpy(raw, meta["dtype"]).to(device=device or "cpu",
                                                  dtype=like.dtype)

    def walk(like, prefix):
        if not isinstance(like, dict):
            return one(prefix, like)
        return {k: walk(v, f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k, v in like.items()}

    return walk(tree_like, ""), step, manifest["extra"]


class AsyncCheckpointer:
    """Credit-bounded async checkpoint writer (paper C3).

    ``submit`` copies the tree to host memory and enqueues it; it blocks
    only when all ``credits`` are in flight (bounded memory — the endpoint
    FIFO rule).  ``fence`` drains outstanding writes (the store barrier:
    wait until the credit counter is back at max)."""

    def __init__(self, root: os.PathLike, credits: int = 2):
        self.root = Path(root)
        self._q: queue.Queue = queue.Queue(maxsize=credits)
        self._errors: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree, extra = item
            try:
                save(self.root, step, tree, extra)
            except Exception as e:  # surfaced at next submit/fence
                self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, step: int, tree: Any, extra: Optional[Dict] = None):
        if self._errors:
            raise self._errors.pop(0)
        # snapshot NOW (a flat dict of host copies, which saves under the
        # same names), so neither a later in-place update of the
        # parameters nor host-side mutation can leak into the write
        snap = {k: v.detach().to("cpu", copy=True)
                if isinstance(v, torch.Tensor) else np.array(v, copy=True)
                for k, v in _flatten(tree).items()}
        self._q.put((step, snap, extra))

    def fence(self):
        self._q.join()
        if self._errors:
            raise self._errors.pop(0)

    def close(self):
        self.fence()
        self._q.put(None)
        self._thread.join()
