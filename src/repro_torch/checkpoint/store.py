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

One writer serves one card and a mesh: each leaf's file is created at
its full shape, the blocks a rank owns are written into it at their
offsets, and the leaves are checksummed, the manifest written and the
directory renamed.  On one card the one process owns every leaf whole.

**On a mesh** (``specs``, a tree of the leaves' layouts, and ``mesh``;
collective) the same layout holds the same full leaves.  Rank 0 creates
each leaf's file at its full shape; after a barrier every rank writes the
blocks it owns into them at their offsets (``np.lib.format.open_memmap``:
the ranks share one filesystem; a block replicated over some axes is
written by the first rank along them); after a second barrier rank 0
checksums the leaves, writes the manifest and renames, and a third
barrier returns only once the step is committed.  No collective carries
the state.  ``restore`` with ``specs`` reads each rank its own blocks.
A checkpoint written on a mesh restores on one card and in the
reference's ``restore``, and the other way round.
``AsyncCheckpointer(..., mesh=)`` runs those barriers on a gloo group of
its own, from its writer thread, so they never interleave with the
step's collectives; its credits bound each rank's snapshots as on one
card, and its ``fence`` returns once every submitted step is committed.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer",
           "verify_manifest"]

_SEP = "__"  # flat key separator: ("a", "b") -> "a__b"
_BF16 = "bfloat16"


def _to_numpy(leaf) -> np.ndarray:
    """The array written to disk (a bf16 tensor as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _stored(leaf) -> Tuple[np.dtype, str]:
    """(the numpy dtype written to disk, the manifest's dtype name) of a
    leaf, without copying it."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return np.dtype(np.uint16), _BF16
        dt = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return dt, dt.name
    dt = np.asarray(leaf).dtype
    return dt, dt.name


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
         extra: Optional[Dict] = None, specs: Any = None, mesh=None,
         group=None) -> Path:
    """Atomic synchronous save of ``tree`` at ``step``.  On a mesh
    (``specs`` and ``mesh``; collective over ``group``, default the
    world; a mesh on some ranks of the world needs a group over them)
    ``tree`` holds this rank's blocks (module docstring)."""
    plan = _plan(tree, specs, mesh)
    return _save_blocks(Path(root), step, plan, _snapshot(tree, plan),
                        extra, mesh, group)


def _plan(tree, specs, mesh) -> List[Dict]:
    """Per leaf of ``tree``: its key, file, full shape, stored dtype, the
    slices of it that ``tree`` holds, and whether this rank writes them.
    Without a mesh every leaf is whole and written; on one, ``tree``
    holds this rank's blocks and ``specs`` mirrors it (a missing or empty
    spec is a replicated leaf, which rank 0 writes)."""
    from repro_torch.parallel.sharding import block_of, spec_axes
    flat_specs = _flatten(specs) if isinstance(specs, dict) else {}
    out = []
    for key, leaf in _flatten(tree).items():
        shape, where, owner = tuple(np.shape(leaf)), (), True
        if mesh is not None:
            spec = tuple(flat_specs.get(key) or ())
            shape, where = block_of(mesh, spec, shape)
            owner = all(mesh.index(a) == 0 for a in mesh.axis_names
                        if a not in spec_axes(spec))
        dtype, name = _stored(leaf)
        out.append(dict(key=key, file=f"{key.replace('/', '@')}.npy",
                        shape=shape, dtype=dtype, name=name, where=where,
                        owner=owner))
    return out


def _snapshot(tree, plan) -> Dict[str, np.ndarray]:
    """Host copies of the blocks this rank writes (taken now, so that no
    later in-place update of the parameters leaks into the write)."""
    flat = _flatten(tree)
    out = {}
    for p in plan:
        if p["owner"]:
            out[p["key"]] = np.array(_to_numpy(flat[p["key"]]), copy=True)
    return out


def _save_blocks(root: Path, step: int, plan, blocks, extra,
                 mesh=None, group=None) -> Path:
    """Write ``blocks`` into the leaves' files of ``step_N.tmp`` at their
    offsets, then checksum, write the manifest and rename (the mesh's
    first rank); on a ``mesh`` barriers over ``group`` between the
    phases."""
    collective = mesh is not None

    def barrier():
        if collective:
            dist.barrier(group=group)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    rank0 = not collective or dist.get_rank() == mesh.ranks[0]
    if rank0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for p in plan:
            np.lib.format.open_memmap(tmp / p["file"], mode="w+",
                                      dtype=p["dtype"],
                                      shape=p["shape"]).flush()
    barrier()
    for p in plan:
        if p["key"] in blocks:
            mm = np.lib.format.open_memmap(tmp / p["file"], mode="r+")
            mm[p["where"]] = blocks[p["key"]]
            mm.flush()
            del mm
    barrier()
    if rank0:
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for p in plan:
            raw = np.load(tmp / p["file"], mmap_mode="r")
            manifest["leaves"][p["key"]] = {
                "file": p["file"], "shape": list(p["shape"]),
                "dtype": p["name"], "crc32": _crc(raw)}
            del raw
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():  # overwrite-retry after a partial failure
            shutil.rmtree(final)
        tmp.rename(final)   # the commit point
    barrier()
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
            device=None, verify: bool = True, specs: Any = None,
            mesh=None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (nested dicts of
    tensors, e.g. on the ``meta`` device), each leaf as a tensor of the
    leaf's dtype on ``device`` (the CPU by default).  On a mesh
    (``specs`` mirroring ``tree_like``, whose leaves then have the full
    shapes, and ``mesh``) each leaf is this rank's block of it.  Returns
    (tree, step, extra)."""
    from repro_torch.parallel.sharding import block_of
    flat_specs = _flatten(specs) if isinstance(specs, dict) else {}
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
        raw = np.load(d / meta["file"],
                      mmap_mode=None if mesh is None else "r")
        if verify:
            _check_leaf(key, meta, raw)
        if mesh is not None:
            spec = tuple(flat_specs.get(key) or ())
            parts, _ = block_of(mesh, spec, (1,) * len(like.shape))
            block = tuple(n // k for n, k in zip(like.shape, parts))
            raw = np.array(raw[block_of(mesh, spec, block)[1]])
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

    def __init__(self, root: os.PathLike, credits: int = 2, mesh=None):
        self.root = Path(root)
        self.mesh = mesh
        # collective over the world: every rank builds its checkpointer at
        # the same point, a rank outside the mesh too (it submits nothing)
        self._group = None if mesh is None else dist.new_group(
            ranks=list(mesh.ranks), backend="gloo")
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
            step, (plan, blocks), extra = item
            try:
                _save_blocks(self.root, step, plan, blocks, extra,
                             self.mesh, self._group)
            except Exception as e:  # surfaced at next submit/fence
                self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, step: int, tree: Any, extra: Optional[Dict] = None,
               specs: Any = None):
        """Snapshot ``tree`` and queue its save (blocks while every credit
        is in flight).  On a mesh ``tree`` holds this rank's blocks laid
        out by ``specs``; every rank submits the same steps."""
        if self._errors:
            raise self._errors.pop(0)
        plan = _plan(tree, specs, self.mesh)
        self._q.put((step, (plan, _snapshot(tree, plan)), extra))

    def fence(self):
        self._q.join()
        if self._errors:
            raise self._errors.pop(0)

    def close(self):
        self.fence()
        self._q.put(None)
        self._thread.join()
