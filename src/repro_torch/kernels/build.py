"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``lib<name>-<digest>.so`` in :func:`build_dir` (``build/kernels``
of the checkout when the package runs from its ``src/``), where
``<digest>`` hashes the kernel sources (every ``.cu`` and ``.cuh`` under
``csrc/``) and the compiler flags.  A library is built at its first use
and reused while the sources are unchanged; ``build/`` is not committed.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together.  :func:`load` keeps one loaded library per name and
directory, and :func:`cache_stats` says what this process did with a
directory: the libraries it built there and those it found built and
loaded.  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

__all__ = ["CSRC", "NVCC_FLAGS", "build_dir", "using_build_dir", "nvcc",
           "library_path", "build", "load", "cache_stats"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# per build directory: libraries this process built there with nvcc, and
# libraries it loaded from there without building them
_STATS: Dict[Path, Dict[str, int]] = {}

# the directory of the innermost using_build_dir() block, if any
_SCOPED: contextvars.ContextVar[Optional[Path]] = contextvars.ContextVar(
    "repro_torch_build_dir", default=None)


def build_dir() -> Path:
    """Where the libraries go: inside a :func:`using_build_dir` block its
    directory; else ``$REPRO_TORCH_BUILD_DIR`` when set; else
    ``build/kernels`` of the checkout when the package runs from the
    checkout's ``src/``; else ``~/.cache/repro_torch/kernels`` (an
    installed copy)."""
    scoped = _SCOPED.get()
    if scoped is not None:
        return scoped
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _default_build_dir()


@contextlib.contextmanager
def using_build_dir(directory) -> Iterator[None]:
    """Within the block, :func:`build_dir` is ``directory`` (``None``:
    left as it is); the setting ends with the block."""
    if directory is None:
        yield
        return
    token = _SCOPED.set(Path(directory))
    try:
        yield
    finally:
        _SCOPED.reset(token)


@functools.lru_cache(maxsize=None)
def _default_build_dir() -> Path:
    src = Path(__file__).resolve().parents[2]
    if src.name == "src" and (src.parent / "pyproject.toml").exists():
        return src.parent / "build" / "kernels"
    return Path.home() / ".cache" / "repro_torch" / "kernels"


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin); the CUDA kernels are built from source at "
        "first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _count(directory: Path, what: str) -> None:
    stats = _STATS.setdefault(Path(directory), {"built": 0, "loaded": 0})
    stats[what] += 1


def library_path(name: str, directory=None) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives in ``directory``
    (default :func:`build_dir`)."""
    return Path(directory or build_dir()) / f"lib{name}-{_digest()}.so"


def build(names: Sequence[str], directory=None) -> Dict[str, Path]:
    """Build the libraries of ``names`` that are missing from
    ``directory`` (default :func:`build_dir`), one ``nvcc`` per source,
    all started together; returns ``{name: library path}``.

    Each build writes to a temporary file that is renamed into place, so
    concurrent builders never load a half-written library.  The compiler's
    output (``-Xptxas -v``: registers, spills) is kept beside the library
    as ``<library>.log``."""
    out = {n: library_path(n, directory) for n in names}
    for lib in out.values():
        lib.parent.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no CUDA source {src}")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, cmd)
    failed = []
    for name, (proc, tmp, cmd) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{' '.join(cmd)}\n{log}")
            continue
        Path(str(out[name]) + ".log").write_text(log)
        os.replace(tmp, out[name])
        _count(out[name].parent, "built")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str, directory=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` in ``directory`` (default
    :func:`build_dir`), built there first if needed; loaded once per name
    and directory."""
    return _load(name, Path(directory) if directory is not None
                 else build_dir())


@functools.lru_cache(maxsize=None)
def _load(name: str, directory: Path) -> ctypes.CDLL:
    if library_path(name, directory).exists():
        _count(directory, "loaded")
    return ctypes.CDLL(str(build([name], directory)[name]))


def cache_stats(directory=None) -> Dict[str, object]:
    """What this process did with the build directory ``directory``
    (default :func:`build_dir`): ``built``, the libraries it built there
    with ``nvcc``; ``loaded``, those it found already built and loaded;
    ``entries``, the libraries the directory holds now."""
    d = Path(directory) if directory is not None else build_dir()
    stats = _STATS.get(d, {"built": 0, "loaded": 0})
    return {"dir": str(d), "built": stats["built"],
            "loaded": stats["loaded"],
            "entries": len(list(d.glob("lib*.so"))) if d.is_dir() else 0}
