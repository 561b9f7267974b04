"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``lib<name>-<digest>.so`` in :func:`build_dir` (``build/kernels``
of the checkout when the package runs from its ``src/``), where
``<digest>`` hashes the kernel sources (every ``.cu`` and ``.cuh`` under
``csrc/``) and the compiler flags.  A library is built at its first use
and reused while the sources are unchanged; ``build/`` is not committed.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together.  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["CSRC", "NVCC_FLAGS", "build_dir", "nvcc", "library_path",
           "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def build_dir() -> Path:
    """Where the libraries go: ``$REPRO_TORCH_BUILD_DIR`` when set; else
    ``build/kernels`` of the checkout when the package runs from the
    checkout's ``src/``; else ``~/.cache/repro_torch/kernels`` (an
    installed copy)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
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


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest()}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Build the libraries of ``names`` that are missing, one ``nvcc`` per
    source, all started together; returns ``{name: library path}``.

    Each build writes to a temporary file that is renamed into place, so
    concurrent builders never load a half-written library.  The compiler's
    output (``-Xptxas -v``: registers, spills) is kept beside the library
    as ``<library>.log``."""
    out = {n: library_path(n) for n in names}
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
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))
