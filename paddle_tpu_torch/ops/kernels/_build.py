"""Build and load the hand-written CUDA kernels.

Each source `csrc/<name>.cu` exports a plain C interface and is compiled
with ``nvcc`` into its own shared library, then loaded with `ctypes` —
no PyTorch headers, so a build takes seconds. Libraries land in
``build/paddle_tpu_torch/<key>/`` at the root of the checkout, where
``<key>`` hashes the source, the shared ``csrc/*.cuh`` headers, the flags
and the compiler, so an unchanged tree never rebuilds and a changed one
never loads a stale library.

Nothing here runs at import: the first `load` builds. A missing ``nvcc``
or a failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under $CUDA_HOME (default
    /usr/local/cuda). Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME: the CUDA toolkit is "
        "needed to build paddle_tpu_torch's kernels")


def _lib_path(name: str, nvcc: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared by several sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc for `name` unless its library is already built;
    returns (final path, Popen or None, temporary output path)."""
    out = _lib_path(name, nvcc)
    if out.is_file():
        return out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Build the named sources, all nvcc processes started together.
    Writes each compiler log (registers, spills: ``-Xptxas -v``) beside
    its library as ``<lib>.log``. Raises on the first failed build."""
    nvcc = nvcc_path()
    jobs = [(n, *_start(n, nvcc)) for n in names]
    failures: List[str] = []
    paths: Dict[str, Path] = {}
    for name, out, proc, tmp in jobs:
        paths[name] = out
        if proc is None:
            continue
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a concurrent loader never
    if failures:                    # sees a half-written library
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first if
    needed. The caller declares `argtypes`/`restype` on its functions."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def sources() -> List[str]:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
