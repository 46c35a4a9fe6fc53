"""Build the CUDA sources under ``csrc/`` into shared libraries, at first use.

Each library is compiled by ``nvcc`` with a plain C interface and loaded
with ctypes. It lands in ``build/kernels/`` at the root of the checkout,
named by a hash of its source, every header it includes from ``csrc/``
(``#include "..."``, followed recursively) and the flags, so a changed
source or header is rebuilt and an unchanged one is reused. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No fused multiply-add (the plain PyTorch versions round every product and
# sum separately) and no --use_fast_math (exact division and sqrt).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}     # library name -> nvcc output of its build


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of limg_tpu_torch are built from source at first use")


def source_files(src: Path, csrc: Path | None = None) -> list[Path]:
    """``src`` and every file it includes from ``csrc`` (default
    ``csrc/``), recursively."""
    csrc = csrc or CSRC
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (csrc / inc).exists():
                todo.append(csrc / inc)
    return sorted(seen)


def source_digest(name: str, csrc: Path | None = None) -> str:
    """Hash of ``<csrc>/<name>.cu`` (default ``csrc/``), its included
    headers and the flags."""
    csrc = csrc or CSRC
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(csrc / f"{name}.cu", csrc):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return digest.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed, load it, and return the handle."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}_{source_digest(name)}.so"
    if not out.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{build_log[name]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib
