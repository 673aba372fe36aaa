"""Build the port's CUDA sources with plain ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers and includes no
PyTorch header, so one ``nvcc`` call builds it in seconds. The shared library
goes to ``_build/`` beside the package (listed in ``.gitignore``), named by a
hash of the source, of every ``csrc/`` header it includes (``#include
"..."``, followed through headers) and of the flags: it is rebuilt when any
of them changes. Nothing is built at import; the first launch builds.
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
BUILD_DIR = CSRC.parent / "_build"
# -Xptxas -v writes registers, shared memory and spills to the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "toolkit is needed to build the port's kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header under ``csrc/`` it includes,
    directly or through another header, in the order first met."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = (path.parent / inc.decode()).resolve()
            if header not in found:
                found.append(header)
    return found


def _artifact(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output from the build of ``csrc/<name>.cu``."""
    return _artifact(name).with_suffix(".log").read_text()


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hash is new, then load it (once per process)."""
    if name in _LIBS:
        return _LIBS[name]
    so = _artifact(name)
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc exited {proc.returncode} building {name}.cu:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    _LIBS[name] = ctypes.CDLL(str(so))
    return _LIBS[name]
