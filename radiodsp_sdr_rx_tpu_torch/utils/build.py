"""Build the port's CUDA sources with plain ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers and includes no
PyTorch header, so one ``nvcc`` call builds it in seconds. The shared library
goes to ``_build/`` beside the package (listed in ``.gitignore``), named by a
hash of the source, of every ``csrc/`` header it includes (``#include
"..."``, followed through headers) and of the flags: it is rebuilt when any
of them changes. Nothing is built at import; the first launch builds.

``build_host_library`` is the same for host C++ (``csrc/<name>.cpp``, no CUDA),
built with ``g++``: the native IQ ring of ``utils/native_io.py``, the port's
copy of the JAX package's ``native/rdsp_io.cpp``, which it never builds in
place.
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

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
GXX_LIBS = ("-lpthread",)

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


def _compile(so: Path, cmd_of, what: str) -> None:
    """Run the compiler command ``cmd_of(tmp)`` into a temporary name beside
    ``so``, keep its output in ``so``'s ``.log``, and move it in place."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = cmd_of(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} exited {proc.returncode} building {what}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hash is new, then load it (once per process)."""
    if name in _LIBS:
        return _LIBS[name]
    so = _artifact(name)
    if not so.exists():
        _compile(so, lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                  str(CSRC / f"{name}.cu")], f"{name}.cu")
    _LIBS[name] = ctypes.CDLL(str(so))
    return _LIBS[name]


def host_artifact(name: str) -> Path:
    """Where ``csrc/<name>.cpp`` builds: ``_build/lib<name>-<hash>.so``, the
    hash of the source and the g++ flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    digest.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_host_library(name: str) -> Path:
    """Build ``csrc/<name>.cpp`` with g++ if its hash is new; its path."""
    so = host_artifact(name)
    if not so.exists():
        _compile(so, lambda tmp: ["g++", *GXX_FLAGS, "-o", str(tmp),
                                  str(CSRC / f"{name}.cpp"), *GXX_LIBS], f"{name}.cpp")
    return so
