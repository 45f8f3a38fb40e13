"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` (CUDA, compiled by ``nvcc`` for ``sm_90a``) or
``csrc/<name>.cpp`` (host code, compiled by ``g++ -march=native``)
exports plain-C functions. It is compiled on first use into
``csrc/build/`` (listed in .gitignore) under a file name that carries a
hash of the source and the flags, and for g++ of the CPU that
``-march=native`` resolves to, so an edited source is never served a
stale library and a host library built for one CPU is never loaded on
another. The library is written under a temporary name and renamed into
place, so concurrent builds need no lock file. A failed build raises,
naming the compiler: nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX = "g++"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are built on the machine with the card")
    return found


def _gxx() -> str:
    found = shutil.which(GXX)
    if found is None:
        raise RuntimeError(f"g++ not found ({GXX!r}): the port's host "
                           "library (csrc/hostops.cpp) is built with g++")
    return found


@functools.cache
def _native_arch(gxx: str) -> str:
    """What ``-march=native`` means on this machine, as g++ reports it."""
    proc = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ ({gxx}) failed to report -march=native:\n"
                           f"{proc.stderr}")
    return " ".join(line.split()[-1] for line in proc.stdout.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def _source(name: str) -> str:
    cu = os.path.join(CSRC_DIR, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC_DIR,
                                                      f"{name}.cpp")


def _command(src: str) -> Tuple[str, ...]:
    """The compiler and its flags for ``src``, without the file names."""
    if src.endswith(".cu"):
        return (_nvcc(),) + NVCC_FLAGS
    return (_gxx(),) + GXX_FLAGS


def library_path(name: str) -> str:
    src = _source(name)
    cmd = _command(src)
    key = hashlib.sha256()
    with open(src, "rb") as f:
        key.update(f.read())
    key.update(" ".join(cmd[1:]).encode())
    if not src.endswith(".cu"):
        key.update(_native_arch(cmd[0]).encode())
    return os.path.join(BUILD_DIR, f"{name}-{key.hexdigest()[:16]}.so")


def build_library(name: str) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless its library exists.

    Returns (library path, the compiler's output: for nvcc the ``-Xptxas
    -v`` register and shared-memory report; empty when the library was
    already built).
    """
    out = library_path(name)
    if os.path.exists(out):
        return out, ""
    src = _source(name)
    cmd = _command(src)
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, src], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed on "
                f"csrc/{os.path.basename(src)}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>``'s library."""
    path, _ = build_library(name)
    return ctypes.CDLL(path)
