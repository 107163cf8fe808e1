"""Build the port's native code at first use.

Two builds, both into ``BUILD_DIR`` (listed in ``.gitignore``) and both
keyed by a hash of their sources and flags, so a changed source rebuilds
and an unchanged one is reused:

* the CUDA kernels: each ``csrc/*.cu`` becomes its own shared library with
  a plain C interface, compiled by ``nvcc`` for ``sm_90a``.  All sources
  compile in parallel, one ``nvcc`` each.  A failed build raises with the
  compiler's output; there is no fallback.
* the host library: ``native/aligner.cc`` and ``native/packer.cc`` (the
  gapped aligner and the LPT lane packer, shared with the JAX package's
  sources) compiled by ``g++`` without ``-march=native``, so the library
  runs on any x86-64 host.  Where it cannot be built, callers keep their
  NumPy host paths.

A file lock serializes concurrent builds (test workers, several
processes of one run) on the same directory.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess

__all__ = ["BUILD_DIR", "KERNEL_SOURCES", "NVCC_FLAGS", "build_kernels",
           "cuda_tool", "kernel_library", "native_library"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")

# one shared library per kernel source; headers are hashed into each
KERNEL_SOURCES = ("dprofile", "hint", "wavefront", "carry_rows", "segment",
                  "peak")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
NATIVE_SOURCES = ("aligner.cc", "packer.cc")

_kernel_paths: dict[str, str] | None = None


def _digest(paths, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _locked():
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def cuda_tool(name: str) -> str | None:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): under CUDA_HOME
    (default /usr/local/cuda), else on PATH; None when missing."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", name)
    return cand if os.path.exists(cand) else shutil.which(name)


def _nvcc() -> str:
    found = cuda_tool("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels are built from "
                           f"{CSRC} at first use")
    return found


def build_kernels() -> dict[str, str]:
    """Build every kernel library that is missing; return name -> path.

    The nvcc processes run concurrently, so the build takes as long as
    the slowest source."""
    global _kernel_paths
    if _kernel_paths is not None:
        return _kernel_paths
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cuh"))
    paths = {}
    for name in KERNEL_SOURCES:
        src = os.path.join(CSRC, name + ".cu")
        key = _digest([src] + headers, NVCC_FLAGS)
        paths[name] = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    with _locked():
        todo = [n for n, p in paths.items() if not os.path.exists(p)]
        if todo:
            nvcc = _nvcc()
            procs = []
            for name in todo:
                tmp = paths[name] + f".tmp{os.getpid()}"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC, name + ".cu")]
                procs.append((name, tmp, cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            failed = []
            for name, tmp, cmd, proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"$ {' '.join(cmd)}\n"
                                  f"{out.decode(errors='replace')}")
                    continue
                os.replace(tmp, paths[name])
            if failed:
                raise RuntimeError("CUDA kernel build failed:\n"
                                   + "\n".join(failed))
    _kernel_paths = paths
    return paths


def kernel_library(name: str) -> str:
    """Path of the built shared library for kernel source ``name``."""
    return build_kernels()[name]


def native_library() -> str | None:
    """Path of the host library (aligner + packer), building it if
    needed; None when its sources or g++ are missing or the build
    fails."""
    srcs = [os.path.join(NATIVE_DIR, s) for s in NATIVE_SOURCES]
    gxx = shutil.which(os.environ.get("CXX", "g++"))
    if gxx is None or not all(os.path.exists(s) for s in srcs):
        return None
    path = os.path.join(BUILD_DIR,
                        f"libswipe_native-{_digest(srcs, GXX_FLAGS)}.so")
    with _locked():
        if not os.path.exists(path):
            tmp = path + f".tmp{os.getpid()}"
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, *srcs],
                                  capture_output=True)
            if proc.returncode != 0:
                return None
            os.replace(tmp, path)
    return path
