"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` (the H100) into ``build/kernels/lib<name>-<digest>.so`` at
the root of the checkout; the digest covers the source, every shared header
``csrc/*.cuh`` (by name and content) and the flags, so an edited source or
header never loads a stale library. Headers reached through a ``-I`` path in
the flags (the toolkit's, CUTLASS's) enter the digest by that path only. A build writes to a temporary
name and renames it into place, so two processes that build at once both
end with a whole library. :func:`build` starts one ``nvcc`` per missing
source at once and waits for all of them.

Nothing here runs at import: the CPU-only installs that run the tests
never call it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "load", "build_log", "BUILD_DIR", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
_logs = {}


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _target(name):
    src = CSRC / (name + ".cu")
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(b"\0" + hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / ("lib%s-%s.so" % (name, h.hexdigest()[:16]))


def build(names):
    """Compile every missing library of ``names`` in parallel (one ``nvcc``
    each); returns ``{name: path}``. Raises with the compiler's output when
    a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    out = {}
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_name(lib.name + ".%d.tmp" % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        _logs[name] = log
        if proc.returncode != 0:
            failed.append("%s:\n%s" % (name, log))
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name):
    """The ctypes handle of ``lib<name>``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def build_log(name):
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the build this process ran for ``name``; empty when the
    library was already on disk."""
    return _logs.get(name, "")
