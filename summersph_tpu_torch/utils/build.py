"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

The library is built at first use into `summersph_tpu_torch/_build/`
(listed in .gitignore) under a file name that carries a hash of the
sources and flags, so a changed source builds anew and an unchanged one is
loaded as it is.  The sources have a plain `extern "C"` interface and
include no PyTorch header, which keeps the build to seconds.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise BuildError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                     "/usr/local/cuda/bin; the CUDA pair kernels need it")


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu lives for the current
    sources and flags."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the hashed library exists.  The
    compiler's output (ptxas register and spill counts) is kept beside the
    library in a `.log` file."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                         f"{res.stdout}\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """The compiler output kept by `build` (empty if it kept none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one handle per process."""
    return ctypes.CDLL(str(build(name)))


__all__ = ["BuildError", "build", "build_log", "find_nvcc", "library_path",
           "load"]
