"""Build and load the port's CUDA kernel library.

Every ``*.cu`` source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
at first use, each source by its own ``nvcc`` process (all started
together), and the objects are linked into one shared library with a plain
C interface in ``build/sgmcmc_tpu_torch/`` beside the package.  The
library's name carries a hash of every source and header in ``csrc/`` and
of the flags, so an edited source builds anew.  The wrappers bind their
entry points with ``ctypes``; nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "sgmcmc_tpu_torch"
# --fmad=false: the fused window's model body rounds after every operation,
# as PyTorch's elementwise operators do, so kernel and plain version pick
# the same ancestors (see the note at the top of csrc/fused_window.cu).
# It changes nothing in the resample-apply kernel, which only copies.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")
# Dynamic shared memory one block may use on Hopper.
SMEM_LIMIT = 232448


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def sources() -> list[Path]:
    """The ``.cu`` files compiled into the library, in name order."""
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libsgmcmc_kernels_{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    """Compiler output of the build (``ptxas -v`` lines included)."""
    return library_path().with_suffix(".log")


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = so.with_name(f"{tag}.tmp")
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                            *map(str, objs)],
                           capture_output=True, text=True)
        log.append(f"== link\n{r.stdout}{r.stderr}")
        if r.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                           + "".join(log))


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    lib.sgmcmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgmcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + load_library().sgmcmc_cuda_error_string(
                               rc).decode())
