"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/repro_torch/lib<name>-<hash>.so`` at the repository
root (a directory ``.gitignore`` lists).  The hash covers the source, the
shared headers ``csrc/*.cuh`` and the compiler flags, so an edited source or
header is rebuilt and a built one is reused.
``nvcc`` exists only where the card is; nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: flags every source is compiled with.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags of one source on top of those: event_apply is bit-exact against its
#: plain version, so ``-fmad=false`` keeps a*b+c two roundings there;
#: ssd_scan is held to a tolerance and keeps the contracted FMAs.
SOURCE_FLAGS = {"event_apply": ("-fmad=false",)}


def flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path.

    Raises with the compiler's output if ``nvcc`` fails.  The ``ptxas``
    register/shared-memory report is kept beside the library as
    ``<lib>.log``.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    out.with_name(out.name + ".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    return ctypes.CDLL(str(build(name)))
