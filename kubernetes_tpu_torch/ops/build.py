"""Building the hand-written CUDA kernels: each source under ``csrc/``
is compiled by ``nvcc`` for sm_90a into a shared library with a plain C
interface (loaded with ctypes by its wrapper), under ``build/``, named by
the hash of the source and the flags, so an edited source rebuilds.
ptxas's report (registers, shared memory and spills of each kernel) is
kept beside each library. ``build_kernels`` starts one ``nvcc`` a source,
all at once, and waits for them together."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
# no FMA contraction: the float scores are summed in the reference's
# order with one rounding a step
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc(source: Path) -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found: {source.name} is built with "
                           "the CUDA toolkit")
    return path


def library_path(source: Path) -> Path:
    """The library ``source`` builds into."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def ptxas_report_path(lib: Path) -> Path:
    """Where ptxas's report for ``lib`` is kept."""
    return lib.with_suffix(".ptxas.txt")


def build_kernels(sources: Sequence[Path]) -> List[Path]:
    """Build every source not built yet, one ``nvcc`` each, all started
    together; returns the libraries' paths in the sources' order. Raises
    RuntimeError naming each source that failed."""
    libs = [library_path(Path(s)) for s in sources]
    running = []
    for source, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(Path(source)), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{err}")
            continue
        ptxas_report_path(lib).write_text(err)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build_kernel(source: Path) -> Path:
    """``build_kernels`` of one source."""
    return build_kernels([source])[0]
