"""Shared kernel plumbing: tiling helpers and the CUDA build.

The reference chooses between a TPU kernel and Pallas interpret mode by
backend (``repro.kernels.common.use_interpret``).  The port has no such
switch: the device of the input tensor decides.  A CPU tensor runs the
kernel's plain torch version; a CUDA tensor launches the CUDA kernel or
raises.

Kernels are CUDA C++ sources under ``repro_torch/csrc`` with a plain C
interface.  :func:`load_library` compiles them with ``nvcc`` for Hopper
(``sm_90a``) at first use — every source at once, one ``nvcc`` each, in
parallel — into a build directory beside the package, named by a hash of
the source and of the shared headers (``csrc/*.cuh``) so that an edited
source or header is rebuilt, and loads one of them through ``ctypes``.
Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

#: CUDA C++ sources of every kernel of the port.
CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
#: Where the compiled libraries go (listed in the repository's .gitignore).
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: Shared memory one block may use on Hopper (bytes): 227 KB.
MAX_SHARED_BYTES = 232448

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def batch_tile(n: int, elem_bytes: int, *, smem_budget: int = 64 * 2**10,
               buffers: int = 2, override: int | None = None) -> int:
    """Transforms per thread block keeping ``buffers`` copies of (tile, n)
    within ``smem_budget`` bytes of shared memory (at least one).

    The budget leaves room for three blocks on one SM's 227 KB.
    ``override`` short-circuits the heuristic with an explicit tile (the
    autotuner's tuned choice, ``repro_torch.tune``), validated positive.
    """
    if override is not None:
        if override < 1:
            raise ValueError(f"batch tile override must be >= 1, "
                             f"got {override}")
        return override
    return max(smem_budget // (n * elem_bytes * buffers), 1)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "repro_torch are compiled on the machine with the card")
    return path


def _library_path(source: Path) -> Path:
    """Where ``source`` is built: named by a hash of the source, every
    header under ``csrc/`` (a source may include any of them) and the
    flags, so that editing any of them builds a new library."""
    h = hashlib.blake2b(source.read_bytes(), digest_size=8)
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()}.so"


@functools.cache
def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built, all ``nvcc`` runs at once.

    Returns {source stem: library path}.  Raises with the compiler's
    output when a source does not compile.  ``nvcc``'s ``-Xptxas -v``
    report (registers, shared memory, spills) is kept beside each library
    as ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: _library_path(src) for src in sorted(CSRC_DIR.glob("*.cu"))}
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        out = libs[src.stem]
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


@functools.cache
def load_library(stem: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<stem>.cu`` (built on first use)."""
    return ctypes.CDLL(str(build_all()[stem]))
