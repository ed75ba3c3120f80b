"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on its
own for ``sm_90a`` into ``build/repro_torch/lib<name>-<hash>.so`` at the
root of the checkout (a directory ``.gitignore`` lists), the first time a
wrapper needs it; the hash covers the source, the ``csrc/*.cuh`` headers
it includes (``#include "name.cuh"``) and the flags, so an edited source
or header is rebuilt. Libraries are loaded with ``ctypes``: no PyTorch
headers are compiled, which keeps a build to seconds. Nothing is built
when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "KERNEL_SOURCES", "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNEL_SOURCES = (
    "klms_bank", "bank_predict", "krls_bank", "krls_compact", "rff_features",
    "rff_scan", "rff_attention", "flash_attention", "flash_attention_sm90",
)

# No -use_fast_math: |x W + b| runs far outside [-pi, pi], where the fast
# __cosf loses accuracy; the kernels call the IEEE cosf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the repro_torch CUDA kernels are built on the "
        "machine with the card (CUDA toolkit on PATH or in /usr/local/cuda)"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def _sources(path: Path, seen=None) -> list[Path]:
    """``path`` and every ``csrc`` header it includes, directly or through
    another header, each once, in the order first reached."""
    seen = [] if seen is None else seen
    seen.append(path)
    for name in _INCLUDE.findall(path.read_bytes()):
        header = CSRC / name.decode()
        if header not in seen:
            _sources(header, seen)
    return seen


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu"):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once. Returns the wall seconds per library (0.0
    for one already built). Raises with the compiler's output on failure;
    the ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            target,
        )
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if needed.

    ``signatures`` maps each exported C function to its ``argtypes``; every
    function returns a ``cudaError_t`` as a C int.
    """
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in signatures.items():
            cfn = getattr(lib, fn)
            cfn.argtypes = list(argtypes)
            cfn.restype = ctypes.c_int
        _libs[name] = lib
    return lib
