"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into ``<repo>/build/kernels/<name>-<hash>.so`` for
``sm_90a`` (Hopper).  The hash covers the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing is built or
loaded at import time: the CPU tests import every module on a machine
without ``nvcc``.

:func:`load` builds what is missing and returns the loaded library with its
function signatures set; :func:`build_all` compiles several sources at
once, one ``nvcc`` process each.  nvcc's output (``ptxas`` register and
spill lines) is kept in :data:`BUILD_LOGS`.  :func:`current_stream`,
:func:`check_launch` and :func:`forward_only` are the wrappers' launch
helpers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# signature table: C function name -> (restype, argtypes)
Signatures = Dict[str, Tuple[object, Sequence[object]]]

_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output for the build made by this process
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built with nvcc at first use")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> None:
    """Compile every ``csrc/<name>.cu`` whose library is not current.

    One nvcc process per source, all started together.  Each writes a
    temporary file that is renamed into place when it succeeds; a failed
    build raises with nvcc's output (after every process has ended).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, path))
    failed = []
    for name, proc, tmp, path in running:
        BUILD_LOGS[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):"
                          f"\n{BUILD_LOGS[name]}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))


def current_stream(device) -> int:
    """PyTorch's current stream on ``device``, as the raw handle.

    Read with ``torch._C._cuda_getCurrentRawStream`` (the call Triton's
    launcher makes): ``torch.cuda.current_stream`` builds a ``Stream``
    object per call, several microseconds of host time per launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_launch(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def forward_only(what: str, *tensors) -> None:
    """Raise when autograd would need a backward pass through a kernel that
    has none (the reference's attention and WKV kernels are forward-only)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward pass; call it on tensors "
                           "that do not require grad (or under torch.no_grad)")


def load(name: str, signatures: Signatures) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = list(argtypes)
        _LOADED[name] = lib
    return lib
