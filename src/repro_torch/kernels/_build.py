"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The libraries go to ``build/kernels/<hash>/`` at the repository root,
where ``<hash>`` covers the sources and the flags, so an edited source
builds into a fresh directory. The first call to :func:`library` builds
every missing library, one ``nvcc`` per source, all started together;
``ptxas``'s register and spill report lands in ``<name>.log`` beside each
library. ``nvcc`` comes from ``$CUDA_HOME/bin`` when ``CUDA_HOME`` is set,
else from ``PATH``; without it, or when a build fails, this raises.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check_launch` turns a non-zero code into
an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_ROOT", "NVCC_FLAGS", "find_nvcc", "build_dir",
           "build_all", "library", "current_stream", "check_launch",
           "check_tensor"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home:
        nvcc = Path(home) / "bin" / "nvcc"
        if not nvcc.is_file():
            raise FileNotFoundError(f"CUDA_HOME={home} has no bin/nvcc")
        return str(nvcc)
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise FileNotFoundError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """Directory of this source tree's libraries (hash of sources+flags)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing — one ``nvcc`` per
    source, all running at once — and return ``name -> library path``.
    A library is written under a temporary name and renamed into place,
    so processes building at the same time never load a half-written
    file."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out / f"lib{src.stem}.so" for src in _sources()}
    todo = [src for src in _sources() if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    procs = []
    for src in todo:
        tmp = out / f".lib{src.stem}.{os.getpid()}.so"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((src.stem, proc, tmp))
    failed = []
    for name, proc, tmp in procs:
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds on first
    use)."""
    with _lock:
        if not _libs:
            for stem, path in build_all().items():
                _libs[stem] = ctypes.CDLL(str(path))
        return _libs[name]


def current_stream(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``, read at call
    time — inside ``with torch.cuda.stream(s)`` that is ``s``."""
    if device.index is not None and device.index != torch.cuda.current_device():
        raise RuntimeError(f"tensor on {device} but the current device is "
                           f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(device).cuda_stream


#: guards every wrapper's ``launches`` counter: the serving path launches
#: from several threads at once (engine workers, a scheduler's pool)
_count_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to ``fn.launches`` (a wrapper's launch counter), exactly,
    whichever thread launched."""
    with _count_lock:
        fn.launches += 1


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{code}")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank
    ``ndim`` on ``device`` — what the kernels take, and nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
