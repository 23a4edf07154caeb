"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (and may include the shared
headers ``csrc/*.cuh``). At first use it is compiled with ``nvcc`` for
``sm_90a`` into ``ggad_tpu_torch/build/`` (git-ignored), under a name that
carries a hash of the sources and flags, and
loaded with ``ctypes``. Nothing is built when a module is imported. :func:`launch`
calls an entry point on PyTorch's current stream.
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

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple, object] = {}      # entry points, with their types set


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path and nvcc's output (register and shared-memory use)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        if name not in _loaded:
            path, _ = build(name)
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]


def launch(name: str, entry: str, device: torch.device, pointers, ints
           ) -> None:
    """Call ``entry`` of ``csrc/<name>.cu`` as ``entry(*pointers, *ints,
    stream)`` on PyTorch's current stream of ``device`` (in a backward
    pass, the stream autograd's engine set). Raises on a non-zero CUDA
    error code."""
    key = (name, entry, len(pointers), len(ints))
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(name), entry)
        fn.argtypes = ([ctypes.c_void_p] * len(pointers)
                       + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[key] = fn
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*pointers, *ints, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*pointers, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
