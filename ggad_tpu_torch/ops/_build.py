"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` has a plain C interface (and may include the shared
headers ``csrc/*.cuh``). At first use it is compiled with ``nvcc`` for
``sm_90a`` into ``ggad_tpu_torch/build/`` (git-ignored), under a name that
carries a hash of the sources and flags, and
loaded with ``ctypes``. Nothing is built when a module is imported. :func:`launch`
calls an entry point on PyTorch's current stream.

:func:`build_host` compiles a host library, ``csrc/<name>.cpp`` (the graph
builder of ``ggad_tpu_torch.native``), with the C++ compiler into the same
directory, the same way: hashed name, a per-process temporary file and an
atomic rename, so processes building at once leave one whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
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
# no -march=native: the library must load on any x86-64 host it reaches
# (a build directory copied to another machine); the compiler's identity
# is part of the name's hash instead, so another toolchain rebuilds it
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")

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


def cxx_path() -> str | None:
    """The host C++ compiler (``g++``, else ``c++``), or None."""
    return shutil.which("g++") or shutil.which("c++")


def _hashed_path(name: str, sources, salt: str) -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + salt.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    return _hashed_path(name, sources, " ".join(NVCC_FLAGS))


def _compile(out: Path, compiler: list, source: Path) -> str:
    """``compiler -o <tmp> source`` into a per-process temporary file,
    renamed to ``out``; returns the compiler's messages, raises with them
    when it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*compiler, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler[0]} failed for {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stderr


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path and nvcc's output (register and shared-memory use)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    return out, _compile(out, [nvcc_path(), *NVCC_FLAGS],
                         CSRC_DIR / f"{name}.cu")


def host_library_path(name: str, cxx: str) -> Path:
    """The host library's path, named by a hash of ``csrc/<name>.cpp``,
    the flags, the machine's architecture and the compiler's version."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[:1]
    return _hashed_path(name, [CSRC_DIR / f"{name}.cpp"], " ".join(
        (*HOST_FLAGS, platform.machine(), cxx, *version)))


def build_host(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cpp`` with the host C++ compiler unless its
    library exists; returns the library's path and the compiler's
    warnings. Raises when no compiler is found or the compile fails."""
    cxx = cxx_path()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on this host")
    out = host_library_path(name, cxx)
    if out.exists():
        return out, ""
    return out, _compile(out, [cxx, *HOST_FLAGS], CSRC_DIR / f"{name}.cpp")


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
