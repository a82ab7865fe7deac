"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
:mod:`ctypes`.  Nothing is compiled or loaded when this module is
imported: a library is built the first time a wrapper launches its
kernel (or when :func:`build_all` is called), into ``build/repro_torch/``
at the root of the checkout.  The file name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  Builds and loads run under one module lock, so threads
that launch a kernel at once on a cold build directory start one
``nvcc`` a source, and every build writes a temporary file of its own.

Every wrapper in :mod:`repro_torch.kernels` goes through this module:

* :func:`on_cpu` decides the route — the plain PyTorch version for a CPU
  tensor, the kernel for a CUDA tensor, an error for anything else;
* :func:`check_words` validates what the kernel takes (int32 words,
  contiguous, enough dimensions);
* :func:`blocks_for` is the launch geometry: one thread per output
  word, ``threads`` a block, a grid-stride loop beyond the grid limit.
  Kernels mask the ragged edge themselves, so no input is padded;
* :func:`kernel` returns the C entry point, bound once, and :func:`run`
  launches it on the tensor's device (entered only when it is not the
  current one) and current stream, raising on a non-zero ``cudaError_t``
  returned right after the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
import uuid

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: The kernel sources, one shared library each.
SOURCES = ("majx", "fanout", "megakernel", "mismatch", "bitserial")
#: Largest 1-D grid a launch asks for; a grid-stride loop covers the rest.
MAX_BLOCKS = 2**31 - 1

#: Serializes builds, loads and bindings (re-entrant: a first launch
#: builds from inside :func:`_library`).
_LOCK = threading.RLock()

VOID_P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` lives for these sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, pathlib.Path]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}-{uuid.uuid4().hex[:8]}")
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp


def build_all(names=SOURCES) -> dict[str, float]:
    """Build every missing library, all ``nvcc`` processes at once.

    Returns the wall seconds each build took (0.0 when the library for
    the current sources already existed).  Raises with the compiler's
    log when a build fails.
    """
    with _LOCK:
        t0 = time.perf_counter()
        started = {n: _start_build(n) for n in names
                   if not library_path(n).exists()}
        seconds = {n: 0.0 for n in names}
        failed = []
        for n, (proc, tmp) in started.items():
            rc = proc.wait()
            seconds[n] = time.perf_counter() - t0
            if rc == 0:
                os.replace(tmp, library_path(n))
            else:
                tmp.unlink(missing_ok=True)
                failed.append(n)
    if failed:
        logs = "\n".join(library_path(n).with_suffix(".log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


#: Loaded libraries by source name.
_LIBRARIES: dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBRARIES.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = _LIBRARIES[name] = ctypes.CDLL(str(path))
        return lib


#: Bound entry points by (library, function): ``argtypes`` are set once.
_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def kernel(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of ``csrc/<name>.cu``, built on first use
    and bound once (``argtypes`` of later calls are not read again).

    Every entry point returns the ``cudaError_t`` of its launch.
    """
    f = _ENTRIES.get((name, fn))
    if f is None:
        with _LOCK:
            f = _ENTRIES.get((name, fn))
            if f is None:
                f = getattr(_library(name), fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _ENTRIES[(name, fn)] = f
    return f


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain route), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel route for a tensor on {t.device}")


def check_words(name: str, t: torch.Tensor, min_ndim: int = 1) -> None:
    """Raise unless ``t`` is packed words a kernel takes."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: packed words are int32, got {t.dtype}")
    if t.dim() < min_ndim:
        raise ValueError(f"{name}: needs >= {min_ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def blocks_for(n_items: int, threads: int) -> int:
    """Blocks of ``threads`` covering ``n_items`` (grid-stride beyond)."""
    if threads <= 0 or threads > 1024 or threads % 32:
        raise ValueError(f"threads per block must be a multiple of 32 in "
                         f"[32, 1024], got {threads}")
    return max(1, min(-(-n_items // threads), MAX_BLOCKS))


def run(f: ctypes._CFuncPtr, what: str, device: torch.device,
        *args) -> None:
    """Launch ``f(*args, stream)`` on ``device``'s current stream.

    The CUDA runtime launches on its current device, so ``device`` is
    made current only when it is not already.  Raises when the launch
    returns a CUDA error code.  The launch is asynchronous: a fault while
    the kernel runs shows at the next synchronisation.
    """
    index = device.index
    if index is None or index == torch.cuda.current_device():
        err = f(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = f(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
