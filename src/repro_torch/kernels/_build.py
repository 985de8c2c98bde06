"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers)
and is compiled, at first use, by its own ``nvcc`` process into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout;
all sources compile in parallel. The hash covers the source, the shared
headers and the flags, so an edited source rebuilds and a built one is
reused. The library is loaded with ``ctypes``: pointers and the stream
pass as ``c_void_p``, and every C entry point returns
``cudaGetLastError()`` of its launches, which :func:`check` turns into an
exception.

Nothing here falls back: a missing ``nvcc``, a failed build or a failed
launch raises. The CPU tests never reach this module, because the
wrappers run their plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_all", "check", "count_launch", "load"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# guards the wrappers' launch counts and host-side scratch caches: the
# engine's parallel flush launches from several threads
wrapper_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (each wrapper calls this where it
    launches its kernel, and nowhere else), exactly under threads."""
    with wrapper_lock:
        wrapper.launches += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of repro_torch are built from csrc/ at first use"
    )


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(*, ptxas_info: bool = False) -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet,
    one ``nvcc`` per source, all started together. Returns the compiler
    output per built source (with ``ptxas_info``, the registers, shared
    memory and spills of every kernel). Raises naming the source whose
    build failed."""
    with _lock:
        return _build_all(ptxas_info)


def _build_all(ptxas_info: bool) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [
        (src, _lib_path(src))
        for src in sorted(CSRC.glob("*.cu"))
        if not _lib_path(src).exists()
    ]
    if not todo:
        return {}
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if ptxas_info else ()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append(
            (src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        )
    logs: dict[str, str] = {}
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, building every
    source first if needed; ``signatures`` maps each C entry point to its
    ``argtypes`` (every entry point returns ``int``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = CSRC / f"{name}.cu"
            path = _lib_path(src)
            if not path.exists():
                _build_all(ptxas_info=False)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")

