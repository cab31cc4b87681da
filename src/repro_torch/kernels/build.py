"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes). The first
call to :func:`library` compiles all of them at once, one ``nvcc`` process
per source started together, for ``sm_90a`` into ``build/kernels/`` at the
root of the checkout. A library's file name carries a hash of every
source under ``csrc/`` and of the flags, so an edited source is rebuilt
and an unchanged one is reused.

Each C entry point takes its pointers and the stream as ``void*``,
launches on PyTorch's current stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. Wrappers count their launches with :func:`count_launch`;
:func:`sass` disassembles a built library. A kernel without a backward
refuses a call that autograd would have to differentiate
(:func:`refuse_grad`): flash attention and the two scans have one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()        # first-use build + load
_COUNT_LOCK = threading.Lock()  # launch counters (bumped from several threads)
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # source stem -> nvcc's output (-Xptxas -v)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built, all ``nvcc`` processes in
    parallel; returns {source stem: library path}. Raises on any failure,
    with the compiler's output."""
    digest = _sources_digest()
    targets = {src.stem: (src, BUILD_DIR / f"lib{src.stem}-{digest}.so")
               for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: st for stem, st in targets.items() if not st[1].exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for stem, (src, out) in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[stem] = (subprocess.Popen(
                nvcc_command(nvcc, src, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            BUILD_LOG[stem] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)      # atomic: no half-written library
            else:
                failed.append(f"{stem}.cu:\n{BUILD_LOG[stem]}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return {stem: out for stem, (_src, out) in targets.items()}


def library(stem: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, with ``argtypes`` set from
    ``signatures`` (entry name -> ctypes argument types) and ``restype``
    ``c_int``; builds every kernel library at first use."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[stem]))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[stem] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: error {rc} "
                           f"({lib.error_string(rc).decode()})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` where grad is enabled and one of ``tensors``
    requires it: the kernel's output would carry no gradient, and a
    training step would silently lose every parameter behind it."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or with inputs that do not require grad")


def count_launch(wrapper, route: str | None = None) -> None:
    """One more launch on ``wrapper.launches`` and, for a wrapper with more
    than one kernel, on ``wrapper.launches_by_route[route]`` (thread-safe)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if route is not None:
            wrapper.launches_by_route[route] += 1


def zero_launches(wrapper) -> None:
    """Set ``wrapper.launches`` and every count of its routes to 0."""
    with _COUNT_LOCK:
        wrapper.launches = 0
        for route in getattr(wrapper, "launches_by_route", {}):
            wrapper.launches_by_route[route] = 0


def sass(stem: str) -> str:
    """The SASS of ``csrc/<stem>.cu``'s built library, as ``cuobjdump
    -sass`` prints it (to show which instructions the kernels use)."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(build_all()[stem])],
                         capture_output=True, text=True, check=True)
    return out.stdout
