"""Build the CUDA sources under ``repro_torch/csrc/`` and bind them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library name
carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused. Libraries go to ``build/kernels/`` at the root
of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it). No
``--use_fast_math``: the activation quantizer relies on IEEE division.

Binding rules: every pointer and the stream are ``c_void_p`` (``None`` is
the null pointer); the caller
allocates every output with ``torch.empty``; each C entry point returns
``cudaGetLastError()`` and :func:`call` raises if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = ["SOURCES", "build", "call", "build_dir"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("act_quant", "w4ax_matmul", "paged_attention", "paged_decode",
           "kv4_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
_LOCK = threading.Lock()


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[2] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source not yet built, one ``nvcc`` each, all
    started together; → {name: library path}. Raises with the compiler's
    output if any build fails."""
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            errors.append(f"nvcc failed for {n}.cu (exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out[n])     # atomic: concurrent builders race safely
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _lib(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def _arg(a):
    if a is None:                     # an optional buffer left out
        return ctypes.c_void_p(None)
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if isinstance(a, bool) or not isinstance(a, int):
        raise TypeError(f"kernel argument must be a tensor or int, got {a!r}")
    return ctypes.c_int(a)


def call(lib: str, fn: str, device: torch.device, *args) -> None:
    """Launch ``fn`` of library ``lib`` on ``device``'s current stream.
    Tensors pass as device pointers, ints as C ``int``."""
    f = getattr(_lib(lib), fn)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = f(*[_arg(a) for a in args], ctypes.c_void_p(stream))
    if rc != 0:
        msg = _lib(lib).kernel_error_string(rc).decode()
        raise RuntimeError(f"{lib}.{fn}: CUDA error {rc}: {msg}")
