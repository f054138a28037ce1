"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, which ``ctypes`` loads. The library
lives in ``sudo_rm_rf_tpu_torch/_build/`` under a name keyed on a hash of the
sources and flags, so an edited source rebuilds. Nothing here runs at import.

The forward entry points share one convention, ``entry(x, out, *params,
workspace, *scalars, stream) -> cudaError_t``, and their wrappers one
:func:`check_params` and one :func:`launch`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def library_path() -> Path:
    """Path of the library built from the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsudo_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists. The
    compiler's report (registers, shared memory, spills) is kept beside it
    as ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(SRC_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    so.with_name(so.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.uconv_workspace_floats.argtypes = [i32] * 6
    lib.uconv_workspace_floats.restype = ctypes.c_longlong
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.ladder_tiles.argtypes = [i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.ladder_tiles.restype = i32
    lib.gemm_wide.argtypes = [i32, i32]
    lib.gemm_wide.restype = i32
    lib.uconv_block_forward.argtypes = (
        [ptr] * 17 + [i32] * 5 + [ctypes.c_float, i32, ptr])
    lib.uconv_block_forward.restype = i32
    lib.tac_tiles.argtypes = [i32]
    lib.tac_tiles.restype = i32
    lib.tac_workspace_floats.argtypes = [i32] * 3
    lib.tac_workspace_floats.restype = ctypes.c_longlong
    lib.tac_launches.argtypes = [i32]
    lib.tac_launches.restype = i32
    lib.tac_forward.argtypes = [ptr] * 14 + [i32] * 4 + [ctypes.c_float, ptr]
    lib.tac_forward.restype = i32
    return lib


def check_params(name: str, x, params, shapes: dict, convert: bool = False) -> list:
    """``params[label]`` for each label of ``shapes``, in its order, for a
    launch on x: each on x's device with the label's shape and a contiguous
    float32 tensor (``convert`` reads it as one), else a ValueError naming
    ``name`` and the label; a RuntimeError where autograd would need a
    gradient. Runs on CPU tensors too."""
    out = []
    for label, shape in shapes.items():
        p = params[label]
        if p.device != x.device or tuple(p.shape) != shape:
            raise ValueError(f"{name}: param {label} must be a {shape} tensor on {x.device}, "
                             f"got {tuple(p.shape)} on {p.device}")
        if p.dtype != torch.float32 or not p.is_contiguous():
            if not convert:
                raise ValueError(f"{name}: param {label} must be a contiguous float32 tensor, "
                                 f"got {p.dtype} contiguous={p.is_contiguous()}")
            p = p.float().contiguous()
        out.append(p)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in out)):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad() or "
                           "torch.inference_mode()")
    return out


def launch(name: str, lib: ctypes.CDLL, entry: str, x, params: list, workspace_floats: int,
           *scalars):
    """Run ``lib.<entry>`` on x's device and current stream, with a new
    output like x and a float32 workspace of ``workspace_floats``; returns
    the output. A launch error raises a RuntimeError naming ``name``."""
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        work = torch.empty(workspace_floats, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptr = lambda v: ctypes.c_void_p(v.data_ptr())  # noqa: E731
        err = getattr(lib, entry)(ptr(x), ptr(out), *map(ptr, params), ptr(work), *scalars,
                                  ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    return out
