"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``a3vlm_tpu_torch/csrc``
for ``sm_90a``, one process per ``.cu`` file, all started together, and
links the objects into one shared library with a plain C interface, which
is loaded with ``ctypes``. The library lands in ``a3vlm_tpu_torch/_build/``
(git-ignored) under a name that carries the hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused; the
compiler's output (``-Xptxas -v``: registers, shared memory and spills of
every kernel) is kept beside it as ``.log``. Nothing here
runs at import time: the CPU tests import every module.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                  ctypes.c_float)
# name -> argtypes; every function returns a cudaError_t as int
_SIGNATURES = {
    "a3_int4_gemv": [_I] + [_P] * 6 + [_I] * 6 + [_P],
    "a3_int4_gemv_clusters": [_I, _I, _I, _I],
    "a3_int4_mma": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "a3_int4_mma_v3": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "a3_int4_mma_glu": [_P] * 7 + [_I, _I, _I, _I, _P],
    "a3_int8_gemv": [_P] * 4 + [_I] * 5 + [_P],
    "a3_int8_gemv_clusters": [_I, _I],
    "a3_int8_mma": [_P, _P, _P, _P, _I, _I, _I, _P],
    "a3_int4_gemv_a8": [_P] * 5 + [_I] * 6 + [_P],
    "a3_int4_gemv_a8_clusters": [_I, _I, _I],
    "a3_quantize_act_int8": [_P] * 3 + [_I] * 3 + [_P],
    "a3_int4_mma_w8a8p": [_P] * 6 + [_I, _I, _I, _I, _P],
    "a3_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                     _I, _P],
    "a3_flash_bwd_dq": [_P] * 7 + [_I] * 8 + [_F, _F, _I, _P],
    "a3_flash_bwd_dkv": [_P] * 8 + [_I] * 8 + [_F, _F, _I, _P],
    "a3_decode_slots": [_I, _I],
    "a3_decode_slots_q8": [_I, _I],
    "a3_decode_attend": [_P] * 8 + [_I] * 6 + [_F, _P],
    "a3_decode_attend_q8": [_P] * 10 + [_I] * 6 + [_F, _P],
    "a3_verify_slots": [_I, _I],
    "a3_verify_attend": [_P] * 6 + [_I] * 6 + [_F, _P],
    "a3_verify_attend_q8": [_P] * 8 + [_I] * 6 + [_F, _P],
    "a3_vit_attention": [_P] * 4 + [_I] * 4 + [_L] * 3 + [_F, _P],
    "a3_probe_wgmma": [_P] * 4 + [_I, _P],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "cannot be built"
        )
    return str(path)


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"liba3vlm_kernels_{digest.hexdigest()[:16]}.so"


def build_log(library: Path) -> Path:
    """The compiler's output of the build that made ``library``."""
    return library.with_suffix(".log")


def _run_all(commands: list[list[str]]) -> list[str]:
    """Run the commands in parallel and return their outputs; raise with
    the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in commands]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(commands, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return outputs


def build() -> Path:
    """Compile the library if no build of these exact sources exists."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [s for s in sources() if s.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in cu]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o]
                         for s, o in zip(cu, objs)])
        so = str(Path(tmp) / "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]])
        # what ptxas said of each kernel: registers, shared memory, spills
        build_log(target).write_text("".join(
            f"== {s.name}\n{log}" for s, log in zip(cu, logs)))
        os.replace(so, target)
    return target


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


# The current stream's handle without a Stream object (a few us a call
# less, on every launch), where this PyTorch has the accessor.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream() -> int:
    """The handle of the current CUDA stream of the current device."""
    if _raw_stream is not None:
        return _raw_stream(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_cuda(name: str, *tensors: torch.Tensor,
                 dtype: torch.dtype | None = None) -> None:
    """Device, dtype, contiguity and 16-byte alignment of kernel operands.
    (The messages are formatted only on failure: this runs on every
    launch.)"""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: tensor on {t.device}, want cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand not 16-byte aligned")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, want {dtype}")
