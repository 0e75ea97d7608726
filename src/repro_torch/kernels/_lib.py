"""Build the port's CUDA kernels at first use and bind them with ctypes.

All ``*.cu`` sources under ``repro_torch/kernels/*/csrc`` are compiled for
``sm_90a`` with ``nvcc`` into one shared library with a plain C interface:
one ``nvcc -c`` per source, all started together, then one ``nvcc -shared``
link.  The library lands in ``<repo>/build/torch_kernels/<digest>/``, keyed
by a hash of the sources and flags, so a checkout builds it once and a
changed source builds anew.  Nothing is compiled or loaded at import time.

Each C entry point takes raw device pointers, its sizes and the CUDA stream,
launches on that stream and returns ``cudaGetLastError()``; ``check``
raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

_PKG = Path(__file__).resolve().parent
SOURCES = (
    _PKG / "spmv" / "csrc" / "ell_matvec.cu",
    _PKG / "spmv" / "csrc" / "ell_rmatvec.cu",
    _PKG / "bsls_draw" / "csrc" / "two_level_draw.cu",
    _PKG / "coord_update" / "csrc" / "coord_update.cu",
    _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    _PKG / "flash_attention" / "csrc" / "flash_attention_wgmma.cu",
    _PKG / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
    _PKG / "flash_attention" / "csrc" / "wgmma_tile_check.cu",
    _PKG / "scatter" / "csrc" / "scatter_add_ordered.cu",
)
INCLUDE = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[2] / "build" / "torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libreproport.so"

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_COLS = [_P, _P, _P, _P, _P, _P, _I, _I]
SIGNATURES = {
    "port_ell_matvec": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    "port_ell_rmatvec": _COLS + [_P, _P, _I, _I, _P, _I, _P, _P, _I, _P, _P],
    "port_two_level_draw": [_P, _P, _I, _I, _P, _U, _U, _P, _P, _P, _P, _I, _I, _P],
    "port_launch_floor": [_P],
    "port_coord_update": ([_I, _P] + _COLS + [_P, _P, _P, _I] + [_P] * 10
                          + [_I, _F, _F, _F, _F, _I, _P, _P, _I, _P, _P, _F] + [_P] * 6
                          + [_I, _I, _P, _I, _I] + [_P] * 5 + [_I] + [_P] * 3 + [_I] * 6
                          + [_P]),
    "port_coord_update_short_route_max": [],
    "port_flash_attention": [_P] * 5 + [_I] * 8 + [_F, _P],
    "port_flash_attention_bf16": [_P] * 5 + [_I] * 12 + [_F, _P],
    "port_flash_attention_bwd": [_P] * 12 + [_I] * 10 + [_F, _I, _P],
    "port_wgmma_tile_check": [_P, _P, _P, _I, _P, _P, _P, _P],
    "port_scatter_add_ordered": [_P, _P, _I, _P, _I, _P, _P, _I, _P, _P],
    "port_scatter_scratch_words": [_I],
}
RESTYPES = {"port_scatter_scratch_words": ctypes.c_longlong}


def digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for path in sorted(SOURCES + tuple(INCLUDE.glob("*.cuh"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def build() -> Tuple[Path, Dict[str, object]]:
    """Compile the library unless this digest is built; returns (path, info).

    ``info`` holds the build's wall seconds (0 when it was already built) and
    the compiler's ``-Xptxas -v`` report.
    """
    out_dir = BUILD_ROOT / digest()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return lib, {"seconds": 0.0, "log": log, "cached": True}
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs, procs = [], []
        for src in SOURCES:
            obj = tmp / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc(), *ARCH, *FLAGS, "-I", str(INCLUDE), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        link = subprocess.run([nvcc(), *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        log_path.write_text(log)
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib, {"seconds": time.perf_counter() - t0, "log": log, "cached": False}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    lib.port_error_string.argtypes = [ctypes.c_int]
    lib.port_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().port_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {code} ({msg})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t) -> int:
    """Device pointer of a tensor (None → NULL)."""
    return None if t is None else t.data_ptr()


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Refuse what the kernels do not take: non-CUDA or non-contiguous tensors."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def col_table(pcsc) -> tuple:
    """The C ``Cols`` arguments of a PaddedCSC or TieredCSC."""
    if hasattr(pcsc, "heavy_slot"):
        tensors = (pcsc.indices, pcsc.values, pcsc.nnz, pcsc.heavy_slot,
                   pcsc.heavy_indices, pcsc.heavy_values)
        widths = (pcsc.width, pcsc.full_width)
    else:
        tensors = (pcsc.indices, pcsc.values, pcsc.nnz, None, pcsc.indices, pcsc.values)
        widths = (pcsc.full_width, pcsc.full_width)
    for t, dtype in zip(tensors, (torch.int32, torch.float32, torch.int32, torch.int32,
                                  torch.int32, torch.float32)):
        if t is not None and t.dtype != dtype:
            raise ValueError(f"padded CSC: expected {dtype}, got {t.dtype}")
    require_cuda("padded CSC", *tensors)
    return tuple(ptr(t) for t in tensors) + widths
