"""Build the hand-written CUDA kernels and load them with ctypes.

Each `csrc/<name>.cu` is compiled on first use by `nvcc` into a shared
library with a plain C interface, `build/lib<name>-<hash>.so` at the repo
root. The hash is taken over the source and the flags, so an edited source
builds anew and a stale library is never loaded. Nothing here runs at
import time: this module imports on machines without `nvcc` or a GPU.

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v [-fmad=false] \
         -o build/lib<name>-<hash>.so <name>.cu

What ptxas prints for each kernel (registers, static shared memory, spills)
is kept beside the library as `build/lib<name>-<hash>.log`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]
# Per-kernel extra flags. Canny and the warp keep their plain versions'
# order of operations exactly: no fused multiply-add contraction.
EXTRA_FLAGS: Dict[str, list] = {"canny": ["-fmad=false"], "dense_block": [],
                                "shape_stream": [], "warp": ["-fmad=false"]}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _flags(name: str) -> list:
    return NVCC_FLAGS + EXTRA_FLAGS[name]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for `name` unless its library exists; returns the
    process (or None) and the temporary output path."""
    out = library_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all nvcc
    processes at once; raise with nvcc's output if one fails."""
    names = list(names)
    started = {n: _start(n) for n in names}
    errors = []
    for name, (proc, tmp) in started.items():
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            library_path(name).with_suffix(".log").write_text(log)
            os.replace(tmp, library_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def ptxas_info(name: str) -> list:
    """ptxas's lines for each kernel of the built library `name`: the
    function, its registers and shared memory, its stack and spills."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    return [line.strip() for line in log.read_text().splitlines()
            if "ptxas info" in line and ("Compiling entry" in line
                                         or "Used" in line)
            or "spill" in line]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built if needed, with every C entry
    point's argument and return types declared."""
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "canny":
        lib.canny_forward.argtypes = [p, p, i, i, i, f, f, p]
        lib.canny_forward.restype = i
        lib.canny_iters.argtypes = []
        lib.canny_iters.restype = i
    elif name == "dense_block":
        lib.dense_block_forward.argtypes = [p, p, p, p, p, p, p,
                                            i, i, i, i, i, p]
        lib.dense_block_forward.restype = i
        lib.dense_block_growth.argtypes = []
        lib.dense_block_growth.restype = i
        lib.dense_block_hidden.argtypes = []
        lib.dense_block_hidden.restype = i
    elif name == "shape_stream":
        lib.shape_stream_forward.argtypes = [p, p, p, p,
                                             ctypes.POINTER(p), i, i, i, p]
        lib.shape_stream_forward.restype = i
        lib.shape_stream_operands.argtypes = []
        lib.shape_stream_operands.restype = i
    elif name == "warp":
        lib.gather_image_forward.argtypes = [p, p, p, i, i, i, i, p]
        lib.gather_image_forward.restype = i
        lib.warp_forward.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.warp_forward.restype = i
        lib.resample_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                         i, p]
        lib.resample_forward.restype = i
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
