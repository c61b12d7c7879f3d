"""Build, load and count the hand-written CUDA kernels.

The CUDA sources under ``kernels/csrc/`` are compiled at first use with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
loaded with ``ctypes``. The build goes into ``build/`` at the root of the
checkout, in a directory named after a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is. Each
source compiles in its own ``nvcc`` process, all started together.

Each kernel module keeps an integer launch counter beside its wrapper;
``launch_counts`` and ``reset_launch_counts`` read and clear them all, so a
run can show which kernels the main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build"
SOURCES = ("awac_sweep.cu", "awac_persistent.cu", "flash_attention.cu",
           "flash_attention_tc.cu", "router_swap.cu", "embedding_bag.cu",
           "cycle_gain.cu", "mcm_persistent.cu")
HEADERS = ("awac_common.cuh", "coop_grid.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_ll = ctypes.c_longlong
c_float = ctypes.c_float
# q, k, v, o; B, H, Hkv, S, Sk, D; 12 strides; causal; scale; stream
_FLASH_ARGS = [c_ptr] * 4 + [c_int] * 6 + [ctypes.POINTER(c_ll), c_int,
                                          c_float, c_ptr]

#: argument types of each exported C function, in order
SIGNATURES = {
    # row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain; B, cap,
    # n; rec, keys; build; cgain, crow, cw1, cw2, stream
    "awac_sweep": [c_ptr] * 9 + [c_int, c_ll, c_int] + [c_ptr] * 2
    + [c_int] + [c_ptr] * 5,
    # row, col, val, row_ptr, mate_row, mate_col, u, v, go0, min_gain;
    # max_iter, B, cap, n; mate_row, mate_col, u, v, iters, scratch;
    # scratch bytes; stream
    "awac_persistent": [c_ptr] * 10 + [c_int, c_int, c_ll, c_int]
    + [c_ptr] * 6 + [c_ll, c_ptr],
    # B, n -> bytes of scratch for awac_persistent
    "awac_persistent_scratch_bytes": [c_int, c_int],
    "flash_attention_f32": _FLASH_ARGS,
    "flash_attention_bf16": _FLASH_ARGS,
    # aff, assign, cur, gain, partner; G, T, E, idx64; stream
    "router_swap": [c_ptr] * 5 + [c_int] * 4 + [c_ptr],
    # idx, w, table, out; B, L, V, D; route, slices, windows, window_rows,
    # passes, bags_per_block, blocks, smem; scratch, split, stream
    "embedding_bag": [c_ptr] * 4 + [c_int] * 12 + [c_ptr] * 3,
    # a, a2, u, v, gain, row; M, N; stream
    "cycle_gain": [c_ptr] * 6 + [c_int] * 2 + [c_ptr],
    # col, val, row_ptr, mate_row, mate_col; n; mate_row, mate_col, stats,
    # scratch; scratch bytes; stream
    "mcm_persistent": [c_ptr] * 5 + [c_int] + [c_ptr] * 4 + [c_ll, c_ptr],
    # n -> bytes of scratch for mcm_persistent
    "mcm_persistent_scratch_bytes": [c_int],
}

#: return types other than int (a ``cudaError_t``)
RESTYPES = {"awac_persistent_scratch_bytes": c_ll,
            "mcm_persistent_scratch_bytes": c_ll}

_LIB = None
#: what the last build did: {"seconds", "library", "ptxas", "cached"}
BUILD_INFO: dict = {}


class KernelBuildError(RuntimeError):
    """The kernels could not be built or loaded: no ``nvcc``, a source that
    does not compile or link, or a library that does not load. Never
    transient: building again gives the same result."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc, on the machine with the "
                           "card")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (if this exact version is not built yet) and
    return the path of the shared library."""
    out_dir = BUILD_ROOT / f"kernels-{_digest()}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        log = out_dir / "ptxas.log"
        BUILD_INFO.update(seconds=0.0, library=str(lib), cached=True,
                          ptxas=log.read_text() if log.exists() else "")
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        objs, procs = [], []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, proc in procs:  # wait for every one, failed or not
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}:\n{out}")
        if failed:
            raise KernelBuildError("\n".join(failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp / LIB_NAME),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelBuildError(
                f"linking the kernels failed:\n{link.stderr}")
        (tmp / "ptxas.log").write_text("\n".join(logs))
        try:
            os.replace(tmp, out_dir)  # atomic; a concurrent build may win
        except OSError:
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(lib),
                      cached=False,
                      ptxas=(out_dir / "ptxas.log").read_text())
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _LIB
    if _LIB is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, c_int)
        except (OSError, AttributeError) as e:
            raise KernelBuildError(
                f"loading the kernel library {path} failed: {e}") from e
        _LIB = lib
    return _LIB


def stream(dev: torch.device) -> int:
    """The handle of torch's current stream on ``dev``, for a launch. The
    raw getter, where torch has it, skips building a ``torch.cuda.Stream``
    object: microseconds on the launch path of a kernel that runs for
    about a hundred."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None or dev.index is None:
        return torch.cuda.current_stream(dev).cuda_stream
    return raw(dev.index)


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a kernel's C entry."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: error {err} "
            f"({torch.cuda.get_device_name()})")


def launch_counts() -> dict[str, int]:
    """Launches of each hand-written kernel since the last reset."""
    awac_sweep, persistent, flash, swap, bag, tile, mcm = _kernel_modules()
    return {"awac_sweep": awac_sweep.launches,
            "awac_persistent": persistent.launches,
            "flash_attention": flash.launches,
            "router_swap": swap.launches,
            "embedding_bag": bag.launches,
            "cycle_gain": tile.launches,
            "mcm_persistent": mcm.launches}


def reset_launch_counts() -> None:
    for mod in _kernel_modules():
        mod.launches = 0


def _kernel_modules():
    """The wrapper modules that hold the launch counters (imported here:
    they import this module; the flash-attention, router-swap and
    embedding-bag packages export a function of their module's name, so
    the modules are looked up by path)."""
    return tuple(importlib.import_module(f"repro_torch.kernels.{m}") for m in (
        "cycle_gain.awac_sweep", "cycle_gain.persistent",
        "flash_attention.flash_attention", "router_swap.router_swap",
        "embedding_bag.embedding_bag", "cycle_gain.cycle_gain",
        "mcm.persistent"))
