"""Build and load the port's CUDA kernel library.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a``, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``build/kernels/`` at the repository root, under
a file name keyed by a hash of the sources and flags, so it is reused while
the sources are unchanged. Nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types; every entry point returns cudaGetLastError().
SIGNATURES = {
    # The attention entry points end with fp32 (0 / 1: q and o, or o alone where
    # the caller scaled and rounded q, are fp32) and the stream.
    # q, k, v, o, batch, seq, heads, head_dim, fp32, stream
    "md_flash_fullc": (P, P, P, P, I, I, I, I, I, P),
    # q, k, v, o, batch, q_len, kv_len, heads, head_dim, fp32, stream
    "md_flash_cross": (P, P, P, P, I, I, I, I, I, I, P),
    # q, k, v, o, batch, seq, heads, head_dim, fp32, stream
    "md_flash_wide": (P, P, P, P, I, I, I, I, I, P),
    # q, k, v, o, batch, seq, heads, head_dim, fp32, stream
    "md_flash_resident": (P, P, P, P, I, I, I, I, I, P),
    # q, k, v, o, batch, frames, positions, channels, heads, sequences a tile, heads a tile,
    # warps a block, fp32, stream
    "md_temporal_attention": (P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    # q, k, v, o, sequences, tokens, channels, heads, sequences a tile, heads a tile,
    # warps a block, fp32, stream
    "md_small_attention": (P, P, P, P, I, I, I, I, I, I, I, I, P),
    # x, weight, bias, y, scratch, images, rows, channels, groups, eps, silu, x_fp32,
    # w_fp32, cluster (0: streamed), slab, rows_per_block, splits, rows_per_split, chunk_w,
    # apply_blocks, stream
    "md_group_norm": (P, P, P, P, P, I, L, I, I, F, I, I, I, I, I, I, I, L, I, I, P),
    # x_fp32, w_fp32, silu, cluster, slab, rows_per_block, out: clusters held at once
    "md_group_norm_clusters": (I, I, I, I, I, I, ctypes.POINTER(ctypes.c_int)),
    # x, weight, bias, y, rows, channels, lanes a row, vectors a lane, eps, x_fp32, w_fp32,
    # stream
    "md_layer_norm": (P, P, P, P, L, I, I, I, F, I, I, P),
    # x, w, bias, residual, y, rows, cin, cout, bias_fp32, tile width, stream
    "md_linear": (P, P, P, P, P, L, I, I, I, I, P),
    # x, packed weight, bias, y, images, height, width, cin, cout, bias_fp32, tile width,
    # box width, box height, stream
    "md_conv3x3": (P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    # q, k, v, o, batch, seq, heads, head_dim, fp32, stream
    "md_flash_anchor_resident": (P, P, P, P, I, I, I, I, I, P),
    # q, k, v, o, batch, seq, heads, head_dim, fp32, stream
    "md_flash_anchor_stream": (P, P, P, P, I, I, I, I, I, P),
    # q, k, v, o, batch, seq, heads, head_dim, fp32, stream
    "md_flash_fullc_t": (P, P, P, P, I, I, I, I, I, P),
    # pointer table (inputs, weights, vectors, output, scratch, barrier), batch, seq,
    # head_dim, context rows, real context rows, chunk, eps, stamps, stream
    "md_mega_block": (P, I, I, I, I, I, I, F, P, P),
    # error code -> message
    "md_error_string": (I,),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmd_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return path


def build() -> Path:
    """Compile the library if no build of the current sources exists.
    Returns its path. One nvcc per source runs in parallel; the link writes
    to a temporary directory and renames, so a concurrent or interrupted
    build never leaves a partial library.
    ptxas's report (registers, shared memory, spills per kernel) is kept
    beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name} ({p.returncode}):\n{log}"
                  for src, p, log in zip(cu, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        out.with_suffix(".log").write_text("".join(logs) + res.stdout + res.stderr)
        os.replace(lib, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "md_error_string" else ctypes.c_int
    return lib


class CudaKernel:
    """One C entry point of the library, with a plain count of its launches.

    ``source`` and ``replaces`` name the CUDA file and the TPU kernel it
    ports; ``chip_smoke.py`` reports them beside the measurements."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name, self.symbol, self.source, self.replaces = name, symbol, source, replaces
        self.launches = 0
        self._entry = None  # the C entry point, looked up at the first launch

    def launch(self, *args) -> None:
        if self._entry is None:
            self._entry = getattr(load(), self.symbol)
        err = self._entry(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} ({load().md_error_string(err).decode()})")
        self.launches += 1
