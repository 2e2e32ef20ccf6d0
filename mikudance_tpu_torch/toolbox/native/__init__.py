"""ctypes loader for the port's C++ deformable-attention kernel.

``ms_deform_attn.cpp`` beside this file is the port's own copy of the JAX
package's source. ``g++`` builds it at first use into ``build/native/`` at the
repository root, under a file name keyed by a hash of the source and flags,
so it is reused while the source is unchanged; the library is written under
a temporary name and renamed, so processes that build at once do not see a
half-written file. Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "ms_deform_attn.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmsda_{key}.so"


def build() -> Path:
    """Compile the library unless this source's build is already there."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)], check=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.msda_forward.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ] + [ctypes.c_int64] * 7
    lib.msda_forward.restype = None
    return lib


def ms_deform_attn_cpu(value, spatial_shapes, sampling_locations, attention_weights):
    """numpy forward through the C++ kernel; mirrors ``toolbox.deformable.ms_deform_attn``.

    value (B, S, H, D); spatial_shapes [(h, w)] per level; sampling_locations
    (B, Q, H, L, P, 2) in [0, 1]; attention_weights (B, Q, H, L, P) ->
    (B, Q, H * D) float32."""
    lib = get_lib()
    value = np.ascontiguousarray(value, np.float32)
    shapes = np.ascontiguousarray(np.asarray(spatial_shapes, np.int64).reshape(-1, 2))
    locs = np.ascontiguousarray(sampling_locations, np.float32)
    wts = np.ascontiguousarray(attention_weights, np.float32)
    B, S, H, D = value.shape
    L = shapes.shape[0]
    Q, P = locs.shape[1], locs.shape[4]
    if not 0 < L <= 64 or int((shapes[:, 0] * shapes[:, 1]).sum()) != S:
        raise ValueError(f"spatial_shapes {shapes.tolist()} do not tile the {S} value rows "
                         "(at most 64 levels)")
    if locs.shape != (B, Q, H, L, P, 2) or wts.shape != (B, Q, H, L, P):
        raise ValueError(f"sampling_locations {locs.shape} / attention_weights {wts.shape} "
                         f"do not match value {value.shape} and {L} levels")
    out = np.zeros((B, Q, H * D), np.float32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.msda_forward(
        ptr(value, ctypes.c_float), ptr(shapes, ctypes.c_int64),
        ptr(locs, ctypes.c_float), ptr(wts, ctypes.c_float),
        ptr(out, ctypes.c_float),
        B, S, H, D, L, Q, P,
    )
    return out
