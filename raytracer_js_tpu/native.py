"""ctypes bindings for the native scenekit library (native/scenekit.cpp).

Native host-side components of the framework (the reference has none —
SURVEY.md §2 "zero native components"): octree CSR build and OBJ loading.
The library is not committed: it is built from ``native/scenekit.cpp`` into
the git-ignored ``native/build/`` on first use (``make -C native``); every
entry point has a NumPy fallback so the framework works unbuilt (the
fallback IS the specification — tests compare the two).
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent
_NATIVE_DIR = _REPO / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libscenekit.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    """Build (once) and load the shared library; None if unavailable."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            if not _LIB_PATH.exists():
                subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                               capture_output=True, text=True, timeout=120)
            lib = ctypes.CDLL(str(_LIB_PATH))
        except subprocess.CalledProcessError as e:
            _lib_error = f"make -C native failed:\n{e.stderr}"
            return None
        except Exception as e:
            _lib_error = repr(e)
            return None
        lib.sk_count_pairs.restype = ctypes.c_int64
        lib.sk_count_pairs.argtypes = [_f32p, _f32p, _u8p, ctypes.c_int64,
                                       _f32p, ctypes.c_float, ctypes.c_int]
        lib.sk_fill_csr.restype = ctypes.c_int32
        lib.sk_fill_csr.argtypes = [_f32p, _f32p, _u8p, ctypes.c_int64,
                                    _f32p, ctypes.c_float, ctypes.c_int,
                                    _i32p, _i32p, ctypes.c_int64]
        lib.sk_covering_levels.restype = None
        lib.sk_covering_levels.argtypes = [_f32p, _f32p, ctypes.c_int64,
                                           _f32p, ctypes.c_float,
                                           ctypes.c_int, _i32p, _i32p]
        lib.sk_obj_counts.restype = ctypes.c_int
        lib.sk_obj_counts.argtypes = [ctypes.c_char_p, _i64p, _i64p]
        lib.sk_obj_load.restype = ctypes.c_int
        lib.sk_obj_load.argtypes = [ctypes.c_char_p, _f32p, _i32p,
                                    ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def require() -> None:
    """Raise unless the native library builds and loads: for timed set-up,
    which must not fall back to the much slower NumPy paths unnoticed."""
    if _load() is None:
        raise RuntimeError(f"native scenekit unavailable: {_lib_error}")


# ---------------------------------------------------------------------------
# Octree CSR build
# ---------------------------------------------------------------------------

def grid_csr(lo: np.ndarray, hi: np.ndarray, fine_mask: np.ndarray,
             root_lo: np.ndarray, root_size: float,
             depth: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(cell_offsets [R^3+1] i32, cell_ids [K] i32, max_per_cell).

    Native when built; NumPy otherwise. Both paths are bit-identical
    (same cell clipping and stable prim order).
    """
    lib = _load()
    R = 1 << depth
    lo32 = np.ascontiguousarray(lo, np.float32)
    hi32 = np.ascontiguousarray(hi, np.float32)
    fm = np.ascontiguousarray(fine_mask, np.uint8)
    rl = np.ascontiguousarray(root_lo, np.float32)
    n = lo32.shape[0]
    if lib is not None:
        total = lib.sk_count_pairs(lo32, hi32, fm, n, rl,
                                   ctypes.c_float(root_size), depth)
        offsets = np.zeros(R ** 3 + 1, np.int32)
        ids = np.zeros(int(total), np.int32)
        mpc = lib.sk_fill_csr(lo32, hi32, fm, n, rl,
                              ctypes.c_float(root_size), depth,
                              offsets, ids, total)
        if mpc < 0:
            raise ValueError("octree CSR overflow")
        return offsets, ids, int(mpc)
    return _grid_csr_numpy(lo32, hi32, fm.astype(bool), rl, root_size, depth)


def _grid_csr_numpy(lo, hi, fine_mask, root_lo, root_size, depth):
    R = 1 << depth
    cell_sz = root_size / R
    pairs_cell, pairs_id = [], []
    for p in np.where(fine_mask)[0]:
        c_lo = np.clip(np.floor((lo[p] - root_lo) / cell_sz), 0, R - 1).astype(int)
        c_hi = np.clip(np.floor((hi[p] - root_lo) / cell_sz - 1e-9), 0,
                       R - 1).astype(int)
        gx, gy, gz = np.meshgrid(np.arange(c_lo[0], c_hi[0] + 1),
                                 np.arange(c_lo[1], c_hi[1] + 1),
                                 np.arange(c_lo[2], c_hi[2] + 1),
                                 indexing="ij")
        lin = (gx.astype(np.int64) * R + gy) * R + gz
        pairs_cell.append(lin.ravel())
        pairs_id.append(np.full(lin.size, p, np.int64))
    if pairs_cell:
        pc = np.concatenate(pairs_cell)
        pi = np.concatenate(pairs_id)
        o = np.argsort(pc, kind="stable")
        pc, pi = pc[o], pi[o]
        counts = np.bincount(pc, minlength=R ** 3)
        offsets = np.zeros(R ** 3 + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        return (offsets.astype(np.int32), pi.astype(np.int32),
                int(counts.max()) if counts.size else 0)
    return np.zeros(R ** 3 + 1, np.int32), np.zeros(0, np.int32), 0


def covering_levels_native(lo, hi, root_lo, root_size, depth):
    """Native covering-level pass; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    lo32 = np.ascontiguousarray(lo, np.float32)
    hi32 = np.ascontiguousarray(hi, np.float32)
    rl = np.ascontiguousarray(root_lo, np.float32)
    n = lo32.shape[0]
    level = np.zeros(n, np.int32)
    cell = np.zeros((n, 3), np.int32)
    lib.sk_covering_levels(lo32, hi32, n, rl, ctypes.c_float(root_size),
                           depth, level, np.ascontiguousarray(cell))
    return level.astype(np.int64), cell.astype(np.int64)


# ---------------------------------------------------------------------------
# OBJ loading
# ---------------------------------------------------------------------------

def load_obj(path) -> Tuple[np.ndarray, np.ndarray]:
    """OBJ file -> (vertices [V,3] f32, faces [T,3] i32), fan-triangulated."""
    lib = _load()
    path = str(path)
    if lib is not None:
        nv = np.zeros(1, np.int64)
        nt = np.zeros(1, np.int64)
        if lib.sk_obj_counts(path.encode(), nv, nt) != 0:
            raise IOError(f"cannot read {path}")
        verts = np.zeros((int(nv[0]), 3), np.float32)
        faces = np.zeros((int(nt[0]), 3), np.int32)
        rc = lib.sk_obj_load(path.encode(), np.ascontiguousarray(verts),
                             np.ascontiguousarray(faces), int(nv[0]),
                             int(nt[0]))
        if rc != 0:
            raise IOError(f"OBJ parse failure ({rc}) in {path}")
        return verts, faces
    return _load_obj_python(path)


def _load_obj_python(path):
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v ") or line.startswith("v\t"):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith("f ") or line.startswith("f\t"):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(len(verts) + i if i < 0 else i - 1)
                for k in range(2, len(idx)):
                    faces.append([idx[0], idx[k - 1], idx[k]])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))
