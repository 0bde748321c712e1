"""ctypes bindings to the native C++ helpers (the counterpart of
``parallelraytracing_tpu.native``).

The sources are the repository's ``native/src/{lbvh,ply,imageio}.cpp``,
compiled unchanged with the system's ``g++`` and the flags of
``native/Makefile`` at first use, into ``build/native/`` at the root of
the checkout (keyed by a hash of the sources, the compiler and the
flags, beside the build's log).  Nothing is written into either
package.

- ``build_lbvh``: the threaded LBVH build (Morton codes, Karras tree,
  threading), the C++ twin of accel/lbvh.py;
- ``load_ply``: the PLY reader, the twin of core/mesh.py's;
- ``encode_png``: the zlib PNG encoder of the viewer's display path.

``available()`` is False only when the build fails (no compiler, no
zlib headers); ``build_log()`` then says why.  Callers keep their Python
path as the reference semantics.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
SOURCES = tuple(_ROOT / "native" / "src" / f
                for f in ("lbvh.cpp", "ply.cpp", "imageio.cpp"))
BUILD_DIR = _ROOT / "build" / "native"
#: native/Makefile's CXXFLAGS and LDFLAGS (x86-64-v2: the library runs on
#: any reasonably modern host, not only the one that built it)
CXXFLAGS = ("-O3", "-march=x86-64-v2", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lz")
#: the compiler: g++ on PATH, the system's, whose libstdc++ is the one a
#: Python process loads.  Not $CXX: a library built by another GCC (a
#: newer one named by CXX, measured) crashes in libstdc++'s stream
#: functions under the system's older libstdc++.
CXX = "g++"


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX,) + CXXFLAGS + LDFLAGS).encode())
    for path in SOURCES:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libprt_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the one for this hash exists.  Raises
    RuntimeError with the compiler's output (also kept in the log beside
    the library) when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXXFLAGS, *map(str, SOURCES), *LDFLAGS, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        text, rc = proc.stdout + proc.stderr, proc.returncode
    except (OSError, subprocess.TimeoutExpired) as e:
        text, rc = f"{type(e).__name__}: {e}", -1
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + text)
    if rc != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed (rc {rc}); log "
                           f"{out.with_suffix('.log')}:\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build_log() -> str:
    """The last build's log (the command and the compiler's output)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else "(not built yet)"


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        return None

    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")

    lib.prt_build_lbvh.restype = ctypes.c_int
    lib.prt_build_lbvh.argtypes = [f64p, f64p, ctypes.c_int64,
                                   f64p, f64p, i32p, i32p, i32p, i32p]

    lib.prt_ply_load.restype = ctypes.c_void_p
    lib.prt_ply_load.argtypes = [ctypes.c_char_p]
    lib.prt_ply_counts.restype = None
    lib.prt_ply_counts.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.POINTER(ctypes.c_int32)]
    lib.prt_ply_fill.restype = None
    lib.prt_ply_fill.argtypes = [ctypes.c_void_p, f32p, f32p, f32p, u32p]
    lib.prt_ply_free.restype = None
    lib.prt_ply_free.argtypes = [ctypes.c_void_p]

    lib.prt_encode_png.restype = ctypes.c_int64
    lib.prt_encode_png.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int, u8p,
                                   ctypes.c_int64]
    return lib


def available() -> bool:
    """True when the library builds and loads (built at the first call)."""
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library did not build:\n" + build_log())
    return lib


# ------------------------------------------------------------------- LBVH

def build_lbvh(prim_min: np.ndarray, prim_max: np.ndarray):
    """Native threaded-LBVH build over N > 1 boxes: (node_min, node_max,
    is_leaf, payload, miss, order), the Python builder's arrays (a leaf's
    payload is its sorted position; ``order`` maps it to the box)."""
    lib = _lib()
    n = len(prim_min)
    if n < 2:
        raise ValueError("build_lbvh needs at least two boxes")
    m = 2 * n - 1
    pmin = np.ascontiguousarray(prim_min, np.float64)
    pmax = np.ascontiguousarray(prim_max, np.float64)
    if pmin.shape != (n, 3) or pmax.shape != (n, 3):
        raise ValueError(f"boxes {pmin.shape} / {pmax.shape}, want ({n}, 3)")
    node_min = np.zeros((m, 3), np.float64)
    node_max = np.zeros((m, 3), np.float64)
    leaf = np.zeros(m, np.int32)
    payload = np.zeros(m, np.int32)
    miss = np.zeros(m, np.int32)
    order = np.zeros(n, np.int32)
    rc = lib.prt_build_lbvh(pmin, pmax, n, node_min, node_max, leaf,
                            payload, miss, order)
    if rc != 0:
        raise RuntimeError(f"prt_build_lbvh failed with code {rc}")
    return node_min, node_max, leaf.astype(bool), payload, miss, order


# -------------------------------------------------------------------- PLY

def load_ply(path: str):
    """Native PLY parse: (verts, normals or None, uvs or None, indices)."""
    lib = _lib()
    h = lib.prt_ply_load(os.fsencode(path))
    if not h:
        raise IOError(f"native PLY parse failed for {path}")
    try:
        nv = ctypes.c_int64()
        ni = ctypes.c_int64()
        hn = ctypes.c_int32()
        hu = ctypes.c_int32()
        lib.prt_ply_counts(h, ctypes.byref(nv), ctypes.byref(ni),
                           ctypes.byref(hn), ctypes.byref(hu))
        verts = np.zeros((nv.value, 3), np.float32)
        normals = np.zeros((nv.value, 3), np.float32)
        uvs = np.zeros((nv.value, 2), np.float32)
        idx = np.zeros(ni.value, np.uint32)
        lib.prt_ply_fill(h, verts, normals, uvs, idx)
        return (verts,
                normals if hn.value else None,
                uvs if hu.value else None,
                idx)
    finally:
        lib.prt_ply_free(h)


# -------------------------------------------------------------------- PNG

def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """Native PNG encode of an (H, W, 3 or 4) uint8 image."""
    lib = _lib()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"image {img.shape}, want (H, W, 3 or 4)")
    h, w, c = img.shape
    cap = img.nbytes + (img.nbytes >> 1) + 4096
    out = np.zeros(cap, np.uint8)
    n = lib.prt_encode_png(img, h, w, c, level, out, cap)
    if n < 0:
        raise RuntimeError("prt_encode_png failed")
    return out[:n].tobytes()
