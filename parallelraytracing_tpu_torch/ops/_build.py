"""Build and bind the port's CUDA kernels.

Each kernel source under ``csrc/`` compiles with ``nvcc`` into a shared
library with a plain C interface, loaded through ``ctypes``.  The build
happens at first use, into ``build/kernels/`` at the root of the checkout,
keyed by a hash of the source and the flags, so a changed source rebuilds
and an unchanged one loads at once.  Nothing here runs at import time: a
machine without ``nvcc`` imports the package and runs the plain PyTorch
versions of the kernels on CPU tensors.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

#: sm_90a keeps Hopper-only instructions available to later kernels.
#: No --use_fast_math, and -fmad=false: the kernels are held to plain
#: PyTorch versions that round every multiply and add on its own (see the
#: note in csrc/trace.cu).  -Xptxas -v records registers and spills in the
#: build log beside the library.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U = ctypes.c_uint

#: C signature of each kernel library's launch function
SIGNATURES = {
    "trace": ("prt_trace_launch", [
        I, P,                  # device, stream
        P, P, P, P, I,         # o, d, pix, out, n_rays
        P, I, P, I, I,         # sph, n_sph, sph_cl, rows, cols
        P, I, P, I, I,         # quad, n_quad, quad_cl, rows, cols
        P, I, I,               # mats, n_mats, csize
        U, I, F, F,            # seed, max_depth, t_min, t_cap
        F, F, F,               # sky
    ]),
}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on PATH."""
    cands = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"]
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for its hash exists.
    Raises with nvcc's output if the compile fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The launch function of kernel library `name`, built if needed, with
    its ctypes signature declared."""
    fn_name, argtypes = SIGNATURES[name]
    lib = ctypes.CDLL(str(build(name)))
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    fn.library = lib  # keep the library loaded while the function lives
    return fn
