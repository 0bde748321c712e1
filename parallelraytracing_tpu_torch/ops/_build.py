"""Build and bind the port's CUDA kernels.

Each kernel source ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared
library with a plain C interface, loaded through ``ctypes``.  The build
happens at first use, into ``build/kernels/`` at the root of the checkout,
keyed by a hash of the source, of every ``csrc/`` header it includes and
of the flags, so a changed source or header rebuilds and an unchanged one
loads at once.  ``build_all`` starts one ``nvcc`` per library at once and
waits for all of them.  Nothing here runs at import time: a machine
without ``nvcc`` imports the package and runs the plain PyTorch versions
of the kernels on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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
#: note in csrc/bounce.cuh).  -Xptxas -v records registers and spills in
#: the build log beside the library.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U = ctypes.c_uint


class PrtScene(ctypes.Structure):
    """ctypes mirror of ``struct PrtScene`` in csrc/bounce.cuh: the tables'
    records (ops/pack.SceneRecords), their widths and the scene's facts."""
    _fields_ = [
        ("sph", P), ("sph_cl", P),
        ("n_sph", I), ("sph_cl_rows", I), ("sph_cl_cols", I),
        ("quad", P), ("quad_cl", P),
        ("n_quad", I), ("quad_cl_rows", I), ("quad_cl_cols", I),
        ("tri", P), ("tri_tail", P), ("tri_cl", P),
        ("n_tri", I), ("tri_cl_rows", I), ("tri_cl_cols", I),
        ("tri_tail_w", I),
        ("mats", P), ("n_mats", I),
        ("csize", I), ("tri_csize", I),
        ("t_min", F), ("t_cap", F), ("sky", F * 13), ("sky_mode", I),
        ("lights", P), ("n_lights", I), ("rr_depth", I),
        ("itri", P), ("itri_tail", P), ("iacc", P), ("ibox", P), ("inst", P),
        ("n_itri", I), ("n_iacc", I), ("n_inst", I), ("itri_tail_w", I),
        ("mtex", P), ("itex", P),
        ("mini", P), ("n_mini", I), ("chunk", I), ("node_rows", I),
        ("stream_shift", I),
    ]


SCENE = ctypes.POINTER(PrtScene)

#: C signature of each kernel library's launch function
SIGNATURES = {
    "trace": ("prt_trace_launch", [
        I, P, SCENE,           # device, stream, scene
        P, P, P, P, P, I,      # o, d, pix, out, next (ray counter), n_rays
        U, I,                  # seed, max_depth
    ]),
    "segment": ("prt_segment_launch", [
        I, P, SCENE,           # device, stream, scene
        P, P, P,               # input queue: pix, state, count
        P, P, P, P, P,         # pix_out, out, key_out, rad, counters
        I, U, I, I, I, I,      # n_rays, seed, depth0, n_bounces, max_depth, key_mode
        ctypes.POINTER(F),     # bb: the scene box's low corner, 1 / extent
    ]),
    "probe": ("prt_probe_launch", [
        I, P, SCENE,           # device, stream, scene
        P, P, P, P, P, P, I,   # o, d, pix, out, depth, stats, n_rays
        U, I,                  # seed, max_depth
    ]),
    "micro": ("prt_fp32_peak_launch", [
        I, P,                  # device, stream
        P, P, I, I, I,         # x, out, n, loops, mix
    ]),
}

#: the fields of a persistent kernel's launch query (``launch_config``),
#: in csrc/persistent.cuh launch_info's order
LAUNCH_INFO = ("grid", "threads", "blocks_per_sm", "registers",
               "local_bytes", "static_smem", "dynamic_smem", "sms")

#: every kernel library, in the order chip_smoke.py's build phase lists them
LIBRARIES = ("trace", "segment", "probe", "micro")

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


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


def sources(name: str):
    """csrc/<name>.cu and every csrc/ header it includes, transitively."""
    todo = [CSRC / f"{name}.cu"]
    seen = []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(CSRC / inc.decode())
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names) -> list:
    """Compile csrc/<name>.cu for each name whose library is missing, one
    nvcc process each, all started together.  Returns the library paths;
    raises with nvcc's output if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, cmd, proc))
    failed = []
    for name, out, tmp, cmd, proc in jobs:
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed building {name}.cu:\n{text}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for its hash exists."""
    return build_all([name])[0]


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The launch function of kernel library `name`, built if needed, with
    its ctypes signature declared.  Raises if a library that reads the
    scene has a ``sizeof(PrtScene)`` other than the ctypes mirror's: a
    field added on one side only would otherwise shift every pointer after
    it."""
    fn_name, argtypes = SIGNATURES[name]
    lib = ctypes.CDLL(str(build(name)))
    if SCENE in argtypes:
        lib.prt_scene_size.restype = ctypes.c_int
        lib.prt_scene_size.argtypes = []
        size = lib.prt_scene_size()
        if size != ctypes.sizeof(PrtScene):
            raise RuntimeError(
                f"lib{name}: sizeof(PrtScene) is {size} in csrc/bounce.cuh "
                f"but {ctypes.sizeof(PrtScene)} in the ctypes mirror "
                f"(ops/_build.py)")
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    fn.library = lib  # keep the library loaded while the function lives
    return fn


def launch_config(name: str, device_index: int, variant: int) -> dict:
    """What instantiation `variant` of persistent kernel library `name`
    ("trace" or "segment") runs with on CUDA device `device_index`, from
    its ``prt_<name>_info`` (the fields of LAUNCH_INFO): its persistent
    grid in blocks, threads a block, resident blocks per SM, registers
    and local memory a thread (bytes), static and dynamic shared memory a
    block (bytes), and the device's SMs."""
    info_fn = getattr(load(name).library, f"prt_{name}_info")
    info_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    info_fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(LAUNCH_INFO))()
    err = info_fn(device_index, int(variant), info)
    if err != 0:
        raise RuntimeError(f"{name} kernel query failed: cudaError_t {err}")
    return dict(zip(LAUNCH_INFO, info))
