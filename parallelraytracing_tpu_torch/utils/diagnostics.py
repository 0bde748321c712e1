"""Start-up capability probes (the counterpart of
``parallelraytracing_tpu.utils.diagnostics``).

The analogue of the reference's checkCUDA() / checkOptiX() probes
(main.cpp:46-83) and its register-only-if-available engine policy
(main.cpp:162-163): one row each for torch and its CUDA build, the card
(its compute capability must be 9.0, for sm_90a), nvcc, triton, the build
of each CUDA kernel library, the native helpers, and a 16x8 MATERIAL_TEST
frame on every engine, so a caller can list the engines that work.  On
the CPU the rows of the CUDA toolchain are skipped ("skipped: cpu") and
each engine renders through its plain PyTorch versions.
"""

from __future__ import annotations

import subprocess
import time
import traceback
from typing import Dict, List

import numpy as np
import torch


def run_diagnostics(device="cuda", verbose: bool = True) -> Dict[str, dict]:
    """Probe the toolchain and every engine on `device`: {row: {"ok",
    "detail", "ms"}}; a skipped row is ok."""
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    results: Dict[str, dict] = {}

    def record(name, ok, detail="", ms=None, skipped=False):
        results[name] = {"ok": bool(ok), "detail": str(detail),
                         "ms": None if ms is None else round(ms, 1)}
        if verbose:
            mark = "SKIP" if skipped else ("OK " if ok else "FAIL")
            extra = f" ({ms:.0f} ms)" if ms is not None else ""
            print(f"[{mark}] {name:24s} {detail}{extra}", flush=True)

    def skip(name):
        record(name, True, f"skipped: {dev.type}", skipped=True)

    record("torch", True, f"torch {torch.__version__}, CUDA build "
           f"{torch.version.cuda or 'none'}")

    if on_cuda:
        if not torch.cuda.is_available():
            record("device", False, "CUDA is not available")
            return results
        cap = torch.cuda.get_device_capability(dev)
        record("device", cap == (9, 0),
               f"{torch.cuda.get_device_name(dev)}, compute capability "
               f"{cap[0]}.{cap[1]} (the kernels are built for sm_90a)")
    else:
        skip("device")

    from parallelraytracing_tpu_torch.ops import _build
    if on_cuda:
        try:
            exe = _build.nvcc()
            ver = subprocess.run([exe, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout.strip()
            record("nvcc", True, f"{exe}: {ver.splitlines()[-1]}")
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            record("nvcc", False, repr(e))
    else:
        skip("nvcc")

    if on_cuda:
        try:
            import triton
            record("triton", True, f"triton {triton.__version__} (no port "
                   f"kernel is written in Triton)")
        except ImportError:
            record("triton", True, "absent (no port kernel needs it)")
    else:
        skip("triton")

    if on_cuda:
        t0 = time.perf_counter()
        try:
            _build.build_all(_build.LIBRARIES)
            ms = (time.perf_counter() - t0) * 1e3
            for name in _build.LIBRARIES:
                _build.load(name)
                record(f"build:{name}", True,
                       f"{_build.library_path(name).name} (one nvcc each, "
                       f"all at once)", ms)
        except (RuntimeError, OSError) as e:
            for name in _build.LIBRARIES:
                record(f"build:{name}", False, str(e)[-300:])
    else:
        for name in _build.LIBRARIES:
            skip(f"build:{name}")

    from parallelraytracing_tpu_torch import native
    t0 = time.perf_counter()
    ok = native.available()
    record("native", ok,
           native.library_path().name if ok
           else "build failed: " + native.build_log()[-300:],
           (time.perf_counter() - t0) * 1e3)

    from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,
                                              ScenePreset, available_engines,
                                              create_renderer)
    from parallelraytracing_tpu_torch.core.camera import default_camera

    cfg = RenderConfig(width=16, height=8, max_depth=3, seed=0,
                       intersect_chunk=8, ray_tile=1 << 10)
    for name in available_engines():
        try:
            scene = Scene(ScenePreset.MATERIAL_TEST)
            film = Film(cfg.width, cfg.height, dev)
            r = create_renderer(name, dev)
            t0 = time.perf_counter()
            r.init(film, scene, default_camera(cfg.width, cfg.height), cfg)
            r.progressive_render()
            img = film.hdr_average().cpu().numpy()
            ok = bool(np.isfinite(img).all() and img.max() > 0)
            record(f"engine:{name}", ok, "rendered" if ok else
                   "not finite or all zero", (time.perf_counter() - t0) * 1e3)
        except Exception as e:  # a row per engine: report it, go on
            tb = traceback.format_exception_only(type(e), e)[-1].strip()
            record(f"engine:{name}", False, tb[:200])

    return results


def working_engines(device="cuda") -> List[str]:
    """Names of the engines that pass the probe on `device`."""
    res = run_diagnostics(device, verbose=False)
    return sorted(k.split(":", 1)[1] for k, v in res.items()
                  if k.startswith("engine:") and v["ok"])
