"""One rank's run of a cell: set-up, the measured window, the program's
outputs, then the reference's share of the check.

The window drives the renderer as its viewer does: a closed loop of
``Renderer.progressive_render()`` calls, each issued when the last
returns, the card waited for every ``MAX_PENDING`` frames and at each
display; a display reads the film whole (``Renderer.gather_film()`` on
every rank, a collective on more than one) and its tonemapped image to
the host on rank 0.  Rank 0 schedules the displays by its clock, one
every ``display_ms``, and ends the window at the first display past
``--seconds``; on more than one rank it broadcasts each schedule at the
display, so that every rank runs the same frames and gathers at the same
ones.  The harness's own exchanges (that broadcast, its barriers) go over
a host (gloo) group and never become device kernels, and the ranks meet
there before each gather, so that the gather's kernels time the transfer
and not one rank waiting for another.  Each rank of a multi-rank cell
runs one intra-op thread (``OMP_NUM_THREADS=1``, as ``torchrun`` sets
for more than one process) on cores of its own.  An orbiting traffic moves the camera before each frame (a new
camera turned by ``yaw_deg_per_frame``, ``set_camera``, the film
cleared, ``reset_progressive``), as the viewer's preview does while the
user drags.

With ``--trace 1`` a ``torch.profiler`` capture covers a slice of the
window (``TRACE_DISPLAYS`` display intervals from display
``TRACE_FROM_DISPLAY``), the harness's calls marked by the spans
``prtbench.frame`` and ``prtbench.display``, and is reduced here
(``tracefile.reduce``).  The profiler starts there for the first time in
the process (its start is outside the spans), and the host spans of the
frames before it are the ones kept: once started, its hooks slow the
host part of every later frame.

    python -m prtbench.cell <plan.json> <rank> <world> <init> <seed> \\
        <seconds> <trace> <device> <out.pkl> <t_launch>

runs one rank of a multi-rank cell (``run.py`` starts them).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch

from prtbench import reference, scenes, tracefile

FORBIDDEN = ("jax", "jaxlib", "flax", "parallelraytracing_tpu")
#: frames of set-up before the window (every shape and path once)
WARMUP_FRAMES = 3
#: frames the loop runs ahead of the card before it waits for it
MAX_PENDING = 4
#: the profiled slice of a ``--trace 1`` run: this many display
#: intervals from this display on (after warm-up, some tens of frames)
TRACE_FROM_DISPLAY = 8
TRACE_DISPLAYS = 2


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark's processes
    may not hold (compared whole: the renderer's own name only begins
    with one of them)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Marks:
    """The end of each frame: a CUDA event recorded on the stream after
    it (read once the window is over), or the host clock on the CPU."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append(ev)
        return ev

    def wait(self, ev) -> None:
        if self.cuda:
            ev.synchronize()

    def intervals_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [m[i].elapsed_time(m[i + 1]) for i in range(len(m) - 1)]
        return [(m[i + 1] - m[i]) * 1e3 for i in range(len(m) - 1)]


def frame_size(plan: dict) -> tuple:
    rnd = plan["config"]["render"]
    scale = int(plan["traffic"].get("scale", 1))
    return max(8, rnd["width"] // scale), max(8, rnd["height"] // scale)


def sample_pixels(seed: int, width: int, height: int, count: int) -> np.ndarray:
    """The pixel ids the check reads, drawn from the seed in a random
    order (so that any first part of them is a sample too)."""
    n = width * height
    rng = np.random.default_rng(int(seed))
    return rng.choice(n, size=min(count, n), replace=False)


def checked_pixels(sample: dict, frames: int, displays: int, orbit: bool) -> int:
    """How many of the drawn pixels the reference follows: all of them,
    unless the window's frames (at rest) or displays (in orbit) would take
    it past ``max_paths`` paths, as a renderer whose frames cost nothing
    would; 0 where one pixel's frames alone pass it (then nothing is
    followed and the run is not correct)."""
    per_pixel = displays + 1 if orbit else frames
    return min(int(sample["pixels"]),
               int(sample["max_paths"]) // max(per_pixel, 1))


def own_cores(rank: int, world: int) -> None:
    """One intra-op thread, on this rank's share of the cores."""
    torch.set_num_threads(1)
    cores = sorted(os.sched_getaffinity(0))
    k = len(cores) // world
    if k:
        os.sched_setaffinity(0, cores[rank * k:(rank + 1) * k])


def run_rank(plan: dict, seed: int, seconds: float, trace: bool,
             rank: int = 0, world: int = 1, device: str = "cuda",
             init: str = "", t_launch: float = 0.0) -> dict:
    cuda = device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist = host = None
    if cuda:
        torch.cuda.set_device(dev)
    if world > 1:
        own_cores(rank, world)
        import torch.distributed as dist
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=init, world_size=world, rank=rank)
        host = dist.new_group(backend="gloo")
    from parallelraytracing_tpu_torch import Film, RenderConfig, create_renderer

    cfg, tr = plan["config"], plan["traffic"]
    rnd = cfg["render"]
    w, h = frame_size(plan)
    rcfg = RenderConfig(width=w, height=h, max_depth=rnd["max_depth"],
                        samples_per_frame=rnd["samples_per_frame"],
                        jitter=rnd["jitter"], seed=seed, nee=rnd["nee"],
                        russian_roulette_depth=rnd["russian_roulette_depth"],
                        t_min=rnd["t_min"], t_max=rnd["t_max"])
    desc = cfg["scene"]
    mats, objs = scenes.expand(desc)
    scene = scenes.build_program_scene(desc, mats, objs)
    orbit = tr["motion"] == "orbit"
    step = float(tr.get("yaw_deg_per_frame", 0.0))

    def camera(k):
        return scenes.program_camera(*scenes.orbit_camera(cfg["camera"], k, step),
                                     w, h)

    renderer = create_renderer(tr.get("engine") or cfg["engine"], dev)
    for knob, value in tr.get("knobs", {}).items():
        setattr(renderer, knob, value)
    film = Film(w, h, dev)
    renderer.init(film, scene, camera(0), rcfg)
    pixels = sample_pixels(seed, w, h, plan["sample"]["pixels"])
    cam_k = 0

    def meet():
        """Every rank here, on the host (no device kernel)."""
        if host is not None:
            dist.barrier(group=host)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
        meet()

    def schedule(decision):
        """Rank 0's [frames to the next display, stop] on every rank."""
        if host is None:
            return decision
        t = torch.tensor(decision, dtype=torch.int64)
        dist.broadcast(t, 0, group=host)
        return t.tolist()

    def move():
        nonlocal cam_k
        cam_k += 1
        renderer.set_camera(camera(cam_k))
        film.clear()
        renderer.reset_progressive()

    def display():
        meet()
        renderer.gather_film()
        return film.display_numpy() if rank == 0 else None

    def profiler():
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        return profile(activities=acts)

    # set-up: every shape and path of the window once
    for _ in range(WARMUP_FRAMES):
        if orbit:
            move()
        renderer.progressive_render()
    display()
    schedule([1, 0])
    if not orbit:
        film.clear()
        renderer.reset_progressive()
    sync()

    # the window
    display_s = float(tr["display_ms"]) * 1e-3
    marks = Marks(cuda)
    host_s = []
    disp_frames, disp_cams, disp_px = [], [], []
    frames = pending = n_disp = slice_frames = slice_disp = 0
    prof, in_slice = None, False
    t0_wall = time.time()
    t0 = last_t = time.perf_counter()
    marks.mark()
    next_disp, last_f = 1, 0
    while True:
        span = (torch.profiler.record_function("prtbench.frame") if in_slice
                else contextlib.nullcontext())
        with span:
            if orbit:
                move()
            h0 = time.perf_counter()
            renderer.progressive_render()
            if prof is None:
                host_s.append(time.perf_counter() - h0)
        ev = marks.mark()
        frames += 1
        pending += 1
        slice_frames += in_slice
        if frames != next_disp:
            if pending >= MAX_PENDING:
                marks.wait(ev)
                pending = 0
            continue
        marks.wait(ev)
        pending = 0
        with (torch.profiler.record_function("prtbench.display") if in_slice
              else contextlib.nullcontext()):
            img = display()
        disp_frames.append(frames)
        disp_cams.append(cam_k)
        if img is not None:
            disp_px.append(img.reshape(-1, 4)[pixels, :3].copy())
        n_disp += 1
        slice_disp += in_slice
        now = time.perf_counter()
        decision = [0, 0]
        if rank == 0:
            ft = (now - last_t) / (frames - last_f)
            remaining = seconds - (now - t0)
            # a traced run goes on until its slice is complete
            slice_due = trace and (prof is None or in_slice)
            stop = remaining <= 0.5 * ft and not slice_due
            gap = display_s if remaining <= 0.5 * ft else min(display_s,
                                                              remaining)
            decision = [max(1, round(gap / ft)), int(stop)]
        n, stop = schedule(decision)
        last_t, last_f = now, frames
        if trace and n_disp == TRACE_FROM_DISPLAY and not stop:
            prof = profiler()
            prof.__enter__()
            in_slice = True
        elif in_slice and n_disp == TRACE_FROM_DISPLAY + TRACE_DISPLAYS:
            prof.__exit__(None, None, None)
            in_slice = False
        if stop:
            break
        next_disp = frames + n
    if in_slice:
        prof.__exit__(None, None, None)
    if cuda:
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()

    pixels = pixels[:checked_pixels(plan["sample"], frames, len(disp_frames),
                                    orbit)]
    raw = {"rank": rank, "frames": frames, "window_s": t1 - t0,
           "t0_wall": t0_wall, "intervals_ms": marks.intervals_ms(),
           "host_s": host_s, "slice_frames": slice_frames,
           "slice_displays": slice_disp, "disp_frames": disp_frames,
           "sample_count": film.sample_count,
           "expected_count": 1 if orbit else frames,
           "pixels": pixels, "width": w, "height": h,
           "memory_peak": (torch.cuda.max_memory_allocated(dev) if cuda
                           else 0),
           "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    if rank == 0:
        raw["disp_px"] = np.stack(disp_px)[:, :len(pixels)]
    if not len(pixels):
        print(f"prtbench rank {rank}: {frames} frames are more than the "
              f"reference can follow ({plan['sample']['max_paths']} paths)",
              file=sys.stderr)
    renderer.gather_film()
    if rank == 0:
        raw["final_hdr"] = film.hdr_average().reshape(-1, 3)[
            torch.from_numpy(pixels).to(dev)].double().cpu().numpy()

    # the program's state goes before the reference runs
    del renderer, film, scene
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    raw["trace"] = None
    if prof is not None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="prtbench_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            raw["trace"] = tracefile.reduce(path, plan["layers"])
        finally:
            os.unlink(path)

    t_ref = time.perf_counter()
    if len(pixels):
        raw.update(reference_share(plan, seed, pixels[rank::world], frames,
                                   disp_frames, disp_cams, cam_k, w, h, dev))
    raw["reference_s"] = time.perf_counter() - t_ref
    raw["forbidden"] = forbidden_modules()
    print(f"prtbench rank {rank}: set-up {t0_wall - t_launch:.3f} s, window "
          f"{t1 - t0:.3f} s ({frames} frames, {len(disp_frames)} displays), "
          f"after it {t_ref - t1:.3f} s, reference {raw['reference_s']:.3f} s; "
          f"{len(os.sched_getaffinity(0))} cores of {os.cpu_count()}, "
          f"load {os.getloadavg()[0]:.2f}",
          file=sys.stderr, flush=True)
    if dist is not None:
        meet()
        dist.destroy_process_group()
    return raw


def reference_share(plan: dict, seed: int, pixels: np.ndarray, frames: int,
                    disp_frames, disp_cams, last_cam: int, w: int, h: int,
                    dev, dtype=torch.float32) -> dict:
    """This rank's share of the reference: at its pixels, the film's mean
    after each display's frames and after the window's (at rest), or each
    display's and the last frame's single frame under its camera (in
    orbit), and the tally of the paths for the roofline's floor."""
    cfg, tr = plan["config"], plan["traffic"]
    rnd = cfg["render"]
    mats, objs = scenes.expand(cfg["scene"])
    sc = reference.RefScene.build(cfg["scene"]["sky"], mats, objs, dev, dtype)
    step = float(tr.get("yaw_deg_per_frame", 0.0))
    counts = reference.new_counts()

    def radiance(cam_index, frame_list):
        eye, view = scenes.orbit_camera(cfg["camera"], cam_index, step)
        return reference.pixel_radiance(
            sc, reference.camera_params(eye, view, w, h), w, h, pixels,
            frame_list, seed, rnd["max_depth"], rnd["t_min"],
            reference.t_cap(rnd["t_max"]), dev, dtype, counts)

    if tr["motion"] == "orbit":
        disp = np.stack([radiance(k, [0])[0] for k in disp_cams])
        final = radiance(last_cam, [0])[0]
        paths = (len(disp_cams) + 1) * len(pixels)
    else:
        rad = radiance(0, range(frames))
        csum = np.cumsum(rad, axis=0)
        disp = np.stack([csum[k - 1] / k for k in disp_frames])
        final = csum[-1] / frames
        paths = frames * len(pixels)
    return {"share": pixels, "ref_disp": disp, "ref_final": final,
            "counts": counts, "paths": paths, "scene_bytes": sc.scene_bytes}


def main(argv) -> int:
    plan_path, rank, world, init, seed, seconds, trace, device, out, t_launch = argv
    with open(plan_path) as f:
        plan = json.load(f)
    raw = run_rank(plan, int(seed), float(seconds), trace == "1", int(rank),
                   int(world), device, init, float(t_launch))
    with open(out, "wb") as f:
        pickle.dump(raw, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
