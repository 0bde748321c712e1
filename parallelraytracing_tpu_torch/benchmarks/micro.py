"""The card's float32 and memory peaks: the roofline's ceiling, measured.

The counterpart of ``benchmarks/micro.py::vpu_peak_vmem`` (the JAX
package's float32 peak kernel): ``peak_chains`` runs 8 independent chains
per element for ``loops`` iterations in the hand-written kernel
csrc/micro.cu (mix "fma": two multiply-adds per chain per iteration;
"slab": a multiply-add, then the slab test's min / max / select round) and
writes the chains' sum; ``peak_chains_reference`` is its plain PyTorch
version (a multiply-add as a float64 product and sum rounded to float32).
``fp32_peak`` times the kernel and returns (seconds, operations) in the
JAX micro's unit, one operation per lane op with a multiply-add counted
once, which is one instruction: the unit in which the port's operation
counts (benchmarks/roofline.py) are written, since the kernels build with
-fmad=false.  ``flops`` counts a multiply-add as 2, the data sheet's unit.
``read_rate`` is the bytes peak: a plain torch read (a sum) of a 4 GiB
tensor, as the JAX micro measures streaming bandwidth with plain XLA ops.

    python -m parallelraytracing_tpu_torch.benchmarks.micro          # the card
    python -m parallelraytracing_tpu_torch.benchmarks.micro --device cpu

On the CPU it checks the plain version at a small size and measures
nothing: a rate comes only from the card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

MIXES = ("fma", "slab")
#: operations per iteration per element: 8 chains x 2 multiply-adds, or 8
#: multiply-adds and 8 min / max / select (the JAX micro's ops_per_iter)
OPS_PER_ITER = {"fma": 16, "slab": 16}
#: the same with a multiply-add counted as 2 floating-point operations
FLOPS_PER_ITER = {"fma": 32, "slab": 24}
#: elements (one thread each): 4 waves of 2048 threads on each of the
#: H100's 132 SMs; iterations per element
N_ELEMS, LOOPS = 132 * 2048 * 4, 4096
#: the bytes peak's tensor
READ_BYTES = 4 << 30


def _f32(v: float) -> float:
    return float(np.float32(v))


def init_scales() -> list:
    """Chain k starts at x * float32(0.5 + 0.05 k)."""
    return [_f32(0.5 + 0.05 * k) for k in range(8)]


def fma_rounds() -> list:
    """Chain k's two multiply-adds (scale, addend) of the "fma" mix."""
    return [((_f32(1.0 + (k + 1) * 1e-7), _f32((k + 1) * 1e-7)),
             (_f32(1.0 - (k + 1) * 1e-7), -_f32((k + 1) * 1e-7)))
            for k in range(8)]


#: the "slab" mix's multiply-adds (scale, addend), chains a-h
SLAB_FMAS = [(_f32(c), _f32(b)) for c, b in (
    (1.0000001, -1e-7), (0.9999999, 1e-7), (1.0000002, -2e-7),
    (0.9999998, 2e-7), (1.0000003, -3e-7), (0.9999997, 3e-7),
    (1.0000004, -4e-7), (0.9999996, 4e-7))]


def _fma(a, scale: float, addend: float):
    """fmaf on float32 a: the float64 product (exact) plus the addend,
    rounded to float32 (once through float64, so a result within one ulp
    of fmaf's)."""
    return (a.double() * scale + addend).float()


def peak_chains_reference(x, loops: int, mix: str = "fma"):
    """Plain PyTorch version of ``peak_chains``: the chains' sum per
    element, (n,) float32."""
    c = [x * s for s in init_scales()]
    for _ in range(loops):
        if mix == "fma":
            for k, ((s1, b1), (s2, b2)) in enumerate(fma_rounds()):
                c[k] = _fma(_fma(c[k], s1, b1), s2, b2)
        else:
            c = [_fma(v, s, b) for v, (s, b) in zip(c, SLAB_FMAS)]
            a, b, cc, d, e, f, g, h = c
            a = torch.minimum(a, e)
            b = torch.maximum(b, f)
            cc = torch.minimum(cc, g)
            d = torch.maximum(d, h)
            e = torch.clamp_min(e, _f32(0.1))
            f = torch.clamp_max(f, 10.0)
            g = torch.where(g > cc, g, cc)
            h = torch.where(h < d, h, d)
            c = [a, b, cc, d, e, f, g, h]
    out = c[0]
    for v in c[1:]:
        out = out + v
    return out


def peak_chains(x, loops: int, mix: str = "fma"):
    """The chains' sum per element of float32 x, (n,) float32: on a CUDA
    tensor the kernel csrc/micro.cu (or raise), counted on
    ``peak_chains.launches``; on a CPU tensor ``peak_chains_reference``."""
    if mix not in MIXES:
        raise ValueError(f"mix {mix!r}: want one of {MIXES}")
    if x.device.type == "cpu":
        return peak_chains_reference(x, loops, mix)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("peak_chains takes a contiguous (n,) float32 tensor "
                         "on cpu or cuda")
    from parallelraytracing_tpu_torch.ops import _build
    from parallelraytracing_tpu_torch.ops.trace import stream_of
    out = torch.empty_like(x)
    err = _build.load("micro")(*stream_of(x.device), x.data_ptr(),
                               out.data_ptr(), int(x.shape[0]), int(loops),
                               MIXES.index(mix))
    if err != 0:
        raise RuntimeError(f"micro kernel launch failed: cudaError_t {err}")
    peak_chains.launches += 1
    return out


peak_chains.launches = 0


def _cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()  # warm-up (and the first call's build)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def operations(mix: str, loops: int, n: int) -> int:
    """Lane operations of one launch, a multiply-add counted once."""
    return n * loops * OPS_PER_ITER[mix]


def flops(mix: str, loops: int, n: int) -> int:
    """The same with a multiply-add counted as 2."""
    return n * loops * FLOPS_PER_ITER[mix]


def fp32_peak(mix: str = "fma", loops: int = LOOPS, n: int = N_ELEMS,
              reps: int = 5):
    """(seconds per launch, operations per launch) of ``peak_chains`` on
    the card, x = 0.5 everywhere, CUDA events over `reps` launches after
    a warm-up.  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("fp32_peak measures the card: no CUDA device")
    x = torch.full((n,), 0.5, dtype=torch.float32, device="cuda")
    ms = _cuda_ms(lambda: peak_chains(x, loops, mix), reps)
    return ms / 1e3, operations(mix, loops, n)


def loop_ratio(mix: str = "fma", loops: int = LOOPS) -> float:
    """``fp32_peak``'s time at `loops` over its time at loops // 2: about
    2 when the kernel runs the iterations it is given.  The values alone
    cannot show a short count: the chains drift by less than a last bit
    per iteration, so a few iterations fewer stay within the plain check's
    tolerance."""
    return fp32_peak(mix, loops)[0] / fp32_peak(mix, loops // 2)[0]


def read_rate(nbytes: int = READ_BYTES, reps: int = 5) -> float:
    """Bytes per second of one torch sum over a float32 tensor of
    `nbytes` on the card (each byte read once), CUDA events over `reps`
    sums after a warm-up."""
    x = torch.ones((nbytes // 4,), dtype=torch.float32, device="cuda")
    ms = _cuda_ms(lambda: x.sum(), reps)
    del x
    return nbytes / (ms / 1e3)


def sass_counts() -> dict:
    """Instructions of each micro kernel in its SASS (``cuobjdump -sass``
    of the built library): {kernel: {opcode: count}} for FFMA, FMUL,
    FADD, FMNMX, FSEL, the float32 instructions the chains compile to."""
    from parallelraytracing_tpu_torch.ops import _build
    lib = _build.build("micro")
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = "fma" if "ILi0E" in m.group(1) else "slab"
            out[name] = {op: 0 for op in ("FFMA", "FMUL", "FADD", "FMNMX",
                                          "FSEL")}
        elif name:
            m = re.search(r"\b(FFMA|FMUL|FADD|FMNMX|FSEL)\b", ln)
            if m:
                out[name][m.group(1)] += 1
    return out


def check_plain(device, loops: int, n: int) -> dict:
    """Max relative difference of the kernel (or on the CPU the plain
    version itself) against the plain version on n elements: the kernel's
    fmaf rounds once where the plain version rounds through float64, a
    last-bit difference at most per rounding, carried along the chain."""
    x = torch.linspace(0.25, 1.0, n, dtype=torch.float32, device=device)
    out = {}
    for mix in MIXES:
        k = peak_chains(x, loops, mix)
        p = peak_chains_reference(x.cpu(), loops, mix).to(device)
        out[mix] = float(((k - p).abs() / p.abs()).max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cpu":
        print(json.dumps({"device": "cpu", "plain_rel_err": check_plain(
            "cpu", 4, 1024), "rates": "not measured (no card)"}))
        return 0
    if not torch.cuda.is_available():
        print("micro: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    rec = {"device": torch.cuda.get_device_name(0),
           "vs_plain_rel_err": check_plain("cuda", 64, 4096)}
    for mix in MIXES:
        sec, ops = fp32_peak(mix)
        rec[mix] = dict(ms=sec * 1e3, tops=ops / sec / 1e12,
                        tflops=flops(mix, LOOPS, N_ELEMS) / sec / 1e12)
    rec["read_tb_per_s"] = read_rate() / 1e12
    rec["sass"] = sass_counts()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
