"""The comparison that decides ``correct``.

Each rank hands back what the timed path produced (rank 0: the film's HDR
mean after the window and the tonemapped image of every display, read at
the pixels drawn from the seed; every rank: its film's sample count) and
its share of the reference at those pixels.  Three numbers are compared,
each with its limit from the cell's ``checks/<workload>.json``:

- ``frames_gap``: the largest distance between a rank's film sample count
  and the frames it accumulated since its last clear (exact: limit 0);
- ``hdr_bad_share``: the share of the pixels' channels whose film HDR
  mean after the window is more than ``HDR_TOLERANCE`` x (|reference| +
  0.01) away from the reference's mean after the same frames;
- ``display_bad_share``: the share of the displays' pixel channels whose
  8-bit value is more than 1 away from the reference's tonemap of its
  own mean after the same frames (1 allows the rounding of a float sum
  that lands on a step).

A path that grazes a primitive can take another branch on the card than
in the reference, so the two shares count pixels that are off, not how
far off: a handful of such paths moves neither far, while a wrong image
moves both to most of the pixels.  Their limits are set between what sound runs read and what the
control (the reference in bfloat16) reads.
"""

from __future__ import annotations

import numpy as np
import torch

from prtbench import reference

#: pixels drawn from the seed that the reference follows, and the most
#: paths it follows over a run (fewer pixels where the frames would pass it)
PIXELS = 4096
MAX_PATHS = 16_000_000
#: the 8-bit distance a display's channel may be off by
DISPLAY_TOLERANCE = 1
#: the relative distance a film channel's mean may be off by: far above
#: the float32 sum's rounding over thousands of frames (~1e-5)
HDR_TOLERANCE = 1e-3


def assemble(raws: list, key: str) -> np.ndarray:
    """A reference quantity whose last-but-one axis runs over the pixels,
    put together from the ranks' shares in the order of the drawn
    pixels."""
    pixels = raws[0]["pixels"]
    pos = {int(p): i for i, p in enumerate(pixels)}
    first = np.asarray(raws[0][key])
    out = np.empty(first.shape[:-2] + (len(pixels), 3), np.float64)
    for r in raws:
        idx = [pos[int(p)] for p in r["share"]]
        out[..., idx, :] = np.asarray(r[key])
    return out


def tonemap(hdr: np.ndarray) -> np.ndarray:
    return reference.tonemap(torch.from_numpy(
        np.asarray(hdr, np.float32))).numpy()


def numbers(raws: list, final_hdr=None, disp_px=None) -> dict:
    """The compared numbers of a run, from its ranks' raw records; the
    program's outputs default to rank 0's."""
    r0 = raws[0]
    frames_gap = float(max(abs(r["sample_count"] - r["expected_count"])
                           for r in raws))
    if any("ref_final" not in r for r in raws):
        # the reference could not follow the window's frames
        return {"frames_gap": frames_gap, "hdr_bad_share": None,
                "display_bad_share": None}
    final_hdr = r0["final_hdr"] if final_hdr is None else final_hdr
    disp_px = r0["disp_px"] if disp_px is None else disp_px
    ref_final = assemble(raws, "ref_final")
    ref_disp = assemble(raws, "ref_disp")
    off = np.abs(np.asarray(final_hdr, np.float64) - ref_final)
    gap = np.abs(np.asarray(disp_px, np.int64)
                 - tonemap(ref_disp).astype(np.int64))
    return {
        "frames_gap": frames_gap,
        # NaN is off too: the comparison below is False for it
        "hdr_bad_share": float(np.mean(~(off <= HDR_TOLERANCE
                                          * (np.abs(ref_final) + 0.01)))),
        "display_bad_share": float(np.mean(gap > DISPLAY_TOLERANCE)),
    }


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every compared number, and whether
    each is within its limit (``ok``; a number that could not be worked
    out, None, is not)."""
    return {k: {"value": v, "limit": limits[k],
                "ok": v is not None and bool(v <= limits[k])}
            for k, v in values.items()}
