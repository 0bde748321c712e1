"""Device-resident accumulating film.

The counterpart of ``parallelraytracing_tpu.core.film`` (the reference
Film, src/core/film.{h,cu}): linear RGB accumulation in float32 with
per-pixel weights, and a display conversion doing weight-normalize ->
Reinhard x/(1+x) -> gamma 1/2.2 -> u8 with +0.5 rounding.  Samples stay
on the film's device; only the display image is fetched.  Accumulation
updates the buffers in place (the JAX package donates them instead), and
copies nothing from the host, so the host never waits for the card there.

An engine may install a storage layout (``set_layout``): accum and
weights then live as flat (slots,) buffers in the engine's pixel order
(the fused engine's Morton order), so a frame accumulates with no gather;
the layout is undone only at display, read-out and checkpoint time.
A layout may also name the block of slots this process accumulates (the
sharded engine's px block, ``block``): a frame then brings only that
block, and the other slots hold what the last gather over the ranks put
there (parallel/sharding.gather_film).
Checkpoints (accum, weights, sample count, frame index) are canonical
pixel order, so any engine can resume any checkpoint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from parallelraytracing_tpu_torch.utils.profiling import annotate


def display_rgba(hdr: torch.Tensor, exposure: float = 1.0,
                 gamma: float = 2.2) -> torch.Tensor:
    """The display transform of an (H, W, 3) HDR image: exposure,
    Reinhard x / (1 + x), gamma 1 / `gamma`, then u8 with +0.5 rounding;
    (H, W, 4) uint8 with an opaque alpha."""
    x = hdr * torch.tensor(exposure, dtype=torch.float32)
    x = x / (1.0 + x)                          # Reinhard (film.h:63-69)
    x = torch.pow(torch.clamp_min(x, 0.0),
                  torch.tensor(1.0 / gamma, dtype=torch.float32))
    rgb = (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


class Film:
    def __init__(self, width: int, height: int, device):
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        #: pixel id -> storage slot, or None for the canonical (H, W) layout
        self.resize(width, height)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def set_layout(self, layout) -> None:
        """Install (inv, slots) — inv (H*W,) pixel -> slot — or None for the
        canonical layout; a third entry (lo, hi) makes slots [lo, hi) the
        block this process accumulates.  Accumulated content is converted,
        not dropped."""
        self.block = None if layout is None or len(layout) < 3 else (
            int(layout[2][0]), int(layout[2][1]))
        if layout is None:
            if self._layout_inv is None:
                return
            self.accum = self._canonical(self.accum)
            self.weights = self._canonical(self.weights)
            self._layout_inv = None
            self._slots = 0
            return
        inv, slots = layout[:2]
        if isinstance(inv, np.ndarray):
            inv = torch.from_numpy(inv.astype(np.int64))  # a copy: writable
        inv = inv.to(device=self.device, dtype=torch.int64)
        slots = int(slots)
        if inv.shape != (self.height * self.width,):
            raise ValueError(f"layout inv {tuple(inv.shape)} does not match "
                             f"a {self.width}x{self.height} film")
        if slots < self.height * self.width:
            raise ValueError(f"{slots} slots for {self.height * self.width} pixels")
        if self._layout_inv is not None:
            if slots == self._slots and torch.equal(inv, self._layout_inv):
                return
            acc = self._canonical(self.accum)
            w = self._canonical(self.weights)
        else:
            acc, w = self.accum, self.weights
        self._layout_inv = inv
        self._slots = slots
        self.accum = self._zeros(slots, 3)
        self.accum[inv] = acc.reshape(-1, 3)
        self.weights = self._zeros(slots)
        self.weights[inv] = w.reshape(-1)

    def _canonical(self, flat: torch.Tensor) -> torch.Tensor:
        """Gather a (slots, ...) storage buffer back to (H, W, ...)."""
        img = flat[self._layout_inv]
        return img.reshape((self.height, self.width) + tuple(flat.shape[1:]))

    def resize(self, width: int, height: int) -> None:
        """Film::Resize (film.cu:11-23): new empty buffers of the new size
        on the film's device, in the canonical layout (a layout belongs to
        one resolution)."""
        self.width = int(width)
        self.height = int(height)
        self._layout_inv = None
        self._slots = 0
        #: the slots [lo, hi) this process accumulates, or None: every slot
        self.block = None
        self.accum = self._zeros(self.height, self.width, 3)
        self.weights = self._zeros(self.height, self.width)
        self.sample_count = 0

    def clear(self) -> None:
        """Film::Clear (film.cu:25-35): drop the accumulation, keeping the
        storage layout (the progressive reset after a camera move)."""
        with annotate("prt.film_clear"):
            self.accum = torch.zeros_like(self.accum)
            self.weights = torch.zeros_like(self.weights)
            self.sample_count = 0

    def add_sample_buffer(self, rgb: torch.Tensor, weight: float = 1.0) -> None:
        """Accumulate one frame of per-pixel radiance: (H,W,3) or (H*W,3),
        or (slots,3) in the installed storage layout, or (hi - lo, 3) of its
        block.  The weight stays a Python float: each op casts it to
        float32, the arithmetic of a float32 weight tensor with no upload."""
        weight = float(weight)
        if self.block is not None:
            lo, hi = self.block
            self.accum[lo:hi] += rgb.reshape(hi - lo, 3).to(torch.float32) * weight
            self.weights[lo:hi] += weight
            self.sample_count += 1
            return
        if self._layout_inv is not None:
            rgb = rgb.reshape(self._slots, 3)
        else:
            rgb = rgb.reshape(self.height, self.width, 3)
        self.accum += rgb.to(torch.float32) * weight
        self.weights += weight
        self.sample_count += 1

    def add_sample(self, x: int, y: int, rgb, weight: float = 1.0) -> None:
        """Film::AddSample (film.cu:37-55): accumulate one sample into one
        pixel; a pixel outside the film is ignored, as in the reference."""
        if not (0 <= x < self.width and 0 <= y < self.height):
            return
        rgb = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        if self._layout_inv is not None:
            slot = self._layout_inv[y * self.width + x]
            self.accum[slot] += rgb * weight
            self.weights[slot] += weight
            return
        self.accum[y, x] += rgb * weight
        self.weights[y, x] += weight

    def add_sample_slots(self, slots: torch.Tensor, rgb: torch.Tensor,
                         weight: float = 1.0) -> None:
        """Accumulate a subset of storage slots (the adaptive engine's
        selected pixels): slots (B,) index the installed storage layout
        (or the flat H*W order), rgb (B, 3).  Each pixel's weight counts
        its own samples, so its mean stays exact; a slot given twice
        accumulates twice.  The slots' weights are filled on the film's
        device, not uploaded."""
        weight = float(weight)
        slots = slots.to(device=self.device, dtype=torch.int64)
        rgb = rgb.to(torch.float32) * weight
        w = rgb.new_full(slots.shape, weight)
        if self._layout_inv is None:
            self.accum.view(-1, 3).index_add_(0, slots, rgb)
            self.weights.view(-1).index_add_(0, slots, w)
        else:
            self.accum.index_add_(0, slots, rgb)
            self.weights.index_add_(0, slots, w)
        self.sample_count += 1

    def _canonical_buffers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._layout_inv is None:
            return self.accum, self.weights
        return self._canonical(self.accum), self._canonical(self.weights)

    def hdr_average(self) -> torch.Tensor:
        """Weight-normalized linear HDR image (H,W,3)."""
        accum, weights = self._canonical_buffers()
        w = weights[..., None]
        safe = w > 0.0
        return torch.where(safe, accum / torch.where(safe, w, 1.0), 0.0)

    def to_display(self, exposure: float = 1.0, gamma: float = 2.2) -> torch.Tensor:
        """UpdateDisplay -> (H,W,4) uint8 on the film's device."""
        return display_rgba(self.hdr_average(), exposure, gamma)

    def display_numpy(self, exposure: float = 1.0, gamma: float = 2.2) -> np.ndarray:
        with annotate("prt.display"):
            return self.to_display(exposure, gamma).cpu().numpy()

    def save_png(self, path: str, exposure: float = 1.0, gamma: float = 2.2) -> None:
        from parallelraytracing_tpu_torch.utils.png import write_png
        write_png(path, self.display_numpy(exposure, gamma))

    def save_pfm(self, path: str) -> None:
        """Write the linear HDR average as a little-endian Portable Float
        Map (rows bottom-to-top)."""
        img = self.hdr_average().cpu().numpy().astype(np.float32)
        with open(path, "wb") as f:
            f.write(b"PF\n")
            f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
            f.write(b"-1.0\n")  # negative scale = little-endian
            f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, path: str, frame_index: int = 0) -> None:
        accum, weights = self._canonical_buffers()
        np.savez(path, accum=accum.cpu().numpy(), weights=weights.cpu().numpy(),
                 sample_count=self.sample_count, frame_index=frame_index,
                 width=self.width, height=self.height)

    @classmethod
    def load_checkpoint(cls, path: str, device) -> Tuple["Film", int]:
        with np.load(path) as z:
            film = cls(int(z["width"]), int(z["height"]), device)
            film.accum = torch.from_numpy(z["accum"]).to(film.device)
            film.weights = torch.from_numpy(z["weights"]).to(film.device)
            film.sample_count = int(z["sample_count"])
            return film, int(z["frame_index"])
