"""float32 sqrt, rsqrt, sin and cos that round the same on every device.

PyTorch's own float32 ``sqrt`` on the CPU is not always correctly rounded,
``rsqrt`` on CUDA is an approximation, and ``sin``/``cos`` differ between
the CPU and CUDA libraries in the last bit.  The plain versions of the
kernels take these from float64 and round once to float32, which is what
the CUDA kernels compute (IEEE ``sqrtf``, ``1.0f / sqrtf``, and float64
``sin``/``cos`` rounded to float), so a plain version gives the same bits
on the CPU and on the card.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x), each step rounded to float32 (not a fused rsqrt)."""
    return 1.0 / sqrt(x)


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).float()


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).float()
