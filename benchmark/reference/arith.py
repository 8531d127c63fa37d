"""The arithmetic a reference computes in: float64, or the control's
float32 with every matrix product's operands rounded to TF32 (10 mantissa
bits), as the tensor cores take them."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class Arith:
    """The precision the reference computes in: float64, or the control's
    float32 with TF32 products."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64

    def mm(self, a, b):
        if self.tf32:
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)
