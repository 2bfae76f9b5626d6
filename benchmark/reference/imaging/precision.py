"""The precision tiers shared by the dot finish and the dispersion transforms
(``GatherConfig.precision``, ``DispersionConfig.precision``): ``"f32"``
contracts at full width (TF32 off); ``"bf16"`` rounds the contraction
operands through bfloat16 and sums in float32."""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "bf16")


def check_precision(precision: str) -> None:
    """Raise ``ValueError`` naming ``precision`` for an unknown tier (the JAX
    package's text)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round a real tensor through bfloat16 (to nearest even); float32 out."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_round_complex(x: torch.Tensor) -> torch.Tensor:
    """Round the real and imaginary parts of a complex tensor through
    bfloat16; complex64 out (the JAX package's ``_bf16_round_complex``)."""
    return torch.complex(bf16_round(x.real), bf16_round(x.imag))
