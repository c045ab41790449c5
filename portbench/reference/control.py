"""The control: the reference in the nearest precision below the
configuration's float32.

The configurations' float32 arithmetic is FFTs and elementwise passes,
where no TF32 mode exists (TF32 is a matrix-multiply mode, and the one
matrix product, the PCA clean, is stated in float64), so the step below
float32 is bfloat16.  cuFFT has no bfloat16 transform, so the control
keeps every stored field in bfloat16: each stage's output is rounded to
bfloat16 at the stage boundary, and the arithmetic inside a stage runs in
float64.  That is kinder to the control than bfloat16 arithmetic, so a
comparison that fails it fails bfloat16 work too.
"""
from __future__ import annotations

import torch


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and widened back (complex: each part)."""
    if x.is_complex():
        return torch.complex(bf16_round(x.real), bf16_round(x.imag))
    return x.to(torch.bfloat16).to(x.dtype)
