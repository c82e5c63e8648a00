"""Precisions of the reference: bfloat16 rounding where the
configuration states a bfloat16 operand, and the control's TF32 (float32
operands rounded to TF32's 10-bit mantissa, products and sums in
float32, as the tensor cores compute with TF32 on), emulated so that it
reads the same on the CPU and the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (nearest even), kept in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (nearest even on the 13 dropped bits), kept
    in float32."""
    bits = t.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _LinearTF32(torch.autograd.Function):
    """``x @ w.T + b`` with every product's operands rounded to TF32, in
    the backward pass too."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.t() + b

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_tf32(g)
        return gr @ wr, gr.t() @ xr, g.sum(0)


def linear(x, w, b, precision: str):
    """A dense layer in ``precision`` (``float32``: TF32 off; ``tf32``:
    the control)."""
    if precision == "tf32":
        return _LinearTF32.apply(x, w, b)
    return F.linear(x, w, b)


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand of an edge product in ``precision``: rounded to TF32
    in the forward pass for the control (the gradient passes straight
    through), unchanged otherwise."""
    if precision != "tf32":
        return t
    return t + (round_tf32(t.detach()) - t.detach())


def dropout(x, generator, p: float, cap_rows: int):
    """Inverted dropout with the mask of one ``[cap_rows, width]`` draw
    from ``generator``; ``x`` holds the first rows of that padded shape
    (the program draws a mask for its padded rows, then computes
    ``x * keep / (1 - p)``)."""
    keep = torch.rand((cap_rows, x.shape[1]), generator=generator,
                      device=x.device) >= p
    return x * keep[: x.shape[0]] / (1.0 - p)
