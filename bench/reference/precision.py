"""The products of the reference and of its control.

``exact`` is ``torch.matmul`` in float32 with TF32 off (``strict_float32``
switches it off for the whole process: a float32 product on this card
may otherwise run as TF32).  ``fp8`` is the control: the reference with
both operands of every product rounded to float8 e4m3 with one scale a
tensor (its largest magnitude to e4m3's largest, 448), as an fp8 training
step would take them, and the product summed in float32.  Gradients pass
the rounding unchanged (straight through), so the backward's products
read the rounded operands the forward saved.
"""

from __future__ import annotations

import torch

__all__ = ["strict_float32", "exact", "fp8", "PRODUCTS"]

E4M3_MAX = 448.0


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


class _RoundE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_RoundE4M3.apply(a), _RoundE4M3.apply(b))


PRODUCTS = {"float32": exact, "fp8": fp8}
