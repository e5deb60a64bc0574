"""Products in a stated precision, for the reference and its controls.

``fp32``: float32 with TF32 off (the caller turns PyTorch's TF32 flags off
before running the reference). ``tf32``: each operand rounded to TF32's
10-bit mantissa (to nearest), the product in float32. ``bf16``: each operand
rounded to bfloat16, the product accumulated in float32. ``fp8``: each
operand scaled per tensor into float8 e4m3's range (largest magnitude to
448) and rounded to it, the product accumulated in float32 and scaled back.
A product's result is rounded to the precision too, as a program computing
in that type stores it: the program's bf16 layers keep their inputs and
outputs in bf16, so the step below keeps both in fp8. (Mixed fp8 recipes,
whose products read fp8 and write bf16, round the operands alone.)
Gradients pass the rounding straight through, and the saved operands of
the backward are the rounded ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to this precision, kept in float32."""
        if self.name == "fp32":
            return x
        if self.name == "tf32":
            bits = x.detach().float().contiguous().view(torch.int32)
            q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
            return _straight(x, q.to(x.dtype))
        if self.name == "bf16":
            return _straight(x, x.to(torch.bfloat16).to(x.dtype))
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = FP8_MAX / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
        return _straight(x, q)

    def linear(self, x, w, b=None):
        y = self.round(F.linear(self.round(x), self.round(w)))
        return y if b is None else self.round(y + self.round(b))

    def conv2d(self, x, w, b, stride: int = 1, padding: int = 0):
        y = self.round(F.conv2d(self.round(x), self.round(w), None,
                                stride=stride, padding=padding))
        return self.round(y + self.round(b)[None, :, None, None])

    def matmul(self, a, b):
        return self.round(self.round(a) @ self.round(b))


def _straight(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``q``'s value with ``x``'s gradient."""
    return x + (q - x).detach()


def strict_fp32() -> None:
    """TF32 off for cuBLAS and cuDNN: the reference's float32 is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
