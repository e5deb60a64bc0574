"""Device resolution and the fp32 precision policy of the port's entry points.

The default device is CUDA. There is no fallback: asking for CUDA on a
machine without it raises, and the CPU runs only when the caller names it
(``device="cpu"``, as the tests do).

Every entry point (the CLI's trainers, ``MonoASRTrainer``,
``MetaASRTrainer``, ``ServingDecoder`` through ``ASRTask``) resolves its
device here, and :func:`resolve_device` applies the one precision policy,
:func:`apply_precision_policy`: TF32 for cuBLAS fp32 matrix products and
cuDNN fp32 convolutions when ``ALLOW_TF32`` is true (the default). The
reference pins fp32 HIGHEST only in its front-end, which here is K1, the
port's own fp32 kernel, and leaves every other fp32 product at XLA's
default precision; K1, K2, K2b, K3 and K3b are fp32 code of the port's own
and unaffected either way.
"""

from __future__ import annotations

import torch

ALLOW_TF32 = True  # set False before resolving a device to run strict fp32


def apply_precision_policy() -> None:
    """Set PyTorch's fp32 precision flags to the port's policy. They are
    process-wide and only change CUDA work."""
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent. Applies
    the precision policy."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    apply_precision_policy()
    return dev
