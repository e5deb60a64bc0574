"""Published peaks of the H100 parts (NVIDIA data sheets; dense rates,
without sparsity), each at the part's full power limit."""

from __future__ import annotations

# bf16 / TF32 tensor-core, fp32 without tensor cores, fp64 tensor-core
# FLOP/s, and HBM bytes/s
PEAKS = {
    "H100 SXM": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12,
                 "fp64": 67e12, "bytes": 3.35e12},
    "H100 NVL": {"bf16": 835e12, "tf32": 418e12, "fp32": 60e12,
                 "fp64": 60e12, "bytes": 3.9e12},
    "H100 PCIe": {"bf16": 756e12, "tf32": 378e12, "fp32": 51.2e12,
                  "fp64": 51.2e12, "bytes": 2.0e12},
}


def part(device_name: str) -> str | None:
    """The H100 part a ``torch.cuda.get_device_name()`` names, or None for
    another card (whose peaks this table does not hold)."""
    if "H100" not in device_name:
        return None
    for key in ("PCIe", "NVL"):
        if key in device_name:
            return f"H100 {key}"
    return "H100 SXM"


def peaks(device_name: str) -> dict | None:
    name = part(device_name)
    return None if name is None else PEAKS[name]
