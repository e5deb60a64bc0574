"""Serving: bundles, ``ServingDecoder`` and the dynamic batcher.

The reference's ``ExportSpec``, ``export_bundle`` and ``make_decode_fn``
(``jax.export`` programs) have no counterpart: the port's bundles carry
weights and config only (``write_bundle``). In place of the reference's
``cast_weights``, a bf16 bundle's weights are rounded by
``export.round_to_bf16`` and kept in fp32 tensors."""

from metaasr_tpu_torch.serve.batcher import DynamicBatcher
from metaasr_tpu_torch.serve.export import (
    ServingDecoder,
    pack_decode_outputs,
    unpack_decode_outputs,
    write_bundle,
)

__all__ = ["DynamicBatcher", "ServingDecoder", "pack_decode_outputs",
           "unpack_decode_outputs", "write_bundle"]
