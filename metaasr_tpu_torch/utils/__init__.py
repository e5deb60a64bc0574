from metaasr_tpu_torch.utils.padding import (
    bucket_length,
    make_non_pad_mask,
    make_pad_mask,
    pad_to,
    subsampled_lengths,
)

__all__ = [
    "make_pad_mask",
    "make_non_pad_mask",
    "subsampled_lengths",
    "pad_to",
    "bucket_length",
]
