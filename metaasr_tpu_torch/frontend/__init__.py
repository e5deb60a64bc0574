from metaasr_tpu_torch.frontend.fbank import (
    FbankParams,
    log_mel_fbank,
    num_frames,
)
from metaasr_tpu_torch.frontend.specaug import spec_augment

__all__ = ["FbankParams", "log_mel_fbank", "num_frames", "spec_augment"]
