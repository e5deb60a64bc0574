"""K1: the fused log-mel fbank kernel and its plain PyTorch version.

Counterpart of ``metaasr_tpu/frontend/pallas_fbank.py`` (the Pallas
``_kernel``). The CUDA source is ``csrc/fbank.cu``; its header note gives
the kernel's bound and design. :func:`fused_log_mel` is the one entry
point: on a CPU tensor it runs :func:`plain_log_mel`, on a CUDA tensor it
launches the kernel or raises. Masking of frames past each utterance's
length happens in both; CMVN stays outside, as in the reference.
"""

from __future__ import annotations

import ctypes

import torch

from metaasr_tpu_torch.frontend.oracle import EPS, FRAME_LEN, FRAME_SHIFT
from metaasr_tpu_torch.utils.padding import make_non_pad_mask


def plain_log_mel(audio: torch.Tensor, frame_lens: torch.Tensor,
                  c_cos: torch.Tensor, c_sin: torch.Tensor,
                  mel_t: torch.Tensor) -> torch.Tensor:
    """[B, S] f32 audio, [B] frame lengths -> [B, F, num_mel] log-mel.

    Two matmuls, the power, a matmul and a log, in fp32 (callers keep
    TF32 off on CUDA, as the reference pins HIGHEST precision)."""
    bsz, s = audio.shape
    n_mel = mel_t.shape[1]
    if s < FRAME_LEN:
        return audio.new_zeros((bsz, 0, n_mel))
    frames = audio.unfold(1, FRAME_LEN, FRAME_SHIFT)       # [B, F, 400] view
    real = frames @ c_cos
    imag = frames @ c_sin
    power = real * real + imag * imag
    feats = torch.log(torch.clamp_min(power @ mel_t, EPS))
    mask = make_non_pad_mask(frame_lens, feats.shape[1])[..., None]
    return torch.where(mask, feats, 0.0)


_matrices: dict = {}


def _device_matrices(params, device: torch.device):
    """(c_cos, c_sin, mel_t) of an ``FbankParams`` as f32 tensors on
    ``device``, cached per (params, device): ``FbankParams.create`` returns
    cached instances, so their ids are stable."""
    key = (id(params), device)
    hit = _matrices.get(key)
    if hit is None:
        hit = (params, tuple(
            torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in (params.c_cos, params.c_sin, params.mel_t)))
        _matrices[key] = hit
    return hit[1]


def _launch(audio, frame_lens, c_cos, c_sin, mel_t) -> torch.Tensor:
    from metaasr_tpu_torch.ops import _build

    lib = _build.load("fbank")
    fn = lib.metaasr_fbank_log_mel
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    bsz, s = audio.shape
    n_mel = mel_t.shape[1]
    lib.metaasr_fbank_max_mel.restype = ctypes.c_int
    if n_mel > lib.metaasr_fbank_max_mel():
        raise ValueError(f"num_mel_bins {n_mel} exceeds the kernel's "
                         f"{lib.metaasr_fbank_max_mel()}")
    nf = max(0, 1 + (s - FRAME_LEN) // FRAME_SHIFT)
    out = torch.empty((bsz, nf, n_mel), dtype=torch.float32,
                      device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    rc = fn(audio.data_ptr(), frame_lens.data_ptr(), c_cos.data_ptr(),
            c_sin.data_ptr(), mel_t.data_ptr(), out.data_ptr(),
            bsz, s, nf, n_mel, stream)
    if rc != 0:
        raise RuntimeError(f"fbank kernel launch failed: cudaError {rc}")
    fused_log_mel.launches += 1
    return out


def fused_log_mel(audio: torch.Tensor, frame_lens: torch.Tensor,
                  params) -> torch.Tensor:
    """[B, S] f32 waveforms + [B] int32 frame lengths -> [B, F, num_mel]
    masked log-mel features. ``params`` is a ``frontend.fbank.FbankParams``.

    A CPU tensor runs the plain version; a CUDA tensor launches K1 (the
    ``launches`` attribute counts those launches) or raises."""
    if audio.dim() != 2 or audio.dtype != torch.float32:
        raise ValueError(f"audio must be [B, S] float32, got "
                         f"{tuple(audio.shape)} {audio.dtype}")
    if frame_lens.shape != (audio.shape[0],):
        raise ValueError(f"frame_lens must be [{audio.shape[0]}], got "
                         f"{tuple(frame_lens.shape)}")
    if frame_lens.device != audio.device:
        raise ValueError("audio and frame_lens must be on one device")
    mats = _device_matrices(params, audio.device)
    if audio.device.type == "cpu":
        return plain_log_mel(audio, frame_lens, *mats)
    if audio.device.type != "cuda":
        raise ValueError(f"unsupported device {audio.device}")
    if frame_lens.dtype != torch.int32:
        raise ValueError(f"frame_lens must be int32, got {frame_lens.dtype}")
    if not (audio.is_contiguous() and frame_lens.is_contiguous()):
        raise ValueError("audio and frame_lens must be contiguous")
    return _launch(audio, frame_lens, *mats)


fused_log_mel.launches = 0
