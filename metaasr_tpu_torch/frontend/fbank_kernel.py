"""K1: the log-mel fbank kernel and its plain PyTorch versions.

Counterpart of ``metaasr_tpu/frontend/pallas_fbank.py`` (the Pallas
``_kernel``). The CUDA source is ``csrc/fbank.cu``; its header note gives
the kernel's bound and design: per frame, the front-end one step at a time
and a 512-point real FFT in float64, then a sparse mel projection.
:func:`fused_log_mel` is the one entry point: on a CPU tensor it runs
:func:`plain_log_mel` (the folded matrix product of the reference), on a
CUDA tensor it launches the kernel or raises. :func:`plain_log_mel_unfolded`
writes the kernel's algorithm in PyTorch for the tests; nothing on the main
path calls it. Frames past each utterance's length are 0 in all three;
CMVN stays outside, as in the reference.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from metaasr_tpu_torch.frontend.oracle import EPS, FRAME_LEN, FRAME_SHIFT, N_FFT
from metaasr_tpu_torch.utils.padding import make_non_pad_mask

N_BINS = N_FFT // 2     # 256: bins 0..255, Nyquist dropped
MAX_MEL = 128           # the reference Pallas path's padded mel width


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


def mel_ranges(mel_t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The mel banks [256, M] compacted: ([M, 2] int32 (lo, hi), filter
    m's bins lo..hi-1, and [widest filter, M] float32 weights, filter m's
    weight of bin lo + t at [t, m], 0 past its end). A Kaldi triangle's
    non-zero bins are contiguous; an empty filter has lo = hi."""
    n_mel = mel_t.shape[1]
    bins = np.zeros((n_mel, 2), np.int32)
    for m in range(n_mel):
        nz = np.flatnonzero(mel_t[:, m])
        if nz.size:
            bins[m] = nz[0], nz[-1] + 1
    width = int((bins[:, 1] - bins[:, 0]).max())
    weights = np.zeros((width, n_mel), np.float32)
    for m, (lo, hi) in enumerate(bins):
        weights[: hi - lo, m] = mel_t[lo:hi, m]
    return bins, weights


def twiddles() -> np.ndarray:
    """[504, 2] float64 (re, im) of W^e, W = exp(-2 pi i / 512), in the
    order the kernel reads them: W^(8 r m) for the second radix-8 pass
    (r = 1..7, m = 0..7), W^(2 r j) for the radix-4 pass (r = 1..3,
    j = 0..63), then W^k for the real split (k = 0..255)."""
    r2, m = np.meshgrid(np.arange(1, 8), np.arange(8), indexing="ij")
    r3, j = np.meshgrid(np.arange(1, 4), np.arange(64), indexing="ij")
    e = np.concatenate([(8 * r2 * m).ravel(), (2 * r3 * j).ravel(),
                        np.arange(N_BINS)])
    w = np.exp(-2j * np.pi * e / N_FFT)
    return np.stack([w.real, w.imag], axis=1)


def plain_log_mel_unfolded(audio: torch.Tensor, frame_lens: torch.Tensor,
                           params) -> torch.Tensor:
    """K1's algorithm as PyTorch ops, for the tests: DC removal,
    preemphasis and the window one at a time and ``torch.fft.rfft``, in
    float64 as the kernel computes them, the power in fp32, then the
    compacted mel weights (:func:`mel_ranges`) and the log."""
    bsz, s = audio.shape
    n_mel = params.num_mel_bins
    if s < FRAME_LEN:
        return audio.new_zeros((bsz, 0, n_mel))
    frames = audio.unfold(1, FRAME_LEN, FRAME_SHIFT).double()
    if params.remove_dc_offset:
        frames = frames - frames.mean(dim=2, keepdim=True)
    if params.preemphasis:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=2)
        frames = frames - params.preemphasis * prev
    frames = frames * torch.from_numpy(params.window).to(audio.device)
    spec = torch.fft.rfft(frames, n=N_FFT, dim=2)[..., :N_BINS]
    power = (spec.real * spec.real + spec.imag * spec.imag).float()
    bins, weights = mel_ranges(params.mel_t)
    # [width, M] bin indices, clipped inside the spectrum where the weight
    # is the 0 past a filter's end
    idx = np.minimum(bins[:, 0] + np.arange(weights.shape[0])[:, None],
                     N_BINS - 1)
    terms = power[..., torch.from_numpy(idx).to(audio.device)] \
        * torch.from_numpy(weights).to(audio.device)
    feats = torch.log(torch.clamp_min(terms.sum(dim=2), EPS))
    mask = make_non_pad_mask(frame_lens, feats.shape[1])[..., None]
    return torch.where(mask, feats, 0.0)


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def pack_tables(params) -> np.ndarray:
    """K1's read-only tables as one byte buffer, each part 16-byte aligned,
    as ``csrc/fbank.cu``'s ``Tables`` reads it: the float64 twiddles and
    window, then the mel bins (int32 [M, 2]) and weights (float32
    [width, M]) of :func:`mel_ranges`."""
    bins, weights = mel_ranges(params.mel_t)
    parts = [twiddles().tobytes(), params.window.astype(np.float64).tobytes(),
             bins.tobytes(), weights.tobytes()]
    return np.frombuffer(b"".join(
        p + bytes(_round16(len(p)) - len(p)) for p in parts), np.uint8).copy()


_matrices: dict = {}
_tables: dict = {}


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


def _kernel_tables(params, device: torch.device):
    """(:func:`pack_tables` on ``device``, the widest mel filter's bins),
    cached per (params, device) like :func:`_device_matrices`."""
    key = (id(params), device)
    hit = _tables.get(key)
    if hit is None:
        hit = (params, (torch.from_numpy(pack_tables(params)).to(device),
                        mel_ranges(params.mel_t)[1].shape[0]))
        _tables[key] = hit
    return hit[1]


@functools.cache
def _library():
    """(the loaded ``fbank`` library with its C signatures set, the largest
    mel dimension it takes)."""
    from metaasr_tpu_torch.ops import _build

    lib = _build.load("fbank")
    fn = lib.metaasr_fbank_log_mel
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
    lib.metaasr_fbank_max_mel.restype = ctypes.c_int
    return lib, lib.metaasr_fbank_max_mel()


def _launch(audio, frame_lens, params) -> torch.Tensor:
    lib, max_mel = _library()
    n_mel = params.num_mel_bins
    if n_mel > max_mel:
        raise ValueError(f"num_mel_bins {n_mel} exceeds the kernel's "
                         f"{max_mel}")
    bsz, s = audio.shape
    nf = max(0, 1 + (s - FRAME_LEN) // FRAME_SHIFT)
    out = torch.empty((bsz, nf, n_mel), dtype=torch.float32,
                      device=audio.device)
    if out.numel() == 0:
        return out
    tables, mel_width = _kernel_tables(params, audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    rc = lib.metaasr_fbank_log_mel(
        audio.data_ptr(), frame_lens.data_ptr(), tables.data_ptr(),
        out.data_ptr(), bsz, s, nf, n_mel, mel_width,
        params.preemphasis, int(params.remove_dc_offset), stream)
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
    if audio.device.type == "cpu":
        return plain_log_mel(audio, frame_lens,
                             *_device_matrices(params, audio.device))
    if audio.device.type != "cuda":
        raise ValueError(f"unsupported device {audio.device}")
    if frame_lens.dtype != torch.int32:
        raise ValueError(f"frame_lens must be int32, got {frame_lens.dtype}")
    if not (audio.is_contiguous() and frame_lens.is_contiguous()):
        raise ValueError("audio and frame_lens must be contiguous")
    return _launch(audio, frame_lens, params)


fused_log_mel.launches = 0
