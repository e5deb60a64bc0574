"""WAV decode/write — native C++ fast path with a numpy fallback
(counterpart of ``metaasr_tpu/data/audio_io.py``).

The reference crosses into sox/libsndfile here (SURVEY.md section 2.2 #N5);
the first-party equivalent is native/wavio.cpp (ctypes).
"""

from __future__ import annotations

import ctypes
import wave

import numpy as np

from metaasr_tpu_torch.utils.native import get_native_lib


def load_wav(path: str, target_rate: int = 16000) -> np.ndarray:
    """Decode a WAV file to float32 mono at ``target_rate``."""
    lib = get_native_lib()
    if lib is not None:
        n = lib.metaasr_load_wav(path.encode(), target_rate, None, 0)
        if n >= 0:
            buf = np.empty(n, dtype=np.float32)
            lib.metaasr_load_wav(
                path.encode(), target_rate,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            )
            return buf
    return _load_wav_py(path, target_rate)


def write_wav(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    """Write float32 samples as 16-bit PCM mono."""
    samples = np.asarray(samples, dtype=np.float32)
    lib = get_native_lib()
    if lib is not None:
        rc = lib.metaasr_write_wav(
            path.encode(),
            np.ascontiguousarray(samples).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            len(samples), rate)
        if rc == 0:
            return
    _write_wav_py(path, samples, rate)


def _write_wav_py(path: str, samples: np.ndarray, rate: int) -> None:
    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _load_wav_py(path: str, target_rate: int) -> np.ndarray:
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if rate != target_rate:
        out_n = int(len(x) * target_rate // rate)
        t = np.arange(out_n) * (rate / target_rate)
        j = np.minimum(t.astype(np.int64), len(x) - 1)
        j1 = np.minimum(j + 1, len(x) - 1)
        frac = (t - j).astype(np.float32)
        x = x[j] * (1 - frac) + x[j1] * frac
    return x.astype(np.float32)
