"""K1's redesign on the CPU: the tables the kernel reads (mel bin ranges
and weights, twiddles, the packed buffer) and its algorithm written in
PyTorch (``plain_log_mel_unfolded``) against the folded plain version, the
JAX reference paths and the float64 oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.frontend import fbank as ref_fbank
from metaasr_tpu.frontend.oracle import fbank_oracle
from metaasr_tpu.frontend.pallas_fbank import pallas_log_mel_fbank
from metaasr_tpu_torch.frontend import fbank, fbank_kernel, oracle
from tests.test_torch_frontend import _audio

# the parameter sets of test_fbank_params_equal_reference, at 40, 80 and
# 128 mel bins (128: the reference Pallas path's limit, pallas_fbank.py:45)
PARAM_SETS = [{}, {"preemphasis": 0.0},
              {"remove_dc_offset": False, "low_freq": 60.0,
               "high_freq": -400.0}]
CASES = [dict(kw, num_mel_bins=m) for kw in PARAM_SETS for m in (40, 80, 128)]
CASE_IDS = [f"set{i // 3}-mel{m}" for i, m in
            enumerate([40, 80, 128] * len(PARAM_SETS))]


@pytest.mark.parametrize("kw", CASES, ids=CASE_IDS)
def test_mel_ranges_rebuild_the_mel_banks_exactly(kw):
    mel_t = fbank.FbankParams.create(**kw).mel_t
    bins, weights = fbank_kernel.mel_ranges(mel_t)
    rebuilt = np.zeros_like(mel_t)
    for m, (lo, hi) in enumerate(bins):
        assert 0 <= lo <= hi <= fbank.N_BINS
        rebuilt[lo:hi, m] = weights[: hi - lo, m]
        assert not weights[hi - lo:, m].any()
    np.testing.assert_array_equal(rebuilt, mel_t)
    # each FFT bin feeds at most two filters: ~500 non-zeros
    assert (mel_t != 0).sum(axis=1).max() <= 2
    assert (bins[:, 1] - bins[:, 0]).sum() == (mel_t != 0).sum() <= 512


@pytest.mark.parametrize("kw", CASES, ids=CASE_IDS)
def test_unfolded_matches_plain_reference_and_oracle(kw):
    audio, lens = _audio(seed=4)
    params = fbank.FbankParams.create(**kw)
    flens = fbank.frame_lengths(torch.from_numpy(lens))
    got = fbank_kernel.plain_log_mel_unfolded(torch.from_numpy(audio), flens,
                                              params).numpy()
    plain = fbank_kernel.plain_log_mel(
        torch.from_numpy(audio), flens,
        *fbank_kernel._device_matrices(params, torch.device("cpu"))).numpy()
    ref_params = ref_fbank.FbankParams.create(**kw)
    ref, _ = ref_fbank.log_mel_fbank(jnp.asarray(audio), jnp.asarray(lens),
                                     ref_params, cmvn="none")
    pal, _ = pallas_log_mel_fbank(jnp.asarray(audio), jnp.asarray(lens),
                                  ref_params, cmvn="none", interpret=True)
    # the reference's own bar for K1 (tests/test_m3_pallas.py:21)
    for other in (plain, np.asarray(ref), np.asarray(pal)):
        assert got.shape == other.shape
        np.testing.assert_allclose(got, other, rtol=1e-4, atol=1e-4)
    for i, n in enumerate(lens):
        want = fbank_oracle(audio[i, :n], **kw)
        np.testing.assert_allclose(got[i, : len(want)], want, rtol=0,
                                   atol=2e-4)
        assert not got[i, len(want):].any()


def _stockham_fft256(z: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """The kernel's three passes (csrc/fbank.cu: radix 8, 8, 4) over lanes
    l = 0..31 in numpy, reading the twiddles at the kernel's offsets."""
    w = tw[:, 0] + 1j * tw[:, 1]
    lane = np.arange(32)
    out = np.empty(256, complex)
    v = np.fft.fft(np.stack([z[lane + 32 * r] for r in range(8)]), axis=0)
    for r in range(8):                           # 8-point DFTs per lane
        out[8 * lane + r] = v[r]
    v = [out[lane + 32 * r] * (w[8 * (r - 1) + (lane & 7)] if r else 1)
         for r in range(8)]
    v = np.fft.fft(np.stack(v), axis=0)
    nxt = np.empty(256, complex)
    for r in range(8):
        nxt[64 * (lane >> 3) + (lane & 7) + 8 * r] = v[r]
    res = np.empty(256, complex)
    for h in range(2):
        j = lane + 32 * h
        u = [nxt[j + 64 * r] * (w[56 + 64 * (r - 1) + j] if r else 1)
             for r in range(4)]
        u = np.fft.fft(np.stack(u), axis=0)
        for r in range(4):
            res[j + 64 * r] = u[r]
    return res


def test_twiddle_table_drives_the_kernels_fft():
    tw = fbank_kernel.twiddles()
    assert tw.shape == (504, 2) and tw.dtype == np.float64
    rng = np.random.default_rng(7)
    y = rng.standard_normal(400)
    z = np.zeros(256, complex)
    z[:200] = y[0::2] + 1j * y[1::2]
    zf = _stockham_fft256(z, tw)
    np.testing.assert_allclose(zf, np.fft.fft(z), rtol=0, atol=1e-11)
    # the real split with the table's last 256 entries: 2 X[k] = s - i W^k d
    k = np.arange(256)
    wk = tw[248:, 0] + 1j * tw[248:, 1]
    pc = np.conj(zf[(256 - k) % 256])
    x2 = (zf + pc) - 1j * wk * (zf - pc)
    np.testing.assert_allclose(x2 / 2, np.fft.rfft(y, n=512)[:256], rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("n_mel", [1, 40, 80, 128])
def test_packed_tables_follow_the_kernels_layout(n_mel):
    params = fbank.FbankParams.create(num_mel_bins=n_mel)
    buf = fbank_kernel.pack_tables(params)
    bins, weights = fbank_kernel.mel_ranges(params.mel_t)
    r16 = lambda n: (n + 15) // 16 * 16  # noqa: E731
    assert buf.dtype == np.uint8 and buf.size % 16 == 0
    assert buf.size == 16 * (504 + 200) + r16(8 * n_mel) + r16(weights.nbytes)
    np.testing.assert_array_equal(buf[:8064].view(np.float64).reshape(-1, 2),
                                  fbank_kernel.twiddles())
    np.testing.assert_array_equal(buf[8064:11264].view(np.float64),
                                  params.window)
    np.testing.assert_array_equal(
        buf[11264: 11264 + 8 * n_mel].view(np.int32).reshape(-1, 2), bins)
    off = 11264 + r16(8 * n_mel)
    np.testing.assert_array_equal(
        buf[off: off + weights.nbytes].view(np.float32).reshape(
            weights.shape), weights)


@pytest.mark.parametrize("width, lens", [(399, [399, 0]),
                                         (720, [720, 0, 400, 559, 401])],
                         ids=["shorter_than_a_frame", "three_frames_ragged"])
def test_unfolded_edges_match_plain(width, lens):
    """Rows shorter than a frame, empty rows and ragged ends: the same
    shape, the same zeros and the same features as the folded version."""
    rng = np.random.default_rng(11)
    audio = np.zeros((len(lens), width), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = 0.1 * rng.standard_normal(n)
    params = fbank.FbankParams.create()
    flens = fbank.frame_lengths(torch.tensor(lens, dtype=torch.int32))
    got = fbank_kernel.plain_log_mel_unfolded(torch.from_numpy(audio), flens,
                                              params).numpy()
    plain = fbank_kernel.plain_log_mel(
        torch.from_numpy(audio), flens,
        *fbank_kernel._device_matrices(params, torch.device("cpu"))).numpy()
    assert got.shape == plain.shape == (len(lens), fbank.num_frames(width),
                                        80)
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)
    for i, f in enumerate(flens.tolist()):
        assert not got[i, f:].any() and not plain[i, f:].any()


@pytest.mark.parametrize("kw", PARAM_SETS, ids=["set0", "set1", "set2"])
def test_params_keep_the_front_end_they_fold(kw):
    """The unfolded values (window, preemphasis, DC removal), applied one
    at a time in float64 before a DFT, give what the folded matrices give."""
    params = fbank.FbankParams.create(**kw)
    np.testing.assert_array_equal(params.window, oracle.povey_window())
    assert params.preemphasis == kw.get("preemphasis", 0.97)
    assert params.remove_dc_offset == kw.get("remove_dc_offset", True)
    x = np.random.default_rng(9).standard_normal((3, 400))
    y = x - x.mean(axis=1, keepdims=True) if params.remove_dc_offset else x
    y = y - params.preemphasis * np.concatenate([y[:, :1], y[:, :-1]], axis=1)
    spec = np.fft.rfft(y * params.window, n=512)[:, :256]
    np.testing.assert_allclose(x @ params.c_cos, spec.real, rtol=0, atol=1e-4)
    np.testing.assert_allclose(x @ params.c_sin, spec.imag, rtol=0, atol=1e-4)
