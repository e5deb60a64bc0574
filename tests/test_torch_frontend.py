"""Port vs reference: the fbank front-end (K1's plain version on the CPU),
CMVN, the task's feature modes, and the port's import boundary."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.frontend import fbank as ref_fbank
from metaasr_tpu.frontend.oracle import cmvn_oracle, fbank_oracle
from metaasr_tpu.frontend.pallas_fbank import pallas_log_mel_fbank
from metaasr_tpu_torch.frontend import fbank
from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = [16000, 401, 400, 7003, 399]   # 401 -> 1 frame; 399 -> 0 frames
CMVN_MODES = [("none", False), ("utterance", False), ("utterance", True)]


def _audio(seed=0, lens=LENS, s_max=16000):
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(lens), s_max), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000.0
        audio[i, :n] = (0.3 * np.sin(2 * np.pi * 440 * t)
                        + 0.1 * rng.standard_normal(n))
    return audio, np.asarray(lens, np.int32)


@pytest.mark.parametrize("kw", [{}, {"num_mel_bins": 40, "preemphasis": 0.0},
                                {"remove_dc_offset": False, "low_freq": 60.0,
                                 "high_freq": -400.0}])
def test_fbank_params_equal_reference(kw):
    got = fbank.FbankParams.create(**kw)
    ref = ref_fbank.FbankParams.create(**kw)
    # the reference embeds the 400 DFT rows in a 480-wide frame layout
    np.testing.assert_allclose(got.c_cos, ref.c_cos[:400], atol=1e-7, rtol=0)
    np.testing.assert_allclose(got.c_sin, ref.c_sin[:400], atol=1e-7, rtol=0)
    assert not ref.c_cos[400:].any() and not ref.c_sin[400:].any()
    np.testing.assert_allclose(got.mel_t, ref.mel_t, atol=1e-7, rtol=0)
    assert got.num_mel_bins == ref.num_mel_bins


@pytest.mark.parametrize("cmvn,norm_var", CMVN_MODES)
def test_fbank_matches_jax_and_pallas_interpret(cmvn, norm_var):
    audio, lens = _audio()
    feats, flens = fbank.log_mel_fbank(torch.from_numpy(audio),
                                       torch.from_numpy(lens), cmvn=cmvn,
                                       cmvn_norm_var=norm_var)
    ref, ref_lens = ref_fbank.log_mel_fbank(jnp.asarray(audio),
                                            jnp.asarray(lens), cmvn=cmvn,
                                            cmvn_norm_var=norm_var)
    pal, pal_lens = pallas_log_mel_fbank(jnp.asarray(audio), jnp.asarray(lens),
                                         cmvn=cmvn, cmvn_norm_var=norm_var,
                                         interpret=True)
    np.testing.assert_array_equal(flens.numpy(), np.asarray(ref_lens))
    np.testing.assert_array_equal(flens.numpy(), np.asarray(pal_lens))
    assert feats.shape == ref.shape
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(feats.numpy(), np.asarray(pal), rtol=1e-4,
                               atol=1e-4)


def test_fbank_matches_numpy_oracle():
    audio, lens = _audio(seed=1)
    feats, flens = fbank.log_mel_fbank(torch.from_numpy(audio),
                                       torch.from_numpy(lens), cmvn="none")
    for i, n in enumerate(lens):
        ref = fbank_oracle(audio[i, :n])
        assert int(flens[i]) == len(ref)
        np.testing.assert_allclose(feats[i, : len(ref)].numpy(), ref,
                                   rtol=2e-4, atol=2e-4)
        assert not feats[i, len(ref):].any()
        for norm_var in (False, True):
            if len(ref) < 2:
                continue
            got = fbank.apply_cmvn(feats[i: i + 1], flens[i: i + 1], norm_var)
            np.testing.assert_allclose(got[0, : len(ref)].numpy(),
                                       cmvn_oracle(ref, norm_var=norm_var),
                                       rtol=2e-4, atol=2e-4)


def test_fused_log_mel_checks_inputs():
    params = fbank.FbankParams.create()
    audio = torch.zeros((2, 800))
    with pytest.raises(ValueError):
        fused_log_mel(audio.double(), torch.zeros(2, dtype=torch.int32), params)
    with pytest.raises(ValueError):
        fused_log_mel(audio, torch.zeros(3, dtype=torch.int32), params)
    with pytest.raises(ValueError):
        fused_log_mel(audio.to("meta"), torch.zeros(2, dtype=torch.int32,
                                                    device="meta"), params)
    before = fused_log_mel.launches
    fused_log_mel(audio, torch.tensor([800, 0], dtype=torch.int32), params)
    assert fused_log_mel.launches == before  # the CPU path launches nothing


def _stats_file(tmp_path, dim=80):
    rng = np.random.default_rng(5)
    path = tmp_path / "stats.json"
    path.write_text(json.dumps({"mean": rng.standard_normal(dim).tolist(),
                                "var": (1 + rng.random(dim)).tolist()}))
    return str(path)


@pytest.mark.parametrize("cmvn", ["utterance", "none", "global", "speaker",
                                  "speaker_no_stats"])
def test_task_features_match_reference(cmvn, tmp_path):
    from metaasr_tpu.train.task import ASRTask as RefTask
    from metaasr_tpu_torch.config import Config
    from metaasr_tpu_torch.task import ASRTask
    from tests.test_m2_models import tiny_cfg

    ref_cfg = tiny_cfg("transformer")
    cfg = Config()
    mode = "speaker" if cmvn.startswith("speaker") else cmvn
    for c in (ref_cfg, cfg):
        c.frontend.cmvn = mode
        c.frontend.cmvn_norm_var = True
        if mode == "global":
            c.frontend.cmvn_stats_path = _stats_file(tmp_path)
    audio, lens = _audio(seed=2, lens=[16000, 9000, 401])
    rng = np.random.default_rng(3)
    mean = std = None
    if cmvn == "speaker":
        mean = rng.standard_normal((3, 80)).astype(np.float32)
        std = (1 + rng.random((3, 80))).astype(np.float32)
    ref, ref_lens = RefTask(ref_cfg).features(
        jnp.asarray(audio), jnp.asarray(lens),
        cmvn_mean=None if mean is None else jnp.asarray(mean),
        cmvn_std=None if std is None else jnp.asarray(std))
    got, got_lens = ASRTask(cfg, device="cpu").features(
        torch.from_numpy(audio), torch.from_numpy(lens),
        cmvn_mean=None if mean is None else torch.from_numpy(mean),
        cmvn_std=None if std is None else torch.from_numpy(std))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_config_copy_loads_like_reference():
    import dataclasses
    import glob

    from metaasr_tpu.config import load_config as ref_load
    from metaasr_tpu_torch.config import load_config

    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert paths
    for path in paths + [None]:
        ov = {"model.d_model": 64, "data.frame_buckets": "128,256"}
        assert (dataclasses.asdict(load_config(path, ov))
                == dataclasses.asdict(ref_load(path, ov))), path


def test_port_imports_neither_jax_nor_reference_package():
    """Every module of the port, imported in a fresh interpreter, pulls in
    neither ``jax`` nor ``metaasr_tpu`` (nor ``triton``: kernels are built
    where they launch), and no import builds or loads a kernel: ``nvcc``
    would run in a subprocess, and a loaded library sits in
    ``ops._build._libs``."""
    code = (
        "import importlib, pkgutil, subprocess, sys\n"
        "def no_build(*a, **k):\n"
        "    raise AssertionError(f'a subprocess at import: {a[:1]}')\n"
        "subprocess.Popen = subprocess.run = no_build\n"
        "import metaasr_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'metaasr_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'metaasr_tpu' or k.startswith('metaasr_tpu.')"
        " or k == 'triton' or k.startswith('triton.'))\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n"
        "for m in ('serve.batcher', 'ops.ctc_kernel', 'meta.maml',\n"
        "          'train.meta_train', 'data.sampler', 'ops.lstm_kernel',\n"
        "          'models.vgg_blstm', 'train.mono', 'train.metrics',\n"
        "          'scripts.prepare_data', 'scripts.acceptance', 'data.bpe',\n"
        "          'models.lm', 'scripts.train_lm', 'scripts.bench',\n"
        "          'scripts.bench_baseline_torch', 'scripts.bench_baseline_seq',\n"
        "          'scripts.sweep_throughput', 'serve', 'scripts.decode_bench',\n"
        "          'scripts.serve_bench', 'scripts.batcher_bench',\n"
        "          'scripts.flagship_results', 'scripts.demo_meta_adaptation',\n"
        "          'scripts.kshot_curve'):\n"
        "    assert 'metaasr_tpu_torch.' + m in mods, mods\n"
        "from metaasr_tpu_torch.ops import _build\n"
        "assert not _build._libs, sorted(_build._libs)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
