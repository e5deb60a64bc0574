"""Port vs reference: decoding and serving a conformer-encoder model.

The reference's small conformer (d=32, 2 heads, 2+2 layers, depthwise
kernel 7) with one set of weights in both packages: the joint beam search
(texts exact, scores within 1e-5), a bundle the JAX package exported
(``export_bundle(..., platforms=("cpu",))``, one bucket) served by the
port's ``ServingDecoder`` with the reference's texts, and a bundle the port
wrote served through its CLI without ``--config`` as with it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.data.tokenizer import CharTokenizer
from metaasr_tpu.decode import beam_search as ref_bs
from metaasr_tpu.serve import ExportSpec, export_bundle
from metaasr_tpu.serve import ServingDecoder as RefDecoder
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.config import save_config
from metaasr_tpu_torch.decode import beam_search as bs
from metaasr_tpu_torch.serve.export import ServingDecoder, write_bundle
from metaasr_tpu_torch.task import ASRTask, build_model
from metaasr_tpu_torch.weights import params_to_flax
from tests.test_m2_models import tiny_cfg
from tests.test_torch_meta import port_cfg
from tests.test_torch_serve import _assert_same, _waves

BUCKETS = ((3, 8000),)


@pytest.fixture(scope="module")
def run():
    """(reference config, port config, Flax-layout weights, tokenizer): the
    port's seeded init of the small conformer, char vocabulary."""
    tok = CharTokenizer.ascii_default()
    cfg = tiny_cfg("transformer", vocab=tok.vocab_size)
    cfg.model.encoder, cfg.model.conformer_kernel = "conformer", 7
    cfg.data.max_tokens = 8
    cfg.train.beam_size = 3
    pcfg = port_cfg(cfg)
    params = params_to_flax(
        ASRTask(pcfg, tok.sos_eos_id, device="cpu").init_params(0),
        num_heads=2)
    return cfg, pcfg, params, tok


def test_beam_search_matches_reference(run):
    from metaasr_tpu.train.task import build_model as ref_build_model
    from metaasr_tpu_torch.weights import flax_to_state_dict

    cfg, pcfg, params, tok = run
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 35, 80)).astype(np.float32)
    lens = np.array([35, 23], np.int32)
    kw = dict(beam_size=3, max_len=6, ctc_weight=0.3)
    want = ref_bs.beam_search_transformer(
        ref_build_model(cfg), params, jnp.asarray(feats), jnp.asarray(lens),
        tok.sos_eos_id, ref_bs.BeamSearchConfig(**kw))
    pm = build_model(pcfg).eval()
    pm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = bs.beam_search_transformer(
            pm, torch.from_numpy(feats), torch.from_numpy(lens),
            tok.sos_eos_id, bs.BeamSearchConfig(**kw))
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    np.testing.assert_array_equal(got["finished"].numpy(), want["finished"])
    for b in range(2):
        for j in range(kw["beam_size"]):
            n = want["lengths"][b, j]
            np.testing.assert_array_equal(got["tokens"][b, j, :n].numpy(),
                                          want["tokens"][b, j, :n])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=1e-5, atol=1e-5)


def test_reference_bundle_served_by_port(run, tmp_path):
    cfg, pcfg, params, tok = run
    out = str(tmp_path / "jax_bundle")
    export_bundle(cfg, jax.tree.map(jnp.asarray, params), tok, out,
                  spec=ExportSpec(buckets=BUCKETS, platforms=("cpu",)))
    dec = ServingDecoder(out, pcfg, device="cpu")
    assert dec.model.encoder.layers[0].conv.depthwise.weight.shape[-1] == 7
    waves = _waves(1, (8000, 5000, 3000))
    _assert_same(dec.transcribe(waves, nbest=2),
                 RefDecoder(out).transcribe(waves, nbest=2))


def test_port_bundle_serves_through_cli_without_config(run, tmp_path,
                                                       capsys):
    """The bundle records ``encoder`` and ``conformer_kernel``: served
    with no config it rebuilds the conformer it was written from."""
    from metaasr_tpu.data.audio_io import write_wav
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer as PortChars

    _, pcfg, params, _ = run
    bundle = str(tmp_path / "bundle")
    write_bundle(bundle, pcfg, params, PortChars.ascii_default(), BUCKETS)
    with open(os.path.join(bundle, "meta.json")) as f:
        model = json.load(f)["model"]
    assert (model["encoder"], model["conformer_kernel"]) == ("conformer", 7)
    wavs = []
    for i, w in enumerate(_waves(2, (7000, 2500))):
        wavs.append(str(tmp_path / f"u{i}.wav"))
        write_wav(wavs[-1], w, rate=16000)
    cfg_path = str(tmp_path / "run.yaml")
    save_config(pcfg, cfg_path)
    served = []
    for extra in ([], ["--config", cfg_path]):
        assert cli.main(["--mode", "serve", "--bundle", bundle, "--wav",
                         *wavs, "--device", "cpu", "--dump-nbest", "2",
                         *extra]) == 0
        served.append([json.loads(line) for line in
                       capsys.readouterr().out.splitlines()])
    assert served[0] == served[1] and len(served[0]) == 2
    want = ServingDecoder(bundle, device="cpu").transcribe_files(wavs,
                                                                 nbest=2)
    assert [{k: v for k, v in r.items() if k != "file"}
            for r in served[0]] == want
