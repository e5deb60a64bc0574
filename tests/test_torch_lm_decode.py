"""LM shallow fusion behind the trainer and the CLI.

``MetaASRTrainer.decode(..., mode="beam")`` with ``train.lm_ckpt`` (an LM
npz the reference wrote) against the reference's trainer at the same
weights (the tiny transformer of ``tests/test_torch_eval.py``): texts exact,
WER/CER equal, scores 1e-4. Then the port alone: ``train.lm_weight``
without ``train.lm_ckpt`` decodes exactly as weight 0, as the reference's
does; ``--lm-ckpt``/``--lm-weight`` set the run's config; ``--mode test``
with them, ``--mode export`` of an LM bundle and ``--mode serve`` of it
with an adapted npz hot-swapped, on the CPU."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metaasr_tpu.cli import make_trainer as ref_make_trainer
from metaasr_tpu.data import synthetic as ref_synthetic
from metaasr_tpu.models.lm import LSTMLM as RefLM
from metaasr_tpu.train.checkpoint import save_params_npz as ref_save_npz
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.config import save_config
from metaasr_tpu_torch.data import synthetic
from metaasr_tpu_torch.serve.export import ServingDecoder, load_bundle_params
from metaasr_tpu_torch.train.checkpoint import (
    CheckpointManager,
    save_params_npz,
)
from metaasr_tpu_torch.weights import params_to_flax
from tests.test_torch_eval import _assert_same_dump, _records, eval_cfg
from tests.test_torch_meta import port_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ACCENTS = ("alpha", "bravo", "echo", "delta")
LM_WEIGHT = 0.5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(reference trainer, port trainer, reference params, port params,
    LM npz, port config) with train.lm_ckpt set in both."""
    ref_dir = str(tmp_path_factory.mktemp("ref_corpus"))
    dir_ = str(tmp_path_factory.mktemp("port_corpus"))
    kw = dict(accents=ACCENTS, utts_per_accent=10, words_per_utt=(1, 3),
              seed=5)
    ref_synthetic.generate_dataset(ref_dir, **kw)
    synthetic.generate_dataset(dir_, **kw)
    lm = RefLM(vocab_size=30, embed_dim=8, hidden=12, layers=1)
    lm_params = jax.tree.map(np.asarray, lm.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 2), jnp.int32))["params"])
    lm_params["out_proj"]["kernel"] = 8.0 * lm_params["out_proj"]["kernel"]
    npz = str(tmp_path_factory.mktemp("lm") / "lm.npz")
    ref_save_npz(npz, lm_params)

    def with_lm(cfg):
        cfg.train.lm_ckpt, cfg.train.lm_weight = npz, LM_WEIGHT
        return cfg

    ref, _ = ref_make_trainer(with_lm(eval_cfg(ref_dir)),
                              str(tmp_path_factory.mktemp("ref_wd")))
    cfg = port_cfg(with_lm(eval_cfg(dir_)))
    port, _ = cli.make_trainer(cfg, str(tmp_path_factory.mktemp("port_wd")),
                               device="cpu")
    params = port.init_state()["params"]
    return ref, port, params_to_flax(params, num_heads=2), params, npz, cfg


def test_trainer_beam_decode_with_fusion_lm(setup, tmp_path):
    ref, port, ref_params, params, _, _ = setup
    kw = dict(max_utts=7, mode="beam", dump_nbest=3)
    want = ref.decode(ref_params, ref.heldout_datasets["delta"],
                      dump_path=str(tmp_path / "want.jsonl"), **kw)
    got = port.decode(params, port.heldout_datasets["delta"],
                      dump_path=str(tmp_path / "got.jsonl"), **kw)
    _assert_same_dump(tmp_path / "got.jsonl", tmp_path / "want.jsonl")
    assert got == want and math.isfinite(got["wer"])
    assert port._fusion_lm() is port._fusion_lm()        # loaded once
    port.cfg.train.lm_weight = 0.0
    try:
        port.decode(params, port.heldout_datasets["delta"],
                    dump_path=str(tmp_path / "plain.jsonl"), **kw)
    finally:
        port.cfg.train.lm_weight = LM_WEIGHT
    assert [r["score"] for r in _records(tmp_path / "plain.jsonl")] != \
        [r["score"] for r in _records(tmp_path / "got.jsonl")]


def test_lm_weight_alone_decodes_as_weight_zero(setup, tmp_path):
    """train.lm_weight with no train.lm_ckpt fuses nothing and raises
    nothing (the reference's trainer gates fusion on both)."""
    _, port, _, params, _, _ = setup
    t = port.cfg.train
    dumps = []
    try:
        t.lm_ckpt = ""
        for i, weight in enumerate((LM_WEIGHT, 0.0)):
            t.lm_weight = weight
            dumps.append(str(tmp_path / f"{i}.jsonl"))
            port.decode(params, port.heldout_datasets["delta"], max_utts=4,
                        mode="beam", dump_path=dumps[-1], dump_nbest=2)
    finally:
        t.lm_ckpt, t.lm_weight = setup[4], LM_WEIGHT
    assert len(_records(dumps[0])) == 4
    assert _records(dumps[0]) == _records(dumps[1])


def test_cli_lm_flags_set_the_config(monkeypatch, tmp_path):
    seen = {}

    def record(args, cfg, group=None):
        seen[args.mode] = cfg
        return 0

    monkeypatch.setattr(cli, "_meta_test", record)
    monkeypatch.setattr(cli, "_train", record)
    for mode in ("test", "train"):
        cli.main(["--mode", mode, "--config", "configs/config3_fomaml.yaml",
                  "--workdir", str(tmp_path), "--lm-ckpt", "lm.npz",
                  "--lm-weight", "0.25"])
        assert (seen[mode].train.lm_ckpt, seen[mode].train.lm_weight) == \
            ("lm.npz", 0.25)


def test_cli_fused_test_export_and_serve(setup, tmp_path, capsys):
    """--mode test (beam) and --mode export with --lm-ckpt/--lm-weight, then
    --mode serve of the LM bundle with an adapted npz: the transcripts
    ServingDecoder gives for the same bundle and tree."""
    _, port, _, params, npz, cfg = setup
    wd = str(tmp_path / "wd")
    os.makedirs(wd)
    plain = port_cfg(cfg)
    plain.train.lm_ckpt, plain.train.lm_weight = "", 0.0
    save_config(plain, os.path.join(wd, "config.yaml"))
    CheckpointManager(os.path.join(wd, "ckpts")).save(
        1, dict(port.init_state(), params=params))
    flags = ["--workdir", wd, "--device", "cpu", "--lm-ckpt", npz,
             "--lm-weight", str(LM_WEIGHT)]
    assert cli.main(["--mode", "test", "--decode-mode", "beam", *flags]) == 0
    with open(os.path.join(wd, "test_results.json")) as f:
        assert math.isfinite(json.load(f)["delta"]["wer"])
    bundle = os.path.join(wd, "bundle")
    assert cli.main(["--mode", "export", "--export-dir", bundle,
                     "--export-buckets", "4x32000", *flags]) == 0
    with open(os.path.join(bundle, "meta.json")) as f:
        meta = json.load(f)
    assert meta["has_lm"] and meta["beam"]["lm_weight"] == LM_WEIGHT
    assert cli.main(["--mode", "export", "--export-dir", wd + "/off",
                     "--workdir", wd, "--device", "cpu"]) == 0
    with open(os.path.join(wd, "off", "meta.json")) as f:
        assert not json.load(f)["has_lm"]

    adapted = {k: v + 0.01 for k, v in params.items()}
    adapted_npz = str(tmp_path / "adapted.npz")
    save_params_npz(adapted_npz, adapted, num_heads=2)
    ds = port.heldout_datasets["delta"]
    wavs = [os.path.join(ds.manifest.root, u.wav)
            for u in ds.manifest.utts[:3]]
    capsys.readouterr()
    assert cli.main(["--mode", "serve", "--bundle", bundle, "--device",
                     "cpu", "--serve-params", adapted_npz,
                     "--wav", *wavs]) == 0
    served = [json.loads(line) for line in
              capsys.readouterr().out.splitlines()]
    want = ServingDecoder(bundle, device="cpu").transcribe_files(
        wavs, params=load_bundle_params(adapted_npz))
    assert len(served) == 3
    assert [{k: r[k] for k in ("text", "score")} for r in served] == want
