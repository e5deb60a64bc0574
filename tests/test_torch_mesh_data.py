"""Port vs itself and vs the reference: the task mesh's data axis
(``parallel.make_mesh``, ``--mesh-tasks N`` below the world size).

2 gloo processes as one task group with a data axis of 2, and 4 processes
as 2 groups x 2 (``tests/torch_parallel_worker.py``, started once for the
module), against one process running every task's whole shots: FOMAML over
two Adam steps, Reptile, an inner-clipped FOMAML and a bf16 meta-step, at
dropout 0.1 with SpecAugment and dither on, so that every draw of a rank is
one process's at its rows; second-order MAML repeating each task on both
ranks; the CLI with ``--mesh-tasks 1`` on two ranks; the 2-process
gradient against the reference's ``maml_grads``. Then the pieces in
process: the draws at a rank's rows, the global denominators, the
sampler's ``shots=``, the mesh layout and the refusals; and the script
``scripts/multihost_smoke.py`` with the reference's constants under
torchrun's environment. d=32, 2 heads, 2+2 layers, on the CPU.
"""

import concurrent.futures
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.meta import maml as ref_maml
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.config import save_config
from metaasr_tpu_torch.data import synthetic
from metaasr_tpu_torch.frontend.specaug import spec_augment
from metaasr_tpu_torch.models.losses import (
    joint_ctc_attention_loss,
    label_smoothing_loss,
    prepare_decoder_targets,
)
from metaasr_tpu_torch.models.transformer import Dropout
from metaasr_tpu_torch.parallel import distributed
from metaasr_tpu_torch.scripts import multihost_smoke as mh
from metaasr_tpu_torch.scripts import multihost_trainer_smoke as smoke
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.utils.rows import Rows, make_generator
from metaasr_tpu_torch.weights import flatten_tree, params_to_flax
from tests import torch_parallel_worker as worker
from tests.test_m2_models import tiny_cfg
from tests.test_torch_meta import GRAD_L2REL, LOSS_RTOL, _l2rel
from tests.test_torch_mesh_tasks import (
    _assert_records_close,
    _records,
    _stub_group,
)
from tests.test_torch_parallel import (
    ACCENTS,
    RTOL,
    _assert_ranks_equal,
    _clear_env,
    _Group,
    _key_bias,
    _samplers,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# scenario -> the worlds it runs in, as (processes, task groups)
TWO, FOUR = (2, 1), (4, 2)
RUNS = {"fomaml": (TWO, FOUR), "reptile": (TWO, FOUR),
        "fomaml_bf16": (TWO, FOUR), "fomaml_clip": (TWO,), "maml": (TWO,),
        "fomaml_plain": (TWO,)}
U_BF16 = 2.0 ** -8     # bf16's unit roundoff


def _assert_tree_close(got: dict, want: dict, rtol: float = RTOL) -> None:
    """||got - want|| <= rtol ||want|| over the whole tree, off the key
    biases (``test_torch_parallel._key_bias``: both sides hold rounding
    noise there, which Adam turns into steps of up to lr). A rank's inner
    gradient is a sum of partials, so its adapted parameters part from one
    process's by fp32 rounding (~1e-6 of a leaf's scale), and what follows
    carries that at the scale of the whole: a few elements of a small
    leaf's gradient, or of a parameter whose gradient is near 0 before
    Adam's per-element scaling, sit further off than an element-wise 1e-5
    (the task axis alone leaves a task's arithmetic unchanged and is held
    element by element in ``test_torch_parallel.py``)."""
    assert got.keys() == want.keys()
    num = den = 0.0
    for k, w in want.items():
        off = ~_key_bias(k, w.shape)
        num += float(np.sum((got[k][off] - w[off]) ** 2, dtype=np.float64))
        den += float(np.sum(w[off] ** 2, dtype=np.float64))
    assert math.sqrt(num) <= rtol * math.sqrt(den), math.sqrt(num / den)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_data")
    data = str(root / "data")
    synthetic.generate_dataset(data, accents=ACCENTS, utts_per_accent=8,
                               words_per_utt=(1, 2), seed=3)
    config = str(root / "run.yaml")
    save_config(worker.trainer_cfg(data), config)
    return root, data, config


def _jobs(world: tuple) -> list:
    return [{"kind": "scenario", "name": n, "num_task": world[1]}
            for n, worlds in RUNS.items() if world in worlds]


@pytest.fixture(scope="module")
def runs(corpus):
    """Both worlds' ranks, the script's 2 ranks in a thread, and this
    process's one-process sides, all at once -> {world: rank results,
    "one": {scenario: one process's}, "cli_one": the one-process CLI run,
    "script": (one process's losses, the ranks')}."""
    root, _, config = corpus
    cli_argv = smoke.train_argv(config, str(root / "wd_mesh1"), 2, "cpu", 1)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    script = pool.submit(mh.launch, 2, 1, "cpu")
    two = worker.Ranks(2, str(root / "two"), _jobs(TWO) + [
        {"kind": "cli", "name": "cli", "argv": cli_argv, "audit_root": None}])
    four = worker.Ranks(4, str(root / "four"), _jobs(FOUR))
    try:
        one = {n: worker.run_scenario(n) for n in RUNS}
        cli_one = worker.cli_job(smoke.train_argv(
            config, str(root / "wd_one"), 2, "cpu"))
        script_one = mh.run("cpu")
        out = {TWO: two.results(), FOUR: four.results(), "one": one,
               "cli_one": cli_one, "script": (script_one, script.result())}
    finally:
        two.close()
        four.close()
        concurrent.futures.wait([script])
        pool.shutdown()
    return out


def _cases():
    return [(n, w) for n, worlds in RUNS.items() for w in worlds
            if n not in ("fomaml_bf16", "fomaml_plain")]


@pytest.mark.parametrize("name,world", _cases(),
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else x)
def test_data_axis_equals_one_process(runs, name, world):
    """W ranks in W / 2 task groups of 2 = one process over every task's
    whole shots, in fp32, at rtol 1e-5: every step's metrics and
    grad_norm, step 1's reduced gradient and the parameters after the
    steps (as trees, ``_assert_tree_close``); every rank ends with the same
    parameters. One outer all-reduce a step, and under first order one
    inner all-reduce per inner step of each of the group's tasks (none
    under second order, which repeats the task)."""
    want = runs["one"][name]
    algo, _, steps = worker.SCENARIOS[name]
    tasks = worker.M_TASKS // world[1]
    inner = 0 if name == "maml" else steps * tasks * algo["inner_steps"]
    for got in runs[world]:
        got = got[name]
        assert got["all_reduces"] == steps and got["inner_reduces"] == inner
        _assert_tree_close(got["grads"], want["grads"])
        for g, w in zip(got["metrics"], want["metrics"]):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=RTOL)
        _assert_tree_close(got["params"], want["params"])
    for got in runs[world][1:]:
        _assert_ranks_equal(runs[world][0][name]["params"],
                            got[name]["params"])
    assert want["inner_reduces"] == want["all_reduces"] == 0


@pytest.mark.parametrize("world", (TWO, FOUR), ids=("2x1", "4x2"))
def test_a_groups_ranks_hold_bit_equal_adapted_parameters(runs, world):
    """The D ranks of a task group hold the same adapted parameters bit for
    bit after each inner step (they take one reduced update), and task
    group 0's are one process's within rtol 1e-5; second-order MAML's
    replicas hold one process's exactly."""
    for name in (n for n, ws in RUNS.items() if world in ws):
        ranks = [r[name]["adapted"] for r in runs[world]]
        want = runs["one"][name]["adapted"]
        for g in range(world[1]):
            a, b = ranks[2 * g], ranks[2 * g + 1]
            assert len(a) == len(b) == len(want)
            for x, y in zip(a, b):
                _assert_ranks_equal(x, y)
        tol = RTOL if name != "fomaml_bf16" else None
        for got, w in zip(ranks[0], want):
            for k, v in w.items():
                if name == "maml":
                    assert np.array_equal(got[k], v), k
                elif tol is not None:
                    np.testing.assert_allclose(got[k], v, rtol=tol,
                                               atol=1e-7, err_msg=k)
                else:   # bf16: one ulp at the leaf's largest element
                    ulp = 2 * U_BF16 * np.abs(v).max(initial=0.0)
                    assert np.abs(got[k] - v).max(initial=0.0) <= ulp, k


@pytest.mark.parametrize("world", (TWO, FOUR), ids=("2x1", "4x2"))
def test_bf16_data_axis_within_its_rounding(runs, world):
    """grad_dtype bfloat16: each rank's partial inner gradient is rounded
    to bf16 before the fp32 sum, one process's whole gradient once, so the
    two part by bf16 rounding (U = 2^-8), not by fp32's: step 1's
    meta_loss within rtol U, grad_norm and the outer gradient (as a tree)
    within 2U (two roundings)."""
    want = runs["one"]["fomaml_bf16"]
    for got in (r["fomaml_bf16"] for r in runs[world]):
        np.testing.assert_allclose(got["metrics"][0]["meta_loss"],
                                   want["metrics"][0]["meta_loss"],
                                   rtol=U_BF16)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=2 * U_BF16)
        _assert_tree_close(got["grads"], want["grads"], 2 * U_BF16)


def test_inner_clip_takes_the_whole_tasks_norm(runs):
    """The clip scenario clips (its adapted parameters differ from the
    unclipped run's), and the data axis clips with the summed gradient's
    norm: its ranks' adapted parameters are one process's
    (``test_a_groups_ranks_hold...`` and ``test_data_axis_equals...``
    hold them)."""
    clipped = runs["one"]["fomaml_clip"]["adapted"][1]
    plain = runs["one"]["fomaml"]["adapted"][1]
    assert any(not np.allclose(clipped[k], plain[k]) for k in plain)


def test_data_axis_fomaml_matches_the_reference(runs):
    """The 2-process data-axis FOMAML gradient and metrics against the
    reference's single-process ``maml_grads`` on the same 4-task batch and
    weights (SpecAugment off, dropout 0, dither 0), at
    ``test_torch_meta.py``'s fp32 bars."""
    algo, _, _ = worker.SCENARIOS["fomaml_plain"]
    ref_task = RefTask(tiny_cfg("transformer", vocab=worker.VOCAB),
                       worker.VOCAB - 1)
    task = ASRTask(worker.small_cfg(False), worker.VOCAB - 1, device="cpu")
    params = params_to_flax(task.init_params(0), num_heads=2)
    ref_fn = jax.jit(ref_maml.maml_grads(
        ref_task.loss_fn, ref_maml.MetaAlgoConfig(first_order=True, **algo),
        ref_task.preprocess))
    want, want_m = ref_fn(params, jax.tree.map(jnp.asarray,
                                               worker.meta_batch(0)),
                          jax.random.PRNGKey(0))
    for got in (r["fomaml_plain"] for r in runs[TWO]):
        for key in ("meta_loss", "query_loss_max", "support_loss_mean"):
            np.testing.assert_allclose(got["metrics"][0][key],
                                       float(want_m[key]),
                                       rtol=LOSS_RTOL["float32"])
        want_flat = flatten_tree(jax.tree.map(np.asarray, want))
        got_flat = flatten_tree(params_to_flax(
            {k: torch.from_numpy(v) for k, v in got["grads"].items()},
            num_heads=2))
        assert got_flat.keys() == want_flat.keys()
        worst = max(_l2rel(got_flat[k], want_flat[k]) for k in want_flat)
        assert worst <= GRAD_L2REL["float32"], worst


def test_cli_mesh_tasks_1_on_two_ranks_equals_one_process(runs, corpus):
    """``cli.main --mesh-tasks 1`` on 2 ranks (one task group, a data axis
    of 2: 1 + 1 shots a rank, dropout, SpecAugment and dither on) trains
    2 steps as one process does: every logged record within rtol 1e-5,
    the parameters within rtol 1e-5 as a tree and equal across ranks; per
    rank 2 outer
    all-reduces and 4 tasks x 2 inner steps x 2 steps inner ones."""
    want = runs["cli_one"]["trainers"][0]
    r0, r1 = (r["cli"] for r in runs[TWO])
    for r in (r0, r1):
        assert r["rc"] == 0 and r["all_reduces"] == 2
        assert r["inner_reduces"] == 2 * worker.M_TASKS * 2
        end = r["trainers"][0]
        assert end["step"] == 2 and end["best_metric"] == want["best_metric"]
    _assert_records_close(_records(str(corpus[0] / "wd_mesh1")),
                          _records(str(corpus[0] / "wd_one")))
    _assert_tree_close(r0["trainers"][0]["params"], want["params"])
    _assert_ranks_equal(r0["trainers"][0]["params"],
                        r1["trainers"][0]["params"])


def test_script_under_torchrun_agrees_with_one_process(runs):
    """``scripts/multihost_smoke.py``'s 2 ranks (a data axis of 2, the
    reference's constants) against its one process: both steps' losses
    within the reference's 1e-5."""
    one, multi = runs["script"]
    worst, ok = mh.compare(one, multi)
    assert ok, (worst, one, multi)
    assert all(math.isfinite(x) for x in one)


# ---- the pieces, in process ----

def test_draws_at_a_ranks_rows_are_one_process_draws():
    """Dropout (0.1), SpecAugment (with time warp) and dither drawn through
    a generator carrying rank d's rows of 4 are the whole batch's draws at
    those rows, bit for bit; so is a draw over a rank's support rows then
    query rows concatenated (Reptile's layout)."""
    x = torch.randn(4, 5, 6)
    drop = Dropout(0.1)
    whole = drop(x, True, make_generator(5, "cpu"))
    feats = torch.randn(4, 40, 8)
    lens = torch.tensor([40, 31, 25, 40])
    kw = dict(num_freq_masks=2, freq_mask_width=3, num_time_masks=2,
              time_mask_width=6, time_warp=4)
    aug = spec_augment(make_generator(6, "cpu"), feats, lens, **kw)
    task = ASRTask(worker.small_cfg(True), worker.VOCAB - 1, device="cpu")
    audio = 0.1 * torch.randn(4, 4000)
    audio_lens = torch.tensor([4000, 3000, 3500, 4000], dtype=torch.int32)
    dith = task.features(audio, audio_lens, generator=make_generator(
        7, "cpu"), train=True)[0]
    for d in range(2):
        rows = Rows.part(d, 2, 4)
        sl = slice(2 * d, 2 * d + 2)
        assert torch.equal(drop(x[sl], True, make_generator(5, "cpu", rows)),
                           whole[sl])
        assert torch.equal(spec_augment(make_generator(6, "cpu", rows),
                                        feats[sl], lens[sl], **kw), aug[sl])
        got = task.features(audio[sl], audio_lens[sl],
                            generator=make_generator(7, "cpu", rows),
                            train=True)[0]
        assert torch.equal(got, dith[sl])
    sup, qry = torch.randn(4, 3, 2), torch.randn(6, 3, 2)
    whole = drop(torch.cat([sup, qry]), True, make_generator(9, "cpu"))
    rows = Rows.part(1, 2, 4) + Rows.part(1, 2, 6)
    got = drop(torch.cat([sup[2:], qry[3:]]), True,
               make_generator(9, "cpu", rows))
    assert torch.equal(got, torch.cat([whole[2:4], whole[7:]]))
    with pytest.raises(ValueError, match="a draw for 3 rows"):
        drop(x[:3], True, make_generator(5, "cpu", Rows.part(0, 2, 4)))


@pytest.mark.parametrize("arch,encoder", (("transformer", "transformer"),
                                          ("transformer", "conformer"),
                                          ("vgg_blstm", "transformer")))
def test_two_shares_losses_are_the_whole_batchs(arch, encoder):
    """``ASRTask.preprocess`` + ``loss_fn`` on each half of a 4-row batch
    (its generators carrying its rows, ``whole_token_lens`` beside it) at
    dropout 0.1 with SpecAugment and dither on: the halves' features are
    the whole batch's rows bit for bit, and their losses add up to the
    whole batch's, for the transformer, the conformer and the VGG-BLSTM."""
    cfg = worker.small_cfg(True)
    cfg.model.arch, cfg.model.encoder = arch, encoder
    if arch == "vgg_blstm":
        cfg.model.blstm_hidden, cfg.model.blstm_layers = 16, 1
        cfg.model.vgg_channels = (4, 8)
    task = ASRTask(cfg, worker.VOCAB - 1, device="cpu")
    params = task.init_params(0)
    batch = {k: torch.from_numpy(v[0]) for k, v in
             worker.meta_batch(3)["support"].items()}
    batch = {k: torch.cat([v, v.flip(0)]) for k, v in batch.items()}
    whole = task.preprocess(batch, make_generator(1, "cpu"), True)
    want = task.loss_fn(params, whole, make_generator(2, "cpu"), True)[0]
    got = 0.0
    for d in range(2):
        rows, sl = Rows.part(d, 2, 4), slice(2 * d, 2 * d + 2)
        share = {k: v[sl] for k, v in batch.items()}
        share["whole_token_lens"] = batch["token_lens"]
        share = task.preprocess(share, make_generator(1, "cpu", rows), True)
        assert torch.equal(share["feats"], whole["feats"][sl])
        got = got + task.loss_fn(params, share,
                                 make_generator(2, "cpu", rows), True)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("normalize", ("tokens", "batch"))
def test_shares_losses_add_up_to_the_whole_batchs(normalize):
    """Over the whole batch's counts (rows, valid decoder positions) the
    label-smoothed KL and the joint CTC/attention loss of two shares add
    up to the whole batch's, with ``normalize='batch'`` too."""
    rng = np.random.default_rng(0)
    b, u, v, t = 4, 6, 9, 20
    lens = torch.from_numpy(rng.integers(1, u + 1, b).astype(np.int32))
    tokens = torch.from_numpy(rng.integers(1, v - 1, (b, u)).astype(
        np.int32)) * (torch.arange(u)[None] < lens[:, None])
    _, tokens_out, mask = prepare_decoder_targets(tokens.long(), lens, v - 1)
    att = torch.randn(b, u + 1, v, dtype=torch.float64).float()
    ctc = torch.randn(b, t, v)
    enc_lens = torch.tensor([20, 18, 15, 20])
    whole_counts = (b, (lens.long() + 1).sum())
    want_ls = label_smoothing_loss(att, tokens_out, mask, 0.1, normalize)
    got_ls = sum(label_smoothing_loss(att[s], tokens_out[s], mask[s], 0.1,
                                      normalize, whole=whole_counts)
                 for s in (slice(0, 2), slice(2, 4)))
    torch.testing.assert_close(got_ls, want_ls, rtol=1e-6, atol=0)
    if normalize == "tokens":
        outs = {"ctc_logits": ctc, "enc_lens": enc_lens, "att_logits": att}
        want = joint_ctc_attention_loss(outs, tokens, lens, v - 1)[0]
        got = sum(joint_ctc_attention_loss(
            {k: o[s] for k, o in outs.items()}, tokens[s], lens[s], v - 1,
            whole=whole_counts)[0] for s in (slice(0, 1), slice(1, 4)))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_sample_shots_are_the_full_samples_columns(corpus):
    """``sample(step, rows=, shots=(d, 2))``: the task group's rows, the
    d-th half of each task's support and query shots, padded to the whole
    draw's bucket, with ``whole_token_lens`` the full sample's token
    lengths of those tasks."""
    port, _ = _samplers(corpus[1])
    for step in range(3):
        full = port.sample(step)
        for rows in (slice(0, 4), slice(2, 4)):
            for d in range(2):
                got = port.sample(step, rows=rows, shots=(d, 2))
                assert list(got["accents"]) == list(full["accents"][rows])
                cols = slice(d, d + 1)
                for part in ("support", "query"):
                    g, w = got[part], full[part]
                    assert g.keys() == w.keys() | {"whole_token_lens"}
                    for k, v in w.items():
                        if k == "texts":
                            assert g[k] == [t[cols] for t in v[rows]]
                        else:
                            np.testing.assert_array_equal(g[k],
                                                          v[rows][:, cols])
                    np.testing.assert_array_equal(g["whole_token_lens"],
                                                  w["token_lens"][rows])
    with pytest.raises(ValueError, match="2 rows do not split over 4"):
        port.sample(0, shots=(0, 4))


@pytest.mark.parametrize("world,num_task", ((8, 8), (8, 1), (8, 4), (8, 2),
                                            (2, 1), (4, 2)))
def test_mesh_lays_ranks_out_as_the_reference(monkeypatch, world, num_task):
    """Rank r's task group and data index are its row and column in the
    reference's ``np.array(devices).reshape(num_task, W // num_task)``
    (``tests/test_m7_scale.py`` builds (8, 1) and (2, 4) meshes; its ASR
    step runs on (4, 2)); every rank makes every data group, in order, and
    keeps its own; its task rows are its group's."""
    made = []
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda g: g.world)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda g: g.rank)
    monkeypatch.setattr(distributed.dist, "new_group",
                        lambda ranks: made.append(tuple(ranks)) or
                        tuple(ranks))
    layout = np.arange(world).reshape(num_task, world // num_task)
    for r in range(world):
        made.clear()
        mesh = distributed.make_mesh(_Group(world, r), num_task)
        (g,), (d,) = np.nonzero(layout == r)
        per = 8 // num_task
        assert mesh.task_rows(8) == slice(g * per, (g + 1) * per)
        if world == num_task:
            assert mesh.data is None and made == []
            continue
        assert made == [tuple(row) for row in layout]
        assert (mesh.data.group, mesh.data.size, mesh.data.index) == (
            tuple(layout[g]), world // num_task, d)
        assert mesh.data.rows(2) == Rows(((2 * d, 2 * d + 2),),
                                         2 * world // num_task)


def test_mesh_tasks_must_divide_the_world_size(corpus, monkeypatch):
    """``--mesh-tasks 3`` on 4 ranks is refused, naming N and W, and so is
    a mesh of 3 task groups over 4 ranks."""
    _clear_env(monkeypatch)
    _stub_group(monkeypatch, 4)
    argv = smoke.train_argv(corpus[2], str(corpus[0] / "w3"), 1, "cpu")
    with pytest.raises(SystemExit, match="--mesh-tasks 3 but the world "
                       "size is 4: N = 3 task groups must divide the W = 4"):
        cli.main(argv + ["--mesh-tasks", "3"])
    assert not (corpus[0] / "w3").exists()
    with pytest.raises(ValueError, match="does not divide the world size 4"):
        distributed.make_mesh(_Group(4, 0), 3)


def _trainer_with(monkeypatch, data, workdir, world, num_task, **meta):
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda g=None: g.world)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda g=None: g.rank)
    monkeypatch.setattr(distributed.dist, "new_group", tuple)
    cfg = worker.trainer_cfg(data)
    for k, v in meta.items():
        setattr(cfg.meta, k, v)
    return cli.make_trainer(cfg, str(workdir), "cpu", _Group(world, 0),
                            mesh_tasks=num_task)[0]


def test_the_knobs_that_do_not_split_are_refused(corpus, monkeypatch,
                                                 tmp_path):
    """N that does not divide meta.tasks_per_batch, and under first order a
    data axis that does not divide meta.k_support or meta.k_query, raise
    ``ValueError`` naming the knob; second order takes the whole shots and
    is not refused."""
    data = corpus[1]
    with pytest.raises(ValueError, match="meta.tasks_per_batch"):
        _trainer_with(monkeypatch, data, tmp_path, 6, 3)
    with pytest.raises(ValueError, match="meta.k_support = 2 does not split "
                       "over a data axis of 4"):
        _trainer_with(monkeypatch, data, tmp_path, 4, 1)
    with pytest.raises(ValueError, match="meta.k_query = 3 does not split"):
        _trainer_with(monkeypatch, data, tmp_path, 2, 1, k_query=3)
    tr = _trainer_with(monkeypatch, data, tmp_path, 4, 1, algo="maml")
    assert tr.shots is None and tr.mesh.data.size == 4
    tr = _trainer_with(monkeypatch, data, tmp_path, 4, 2)
    assert tr.shots == (0, 2) and tr.rows == slice(0, 2)


def test_script_imports_neither_jax_nor_the_reference():
    """The script and the data axis's modules run the port alone."""
    code = ("import sys, metaasr_tpu_torch.scripts.multihost_smoke, "
            "metaasr_tpu_torch.utils.rows, metaasr_tpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'metaasr_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=worker.REPO,
                          env=dict(os.environ, PYTHONPATH=worker.REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
