"""Port vs reference: the VGG-BLSTM CTC model.

``flip_padded``, the VGG extractor, the BLSTM stack and the whole model
against the Flax modules with the weights carried across by ``weights.py``
(logits to 1e-4, lengths exact, ragged batches), the parameter tree's round
trip, and ``ASRTask.loss_fn`` with its gradients against ``jax.grad`` of the
reference's. Small shapes: hidden 32, 2 layers, channels (8, 16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.config import Config as RefConfig
from metaasr_tpu.models import vgg_blstm as ref_vgg
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu.utils.padding import vgg_subsampled_lengths as ref_vgg_lens
from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.models import vgg_blstm
from metaasr_tpu_torch.task import ASRTask, build_model
from metaasr_tpu_torch.utils.padding import vgg_subsampled_lengths
from metaasr_tpu_torch.weights import (
    flatten_tree,
    flax_path,
    flax_to_state_dict,
    random_state_dict,
    state_dict_to_flax,
)

VOCAB, HIDDEN, LAYERS, CHANNELS = 12, 32, 2, (8, 16)


def _feats(seed=0, bsz=3, t_len=43, lens=(43, 30, 9)):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((bsz, t_len, 80)).astype(np.float32)
    return feats, np.asarray(lens, np.int32)


def _flax_model(lstm_impl="scan"):
    return ref_vgg.VGGBLSTMCTC(vocab_size=VOCAB, blstm_hidden=HIDDEN,
                               blstm_layers=LAYERS, vgg_channels=CHANNELS,
                               lstm_impl=lstm_impl)


def _port_model(lstm_impl="auto"):
    return vgg_blstm.VGGBLSTMCTC(VOCAB, HIDDEN, LAYERS, CHANNELS,
                                 lstm_impl=lstm_impl).eval()


@pytest.fixture(scope="module")
def flax_params():
    feats, lens = _feats()
    return _flax_model().init(jax.random.PRNGKey(0), jnp.asarray(feats),
                              jnp.asarray(lens))["params"]


def test_flip_padded_and_lengths_exact():
    rng = np.random.default_rng(1)
    lens = np.array([7, 4, 1, 0], np.int32)
    for shape in ((4, 7), (4, 7, 3), (4, 7, 2, 5)):
        x = rng.standard_normal(shape).astype(np.float32)
        want = ref_vgg.flip_padded(jnp.asarray(x), jnp.asarray(lens))
        got = vgg_blstm.flip_padded(torch.from_numpy(x),
                                    torch.from_numpy(lens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = vgg_blstm.flip_padded(got, torch.from_numpy(lens))
        np.testing.assert_array_equal(back.numpy(), x)
    raw = np.array([0, 1, 2, 3, 4, 7, 99, 398], np.int32)
    for blocks in (1, 2, 3):
        np.testing.assert_array_equal(
            vgg_subsampled_lengths(torch.from_numpy(raw), blocks).numpy(),
            np.asarray(ref_vgg_lens(jnp.asarray(raw), blocks)))


def test_vgg_extractor_matches_flax(flax_params):
    feats, _ = _feats(2)
    want = ref_vgg.VGGExtractor(CHANNELS).apply(
        {"params": flax_params["VGGExtractor_0"]}, jnp.asarray(feats))
    ext = vgg_blstm.VGGExtractor(CHANNELS)
    ext.load_state_dict(flax_to_state_dict(flax_params["VGGExtractor_0"]))
    with torch.no_grad():
        got = ext(torch.from_numpy(feats))
    assert got.shape == want.shape == (3, 10, 20 * 16)
    assert ext.out_features(80) == 20 * 16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("impl", ["auto", "scan"])
def test_blstm_matches_flax(flax_params, impl):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 10, 320)).astype(np.float32)
    lens = np.array([10, 6, 1], np.int32)
    want = ref_vgg.BLSTM(HIDDEN, LAYERS).apply(
        {"params": flax_params["BLSTM_0"]}, jnp.asarray(x), jnp.asarray(lens))
    net = vgg_blstm.BLSTM(320, HIDDEN, LAYERS, lstm_impl=impl)
    net.load_state_dict(flax_to_state_dict(flax_params["BLSTM_0"]))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert float(got[1, 6:].abs().max()) == 0.0   # padded outputs masked


@pytest.mark.parametrize("ref_impl", ["scan", "pallas"])
def test_model_matches_flax(flax_params, ref_impl):
    feats, lens = _feats(4)
    want, want_lens = _flax_model(ref_impl).apply(
        {"params": flax_params}, jnp.asarray(feats), jnp.asarray(lens))
    model = _port_model()
    model.load_state_dict(flax_to_state_dict(flax_params))
    with torch.no_grad():
        got, got_lens = model(torch.from_numpy(feats), torch.from_numpy(lens))
        # whatever sits in the padding frames never reaches a valid output
        noisy = feats.copy()
        noisy[1, 30:] = 7.0
        again, _ = model(torch.from_numpy(noisy), torch.from_numpy(lens))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(
        model.output_lengths(torch.from_numpy(lens)).numpy(),
        np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert torch.equal(again, got)


def test_tree_round_trips_exactly(flax_params):
    sd = flax_to_state_dict(flax_params)
    model = _port_model()
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    back = flatten_tree(state_dict_to_flax(sd, num_heads=1))
    want = flatten_tree(jax.tree.map(np.asarray, flax_params))
    assert set(back) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    assert flax_path("blstm.fwd_1.recurrent") == "BLSTM_0/fwd_1/recurrent"
    assert flax_path("blstm.bwd_0.input_proj.weight") == \
        "BLSTM_0/bwd_0/input_proj/kernel"
    assert flax_path("vgg.conv1_0.bias") == "VGGExtractor_0/conv1_0/bias"
    assert flax_path("ctc_head.weight") == "ctc_head/kernel"
    assert {flax_path(k) for k in sd} == set(want)


def test_random_state_dict_is_seeded_and_orthogonal():
    model = _port_model()
    a, b = random_state_dict(model, 3), random_state_dict(model, 3)
    c = random_state_dict(model, 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert all(v.is_contiguous() for v in a.values())   # the kernels need it
    u = a["blstm.fwd_0.recurrent"]
    assert u.shape == (HIDDEN, 4 * HIDDEN)
    torch.testing.assert_close(u @ u.T, torch.eye(HIDDEN), atol=1e-5, rtol=0)
    model.load_state_dict(a)


def _cfgs():
    cfgs = []
    for cls in (RefConfig, Config):
        cfg = cls()
        m = cfg.model
        m.arch, m.vocab_size, m.dtype = "vgg_blstm", VOCAB, "float32"
        m.blstm_hidden, m.blstm_layers = HIDDEN, LAYERS
        m.vgg_channels = CHANNELS
        cfg.specaug.enabled = False
        cfg.frontend.dither = 0.0
        cfg.frontend.use_pallas = False   # the reference's jnp front-end
        cfgs.append(cfg)
    return cfgs


def _audio_batch(seed=6):
    rng = np.random.default_rng(seed)
    lens = np.array([8000, 5600, 3000], np.int32)
    audio = np.zeros((3, 8000), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = 0.1 * rng.standard_normal(n)
    tok_lens = np.array([5, 3, 0], np.int32)
    tokens = rng.integers(1, VOCAB - 1, (3, 5)).astype(np.int32)
    tokens *= np.arange(5)[None, :] < tok_lens[:, None]
    return {"audio": audio, "audio_lens": lens, "tokens": tokens,
            "token_lens": tok_lens}


@pytest.mark.parametrize("train", [False, True])
def test_loss_and_gradients_match_reference(flax_params, train):
    ref_cfg, cfg = _cfgs()
    batch = _audio_batch()
    ref_task = RefTask(ref_cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, want_m), want_g = jax.value_and_grad(
        ref_task.loss_fn, has_aux=True)(flax_params, jb,
                                        jax.random.PRNGKey(0), train)
    task = ASRTask(cfg, device="cpu")
    params = {k: v.requires_grad_(True)
              for k, v in flax_to_state_dict(flax_params).items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = task.loss_fn(params, tb, train=train)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    loss = loss.detach()
    assert abs(float(loss) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    assert set(metrics) == set(want_m) == {"loss", "ctc_loss"}
    got_g = flatten_tree(state_dict_to_flax(grads, num_heads=1))
    for k, w in flatten_tree(jax.tree.map(np.asarray, want_g)).items():
        l2rel = np.linalg.norm(got_g[k] - w) / max(np.linalg.norm(w), 1e-12)
        assert l2rel <= 1e-3, (k, l2rel)
    # a feature batch from preprocess gives the same loss
    again, _ = task.loss_fn(params, task.preprocess(tb), train=train)
    assert abs(float(again.detach()) - float(loss)) <= 1e-6 * abs(float(loss))


def test_task_builds_and_switches_the_model():
    _, cfg = _cfgs()
    cfg.model.ctc_impl = "scan"   # K2's Function is first order only too
    task = ASRTask(cfg, device="cpu")
    assert isinstance(task.model, vgg_blstm.VGGBLSTMCTC)
    params = task.init_params(0)
    assert set(params) == set(task.model.state_dict())
    assert task.model.blstm.fwd_0.impl == "auto"
    # second-order MAML needs the twice-differentiable loop
    task.require_full_autodiff()
    assert cfg.model.lstm_impl == "scan"
    assert task.model.blstm.fwd_0.impl == "scan"
    feats, lens = _feats(7)
    batch = {"feats": torch.from_numpy(feats), "feat_lens":
             torch.from_numpy(lens), "tokens": torch.ones(3, 2, dtype=torch.int32),
             "token_lens": torch.tensor([2, 1, 2], dtype=torch.int32)}
    p = {k: v.requires_grad_(True) for k, v in params.items()}
    loss, _ = task.loss_fn(p, batch)
    (g,) = torch.autograd.grad(loss, p["blstm.fwd_0.recurrent"],
                               create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), p["ctc_head.weight"])
    assert torch.isfinite(gg).all()
    # the greedy decode of the task equals the module's
    packed, out_lens = task.greedy_batch(params, batch)
    model = build_model(cfg)
    model.load_state_dict(params)
    want = task._greedy_from_feats(model, batch["feats"], batch["feat_lens"])
    assert torch.equal(packed, want[0]) and torch.equal(out_lens, want[1])


def test_unported_archs_name_what_is_missing():
    """The conformer encoder builds (with its kernel width); an unknown
    encoder or arch raises, naming what is wrong."""
    from metaasr_tpu_torch.models.conformer import ConformerEncoder

    cfg = Config()
    cfg.model.encoder, cfg.model.conformer_kernel = "conformer", 7
    cfg.model.num_encoder_layers = cfg.model.num_decoder_layers = 1
    model = build_model(cfg)
    assert isinstance(model.encoder, ConformerEncoder)
    assert model.encoder.layers[0].conv.depthwise.weight.shape == (256, 1, 7)
    cfg.model.encoder = "lstm"
    with pytest.raises(ValueError, match="unknown encoder 'lstm'"):
        build_model(cfg)
    cfg.model.arch = "rnnt"
    with pytest.raises(ValueError, match="unknown arch rnnt"):
        build_model(cfg)
