"""Port vs reference: meta-gradients through the conformer encoder.

``metaasr_tpu_torch.meta.maml.maml_grads`` against
``metaasr_tpu.meta.maml.maml_grads`` on the reference's small conformer
(d=32, 2 heads, 2+2 layers, depthwise kernel 7) over the ASR task, with
``tests/test_torch_meta.py``'s meta-batch (2 tasks x (2 support + 2 query)
utterances of <= 8,000 samples), dropout 0, SpecAugment off: FOMAML with
the whole body adapted and with the reference's conformer recipe
(``adapt_filter: decoder``, decoder-only inner steps), and one
second-order MAML meta-gradient (1 inner step), whose outer backward runs
through the conformer's inner gradient. The same Flax weights go into both
packages through ``weights.py``; the bars are ``tests/test_torch_meta.py``'s
(meta-loss within ``LOSS_RTOL``, worst leaf l2rel <= 1e-3 in fp32).
Measured on the CPU, worst leaf: 2.6e-5 (full body), 2.1e-5 (decoder
only), 1.2e-4 (second order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metaasr_tpu.meta import maml as ref_maml
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch.meta import maml
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.weights import flatten_tree, flax_to_params, params_to_flax
from tests.test_m2_models import tiny_cfg
from tests.test_torch_meta import (
    GRAD_L2REL,
    LOSS_RTOL,
    VOCAB,
    _l2rel,
    _meta_batch,
    _to_torch,
    port_cfg,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg("transformer", vocab=VOCAB)
    cfg.model.encoder, cfg.model.conformer_kernel = "conformer", 7
    task = ASRTask(port_cfg(cfg), VOCAB - 1, device="cpu")
    # the port's seeded init in the Flax layout (the reference's own init
    # would cost a compile of the whole model): u_bias/v_bias at the
    # reference's N(0, 0.02^2), the rest as weights.random_state_dict draws
    params = params_to_flax(task.init_params(0), num_heads=2)
    return RefTask(cfg, VOCAB - 1), task, params, _meta_batch()


CASES = {
    "fomaml_full_body": dict(first_order=True, inner_steps=2),
    "fomaml_adapt_decoder": dict(first_order=True, inner_steps=2,
                                 adapt_filter=("decoder",)),
    "maml_second_order": dict(first_order=False, inner_steps=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_conformer_meta_grads_match_reference(setup, case):
    ref_task, task, params, mb = setup
    common = dict(inner_lr=0.05, **CASES[case])
    want, want_m = jax.jit(ref_maml.maml_grads(
        ref_task.loss_fn, ref_maml.MetaAlgoConfig(**common),
        ref_task.preprocess))(params, jax.tree.map(jnp.asarray, mb),
                              jax.random.PRNGKey(0))
    got, got_m = maml.maml_grads(
        task.loss_fn, maml.MetaAlgoConfig(**common), task.preprocess)(
        flax_to_params(params), _to_torch(mb), 0)
    for key in ("meta_loss", "query_loss_max", "support_loss_mean"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=LOSS_RTOL["float32"])
    want_flat = flatten_tree(jax.tree.map(np.asarray, want))
    got_flat = flatten_tree(params_to_flax(got, num_heads=2))
    assert got_flat.keys() == want_flat.keys()
    worst = max(_l2rel(got_flat[k], want_flat[k]) for k in want_flat)
    assert worst <= GRAD_L2REL["float32"], (case, worst)
    # the conformer's own leaves carry gradient
    layer = "encoder/layer_0"
    for leaf in ("self_attn/u_bias", "conv/depthwise/kernel"):
        assert np.abs(got_flat[f"{layer}/{leaf}"]).max() > 0, leaf
