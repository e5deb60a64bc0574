"""Token-level LSTM language model for shallow fusion at decode time
(counterpart of ``metaasr_tpu/models/lm.py``).

The beam gains ``lm_weight * log p_LM(token | prefix)`` per emitted token
(``decode/beam_search.py``). The LM has two call surfaces over the same
parameters:

- ``forward(tokens [B, U]) -> logits [B, U, V]``, the sequence mode of
  training and scoring: per layer one input projection over the whole
  sequence, then the recurrence through ``ops/lstm_kernel.py::
  lstm_recurrence`` (K3 forward and K3b in the backward on CUDA tensors,
  their plain versions on CPU tensors). The cell is K3's: gates (i, f, g,
  o), +1 on the forget gate, zero initial state.
- ``step(tokens [N, 1], state) -> (logits [N, V], state)``, one token per
  beam step in plain PyTorch with the LM's own :meth:`LSTMLM._cell`: a
  launch of K3 at T = 1 would load U into a cluster's shared memory for
  one step.

Parameter names follow the Flax tree (``embed``, ``input_proj_{i}``,
``recurrent_{i}`` [H, 4H], ``out_proj``); ``weights.py`` maps the tree both
ways. K3's limits hold on the card: H a multiple of 4, at most 5,808. The
architecture is recovered from the parameter shapes
(:func:`lm_dims_from_params`), so a consumer needs only the npz and a
weight. The token inventory is the ASR tokenizer's (sos and eos share
``vocab_size - 1``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metaasr_tpu_torch.config import OptimizerConfig
from metaasr_tpu_torch.ops.lstm_kernel import lstm_recurrence
from metaasr_tpu_torch.train.optimizer import Optimizer, apply_updates
from metaasr_tpu_torch.weights import flax_to_lm_state_dict


class LSTMLM(nn.Module):
    """Embedding -> stacked unidirectional LSTM -> output projection.

    Weights are drawn from ``generator`` (default: a fresh one seeded 0) with
    the reference's initializers: embedding N(0, 1/E), Dense kernels
    truncated normal of variance 1/fan_in, zero biases, orthogonal
    recurrent matrices."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 hidden: int = 256, layers: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.hidden, self.layers = hidden, layers
        self.embed = nn.Embedding(vocab_size, embed_dim)
        for i in range(layers):
            self.add_module(f"input_proj_{i}",
                            nn.Linear(embed_dim if i == 0 else hidden,
                                      4 * hidden))
            self.register_parameter(f"recurrent_{i}", nn.Parameter(
                torch.empty(hidden, 4 * hidden)))
        self.out_proj = nn.Linear(hidden, vocab_size)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        g = generator or torch.Generator().manual_seed(0)
        nn.init.normal_(self.embed.weight, 0.0, self.embed_dim ** -0.5,
                        generator=g)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.startswith("recurrent_"):
                nn.init.orthogonal_(p, generator=g)
            elif p.dim() == 2 and name != "embed.weight":
                # flax lecun_normal: the std before truncation at 2 sigma
                std = p.shape[1] ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=g)

    def input_proj(self, i: int) -> nn.Linear:
        return getattr(self, f"input_proj_{i}")

    def recurrent(self, i: int) -> torch.Tensor:
        return getattr(self, f"recurrent_{i}")

    @staticmethod
    def _cell(g: torch.Tensor, c: torch.Tensor):
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c), c

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, U] -> logits [B, U, V], the recurrence through K3."""
        x = self.embed(tokens)                                # [B, U, E]
        for i in range(self.layers):
            gx = self.input_proj(i)(x).transpose(0, 1)        # [U, B, 4H]
            hs = lstm_recurrence(gx.contiguous(),
                                 self.recurrent(i).contiguous())
            x = hs.transpose(0, 1)                            # [B, U, H]
        return self.out_proj(x)

    def init_state(self, n: int) -> dict:
        """Carry for :meth:`step`: h/c [N, layers, H] fp32 zeros, the row
        axis first so the beam search gathers rows like the KV caches."""
        z = torch.zeros((n, self.layers, self.hidden),
                        device=self.embed.weight.device)
        return {"h": z, "c": z}

    def step(self, tokens: torch.Tensor, state: dict):
        """One LM step: tokens [N, 1] (the last emitted token, or sos) ->
        (logits [N, V], new state)."""
        x = self.embed(tokens[:, 0])                          # [N, E]
        hs, cs = [], []
        for i in range(self.layers):
            g = self.input_proj(i)(x) + state["h"][:, i] @ self.recurrent(i)
            x, c = self._cell(g, state["c"][:, i])
            hs.append(x)
            cs.append(c)
        return self.out_proj(x), {"h": torch.stack(hs, 1),
                                  "c": torch.stack(cs, 1)}


def lm_dims_from_params(params) -> dict:
    """Constructor kwargs from a Flax-layout LM tree (an npz carries no
    metadata)."""
    vocab, embed_dim = np.shape(params["embed"]["embedding"])
    return {"vocab_size": int(vocab), "embed_dim": int(embed_dim),
            "hidden": int(np.shape(params["recurrent_0"])[0]),
            "layers": sum(1 for k in params
                          if str(k).startswith("recurrent_"))}


def lm_from_flax(tree, device=None) -> LSTMLM:
    """An eval-mode :class:`LSTMLM` holding a Flax-layout tree's weights
    (fp32, contiguous) on ``device`` (default the CPU)."""
    model = LSTMLM(**lm_dims_from_params(tree))
    model.load_state_dict(flax_to_lm_state_dict(tree))
    return model.to(device or "cpu").eval()


def _apply(model: LSTMLM, params: dict | None, tokens: torch.Tensor):
    if params is None:
        return model(tokens)
    return torch.func.functional_call(model, params, (tokens,))


def lm_nll(model: LSTMLM, params: dict | None, tokens: torch.Tensor,
           lens: torch.Tensor, sos_eos: int) -> torch.Tensor:
    """Mean per-token negative log-likelihood of ``tokens`` (padded [B, U],
    true lengths ``lens``) with sos prepended and eos as the last target:
    what fusion adds along a finished hypothesis, up to the weight.
    ``params`` (a dict over the model's parameter names) replaces the
    module's own when given."""
    bsz, u_len = tokens.shape
    dev = tokens.device
    inputs = torch.cat([torch.full((bsz, 1), sos_eos, dtype=tokens.dtype,
                                   device=dev), tokens], 1)   # [B, U+1]
    pos = torch.arange(u_len + 1, device=dev)[None, :]
    lens = lens.to(dev)[:, None]
    targets = torch.where(
        pos < lens, torch.cat([tokens, torch.zeros_like(tokens[:, :1])], 1),
        sos_eos).long()                                       # eos at t=len
    valid = pos <= lens                                       # U tokens + eos
    logp = torch.log_softmax(_apply(model, params, inputs).float(), -1)
    tok_logp = logp.gather(2, targets[:, :, None])[..., 0]
    return -(torch.where(valid, tok_logp, 0.0).sum()
             / torch.clamp_min(valid.sum(), 1))


def lm_optimizer(lr: float) -> Optimizer:
    """``optax.adam(lr)`` at its defaults (b1 0.9, b2 0.999, eps 1e-8), a
    constant rate and no clipping."""
    return Optimizer(OptimizerConfig(
        name="adam", lr=lr, schedule="constant", grad_clip=math.inf,
        adam_b1=0.9, adam_b2=0.999, adam_eps=1e-8))


def lm_train_step(model: LSTMLM, opt: Optimizer, params: dict,
                  opt_state: dict, tokens: torch.Tensor, lens: torch.Tensor,
                  sos_eos: int):
    """One Adam step on :func:`lm_nll` -> (params, opt_state, loss,
    grads); ``params`` are leaf tensors that require grad."""
    loss = lm_nll(model, params, tokens, lens, sos_eos)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    updates, opt_state = opt.update(grads, opt_state, params)
    new = {k: v.detach().requires_grad_()
           for k, v in apply_updates(params, updates).items()}
    return new, opt_state, loss.detach(), grads


def train_char_lm(texts, tokenizer, embed_dim: int = 128, hidden: int = 256,
                  layers: int = 2, steps: int = 300, batch_size: int = 32,
                  lr: float = 1e-3, max_len: int = 64, seed: int = 0,
                  log_every: int = 0, device=None):
    """Train an :class:`LSTMLM` on transcript strings -> (model, params
    {name: tensor}, final mean NLL). The batches are the reference's:
    ``np.random.default_rng(seed).integers`` draws each step's rows of the
    encoded corpus (texts cut to ``max_len`` tokens). The weights start
    from a ``torch.Generator`` seeded with ``seed``. On CUDA every step
    launches K3 and K3b once per layer."""
    enc = [np.asarray(tokenizer.encode(t))[:max_len] for t in texts if t]
    if not enc:
        raise ValueError("empty LM corpus")
    u_max = max(len(e) for e in enc)
    toks = np.zeros((len(enc), u_max), np.int64)
    lens = np.zeros((len(enc),), np.int64)
    for i, e in enumerate(enc):
        toks[i, :len(e)] = e
        lens[i] = len(e)
    device = torch.device(device or "cpu")
    toks_d = torch.from_numpy(toks).to(device)
    lens_d = torch.from_numpy(lens).to(device)

    model = LSTMLM(tokenizer.vocab_size, embed_dim, hidden, layers,
                   generator=torch.Generator().manual_seed(seed)).to(device)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in model.named_parameters()}
    opt = lm_optimizer(lr)
    opt_state = opt.init(params)
    sos_eos = tokenizer.sos_eos_id
    rng = np.random.default_rng(seed)
    loss = torch.tensor(math.inf)
    for s in range(steps):
        idx = rng.integers(0, len(enc), size=min(batch_size, len(enc)))
        idx = torch.from_numpy(idx).to(device)
        params, opt_state, loss, _ = lm_train_step(
            model, opt, params, opt_state, toks_d[idx], lens_d[idx], sos_eos)
        if log_every and (s + 1) % log_every == 0:
            print(f"lm step {s + 1}/{steps} nll {float(loss):.4f}")
    params = {k: v.detach() for k, v in params.items()}
    model.load_state_dict(params)
    return model, params, float(loss)


def make_lm_step_fn(model: LSTMLM):
    """The beam search's ``lm_step_fn(tokens [N, 1], state) -> (logp
    [N, V] fp32, state)`` over ``model``."""

    def lm_step_fn(tokens, state):
        logits, state = model.step(tokens, state)
        return torch.log_softmax(logits.float(), -1), state

    return lm_step_fn
