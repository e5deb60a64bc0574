"""Training steps of the reference: first-order MAML over accent tasks and
plain supervised CTC training, each with its outer optimizer.

FOMAML (Finn et al., 2017; first order as in Nichol et al., 2018) at step
``s`` with the run's seed ``r``: the step's seed is ``fold_in(r, s)``, task
m's ``fold_in(step seed, m)``. A task's support and query utterances each go
through the front-end once (features, CMVN, SpecAugment drawn from
``fold_in(task, 2)`` and ``fold_in(task, 3)``); ``inner`` SGD steps of rate
``inner_lr`` on the support loss, step i's dropout from ``fold_in(fold_in(
task, 0), i)``, each gradient taken at the current adapted weights with no
path back to the meta-weights; then the query loss (dropout from
``fold_in(task, 1)``) at the adapted weights, whose gradient, divided by the
number of tasks and summed in float32 over tasks, is the outer gradient.
The reported loss is the mean query loss.

Supervised step ``s``: SpecAugment from ``fold_in(fold_in(r, s), 0)``, the
loss and its gradient.

Outer optimizers: the gradient clipped to global norm 5 (scaled by
5 / norm when norm >= 5), then Adam (b1 0.9, b2 0.98, eps 1e-9, bias
corrected) at Noam's rate lr * d^-0.5 * min(n^-0.5, n * warmup^-1.5) for
the n-th update, or Adadelta (rho 0.9, eps 1e-6, rate 1).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import frontend
from benchmark.reference.seeds import fold_in, generator


def clip(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    if float(norm) < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


class Adam:
    def __init__(self, lr, d_model, warmup, b1=0.9, b2=0.98, eps=1e-9,
                 max_norm=5.0):
        self.lr, self.d, self.warmup = lr, d_model, warmup
        self.b1, self.b2, self.eps, self.max_norm = b1, b2, eps, max_norm
        self.mu = self.nu = None
        self.n = 0

    def rate(self, n: int) -> float:
        return self.lr * self.d ** -0.5 * min(n ** -0.5,
                                              n * self.warmup ** -1.5)

    def step(self, params: dict, grads: dict) -> tuple[dict, dict]:
        """-> (new parameters, the clipped gradient)."""
        g = clip(grads, self.max_norm)
        if self.mu is None:
            self.mu = {k: torch.zeros_like(v) for k, v in g.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in g.items()}
        self.n += 1
        lr = self.rate(self.n)
        c1, c2 = 1 - self.b1 ** self.n, 1 - self.b2 ** self.n
        out = {}
        for k, p in params.items():
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g[k]
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g[k] ** 2
            out[k] = p - lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu[k] / c2) + self.eps)
        return out, g


class Adadelta:
    def __init__(self, lr=1.0, rho=0.9, eps=1e-6, max_norm=5.0):
        self.lr, self.rho, self.eps, self.max_norm = lr, rho, eps, max_norm
        self.eg = self.ex = None

    def step(self, params: dict, grads: dict) -> tuple[dict, dict]:
        g = clip(grads, self.max_norm)
        if self.eg is None:
            self.eg = {k: torch.zeros_like(v) for k, v in g.items()}
            self.ex = {k: torch.zeros_like(v) for k, v in g.items()}
        out = {}
        for k, p in params.items():
            self.eg[k] = self.rho * self.eg[k] + (1 - self.rho) * g[k] ** 2
            dx = torch.sqrt(self.ex[k] + self.eps) / torch.sqrt(
                self.eg[k] + self.eps) * g[k]
            self.ex[k] = self.rho * self.ex[k] + (1 - self.rho) * dx ** 2
            out[k] = p - self.lr * dx
        return out, g


def augmented(batch: dict, gen, specaug: dict | None):
    """Features of a batch, SpecAugment'ed unless ``specaug`` is None."""
    feats, flen = frontend.features(batch["audio"], batch["audio_lens"])
    if specaug is None:
        return feats, flen
    return frontend.spec_augment(gen, feats, flen, **specaug), flen


def _grads(loss_fn, params: dict):
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_fn(live)
        grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), dict(zip(live, grads))


def fomaml_grads(model_fn, params: dict, meta_batch: dict, seed: int,
                 inner_steps: int, inner_lr: float, specaug: dict):
    """-> (outer gradient, mean query loss, mean support loss before the
    inner steps). ``model_fn(params)`` builds the reference model over a
    parameter dict; its ``loss(feats, flen, tokens, token_lens, gen)`` is
    the batch loss."""
    sup, qry = meta_batch["support"], meta_batch["query"]
    tasks = sup["audio"].shape[0]
    dev = sup["audio"].device
    acc = {k: torch.zeros_like(v, dtype=torch.float32)
           for k, v in params.items()}
    q_losses, s_losses = [], []
    for m in range(tasks):
        task = fold_in(seed, m)
        s = {k: v[m] for k, v in sup.items()}
        q = {k: v[m] for k, v in qry.items()}
        with torch.no_grad():
            s_feats, s_len = augmented(s, generator(fold_in(task, 2), dev),
                                       specaug)
            q_feats, q_len = augmented(q, generator(fold_in(task, 3), dev),
                                       specaug)
        base = fold_in(task, 0)
        adapted = {k: v.detach() for k, v in params.items()}
        for i in range(inner_steps):
            gen = generator(fold_in(base, i), dev)
            s_loss, g = _grads(lambda p: model_fn(p).loss(
                s_feats, s_len, s["tokens"], s["token_lens"], gen), adapted)
            if i == 0:
                s_losses.append(float(s_loss))
            adapted = {k: v - inner_lr * g[k] for k, v in adapted.items()}
        gen = generator(fold_in(task, 1), dev)
        q_loss, g = _grads(lambda p: model_fn(p).loss(
            q_feats, q_len, q["tokens"], q["token_lens"], gen) / tasks,
            adapted)
        for k in acc:
            acc[k] += g[k].float()
        q_losses.append(float(q_loss) * tasks)
    return acc, sum(q_losses) / tasks, sum(s_losses) / tasks


def supervised_grads(model_fn, params: dict, batch: dict, seed: int,
                     specaug: dict):
    dev = batch["audio"].device
    with torch.no_grad():
        feats, flen = augmented(batch, generator(fold_in(seed, 0), dev),
                                specaug)
    loss, g = _grads(lambda p: model_fn(p).loss(
        feats, flen, batch["tokens"], batch["token_lens"], None), params)
    return g, float(loss)


def run_steps(kind: str, model_fn, params: dict, batches: list, run_seed: int,
              optimizer, **kw) -> dict:
    """The first ``len(batches)`` training steps from ``params`` ->
    {"losses": per step, "grad_norms": {leaf: norm of step 1's clipped
    gradient}, "signs": {leaf: the signs of step 1's update of its
    elements}, "change_norms": {leaf: norm of the parameters' change over
    every step}}; FOMAML adds "support_losses", each step's mean support
    loss before the inner steps."""
    start = {k: v.detach().clone() for k, v in params.items()}
    losses, first, support = [], None, []
    for s, batch in enumerate(batches):
        seed = fold_in(run_seed, s)
        if kind == "fomaml":
            grads, loss, s_loss = fomaml_grads(model_fn, params, batch, seed,
                                               **kw)
            support.append(s_loss)
        else:
            grads, loss = supervised_grads(model_fn, params, batch, seed,
                                           **kw)
        with torch.no_grad():
            before = params
            params, clipped = optimizer.step(params, grads)
        if first is None:
            first = {k: float(torch.linalg.vector_norm(v.double()))
                     for k, v in clipped.items()}
            signs = {k: (params[k] - before[k]).sign().to(torch.int8)
                     for k in params}
        if not math.isfinite(loss):
            raise FloatingPointError(f"reference loss {loss} at step {s}")
        losses.append(loss)
    change = {k: float(torch.linalg.vector_norm((params[k] - start[k])
                                                .double()))
              for k in params}
    out = {"losses": losses, "grad_norms": first, "change_norms": change,
           "signs": signs}
    if support:
        out["support_losses"] = support
    return out
