"""Batched joint CTC/attention beam search (counterpart of
``metaasr_tpu/decode/beam_search.py``).

Same fixed-shape hypothesis state [B, K, ...] and the same scoring:
(1-w)*att_cumlogp + w*ctc_prefix_logp (+ lm_weight * lm_cumlogp, shallow
fusion) (+ length_penalty * length), with Graves CTC prefix scores for
every (hypothesis x candidate) pair and an eos candidate scoring the
hypothesis as a complete CTC sequence. The fused LM (``models/lm.py``)
steps on the same token stream as the decoder, one plain PyTorch step per
beam step; its state rows are gathered like the KV caches. The decode
loop is a host loop that stops once every hypothesis has finished (the
reference's early-exit while loop); the CTC prefix recursion is a host loop
over the encoder frames that are valid in at least one row.

Ties: dead beams carry the sentinel ``NEG`` (not -inf; ``_lae`` depends on
it), and every top-k and final ranking breaks ties by the lower index
first, as ``jax.lax.top_k`` and the stable ``jnp.argsort`` do
(``torch.topk`` on CUDA promises no order among ties).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from metaasr_tpu_torch.constants import BLANK_ID
from metaasr_tpu_torch.models.lm import make_lm_step_fn
from metaasr_tpu_torch.utils.padding import make_non_pad_mask

NEG = -1.0e9


def _lae(a, b):
    """logaddexp that tolerates NEG sentinels."""
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(torch.minimum(a, b)
                                     - torch.clamp_min(m, NEG)))


def _topk(x: torch.Tensor, k: int):
    """Top-k over the last axis, best first, lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclass(frozen=True)
class BeamSearchConfig:
    beam_size: int = 10
    max_len: int = 64
    ctc_weight: float = 0.3
    length_penalty: float = 0.0
    blank_id: int = BLANK_ID
    # 0 = auto (full vocabulary up to FULL_SCORING_MAX_VOCAB, else prune to
    # AUTO_CTC_CANDIDATES), -1 = always full, N > 0 = top-N by attention
    # score (+ eos)
    ctc_candidates: int = 0
    normalize_final: bool = False
    coverage_weight: float = 0.0
    coverage_tau: float = 0.5
    min_len: int = 0
    lm_weight: float = 0.0


FULL_SCORING_MAX_VOCAB = 128
AUTO_CTC_CANDIDATES = 64


def effective_ctc_candidates(vocab: int, requested: int) -> int:
    """Resolve ``ctc_candidates``: >0 explicit (capped at vocab), -1 forced
    full-vocab (0), 0 auto."""
    if requested > 0:
        return min(requested, vocab)
    if requested < 0 or vocab <= FULL_SCORING_MAX_VOCAB:
        return 0
    logging.getLogger(__name__).warning(
        "ctc_candidates=0 (full-vocab prefix scoring) with vocab=%d: "
        "auto-pruning to top-%d candidates to bound the [B,K,V,T] prefix "
        "arrays; set train.ctc_candidates explicitly (or -1 to force "
        "full-vocab scoring) to silence this", vocab, AUTO_CTC_CANDIDATES)
    return AUTO_CTC_CANDIDATES


def ctc_prefix_step(ctc_logp, enc_lens, r_nb, r_b, last, empty,
                    blank_id: int, cand=None):
    """Extend every hypothesis with candidate tokens.

    ctc_logp [B, T, V]; r_nb/r_b [B, K, T] prefix log-probs of the current
    hypotheses; last [B, K] last token; empty [B, K] bool; cand optional
    [B, K, C] candidate ids (None = all V).

    Returns (new_r_nb [B,K,C,T], new_r_b [B,K,C,T], psi [B,K,C],
    complete [B,K]).
    """
    bsz, t_len, vocab = ctc_logp.shape
    k = r_nb.shape[1]
    dev = ctc_logp.device
    r_b_m1 = torch.where(empty, 0.0, NEG).to(torch.float32)
    r_nb_m1 = torch.full((bsz, k), NEG, device=dev)
    r_b_prev = torch.cat([r_b_m1[:, :, None], r_b[:, :, :-1]], 2)
    r_nb_prev = torch.cat([r_nb_m1[:, :, None], r_nb[:, :, :-1]], 2)

    if cand is None:
        cand_ids = torch.arange(vocab, device=dev)[None, None, :]
    else:
        cand_ids = cand
    not_repeat = cand_ids != last[:, :, None]                 # [B, K, C]

    lp_rows = ctc_logp.permute(1, 0, 2)                       # [T, B, V]
    lp_blank = ctc_logp[:, :, blank_id].T[:, :, None, None]   # [T, B, 1, 1]
    rb_p = r_b_prev.permute(2, 0, 1)[..., None]               # [T, B, K, 1]
    rnb_p = r_nb_prev.permute(2, 0, 1)[..., None]
    if cand is None:
        lp_cand = lp_rows[:, :, None, :]                      # [T, B, 1, V]
    else:
        n_c = cand_ids.shape[2]
        lp_cand = torch.gather(
            lp_rows[:, :, None, :].expand(t_len, bsz, k, vocab), 3,
            cand_ids[None].expand(t_len, bsz, k, n_c))        # [T, B, K, C]
    # phi(t-1) does not depend on the recursion's carry: all frames at once
    phi = _lae(rb_p, torch.where(not_repeat, rnb_p, NEG))     # [T, B, K, C]
    phi_lp = phi + lp_cand

    n_cand = phi.shape[3]
    c_nb = torch.full((bsz, k, n_cand), NEG, device=dev)
    c_b = c_nb.clone()
    c_psi = c_nb.clone()
    seq_nb = torch.empty((t_len, bsz, k, n_cand), device=dev)
    seq_b = torch.empty_like(seq_nb)
    t_active = (torch.arange(t_len, device=dev)[:, None, None, None]
                < enc_lens[None, :, None, None])              # [T, B, 1, 1]
    t_stop = min(t_len, int(enc_lens.max()))  # later frames: all inactive
    for t in range(t_stop):
        act = t_active[t]
        n_nb = _lae(c_nb, phi[t]) + lp_cand[t]
        n_b = _lae(c_b, c_nb) + lp_blank[t]
        n_psi = _lae(c_psi, phi_lp[t])
        c_nb = torch.where(act, n_nb, c_nb)
        c_b = torch.where(act, n_b, c_b)
        c_psi = torch.where(act, n_psi, c_psi)
        seq_nb[t] = c_nb
        seq_b[t] = c_b
    seq_nb[t_stop:] = c_nb
    seq_b[t_stop:] = c_b

    new_r_nb = seq_nb.permute(1, 2, 3, 0)                     # [B, K, C, T]
    new_r_b = seq_b.permute(1, 2, 3, 0)
    t_idx = torch.clamp_min(enc_lens.to(torch.int64) - 1, 0)[:, None, None]
    t_idx = t_idx.expand(bsz, k, 1)
    complete = _lae(r_b.gather(2, t_idx)[..., 0], r_nb.gather(2, t_idx)[..., 0])
    return new_r_nb, new_r_b, c_psi, complete


def ctc_prefix_init(ctc_logp, enc_lens, k: int, blank_id: int):
    """Prefix arrays of the empty hypothesis: r_b = cumulative blank
    log-prob (held at its last valid value), r_nb = NEG."""
    bsz, t_len, _ = ctc_logp.shape
    mask = make_non_pad_mask(enc_lens, t_len)
    r_b = torch.cumsum(torch.where(mask, ctc_logp[:, :, blank_id], 0.0), 1)
    last = r_b.gather(1, torch.clamp_min(enc_lens.to(torch.int64) - 1, 0)[:, None])
    r_b = torch.where(mask, r_b, last)
    r_b = r_b[:, None, :].expand(bsz, k, t_len).contiguous()
    r_nb = torch.full((bsz, k, t_len), NEG, device=ctc_logp.device)
    return r_nb, r_b


def batched_beam_search(decoder_step_fn, init_caches, enc_lens, ctc_logits,
                        eos_id: int, cfg: BeamSearchConfig,
                        lm_step_fn=None, init_lm_state=None):
    """Run the search.

    decoder_step_fn(tokens [N, 1], step, caches) -> (log_probs [N, V],
    caches) — or (log_probs, caches, cross_attn [N, T]) when
    cfg.coverage_weight != 0 — with N = B*K; caches are lists of
    {'k','v': [N, L, H, Dh]} (L >= max_len).
    lm_step_fn(tokens [N, 1], lm_state) -> (log_probs [N, V], lm_state):
    the shallow-fusion LM, used when cfg.lm_weight != 0; its state is a
    dict of [N, ...] tensors (``init_lm_state``).

    Returns dict: tokens [B, K, L], lengths [B, K], scores [B, K],
    finished [B, K], sorted best-first; tokens exclude sos and eos.
    """
    bsz, t_len, vocab = ctc_logits.shape
    k = cfg.beam_size
    l_max = cfg.max_len
    dev = ctc_logits.device
    ctc_logp = torch.log_softmax(ctc_logits.float(), dim=-1)

    r_nb, r_b = ctc_prefix_init(ctc_logp, enc_lens, k, cfg.blank_id)
    beam_iota = torch.arange(k, device=dev)[None, :].expand(bsz, k)
    state = {
        "tokens": torch.zeros((bsz, k, l_max), dtype=torch.int64, device=dev),
        "length": torch.zeros((bsz, k), dtype=torch.int64, device=dev),
        "att_cum": torch.zeros((bsz, k), device=dev),
        "score": torch.where(beam_iota == 0, 0.0, NEG).to(torch.float32),
        "finished": torch.zeros((bsz, k), dtype=torch.bool, device=dev),
        "last": torch.full((bsz, k), eos_id, dtype=torch.int64, device=dev),
        "empty": torch.ones((bsz, k), dtype=torch.bool, device=dev),
        "r_nb": r_nb,
        "r_b": r_b,
    }
    caches = init_caches
    use_cov = cfg.coverage_weight != 0.0
    if use_cov:
        state["coverage"] = torch.zeros((bsz, k, t_len), device=dev)
    use_lm = cfg.lm_weight != 0.0 and lm_step_fn is not None
    if use_lm:
        if init_lm_state is None:
            raise ValueError("lm_weight set but no init_lm_state given")
        lm_state = init_lm_state
        # the cumulative LM log-prob of each hypothesis, like att_cum: the
        # score is rebuilt from cumulative trackers every step
        state["lm_cum"] = torch.zeros((bsz, k), device=dev)

    req = effective_ctc_candidates(vocab, cfg.ctc_candidates)
    n_cand = vocab if req <= 0 else min(req + 1, vocab)  # +1: eos on top
    vocab_ids = torch.arange(vocab, device=dev)
    pos_ids = torch.arange(l_max, device=dev)
    row_base = (torch.arange(bsz, device=dev) * k)[:, None]

    for step_idx in range(l_max):
        if bool(state["finished"].all()):
            break
        # 1) one batched decoder step on all hypotheses
        out = decoder_step_fn(state["last"].reshape(bsz * k, 1), step_idx,
                              caches)
        if use_cov:
            att_logp, new_caches, cross_attn = out
            cross_attn = cross_attn.reshape(bsz, k, -1)
        else:
            att_logp, new_caches = out
        att_logp = att_logp.reshape(bsz, k, vocab)
        if use_lm:
            lm_logp, lm_new = lm_step_fn(state["last"].reshape(bsz * k, 1),
                                         lm_state)
            lm_logp = lm_logp.reshape(bsz, k, vocab)

        # 2) candidates: the whole vocabulary, or the top-N by attention
        #    score plus eos, all CTC prefix-scored
        if n_cand == vocab:
            cand = None
            cand_att_logp = att_logp
        else:
            masked = att_logp.clone()
            masked[:, :, cfg.blank_id] = NEG
            masked[:, :, eos_id] = NEG
            top_ids = _topk(masked, n_cand - 1)[1]
            cand = torch.cat([top_ids, torch.full((bsz, k, 1), eos_id,
                                                  dtype=torch.int64,
                                                  device=dev)], 2)
            cand_att_logp = att_logp.gather(2, cand)
        new_r_nb, new_r_b, ctc_ext, ctc_complete = ctc_prefix_step(
            ctc_logp, enc_lens, state["r_nb"], state["r_b"], state["last"],
            state["empty"], cfg.blank_id, cand=cand)

        # 3) joint candidate scores [B, K, C]
        att_new = state["att_cum"][:, :, None] + cand_att_logp
        w = cfg.ctc_weight
        is_eos_slot = (vocab_ids == eos_id)[None, None, :] if cand is None \
            else cand == eos_id
        # an eos candidate scores the hypothesis as a complete sequence
        cand_ctc = torch.where(is_eos_slot, ctc_complete[:, :, None], ctc_ext)
        scores = (1 - w) * att_new + w * cand_ctc
        if use_lm:
            # the extended hypothesis' cumulative LM log-prob (eos included)
            cand_lm = lm_logp if cand is None else lm_logp.gather(2, cand)
            scores = scores + cfg.lm_weight * (state["lm_cum"][:, :, None]
                                               + cand_lm)
        scores = scores + cfg.length_penalty * (
            state["length"] + 1)[:, :, None].to(torch.float32)
        if step_idx < cfg.min_len:
            scores = torch.where(is_eos_slot, NEG, scores)
        if cand is None:
            scores[:, :, cfg.blank_id] = NEG  # never emit blank
        # dead hypotheses propose nothing, finished ones only their frozen self
        fin = state["finished"][:, :, None]
        alive_scores = torch.where(fin, NEG, scores)
        alive_scores = torch.where(state["score"][:, :, None] <= NEG / 2, NEG,
                                   alive_scores)
        frozen = torch.where(is_eos_slot, state["score"][:, :, None], NEG)
        cand_scores = torch.where(fin, frozen, alive_scores)

        # 4) top-K over K*C
        top_scores, top_idx = _topk(cand_scores.reshape(bsz, k * n_cand), k)
        parent = torch.div(top_idx, n_cand, rounding_mode="floor")
        slot = top_idx % n_cand
        token = slot if cand is None else cand.reshape(bsz, -1).gather(1, top_idx)

        def sel(x):
            """Gather parent rows of a [B, K, ...] tensor."""
            idx = parent.reshape(parent.shape + (1,) * (x.dim() - 2))
            return x.gather(1, idx.expand((bsz, k) + x.shape[2:]))

        parent_finished = sel(state["finished"])
        parent_len = sel(state["length"])
        parent_att = sel(state["att_cum"])
        frozen_now = parent_finished | (token == eos_id)
        now_finish = ~parent_finished & (token == eos_id)
        write_pos = torch.clamp_max(parent_len, l_max - 1)
        appended = torch.where(
            (pos_ids[None, None, :] == write_pos[:, :, None])
            & ~frozen_now[:, :, None],
            token[:, :, None], sel(state["tokens"]))
        new_att = torch.where(
            parent_finished, parent_att,
            parent_att + sel(att_logp).gather(2, token[:, :, None])[..., 0])
        if use_lm:
            parent_lm = sel(state["lm_cum"])
            new_lm_cum = torch.where(
                parent_finished, parent_lm,
                parent_lm + sel(lm_logp).gather(2, token[:, :, None])[..., 0])

        def sel_cand(x):                                      # [B, K, C, T]
            p = sel(x)
            idx = slot[:, :, None, None].expand(bsz, k, 1, x.shape[3])
            return p.gather(2, idx)[:, :, 0]

        keep_r = frozen_now[:, :, None]
        new_state = {
            "tokens": appended,
            "length": torch.where(frozen_now, parent_len, parent_len + 1),
            "att_cum": new_att,
            "score": top_scores,
            "finished": parent_finished | now_finish,
            "last": torch.where(frozen_now, sel(state["last"]), token),
            "empty": sel(state["empty"]) & frozen_now,
            "r_nb": torch.where(keep_r, sel(state["r_nb"]), sel_cand(new_r_nb)),
            "r_b": torch.where(keep_r, sel(state["r_b"]), sel_cand(new_r_b)),
        }
        if use_cov:
            new_state["coverage"] = torch.where(
                keep_r, sel(state["coverage"]),
                sel(state["coverage"]) + sel(cross_attn))
        # decoder caches: [B*K, L, H, Dh] leaves, gather the parent beams
        rows = (row_base + parent).reshape(-1)
        caches = [{name: c.index_select(0, rows) for name, c in layer.items()}
                  for layer in new_caches]
        if use_lm:
            # finished hypotheses keep their old LM carry (the choice is
            # made per row before the gather), then the parent rows
            fin_rows = state["finished"].reshape(-1)
            lm_state = {
                name: torch.where(
                    fin_rows.reshape((-1,) + (1,) * (new.dim() - 1)),
                    lm_state[name], new).index_select(0, rows)
                for name, new in lm_new.items()}
            new_state["lm_cum"] = new_lm_cum
        state = new_state

    final = state["score"]
    if cfg.normalize_final:
        final = final / torch.clamp_min(state["length"].to(torch.float32), 1.0)
    if use_cov:
        valid = make_non_pad_mask(enc_lens, t_len)[:, None, :]
        covered = (state["coverage"] > cfg.coverage_tau) & valid
        final = final + cfg.coverage_weight * covered.sum(-1).to(torch.float32)
    order = torch.sort(-final, dim=1, stable=True).indices
    return {
        "tokens": state["tokens"].gather(
            1, order[:, :, None].expand(bsz, k, l_max)),
        "lengths": state["length"].gather(1, order),
        "scores": state["score"].gather(1, order),
        "finished": state["finished"].gather(1, order),
    }


def beam_search_transformer(model, feats, feat_lens, eos_id: int,
                            cfg: BeamSearchConfig, lm_model=None):
    """Encode + CTC head + batched search for a port ``TransformerASR``
    (feats [B, T, D]); ``lm_model``, an ``LSTMLM`` on the same device, is
    fused when cfg.lm_weight != 0."""
    k = cfg.beam_size
    enc, enc_lens = model.encode(feats, feat_lens)
    ctc_logits = model.apply_ctc_head(enc)
    bsz = feats.shape[0]
    caches = model.decoder_init_state(bsz * k, cfg.max_len)
    # encoder K/V projected once per utterance, then repeated across beams
    cross = [{name: c.repeat_interleave(k, dim=0) for name, c in layer.items()}
             for layer in model.decoder_precompute_cross(enc)]
    enc_lens_rep = enc_lens.repeat_interleave(k, dim=0)
    want_attn = cfg.coverage_weight != 0.0

    def decoder_step_fn(tokens, step, caches):
        return model.decoder_step(tokens, step, caches, enc_lens_rep, cross,
                                  return_attn=want_attn)

    lm_step_fn = init_lm_state = None
    if cfg.lm_weight != 0.0 and lm_model is not None:
        lm_step_fn = make_lm_step_fn(lm_model)
        init_lm_state = lm_model.init_state(bsz * k)
    return batched_beam_search(decoder_step_fn, caches, enc_lens, ctc_logits,
                               eos_id, cfg, lm_step_fn=lm_step_fn,
                               init_lm_state=init_lm_state)
