"""The joint CTC-attention score of a decoded hypothesis (Watanabe et al.,
2017; Hori et al., 2017), worked out from the tokens alone.

For tokens y_1..y_L of an utterance that did not end (no eos):
``(1 - w) * sum_l log p_att(y_l | sos, y_<l) + w * log psi(y_1..y_L)``, with
p_att the teacher-forced decoder's softmax and psi the CTC prefix
probability: the total probability of the frame alignments whose labels
begin with y_1..y_L, over the utterance's valid encoder frames. psi follows
the prefix recursion over frames of Graves (2008, ch. 7) in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import frontend
from benchmark.reference.transformer import Transformer


def ctc_prefix_logprob(logp: np.ndarray, hyps: np.ndarray,
                       frames: np.ndarray, blank: int = 0) -> np.ndarray:
    """logp [N, T, V] float64 CTC log posteriors, hyps [N, L] ids, frames
    [N] valid frame counts -> [N] log psi of each whole hypothesis."""
    n, t_len, _ = logp.shape
    rows = np.arange(n)
    active = np.arange(t_len)[None, :] < frames[:, None]          # [N, T]
    lp_blank = np.where(active, logp[:, :, blank], 0.0)
    r_b = np.cumsum(lp_blank, axis=1)                              # empty
    r_nb = np.full((n, t_len), -np.inf)
    start_b = np.zeros(n)                                          # t = -1
    psi = np.zeros(n)
    last = np.full(n, -1)
    for c in hyps.T:
        lp_c = logp[rows, :, c]                                    # [N, T]
        prev_b = np.concatenate([start_b[:, None], r_b[:, :-1]], 1)
        prev_nb = np.concatenate([np.full((n, 1), -np.inf), r_nb[:, :-1]], 1)
        phi = np.logaddexp(prev_b, np.where((c != last)[:, None], prev_nb,
                                            -np.inf))
        new_nb = np.empty((n, t_len))
        new_b = np.empty((n, t_len))
        nb = b = np.full(n, -np.inf)
        for t in range(t_len):
            nb_t = np.logaddexp(nb, phi[:, t]) + lp_c[:, t]
            b_t = np.logaddexp(b, nb) + logp[:, t, blank]
            act = active[:, t]
            nb, b = np.where(act, nb_t, nb), np.where(act, b_t, b)
            new_nb[:, t], new_b[:, t] = nb, b
        terms = np.where(active, phi + lp_c, -np.inf)
        psi = np.logaddexp.reduce(terms, axis=1)
        r_nb, r_b = new_nb, new_b
        start_b = np.full(n, -np.inf)
        last = c
    return psi


def hypothesis_scores(model: Transformer, requests: list,
                      ctc_weight: float = 0.3) -> list:
    """``requests``: (waveform [S] tensor, hypotheses [K, L] ids) pairs ->
    one [K] array of joint scores each. The CTC prefix recursion runs once
    over every hypothesis of every request."""
    att, logps, frames, hyps = [], [], [], []
    sos = model.P["decoder.embed.weight"].shape[0] - 1
    with torch.no_grad():
        for audio, h in requests:
            dev = audio.device
            feats, flen = frontend.features(
                audio[None], torch.tensor([audio.shape[0]], device=dev))
            enc, enc_lens = model.encode(feats, flen)
            ctc_logp = torch.log_softmax(model.ctc_logits(enc).double(), -1)
            k, length = h.shape
            ids = torch.as_tensor(h, device=dev, dtype=torch.long)
            tokens_in = torch.cat([torch.full((k, 1), sos, device=dev,
                                              dtype=torch.long),
                                   ids[:, :-1]], 1)
            logits = model.decode(tokens_in,
                                  torch.full((k,), length, device=dev),
                                  enc.expand(k, -1, -1), enc_lens.expand(k))
            att.append(torch.log_softmax(logits.double(), -1).gather(
                2, ids[..., None])[..., 0].sum(1).cpu().numpy())
            logps += [ctc_logp[0].cpu().numpy()] * k
            frames += [int(enc_lens[0])] * k
            hyps.append(np.asarray(h))
    t_max = max(lp.shape[0] for lp in logps)
    padded = np.stack([np.pad(lp, ((0, t_max - lp.shape[0]), (0, 0)))
                       for lp in logps])
    psi = ctc_prefix_logprob(padded, np.concatenate(hyps),
                             np.asarray(frames))
    out, at = [], 0
    for a in att:
        out.append((1.0 - ctc_weight) * a + ctc_weight * psi[at: at + len(a)])
        at += len(a)
    return out
