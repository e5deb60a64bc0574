"""Job kind ``serve``: requests through ``DynamicBatcher.submit`` to a
``ServingDecoder`` over a waveform-mode bundle written in set-up.

The traffic file gives the open-loop load (``rate`` requests a second,
lengths uniform over ``min_samples``..``max_samples``: ``yardstick/load``),
the bundle's buckets, the batcher's ``max_wait_ms`` and ``max_inflight``,
and the search's forced length (``min_len = max_len``). Set-up writes the
bundle from the seed's weights, loads it, and warms every bucket; the
window offers the load for ``--seconds`` and then waits up to a minute for
the last answers. A request's latency runs from when it was due.

Correct: a sample of the answered requests drawn from the seed, with the
longest among them; the reference scores every hypothesis of each one's
n-best from its tokens (``reference/beam_score``). ``score_gap`` is the
widest |served score - reference score|, in nats; a hypothesis of another
length than the search was forced to counts as failed.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

from benchmark import inputs, program
from benchmark.yardstick import load

WAIT_AFTER_S = 60.0
# a served score this low carries the search's -1e9 sentinel: a hypothesis
# the CTC prefix scores hold impossible
IMPOSSIBLE = -1e8


class Server:
    def __init__(self, ctx, dev):
        import tempfile

        from metaasr_tpu_torch.data.tokenizer import CharTokenizer
        from metaasr_tpu_torch.serve.batcher import DynamicBatcher
        from metaasr_tpu_torch.serve.export import (
            ServingDecoder,
            write_bundle,
        )
        from metaasr_tpu_torch.task import ASRTask
        from metaasr_tpu_torch.weights import state_dict_to_flax

        conf, t = ctx.cell.config, ctx.cell.traffic
        self.traffic, self.dev = t, dev
        cfg = program.config(conf)
        cfg.data.max_tokens = t["decode_len"]
        cfg.train.beam_min_len = t["decode_len"]
        self.shapes = program.parameter_shapes(ASRTask(cfg, device=dev))
        params = inputs.make_weights(self.shapes, ctx.seed, dev)
        self._dir = tempfile.TemporaryDirectory()
        tokenizer = CharTokenizer.ascii_default()
        if tokenizer.vocab_size != cfg.model.vocab_size:
            raise ValueError("the character vocabulary does not match "
                             "model.vocab_size")
        write_bundle(self._dir.name, cfg,
                     state_dict_to_flax(params, cfg.model.num_heads),
                     tokenizer, [tuple(b) for b in t["buckets"]])
        del params
        with open(os.path.join(self._dir.name, "tokenizer.json")) as f:
            symbols = json.load(f)["symbols"]
        self.ids = {s: i + 1 for i, s in enumerate(symbols)}
        self.decoder = ServingDecoder(self._dir.name, device=dev)
        widest = max(w for _, w in t["buckets"])
        warm = inputs.make_utterances(1, widest, 1, 3, ctx.seed, 7,
                                      dev)["audio"][0].cpu().numpy()
        for bsz, _ in t["buckets"]:
            self.decoder.transcribe([warm] * bsz, nbest=cfg.train.beam_size)
        self.batcher = DynamicBatcher(self.decoder,
                                      max_wait_ms=t["max_wait_ms"],
                                      nbest=cfg.train.beam_size,
                                      max_inflight=t["max_inflight"])
        self.batcher.submit(warm).result()

    def requests(self, seconds: float, seed: int) -> load.Window:
        """``seconds`` of the load, made before it is offered: due times
        and waveforms (on the host, as a client sends them)."""
        t = self.traffic
        due, lengths = load.schedule(t["rate"], seconds, t["min_samples"],
                                     t["max_samples"], seed)
        audio = inputs.make_utterances(len(due), t["max_samples"], 1, 3,
                                       seed, 11, self.dev)["audio"]
        waves = audio.cpu().numpy()
        return load.Window(self.batcher.submit,
                           [waves[i, :n] for i, n in enumerate(lengths)],
                           due)

    def offer(self, window: load.Window, t0=None):
        """Offer a window's requests from ``t0`` (now by default) and wait
        for their answers -> (t0, groups, requests dispatched)."""
        seconds = float(window.due[-1]) if len(window.due) else 0.0
        before = dict(self.batcher.stats)
        t0 = t0 if t0 is not None else time.perf_counter()
        window.run(t0)
        window.wait(t0 + seconds + WAIT_AFTER_S)
        after = self.batcher.stats
        return (t0, after["batches"] - before["batches"],
                after["requests"] - before["requests"])

    def close(self):
        self.batcher.close()
        self.batcher = self.decoder = None
        self._dir.cleanup()


def run(ctx) -> dict:
    import torch

    from benchmark.yardstick.trace import traced

    dev = torch.device(ctx.device)
    srv = Server(ctx, dev)
    window = srv.requests(ctx.seconds, ctx.seed)
    t0, groups, requests = srv.offer(window, ctx.window_opens())
    lat = window.latencies(t0)
    failed = int(np.sum(~np.isfinite(lat)))
    facts = {"groups": groups, "requests": requests,
             "device_kind": program.device_kind(dev), "chips": 1}
    trace = None
    if ctx.trace:
        span = ctx.cell.workload.get("traced_seconds", 3.0)
        traced_window = srv.requests(span, ctx.seed + 1)
        trace, (_, t_groups, _) = traced(
            torch, lambda: srv.offer(traced_window))
        facts["traced_groups"] = t_groups
    peak = program.memory_peak(dev)
    # the sample the reference judges: drawn from the seed among the
    # answered requests, with the longest answered one in it
    answered = [i for i, r in enumerate(window.results) if r is not None]
    rng = np.random.default_rng(ctx.seed)
    pick = set(rng.choice(answered, min(ctx.cell.workload["sample"],
                                        len(answered)), replace=False)
               .tolist()) if answered else set()
    if answered:
        pick.add(max(answered, key=lambda i: len(window.payloads[i])))
    shapes, ids = srv.shapes, srv.ids
    chosen = [(window.payloads[i], window.results[i]) for i in sorted(pick)]
    srv.close()
    del srv, window
    program.release(dev)
    gap = math.inf if not chosen else score_gap(ctx, dev, shapes, ids,
                                                chosen, "fp32")
    checks = [{"name": "score_gap", "value": gap if math.isfinite(gap)
               else 1e308, "limit": ctx.cell.workload["limits"]["score_gap"]}]
    return dict(facts, end_to_end={"serve_p95_ms": 1e3 * load.p95(lat)
                                   if failed == 0 else 1e3 * (
                                       ctx.seconds + WAIT_AFTER_S)},
                attempted=len(lat), failed=failed, memory_peak_bytes=peak,
                checks=checks, trace=trace)


def hypotheses(result: dict, ids: dict, length: int) -> np.ndarray | None:
    """A result's n-best as token ids [K, L] through the bundle's symbol
    list, or None when one is not a string of ``length`` symbols."""
    rows = []
    for h in result["nbest"]:
        row = [ids.get(c) for c in h["hyp"]]
        if None in row or len(row) != length:
            return None
        rows.append(row)
    return np.asarray(rows)


def reference_scores(ctx, dev, shapes, ids, chosen, precision: str):
    """The reference's joint score of every hypothesis of the chosen
    requests' n-best, its products in ``precision`` -> one [K] array a
    request, or None where a hypothesis cannot be read back."""
    import torch

    from benchmark.reference import beam_score, numerics
    from benchmark.reference.transformer import Transformer

    numerics.strict_fp32()
    conf, t = ctx.cell.config, ctx.cell.traffic
    m = conf["model"]
    requests = []
    for wave, result in chosen:
        hyps = hypotheses(result, ids, t["decode_len"])
        if hyps is None:
            return None
        requests.append((torch.from_numpy(np.ascontiguousarray(wave)).to(dev),
                         hyps))
    model = Transformer(inputs.make_weights(shapes, ctx.seed, dev),
                        heads=m["num_heads"],
                        enc_layers=m["num_encoder_layers"],
                        dec_layers=m["num_decoder_layers"], dropout=0.0,
                        precision=numerics.Precision(precision))
    return beam_score.hypothesis_scores(model, requests,
                                        conf["train"]["decode_ctc_weight"])


def score_gap(ctx, dev, shapes, ids, chosen, precision: str) -> float:
    """The widest |served - reference| joint score over the chosen requests'
    n-best."""
    scores = reference_scores(ctx, dev, shapes, ids, chosen, precision)
    if scores is None:
        return math.inf
    served = [np.asarray([h["score"] for h in r["nbest"]]) for _, r in chosen]
    impossible = sum(int(np.isneginf(a).sum()) for a in scores)
    print(f"score_gap over {sum(a.size for a in scores)} hypotheses of "
          f"{len(scores)} requests, {impossible} of them judged by the "
          "sentinel alone", file=sys.stderr)
    return float(max(np.max(gap(a, b)) for a, b in zip(scores, served)))


def gap(reference: np.ndarray, served: np.ndarray) -> np.ndarray:
    """|served - reference| a hypothesis. A hypothesis CTC cannot align in
    the utterance's frames (48 forced tokens in the 48 encoder frames of a
    2 s request) has the reference score -inf; the search's own sentinel
    (-1e9 in its CTC prefix scores) marks it so: it agrees where the served
    score lies below ``IMPOSSIBLE``."""
    impossible = np.isneginf(reference)
    return np.where(impossible, np.where(served < IMPOSSIBLE, 0.0, np.inf),
                    np.abs(np.where(impossible, 0.0, reference) - served))
