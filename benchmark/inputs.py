"""Weights and batches made from the run's seed, on the device, in a few
large draws. Both the program and the reference are handed these.

Weights, by parameter name: LayerNorm scales 1 and shifts 0, other biases
N(0, 0.02^2), embeddings N(0, 1), an LSTM's recurrent [H, 4H] N(0, 1/(4H))
(rows of about unit norm), every other matrix or kernel N(0, 1/fan_in).
Audio is 0.1 N(0, 1) noise; tokens are uniform over the symbols (ids 1 to
V - 2: not the blank 0, not sos/eos V - 1).
"""

from __future__ import annotations

import math

import torch


def _seed(seed: int, salt: int) -> int:
    return (int(seed) * 1_000_003 + salt) % (2**63 - 1)


def make_weights(shapes: dict, seed: int, device) -> dict:
    """{name: shape} -> {name: float32 tensor on ``device``}."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 1))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[at: at + n].view(shape)
        at += n
        module, leaf = name.split(".")[-2:]
        if module.startswith("norm") or module == "final_norm":
            x = torch.ones_like(x) if leaf == "weight" else torch.zeros_like(x)
        elif leaf == "bias":
            x = 0.02 * x
        elif module == "embed":
            pass
        elif leaf == "recurrent":
            x = x / math.sqrt(shape[1])
        else:
            x = x / math.sqrt(math.prod(shape[1:]))
        out[name] = x.contiguous()
    return out


def make_utterances(count: int, samples: int, tokens: int, vocab: int,
                    seed: int, salt: int, device) -> dict:
    """``count`` utterances of ``samples`` samples and ``tokens`` tokens:
    {audio [count, samples] f32, audio_lens, tokens [count, tokens],
    token_lens} (int32 lengths and ids)."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, salt))
    audio = 0.1 * torch.randn((count, samples), generator=gen, device=device)
    ids = torch.randint(1, vocab - 1, (count, tokens), generator=gen,
                        device=device, dtype=torch.int32)
    return {"audio": audio,
            "audio_lens": torch.full((count,), samples, dtype=torch.int32,
                                     device=device),
            "tokens": ids,
            "token_lens": torch.full((count,), tokens, dtype=torch.int32,
                                     device=device)}


def meta_batches(n: int, tasks: int, k_support: int, k_query: int,
                 samples: int, tokens: int, vocab: int, seed: int,
                 device) -> list:
    """``n`` meta-batches {support, query}, each key [tasks, k, ...]; every
    utterance differs."""
    out = []
    for i in range(n):
        both = make_utterances(tasks * (k_support + k_query), samples,
                               tokens, vocab, seed, 100 + i, device)
        split = {}
        for name, k, lo in (("support", k_support, 0),
                            ("query", k_query, tasks * k_support)):
            split[name] = {key: v[lo: lo + tasks * k].reshape(
                (tasks, k) + v.shape[1:]).contiguous()
                for key, v in both.items()}
        out.append(split)
    return out


def batches(n: int, size: int, samples: int, tokens: int, vocab: int,
            seed: int, device) -> list:
    return [make_utterances(size, samples, tokens, vocab, seed, 100 + i,
                            device) for i in range(n)]
