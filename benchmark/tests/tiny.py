"""Cells cut to a size the CPU runs in seconds, for the tests."""

from benchmark import calibrate, run

TINY_XFMR = {"model": {"d_model": 32, "num_heads": 4, "d_ff": 64,
                       "num_encoder_layers": 2, "num_decoder_layers": 2}}


def cell(name: str) -> run.Cell:
    c = run.Cell(name, calibrate.with_waiting())
    if c.workload["job"] == "meta_train":
        return c.override(config=TINY_XFMR, traffic={
            "tasks": 2, "k_support": 2, "k_query": 2, "samples": 16000,
            "tokens": 8, "pool": 4})
    if c.workload["job"] == "mono_train":
        return c.override(config={"model": {
            "blstm_hidden": 16, "blstm_layers": 2, "vgg_channels": [4, 8]}},
            traffic={"batch": 4, "samples": 16000, "tokens": 8, "pool": 4})
    return c.override(config=TINY_XFMR, traffic={
        "rate": 4.0, "min_samples": 8000, "max_samples": 16000,
        "buckets": [[1, 16000], [4, 16000]], "decode_len": 8},
        workload={"sample": 4})


def context(name: str, seed: int = 12345, seconds: float = 1.0,
            c: run.Cell | None = None) -> run.Context:
    return run.Context(c or cell(name), seed, seconds, False, device="cpu")
