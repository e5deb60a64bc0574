"""Port vs reference: the package re-exports of ``data``, ``utils`` and
``frontend``, the padding helpers ``make_pad_mask`` / ``pad_to`` and the
step timer ``utils.profiling.Timer``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.utils import padding as ref_padding
from metaasr_tpu_torch.utils import padding, profiling
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# package -> {exported name: the port module that defines it}
EXPORTS = {
    "data": {"CharTokenizer": "data.tokenizer", "PhoneTokenizer":
             "data.tokenizer", "AccentDataset": "data.dataset",
             "Manifest": "data.dataset", "Utterance": "data.dataset",
             "TaskSampler": "data.sampler", "BucketBatcher": "data.sampler",
             "collate": "data.sampler"},
    "utils": {n: "utils.padding" for n in (
        "make_pad_mask", "make_non_pad_mask", "subsampled_lengths", "pad_to",
        "bucket_length")},
    "frontend": {"FbankParams": "frontend.fbank", "log_mel_fbank":
                 "frontend.fbank", "num_frames": "frontend.fbank",
                 "spec_augment": "frontend.specaug"},
}


@pytest.mark.parametrize("pkg", sorted(EXPORTS))
def test_reexports_are_the_reference_names_and_the_modules_own(pkg):
    ref = importlib.import_module(f"metaasr_tpu.{pkg}")
    port = importlib.import_module(f"metaasr_tpu_torch.{pkg}")
    assert sorted(port.__all__) == sorted(ref.__all__) == sorted(EXPORTS[pkg])
    for name, mod in EXPORTS[pkg].items():
        own = importlib.import_module(f"metaasr_tpu_torch.{mod}")
        assert getattr(port, name) is getattr(own, name), name


@pytest.mark.parametrize("max_len", (1, 7, 12))
def test_make_pad_mask_matches_reference(max_len):
    lens = np.random.default_rng(max_len).integers(0, max_len + 3, 9)
    want = np.asarray(ref_padding.make_pad_mask(jnp.asarray(lens), max_len))
    got = padding.make_pad_mask(torch.from_numpy(lens), max_len)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), ~padding.make_non_pad_mask(torch.from_numpy(lens),
                                                max_len).numpy())


@pytest.mark.parametrize("shape,length,axis,value", [
    ((5, 3), 8, 0, 0), ((5, 3), 2, 0, 0), ((5, 3), 6, 1, -1.5),
    ((5, 3), 3, 1, 0), ((2, 4, 3), 9, 1, 7), ((2, 4, 3), 1, 2, 0)])
def test_pad_to_matches_reference(shape, length, axis, value):
    x = np.random.default_rng(len(shape) + length).standard_normal(
        shape).astype(np.float32)
    want = ref_padding.pad_to(x, length, axis, value)
    got = padding.pad_to(x, length, axis, value)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_timer_median_and_throughput(monkeypatch):
    clock = iter([10.0, 11.0, 20.0, 23.0, 30.0, 32.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    t = profiling.Timer()
    assert np.isnan(t.median) and np.isnan(t.throughput(4))
    for _ in range(3):
        with t:
            pass
    assert t.times == [1.0, 3.0, 2.0]
    assert t.median == 2.0 and t.throughput(10) == 5.0


def test_timer_block_passes_through_and_waits_for_no_cpu_tensor(
        monkeypatch):
    def no_sync(*a):
        raise AssertionError("synchronized for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    t = profiling.Timer()
    x = {"a": torch.ones(2), "b": [torch.zeros(1), (torch.ones(1), 3)]}
    assert t.block(x) is x
    y = torch.arange(3)
    with t:
        assert t.block(y) is y
    assert len(t.times) == 1
