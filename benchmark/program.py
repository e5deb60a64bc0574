"""The program under test, as the benchmark drives it: its config built from
a configuration file, its device, its parameter layout. This is the only
module of the harness that imports the program, and only inside functions."""

from __future__ import annotations

SECTIONS = ("frontend", "specaug", "model", "optimizer", "meta", "data",
            "train")


def config(conf: dict):
    """The program's ``Config`` from a configuration file's sections."""
    from metaasr_tpu_torch.config import Config

    cfg = Config()
    for section in SECTIONS:
        for key, value in conf.get(section, {}).items():
            obj = getattr(cfg, section)
            if not hasattr(obj, key):
                raise KeyError(f"{section}.{key} is not a setting of the "
                               "program")
            setattr(obj, key, tuple(value) if isinstance(value, list)
                    else value)
    return cfg


def device_kind(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def parameter_shapes(task) -> dict:
    """{name: shape} of the model's parameters, in the program's naming."""
    return {k: tuple(v.shape) for k, v in task.model.state_dict().items()}


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def release(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
