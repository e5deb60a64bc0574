"""Kernels a meta-step: CUDA kernel events in the traced span over its
steps."""

from benchmark.yardstick import readers


def read(out):
    return readers.kernels_per(out, "traced_steps")
