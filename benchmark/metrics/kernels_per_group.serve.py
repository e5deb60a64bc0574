"""Kernels a dispatched group: CUDA kernel events in the traced span over the
groups the batcher dispatched in it."""

from benchmark.yardstick import readers


def read(out):
    return readers.kernels_per(out, "traced_groups")
