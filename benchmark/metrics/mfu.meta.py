"""The meta-step's model FLOPs (yardstick/flops) over the window, as % of the
cards' bf16 peak."""

from benchmark.yardstick import readers


def read(out):
    return readers.mfu(out)
