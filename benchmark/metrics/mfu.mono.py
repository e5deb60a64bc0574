"""The baseline step's model FLOPs (yardstick/flops) over the window, as % of
the card's TF32 peak."""

from benchmark.yardstick import readers


def read(out):
    return readers.mfu(out)
