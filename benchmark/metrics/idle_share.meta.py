"""% of the traced span with nothing running on the device."""

from benchmark.yardstick import readers


def read(out):
    return readers.idle_share(out)
