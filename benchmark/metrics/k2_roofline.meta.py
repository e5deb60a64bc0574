"""K2 (ctc_kernel<false, ...>): its launches' least time from their shape over
their device time, in %."""

from benchmark.yardstick import readers


def read(out):
    return readers.roofline(out, readers.K2, readers.k2_least(out))
