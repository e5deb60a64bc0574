"""K3 (lstm_fwd_kernel): its launches' least time from their shape over their
device time, in %."""

from benchmark.yardstick import readers


def read(out):
    return readers.roofline(out, readers.K3, readers.k3_least(out, 0))
