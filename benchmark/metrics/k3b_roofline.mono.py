"""K3b (lstm_bwd_kernel and its lstm_du_kernel, one launch each a K3b call):
the launches' least time from their shape over their device time, in %."""

from benchmark.yardstick import readers


def read(out):
    return readers.roofline(out, readers.K3B, readers.k3_least(out, 1),
                            launch=readers.K3B_LAUNCH)
