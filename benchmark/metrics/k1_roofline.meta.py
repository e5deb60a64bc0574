"""K1 (fbank_fft_kernel): its launches' least time from their shape over their
device time, in %."""

from benchmark.yardstick import readers


def read(out):
    return readers.roofline(out, readers.K1, readers.k1_least(out))
