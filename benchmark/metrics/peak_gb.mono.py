"""Peak device memory of the run, torch.cuda.max_memory_allocated, in GB."""

from benchmark.yardstick import readers


def read(out):
    return readers.peak_gb(out)
