"""Device milliseconds of NCCL all-reduce kernels a step on rank 0, over the
traced span."""

from benchmark.jobs.meta_train_dp import ALLREDUCE


def read(out):
    trace, steps = out.get("trace"), out.get("traced_steps")
    if trace is None or not steps:
        return None
    launches, seconds = trace.matching(lambda n: bool(ALLREDUCE.search(n)))
    return 1e3 * seconds / steps if launches else None
