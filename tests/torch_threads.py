"""The port's test files hold torch to one intra-op thread.

Import ``one_torch_thread`` into a test module to make it active there (it
is autouse, module-scoped, and so set up before the module's other
fixtures). The port's tests run many small ops: the search, serving loops,
tiny training steps. Under the suite's xdist workers, which share the
cores, torch's thread pool only waits on the other workers: a full-vocab
decode ran ~200x slower, and a two-step training run with one beam decode
took 385 s against 2 s alone.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
