"""One torch intra-op thread for a test module of the port.

The tier-1 run takes the suite in 6 worker processes on the machine's
cores; torch's default pool (a thread a core in every worker) then
oversubscribes them, and every small op of these toy-width tests waits on
its pool (tests/test_torch_bench.py: 11 s alone, 449 s in that run). A file
imports the fixture below; pytest finds it in the module's namespace.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
