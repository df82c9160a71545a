"""The port's test files run torch on one intra-op thread a test.

The suite runs six test processes on the machine's cores, and torch's
default of a thread a core in each leaves its parallel regions waiting on
descheduled threads. Each port test file imports the fixture below:
``from test_torch_threads import _one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, the caller's count restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_a_test_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
