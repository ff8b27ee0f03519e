"""One torch intra-op thread for a test module, imported by the port's
test files (``from torch_threads import one_thread``; autouse).

The suite runs in several worker processes on a few cores, and each
torch op defaults to one OpenMP thread a core: the workers' spinning
threads then take the cores from one another, and a test that takes 3 s
alone took 140 s in the suite (``test_torch_unpack_bf16x3.py``'s fc2
case). The count is put back when the module's tests end."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
