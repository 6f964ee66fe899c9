"""One intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist worker processes at once.  PyTorch
gives each process as many intra-op threads as the machine has cores, and
their OpenMP threads spin while they wait, so a few pools on one machine's
cores spend most of their time waiting on one another.  The port's tests
run small shapes that gain nothing from a pool.  Each port test file
imports :func:`one_torch_thread`, an autouse module fixture: the file's
fixtures and tests run with one intra-op thread, and the previous count
comes back after the file."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
