import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Test workers run beside each other: two threads each keep a smoke
    run's ticks quick enough that its window finishes requests."""
    torch.set_num_threads(2)
