"""Settings of the benchmark's own tests: one torch thread (several pytest
workers each with torch's default thread count slow each other), and the
`cuda` mark of the tests that need the card."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA device; skips inside the test where '
        'there is none')
    torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')
