"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the repository's root. Tests that need the card carry the `card` marker
and skip inside their `card` fixture when there is none; run them on the
card with `python -m pytest benchmark/tests -q -m card`."""
import pytest

import bench_paths  # noqa: F401 (puts the benchmark on sys.path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
