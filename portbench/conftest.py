"""pytest settings of the benchmark's own tests: the ``card`` marker.  A
test that needs the CUDA card takes the ``card`` fixture, which skips it
where there is none (decided when the test runs, not at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; run on the card with "
        "`python -m pytest portbench/tests -m card`")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the control and the faults are read at the "
                    "cells' own sizes)")
    return torch.device("cuda:0")
