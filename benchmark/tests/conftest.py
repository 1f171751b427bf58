"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the repository (CPU, a few minutes); the tests marked ``cuda``
run on a card only and skip elsewhere."""

import pytest
import torch

from benchmark import run
from benchmark.tests.cpu import full_spec


@pytest.fixture(autouse=True)
def later_cells(monkeypatch):
    """Every test sees the cells of ``later_cells.json`` as well."""
    spec = full_spec()
    monkeypatch.setattr(run, "spec_of", lambda root=run.ROOT: spec)


@pytest.fixture
def card():
    """A CUDA device, or a skip where there is none (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
