"""Torch's CPU threads in the port's tests.

The suite runs as several pytest-xdist workers on one host, and torch
starts one intra-op thread per core in each of them, so at the suite's
tiny shapes the workers' thread pools spin against each other (and
against XLA's compiles in the JAX tests) far more than they compute.
Every ``tests/test_torch_*.py`` module imports :func:`share_cores`, an
autouse fixture that gives each worker its share of the cores while the
module runs and restores torch's count after it.  A run without xdist
keeps every core.
"""

import os

import pytest
import torch


def cores_per_worker() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, cores_per_worker()))
    yield
    torch.set_num_threads(before)


def test_share_cores_caps_torch_threads():
    assert torch.get_num_threads() <= cores_per_worker()
    assert torch.get_num_threads() >= 1


def test_cores_per_worker_divides_the_host(monkeypatch):
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert cores_per_worker() == 1
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "2")
    assert cores_per_worker() == 4
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
    assert cores_per_worker() == 8
    monkeypatch.setattr(os, "cpu_count", lambda: None)
    assert cores_per_worker() == 1
