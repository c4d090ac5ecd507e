"""The port's ``cli/buffer.main`` with ``--parallel_experts=2`` against the
JAX package's, on the CPU: 2 experts trained in lockstep, each on its own
batch stream, x 5 epochs, at the size, inits, caption caches and
tolerances of tests/test_torch_buffer_cli.py (a file of its own so that
neither file's JAX runs make it long)."""

import pytest

from test_torch_buffer_cli import (
    assert_logs_match,
    assert_pt_matches_npz,
    assert_trajectories_match,
    run_both,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("buffer_parallel"), "parallel",
                    parallel_experts=2)


def test_parallel_trajectories_match_jax_cli(runs):
    assert_trajectories_match(runs)


def test_parallel_logged_metrics_match_jax_cli(runs):
    assert_logs_match(runs)


def test_parallel_pt_matches_its_npz(runs):
    assert_pt_matches_npz(runs)
