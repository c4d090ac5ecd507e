"""Data parallelism of the distill step against the JAX Distiller on a
2-device mesh (two ranks).

The JAX Distiller runs on a 2-device CPU mesh (``get_mesh((2,))`` over
``tests/conftest.py``'s 8 CPU devices) with ``--shard_syn`` on, the port's
on 2 ``gloo`` ranks; the setting and the tolerances are in
``tests/torch_dp_jax.py``.  The minibatch (5) and the query count (7)
divide neither world: both packages pad and mask the minibatch and pad the
synthetic set with inert rows.  Under ``fr_bwd`` ``rof`` and ``for``.
"""

import pytest

from test_torch_threads import share_cores  # noqa: F401 (autouse)
from torch_dp_jax import MODES, check_against_jax, check_steps_and_pad_rows
from torch_dp_jax import run_both

MODE_IDS = [m["fr_bwd"] for m in MODES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(2, tmp_path_factory.mktemp("dp2"))


@pytest.mark.parametrize("mode", range(len(MODES)), ids=MODE_IDS)
def test_students_loss_and_meta_gradients_match_jax_mesh(runs, mode):
    check_against_jax(runs, mode)


@pytest.mark.parametrize("mode", range(len(MODES)), ids=MODE_IDS)
def test_outer_steps_and_pad_rows(runs, mode):
    check_steps_and_pad_rows(runs, mode)
