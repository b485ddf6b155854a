"""The port's copy of the production executor configuration equals the JAX
package's, name by name."""
import pytest

from alphazero_tpu import production as jprod
from alphazero_tpu_torch import production as tprod

NAMES = ["INFERENCE", "INT8_CALIB_PERCENTILE", "INT8_RESIDUAL", "INT8_HEADS",
         "INT8_CHUNK", "CALIB_GAMES", "CALIB_PLIES", "CALIB_EVERY",
         "MATCH_TREE_REUSE", "MATCH_REUSE_BUDGET"]


def test_executor_config_equals_jax():
    assert tprod.executor_config() == jprod.executor_config()
    assert tprod.executor_config()["inference"] == "int8"


@pytest.mark.parametrize("name", NAMES)
def test_constant_equals_jax(name):
    assert getattr(tprod, name) == getattr(jprod, name)


def test_no_constant_is_missing():
    public = {n for n in vars(jprod) if n.isupper()}
    assert public == set(NAMES)
    assert public == {n for n in vars(tprod) if n.isupper()}
