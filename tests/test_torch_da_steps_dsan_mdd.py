"""The DSAN and MDD cases of tests/test_torch_da_steps.py (its docstring
says what they check): three f64 train steps against JAX's within 1e-9,
and the models' forwards and gradients within 1e-10."""

import pytest
from test_torch_da_steps import check_model_forward_and_grads, check_three_f64_steps
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("case", ["dsan", "mdd"])
def test_three_f64_steps_match_jax(case):
    check_three_f64_steps(case)


@pytest.mark.parametrize("case", ["dsan", "mdd"])
def test_model_forward_and_grads_match_flax_at_f64(case):
    check_model_forward_and_grads(case)
