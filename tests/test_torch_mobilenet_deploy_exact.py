"""The port's QAT MobileNet-V2 with deploy_exact against flax's at f64:
the second configuration of tests/test_torch_mobilenet.py (which says
what is held and how), in a file of its own so that the suite's workers
run the two JAX compilations side by side; and the deploy_exact requant
sites of the port's model."""

import pytest
from test_torch_mobilenet import check_matches_flax_at_f64
from torch_port_helpers import one_torch_thread  # noqa: F401

from alignq_tpu_torch.models.mobilenetv2 import mobile_v2

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_mobilenetv2_deploy_exact_matches_flax_at_f64():
    check_matches_flax_at_f64("deploy_exact-int8-W8A8-admm")


def test_deploy_exact_requant_sites():
    """Block inputs after a stride-1 block, and the head conv's input when
    the last block is one, requantize on the m = 2 grid (the INT graph's
    m_in); the others take none."""
    model = mobile_v2(variant="int8", deploy_exact=True)
    ms = [getattr(model, f"layers_{i}").requant_m for i in range(17)]
    strides = [getattr(model, f"layers_{i}").stride for i in range(17)]
    assert ms == [None] + [2 if s == 1 else None for s in strides[:-1]]
    assert model.head_requant_m == 2
    assert all(m is None for m in [getattr(mobile_v2(), f"layers_{i}").requant_m for i in range(17)])
