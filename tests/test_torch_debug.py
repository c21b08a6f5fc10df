"""enable_nan_checks (esm_tpu_torch.utils.debug): like esm_tpu's jax_debug_nans,
a NaN raises in the forward as well as in the backward, naming the
operation; checks off, the same code runs through."""

import pytest
import torch

from esm_tpu_torch.utils import debug


@pytest.fixture
def checks():
    debug.enable_nan_checks()
    yield
    debug.enable_nan_checks(False)


def test_forward_nan_raises(checks):
    x = torch.tensor([4.0, -1.0])
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        torch.sqrt(x)
    assert torch.equal(torch.sqrt(x[:1]), torch.tensor([2.0]))
    torch.empty(1 << 16)  # uninitialised memory is not checked


def test_backward_nan_raises(checks):
    x = torch.tensor([0.0], requires_grad=True)
    y = torch.sqrt(x) * 0.0  # forward finite, backward 0 * inf
    with pytest.raises(FloatingPointError, match="nan"):
        y.sum().backward()


def test_off_again():
    debug.enable_nan_checks()
    debug.enable_nan_checks(False)
    assert torch.isnan(torch.sqrt(torch.tensor([-1.0]))).all()
