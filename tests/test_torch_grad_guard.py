"""The guard that makes the CUDA routes of K6, K7 and K8 refuse gradients.

The kernels have no backward, so on the card each entry calls
``refuse_grad`` before it launches. The helper itself decides on any
tensors, so it is checked here on CPU tensors; the CPU routes, which run the
plain versions, still differentiate.
"""

import numpy as np
import pytest
import torch

from esm_tpu_torch.kernels import triangle_mul as tm
from esm_tpu_torch.kernels._grad import refuse_grad
from esm_tpu_torch.ops.triangle import TriangleMultiplication


def _module(c, seed=0):
    gen = torch.Generator().manual_seed(seed)
    mod = TriangleMultiplication(c)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(generator=gen).mul_(0.1)
    return mod


def _tensors(requires_grad):
    a = torch.zeros(3)
    b = torch.ones(2, 2, requires_grad=requires_grad)
    return a, None, b


@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("grad_enabled", [False, True])
def test_refuse_grad(requires_grad, grad_enabled):
    """Raises, naming the kernel, only when grad mode is on and a tensor
    requires grad; None entries are skipped."""
    with torch.set_grad_enabled(grad_enabled):
        if requires_grad and grad_enabled:
            with pytest.raises(RuntimeError, match=r"^K7 \(test\): .*no backward"):
                refuse_grad("K7 (test)", *_tensors(requires_grad))
        else:
            refuse_grad("K7 (test)", *_tensors(requires_grad))


def test_refuse_grad_sees_weights_derived_from_parameters():
    """The tri-mul entries pass the weights that stage1_weights and
    epilogue_weights derive from the module: they carry requires_grad from
    its parameters under grad, and not under no_grad."""
    mod = _module(8)
    for weights in (tm.stage1_weights(mod, torch.float32),
                    tm.epilogue_weights(mod, torch.float32)):
        with pytest.raises(RuntimeError, match="no backward"):
            refuse_grad("K8", *weights)
    with torch.no_grad():
        refuse_grad("K8", *tm.stage1_weights(mod, torch.float32))
        refuse_grad("K8", *tm.epilogue_weights(mod, torch.float32))


def test_cpu_routes_still_differentiate():
    """On CPU tensors the entries run the plain versions, which autograd
    differentiates: the guard is on the CUDA route only."""
    rng = np.random.RandomState(0)
    mod = _module(8, seed=1)
    z = torch.from_numpy(rng.randn(1, 3, 4, 8).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rng.randn(1, 3, 4, 8).astype(np.float32))
    a, b = tm.tri_mul_stage1(z, None, mod)
    o = tm.tri_mul_epilogue(x, z, mod)
    (a.sum() + b.sum() + o.sum()).backward()
    assert z.grad is not None and torch.isfinite(z.grad).all()
    assert mod.linear_a_g.weight.grad is not None and mod.linear_g.weight.grad is not None
