"""plslam_torch.geometry.sim3 against the JAX package's ``geometry/sim3.py``.

Random tangents xi = [omega, upsilon, sigma] from a seeded numpy generator,
with rows where theta < 1e-4, where |sigma| < 1e-4, both, and exact zeros,
so every branch of ``_w_coeffs`` is taken. ``exp``, ``log``, ``compose``,
``inverse`` and ``apply`` agree to 1e-5 (absolute, float32); the port's
batched call equals its per-transform calls.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.geometry import sim3 as jsim3
from plslam_torch.geometry import sim3
from torch_parity import few_torch_threads  # noqa: F401

TOL = 1e-5


def _xis(n=48):
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (n, 7)).astype(np.float32)
    xi[:8, :3] *= 1e-5           # theta < 1e-4
    xi[4:12, 6] *= 1e-5          # |sigma| < 1e-4 (rows 4-7: both small)
    xi[12:14, :3] = 0.0          # exact identity rotation
    xi[14:16, 6] = 0.0           # exact unit scale
    return xi


def _j(xi):
    return jsim3.exp(jnp.asarray(xi))


def test_exp_and_log_equal_jax():
    xis = _xis()
    S, R, t = sim3.exp(torch.from_numpy(xis))
    L = sim3.log(S, R, t)
    for i, xi in enumerate(xis):
        js, jR, jt = _j(xi)
        assert abs(float(S[i]) - float(js)) < TOL
        np.testing.assert_allclose(R[i].numpy(), np.asarray(jR), atol=TOL)
        np.testing.assert_allclose(t[i].numpy(), np.asarray(jt), atol=TOL)
        np.testing.assert_allclose(L[i].numpy(), np.asarray(jsim3.log(js, jR, jt)), atol=TOL)
        # the round trip recovers the tangent
        np.testing.assert_allclose(L[i].numpy(), xi, atol=TOL)


def test_batched_equals_single():
    xis = torch.from_numpy(_xis())
    S, R, t = sim3.exp(xis)
    L = sim3.log(S, R, t)
    for i in range(len(xis)):
        s1, R1, t1 = sim3.exp(xis[i])
        assert float(s1) == pytest.approx(float(S[i]), abs=1e-7)
        np.testing.assert_allclose(R1.numpy(), R[i].numpy(), atol=1e-7)
        np.testing.assert_allclose(t1.numpy(), t[i].numpy(), atol=1e-6)
        np.testing.assert_allclose(sim3.log(s1, R1, t1).numpy(), L[i].numpy(), atol=1e-6)


def test_compose_inverse_apply_equal_jax():
    xis = _xis()
    rng = np.random.default_rng(1)
    p = rng.normal(0, 2.0, (5, 3)).astype(np.float32)
    S, R, t = sim3.exp(torch.from_numpy(xis))
    for i in range(0, len(xis) - 1, 2):
        a = _j(xis[i])
        b = _j(xis[i + 1])
        jc = jsim3.compose(*a, *b)
        jinv = jsim3.inverse(*a)
        tc = sim3.compose(S[i], R[i], t[i], S[i + 1], R[i + 1], t[i + 1])
        tinv = sim3.inverse(S[i], R[i], t[i])
        for got, want in zip(tc + tinv, jc + jinv):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(
            sim3.apply(S[i], R[i], t[i], torch.from_numpy(p)).numpy(),
            np.asarray(jsim3.apply(*a, jnp.asarray(p))), atol=1e-4 * max(1.0, float(S[i])))
    # the batched forms: a ∘ a^-1 is the identity for every row
    Si, Ri, ti = sim3.inverse(S, R, t)
    s1, R1, t1 = sim3.compose(S, R, t, Si, Ri, ti)
    np.testing.assert_allclose(s1.numpy(), 1.0, atol=TOL)
    np.testing.assert_allclose(R1.numpy(), np.broadcast_to(np.eye(3), R1.shape), atol=TOL)
    np.testing.assert_allclose(t1.numpy(), 0.0, atol=1e-4)


def test_identity():
    s, R, t = sim3.identity(device="cpu")
    js, jR, jt = jsim3.identity()
    assert float(s) == float(js)
    np.testing.assert_array_equal(R.numpy(), np.asarray(jR))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(sim3.log(s, R, t).numpy(), 0.0, atol=1e-6)


def test_jacobian_through_every_branch_is_finite():
    """``torch.func.jacfwd`` through exp and log at theta = 0 and sigma = 0
    (the pose graph's Jacobians are taken at xi = 0, batched over edges)
    stays finite."""
    zero = torch.zeros(4, 7)

    def f(x):
        return sim3.log(*sim3.exp(x))

    J = torch.func.jacfwd(f)(zero)  # (4, 7, 4, 7)
    assert torch.isfinite(J).all()
    for i in range(4):
        np.testing.assert_allclose(J[i, :, i].numpy(), np.eye(7), atol=1e-4)
