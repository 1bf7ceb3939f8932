"""Sim(3) similarity transforms for loop closing.

Represented as ``(s, R, t)`` with action ``x -> s * R @ x + t``, the Sim3
semantics of the reference's loop correction (LoopClosing.cc:420-617 and
its g2o Sim3 type). The tangent is ordered ``[omega, upsilon, sigma]``
(rotation first, 7-vector), as in the JAX package's ``geometry/sim3.py``.

Every function takes a leading batch (``s: (...)``, ``R: (..., 3, 3)``,
``t: (..., 3)``, ``xi: (..., 7)``). The small-angle (theta < 1e-4) and
small-log-scale (|sigma| < 1e-4) series are selected with ``torch.where``
on safe denominators, so ``torch.func`` transforms differentiate through
every branch without a NaN.
"""

from __future__ import annotations

import torch

from . import se3

_EPS = 1e-7


def identity(dtype=torch.float32, device="cuda"):
    return (torch.ones((), dtype=dtype, device=device), torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def _ps(s: torch.Tensor) -> torch.Tensor:
    """A per-transform scale shaped to scale a (..., 3) vector."""
    return s[..., None] if isinstance(s, torch.Tensor) and s.dim() else s


def apply(s, R, t, p):
    """Transform points p (..., 3) by one similarity."""
    return s * (p @ R.mT) + t


def compose(sa, Ra, ta, sb, Rb, tb):
    """a ∘ b: first apply b, then a."""
    return sa * sb, Ra @ Rb, _ps(sa) * se3._mv(Ra, tb) + ta


def inverse(s, R, t):
    Rt = R.mT
    s_inv = 1.0 / s
    return s_inv, Rt, -_ps(s_inv) * se3._mv(Rt, t)


def _w_coeffs(theta, sigma, s):
    """Coefficients (C, A, B) of W = C I + A [w]x + B [w]x^2, where
    t = W @ upsilon (the translation block of the sim(3) left Jacobian)."""
    theta2 = theta * theta
    sigma2 = sigma * sigma
    small_t = theta < 1e-4
    small_s = sigma.abs() < 1e-4
    one = torch.ones_like(theta)
    safe_t = torch.where(small_t, one, theta)
    safe_t2 = torch.where(small_t, one, theta2)
    safe_s = torch.where(small_s, one, sigma)
    safe_s2 = torch.where(small_s, one, sigma2)

    # sigma ~ 0
    C_s0 = 1.0 + sigma / 2.0 + sigma2 / 6.0
    A_s0 = torch.where(small_t, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    B_s0 = torch.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - torch.sin(theta)) / (safe_t2 * safe_t))

    # generic sigma
    C_g = (s - 1.0) / safe_s
    A_g_t0 = ((sigma - 1.0) * s + 1.0) / safe_s2
    B_g_t0 = (s * (sigma2 - 2.0 * sigma + 2.0) - 2.0) / (2.0 * safe_s2 * safe_s)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + sigma2
    safe_c = torch.where(c < _EPS, one, c)
    A_g = (a * sigma + (1.0 - b) * theta) / (safe_t * safe_c)
    B_g = (C_g - ((b - 1.0) * sigma + a * theta) / safe_c) / safe_t2

    C = torch.where(small_s, C_s0, C_g)
    A = torch.where(small_s, A_s0, torch.where(small_t, A_g_t0, A_g))
    B = torch.where(small_s, B_s0, torch.where(small_t, B_g_t0, B_g))
    return C, A, B


def _w_matrix(w, sigma, s):
    theta = torch.sqrt(se3._sqnorm(w) + _EPS * _EPS)
    C, A, B = (se3._per_matrix(x) for x in _w_coeffs(theta, sigma, s))
    W = se3.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return C * eye + A * W + B * (W @ W)


def exp(xi: torch.Tensor):
    """exp of a sim(3) vector [omega, upsilon, sigma] -> (s, R, t)."""
    w, u, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    return s, se3.so3_exp(w), se3._mv(_w_matrix(w, sigma, s), u)


def log(s, R, t) -> torch.Tensor:
    """Log map of (s, R, t) -> [omega, upsilon, sigma]."""
    sigma = torch.log(s)
    w = se3.so3_log(R)
    Wm = _w_matrix(w, sigma, s)
    u = torch.linalg.solve_ex(Wm, t[..., None])[0][..., 0]
    return torch.cat([w, u, sigma[..., None]], -1)
