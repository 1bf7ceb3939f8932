"""SO(3) / SE(3) Lie-group primitives on torch tensors.

Poses are ``(R, t)`` tuples with ``R: (3,3)`` and ``t: (3,)`` in
world-to-camera convention ``x_cam = R @ x_world + t`` (the reference's
``Tcw``, ``Frame.cc`` SetPose / UpdatePoseMatrices).

The se(3) tangent is ordered ``[omega, upsilon]`` (rotation first) to match
the g2o ``SE3Quat::exp`` convention of the reference optimizer, so the
chi²/step-size behaviour of the LM loops is directly comparable. Every
function is written with ``torch.where`` (no data-dependent python
branches), so ``torch.func.jacfwd`` differentiates through it. Every
function also takes a leading batch of poses (``R: (..., 3, 3)``, ``t`` and
``w: (..., 3)``, ``xi: (..., 6)``); a single pose goes through the same
operations as before the batch form existed, so its results are unchanged.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x such that hat(w) @ v = w × v."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def _sqnorm(w: torch.Tensor) -> torch.Tensor:
    return torch.dot(w, w) if w.dim() == 1 else (w * w).sum(-1)


def _per_matrix(c: torch.Tensor) -> torch.Tensor:
    """A per-pose coefficient shaped to scale a (..., 3, 3) batch."""
    return c if c.dim() == 0 else c[..., None, None]


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x for one matrix and vector, or for a batch of them."""
    return A @ x if x.dim() == 1 else (A @ x.unsqueeze(-1)).squeeze(-1)


def _coeffs(theta2: torch.Tensor):
    """Taylor-stable sin(t)/t, (1-cos t)/t^2 and (1-a)/t^2."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (1.0 - a) / theta2, 1.0 / 6.0 - theta2 / 120.0)
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: exp of so(3) vector -> rotation matrix. Safe at w=0."""
    a, b, _ = (_per_matrix(x) for x in _coeffs(_sqnorm(w)))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * (W @ W)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """exp of se(3) vector [omega, upsilon] -> (R, t) with t = V @ upsilon."""
    w, u = xi[..., :3], xi[..., 3:]
    a, b, c = (_per_matrix(x) for x in _coeffs(_sqnorm(w)))
    W = hat(w)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * W + b * WW
    V = eye + b * W + c * WW
    return R, _mv(V, u)


def compose(Ra, ta, Rb, tb):
    """(Ra,ta) ∘ (Rb,tb): first apply b, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def inverse(R, t):
    Rt = R.mT
    return Rt, -_mv(Rt, t)


def apply(R, t, p):
    """Transform points p (..., 3) by one pose."""
    return p @ R.mT + t


def left_update(xi, R, t):
    """g2o-style multiplicative update: exp(xi) ∘ (R, t)."""
    dR, dt = se3_exp(xi)
    return compose(dR, dt, R, t)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) (two Newton steps of the
    polar decomposition). Float32 chains of hundreds of rotation products
    per frame otherwise contract det(R) exponentially."""
    for _ in range(2):
        R = 0.5 * (3.0 * R - R @ (R.mT @ R))
    return R
