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
``w: (..., 3)``, ``xi: (..., 6)``). Products of 3x3 matrices and 3-vectors
are three elementwise products summed in a fixed order (``_mm``, ``_mv``,
``rotate``, and ``_sqnorm`` for a squared norm):
a pose alone and the same pose inside a batch get the same bits, where a
library product (MKL's on the CPU, cuBLAS's on the card) takes another path
for a batch and rounds otherwise.
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
    """|w|^2 of 3-vectors, in a fixed order (not a library dot product)."""
    return torch.addcmul(torch.addcmul(w[..., 0] * w[..., 0], w[..., 1], w[..., 1]),
                         w[..., 2], w[..., 2])


def _per_matrix(c: torch.Tensor) -> torch.Tensor:
    """A per-pose coefficient shaped to scale a (..., 3, 3) batch."""
    return c if c.dim() == 0 else c[..., None, None]


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for 3x3 matrices, or batches of them, in a fixed order."""
    return ((A[..., :, 0:1] * B[..., 0:1, :] + A[..., :, 1:2] * B[..., 1:2, :])
            + A[..., :, 2:3] * B[..., 2:3, :])


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x for a 3x3 matrix and a 3-vector, or batches of them, in a fixed
    order."""
    return ((A[..., :, 0] * x[..., None, 0] + A[..., :, 1] * x[..., None, 1])
            + A[..., :, 2] * x[..., None, 2])


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
    return eye + a * W + b * _mm(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of a rotation matrix -> so(3) vector, stable near 0 and pi.
    Near 0 (|sin| < 1e-5) the antisymmetric part itself; near pi (cos <
    -0.99) the axis from the column of (R + I) / 2 with the largest diagonal,
    signed by the antisymmetric part."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    theta = torch.arccos(cos_t)
    w_raw = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                               R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = torch.sin(theta)
    small = sin_t.abs() < 1e-5
    one = torch.ones_like(theta)
    scale = torch.where(small, one, theta / torch.where(small, one, sin_t))
    w_generic = scale[..., None] * w_raw
    B = (R + eye) * 0.5
    diag = torch.diagonal(B, dim1=-2, dim2=-1).clamp(min=0.0)
    k = torch.argmax(diag, -1, keepdim=True)                       # first maximum
    row = torch.take_along_dim(B, k[..., None].expand(*k.shape, 3), -2)[..., 0, :]
    axis = row / torch.sqrt(torch.take_along_dim(diag, k, -1) + _EPS)
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + _EPS)
    sign = torch.where((axis * w_raw).sum(-1) < 0.0, -one, one)
    w_pi = (theta * sign)[..., None] * axis
    return torch.where((cos_t < -0.99)[..., None], w_pi, w_generic)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Log map of (R, t) -> [omega, upsilon]."""
    w = so3_log(R)
    theta2 = _sqnorm(w)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    half = 0.5 * theta
    # V^-1 = I - W/2 + (1/theta^2)(1 - theta cos(theta/2) / (2 sin(theta/2))) W^2
    cot = torch.where(theta2 > _EPS,
                      (1.0 - half * torch.cos(half) / (torch.sin(half) + _EPS)) / (theta2 + _EPS),
                      torch.full_like(theta2, 1.0 / 12.0))
    W = hat(w)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Vinv = eye - 0.5 * W + _per_matrix(cot) * _mm(W, W)
    return torch.cat([w, _mv(Vinv, t)], -1)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """exp of se(3) vector [omega, upsilon] -> (R, t) with t = V @ upsilon."""
    w, u = xi[..., :3], xi[..., 3:]
    a, b, c = (_per_matrix(x) for x in _coeffs(_sqnorm(w)))
    W = hat(w)
    WW = _mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * W + b * WW
    V = eye + b * W + c * WW
    return R, _mv(V, u)


def compose(Ra, ta, Rb, tb):
    """(Ra,ta) ∘ (Rb,tb): first apply b, then a."""
    return _mm(Ra, Rb), _mv(Ra, tb) + ta


def inverse(R, t):
    Rt = R.mT
    return Rt, -_mv(Rt, t)


def rotate(R, p):
    """``p @ R.mT``: rows p (..., N, 3) multiplied by R (..., 3, 3), one
    matrix or one per batch entry, as three fused multiply-adds in a fixed
    order (a library product picks its kernel by shape and batch, and
    rounds otherwise for a batch than for one matrix)."""
    Rt = R.mT[..., None, :, :]
    out = p[..., 0:1] * Rt[..., 0, :]
    out = torch.addcmul(out, p[..., 1:2], Rt[..., 1, :])
    return torch.addcmul(out, p[..., 2:3], Rt[..., 2, :])


def apply(R, t, p):
    """Transform points p (..., N, 3) by one pose, or each batch entry of
    points by its own pose (R (..., 3, 3), t (..., 3))."""
    return rotate(R, p) + t[..., None, :]


def left_update(xi, R, t):
    """g2o-style multiplicative update: exp(xi) ∘ (R, t)."""
    dR, dt = se3_exp(xi)
    return compose(dR, dt, R, t)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) (two Newton steps of the
    polar decomposition). Float32 chains of hundreds of rotation products
    per frame otherwise contract det(R) exponentially."""
    for _ in range(2):
        R = 0.5 * (3.0 * R - _mm(R, _mm(R.mT, R)))
    return R


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w) — the TUM trajectory format's order, used by the
# reference's savers (System.cc:337-487).
# ---------------------------------------------------------------------------


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64: the CPU
    build's vectorised float32 sqrt is off by one ulp on ~0.6% of inputs)."""
    return torch.sqrt(x.double()).float()


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) as (x, y, z,
    w), branch-free: the four candidate constructions, the one of the
    largest score (the first on a tie, as the JAX package's argmax), then
    normalised. The JAX package's float32 arithmetic element for element:
    correctly rounded square roots, and the norm's sum of squares as its
    compiled CPU reduction does it, a chain of fused multiply-adds (each
    emulated exactly in float64)."""
    R = R.float()
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw_t = _sqrt32((1.0 + tr).clamp(min=_EPS)) * 0.5
    q0 = torch.stack([(m21 - m12) / (4 * qw_t), (m02 - m20) / (4 * qw_t),
                      (m10 - m01) / (4 * qw_t), qw_t], -1)
    qx_t = _sqrt32((1.0 + m00 - m11 - m22).clamp(min=_EPS)) * 0.5
    q1 = torch.stack([qx_t, (m01 + m10) / (4 * qx_t), (m02 + m20) / (4 * qx_t),
                      (m21 - m12) / (4 * qx_t)], -1)
    qy_t = _sqrt32((1.0 - m00 + m11 - m22).clamp(min=_EPS)) * 0.5
    q2 = torch.stack([(m01 + m10) / (4 * qy_t), qy_t, (m12 + m21) / (4 * qy_t),
                      (m02 - m20) / (4 * qy_t)], -1)
    qz_t = _sqrt32((1.0 - m00 - m11 + m22).clamp(min=_EPS)) * 0.5
    q3 = torch.stack([(m02 + m20) / (4 * qz_t), (m12 + m21) / (4 * qz_t), qz_t,
                      (m10 - m01) / (4 * qz_t)], -1)
    cands = torch.stack([q0, q1, q2, q3], -2)
    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    # torch.argmax returns the first maximal index
    pick = torch.argmax(scores, -1)
    q = torch.take_along_dim(cands, pick[..., None, None], -2)[..., 0, :]
    q64 = q.double()
    acc = q[..., 0] * q[..., 0]
    for i in (1, 2, 3):
        acc = (q64[..., i] * q64[..., i] + acc.double()).float()
    return q / _sqrt32(acc)[..., None]


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) as (x, y, z, w) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.where(n > 0, n, torch.ones_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], -2)
