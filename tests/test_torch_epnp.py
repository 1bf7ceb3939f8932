"""plslam_torch EPnP and EPnP RANSAC against the JAX package's
``optim/epnp.py`` (the scenes of tests/test_epnp.py).

- Exact correspondences: both packages recover the pose to 1e-4 and agree
  with each other to 1e-4.
- ``ransac_epnp`` given the index sets the JAX package draws from its key:
  the same best hypothesis, inlier counts within 1, poses within 1e-3 where
  the inliers are exact (33% gross outliers), and within 1e-2 m / 5e-3 rad
  under 0.5 px pixel noise. The gap under noise is the control points': the
  signs of the principal axes (eigenvectors) are free, LAPACK returns
  different ones in the two packages, and the N=1 EPnP answer of noisy data
  depends on them; given the JAX package's control points the port's
  solve agrees to 1e-4.
- From the port's own ``torch.Generator``: the pose and the outliers found.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.optim import epnp as jepnp
from plslam_torch.geometry.projection import Camera
from plslam_torch.optim import epnp
from test_epnp import _project, _scene
from torch_parity import few_torch_threads  # noqa: F401

KW = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)
JCAM, CAM = JCamera(**KW), Camera(**KW)


def _rot_err(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)))


def _jax_sets(key, valid, n_hyp=256):
    """The (n_hyp, 6) row indices ``ransac_epnp`` draws from ``key``."""
    p = jnp.where(jnp.asarray(valid), 1.0, 0.0)
    p = p / (p.sum() + 1e-9)
    keys = jax.random.split(key, n_hyp)
    m = len(valid)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, m, (epnp.MIN_SET,), replace=False, p=p))(keys))


def _data(kind):
    if kind == "exact":
        pw, R, t = _scene(0)
        uv = _project(R, t, pw).astype(np.float32)
        bad = np.zeros(len(pw), bool)
    else:
        pw, R, t = _scene(1, n=120)
        uv = _project(R, t, pw).astype(np.float32)
        rng = np.random.default_rng(7)
        if kind == "noisy":
            uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
        idx = rng.choice(len(pw), 40, replace=False)
        uv[idx] += (rng.uniform(30, 200, (40, 2)) * rng.choice([-1, 1], (40, 2))).astype(np.float32)
        bad = np.zeros(len(pw), bool)
        bad[idx] = True
    valid = np.ones(len(pw), bool)
    valid[:4] = False
    return pw, uv.astype(np.float32), valid, R, t, bad


def _both(pw, uv, valid, key):
    jR, jt, jinl, jn = jepnp.ransac_epnp(JCAM, jnp.asarray(pw), jnp.asarray(uv),
                                         jnp.asarray(valid), key)
    sets = _jax_sets(key, valid)
    R, t, inl, n = epnp.ransac_epnp(CAM, torch.from_numpy(pw), torch.from_numpy(uv),
                                    torch.from_numpy(valid), samples=torch.from_numpy(sets))
    return (np.asarray(jR), np.asarray(jt), np.asarray(jinl), int(jn),
            R.numpy(), t.numpy(), inl.numpy(), int(n), sets)


def test_exact_data():
    pw, uv, valid, R, t, _ = _data("exact")
    jR, jt, jinl, jn, Rt, tt, inl, n, _ = _both(pw, uv, valid, jax.random.PRNGKey(0))
    assert n == jn == valid.sum()
    for Re, te in ((jR, jt), (Rt, tt)):
        assert np.abs(Re - R).max() < 1e-4 and np.abs(te - t).max() < 1e-4
    assert np.abs(Rt - jR).max() < 1e-4 and np.abs(tt - jt).max() < 1e-4
    # the solver alone on every point
    R1, t1 = epnp._solve(CAM, torch.from_numpy(pw), torch.from_numpy(uv),
                         torch.from_numpy(valid.astype(np.float32)))
    assert np.abs(R1.numpy() - R).max() < 1e-4 and np.abs(t1.numpy() - t).max() < 1e-4


def _hypothesis_scores(pw, uv, valid, sets):
    """Inlier count of every hypothesis, in each package."""
    jpw, juv = jnp.asarray(pw), jnp.asarray(uv)
    Rs, ts = jax.vmap(lambda i: jepnp._solve_single(JCAM, jpw[i], juv[i], jnp.ones(6)))(
        jnp.asarray(sets))
    chi = jax.vmap(lambda R, t: jepnp._chi2(JCAM, R, t, jpw, juv))(Rs, ts)
    js = np.asarray(((chi <= 5.991) & valid[None]).sum(-1))
    idx = torch.from_numpy(sets).long()
    Rs, ts = epnp._solve(CAM, torch.from_numpy(pw)[idx], torch.from_numpy(uv)[idx],
                         torch.ones(idx.shape))
    chi = epnp._chi2(CAM, Rs, ts, torch.from_numpy(pw), torch.from_numpy(uv))
    return js, ((chi <= 5.991) & torch.from_numpy(valid)).sum(-1).numpy()


@pytest.mark.parametrize("kind,tol_t,tol_r", [("outliers", 1e-3, 1e-3), ("noisy", 1e-2, 5e-3)])
def test_ransac_with_jax_sets(kind, tol_t, tol_r):
    pw, uv, valid, R, t, bad = _data(kind)
    key = jax.random.PRNGKey(1)
    jR, jt, jinl, jn, Rt, tt, inl, n, sets = _both(pw, uv, valid, key)
    js, ts = _hypothesis_scores(pw, uv, valid, sets)
    assert ts.argmax() == js.argmax()
    assert abs(int(ts.max()) - int(js.max())) <= 1
    assert abs(n - jn) <= 1 and n >= 70
    assert np.abs(tt - jt).max() < tol_t and _rot_err(Rt, jR) < tol_r
    assert inl[bad].sum() <= 2
    assert np.abs(tt - t).max() < 2e-2


def test_noisy_refit_with_jax_control_points(monkeypatch):
    """The refit of the noisy scene from JAX's control points equals JAX's."""
    pw, uv, valid, *_ = _data("noisy")
    w = valid.astype(np.float32)
    jcw = np.asarray(jepnp._control_points(jnp.asarray(pw), jnp.asarray(w)))
    jR, jt = jepnp._solve_single(JCAM, jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(w))
    monkeypatch.setattr(epnp, "_control_points", lambda p, ww: torch.from_numpy(jcw))
    R, t = epnp._solve(CAM, torch.from_numpy(pw), torch.from_numpy(uv), torch.from_numpy(w))
    assert np.abs(R.numpy() - np.asarray(jR)).max() < 1e-4
    assert np.abs(t.numpy() - np.asarray(jt)).max() < 1e-4


def test_ransac_from_generator():
    pw, uv, valid, R, t, bad = _data("outliers")
    g = torch.Generator().manual_seed(3)
    Re, te, inl, n = epnp.ransac_epnp(CAM, torch.from_numpy(pw), torch.from_numpy(uv),
                                      torch.from_numpy(valid), generator=g)
    inl = inl.numpy()
    assert int(n) >= 0.95 * (valid & ~bad).sum()
    assert inl[bad].sum() <= 2 and not inl[~valid].any()
    assert np.abs(Re.numpy() - R).max() < 1e-3 and np.abs(te.numpy() - t).max() < 1e-3
    # every drawn set holds distinct valid rows
    sets = epnp.draw_sets(torch.from_numpy(valid), 256, torch.Generator().manual_seed(4)).numpy()
    assert all(len(set(s)) == epnp.MIN_SET for s in sets) and valid[sets].all()
