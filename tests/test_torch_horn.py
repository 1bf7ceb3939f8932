"""plslam_torch closed-form alignment and Horn RANSAC against the JAX
package's ``optim/horn.py``.

- ``kabsch`` (rigid and with scale, weighted, and a batch of problems in
  one call) to 1e-5.
- ``ransac_align`` on a scene with 30% gross outliers, given the index
  samples the JAX package draws from its key: equal inlier masks, pose to
  1e-5; and from the port's own ``torch.Generator`` the same inliers.
- ``refine_sim3`` (7-parameter LM, Jacobian by ``torch.func.jacfwd``) from
  a perturbed start, with and without scale: pose and scale to 1e-4,
  equal inlier masks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.optim import horn as jhorn
from plslam_torch.geometry.projection import Camera
from plslam_torch.optim import horn
from torch_parity import few_torch_threads  # noqa: F401

KW = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)


def _rot(rng, scale=0.3):
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _scene(seed, n=200, outliers=0.3, noise=0.003):
    rng = np.random.default_rng(seed)
    src = rng.uniform([-2, -1.5, 1], [2, 1.5, 5], (n, 3)).astype(np.float32)
    R, t = _rot(rng), rng.normal(size=3).astype(np.float32)
    dst = (src @ R.T + t + rng.normal(0, noise, src.shape)).astype(np.float32)
    bad = rng.random(n) < outliers
    dst[bad] += rng.normal(0, 1.0, (bad.sum(), 3)).astype(np.float32)
    valid = rng.random(n) < 0.9
    return src, dst, valid, R, t, bad


@pytest.mark.parametrize("with_scale", [False, True])
def test_kabsch_equals_jax(with_scale):
    src, dst, valid, R, t, bad = _scene(0, outliers=0.0)
    w = np.random.default_rng(1).uniform(0.2, 1.0, len(src)).astype(np.float32) * valid
    for wt in (None, w):
        js, jR, jt = jhorn.kabsch(jnp.asarray(src), jnp.asarray(dst),
                                  None if wt is None else jnp.asarray(wt), with_scale)
        s, Rt, tt = horn.kabsch(torch.from_numpy(src), torch.from_numpy(dst),
                                None if wt is None else torch.from_numpy(wt), with_scale)
        assert abs(float(s) - float(js)) < 1e-5
        np.testing.assert_allclose(Rt.numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-2)
    # a batch of minimal 3-point problems in one call equals each alone
    idx = np.random.default_rng(2).integers(0, len(src), (16, 3))
    sb, Rb, tb = horn.kabsch(torch.from_numpy(src[idx]), torch.from_numpy(dst[idx]),
                             with_scale=with_scale)
    for h in range(16):
        js, jR, jt = jhorn.kabsch(jnp.asarray(src[idx[h]]), jnp.asarray(dst[idx[h]]),
                                  with_scale=with_scale)
        np.testing.assert_allclose(Rb[h].numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(tb[h].numpy(), np.asarray(jt), atol=1e-5)
        assert abs(float(sb[h]) - float(js)) < 1e-5


def _jax_samples(key, valid, n_hyp=256):
    """The (n_hyp, 3) positions ``ransac_align`` draws from ``key``."""
    pool = max(int(valid.sum()), 3)
    return np.asarray(jax.random.randint(key, (n_hyp, 3), 0, pool))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_align_with_jax_samples(seed):
    src, dst, valid, R, t, bad = _scene(seed)
    key = jax.random.PRNGKey(seed)
    js, jR, jt, jinl, jn = jhorn.ransac_align(jnp.asarray(src), jnp.asarray(dst),
                                              jnp.asarray(valid), key)
    s, Rt, tt, inl, n = horn.ransac_align(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
        samples=torch.from_numpy(_jax_samples(key, valid).copy()))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert int(n) == int(jn) > 0.5 * valid.sum()
    np.testing.assert_allclose(Rt.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    assert float(s) == 1.0
    assert not inl.numpy()[bad].any()
    # the port's own draws reach the same consensus
    g = torch.Generator().manual_seed(seed)
    _, Rg, tg, inl_g, _ = horn.ransac_align(torch.from_numpy(src), torch.from_numpy(dst),
                                            torch.from_numpy(valid), generator=g)
    assert (inl_g.numpy() == np.asarray(jinl)).mean() > 0.98
    np.testing.assert_allclose(tg.numpy(), np.asarray(jt), atol=1e-3)


def test_ransac_align_with_scale_and_few_valid():
    src, dst, valid, R, t, bad = _scene(4, n=60, outliers=0.2)
    dst = (1.3 * dst).astype(np.float32)
    valid[:] = False
    valid[[3, 8, 20, 33]] = True  # fewer valid rows than the RANSAC pool's floor
    for v in (np.ones_like(valid), valid):
        key = jax.random.PRNGKey(7)
        js, jR, jt, jinl, jn = jhorn.ransac_align(jnp.asarray(src), jnp.asarray(dst),
                                                  jnp.asarray(v), key, with_scale=True)
        s, Rt, tt, inl, n = horn.ransac_align(
            torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(v),
            with_scale=True, samples=torch.from_numpy(_jax_samples(key, v).copy()))
        np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
        assert abs(float(s) - float(js)) < 1e-5
        np.testing.assert_allclose(Rt.numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def _project(p):
    return np.stack([KW["fx"] * p[:, 0] / p[:, 2] + KW["cx"],
                     KW["fy"] * p[:, 1] / p[:, 2] + KW["cy"]], -1).astype(np.float32)


@pytest.mark.parametrize("with_scale", [True, False])
def test_refine_sim3_equals_jax(with_scale):
    rng = np.random.default_rng(5)
    x2 = rng.uniform([-1.5, -1, 2], [1.5, 1, 5], (80, 3)).astype(np.float32)
    R, t, s = _rot(rng, 0.1), rng.normal(size=3).astype(np.float32) * 0.2, 1.15
    x1 = (s * x2 @ R.T + t).astype(np.float32)
    uv1 = _project(x1) + rng.normal(0, 0.7, (80, 2)).astype(np.float32)
    uv2 = _project(x2) + rng.normal(0, 0.7, (80, 2)).astype(np.float32)
    uv1[:10] += 40.0  # wrong matches
    valid = np.ones(80, bool)
    valid[-5:] = False
    R0 = (_rot(np.random.default_rng(9), 0.01) @ R).astype(np.float32)
    t0 = (t + 0.03).astype(np.float32)
    s0 = 1.1 if with_scale else 1.15
    jout = jhorn.refine_sim3(JCamera(**KW), jnp.float32(s0), jnp.asarray(R0), jnp.asarray(t0),
                             jnp.asarray(x1), jnp.asarray(uv1), jnp.asarray(x2),
                             jnp.asarray(uv2), jnp.asarray(valid), with_scale=with_scale)
    tout = horn.refine_sim3(Camera(**KW), torch.tensor(s0), torch.from_numpy(R0),
                            torch.from_numpy(t0), torch.from_numpy(x1), torch.from_numpy(uv1),
                            torch.from_numpy(x2), torch.from_numpy(uv2),
                            torch.from_numpy(valid), with_scale=with_scale)
    assert abs(float(tout[0]) - float(jout[0])) < 1e-4
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-4)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), atol=1e-4)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert int(tout[4]) == int(jout[4]) >= 60
    assert not tout[3].numpy()[:10].any()
    assert np.abs(tout[1].numpy() - R).max() < 5e-3
