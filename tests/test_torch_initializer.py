"""plslam_torch.ops.initializer against the JAX package's ops/initializer.py.

Scenes of tests/test_initializer.py (a general scene, where F wins, and a
planar one, where H wins) and a pure rotation, whose reconstruction must
not be clear in either package. The hypothesis sets are the JAX package's
own ``jax.random.choice`` draws, rebuilt here from the same key and
injected (``samples=``), so both packages score the same minimal sets.

Tolerances: scores within 1e-3 relative and inlier masks equal; H and F,
normalised to unit Frobenius norm and a positive largest-magnitude entry,
within 1e-4 (F only where eight points determine it: the general scene);
the reconstructed R and t within 1e-4, ``good`` and ``clear`` equal,
points within 1e-3 relative. Port-only: the generator's draws are
distinct valid rows, and with them the port picks the right model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.ops import initializer as jinit
from plslam_torch.ops import initializer as tinit
from test_initializer import K, _pad, _proj, _rot


@jax.jit
def jax_draws(valid, key):
    """The index sets JAX's find_models draws with ``key`` (its p and
    per-hypothesis keys, the same expressions under jit)."""
    M = valid.shape[0]
    p = valid.astype(jnp.float32)
    p = p / (p.sum() + 1e-9)
    keys = jax.random.split(key, tinit.N_HYP)
    h = jax.vmap(lambda k: jax.random.choice(k, M, (4,), replace=False, p=p))(keys)
    f = jax.vmap(lambda k: jax.random.choice(k, M, (8,), replace=False, p=p))(keys)
    return h, f


def injected(valid, seed):
    h, f = jax_draws(jnp.asarray(valid), jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(h)), torch.from_numpy(np.array(f))


def _scene(kind):
    if kind == "general":
        rng = np.random.default_rng(0)
        pw = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (200, 3)).astype(np.float32)
        R = _rot(np.array([0.02, -0.03, 0.01]))
        t = np.array([0.3, 0.02, 0.01], np.float32)
        seed = 0
    elif kind == "planar":
        rng = np.random.default_rng(1)
        xy = rng.uniform([-2, -1.5], [2, 1.5], (200, 2)).astype(np.float32)
        z = 5.0 + 0.2 * xy[:, 0] + 0.1 * xy[:, 1]
        pw = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
        R = _rot(np.array([0.0, -0.05, 0.01]))
        t = np.array([0.4, 0.0, 0.05], np.float32)
        seed = 1
    else:  # pure rotation: no baseline, nothing to triangulate
        rng = np.random.default_rng(2)
        pw = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (200, 3)).astype(np.float32)
        R = _rot(np.array([0.01, 0.04, -0.02]))
        t = np.zeros(3, np.float32)
        seed = 2
    uv1 = _proj(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), pw)
    uv2 = _proj(R, t, pw)
    u1, valid = _pad(uv1)
    u2, _ = _pad(uv2)
    return u1, u2, valid, seed, R, t


def _canon(M):
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


@pytest.fixture(scope="module", params=["general", "planar", "rotation"])
def both(request):
    """Each package's find_models on one scene, with JAX's draws."""
    u1, u2, valid, seed, R, t = _scene(request.param)
    jout = [np.array(x) for x in jinit.find_models(
        jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(valid), jax.random.PRNGKey(seed))]
    tout = [x.numpy() for x in tinit.find_models(
        torch.from_numpy(u1), torch.from_numpy(u2), torch.from_numpy(valid),
        samples=injected(valid, seed))]
    return request.param, (u1, u2, valid, R, t), jout, tout


def test_find_models_matches_jax(both):
    kind, _, (jH, jsh, jF, jsf, jokh, jokf), (tH, tsh, tF, tsf, tokh, tokf) = both
    np.testing.assert_allclose(tsh, jsh, rtol=1e-3)
    np.testing.assert_allclose(tsf, jsf, rtol=1e-3)
    np.testing.assert_array_equal(tokh, jokh)
    np.testing.assert_array_equal(tokf, jokf)
    np.testing.assert_allclose(_canon(tH), _canon(jH), atol=1e-4)
    if kind == "general":
        # eight points on a plane, or seen from one centre, leave a null
        # space of more than one dimension: F is then any vector of it
        np.testing.assert_allclose(_canon(tF), _canon(jF), atol=1e-4)
    ratio = tsh / (tsh + tsf)
    if kind == "general":
        assert ratio <= 0.40  # F preferred
    elif kind == "planar":
        assert ratio > 0.40   # H preferred


@pytest.mark.parametrize("model", ["h", "f"])
def test_reconstruct_matches_jax(both, model):
    """The winner (R, t, points, good, clear), never the candidate index:
    LAPACK's SVD signs may order the motions differently."""
    kind, (u1, u2, _, R_gt, t_gt), jout, tout = both
    jM, jok = (jout[0], jout[4]) if model == "h" else (jout[2], jout[5])
    jfn = jinit.reconstruct_h if model == "h" else jinit.reconstruct_f
    tfn = tinit.reconstruct_h if model == "h" else tinit.reconstruct_f
    # both packages reconstruct from the same model and inliers (JAX's)
    jR, jt, jpw, jgood, jclear = (np.asarray(x) for x in jfn(
        jnp.asarray(jM), jnp.asarray(K), jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(jok)))
    tR, tt, tpw, tgood, tclear = (x.numpy() for x in tfn(
        torch.from_numpy(jM), torch.from_numpy(K), torch.from_numpy(u1), torch.from_numpy(u2),
        torch.from_numpy(jok)))
    assert bool(tclear) == bool(jclear)
    if kind == "rotation":
        assert not bool(tclear)
        return
    np.testing.assert_array_equal(tgood, jgood)
    np.testing.assert_allclose(tR, jR, atol=1e-4)
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    g = jgood
    np.testing.assert_allclose(tpw[g], jpw[g], rtol=1e-3, atol=1e-6)
    if (kind, model) in (("general", "f"), ("planar", "h")):  # the model that wins
        assert bool(tclear) and np.linalg.norm(tR - R_gt) < 2e-2


def test_draw_samples_are_distinct_valid_rows():
    valid = torch.zeros(300, dtype=torch.bool)
    valid[torch.randperm(300, generator=torch.Generator().manual_seed(0))[:40]] = True
    s = tinit.draw_samples(valid, 256, 8, torch.Generator().manual_seed(1))
    assert s.shape == (256, 8)
    assert bool(valid[s].all())
    assert all(len(set(row.tolist())) == 8 for row in s)


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_generator_draws_pick_the_model(kind):
    """With its own draws the port picks F for the general scene and H for
    the planar one, and reconstructs the motion (tests/test_initializer.py's
    bars)."""
    u1, u2, valid, _, R_gt, t_gt = _scene(kind)
    H, sh, F, sf, okh, okf = tinit.find_models(
        torch.from_numpy(u1), torch.from_numpy(u2), torch.from_numpy(valid),
        generator=torch.Generator().manual_seed(5))
    ratio = float(sh) / (float(sh) + float(sf))
    args = (torch.from_numpy(K), torch.from_numpy(u1), torch.from_numpy(u2))
    if kind == "general":
        assert ratio <= 0.40
        R, t, _, good, clear = tinit.reconstruct_f(F, *args, okf)
        tol_R, tol_t = 5e-3, 2e-2
    else:
        assert ratio > 0.40
        R, t, _, good, clear = tinit.reconstruct_h(H, *args, okh)
        tol_R, tol_t = 2e-2, 5e-2
    assert bool(clear)
    assert np.linalg.norm(R.numpy() - R_gt) < tol_R
    tdir = t_gt / np.linalg.norm(t_gt)
    assert min(np.linalg.norm(t.numpy() - tdir), np.linalg.norm(t.numpy() + tdir)) < tol_t
