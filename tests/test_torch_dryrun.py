"""plslam_torch.parallel.dryrun against the JAX package's: the per-shard
pose normal equations ``_pose_gn_step`` (H and b at 1e-4 relative; the port
differentiates analytically, JAX with ``jax.jacfwd``), and the port's dry
run completing its four phases on 4 CPU shards."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.geometry import se3 as jse3
from plslam_tpu.parallel import dryrun as jdry
from plslam_torch.parallel import dryrun as tdry
from torch_parity import few_torch_threads  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_gn_step_matches_jax(seed):
    rng = np.random.default_rng(seed)
    p3d = (rng.uniform(-1, 1, (32, 3)) + [0, 0, 3.0]).astype(np.float32)
    uv = rng.uniform(0, 480, (32, 2)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    xi = (0.05 * rng.standard_normal(6)).astype(np.float32)
    R, t = (np.array(x) for x in jse3.se3_exp(jnp.asarray(xi)))
    Hj, bj = (np.asarray(x) for x in jdry._pose_gn_step(*(jnp.asarray(a) for a in
                                                            (p3d, uv, w, R, t))))
    Ht, bt = tdry._pose_gn_step(*(torch.as_tensor(a) for a in (p3d, uv, w, R, t)))
    assert Ht.shape == (6, 6) and bt.shape == (6,)
    assert np.abs(Ht.numpy() - Hj).max() <= 1e-4 * np.abs(Hj).max()
    assert np.abs(bt.numpy() - bj).max() <= 1e-4 * np.abs(bj).max()
    # a stack of shards and keyframes gives each one's equations
    Hs, bs = tdry._pose_gn_step(*(torch.as_tensor(np.stack([a, a])[None])
                                  for a in (p3d, uv, w, R, t)))
    assert Hs.shape == (1, 2, 6, 6)
    np.testing.assert_allclose(Hs[0, 1].numpy(), Ht.numpy(), rtol=1e-6)
    np.testing.assert_allclose(bs[0, 1].numpy(), bt.numpy(), rtol=1e-6, atol=1e-3)


def test_dry_run_completes_on_cpu_shards():
    out = tdry.run(4, device="cpu")
    assert out["pose_step"]["dp"] * out["pose_step"]["obs"] == 4
    assert {"gn_step", "cg_step"} <= set(out)
    assert out["engine_gba"]["solver"] == "distributed"
    assert out["engine_gba"]["mean_kf_err_cm"] < 2.0
