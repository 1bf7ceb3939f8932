"""Shared helpers of the port's parity tests (not a test module): rendered
frames, a JAX map's state as numpy for ``plslam_torch.convert``, and a
float64 harness for the JAX package's local BA."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.optim import local_ba as jlocal_ba
from plslam_torch import convert
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

# 320x240: the smallest size at which RGB-D initialization finds its 300
# keypoints with depth
KW = dict(fx=262.5, fy=262.5, cx=159.5, cy=119.5, bf=40.0, width=320, height=240)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads for the port's CPU ops while a module runs: the
    tier-1 run puts 6 test processes on the machine's cores, and the small
    eager ops of these tests only lose time to thread hand-offs there."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def render(n, total=300):
    """The first ``n`` frames of a ``total``-frame orbit of the room."""
    scene = RoomScene(0)
    out = []
    for R, t in smooth_trajectory(total)[:n]:
        g, d = scene.render(convert.Camera(**KW), R, t)
        out.append((np.clip(g, 0, 255).astype(np.uint8),
                    np.clip(d * 5000.0, 0, 65535).astype(np.uint16)))
    return out


def map_arrays(jm):
    """Everything ``convert.map_from_numpy`` takes, from a JAX map."""
    d = {k: np.array(getattr(jm, k)) for k in convert._ARRAYS}
    d.update(pt_obs=[dict(o) for o in jm.pt_obs], ln_obs=[dict(o) for o in jm.ln_obs],
             kf_children=[set(c) for c in jm.kf_children],
             n_kf=jm.n_kf, _pt_next=jm._pt_next, _ln_next=jm._ln_next,
             loop_edges=list(jm.loop_edges), big_change_idx=jm.big_change_idx,
             kf_frames=list(jm.kf_frames),
             kf_frames_dev=[None if f is None else jax.tree_util.tree_map(np.asarray, f)
                            for f in jm.kf_frames_dev],
             pt_desc_arena=np.asarray(jm.point_desc_arena()),
             ln_desc_arena=np.asarray(jm.line_desc_arena()))
    return d


def _astype(x, src, dst):
    return type(x)(*(np.asarray(v).astype(dst) if np.asarray(v).dtype == src
                     else np.asarray(v) for v in x))


@contextlib.contextmanager
def jax_ba_in_float64():
    """Runs the JAX package's stepped local BA in float64 (inputs and
    results stay float32), as the port solves: on the room's first local BA
    a float32 solve lands millimetres from the float64 optimum (see
    plslam_torch/optim/local_ba.py). Only the test's reference side changes."""
    orig = jlocal_ba.bundle_adjust_stepped

    def f64(cam, prob, **kw):
        with jax.enable_x64(True):
            p = jlocal_ba.BAProblem(*(jnp.asarray(v) for v in
                                      _astype(prob, np.float32, np.float64)))
            res = jlocal_ba.BAResult(*(np.asarray(v) for v in orig(cam, p, **kw)))
        return _astype(res, np.float64, np.float32)

    jlocal_ba.bundle_adjust_stepped = f64
    try:
        yield
    finally:
        jlocal_ba.bundle_adjust_stepped = orig
