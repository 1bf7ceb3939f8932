"""plslam_torch LSD / LBD / line matching against the JAX package.

LSD endpoints agree to 0.5 px on the matched set (at least 95% of lines
matched): the detector is the same algorithm with the same tie order, and
only last-bit float differences in its sums separate the two. LBD bytes are
identical on identical segments and gradients, and ``lbd_distance_matrix``
is integer-exact. Line projection and matching agree exactly on identical
inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.config import LineConfig as JLineConfig
from plslam_tpu.geometry.projection import Camera as JCamera
from plslam_tpu.ops import image as jimage
from plslam_tpu.ops import lbd as jlbd
from plslam_tpu.ops import line_matching as jlm
from plslam_tpu.ops import lsd as jlsd
from plslam_torch.config import LineConfig
from plslam_torch.geometry.projection import Camera
from plslam_torch.ops import lbd as tlbd
from plslam_torch.ops import line_matching as tlm
from plslam_torch.ops import lsd as tlsd
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

KW = dict(fx=262.5, fy=262.5, cx=159.5, cy=119.5, width=320, height=240)
FULL = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5)
FRAMES = (0, 30, 60, 100, 150, 200, 250)


def _frame(k, kw=FULL):
    R, t = smooth_trajectory(300)[k]
    g, _ = RoomScene(0).render(Camera(**kw), R, t)
    g8 = np.clip(g, 0, 255).astype(np.uint8)
    return (((g8 >> 2) << 2) + 2).astype(np.float32)  # the tracker's 6-bit gray


@pytest.fixture(scope="module")
def detected():
    """Both detectors on 640x480 room frames along the trajectory."""
    out = []
    for k in FRAMES:
        img = _frame(k)
        jl = jlsd.detect_lines(jnp.asarray(img), JLineConfig(), img.shape)
        tl = tlsd.detect_lines(torch.from_numpy(img), LineConfig(), img.shape)
        out.append((img, jl, tl))
    return out


def _pairing(jl, tl):
    """Max endpoint distance from each JAX segment to its closest port
    segment (either endpoint order)."""
    jv, tv = np.asarray(jl.valid), tl.valid.numpy()
    je, te = np.asarray(jl.endpoints)[jv], tl.endpoints.numpy()[tv]
    d_fwd = np.abs(je[:, None] - te[None]).max((2, 3))
    d_rev = np.abs(je[:, None] - te[None, :, ::-1]).max((2, 3))
    return np.minimum(d_fwd, d_rev)


def test_lsd_endpoints(detected):
    """At least 95% of the JAX segments have a port segment within 0.5 px,
    pooled over the frames. The misses are decisions at a threshold (support
    count, density, NMS overlap) that XLA's fused float arithmetic inside
    jit tips the other way; the port follows the op-by-op arithmetic."""
    best = np.concatenate([_pairing(jl, tl).min(1) for _, jl, tl in detected])
    assert len(best) >= 50
    assert (best <= 0.5).mean() >= 0.95, np.round(best, 3)
    for _, jl, tl in detected:
        assert abs(int(np.asarray(jl.valid).sum()) - int(tl.valid.sum())) <= 1


def test_lsd_attributes(detected):
    for _, jl, tl in detected:
        d = _pairing(jl, tl)
        jv, tv = np.asarray(jl.valid), tl.valid.numpy()
        hit = d.min(1) <= 0.5
        partner = d.argmin(1)
        for name in ("length", "response"):
            a = np.asarray(getattr(jl, name))[jv][hit]
            b = getattr(tl, name).numpy()[tv][partner[hit]]
            np.testing.assert_allclose(b, a, atol=1.0)
        np.testing.assert_allclose(
            np.abs(tl.coeff.numpy()[tv][partner[hit]]),
            np.abs(np.asarray(jl.coeff)[jv][hit]), atol=1e-2)


def test_lbd_identical_segments(detected):
    img, jl, _ = detected[2]
    bl = jimage.gaussian_blur(jnp.asarray(img), 5, 1.0)
    gx, gy = jimage.sobel_gradients(bl)
    want = np.asarray(jlbd.lbd_descriptors(gx, gy, jl.endpoints, jl.valid, JLineConfig()))
    got = tlbd.lbd_descriptors(torch.tensor(np.asarray(gx)), torch.tensor(np.asarray(gy)),
                               torch.tensor(np.asarray(jl.endpoints)),
                               torch.tensor(np.asarray(jl.valid)), LineConfig()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(96, 96), (37, 53)])
def test_lbd_distance_matrix_exact(shape):
    rng = np.random.default_rng(shape[1])
    a = rng.integers(0, 128, (shape[0], 72)).astype(np.uint8)
    b = rng.integers(0, 128, (shape[1], 72)).astype(np.uint8)
    b[:5] = a[:5]
    want = np.asarray(jlbd.lbd_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tlbd.lbd_distance_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _random_lines(rng, n):
    ep = np.stack([rng.uniform([-1.5, -1.0, 1.0], [1.5, 1.0, 4.0], (n, 3)),
                   rng.uniform([-1.5, -1.0, 1.0], [1.5, 1.0, 4.0], (n, 3))], 1)
    ep[: n // 8, :, 2] = -ep[: n // 8, :, 2]  # some behind the camera
    ep[n // 8: n // 4, 0, 2] = -0.5           # some crossing z = 0
    return ep.astype(np.float32)


def test_project_and_match_lines():
    rng = np.random.default_rng(5)
    n_map, n_f = 64, 96
    ep_w = _random_lines(rng, n_map)
    valid = rng.random(n_map) < 0.9
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.02, -0.01, 0.03], np.float32)
    jp = jlm.project_lines(JCamera(**KW), jnp.asarray(R), jnp.asarray(t),
                           jnp.asarray(ep_w), jnp.asarray(valid))
    tp = tlm.project_lines(Camera(**KW), torch.from_numpy(R), torch.from_numpy(t),
                           torch.from_numpy(ep_w), torch.from_numpy(valid))
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
    # frame lines: noisy copies of the projections plus clutter
    uv = np.asarray(jp.uv)
    f_ep = np.concatenate([uv + rng.normal(0, 1.0, uv.shape),
                           rng.uniform(0, 300, (n_f - n_map, 2, 2))]).astype(np.float32)
    d = f_ep[:, 1] - f_ep[:, 0]
    f_angle = np.arctan2(d[:, 1], d[:, 0]).astype(np.float32)
    f_len = np.linalg.norm(d, axis=1).astype(np.float32)
    f_valid = rng.random(n_f) < 0.95
    map_desc = rng.integers(0, 128, (n_map, 72)).astype(np.uint8)
    f_desc = np.concatenate([map_desc + rng.integers(0, 3, map_desc.shape).astype(np.uint8),
                             rng.integers(0, 128, (n_f - n_map, 72)).astype(np.uint8)])
    for allow_relax in (True, False):
        want = jlm.match_lines(jp, jnp.asarray(map_desc), jnp.asarray(f_ep),
                               jnp.asarray(f_angle), jnp.asarray(f_len),
                               jnp.asarray(f_desc), jnp.asarray(f_valid),
                               JLineConfig(), allow_relax=allow_relax)
        # both sides see the same projection (the JAX one) so that the
        # comparison isolates the gate cascade
        tp_same = tlm.ProjectedLines(*(torch.tensor(np.asarray(a)) for a in jp))
        got = tlm.match_lines(tp_same, torch.from_numpy(map_desc), torch.from_numpy(f_ep),
                              torch.from_numpy(f_angle), torch.from_numpy(f_len),
                              torch.from_numpy(f_desc), torch.from_numpy(f_valid),
                              LineConfig(), allow_relax=allow_relax)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert int(np.asarray(want.ok).sum()) > 10
