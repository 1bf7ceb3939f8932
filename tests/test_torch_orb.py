"""plslam_torch.ops.orb against the JAX package's ops/orb.py.

On identical keypoints of one image, intensity-centroid angles agree to
1e-4 degrees (float32 moment maps summed in another order) and rBRIEF
descriptors are bit-identical (same pattern, same rounding, same gather).

On a full 320x240 frame the pyramid levels above 0 differ in the last bits
(F.interpolate vs jax.image.resize, see test_torch_image.py); at least 99%
of keypoints coincide. On level 0, which is the input itself, every
coinciding keypoint carries an identical descriptor; on the resized levels
a last-bit difference can move an angle by ~0.01 degree and flip a rotated
pattern offset's rounding, so there at least 99% of descriptors are
identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.config import OrbConfig as JOrbConfig
from plslam_tpu.ops import image as jimage
from plslam_tpu.ops import orb as jorb
from plslam_torch.config import OrbConfig
from plslam_torch.geometry.projection import Camera
from plslam_torch.ops import image as timage
from plslam_torch.ops import orb as torb
from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory


@pytest.fixture(scope="module")
def frame():
    cam = Camera(fx=262.5, fy=262.5, cx=159.5, cy=119.5, width=320, height=240)
    R, t = smooth_trajectory(300)[7]
    g, _ = RoomScene(0).render(cam, R, t)
    g8 = np.clip(g, 0, 255).astype(np.uint8)
    return (((g8 >> 2) << 2) + 2).astype(np.float32)  # the tracker's 6-bit gray


def _keypoints(img, n=300, seed=0):
    rng = np.random.default_rng(seed)
    h, w = img.shape
    ys = rng.integers(20, h - 20, n).astype(np.int32)
    xs = rng.integers(20, w - 20, n).astype(np.int32)
    return ys, xs


def test_pattern_tables():
    np.testing.assert_array_equal(torb._umax_table(), jorb._umax_table())
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    assert torb._per_level_budget(OrbConfig()) == jorb._per_level_budget(JOrbConfig())


def test_ic_angles_identical_keypoints(frame):
    ys, xs = _keypoints(frame)
    want = np.asarray(jorb.ic_angles(jnp.asarray(frame), jnp.asarray(ys), jnp.asarray(xs)))
    got = torb.ic_angles(torch.from_numpy(frame), torch.from_numpy(ys),
                         torch.from_numpy(xs)).numpy()
    d = np.abs(got - want)
    d = np.minimum(d, 360.0 - d)
    assert d.max() < 1e-4, d.max()


@pytest.mark.parametrize("seed", [0, 1])
def test_brief_identical_keypoints(frame, seed):
    ys, xs = _keypoints(frame, seed=seed)
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 360, len(ys)).astype(np.float32)
    blurred = np.asarray(jimage.gaussian_blur(jnp.asarray(frame)))
    want = np.asarray(jorb._brief_gather(jnp.asarray(blurred), jnp.asarray(ys),
                                         jnp.asarray(xs), jnp.asarray(ang)))
    got = torb.brief_descriptors(torch.from_numpy(blurred), torch.from_numpy(ys),
                                 torch.from_numpy(xs), torch.from_numpy(ang)).numpy()
    np.testing.assert_array_equal(got, want)


def test_extract_orb_full_frame(frame):
    cfg = OrbConfig()
    want = jorb.extract_orb(jnp.asarray(frame), JOrbConfig(), frame.shape)
    got = torb.extract_orb(torch.from_numpy(frame), cfg)
    jv, tv = np.asarray(want.valid), got.valid.numpy()
    jxy, txy = np.asarray(want.xy), got.xy.numpy()
    same = jv & tv & (np.abs(jxy - txy).max(1) == 0) & (
        np.asarray(want.octave) == got.octave.numpy())
    assert jv.sum() > 500
    assert same.sum() >= 0.99 * jv.sum(), (same.sum(), jv.sum())
    desc_eq = (np.asarray(want.desc) == got.desc.numpy()).all(1)
    lvl0 = same & (got.octave.numpy() == 0)
    assert lvl0.sum() > 100
    assert desc_eq[lvl0].all()
    assert desc_eq[same].mean() >= 0.99
    np.testing.assert_allclose(got.response.numpy()[same],
                               np.asarray(want.response)[same], atol=1e-3)


def test_extract_orb_on_a_resized_level(frame):
    """Given the JAX package's pyramid level as input, FAST scores and the
    selection agree exactly. The level's intensities are not integers, so
    the moment maps' float32 prefix sums (~650 terms, summed in another
    order) differ in the last bits: angles agree to 1e-2 degrees, and at
    least 99% of descriptors are identical."""
    lvl = np.asarray(jimage.build_pyramid(jnp.asarray(frame), 3, 1.2)[2])
    cfg = OrbConfig(n_levels=1, n_features=300, max_keypoints=320)
    jcfg = JOrbConfig(n_levels=1, n_features=300, max_keypoints=320)
    want = jorb.extract_orb(jnp.asarray(lvl), jcfg, lvl.shape)
    got = torb.extract_orb(torch.from_numpy(lvl), cfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(got.response.numpy(), np.asarray(want.response))
    np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle), atol=1e-2)
    eq = (got.desc.numpy() == np.asarray(want.desc)).all(1)[got.valid.numpy()]
    assert eq.mean() >= 0.99, eq.mean()
