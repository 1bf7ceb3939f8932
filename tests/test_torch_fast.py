"""plslam_torch.ops.fast against the JAX package's FAST and its Pallas kernel.

FAST-9 scores are subtracts, minima and maxima of float32 values: exact in
IEEE arithmetic, so the port's plain ``fast_score_nms`` must equal
``nms3x3(fast_score_map(...))`` and the Pallas kernel (interpret mode, at
``tests/test_pallas_fast.py``'s sizes) bit for bit. Selection must keep the
lowest-index-first tie order of ``lax.top_k``: checked on inputs with
deliberate ties (exact index equality).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.ops import fast as jfast
from plslam_tpu.ops.pallas_fast import fast_score_nms as pallas_fast_score_nms
from plslam_torch.ops import fast as tfast
from plslam_torch.ops import image as timage


def _jax_ref(img, th):
    return np.asarray(jfast.nms3x3(jfast.fast_score_map(jnp.asarray(img), th)))


def _structured(h, w):
    img = np.zeros((h, w), np.float32)
    img += np.linspace(0, 40, w)[None, :]
    img[10:25, 12:32] = 200.0
    img[5:8, w - 9:w - 6] = 255.0
    return img


@pytest.mark.parametrize("shape", [(33, 40), (61, 77), (134, 179)])
@pytest.mark.parametrize("th", [7.0, 20.0])
def test_plain_equals_jax_random(shape, th):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape).astype(np.float32)
    got = tfast.fast_score_nms(torch.from_numpy(img), th).numpy()
    np.testing.assert_array_equal(got, _jax_ref(img, th))


def test_plain_equals_jax_structured():
    img = _structured(37, 45)
    got = tfast.fast_score_nms(torch.from_numpy(img), 7.0).numpy()
    np.testing.assert_array_equal(got, _jax_ref(img, 7.0))
    assert (got > 0).sum() > 0  # the square's corners fire


def test_plain_equals_jax_uint8_smooth():
    # a smooth uint8 image (blurred noise) has many equal-score plateaus,
    # which exercises the NMS ">=" tie rule
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (40, 52)).astype(np.float32)
    k = np.ones(3) / 3
    raw = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, raw)
    img = np.round(raw).astype(np.uint8).astype(np.float32)
    got = tfast.fast_score_nms(torch.from_numpy(img), 7.0).numpy()
    np.testing.assert_array_equal(got, _jax_ref(img, 7.0))


@pytest.mark.parametrize("case", ["random", "structured", "uint8"])
def test_plain_equals_pallas_interpret(case):
    rng = np.random.default_rng(7)
    if case == "random":
        img, th = rng.integers(0, 256, (33, 40)).astype(np.float32), 7.0
    elif case == "structured":
        img, th = _structured(37, 45), 7.0
    else:
        img, th = rng.integers(0, 256, (32, 36)).astype(np.uint8).astype(np.float32), 20.0
    want = np.asarray(pallas_fast_score_nms(jnp.asarray(img), th, interpret=True))
    got = tfast.fast_score_nms(torch.from_numpy(img), th).numpy()
    np.testing.assert_array_equal(got, want)


def _tied_scores(h, w, seed):
    # integer scores drawn from a tiny set: nearly every value is tied
    rng = np.random.default_rng(seed)
    s = rng.choice([0.0, 0.0, 8.0, 9.0, 21.0, 30.0], size=(h, w)).astype(np.float32)
    return s


@pytest.mark.parametrize("shape", [(64, 96), (70, 101)])
def test_detect_cellwise_ties(shape):
    s = _tied_scores(*shape, seed=shape[1])
    want = jfast.detect_cellwise(jnp.asarray(s), 20.0, 32, 8, 5)
    got = tfast.detect_cellwise(torch.from_numpy(s), 20.0, 32, 8, 5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("n", [10, 57])
def test_top_n_keypoints_ties(n):
    rng = np.random.default_rng(n)
    resp = rng.choice([0.0, 9.0, 12.0, 30.0], size=96).astype(np.float32)
    ys = rng.integers(0, 100, 96).astype(np.int32)
    xs = rng.integers(0, 100, 96).astype(np.int32)
    want = jfast.top_n_keypoints(jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(resp), n)
    got = tfast.top_n_keypoints(torch.from_numpy(ys), torch.from_numpy(xs),
                                torch.from_numpy(resp), n)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_cpu_tensor_takes_plain_path_without_counting():
    before = tfast.fast_score_nms.launches
    tfast.fast_score_nms(torch.zeros(16, 16), 7.0)
    assert tfast.fast_score_nms.launches == before


def test_levels_equal_jax_on_rendered_pyramid():
    """fast_score_nms_levels on the port's 8-level pyramid of a rendered
    640x480 room frame (the tracker's 6-bit gray) equals the JAX package's
    per-level nms3x3(fast_score_map(...)) on the same levels, bit for bit."""
    from plslam_torch.geometry.projection import Camera
    from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

    cam = Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
    R, t = smooth_trajectory(300)[40]
    g, _ = RoomScene(0).render(cam, R, t)
    g8 = np.clip(g, 0, 255).astype(np.uint8)
    img = (((g8 >> 2) << 2) + 2).astype(np.float32)
    levels = timage.build_pyramid(torch.from_numpy(img), 8, 1.2)
    got = tfast.fast_score_nms_levels(levels, 7.0)
    assert len(got) == 8
    n_corners = 0
    for lvl, score in zip(levels, got):
        want = _jax_ref(lvl.numpy(), 7.0)
        np.testing.assert_allclose(score.numpy(), want, rtol=0, atol=0)
        n_corners += int((want > 0).sum())
    assert n_corners > 1000  # the room's texture fires on every level


def test_levels_empty_and_single():
    assert tfast.fast_score_nms_levels([], 7.0) == []
    img = _structured(37, 45)
    (got,) = tfast.fast_score_nms_levels([torch.from_numpy(img)], 7.0)
    np.testing.assert_array_equal(got.numpy(), _jax_ref(img, 7.0))
