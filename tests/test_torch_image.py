"""plslam_torch.ops.image against the JAX package's ops/image.py.

Blur and Sobel are the same shifted adds in the same order, in float32, so
they match to 1e-5 (exactly, in practice). The pyramid uses
``F.interpolate`` where the JAX package uses ``jax.image.resize``: both are
bilinear with half-pixel centres and no antialias, but they form the
weights and sum in different orders, so levels agree to 1e-4 on 0..255
images, not bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.ops import image as jimage
from plslam_torch.ops import image as timage


def _img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 64, (h, w)).astype(np.float32) * 4 + 2


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
@pytest.mark.parametrize("ksize,sigma", [(7, 2.0), (5, 1.0)])
def test_gaussian_blur(shape, ksize, sigma):
    img = _img(*shape)
    want = np.asarray(jimage.gaussian_blur(jnp.asarray(img), ksize, sigma))
    got = timage.gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_sobel(shape):
    img = _img(*shape, seed=1)
    jgx, jgy = jimage.sobel_gradients(jnp.asarray(img))
    tgx, tgy = timage.sobel_gradients(torch.from_numpy(img))
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tgy.numpy(), np.asarray(jgy), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(240, 320), (97, 131)])
def test_resize_step(shape):
    """One pyramid step from the same input, on a smooth 0..255 image.
    The two resizers place samples with float32 positions that differ by an
    ulp of the coordinate (~1e-5 at x~100); times a neighbour contrast of a
    few grey levels per pixel that stays far below 1e-4 (on white noise,
    with ~250 levels of contrast, it would not)."""
    rng = np.random.default_rng(2)
    coarse = rng.uniform(0, 255, (shape[0] // 8 + 2, shape[1] // 8 + 2))
    yy = np.linspace(0, coarse.shape[0] - 1.001, shape[0])
    xx = np.linspace(0, coarse.shape[1] - 1.001, shape[1])
    y0, x0 = yy.astype(int), xx.astype(int)
    fy, fx = (yy - y0)[:, None], (xx - x0)[None, :]
    img = (coarse[y0][:, x0] * (1 - fy) * (1 - fx) + coarse[y0 + 1][:, x0] * fy * (1 - fx)
           + coarse[y0][:, x0 + 1] * (1 - fy) * fx
           + coarse[y0 + 1][:, x0 + 1] * fy * fx).astype(np.float32)
    assert timage.pyramid_shapes(*shape, 8, 1.2) == jimage.pyramid_shapes(*shape, 8, 1.2)
    for out_hw in timage.pyramid_shapes(*shape, 8, 1.2)[1:4]:
        want = np.asarray(jimage.resize_bilinear(jnp.asarray(img), out_hw))
        got = timage.resize_bilinear(torch.from_numpy(img), out_hw).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pyramid_rendered_frame():
    """The whole 8-level chain on a rendered room frame (the tracker's
    6-bit gray): every level within 1e-4."""
    from plslam_torch.geometry.projection import Camera
    from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

    cam = Camera(fx=262.5, fy=262.5, cx=159.5, cy=119.5, width=320, height=240)
    R, t = smooth_trajectory(300)[5]
    g, _ = RoomScene(0).render(cam, R, t)
    g8 = np.clip(g, 0, 255).astype(np.uint8)
    img = (((g8 >> 2) << 2) + 2).astype(np.float32)
    want = jimage.build_pyramid(jnp.asarray(img), 8, 1.2)
    got = timage.build_pyramid(torch.from_numpy(img), 8, 1.2)
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)
