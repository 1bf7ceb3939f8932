"""Relocalization's tensor programs on the card against the same calls on
the CPU: the vocabulary descent, Horn RANSAC with injected samples, EPnP
RANSAC on exact data, and the relocalization match through kernel 2 at
its dense 1024 x 1024 gate. These tests need an NVIDIA GPU; elsewhere
they skip. Run them on the GPU machine with ``python -m pytest
--noconftest -m cuda tests/test_torch_reloc_cuda.py``.
"""

import numpy as np
import pytest
import torch

from plslam_torch.bow.vocabulary import Vocabulary, sparse_bow
from plslam_torch.config import SlamConfig
from plslam_torch.geometry.projection import Camera
from plslam_torch.models.frame import FrameData
from plslam_torch.models import relocalization as rl
from plslam_torch.ops import hamming
from plslam_torch.optim import epnp, horn

pytestmark = pytest.mark.cuda

CAM = Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def test_vocabulary_transform_on_the_card(dev):
    rng = np.random.default_rng(0)
    desc = torch.as_tensor(rng.integers(0, 256, (1024, 32), dtype=np.uint8))
    valid = torch.as_tensor(rng.random(1024) < 0.9)
    w_cpu, b_cpu = Vocabulary.load(device="cpu").transform(desc, valid)
    w, b = Vocabulary.load(device=dev).transform(desc.to(dev), valid.to(dev))
    assert torch.equal(w.cpu(), w_cpu)
    torch.testing.assert_close(b.cpu(), b_cpu, rtol=0, atol=1e-6)
    ids, vals = sparse_bow(b)
    np.testing.assert_array_equal(ids, torch.nonzero(b_cpu).squeeze(1).numpy())


def _scene(seed, n=300):
    rng = np.random.default_rng(seed)
    src = rng.uniform([-2, -1.5, 1], [2, 1.5, 5], (n, 3)).astype(np.float32)
    w = rng.normal(size=3) * 0.3
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    th = np.linalg.norm(w)
    R = (np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    dst = (src @ R.T + t).astype(np.float32)
    bad = rng.random(n) < 0.3
    dst[bad] += rng.normal(0, 1.0, (bad.sum(), 3)).astype(np.float32)
    return src, dst, R, t, bad


def test_horn_ransac_on_the_card(dev):
    src, dst, R, t, bad = _scene(1)
    valid = np.ones(len(src), bool)
    samples = torch.as_tensor(np.random.default_rng(2).integers(0, len(src), (256, 3)))
    args = [torch.from_numpy(x) for x in (src, dst, valid)]
    cpu = horn.ransac_align(*args, samples=samples)
    gpu = horn.ransac_align(*(x.to(dev) for x in args), samples=samples.to(dev))
    assert torch.equal(gpu[3].cpu(), cpu[3]) and int(gpu[4]) == int(cpu[4])
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(gpu[2].cpu(), cpu[2], rtol=0, atol=1e-5)
    assert not gpu[3].cpu().numpy()[bad].any()
    g = torch.Generator(device=dev).manual_seed(0)
    _, Rg, tg, _, n = horn.ransac_align(*(x.to(dev) for x in args), generator=g)
    assert int(n) == int(cpu[4])
    assert np.abs(tg.cpu().numpy() - t).max() < 1e-4


def test_epnp_on_the_card(dev):
    src, _, R, t, _ = _scene(3, n=100)
    pc = src @ R.T + t
    uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                   CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1).astype(np.float32)
    ok = pc[:, 2] > 0.1
    g = torch.Generator(device=dev).manual_seed(0)
    Re, te, inl, n = epnp.ransac_epnp(CAM, torch.from_numpy(src).to(dev),
                                      torch.from_numpy(uv).to(dev), torch.from_numpy(ok).to(dev),
                                      generator=g)
    assert int(n) >= 0.95 * ok.sum()
    assert np.abs(Re.cpu().numpy() - R).max() < 1e-3 and np.abs(te.cpu().numpy() - t).max() < 1e-3


def test_reloc_match_launches_kernel_2(dev):
    """The match of a frame against a candidate keyframe: a dense gate, one
    kernel launch with every tile on the tensor cores, the plain version's
    result on the CPU."""
    rng = np.random.default_rng(4)
    cfg = SlamConfig(camera=CAM)
    n = cfg.orb.max_keypoints
    kp = torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    kf = kp.clone()
    flip = torch.as_tensor(rng.random((n, 32)) < 0.03)
    kf = torch.where(flip, kf ^ 0x08, kf)[torch.as_tensor(rng.permutation(n))]
    fields = {f: torch.zeros(1) for f in FrameData._fields}
    fields.update(kp_desc=kp, kp_valid=torch.as_tensor(rng.random(n) < 0.95),
                  kp_angle=torch.as_tensor(rng.uniform(0, 360, n).astype(np.float32)))
    fd = FrameData(**fields)
    kf_angle = torch.as_tensor(rng.uniform(0, 360, n).astype(np.float32))
    has = torch.as_tensor(rng.random(n) < 0.8)
    cpu = rl.reloc_match(cfg, fd, kf, kf_angle, has)
    fd_d = FrameData(*(x.to(dev) for x in fd))
    hamming.dense_tiles()
    before = hamming.hamming_top2.launches
    got = rl.reloc_match(cfg, fd_d, kf.to(dev), kf_angle.to(dev), has.to(dev))
    assert hamming.hamming_top2.launches == before + 1
    assert hamming.dense_tiles() == -(-n // 16) * -(-n // 512)
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)
    assert int(got.ok.sum()) > 0
