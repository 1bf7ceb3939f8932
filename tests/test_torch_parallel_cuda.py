"""The landmark-sharded BA on the card: 4 shards on one GPU against the same
4 shards on the CPU (one step at 1e-5 relative: the card sums in another
order), a whole ``distributed_bundle_adjust``, and the engine route. These
tests need an NVIDIA GPU; elsewhere they skip. Run them on the GPU machine
with ``python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py``
(they import no JAX)."""

import numpy as np
import pytest
import torch

from plslam_torch.geometry import se3
from plslam_torch.geometry.projection import Camera
from plslam_torch.optim import local_ba
from plslam_torch.parallel import ba as pba
from plslam_torch.parallel.mesh import make_ba_mesh

pytestmark = pytest.mark.cuda

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _problem(seed=0, n_cams=8, n_pts=300):
    """Cameras on an arc observing a point cloud, pixel noise, perturbed
    poses (camera 0 fixed) and points, as numpy arrays."""
    rng = np.random.default_rng(seed)
    R = se3.so3_exp(torch.tensor([[0.0, 0.08 * (i - n_cams / 2), 0.0]
                                  for i in range(n_cams)])).numpy()
    c = np.array([[np.sin(0.08 * (i - n_cams / 2)), 0.05 * i, -0.3] for i in range(n_cams)],
                 np.float32)
    R = R.transpose(0, 2, 1).copy()
    t = -np.einsum("cij,cj->ci", R, c).astype(np.float32)
    pts = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (n_pts, 3)).astype(np.float32)
    oc = np.repeat(np.arange(n_cams), n_pts)
    op = np.tile(np.arange(n_pts), n_cams)
    pc = np.einsum("oij,oj->oi", R[oc], pts[op]) + t[oc]
    uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx, CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy],
                  -1) + rng.normal(0, 0.3, (len(oc), 2))
    xi = torch.as_tensor(rng.standard_normal((n_cams, 6)).astype(np.float32) * 0.01)
    xi[0] = 0
    Rp, tp = (x.numpy() for x in se3.left_update(xi, torch.as_tensor(R), torch.as_tensor(t)))
    fixed = np.arange(n_cams) == 0
    return (Rp, tp, fixed, pts + rng.normal(0, 0.01, pts.shape).astype(np.float32),
            np.ones(n_pts, bool), oc, op, uv.astype(np.float32),
            np.full(len(oc), -1.0, np.float32), np.ones(len(oc), np.float32), pc[:, 2] > 0.3)


def _rel(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.mark.parametrize("step", ["gn", "cg"])
def test_step_on_card_equals_cpu(dev, step):
    fn = pba.distributed_gn_step if step == "gn" else pba.distributed_cg_step
    prob = pba.shard_problem(*_problem(), n_shards=4)
    on_cpu = fn(CAM, prob, make_ba_mesh([torch.device("cpu")] * 4))
    on_card = fn(CAM, prob, make_ba_mesh([dev] * 4))
    for a, b in zip(on_cpu, on_card):
        assert b.is_cuda
        assert _rel(a, b) <= 1e-5


def test_bundle_adjust_on_card_equals_cpu(dev):
    args = _problem(1)
    C, P, O = len(args[0]), len(args[3]), len(args[5])
    t = lambda a, d=None: torch.as_tensor(np.asarray(a), dtype=d)  # noqa: E731
    prob = local_ba.make_problem(C, P, O, 1, 1, device="cpu")._replace(
        cam_R=t(args[0]), cam_t=t(args[1]), cam_fixed=t(args[2]),
        cam_valid=torch.ones(C, dtype=bool), pt_xyz=t(args[3]), pt_valid=t(args[4]),
        obs_cam=t(args[5], torch.int64), obs_pt=t(args[6], torch.int64), obs_uv=t(args[7]),
        obs_ur=t(args[8]), obs_w=t(args[9]), obs_valid=t(args[10]))
    ref = pba.distributed_bundle_adjust(CAM, prob, make_ba_mesh([torch.device("cpu")] * 4))
    got = pba.distributed_bundle_adjust(CAM, prob, make_ba_mesh([dev] * 4))
    for a, b in zip(ref[:3], got[:3]):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    assert (ref[3] == got[3]).mean() >= 0.999
