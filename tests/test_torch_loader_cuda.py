"""The native loader in a process that has loaded the CUDA libraries and the
kernels: the loader once crashed in ``loader_create`` there (and only
there), in phase loader of chip_smoke.py. It runs in a fresh interpreter,
so that a crash fails this test instead of ending the run. Needs an
NVIDIA GPU; run it on the GPU machine with ``python -m pytest --noconftest
-m cuda tests/test_torch_loader_cuda.py``."""

import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import sys
import numpy as np
import torch
from plslam_torch.geometry.projection import Camera
from plslam_torch.native import TumLoader
from plslam_torch.ops import cuda_build
from plslam_torch.utils import tum_io

dev = torch.device("cuda")
a = torch.randn(64, 6, 6, device=dev, dtype=torch.float64) + 6 * torch.eye(6, device=dev)
torch.linalg.inv_ex(a)
torch.linalg.solve_ex(a, a[..., 0])
float((a @ a).sum())
for name in cuda_build.KERNELS:
    cuda_build.load(name)
cam = Camera(fx=100.0, fy=100.0, cx=15.5, cy=11.5, width=32, height=24)
rng = np.random.default_rng(0)
grays = [rng.integers(0, 256, (24, 32)).astype(np.uint8) for _ in range(3)]
depths = [rng.integers(1, 65535, (24, 32)).astype(np.uint16) for _ in range(3)]
tum_io.write_sequence(sys.argv[1], grays, depths, [0.0, 0.1, 0.2], cam)
frames = list(TumLoader(sys.argv[1] + "/associate.txt", width=32, height=24))
assert len(frames) == 3
print("ok")
"""


def test_loader_after_cuda_libraries(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    r = subprocess.run([sys.executable, "-c", CODE, str(tmp_path)], capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stdout + r.stderr[-3000:]
