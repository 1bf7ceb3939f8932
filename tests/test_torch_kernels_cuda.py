"""The CUDA kernels against their plain PyTorch versions, on the card.

Both kernels must give the same bits as their plain versions (FAST scores
are exact float32 min/max/subtract; Hamming distances are integers). These
tests need an NVIDIA GPU and nvcc; elsewhere they skip. Run them on the GPU
machine with ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (``--noconftest``: the suite's conftest
imports JAX, which a GPU machine for the port need not have).
"""

import numpy as np
import pytest
import torch

from plslam_torch.ops import fast, hamming

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU build)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(480, 640), (400, 533), (134, 179), (7, 9), (33, 40)])
@pytest.mark.parametrize("th", [7.0, 20.0])
def test_fast_kernel_equals_plain(dev, shape, th):
    rng = np.random.default_rng(shape[0])
    img = torch.as_tensor(rng.integers(0, 256, shape).astype(np.float32), device=dev)
    before = fast.fast_score_nms.launches
    got = fast.fast_score_nms(img, th)
    assert fast.fast_score_nms.launches == before + 1
    torch.testing.assert_close(got, fast.fast_score_nms_plain(img, th), rtol=0, atol=0)


def test_fast_kernel_rejects_bad_input(dev):
    with pytest.raises(ValueError):
        fast.fast_score_nms(torch.zeros(8, 8, dtype=torch.float64, device=dev), 7.0)
    with pytest.raises(ValueError):
        fast.fast_score_nms(torch.zeros(8, 16, device=dev)[:, ::2], 7.0)


@pytest.mark.parametrize("n,m,density", [(1024, 1024, 0.05), (8192, 1024, 0.02),
                                         (8192, 1024, 1.0), (1000, 777, 0.5),
                                         (5, 2049, 0.9), (64, 0, 0.0)])
def test_hamming_kernel_equals_plain(dev, n, m, density):
    rng = np.random.default_rng(n + m)
    q = torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8), device=dev)
    t = torch.as_tensor(rng.integers(0, 256, (m, 32), dtype=np.uint8), device=dev)
    if m >= 40 and n >= 20:
        t[10:20] = q[:10]
        t[30:40] = q[:10]  # planted ties on the best distance
    gate = torch.as_tensor(rng.random((n, m)) < density, device=dev)
    if m >= 40 and n >= 20:
        gate[:10, 10:40] = True
        gate[15] = False
    before = hamming.hamming_top2.launches
    got = hamming.hamming_top2(q, t, gate)
    assert hamming.hamming_top2.launches == before + 1
    for a, b in zip(got, hamming.hamming_top2_plain(q, t, gate)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_hamming_kernel_rejects_bad_input(dev):
    q = torch.zeros(4, 32, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        hamming.hamming_top2(q, q, torch.ones(4, 4, dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError):
        hamming.hamming_top2(q, q, torch.ones(4, 5, dtype=torch.bool, device=dev))
