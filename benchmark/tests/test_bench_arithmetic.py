"""The percentile, the pose's age and the frozen roofline arithmetic on
made-up inputs with hand-counted answers."""

import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import cell, roofline
from benchmark.spec import Spec


def test_latency_p90_is_linear_between_ranks():
    p90 = Spec().reader("frame_latency_p90_ms").read
    assert p90(SimpleNamespace(ages_s=[i / 1e3 for i in range(1, 11)])) == pytest.approx(9.1)
    assert p90(SimpleNamespace(ages_s=[0.005])) == pytest.approx(5.0)
    assert p90(SimpleNamespace(ages_s=[])) is None


def test_age_runs_from_hand_over_to_the_retiring_call():
    ses = SimpleNamespace(hand={15: 1.0, 16: 1.5}, age={})
    fps = 30.0
    cell.retire(ses, [(14 / fps, None, None)], 1.4, fps)   # a warm-up frame: no age
    cell.retire(ses, [(15 / fps, None, None)], 2.0, fps)
    cell.retire(ses, [(16 / fps, None, None)], 2.25, fps)  # retired by the flush
    assert ses.age == {15: pytest.approx(1.0), 16: pytest.approx(0.75)}


def test_fast_bound_by_hand():
    # 1000 px, 10 sides: operations 21*1000 + 2*10 = 21,020 at the sub rate,
    # min/max (4*1000 + 63*10 = 4,630) at half of it, counted twice
    ops = 21_020 + 2 * 4_630
    assert roofline.fast_bound_s(1000, 10) == pytest.approx(
        max(8000 / 3.35e12, ops / (67e12 / 2)))


def test_hamming_bound_by_hand():
    # 2 problems of 16 queries x 64 targets, own queries: 2*16*32 + 2*(64*32 +
    # 16*64 + 12*16) bytes
    nbytes = 2 * 16 * 32 + 2 * (64 * 32 + 16 * 64 + 12 * 16)
    assert roofline.hamming_bound_s(2, 16, 64, False) == pytest.approx(nbytes / 3.35e12)
    shared = 16 * 32 + 2 * (64 * 32 + 16 * 64 + 12 * 16)
    assert roofline.hamming_bound_s(2, 16, 64, True) == pytest.approx(shared / 3.35e12)


def test_pretest_sides_by_hand():
    img = torch.zeros(9, 9)
    img[4, 4] = 100.0  # a bright dot: its 4 compass points are all darker by 100
    assert roofline.pretest_sides(img, 20.0) == 1  # the dark side of (4, 4) only
    img2 = torch.zeros(2, 9, 9)
    img2[:, 4, 4] = 100.0
    assert roofline.pretest_sides(img2, 20.0) == 2
    assert roofline.pretest_sides(img, 100.0) == 0
    assert math.isclose(roofline.bound_s(3.35e12, 0, 1.0), 1.0)


def test_roofline_readers_on_a_made_up_slice():
    spec = Spec()
    img = torch.zeros(9, 9)
    img[4, 4] = 100.0
    kernels = [("fast_score_nms_kernel(LevelTable, float)", 0.0, 100.0),   # µs
               ("hamming_top2_kernel(...)", 200.0, 250.0), ("other_kernel", 300.0, 400.0)]
    gate = torch.zeros(3, 16, 64, dtype=torch.bool)
    calls = {"fast": [(None, ([img, img[:6, :6]], 7.0), {}, None)],
             "hamming": [(None, (None, None, gate), {}, None)], "hamming_batched": []}
    run = SimpleNamespace(slice={"kernels": kernels, "calls": calls})
    fast = spec.reader("fast_roofline_share").read(run)
    assert fast == pytest.approx(100 * roofline.fast_bound_s(81 + 36, 1) / 100e-6)
    ham = spec.reader("hamming_roofline_share").read(run)
    assert ham == pytest.approx(100 * roofline.hamming_bound_s(3, 16, 64, False) / 50e-6)
    run.slice["kernels"] = kernels[2:]  # nothing launched: nothing to read
    assert spec.reader("fast_roofline_share").read(run) is None
    assert spec.reader("hamming_roofline_share").read(run) is None
