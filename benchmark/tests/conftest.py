"""Shared helpers of the harness's tests: the cells at a size the CPU runs
in a minute (320x240, a 40-frame sequence, 5 warm frames)."""

import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def small(conf, traffic):
    """Half the camera's resolution and a short sequence; every other
    setting as the configuration states it."""
    s = conf["settings"]
    for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy"):
        s[k] = s[k] / 2
    s["Camera.width"], s["Camera.height"] = 320, 240
    conf["sequence_frames"] = 40
    conf["correct"]["sample_every"] = 2
    conf["correct"]["max_samples"] = 2
    traffic["warmup_frames"] = 5


@pytest.fixture
def small_size():
    """The ``tweak`` of ``run_cell`` that sets the small size."""
    return small


@pytest.fixture
def run_small():
    """``run_small(workload, seconds, **kw)``: one run of a cell on the CPU
    at the small size."""
    from benchmark.cell import run_cell
    from benchmark.spec import Spec

    def go(workload, seconds, seed=987654321012, **kw):
        return run_cell(Spec(), workload, seed, seconds, kw.pop("trace", False),
                        time.perf_counter(), device="cpu", tweak=small, **kw)
    return go
