"""The check that no JAX module is loaded compares top-level names whole, runs
to the end of a run, and the harness reads nothing of the JAX package's
benchmark."""

import sys
import time
from pathlib import Path

import pytest
from benchmark import cell
from benchmark.spec import Spec


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("plslam_tpu_like", "jaxtyping", "plslam_torch.models", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "plslam_tpu.models.tracking", sys)
    assert cell.forbidden_modules() == ["jax", "plslam_tpu"]


def test_the_harness_reads_no_jax_benchmark():
    root = Path(cell.__file__).resolve().parent
    for path in root.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in ("import plslam_tpu", "from plslam_tpu", "import jax", "from jax",
                     "chip_smoke", "bench.py", "BENCH_"):
            assert word not in text, (path, word)


@pytest.mark.parametrize("where", ["metric reader", "oracle"])
def test_a_module_loaded_after_the_window_refuses_the_result(where, monkeypatch, small_size):
    """The check runs again once everything after the window (the readers,
    the reference) has run: a forbidden module they load leaves no result."""
    spec = Spec()
    mod, name = ((spec.reader("frames_per_s"), "read") if where == "metric reader"
                 else (spec.oracle("hamming"), "readings"))
    orig = getattr(mod, name)

    def loads_jax(*a):
        monkeypatch.setitem(sys.modules, "jax", sys)
        return orig(*a)
    monkeypatch.setattr(mod, name, loads_jax)
    with pytest.raises(SystemExit, match="jax"):
        cell.run_cell(spec, "tum_fr3_rgbd.explore", 7, 3.0, False, time.perf_counter(),
                      device="cpu", tweak=small_size)
