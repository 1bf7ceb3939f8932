"""``python -m plslam_torch.utils.run_kitti`` on the CPU: a three-frame
KITTI odometry folder (image_0/, image_1/, times.txt) of rendered stereo
pairs at 320x240, written with OpenCV, and a settings YAML in the
reference's format with ``Camera.bf``. The runner writes one KITTI row of
12 numbers per frame, the first the identity; ``load_yaml`` reads ``bf``
as the JAX package's does; the runner reads its PNGs through the port's
own decoder, so it runs without OpenCV too (pairs written with
``utils.png_io``). Also the TUM2 / TUM3 settings equal the JAX package's."""

import dataclasses
import sys

import numpy as np
import pytest

from plslam_tpu import config as jconfig
from plslam_torch import config as tconfig
from plslam_torch.utils import png_io, run_kitti
from test_torch_stereo import KW, stereo_pairs
from torch_parity import few_torch_threads  # noqa: F401

YAML = """%YAML:1.0
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {width}
Camera.height: {height}
Camera.fps: 10.0
Camera.bf: {bf}
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _settings(tmp_path):
    path = tmp_path / "KITTI.yaml"
    path.write_text(YAML.format(**KW))
    return str(path)


def test_run_kitti_writes_a_row_per_frame(tmp_path):
    cv2 = pytest.importorskip("cv2")
    seq = tmp_path / "00"
    for cam in ("image_0", "image_1"):
        (seq / cam).mkdir(parents=True)
    pairs, _ = stereo_pairs(3, 100)
    for i, (gl, gr) in enumerate(pairs):
        assert cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), gl)
        assert cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), gr)
    np.savetxt(seq / "times.txt", np.arange(3) * 0.1)
    out = tmp_path / "out"
    assert run_kitti.main([_settings(tmp_path), str(seq), "--out", str(out),
                           "--device", "cpu"]) == 0
    rows = np.loadtxt(out / "CameraTrajectory.txt", ndmin=2)
    assert rows.shape == (3, 12)
    assert np.isfinite(rows).all()
    np.testing.assert_allclose(rows[0], np.eye(3, 4).reshape(-1), atol=1e-6)


def test_load_yaml_reads_bf_as_jax(tmp_path):
    path = _settings(tmp_path)
    assert dataclasses.asdict(tconfig.load_yaml(path)) == dataclasses.asdict(
        jconfig.load_yaml(path))
    assert tconfig.load_yaml(path).camera.bf == KW["bf"]


@pytest.mark.parametrize("name", ["tum2_config", "tum3_config"])
def test_tum_configs_match_jax(name):
    assert dataclasses.asdict(getattr(tconfig, name)()) == dataclasses.asdict(
        getattr(jconfig, name)())


def test_run_kitti_without_opencv_names_item_18(tmp_path, monkeypatch):
    """Without OpenCV the runner reads its pairs (the refusal that named
    ROADMAP item 18 is gone with the native decoder)."""
    seq = tmp_path / "00"
    for cam in ("image_0", "image_1"):
        (seq / cam).mkdir(parents=True)
    pairs, _ = stereo_pairs(3, 100)
    for i, (gl, gr) in enumerate(pairs):
        png_io.write_png(seq / "image_0" / f"{i:06d}.png", gl)
        png_io.write_png(seq / "image_1" / f"{i:06d}.png", gr)
        np.testing.assert_array_equal(run_kitti.load_gray(str(seq / "image_0" / f"{i:06d}.png")),
                                      gl)
    np.savetxt(seq / "times.txt", np.arange(3) * 0.1)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    out = tmp_path / "out"
    assert run_kitti.main([_settings(tmp_path), str(seq), "--out", str(out),
                           "--device", "cpu"]) == 0
    rows = np.loadtxt(out / "CameraTrajectory.txt", ndmin=2)
    assert rows.shape == (3, 12) and np.isfinite(rows).all()
