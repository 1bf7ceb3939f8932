"""File-driven goldens of the port (slow tier, CPU): a TUM-format dataset
written by scripts/make_tum_dataset.py -> ``python -m
plslam_torch.utils.run_tum --device cpu`` -> CameraTrajectory.txt, scored
with the port's ``utils.evaluate`` against the known ground truth. The
port's counterparts of tests/test_tum_golden.py. All data is generated
here; nothing is downloaded.
"""

import os
import subprocess
import sys

import pytest

from plslam_torch.utils import evaluate, tum_io

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _generate(tmp_path, **kw):
    from scripts.make_tum_dataset import generate

    seq = str(tmp_path / "seq")
    generate(seq, **kw)
    return seq


def _run(seq, out, *flags, timeout=1800):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "plslam_torch.utils.run_tum",
         os.path.join(seq, "settings.yaml"), os.path.join(seq, "associate.txt"),
         "--out", out, "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def _ate(traj, seq):
    est_ts, est_pos, _ = tum_io.load_trajectory_tum(traj)
    gt_ts, gt_pos, _ = tum_io.load_trajectory_tum(os.path.join(seq, "groundtruth.txt"))
    rmse, n, _ = evaluate.ate_rmse(gt_ts, gt_pos, est_ts, est_pos)
    return rmse, n


def test_tum_pipeline_from_files(tmp_path):
    n = 40
    seq = _generate(tmp_path, n_frames=n, seed=0)
    out = str(tmp_path / "results")
    _run(seq, out)
    traj = os.path.join(out, "CameraTrajectory.txt")
    assert os.path.exists(os.path.join(out, "KeyFrameTrajectory.txt"))
    with open(traj) as f:
        assert len([line for line in f if line.strip()]) == n
    rmse, pairs = _ate(traj, seq)
    assert pairs == n
    assert rmse < 0.03, f"file-driven ATE {rmse * 100:.2f} cm"


def test_file_driven_orbit_healing(tmp_path):
    """The 200-frame full-turn revisit through the file pipeline with async
    workers: the saved (healed) trajectory is at least as good as the raw
    one, and bounded."""
    seq = _generate(tmp_path, n_frames=200, seed=3, orbit=True)
    out = str(tmp_path / "results")
    _run(seq, out, "--save-raw", timeout=3600)
    healed, _ = _ate(os.path.join(out, "CameraTrajectory.txt"), seq)
    raw, _ = _ate(os.path.join(out, "CameraTrajectoryRaw.txt"), seq)
    assert healed <= raw + 0.005, f"healed {healed * 100:.1f} cm, raw {raw * 100:.1f} cm"
    assert healed < 0.10, f"orbit healed ATE {healed * 100:.1f} cm"


def test_compaction_run_ends_ok(tmp_path):
    n = 40
    seq = _generate(tmp_path, n_frames=n, seed=0)
    out = str(tmp_path / "results")
    stdout = _run(seq, out, "--compact-every", "15", "--sync", "--pcd")
    assert "final state:          1" in stdout, stdout[-2000:]
    with open(os.path.join(out, "CameraTrajectory.txt")) as f:
        assert len([line for line in f if line.strip()]) == n
    with open(os.path.join(out, "result.pcd")) as f:
        assert "DATA ascii" in f.read(400)
    rmse, _ = _ate(os.path.join(out, "CameraTrajectory.txt"), seq)
    assert rmse < 0.03


def test_native_loader_names_item_18(tmp_path):
    r = subprocess.run([sys.executable, "-m", "plslam_torch.utils.run_tum", "s.yaml", "a.txt",
                        "--native-loader"], capture_output=True, text=True, timeout=120,
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode != 0 and "item 18" in r.stderr
