"""A run with the timed path broken underneath comes out not correct: once
for each fault the cells can have (there is no exchange between chips to
leave out: both cells take one)."""

import torch

import plslam_torch.models.tracking as tracking
import plslam_torch.ops.hamming as hamming
import plslam_torch.optim.pose as pose
import plslam_torch.parallel.multiseq as multiseq
from plslam_torch.models.frame import FrameData


def test_a_step_that_returns_its_state_unchanged(run_small, monkeypatch):
    def unchanged(cam, R0, t0, obs, rounds=4, iters=10):
        return pose.PoseResult(R0, t0, obs.valid, obs.line_valid,
                               obs.valid.sum(-1, dtype=torch.int32))
    monkeypatch.setattr(pose, "optimize_pose", unchanged)
    out = run_small("tum_fr3_rgbd.explore", 12.0)
    assert not out["correct"]


def test_an_answer_altered_where_it_is_produced(run_small, monkeypatch):
    orig = hamming.hamming_top2

    def altered(q, t, gate):
        # one query row in 50 gets another target's index: too few to lose
        # track, so the frames are sampled and the Hamming check sees it
        best, idx, second = orig(q, t, gate)
        rows = torch.arange(idx.shape[-1], device=idx.device) % 50 == 0
        return best, torch.where(rows & (idx >= 0), (idx + 1) % t.shape[-2], idx), second
    monkeypatch.setattr(hamming, "hamming_top2", altered)
    out = run_small("tum_fr3_rgbd.explore", 12.0)
    assert not out["correct"]
    assert out["checks"]["hamming_mismatch_share"]["value"] > 0


def test_half_of_the_batch_left_out(run_small, monkeypatch):
    orig = multiseq.batched_step

    def half(cfg, gray, depth, args, stereo=False):
        h = max(gray.shape[0] // 2, 1)

        def cut(x):
            if isinstance(x, FrameData):
                return FrameData(*(f[:h] for f in x))
            return x[:h]
        out = orig(cfg, gray[:h], depth[:h], tuple(cut(a) for a in args), stereo)
        reps = -(-gray.shape[0] // h)

        def grow(x):
            if isinstance(x, FrameData):
                return FrameData(*(grow(f) for f in x))
            return torch.cat([x] * reps)[:gray.shape[0]]
        return type(out)(*(grow(x) for x in out))
    monkeypatch.setattr(multiseq, "batched_step", half)
    out = run_small("tum_fr3_rgbd_fleet4.explore", 12.0)
    assert not out["correct"]


def test_a_match_altered_where_it_is_produced(run_small, monkeypatch):
    orig = tracking._local_core

    def altered(*a, **k):
        # one matched local-map point in 20 gets the next feature
        out = orig(*a, **k)
        idx = out.pt_idx
        rows = (torch.arange(idx.shape[-1], device=idx.device) % 20 == 0) & (idx >= 0)
        n = a[1].kp_valid.shape[-1]
        return out._replace(pt_idx=torch.where(rows, (idx + 1) % n, idx))
    monkeypatch.setattr(tracking, "_local_core", altered)
    out = run_small("tum_fr3_rgbd.explore", 12.0)
    assert not out["correct"]
    assert out["checks"]["match_mismatch_share"]["value"] > 0
