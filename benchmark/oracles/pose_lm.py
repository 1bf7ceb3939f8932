"""``pose_lm_gap_mm``: for the pose LM calls of the sampled frames, the
largest distance between the camera centre the program returned and the one
the reference protocol reaches in float64 from the same inputs (each batch
row alone). The correspondences are the program's own state: the matching
oracle checks how they were found. Control: the reference in bfloat16."""

import torch

from benchmark import reference as ref
from benchmark.checks import rows

NUMBERS = ("pose_lm_gap_mm",)
CAPTURES = {"pose": "plslam_torch.optim.pose:optimize_pose"}


def readings(calls, ctx, control):
    worst = 0.0
    for _, args, kwargs, res in calls["pose"]:
        cam_, R0, t0, obs = args[:4]
        rounds = kwargs.get("rounds", args[4] if len(args) > 4 else 4)
        iters = kwargs.get("iters", args[5] if len(args) > 5 else 10)
        lead = R0.dim() - 2
        fields = {k: rows(getattr(obs, k), lead) for k in obs._fields}
        R0s, t0s = rows(R0, lead), rows(t0, lead)
        Rp, tp = rows(res.R, lead), rows(res.t, lead)
        for b in range(R0s.shape[0]):
            o = {k: v[b] for k, v in fields.items()}
            Rr, tr = ref.pose_lm(cam_, R0s[b], t0s[b], o, rounds, iters, torch.float64)
            if control:
                Rp_b, tp_b = ref.pose_lm(cam_, R0s[b], t0s[b], o, rounds, iters, torch.bfloat16)
            else:
                Rp_b, tp_b = Rp[b], tp[b]
            c_ref = -(Rr.double().T @ tr.double())
            c_prog = -(Rp_b.double().T @ tp_b.double())
            worst = max(worst, float(torch.linalg.vector_norm(c_ref - c_prog)) * 1e3)
    return {"pose_lm_gap_mm": worst}
