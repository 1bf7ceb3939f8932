"""``match_mismatch_share``: for the sampled frames' point searches by
projection (the motion-model search and the local-map search, each batch
row alone), the share of queries that either side matched whose target
differs between the program and the reference, which redoes the projection,
the gates, the distances and the filters from the call's own inputs: the
frame (checked by the perception oracle), the map points with their
descriptors, and the pose the search starts from (the program's state).
Line matching is not covered. Control: the reference with its geometry in
bfloat16 and its distances summed in int8."""

import torch

from benchmark import reference as ref
from benchmark.checks import rows

NUMBERS = ("match_mismatch_share",)
CAPTURES = {"motion": "plslam_torch.models.tracking:_motion_core",
            "local": "plslam_torch.models.tracking:_local_core"}
# argument positions of the two searches' inputs
MOTION_ARGS = ("cfg", "fd", "p3d", "desc", "octave", "angle", "valid",
               "ln_ep3d", "ln_desc", "ln_valid", "R", "t")
LOCAL_ARGS = ("cfg", "fd", "p3d", "desc", "normal", "mind", "maxd", "valid", "pre",
              "ln_ep3d", "ln_desc", "ln_valid", "ln_pre", "R", "t")


def _frame(fd, lead: int, b: int) -> dict:
    return {"xy": rows(fd.kp_xy_un, lead)[b], "octave": rows(fd.kp_octave, lead)[b],
            "valid": rows(fd.kp_valid, lead)[b], "desc": rows(fd.kp_desc, lead)[b],
            "angle": rows(fd.kp_angle, lead)[b]}


def readings(calls, ctx, control):
    cfg = ctx.cfg
    dtype, dist_dtype = (torch.bfloat16, torch.int8) if control else (torch.float64, torch.int32)
    scale, n_levels = cfg.orb.scale_factor, cfg.orb.n_levels
    either = differ = 0
    for label, names in (("motion", MOTION_ARGS), ("local", LOCAL_ARGS)):
        for _, args, kwargs, res in calls[label]:
            a = dict(zip(names, args)) | kwargs
            lead = a["R"].dim() - 2
            got_all = rows(res.pt_idx, lead)
            keys = ("p3d", "desc", "octave", "angle", "valid") if label == "motion" else \
                ("p3d", "desc", "normal", "mind", "maxd", "valid", "pre")
            q_all = {k: rows(a[k], lead) for k in keys}
            R_all, t_all = rows(a["R"], lead), rows(a["t"], lead)
            for b in range(R_all.shape[0]):
                fd = _frame(a["fd"], lead, b)
                q = {k: v[b] for k, v in q_all.items()}
                if label == "motion":
                    want = ref.search_motion(cfg.camera, scale, fd, q, R_all[b], t_all[b])
                    got = (ref.search_motion(cfg.camera, scale, fd, q, R_all[b], t_all[b],
                                             dtype, dist_dtype) if control else got_all[b].long())
                else:
                    want = ref.search_local(cfg.camera, scale, n_levels, fd, q, R_all[b], t_all[b])
                    got = (ref.search_local(cfg.camera, scale, n_levels, fd, q, R_all[b],
                                            t_all[b], dtype, dist_dtype)
                           if control else got_all[b].long())
                either += int(((want >= 0) | (got >= 0)).sum())
                differ += int((want != got).sum())
    return {"match_mismatch_share": differ / either if either else 0.0}
