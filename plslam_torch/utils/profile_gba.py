"""Time the global BA solvers on the 256-keyframe synthetic map of
``chip_smoke.py``'s phase distributed, on one GPU.

    python -m plslam_torch.utils.profile_gba [--device cuda]

Gathers the map's whole-map problem as the loop closer does, then times
(host clock around a device sync, after one warm-up call each): one LM
iteration of the single-device PCG (``optim/ba_cg.py``) on the problem as
gathered, the same iteration on a copy whose padding observations are
spread over the cameras and points instead of all naming camera 0 and
point 0 (their weight is 0 either way), and one ``distributed_cg_step`` on
4 shards of the device. Prints one JSON line, with the card's name.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _timed(fn, dev):
    fn()  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m plslam_torch.utils.profile_gba")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    from ..config import SlamConfig
    from ..geometry.projection import Camera
    from ..models.local_mapping import LocalMapper
    from ..models.loop_closing import global_ba_caps
    from ..optim import ba_cg, local_ba
    from ..parallel import ba as pba
    from ..parallel.mesh import make_ba_mesh
    from .synthetic import make_synthetic_ba_map

    cfg = SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    m, _, _ = make_synthetic_ba_map(cfg, n_kf=256, n_pts=16384, obs_per_kf=1000, seed=1,
                                    device=dev)
    prob = LocalMapper(cfg, m).gather_ba(0, **global_ba_caps(m)).prob
    p64 = local_ba._astype(prob, local_ba.SOLVE_DTYPE)
    pad = ~p64.obs_valid
    k = torch.arange(int(pad.sum()), device=dev)
    spread = p64._replace(
        obs_cam=p64.obs_cam.masked_scatter(pad, k % p64.cam_R.shape[0]),
        obs_pt=p64.obs_pt.masked_scatter(pad, k % p64.pt_xyz.shape[0]))
    state = local_ba.ba_state_init(p64)
    cg_iters = cfg.mapping.ba_cg_iters
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
           "observations": int(p64.obs_valid.sum()), "padded_to": int(p64.obs_valid.numel()),
           "cg_iters": cg_iters}
    out["pcg_lm_iteration_s"] = _timed(
        lambda: ba_cg._lm_iteration_cg(cfg.camera, p64, state, True, cg_iters), dev)
    out["pcg_lm_iteration_spread_padding_s"] = _timed(
        lambda: ba_cg._lm_iteration_cg(cfg.camera, spread, local_ba.ba_state_init(spread),
                                       True, cg_iters), dev)
    host = [t.cpu().numpy() for t in (prob.cam_R, prob.cam_t, prob.cam_fixed | ~prob.cam_valid,
                                      prob.pt_xyz, prob.pt_valid, prob.obs_cam, prob.obs_pt,
                                      prob.obs_uv, prob.obs_ur, prob.obs_w, prob.obs_valid)]
    sharded = pba.place(pba.shard_problem(*host, n_shards=4), make_ba_mesh([dev] * 4))
    out["distributed_cg_step_s"] = _timed(
        lambda: pba.distributed_cg_step(cfg.camera, sharded, make_ba_mesh([dev] * 4),
                                        lam=1e-3, cg_iters=cg_iters), dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
