"""Shared helpers of the port's loop-closing tests (not a test module): the
orbit of tests/test_loop_closing.py and its severed-map scenario, on a
plslam_torch map, without JAX."""

import numpy as np

# the old sector's displacement in tests/test_loop_closing.py: yaw 0.10 rad
# and t = (0.15, 0, -0.12)
W_R = np.array([[np.cos(0.1), 0, np.sin(0.1)], [0, 1, 0], [-np.sin(0.1), 0, np.cos(0.1)]],
               np.float32)
W_t = np.array([0.15, 0.0, -0.12], np.float32)


def orbit_poses(n, radius=0.45):
    """tests/test_loop_closing.py::orbit_poses: world-to-camera poses
    orbiting the room's centre, a full turn of yaw in n - 30 frames."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / (n - 30)
        c = np.array([radius * np.sin(a), 0.0, 1.25 + radius * np.cos(a)], np.float32)
        ca, sa = np.cos(a), np.sin(a)
        R = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32).T
        poses.append((R, (-R @ c).astype(np.float32)))
    return poses


def revisit_order(last=149, first=120):
    """Orbit frame indices inside the revisited sector, from the last frame
    tracked down to ``first`` and back up, repeated (chip_smoke.py's
    phase loop feeds the same order)."""
    cycle = list(range(last - 1, first - 1, -1)) + list(range(first + 1, last + 1))
    i = 0
    while True:
        yield cycle[i % len(cycle)]
        i += 1


def walk_to(a, b):
    """Frame indices one step at a time from just after ``a`` to ``b``."""
    step = 1 if b >= a else -1
    return list(range(a + step, b + step, step))


def render_orbit(scene, cam, poses, depth_factor):
    """uint8 gray and uint16 depth frames of ``poses``."""
    out = []
    for R, t in poses:
        g, d = scene.render(cam, R, t)
        out.append((np.clip(g, 0, 255).astype(np.uint8),
                    np.clip(d * depth_factor, 0, 65535).astype(np.uint16)))
    return out


def sever_and_displace(m, kf_cut, W_R, W_t, drop_loop_edges=False):
    """tests/test_loop_closing.py::sever_and_displace (s = 1) on a port
    map: landmarks shared across the cut are split, cross-sector line
    observations dropped, the old sector displaced rigidly by W. With
    ``drop_loop_edges``, which the JAX helper does not do, loop edges across
    the cut are dropped as well (tests/torch_sever_replay.py compares the
    two)."""
    desc_arena = m.point_desc_arena().cpu().numpy()
    for pid in list(m.point_ids()):
        obs = m.pt_obs[pid]
        old_obs = {k: f for k, f in obs.items() if k < kf_cut}
        new_obs = {k: f for k, f in obs.items() if k >= kf_cut}
        if old_obs and new_obs:
            dup = m.add_point(m.pt_pos[pid].copy(), desc_arena[pid].copy(), m.pt_normal[pid],
                              m.pt_min_dist[pid], m.pt_max_dist[pid], min(old_obs))
            for k, f in old_obs.items():
                m.pt_obs[pid].pop(k)
                m.add_point_obs(dup, k, f)
            m.pt_first_kf[pid] = min(new_obs)
    for lid in list(m.line_ids()):
        obs = m.ln_obs[lid]
        old = [k for k in obs if k < kf_cut]
        if old and any(k >= kf_cut for k in obs):
            for k in old:
                f = obs.pop(k)
                if m.kf_ln_idx[k, f] == lid:
                    m.kf_ln_idx[k, f] = -1
            if m.ln_first_kf[lid] < kf_cut:
                m.ln_first_kf[lid] = min(obs) if obs else kf_cut
    for k in range(kf_cut):
        if m.kf_valid[k]:
            R, t = m.kf_R[k], m.kf_t[k]
            m.set_kf_pose(k, R @ W_R, R @ W_t + t)
    pids = m.point_ids()
    sel = pids[m.pt_first_kf[pids] < kf_cut]
    m.pt_pos[sel] = (m.pt_pos[sel] - W_t) @ W_R
    lids = m.line_ids()
    lsel = lids[m.ln_first_kf[lids] < kf_cut]
    for i in (0, 1):
        m.ln_ep[lsel, i] = (m.ln_ep[lsel, i] - W_t) @ W_R
    if drop_loop_edges:
        # a loop closed during the orbit across the cut stays an
        # essential-graph edge between the sectors otherwise
        m.loop_edges = [(a, b) for a, b in m.loop_edges if (a < kf_cut) == (b < kf_cut)]


def anchor_err(R_arr, t_arr, a, b, gt_R, gt_t):
    """Translation error of the a-vs-b relative pose against ground truth's
    (tests/test_loop_closing.py's _cross_sector_err)."""
    Rab = R_arr[a] @ R_arr[b].T
    tab = t_arr[a] - Rab @ t_arr[b]
    Rab0 = gt_R[a] @ gt_R[b].T
    return float(np.linalg.norm(tab - (gt_t[a] - Rab0 @ gt_t[b])))


def kf0_relative_err(m, pose, poses):
    """The last pose relative to keyframe 0 against ground truth's last
    pose relative to its first (tests/test_loop_closing.py's
    _rel_err_vs_gt): invariant to gauge motion."""
    Re, te = pose
    Rrel_e = Re @ m.kf_R[0].T
    trel_e = te - Rrel_e @ m.kf_t[0]
    (Rg, tg), (R0g, t0g) = poses[-1], poses[0]
    Rrel_g = Rg @ R0g.T
    trel_g = tg - Rrel_g @ t0g
    return float(np.linalg.norm(-Rrel_e.T @ trel_e + Rrel_g.T @ trel_g))
