"""Offline visualization — the port of the JAX package's ``utils/viewer.py``,
the headless stand-in for the reference's Pangolin Viewer / FrameDrawer /
MapDrawer (Viewer.cc, FrameDrawer.cc, MapDrawer.cc). Renders the map
(points, lines as segments, keyframes, trajectory) and per-frame overlays
to PNG via matplotlib, from the map's host arrays. matplotlib is imported
inside the functions only: nothing else of the port needs it."""

from __future__ import annotations

import numpy as np
import torch


def draw_map(slam_map, trajectory=None, path: str = "map.png",
             show_lines: bool = True, show_graph: bool = False):
    """Top-down (x-z) map view: points, lines, keyframes, trajectory.

    ``show_graph`` overlays the covisibility graph (edges between
    keyframes sharing >=100 points), the spanning tree, and loop edges —
    MapDrawer::DrawKeyFrames graph rendering
    (MapDrawer.cc:133-228)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    pids = slam_map.point_ids()
    if len(pids):
        p = slam_map.pt_pos[pids]
        ax.scatter(p[:, 0], p[:, 2], s=1, c="k", alpha=0.4, label="points")
    if show_lines:
        lids = slam_map.line_ids()
        for l in lids:
            ep = slam_map.ln_ep[l]
            ax.plot(ep[:, 0], ep[:, 2], "r-", lw=1.2)
    centers = {}
    for k in range(slam_map.n_kf):
        if slam_map.kf_valid[k]:
            c = slam_map.kf_camera_center(k)
            centers[k] = c
            ax.plot(c[0], c[2], "b^", ms=3)
    if show_graph:
        # covisibility edges >=100 shared points (MapDrawer.cc:141-160)
        for k in centers:
            for o, w in slam_map.covisibility_counts(k).items():
                if w >= 100 and o > k and o in centers:
                    a, b = centers[k], centers[o]
                    ax.plot([a[0], b[0]], [a[2], b[2]],
                            "-", c="tab:green", lw=0.4, alpha=0.5)
        # spanning tree (MapDrawer.cc:163-176)
        for k in centers:
            p = int(slam_map.kf_parent[k])
            if p >= 0 and p in centers:
                a, b = centers[k], centers[p]
                ax.plot([a[0], b[0]], [a[2], b[2]],
                        "-", c="tab:blue", lw=0.6, alpha=0.7)
        # loop edges (MapDrawer.cc:179-193)
        for (i, j) in getattr(slam_map, "loop_edges", []):
            if i in centers and j in centers:
                a, b = centers[i], centers[j]
                ax.plot([a[0], b[0]], [a[2], b[2]],
                        "-", c="tab:red", lw=1.4)
    if trajectory is not None:
        cs = np.array([-R.T @ t for _, R, t in trajectory])
        if len(cs):
            ax.plot(cs[:, 0], cs[:, 2], "g-", lw=1, label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def draw_frame(gray, fd, path: str = "frame.png", status: str | None = None):
    """Keypoint + keyline overlay (FrameDrawer.cc:43-253 equivalent).

    ``status``: optional status-bar text rendered below the image — the
    FrameDrawer::DrawTextInfo bar (state, KFs, MPs, matches;
    FrameDrawer.cc:255-296). Build one with :func:`status_text`. ``fd``: a
    FrameData or HostFrame, on any device."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(_np(gray), cmap="gray")
    kp = _np(fd.kp_xy)
    v = _np(fd.kp_valid)
    ax.plot(kp[v, 0], kp[v, 1], "g.", ms=2)
    ep = _np(fd.ln_ep)
    lv = _np(fd.ln_valid)
    for e in ep[lv]:
        ax.plot(e[:, 0], e[:, 1], "r-", lw=1.5)
    ax.set_axis_off()
    if status:
        ax.text(0.0, -0.03, status, transform=ax.transAxes,
                fontsize=9, family="monospace", va="top",
                bbox=dict(facecolor="black", alpha=0.8, pad=3),
                color="white")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


_STATE_NAMES = {-1: "SYSTEM NOT READY", 0: "NOT INITIALIZED",
                1: "SLAM MODE", 2: "LOST"}


def status_text(tracker, slam_map) -> str:
    """FrameDrawer::DrawTextInfo content (FrameDrawer.cc:255-296):
    tracking state, keyframe/map-point/line counts, frame matches."""
    st = _STATE_NAMES.get(int(tracker.state), str(tracker.state))
    nm = 0
    if tracker.last_pt_ids is not None:
        nm = int((tracker.last_pt_ids >= 0).sum())
    return (f"{st} | KFs: {int(slam_map.n_kf)} "
            f"MPs: {int(slam_map.n_points())} "
            f"MLs: {int(slam_map.n_lines())} Matches: {nm}")
