"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. build   — compile the CUDA kernels of plslam_torch/csrc with nvcc.
  2. kernels — each kernel against its plain PyTorch version on the card at
               the main path's shapes (exact equality), with the time per
               call, eager and replayed from a CUDA graph (the device's own
               time), beside the plain version's, a library yardstick and
               the bound (the least time the card could take for the same
               work): FAST as one launch for the 8 pyramid levels and each
               level alone, Hamming on windowed, 10%, dense and mixed gates
               with the count of tiles that took the tensor cores; and
               Hamming at the local mapper's shapes, with gates built as
               the mapper builds them from the room's keyframes: forward
               fusion 4096x1024, reverse fusion as ONE batched launch of
               10 x 2048x1024, an epipolar triangulation gate 1024x1024.
  3. main    — the 150-frame synthetic room (640x480 RGB-D, points+lines)
               through plslam_torch's Tracker with local_mapper=None, with
               the launch counts that prove both kernels ran on the path,
               tracked fps, per-frame latency and ATE against ground truth;
               then one step through the rescue stage, which the room
               never needs, forced by a wrong velocity prior.
  4. mapping — bench.py's own configuration: the same 150 frames through
               Tracker with AsyncLocalMapper(LocalMapper(...)) (fusion,
               triangulation, culling, local BA on a worker thread), with
               launch and run counts that prove fusion, the batched Hamming
               launch and BA ran, fps, latency, and ATE as tracked and as
               healed against the keyframes BA moved.
Then a JSON line of per-kernel numbers (launches: the mapping phase, which
is bench.py's path; the main phase's beside them), the card's name and
power limit, and as the last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without CUDA, when the package is
missing, or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM peaks: the HBM3 rate and the int8 tensor-core rate (NVIDIA data
# sheet); fp32 instructions that are not fused multiply-adds (sub, compare)
# issue at half the data sheet's FMA-counted 67 TFLOP/s, and fp32 min/max at
# half that again (64 per clock per SM: python -m plslam_torch.utils.mma_rate);
# __popc issues 16 per clock per SM on compute capability 9.0 (CUDA C++
# programming guide, arithmetic instruction throughput), on 132 SMs at the
# 1.98 GHz boost clock
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12 / 2
MINMAX_OPS_S = FP32_OPS_S / 2
INT8_TC_OPS_S = 1979e12
POPC_OPS_S = 132 * 16 * 1.98e9  # bounds only the sparse walk's per-pair cost
# FAST: every pixel costs the compass pre-test (4 sub, 8 compares, 8 and/or)
# and the 3x3 NMS, separable: a 3-wide row max then a 3-high max of those
# (4 max), and 1 compare; each side (bright, dark) that passes the
# pre-test costs the best of its 16 arc minima, 63 min/max when neighbouring
# arcs share their 7 common points (32 for 8 windows of 7, 3 a pair, 7 for
# the max), 1 sub and 1 compare
FAST_OPS_PER_PX, FAST_MINMAX_PER_PX = 21, 4
FAST_OPS_PER_SIDE, FAST_MINMAX_PER_SIDE = 2, 63
HAMMING_OPS_PER_PAIR = 2 * 256  # multiply-adds on unpacked bits
POPC_PER_PAIR = 8  # the sparse walk: one per 32-bit word of a descriptor
# the TPU kernels the CUDA kernels replace: the pl.pallas_call in the JAX
# package's module
REPLACES = {"fast_score_nms": "ops/pallas_fast.py:120",
            "hamming_top2": "ops/pallas_matching.py:116"}
N_FRAMES = 150  # bench.py's sequence
ATE_LIMITS_M = (0.012, 0.030)  # RMSE, max
REPS = 50


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps=REPS, warm=5):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=REPS):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed between two CUDA events, so that no host enqueue sits
    between the kernels. At these sizes a call's eager CUDA-event time
    (``cuda_ms``) is bound by how fast the host enqueues its launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(fn):
    """(eager CUDA-event ms, CUDA-graph device ms) per call of ``fn``."""
    return cuda_ms(fn), device_ms(fn)


def bound(nbytes, ops, ops_rate):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ate(est_centers, gt_centers):
    """RMSE and max of the camera-center error after Horn alignment (the
    TUM evaluate_ate protocol, no scale)."""
    a, b = est_centers.T.astype(np.float64), gt_centers.T.astype(np.float64)
    ca, cb = a.mean(1, keepdims=True), b.mean(1, keepdims=True)
    U, _, Vt = np.linalg.svd((a - ca) @ (b - cb).T)
    S = np.eye(3)
    if np.linalg.det(Vt.T @ U.T) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    err = np.linalg.norm(R @ (a - ca) + cb - b, axis=0)
    return float(np.sqrt((err**2).mean())), float(err.max())


def render_frames(cfg, n):
    from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

    scene = RoomScene(0)
    poses = smooth_trajectory(2 * n)[:n]
    f = cfg.tracking.depth_map_factor
    frames = []
    for R, t in poses:
        gray, depth = scene.render(cfg.camera, R, t)
        frames.append((np.clip(gray, 0, 255).astype(np.uint8),
                       np.clip(depth * f, 0, 65535).astype(np.uint16)))
    return frames, poses


def pretest_sides(img, th):
    """Bright and dark sides of the pixels 3 px inside ``img`` that pass
    FAST's compass pre-test (an adjacent pair of the 4 compass points beyond
    +-th on that side): the arcs the kernel evaluates."""
    import torch

    h, w = img.shape
    c = img[3:h - 3, 3:w - 3]
    d = [img[6:h, 3:w - 3] - c, img[3:h - 3, 6:w] - c,      # compass 0 (dy=3), 4 (dx=3)
         img[0:h - 6, 3:w - 3] - c, img[3:h - 3, 0:w - 6] - c]  # 8 (dy=-3), 12 (dx=-3)
    bright = torch.zeros_like(c, dtype=torch.bool)
    dark = torch.zeros_like(bright)
    for k in range(4):
        a, b = d[k], d[(k + 1) % 4]
        bright |= (a > th) & (b > th)
        dark |= (a < -th) & (b < -th)
    return int(bright.sum()) + int(dark.sum())


def fast_bound(npx, nsides):
    """(ms, what binds) for FAST on ``npx`` pixels with ``nsides`` passing
    sides: bytes read and written once against the operations, min/max
    counted at their half issue rate."""
    ops = (FAST_OPS_PER_PX * npx + FAST_OPS_PER_SIDE * nsides
           + (FAST_MINMAX_PER_PX * npx + FAST_MINMAX_PER_SIDE * nsides)
           * FP32_OPS_S / MINMAX_OPS_S)
    return bound(8 * npx, ops, FP32_OPS_S)


def check_fast(cfg, frames, dev):
    """Kernel vs plain at all 8 pyramid levels of rendered frames: the whole
    pyramid in one launch, and each level alone."""
    import torch

    from plslam_torch.ops import fast, image

    th = float(cfg.orb.min_th_fast)
    err = 0.0
    res = dict(name="fast_score_nms", route="cuda",
               source="plslam_torch/csrc/fast_score_nms.cu",
               replaces=REPLACES["fast_score_nms"], library_ms=None, library_device_ms=None)
    for k in (0, 40, 80):
        g = frames[k][0]
        g = ((g >> 2) << 2) + 2  # the tracker's 6-bit gray, half-step restored
        img = torch.as_tensor(g, device=dev).float()
        levels = image.build_pyramid(img, cfg.orb.n_levels, cfg.orb.scale_factor)
        before = fast.fast_score_nms.launches
        batched = fast.fast_score_nms_levels(levels, th)
        require(fast.fast_score_nms.launches == before + 1,
                "fast_score_nms_levels made more than one launch for 8 levels")
        for lvl, got_all in zip(levels, batched):
            got = fast.fast_score_nms(lvl, th)
            want = fast.fast_score_nms_plain(lvl, th)
            torch.cuda.synchronize()
            for what, x in (("batched", got_all), ("alone", got)):
                if not torch.equal(x, want):
                    raise AssertionError(f"fast_score_nms ({what}) differs at "
                                         f"{tuple(lvl.shape)}: "
                                         f"{(x != want).sum().item()} pixels")
                err = max(err, float((x - want).abs().max()))
        if k:
            continue
        npx = nsides = 0
        for lvl in levels:
            h, w = lvl.shape
            n_s = pretest_sides(lvl, th)
            npx, nsides = npx + h * w, nsides + n_s
            t_k, d_k = timings(lambda: fast.fast_score_nms(lvl, th))
            t_p, d_p = timings(lambda: fast.fast_score_nms_plain(lvl, th))
            b, by = fast_bound(h * w, n_s)
            log(f"  fast_score_nms {h}x{w} alone: {n_s} sides of {h * w} px pass the "
                f"pre-test; kernel {t_k:.4f} ms (device {d_k:.4f}), plain {t_p:.4f} ms "
                f"(device {d_p:.4f}), bound {b * 1e3:.3f} us ({by})")
        t_k, d_k = timings(lambda: fast.fast_score_nms_levels(levels, th))
        t_p, d_p = timings(lambda: [fast.fast_score_nms_plain(x, th) for x in levels])
        b, by = fast_bound(npx, nsides)
        shapes = ", ".join(f"{h}x{w}" for h, w in (x.shape for x in levels))
        log(f"  fast_score_nms_levels, 8 levels in one launch ({npx} px, {nsides} sides "
            f"pass the pre-test): kernel {t_k:.4f} ms (device {d_k:.4f}), plain "
            f"{t_p:.4f} ms (device {d_p:.4f}), bound {b * 1e3:.3f} us ({by})")
        res.update(ms=t_k, device_ms=d_k, plain_ms=t_p, plain_device_ms=d_p, bound_ms=b,
                   bound_by=by, pixels=npx, pretest_sides=nsides,
                   shapes=f"8 pyramid levels in one launch: {shapes}")
    res["max_abs_err"] = err
    return res


def check_hamming(cfg, frames, dev):
    """Kernel vs plain at the motion shape, the local-map shape with a
    windowed gate, the same at a uniform 10% density (every tile on the
    sparse walk), the rescue's dense gate, a mixed gate (a dense band of
    1024 rows, the rest windowed), and a ragged shape with planted ties."""
    import torch

    from plslam_torch.models import frame as mframe
    from plslam_torch.ops import hamming

    rng = np.random.default_rng(0)
    g, d = frames[0]
    fd = mframe.build_frame(torch.as_tensor(g, device=dev),
                            torch.as_tensor(d.astype(np.int32), device=dev), cfg)
    t_desc = fd.kp_desc
    t_uv = fd.kp_xy_un
    kp_valid = fd.kp_valid[None, :]
    cases = {}
    # motion match: previous-frame queries vs this frame, 15 px windows
    q_uv = t_uv + torch.as_tensor(rng.normal(0, 4, (1024, 2)), dtype=torch.float32, device=dev)
    q = t_desc.clone()
    flip = torch.as_tensor(rng.random((1024, 32)) < 0.05, device=dev)
    q = torch.where(flip, q ^ 0x10, q)
    win = ((q_uv[:, None] - t_uv[None]).abs() < 15.0).all(-1)
    cases["1024x1024"] = (q, t_desc, win & kp_valid, False)
    # local map: 8192 landmarks spread over the image, 12 px windows
    lm_uv = torch.as_tensor(rng.uniform([0, 0], [640, 480], (8192, 2)),
                            dtype=torch.float32, device=dev)
    lm = torch.as_tensor(rng.integers(0, 256, (8192, 32), dtype=np.uint8), device=dev)
    lm[:1024] = q  # a realistic share of near-duplicate descriptors
    lm = lm.contiguous()
    windowed = ((lm_uv[:, None] - t_uv[None]).abs() < 12.0).all(-1) & kp_valid
    cases["8192x1024"] = (lm, t_desc, windowed, False)
    # the sparse walk's cost per pair: ~10% of the pairs, below the dense
    # threshold in every 16 x 512 tile
    cases["8192x1024 10%"] = (lm, t_desc, torch.as_tensor(
        rng.random((8192, 1024)) < 0.1, device=dev) & kp_valid, False)
    # rescue: the full local map against every keypoint, no window
    # (lm_valid x kp_valid, here with every slot of the local map filled)
    cases["8192x1024 dense"] = (lm, t_desc, kp_valid.expand(8192, -1).contiguous(), True)
    mixed = windowed.clone()
    mixed[2048:3072] = kp_valid
    cases["8192x1024 mixed"] = (lm, t_desc, mixed, True)
    # ragged, with planted ties on the best distance
    tq = torch.as_tensor(rng.integers(0, 256, (1000, 32), dtype=np.uint8), device=dev)
    tt = torch.as_tensor(rng.integers(0, 256, (777, 32), dtype=np.uint8), device=dev)
    tt[100:200] = tq[:100]
    tt[300:400] = tq[:100]  # each of the first 100 queries has two exact twins
    gate = torch.as_tensor(rng.random((1000, 777)) < 0.5, device=dev)
    gate[:100, 100:200] = True
    gate[:100, 300:400] = True
    gate[7] = False  # a fully gated row
    cases["1000x777"] = (tq, tt.contiguous(), gate, True)

    out = None
    hamming.dense_tiles()
    for name, (qq, tt_, gg, dense) in cases.items():
        got = hamming.hamming_top2(qq, tt_, gg)
        tiles = hamming.dense_tiles()
        want = hamming.hamming_top2_plain(qq, tt_, gg)
        torch.cuda.synchronize()
        for a, b, what in zip(got, want, ("best", "idx", "second")):
            if not torch.equal(a, b):
                raise AssertionError(f"hamming_top2 {what} differs at {name}: "
                                     f"{(a != b).sum().item()} rows")
        require((tiles > 0) == dense, f"hamming_top2 {name}: {tiles} dense tiles")
        n, m = gg.shape
        nnz = int(gg.sum())
        t_k, d_k = timings(lambda: hamming.hamming_top2(qq, tt_, gg))
        hamming.dense_tiles()
        t_p, d_p = timings(lambda: hamming.hamming_top2_plain(qq, tt_, gg))
        qb = hamming.unpack_bits(qq).float()
        tb = hamming.unpack_bits(tt_).float().T.contiguous()
        t_l, d_l = timings(lambda: torch.matmul(qb, tb))
        b, by = bound(32 * n + 32 * m + n * m + 12 * n, HAMMING_OPS_PER_PAIR * nnz,
                      INT8_TC_OPS_S)
        log(f"  hamming_top2 {name}: gated {nnz} pairs, {tiles} of "
            f"{-(-n // 16) * -(-m // 512)} tiles on the tensor cores; kernel "
            f"{t_k:.4f} ms (device {d_k:.4f}), plain {t_p:.4f} ms (device {d_p:.4f}), "
            f"matmul on unpacked bits {t_l:.4f} ms (device {d_l:.4f}), bound "
            f"{b * 1e3:.3f} us ({by}; the sparse walk's __popc floor "
            f"{POPC_PER_PAIR * nnz / POPC_OPS_S * 1e6:.3f} us)")
        if name == "8192x1024":
            out = dict(name="hamming_top2", route="cuda",
                       source="plslam_torch/csrc/hamming_top2.cu",
                       replaces=REPLACES["hamming_top2"],
                       max_abs_err=0.0, ms=t_k, device_ms=d_k, plain_ms=t_p,
                       plain_device_ms=d_p, bound_ms=b, bound_by=by,
                       library_ms=t_l, library_device_ms=d_l,
                       shapes="8192x1024 local-map match (also checked at "
                              "1024x1024, 8192x1024 at 10%, with the rescue's "
                              "dense gate and mixed, and 1000x777)")
    return out


def _keyframe(cfg, frame, pose, dev):
    """FrameData of a rendered frame on the card, with its pose tensors."""
    import torch

    from plslam_torch.models import frame as mframe

    g, d = frame
    fd = mframe.build_frame(torch.as_tensor(g, device=dev),
                            torch.as_tensor(d.astype(np.int32), device=dev), cfg)
    R, t = (torch.as_tensor(np.asarray(x, np.float32), device=dev) for x in pose)
    return fd, R, t


def _landmarks(cfg, kfs, cap):
    """Map points as the tracker mints them from depth (world position,
    descriptor, scale band) from keyframes ``kfs``, at most ``cap``, padded
    to ``cap`` with invalid rows, as the mapper pads its candidates."""
    import torch

    from plslam_torch.geometry import projection as gproj

    scale, top = cfg.orb.scale_factor, cfg.orb.n_levels - 1
    p3d, desc, maxd = [], [], []
    for fd, R, t in kfs:
        ok = fd.kp_valid & (fd.kp_depth > 0)
        pc = gproj.backproject(cfg.camera, fd.kp_xy_un[ok], fd.kp_depth[ok])
        pw = (pc - t) @ R  # R^T (pc - t)
        p3d.append(pw)
        desc.append(fd.kp_desc[ok])
        maxd.append(torch.linalg.vector_norm(pc, dim=-1) * scale ** fd.kp_octave[ok].float())
    p3d, desc, maxd = (torch.cat(x)[:cap] for x in (p3d, desc, maxd))
    k = p3d.shape[0]
    pad = cap - k
    dev = p3d.device
    return (torch.cat([p3d, torch.zeros(pad, 3, device=dev)]),
            torch.cat([desc, torch.zeros(pad, 32, dtype=torch.uint8, device=dev)]),
            torch.cat([maxd / scale**top, torch.zeros(pad, device=dev)]),
            torch.cat([maxd, torch.zeros(pad, device=dev)]),
            torch.arange(cap, device=dev) < k)


def check_mapping_shapes(cfg, frames, poses, dev):
    """Hamming top-2 at the local mapper's three shapes, gates built as the
    mapper builds them (models/local_mapping.py, models/triangulation.py)
    from 11 keyframes of the room at their true poses:
    - forward fusion: landmarks of 10 keyframes (4096, padded) into the
      newest keyframe's 1024 features, 3 px x scale^level window;
    - reverse fusion: the newest keyframe's 2048 landmarks into the 10
      others at once, 5 px window, ONE batched launch;
    - triangulation: the epipolar gate of the newest keyframe against a
      neighbour 1024 x 1024 (every valid feature a candidate).
    Each equals its plain version exactly. Returns one record per shape."""
    import torch

    from plslam_torch.models import local_mapping as tlm
    from plslam_torch.models import triangulation as ttri
    from plslam_torch.ops import hamming

    kfs = [_keyframe(cfg, frames[i], poses[i], dev) for i in range(0, 110, 10)]
    new, others = kfs[-1], kfs[:-1]
    fd0, R0, t0 = new
    cases = []
    p3d, desc, mind, maxd, valid = _landmarks(cfg, others, tlm.POINT_CAP)
    g = tlm.fuse_gate(cfg, fd0.kp_xy_un, fd0.kp_octave, fd0.kp_valid, p3d, mind, maxd,
                       valid, R0, t0, tlm.FUSE_TH_PX)
    cases.append(("4096x1024 forward fusion", "hamming_top2", (desc, fd0.kp_desc, g)))
    p3d, desc, mind, maxd, valid = _landmarks(cfg, [new], tlm.REVERSE_CAP)
    st = lambda name: torch.stack([getattr(f, name) for f, _, _ in others])  # noqa: E731
    Rs = torch.stack([R for _, R, _ in others])
    ts = torch.stack([t for _, _, t in others])
    g = tlm.fuse_gate(cfg, st("kp_xy_un"), st("kp_octave"), st("kp_valid"), p3d, mind, maxd,
                       valid, Rs, ts, 5.0).contiguous()
    cases.append((f"{len(others)} x 2048x1024 reverse fusion, one batched launch",
                  "hamming_top2_batched", (desc, st("kp_desc"), g)))
    fd1, R1, t1 = others[-1]
    g = ttri.epipolar_gate(cfg, fd0.kp_xy_un, fd0.kp_octave, fd0.kp_valid, R0, t0,
                           fd1.kp_xy_un, fd1.kp_octave, fd1.kp_valid, R1, t1)
    cases.append(("1024x1024 epipolar triangulation", "hamming_top2", (fd0.kp_desc,
                                                                       fd1.kp_desc, g)))
    out = []
    hamming.dense_tiles()
    for name, fn_name, (q, t, gate) in cases:
        fn = getattr(hamming, fn_name)
        plain = getattr(hamming, fn_name + "_plain")
        got = fn(q, t, gate)
        tiles = hamming.dense_tiles()
        want = plain(q, t, gate)
        torch.cuda.synchronize()
        for a, b, what in zip(got, want, ("best", "idx", "second")):
            if not torch.equal(a, b):
                raise AssertionError(f"{fn_name} {what} differs at {name}: "
                                     f"{(a != b).sum().item()} rows")
        n, m = gate.shape[-2:]
        batch = gate.numel() // (n * m)
        nnz = int(gate.sum())
        t_k, d_k = timings(lambda: fn(q, t, gate))
        hamming.dense_tiles()
        t_p, d_p = timings(lambda: plain(q, t, gate))
        b, by = bound(gate.numel() + 32 * n + 32 * batch * m + 12 * batch * n,
                      HAMMING_OPS_PER_PAIR * nnz, INT8_TC_OPS_S)
        log(f"  {fn_name} {name}: gated {nnz} pairs, {int((got[0] <= 50).sum())} rows "
            f"within the fusion distance, {tiles} of {batch * -(-n // 16) * -(-m // 512)} tiles "
            f"on the tensor cores; kernel {t_k:.4f} ms (device {d_k:.4f}), plain {t_p:.4f} ms "
            f"(device {d_p:.4f}), bound {b * 1e3:.3f} us ({by})")
        out.append(dict(shape=name, launch=fn_name, gated_pairs=nnz, dense_tiles=tiles,
                        ms=t_k, device_ms=d_k, plain_ms=t_p, plain_device_ms=d_p,
                        bound_ms=b, bound_by=by))
    return out


def floors(cfg, dev):
    """Device times of calls whose work is all fixed cost: a 7x9 FAST level
    (one block), a flat 640x480 pyramid (every pixel fails the pre-test, so
    no arc is evaluated), a 16x16 Hamming call and an 8192x1024 one whose
    gate is all false (the gate is read, no pair is computed), and torch's
    zero_ of that gate (one pass over its 8.4 MB)."""
    import torch

    from plslam_torch.ops import fast, hamming, image

    th = float(cfg.orb.min_th_fast)
    rng = np.random.default_rng(1)
    tiny = torch.as_tensor(rng.integers(0, 256, (7, 9)).astype(np.float32), device=dev)
    flat = image.build_pyramid(torch.full((480, 640), 128.0, device=dev),
                               cfg.orb.n_levels, cfg.orb.scale_factor)
    q = torch.as_tensor(rng.integers(0, 256, (8192, 32), dtype=np.uint8), device=dev)
    t = torch.as_tensor(rng.integers(0, 256, (1024, 32), dtype=np.uint8), device=dev)
    off = torch.zeros(8192, 1024, dtype=torch.bool, device=dev)
    off16 = torch.zeros(16, 16, dtype=torch.bool, device=dev)
    for name, fn in (("fast_score_nms 7x9", lambda: fast.fast_score_nms(tiny, th)),
                     ("fast_score_nms_levels flat 640x480 pyramid",
                      lambda: fast.fast_score_nms_levels(flat, th)),
                     ("hamming_top2 16x16 nothing gated",
                      lambda: hamming.hamming_top2(q[:16], t[:16], off16)),
                     ("hamming_top2 8192x1024 nothing gated",
                      lambda: hamming.hamming_top2(q, t, off)),
                     ("torch zero_ of the 8192x1024 gate", lambda: off.zero_())):
        log(f"  floor {name}: device {device_ms(fn) * 1e3:.2f} us")
    require(hamming.dense_tiles() == 0, "dense tiles on an empty gate")


def main_path(cfg, frames, poses, dev):
    import torch

    from plslam_torch.models.map import SlamMap
    from plslam_torch.models.tracking import OK, Tracker
    from plslam_torch.ops import fast, hamming

    m = SlamMap(cfg, device=dev)
    tracker = Tracker(cfg, m)
    n = len(frames)
    _reset_counts()
    per_frame = []
    t0 = time.perf_counter()
    for i, (g, d) in enumerate(frames):
        s = time.perf_counter()
        tracker.process(g, d, i / 30.0)
        per_frame.append(time.perf_counter() - s)
    tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fast_score_nms": fast.fast_score_nms.launches,
                "hamming_top2": hamming.hamming_top2.launches}
    dense_tiles = hamming.dense_tiles()
    rows = len(tracker.trajectory)
    require(rows == n, f"trajectory has {rows} rows for {n} frames")
    require(tracker.state == OK, f"tracker state {tracker.state} after the run")
    require(m.n_kf >= 3, f"{m.n_kf} keyframes")
    require(m.n_lines() > 0, "no map lines")
    est = np.array([-(R.T @ t) for _, R, t in tracker.trajectory])
    gt = np.array([-(R.T @ t) for R, t in poses])
    require(np.isfinite(est).all(), "non-finite camera centres")
    rmse, mx = ate(est, gt)
    require(rmse < ATE_LIMITS_M[0] and mx < ATE_LIMITS_M[1],
            f"ATE rmse {rmse:.4f} m max {mx:.4f} m")
    built = n  # every process() call builds one frame
    tracked = n - 1  # every frame after the initializing one is dispatched
    require(launches["fast_score_nms"] == built, f"launches {launches}")  # one per frame
    require(launches["hamming_top2"] == 3 * tracked, f"launches {launches}")
    ms = np.array(per_frame[1:]) * 1e3  # the first frame initializes
    return dict(frames=n, tracked=rows, keyframes=m.n_kf, points=m.n_points(),
                lines=m.n_lines(), fps=n / wall, p50_ms=float(np.percentile(ms, 50)),
                p90_ms=float(np.percentile(ms, 90)), ate_rmse_cm=rmse * 100,
                ate_max_cm=mx * 100, launches=launches, hamming_dense_tiles=dense_tiles,
                rescue=rescue_step(cfg, tracker, frames[-1], dev))


def _reset_counts():
    from plslam_torch.ops import fast, hamming
    from plslam_torch.optim import local_ba

    fast.fast_score_nms.launches = 0
    hamming.hamming_top2.launches = 0
    hamming.hamming_top2_batched.launches = 0
    local_ba.bundle_adjust_stepped.runs = 0
    hamming.dense_tiles()


def mapping_path(cfg, frames, poses, dev):
    """bench.py's configuration: Tracker with AsyncLocalMapper(LocalMapper)
    over the 150 frames; every count is set to 0 just before the run and
    read after the mapper has drained."""
    import torch

    from plslam_torch.models.async_mapping import AsyncLocalMapper
    from plslam_torch.models.local_mapping import LocalMapper
    from plslam_torch.models.map import SlamMap
    from plslam_torch.models.tracking import OK, Tracker
    from plslam_torch.ops import fast, hamming
    from plslam_torch.optim import local_ba

    m = SlamMap(cfg, device=dev)
    mapper = AsyncLocalMapper(LocalMapper(cfg, m))
    tracker = Tracker(cfg, m, local_mapper=mapper)
    n = len(frames)
    _reset_counts()
    per_frame = []
    t0 = time.perf_counter()
    for i, (g, d) in enumerate(frames):
        s = time.perf_counter()
        tracker.process(g, d, i / 30.0)
        per_frame.append(time.perf_counter() - s)
    tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mapper.wait_idle()
    mapper.shutdown()
    torch.cuda.synchronize()
    drained = time.perf_counter() - t0
    launches = {"fast_score_nms": fast.fast_score_nms.launches,
                "hamming_top2": hamming.hamming_top2.launches,
                "hamming_top2_batched": hamming.hamming_top2_batched.launches}
    ba_runs = local_ba.bundle_adjust_stepped.runs
    dense_tiles = hamming.dense_tiles()
    require(mapper.error is None, f"local mapping failed: {mapper.error!r}")
    require(not mapper._thread.is_alive(), "the mapper thread did not stop")
    rows = len(tracker.trajectory)
    require(rows == n, f"trajectory has {rows} rows for {n} frames")
    require(tracker.state == OK, f"tracker state {tracker.state} after the run")
    require(mapper.inner.fuse_passes >= 1, "no fusion pass ran")
    require(ba_runs >= 1, "no local BA ran")
    require(launches["fast_score_nms"] == n, f"launches {launches}")
    require(launches["hamming_top2"] > 3 * (n - 1), f"launches {launches}: no mapper launch")
    require(launches["hamming_top2_batched"] >= 1, f"launches {launches}: no batched launch")
    gt = np.array([-(R.T @ t) for R, t in poses])
    res = {}
    for what, traj in (("tracked", tracker.trajectory), ("healed", tracker.healed_trajectory())):
        est = np.array([-(R.T @ t) for _, R, t in traj])
        require(np.isfinite(est).all(), f"non-finite {what} camera centres")
        rmse, mx = ate(est, gt)
        require(rmse < ATE_LIMITS_M[0] and mx < ATE_LIMITS_M[1],
                f"{what} ATE rmse {rmse:.4f} m max {mx:.4f} m")
        res[f"ate_{what}_rmse_cm"], res[f"ate_{what}_max_cm"] = rmse * 100, mx * 100
    ms = np.array(per_frame[1:]) * 1e3
    return dict(frames=n, tracked=rows, fps=n / wall, seconds_to_drain=drained,
                p50_ms=float(np.percentile(ms, 50)), p90_ms=float(np.percentile(ms, 90)),
                max_ms=float(ms.max()), keyframes=m.n_kf,
                keyframes_valid=int(m.kf_valid.sum()), points=m.n_points(),
                lines=m.n_lines(), fuse_passes=mapper.inner.fuse_passes, ba_runs=ba_runs,
                launches=launches, hamming_dense_tiles=dense_tiles, **res)


def rescue_step(cfg, tracker, frame, dev):
    """The rescue stage on the card, which the room never needs: the last
    frame tracked again from the last pose with a wrong velocity prior
    (0.4 m sideways, 20 degrees of yaw) starves the motion stage, and the
    windowless local-map match must carry the frame back onto its pose."""
    import torch

    from plslam_torch.models.tracking import fused_track_step
    from plslam_torch.ops import hamming

    c, s = np.cos(np.radians(20.0)), np.sin(np.radians(20.0))
    args = list(tracker.dispatch_args())
    args[7:10] = [torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=torch.float32,
                               device=dev),
                  torch.tensor([0.4, 0.0, 0.0], device=dev), True]
    gray, depth = tracker._quantize_inputs(*frame)
    before = hamming.hamming_top2.launches
    hamming.dense_tiles()
    out = fused_track_step(cfg, torch.from_numpy(gray).to(dev),
                           torch.from_numpy(depth.astype(np.int32)).to(dev), *args)
    stats = out.stats.cpu().numpy()
    calls = hamming.hamming_top2.launches - before
    tiles = hamming.dense_tiles()
    _, R, t = tracker.trajectory[-1]
    dt = float(np.abs(out.t.cpu().numpy() - t).max())
    require(stats[5] > 100 and stats[1] == stats[5],
            f"rescue did not carry the frame: stats {stats.tolist()}")
    require(calls == 4, f"{calls} hamming_top2 launches in a rescued step")
    require(dt < 0.005, f"rescued pose {dt:.4f} m off the tracked one")
    return dict(motion_matches=int(stats[0]), rescue_inliers=int(stats[5]),
                local_inliers=int(stats[2]), hamming_launches=calls,
                hamming_dense_tiles=tiles, pose_err_m=dt)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from plslam_torch.config import SlamConfig
    from plslam_torch.geometry.projection import Camera
    from plslam_torch.ops import cuda_build

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, cuda {torch.version.cuda}")

    t = cuda_build.build(verbose=True)
    log(f"phase build: ok, {t:.1f} s for {len(cuda_build.KERNELS)} kernels")

    cfg = SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    t0 = time.perf_counter()
    frames, poses = render_frames(cfg, N_FRAMES)
    log(f"rendered {N_FRAMES} frames 640x480 in {time.perf_counter() - t0:.1f} s")

    kernels = [check_fast(cfg, frames, dev), check_hamming(cfg, frames, dev)]
    kernels[1]["mapping_shapes"] = check_mapping_shapes(cfg, frames, poses, dev)
    floors(cfg, dev)
    log("phase kernels: ok, both kernels exactly equal to their plain versions, "
        "Hamming also batched and at the mapper's shapes")

    res = main_path(cfg, frames, poses, dev)
    log("phase main: ok, " + json.dumps(res))
    mres = mapping_path(cfg, frames, poses, dev)
    log("phase mapping: ok, " + json.dumps(mres))
    kernels[0]["launches"] = mres["launches"]["fast_score_nms"]
    kernels[0]["launches_main_phase"] = res["launches"]["fast_score_nms"]
    kernels[1]["launches"] = (mres["launches"]["hamming_top2"]
                              + mres["launches"]["hamming_top2_batched"])
    kernels[1]["launches_batched"] = mres["launches"]["hamming_top2_batched"]
    kernels[1]["launches_main_phase"] = res["launches"]["hamming_top2"]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
