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
               10 x 2048x1024, an epipolar triangulation gate 1024x1024;
               and at relocalization's shape, a frame's 1024 features
               against a keyframe's 1024 with the dense gate kp_valid x
               has_point. Each Hamming shape also times torch.matmul on the
               unpacked bits, the library yardstick.
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
  5. stereo  — the stereo sensor on tests/test_stereo.py's scenario at its
               width (640x480, bf 40; 25 pairs of the room, the right image
               rendered bf / fx to the right): frame 0's stereo depth on the
               card (> 200 keypoints, median relative error < 3%), then the
               pairs through System(sensor="stereo").track_stereo: state OK,
               >= 1 keyframe, >= 23 rows, ATE < 3 cm, two FAST launches and
               one stereo-band Hamming launch a frame; fps and latency.
     mono    — the monocular sensor on tests/test_mono.py's scenario (40
               frames) through System(sensor="mono").track_monocular:
               fix_scale off, the bootstrap's frame, model and score ratio,
               state OK, >= 2 keyframes, > 100 points, >= 30 rows, < 5 cm
               after a similarity alignment, >= 1 epipolar Hamming launch
               from the mapper; three identical frames stay NOT_INITIALIZED.
               Then kernel 2 on the inputs these phases gave it (the stereo
               band, the bootstrap's 100 px window, the epipolar gate),
               each exactly equal to its plain version, timed.
  6. reloc   — relocalization and localization-only tracking, through
               Tracker(cfg, m, local_mapper=LocalMapper(cfg, m, kfdb=kfdb),
               voc=voc, kfdb=kfdb) with the port's default vocabulary and
               no lines. Blackout: 15 tracked frames, 4 blackout frames
               (uniform gray, no depth), then views seen before, at the
               room's speed and at twice it; the tracker must be LOST after
               the blackout, OK again within 5 return frames, within 5 cm
               of ground truth, with Hamming launches made by
               relocalization; ms per LOST frame, and the stages of one
               relocalization (BoW + database query, match, Horn and EPnP
               RANSAC, pose LM). Localization-only: map 60 frames of an
               orbit, erase the landmarks of the middle keyframes, switch
               to only_tracking with local BA off and replay the orbit; VO
               mode must engage, no frame may be LOST, the map must be
               reacquired, no keyframe minted, the final pose within 30 cm.
  7. loop    — loop closing through Tracker(cfg, m, local_mapper=
               AsyncLocalMapper(...), loop_closer=AsyncLoopCloser(
               LoopCloser(...)), voc=voc, kfdb=kfdb): the 150-frame orbit of
               RoomScene(3) with both workers, the old half of the map then
               severed and displaced, the newest keyframe submitted while
               revisit frames keep being fed; the loop must close across the
               cut and land the loop pair on ground truth, frames must retire
               during the worker's pass, the final pose must stay within 30
               cm and every keyframe within 1 m (after the orbit and after
               the severed loop); stage times. Then the global BA of the corrected map through
               the PCG solver against the dense one, and kernel 2 at the loop
               closer's five calls, on the inputs it built (phase kernels'
               loop shapes: Sim3 match, two SearchBySim3 expansion rounds of
               B = 2, verification, SearchAndFuse of B = 10).
  8. system  — the System facade (plslam_torch.models.system) through its
               public API on the room's first frames: (a) 60 frames with
               both workers asynchronous, loop closing, the dense cloud and
               tracing, then the TUM, keyframe, KITTI and PCD savers and
               shutdown (60 unit-quaternion rows, healed ATE < 3 cm, > 10,000
               cloud points, a "frame" trace record a retired frame, both
               kernels launched); (b) compaction after 12 of 24 frames
               (slots reclaimed, observation tables consistent, tracking
               goes on); (c) 15 frames mapped, saved, loaded into a
               localization-only System, which starts LOST, relocalizes
               within 5 cm and mints no keyframe. Wall time of each, fps of
               (a).
  9. multiseq — batched multi-sequence tracking (plslam_torch.parallel.
               multiseq): 4 sequences of the room (RoomScene(0..3), 40
               frames, each tracker with its own map, synchronous mapper
               and keyframe database) through one MultiTracker, and the
               same 4 run solo; sequence 1 gets a wrong velocity prior (the
               rescue runs on a sub-batch), sequence 3 two blackout frames
               (it leaves the batch, steps solo, relocalizes). Sequences
               0-2 OK with 40 rows and ATE < 3 cm, every sequence's states
               equal its solo tracker's and its camera centres within 1 mm,
               1 FAST and 3 Hamming launches a batched step (4 with the
               rescue); sequence-frames per second batched and solo. Then 2
               stereo sequences of 10 pairs, batched against solo, and both
               kernels on the inputs the phase recorded (FAST over 4 x 8
               levels in one launch, Hamming with a query set per
               sequence), exact against their plain versions, timed.
               `python3 chip_smoke.py --only multiseq` runs the build and
               this phase alone.
 10. distributed — the landmark-sharded global BA (plslam_torch.parallel)
               in one process with 4 shards on the card: (a) the dry run's
               four phases (parallel/dryrun.py); (b) the whole-map GBA of a
               256-keyframe make_synthetic_ba_map (16,384 points, 1000
               observations a keyframe), gathered as the loop closer gathers
               it, solved by distributed_bundle_adjust, by the single-device
               PCG and through LocalMapper.run_local_ba with a 4-shard mesh
               ("distributed"): mean keyframe error < 1 cm and below half
               the initial one, within 5 mm of PCG, an abort after 2 steps
               stops after 2; (c) two gloo ranks on the same card (2 shards
               each, file:// rendezvous) reduce 1..4 to 10 and take one
               distributed_cg_step equal to the in-process one at 1e-5
               relative. `--only distributed` runs the build and this phase.
 11. loader  — the room's 150 frames written as a TUM directory with
               utils/png_io.py (8-bit RGB, 16-bit depth, the five PNG
               filters in turn); every frame of plslam_torch.native's
               TumLoader (4 decode threads) bit for bit against the plain
               numpy + zlib decode; run_tum --native-loader over the
               directory (150 rows, state OK, ATE < 1.2 / 3.0 cm, both
               kernels launched); run_kitti over 5 stereo pairs written the
               same way. `--only loader` runs the build, the render and
               this phase.
Then a JSON line of per-kernel numbers (launches: the mapping phase,
which is bench.py's path; the main, stereo, mono, reloc, loop, system,
multiseq and loader phases' beside them), the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

Exits non-zero, printing no result, without CUDA, when the package is
missing, or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
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
RELOC_LIMITS = (5, 0.05)  # return frames before OK (0-based), centre error (m)
VO_ERR_M = 0.30  # localization-only leg: final camera-centre error
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


def aligned_errors(est_centers, gt_centers):
    """Per-camera centre errors after Horn alignment (the TUM evaluate_ate
    protocol, no scale)."""
    a, b = est_centers.T.astype(np.float64), gt_centers.T.astype(np.float64)
    ca, cb = a.mean(1, keepdims=True), b.mean(1, keepdims=True)
    U, _, Vt = np.linalg.svd((a - ca) @ (b - cb).T)
    S = np.eye(3)
    if np.linalg.det(Vt.T @ U.T) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    return np.linalg.norm(R @ (a - ca) + cb - b, axis=0)


def ate(est_centers, gt_centers):
    """RMSE and max of the aligned camera-centre error."""
    err = aligned_errors(est_centers, gt_centers)
    return float(np.sqrt((err**2).mean())), float(err.max())


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
        t_l, d_l = matmul_yardstick(qq, tt_)
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


def matmul_yardstick(q, t):
    """(eager ms, device ms) of torch.matmul on the unpacked bits of the
    queries (N, 256) and targets ((B,) 256, M): the library call that
    computes the same inner products (a distance is |q| + |t| - 2 q.t)."""
    import torch

    from plslam_torch.ops import hamming

    qb = hamming.unpack_bits(q).float()
    tb = hamming.unpack_bits(t.reshape(-1, 32)).float().reshape(t.shape[:-1] + (256,))
    tb = tb.mT.contiguous()
    return timings(lambda: torch.matmul(qb, tb))


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
        t_l, d_l = matmul_yardstick(q, t)
        b, by = bound(gate.numel() + 32 * n + 32 * batch * m + 12 * batch * n,
                      HAMMING_OPS_PER_PAIR * nnz, INT8_TC_OPS_S)
        log(f"  {fn_name} {name}: gated {nnz} pairs, {int((got[0] <= 50).sum())} rows "
            f"within the fusion distance, {tiles} of {batch * -(-n // 16) * -(-m // 512)} tiles "
            f"on the tensor cores; kernel {t_k:.4f} ms (device {d_k:.4f}), plain {t_p:.4f} ms "
            f"(device {d_p:.4f}), matmul on unpacked bits {t_l:.4f} ms (device {d_l:.4f}), "
            f"bound {b * 1e3:.3f} us ({by})")
        out.append(dict(shape=name, launch=fn_name, gated_pairs=nnz, dense_tiles=tiles,
                        ms=t_k, device_ms=d_k, plain_ms=t_p, plain_device_ms=d_p,
                        library_ms=t_l, library_device_ms=d_l, bound_ms=b, bound_by=by))
    return out


def check_reloc_shape(cfg, frames, dev):
    """Hamming top-2 at relocalization's shape (models/relocalization.py):
    a frame's 1024 features against a keyframe's 1024, gate kp_valid x
    has_point, where the keyframe is the room's first frame and has_point
    marks its valid features with depth (the map points the tracker mints
    from it at initialization). The gate is dense: every tile with more
    gated pairs than the kernel's threshold must take the tensor cores.
    Equal to the plain version exactly."""
    import torch

    from plslam_torch.ops import hamming

    fd_k, _, _ = _keyframe(cfg, frames[0], (np.eye(3), np.zeros(3)), dev)
    fd_q, _, _ = _keyframe(cfg, frames[60], (np.eye(3), np.zeros(3)), dev)
    has = fd_k.kp_valid & (fd_k.kp_depth > 0)
    gate = fd_q.kp_valid[:, None] & has[None, :]
    q, t = fd_q.kp_desc, fd_k.kp_desc
    hamming.dense_tiles()
    got = hamming.hamming_top2(q, t, gate)
    tiles = hamming.dense_tiles()
    want = hamming.hamming_top2_plain(q, t, gate)
    torch.cuda.synchronize()
    for a, b, what in zip(got, want, ("best", "idx", "second")):
        if not torch.equal(a, b):
            raise AssertionError(f"hamming_top2 {what} differs at the relocalization shape: "
                                 f"{(a != b).sum().item()} rows")
    n, m = gate.shape
    n_tiles = -(-n // 16) * -(-m // 512)
    # a 16 x 512 tile with more than the kernel's threshold of gated pairs
    # takes the tensor cores; the padded rows of the last tiles hold no
    # valid keypoint, so those may stay on the sparse walk
    padded = torch.nn.functional.pad(gate, (0, (-m) % 512, 0, (-n) % 16)).int()
    per_tile = padded.reshape(-(-n // 16), 16, -(-m // 512), 512).sum((1, 3))
    want_tiles = int((per_tile > hamming.dense_min_pairs()).sum())
    require(tiles == want_tiles and tiles >= n_tiles - 8,
            f"relocalization gate: {tiles} of {n_tiles} tiles dense, {want_tiles} expected")
    nnz = int(gate.sum())
    t_k, d_k = timings(lambda: hamming.hamming_top2(q, t, gate))
    hamming.dense_tiles()
    t_p, d_p = timings(lambda: hamming.hamming_top2_plain(q, t, gate))
    t_l, d_l = matmul_yardstick(q, t)
    b, by = bound(gate.numel() + 32 * n + 32 * m + 12 * n, HAMMING_OPS_PER_PAIR * nnz,
                  INT8_TC_OPS_S)
    log(f"  hamming_top2 {n}x{m} relocalization (dense gate kp_valid x has_point): gated "
        f"{nnz} pairs, {tiles} of {n_tiles} tiles on the tensor cores; kernel {t_k:.4f} ms "
        f"(device {d_k:.4f}), plain {t_p:.4f} ms (device {d_p:.4f}), matmul on unpacked bits "
        f"{t_l:.4f} ms (device {d_l:.4f}), bound {b * 1e3:.3f} us ({by})")
    return dict(shape=f"{n}x{m} relocalization, dense gate", launch="hamming_top2",
                gated_pairs=nnz, dense_tiles=tiles, ms=t_k, device_ms=d_k, plain_ms=t_p,
                plain_device_ms=d_p, library_ms=t_l, library_device_ms=d_l, bound_ms=b,
                bound_by=by)


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


def orbit_poses(n, radius=0.45):
    """World-to-camera poses of a camera orbiting the room's centre and
    yawing a full turn in n - 30 frames (tests/test_loop_closing.py's
    orbit)."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / (n - 30)
        c = np.array([radius * np.sin(a), 0.0, 1.25 + radius * np.cos(a)], np.float32)
        ca, sa = np.cos(a), np.sin(a)
        R = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32).T  # R_cw
        poses.append((R, (-R @ c).astype(np.float32)))
    return poses


def _render(scene, cam, pose, f):
    gray, depth = scene.render(cam, *pose)
    return (np.clip(gray, 0, 255).astype(np.uint8),
            np.clip(depth * f, 0, 65535).astype(np.uint16))


def _reloc_tracker(cfg, dev):
    """Tracker with a synchronous LocalMapper, the port's default vocabulary
    (plslam_torch/bow/vocab_synth.npz) and a keyframe database."""
    from plslam_torch.bow.database import KeyFrameDatabase
    from plslam_torch.bow.vocabulary import Vocabulary
    from plslam_torch.models.local_mapping import LocalMapper
    from plslam_torch.models.map import SlamMap
    from plslam_torch.models.tracking import Tracker

    voc = Vocabulary.load(device=dev)
    m = SlamMap(cfg, device=dev)
    kfdb = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    mapper = LocalMapper(cfg, m, kfdb=kfdb)
    return Tracker(cfg, m, local_mapper=mapper, voc=voc, kfdb=kfdb), mapper


def _gauge_error(pose, poses, k):
    """Camera-centre error of ``pose`` against ground-truth pose k in the
    map's gauge (world = the first camera)."""
    R0, t0 = poses[0]
    Rg, tg = poses[k]
    Rrel = Rg @ R0.T
    trel = tg - Rrel @ t0
    R, t = pose
    return float(np.linalg.norm(-(R.T @ t) + Rrel.T @ trel))


def reloc_stages(cfg, tracker):
    """ms of each stage of one relocalization of the frame the tracker just
    relocalized on, against its first candidate (10 calls each, eager,
    CUDA events): BoW transform + database query, match, Horn RANSAC,
    EPnP RANSAC (the fallback, which the room never needs: timed on the
    same matches), pose LM."""
    from plslam_torch.bow.vocabulary import sparse_bow
    from plslam_torch.geometry.projection import backproject
    from plslam_torch.models import relocalization as rl
    from plslam_torch.optim import epnp, horn

    fd, m = tracker._prev_fd, tracker.map
    dev = m.device

    def query():
        _, bow = tracker.voc.transform(fd.kp_desc, fd.kp_valid)
        return tracker.kfdb.detect_reloc_candidates(sparse_bow(bow), m)

    kf = query()[0]
    has, ptw = rl.candidate_inputs(m, kf)
    dkf = m.device_frame(kf)
    mt = rl.reloc_match(cfg, fd, dkf.kp_desc, dkf.kp_angle, has)
    R0, t0, dst_w = rl.reloc_solve(cfg, fd, mt, ptw, rl.reloc_generator(dev, 0, 0))
    src = backproject(cfg.camera, fd.kp_xy_un, fd.kp_depth)
    ok_d = mt.ok & (fd.kp_depth > 0)
    ms = lambda fn: cuda_ms(fn, reps=10, warm=2)  # noqa: E731
    return dict(
        bow_and_query_ms=ms(query),
        match_ms=ms(lambda: rl.reloc_match(cfg, fd, dkf.kp_desc, dkf.kp_angle, has)),
        horn_ms=ms(lambda: horn.ransac_align(src, dst_w, ok_d, rl.reloc_generator(dev, 0, 0))),
        epnp_ms=ms(lambda: epnp.ransac_epnp(cfg.camera, dst_w, fd.kp_xy_un, mt.ok,
                                            rl.reloc_generator(dev, 0, 1))),
        pose_lm_ms=ms(lambda: rl.reloc_refine(cfg, fd, mt, dst_w, R0, t0)),
        matches=int(mt.ok.sum()), depth_pairs=int(ok_d.sum()))


def blackout(cfg, dev, fast):
    """One blackout scenario of tests/test_relocalization.py at full size:
    15 tracked frames, 4 blackout frames, then views seen before (two poses
    back a frame when ``fast``)."""
    import torch

    from plslam_torch.models.tracking import LOST, OK
    from plslam_torch.ops import hamming
    from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

    scene = RoomScene(0)
    poses = smooth_trajectory(30)[:15] if fast else smooth_trajectory(60)[:30]
    f = cfg.tracking.depth_map_factor
    tracker, _ = _reloc_tracker(cfg, dev)
    m = tracker.map
    for i in range(15):
        tracker.process(*_render(scene, cfg.camera, poses[i], f), i / 30.0)
    require(tracker.state == OK and m.n_kf >= 2, f"state {tracker.state}, {m.n_kf} keyframes")
    h, w = cfg.camera.height, cfg.camera.width
    for i in range(15, 19):
        tracker.process(np.full((h, w), 120, np.uint8), np.zeros((h, w), np.uint16), i / 30.0)
    require(tracker.state == LOST, f"state {tracker.state} after the blackout")
    _reset_counts()
    lost_ms = []
    for j in range(8):
        k = max(10 - j * (2 if fast else 1), 2)
        g, d = _render(scene, cfg.camera, poses[k], f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tracker.process(g, d, (19 + j) / 30.0)
        torch.cuda.synchronize()
        lost_ms.append((time.perf_counter() - t0) * 1e3)
        if tracker.state == OK:
            break
    launches = hamming.hamming_top2.launches
    require(tracker.state == OK and j <= RELOC_LIMITS[0],
            f"not relocalized within {RELOC_LIMITS[0] + 1} return frames")
    err = _gauge_error(out, poses, k)
    require(err < RELOC_LIMITS[1], f"relocalized {err * 100:.2f} cm from ground truth")
    require(launches >= 1, "relocalization launched no hamming_top2")
    return dict(relocalized_at_return_frame=j, center_error_cm=err * 100,
                hamming_launches=launches, lost_frame_ms=lost_ms, keyframes=m.n_kf,
                speed_est_m=tracker._speed_est, stages=reloc_stages(cfg, tracker))


def localization_leg(cfg, dev, orbit, poses):
    """Localization-only mode (tests/test_vo_mode.py): map 60 frames of the
    orbit, erase the landmarks anchored in the middle band of keyframes
    (at most one observer outside it), then replay the orbit with
    only_tracking on and local BA off."""
    import torch

    from plslam_torch.models.tracking import LOST, OK
    from plslam_torch.ops import hamming

    n_map = 60
    frames = orbit[:n_map]
    tracker, mapper = _reloc_tracker(cfg, dev)
    m = tracker.map
    for i, (g, d) in enumerate(frames):
        tracker.process(g, d, i / 30.0)
    tracker.flush()
    n_kf = m.n_kf
    require(tracker.state == OK and n_kf >= 6, f"mapping: state {tracker.state}, {n_kf} keyframes")
    band = set(range(n_kf // 3, 2 * n_kf // 3 + 1))
    erased = 0
    for pid in m.point_ids():
        obs = m.pt_obs[pid]
        nb = sum(1 for k in obs if k in band)
        if obs and nb > 0 and len(obs) - nb <= 1:
            m.erase_point(pid)
            erased += 1
    require(erased > 50, f"only {erased} points in the band")
    tracker.only_tracking = True
    mapper.enable_ba = False
    tracker._refresh_local_map(tracker.last_pt_ids, tracker.last_ln_ids)
    _reset_counts()
    states, vo_frames = [], []
    t0 = time.perf_counter()
    for j, i in enumerate(range(2, n_map - 2)):
        tracker.process(*frames[i], (n_map + j) / 30.0)
        states.append(tracker.state)
        if tracker.vo_mode:
            vo_frames.append(i)
    tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = _gauge_error(tracker.last_pose, poses, n_map - 3)
    require(vo_frames, "vo_mode never engaged in the de-mapped sector")
    require(LOST not in states, "the tracker went LOST despite the VO fallback")
    require(tracker.state == OK and not tracker.vo_mode, "the map was not reacquired")
    require(m.n_kf == n_kf, f"localization mode minted keyframes: {n_kf} -> {m.n_kf}")
    require(err < VO_ERR_M, f"final pose {err * 100:.1f} cm from ground truth")
    return dict(keyframes=n_kf, erased_points=erased, replayed=len(states),
                vo_frames=vo_frames, final_error_cm=err * 100, fps=len(states) / wall,
                hamming_launches=hamming.hamming_top2.launches)


def reloc_phase(cfg, dev, orbit, poses):
    """Phase reloc: both blackout scenarios and the localization-only leg on
    the first 60 frames of the orbit, with lines off as the scenarios of the
    JAX package's tests run."""
    import dataclasses

    cfg = dataclasses.replace(cfg, use_lines=False)
    t0 = time.perf_counter()
    res = dict(blackout=blackout(cfg, dev, fast=False),
               blackout_fast=blackout(cfg, dev, fast=True),
               localization=localization_leg(cfg, dev, orbit, poses))
    res["seconds"] = time.perf_counter() - t0
    return res


def sever_and_displace(m, kf_cut, W_R, W_t):
    """The kidnapped-sector state of tests/test_loop_closing.py: every
    landmark shared across the cut is split (the old sector gets a duplicate
    with the real descriptor), cross-sector line observations are dropped,
    and the old sector (keyframes < kf_cut, their landmarks) is displaced
    rigidly by the world transform W, so only the loop pipeline can
    reconnect the sectors. Caller holds the map lock."""
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


def _kf0_relative_err(m, pose, poses, k=-1):
    """Camera-centre error of ``pose`` relative to keyframe 0 against the
    same relative in ground truth (orbit pose ``k`` against the first):
    invariant to any gauge motion of the map."""
    Re, te = pose
    Rrel_e = Re @ m.kf_R[0].T
    trel_e = te - Rrel_e @ m.kf_t[0]
    (Rg, tg), (R0g, t0g) = poses[k], poses[0]
    Rrel_g = Rg @ R0g.T
    trel_g = tg - Rrel_g @ t0g
    return float(np.linalg.norm(-Rrel_e.T @ trel_e + Rrel_g.T @ trel_g))


def _kf_errors(m, poses, frame_of, K):
    """KF0-relative camera-centre error of each valid keyframe < K, cm;
    ``frame_of`` maps a tracker frame id to its orbit pose."""
    return [round(_kf0_relative_err(m, (m.kf_R[q], m.kf_t[q]), poses,
                                    frame_of[int(m.kf_frame_id[q])]) * 100, 2)
            for q in range(K) if m.kf_valid[q]]


def _anchor_err(R_arr, t_arr, a, b, gt_R, gt_t):
    """Translation error of the a-vs-b relative pose against ground truth's."""
    Rab = R_arr[a] @ R_arr[b].T
    tab = t_arr[a] - Rab @ t_arr[b]
    Rab0 = gt_R[a] @ gt_R[b].T
    return float(np.linalg.norm(tab - (gt_t[a] - Rab0 @ gt_t[b])))


class LoopProbe:
    """Instrumentation of one LoopCloser on its worker, attached to the
    instance's stage methods: host ms of each stage (the device synced
    after it), the solver of each global BA, the outcome of each detection
    and relative-pose solve, and, inside the relative-pose and SearchAndFuse
    stages only, the closer's calls into the Hamming module: ``ops.matching``
    reaches it through a forwarding proxy while such a stage runs, which
    keeps the first kernel inputs of each loop shape and counts
    SearchAndFuse's batched launches (calls from other threads pass
    through untouched; the wrappers and their launch counts stay as they
    are)."""

    STAGES = ("_detect_loop", "_compute_relative", "_propagate_group", "_search_and_fuse",
              "_optimize_essential_graph", "_global_ba")

    def __init__(self, inner):
        import threading

        import torch

        from plslam_torch.ops import hamming, matching

        self.ms = {s: [] for s in self.STAGES}
        self.fuse_launches = 0
        self.gba_solvers = []
        self.inputs = {}
        self.calls = []  # (stage, arguments, outcome) of detection and relative pose
        self.pre_correction = None  # keyframe poses just before the first correction
        self._stage = threading.local()

        def timed(name, fn):
            def run(*a, **kw):
                if name == "_propagate_group" and self.pre_correction is None:
                    # the caller holds the map lock
                    self.pre_correction = (inner.map.kf_R.copy(), inner.map.kf_t.copy())
                recorded = name in ("_compute_relative", "_search_and_fuse")
                self._stage.name = name
                if recorded:
                    matching.hamming = proxy
                t0 = time.perf_counter()
                try:
                    out = fn(*a, **kw)
                    torch.cuda.synchronize()
                finally:
                    self._stage.name = None
                    if recorded:
                        matching.hamming = hamming
                self.ms[name].append((time.perf_counter() - t0) * 1e3)
                if name == "_global_ba":
                    self.gba_solvers.append(out)
                if name == "_detect_loop":
                    self.calls.append(("detect", int(a[0]), [int(c) for c in out]))
                if name == "_compute_relative":
                    self.calls.append(("relative", int(a[0]), int(a[1]), out is not None))
                return out
            return run

        def recording(fn_name):
            fn = getattr(hamming, fn_name)

            def run(q, t, gate):
                stage = getattr(self._stage, "name", None)
                if (stage == "_search_and_fuse" and fn_name == "hamming_top2_batched"
                        and q.is_cuda):
                    self.fuse_launches += 1
                if stage in ("_compute_relative", "_search_and_fuse"):
                    kind = {("_compute_relative", "hamming_top2", 1024): "sim3 match",
                            ("_compute_relative", "hamming_top2", 4096): "verification",
                            ("_compute_relative", "hamming_top2_batched", 2): "expansion",
                            ("_search_and_fuse", "hamming_top2_batched", FUSE_TARGETS):
                                "search and fuse"}.get((stage, fn_name, q.shape[0]
                                                        if t.dim() == 2 else t.shape[0]))
                    if kind == "expansion":
                        kind += " round 1" if kind + " round 1" not in self.inputs else \
                            " round 2"
                    if kind is not None and kind not in self.inputs:
                        self.inputs[kind] = (fn_name, q, t, gate)
                return fn(q, t, gate)
            return run

        class Proxy:
            hamming_top2 = staticmethod(recording("hamming_top2"))
            hamming_top2_batched = staticmethod(recording("hamming_top2_batched"))

            def __getattr__(self, name):
                return getattr(hamming, name)

        proxy = Proxy()
        for name in self.STAGES:
            setattr(inner, name, timed(name, getattr(inner, name)))

    def reset(self):
        for v in self.ms.values():
            v.clear()
        self.fuse_launches = 0
        self.gba_solvers.clear()
        self.inputs.clear()
        self.calls.clear()
        self.pre_correction = None


FUSE_TARGETS = 10  # SearchAndFuse's batch: the corrected group's keyframes
LOOP_ANCHOR_M = 0.05  # tests/test_loop_closing.py::run_severed_loop_check's bars
LOOP_FINAL_M = 0.30   # tests/test_async_loop.py's KF0-relative bar
# every keyframe's KF0-relative error, after the orbit (its live loop
# included) and after the severed loop: the orbit drifts tens of cm in both
# packages (the JAX package's own run of it, at 320x240 on the CPU, leaves
# keyframes 1.3-1.9 m off, tests/torch_orbit_compare.py), so the bar only
# catches a map torn by metres
LOOP_MAP_M = 1.0
PCG_POSE_M = 0.005  # tests/test_ba_cg.py's bars: mean pose error difference, cost ratio
PCG_COST_RATIO = 1.05


def revisit_order(last=149, first=120):
    """Orbit frame indices inside the revisited sector, from the last
    frame tracked down to ``first`` and back up, repeated: the camera keeps
    moving through frames 120-149 without the 87-degree jump from frame 149
    back to 120, which the tracker's speed-scaled relocalization gate
    refuses for ~8 LOST frames (as long as a worker pass on the card)."""
    cycle = list(range(last - 1, first - 1, -1)) + list(range(first + 1, last + 1))
    i = 0
    while True:
        yield cycle[i % len(cycle)]
        i += 1


def walk_to(a, b):
    """Frame indices one step at a time from just after ``a`` to ``b``."""
    step = 1 if b >= a else -1
    return list(range(a + step, b + step, step))


def _quiesce(tracker, *workers):
    tracker.flush()
    for _ in range(2):  # a loop correction may queue mapper work
        for w in workers:
            require(w.wait_idle(timeout=300.0), f"{type(w).__name__} still busy after 300 s")


def loop_phase(cfg, dev, frames, poses):
    """The loop-closing path: tests/test_async_loop.py's scenario through
    Tracker(cfg, m, local_mapper=AsyncLocalMapper(...), loop_closer=
    AsyncLoopCloser(LoopCloser(...)), voc=voc, kfdb=kfdb) over the 150-frame
    orbit of RoomScene(3) with culling off, the old half of the map then
    severed and displaced (yaw 0.10 rad, t = (0.15, 0, -0.12)), the newest
    keyframe submitted to the worker up to 3 times while orbit frames
    120-149 keep being fed (back and forth, ``revisit_order``), and frames
    140-149 to finish; with the anchor
    checks of tests/test_loop_closing.py::run_severed_loop_check. Every
    count is set to 0 just before the orbit and read after the workers
    stopped."""
    import dataclasses

    import torch

    from plslam_torch.bow.database import KeyFrameDatabase
    from plslam_torch.bow.vocabulary import Vocabulary
    from plslam_torch.models.async_mapping import AsyncLocalMapper, AsyncLoopCloser
    from plslam_torch.models.local_mapping import LocalMapper
    from plslam_torch.models.loop_closing import LoopCloser
    from plslam_torch.models.map import SlamMap
    from plslam_torch.models.tracking import LOST, Tracker
    from plslam_torch.ops import fast, hamming

    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, kf_culling_redundancy=10.0))  # culling off, as both JAX tests
    voc = Vocabulary.load(device=dev)
    m = SlamMap(cfg, device=dev)
    kfdb = KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
    lm = AsyncLocalMapper(LocalMapper(cfg, m, kfdb=kfdb))
    lc = AsyncLoopCloser(LoopCloser(cfg, m, kfdb, voc, local_mapper=lm))
    tr = Tracker(cfg, m, local_mapper=lm, loop_closer=lc, voc=voc, kfdb=kfdb)
    lc.tracker = tr
    probe = LoopProbe(lc.inner)
    n = len(frames)
    res = dict(frames_orbit=n)
    t_start = time.perf_counter()
    try:
        _reset_counts()
        frame_of = {}  # tracker frame id -> orbit pose index

        def feed(i, ts):
            out = tr.process(*frames[i], ts)
            frame_of[tr.frame_id] = i
            return out

        for i in range(n):
            feed(i, i / 30.0)
        _quiesce(tr, lm, lc)
        orbit_errs = _kf_errors(m, poses, frame_of, m.n_kf)
        res.update(orbit_s=time.perf_counter() - t_start,
                   loops_closed_during_orbit=lc.n_loops_closed,
                   loop_edges_before_severance=[list(e) for e in m.loop_edges],
                   kf0_relative_err_by_kf_before_severance_cm=orbit_errs)
        require(max(orbit_errs) < LOOP_MAP_M * 100,
                f"a keyframe {max(orbit_errs):.1f} cm off after the orbit")
        W_R = np.array([[np.cos(0.1), 0, np.sin(0.1)], [0, 1, 0], [-np.sin(0.1), 0, np.cos(0.1)]],
                       np.float32)
        W_t = np.array([0.15, 0.0, -0.12], np.float32)
        with tr._map_lock:
            kf_cut = max(m.n_kf // 2, 1)
            sever_and_displace(m, kf_cut, W_R, W_t)
            base = lc.inner
            base.prev_groups = []
            base.last_loop_kf = -(10**9)
            base.n_loops_closed = 0
            base.last_loop_pair = None
        tr._refresh_local_map(tr.last_pt_ids, tr.last_ln_ids)
        K0 = m.n_kf
        res.update(keyframes=K0, keyframes_valid=int(m.kf_valid[:K0].sum()), kf_cut=kf_cut)
        k = max(q for q in range(K0) if m.kf_valid[q])
        probe.reset()
        fed = retired = lost = j = 0
        order, cur = revisit_order(), n - 1
        t0 = time.perf_counter()
        for _ in range(3):
            lc.process_keyframe(k)
            while not lc.idle and j < 120:
                cur = next(order)
                if feed(cur, (n + j) / 30.0) is not None:
                    retired += 1
                lost += tr.state == LOST
                fed += 1
                j += 1
            if lc.n_loops_closed:
                break
        _quiesce(tr, lm, lc)
        res.update(worker_pass_s=time.perf_counter() - t0, frames_fed_during_pass=fed,
                   frames_retired_during_pass=retired, lost_frames_during_pass=lost,
                   loops_closed=lc.n_loops_closed, gba_solvers=probe.gba_solvers,
                   search_and_fuse_batched_launches=probe.fuse_launches,
                   loop_calls=probe.calls, submitted=k)
        require(lc.error is None and lm.error is None,
                f"worker error: loop {lc.error!r}, mapping {lm.error!r}")
        require(lc.n_loops_closed >= 1, "the loop never closed")
        k1, k2 = lc.last_loop_pair
        cross = sum(1 for pid in m.point_ids()
                    if any(q < kf_cut for q in m.pt_obs[pid])
                    and any(q >= kf_cut for q in m.pt_obs[pid]))
        gt = [poses[frame_of[int(f)]] for f in m.kf_frame_id[:m.n_kf]]
        gt_R, gt_t = np.stack([R for R, _ in gt]), np.stack([t for _, t in gt])
        # the loop pair's error just before the correction (k1 may be a
        # keyframe the tracker made during the pass) and after it
        err_before = _anchor_err(*probe.pre_correction, k2, k1, gt_R, gt_t)
        err_after = _anchor_err(m.kf_R, m.kf_t, k2, k1, gt_R, gt_t)
        res.update(loop_pair=[int(k1), int(k2)], cross_sector_landmarks=cross,
                   anchor_err_before_cm=err_before * 100, anchor_err_after_cm=err_after * 100)
        for i in walk_to(cur, 139) + list(range(140, 150)):
            feed(i, (n + j) / 30.0)
            j += 1
        _quiesce(tr, lm, lc)
        final_err = _kf0_relative_err(m, tr.last_pose, poses)
        kf_errs = _kf_errors(m, poses, frame_of, K0)
        res.update(kf0_relative_err_by_kf_cm=kf_errs,
                   final_kf0_relative_err_cm=final_err * 100, final_state=tr.state,
                   gauge_corrections_applied=tr._corr_epoch)
        ms = {s.lstrip("_"): v for s, v in probe.ms.items()}
        res["stage_ms"] = dict(
            detection=ms["detect_loop"], compute_relative=ms["compute_relative"],
            propagation_and_search_and_fuse=[a + b for a, b in zip(ms["propagate_group"],
                                                                   ms["search_and_fuse"])],
            essential_graph=ms["optimize_essential_graph"], global_ba=ms["global_ba"])
        require(k2 < kf_cut <= k1, f"loop pair {k1},{k2} not cross-sector (cut {kf_cut})")
        require(cross >= 20, f"only {cross} cross-sector landmarks after SearchAndFuse")
        require(err_before > LOOP_ANCHOR_M, f"severance moved the anchor {err_before:.4f} m")
        require(err_after < LOOP_ANCHOR_M and err_after < 0.3 * err_before,
                f"anchor {err_before * 100:.2f} -> {err_after * 100:.2f} cm against ground truth")
        require(fed >= 3 and retired >= 1,
                f"{fed} frames fed, {retired} retired during the worker's pass")
        require(probe.fuse_launches >= 1, "SearchAndFuse made no batched Hamming launch")
        require(probe.gba_solvers and all(s in ("dense", "pcg") for s in probe.gba_solvers),
                f"global BA did not run: {probe.gba_solvers}")
        require(final_err < LOOP_FINAL_M, f"KF0-relative error {final_err * 100:.1f} cm")
        require(max(kf_errs) < LOOP_MAP_M * 100,
                f"a keyframe {max(kf_errs):.1f} cm off after the severed loop")
    except Exception:
        log("phase loop: failed, " + json.dumps(res))
        raise
    finally:
        lc.shutdown()
        lm.shutdown()
    torch.cuda.synchronize()
    require(lc.error is None and lm.error is None,
            f"worker error: loop {lc.error!r}, mapping {lm.error!r}")
    res["launches"] = {"fast_score_nms": fast.fast_score_nms.launches,
                       "hamming_top2": hamming.hamming_top2.launches,
                       "hamming_top2_batched": hamming.hamming_top2_batched.launches}
    res["phase_s"] = time.perf_counter() - t_start
    return res, probe.inputs, lambda: pcg_check(cfg, m, k1, poses, frame_of)


def pcg_check(cfg, m, kf1, poses, frame_of):
    """The global BA of the corrected map once more, gathered as the loop
    closer gathers it, with ``cfg.mapping.ba_dense_camera_cap`` below the
    keyframe count so that ``solve_ba`` takes the matrix-free PCG solver
    (optim/ba_cg.py), against the dense solver on the same problem, with
    tests/test_ba_cg.py's bars: mean keyframe pose error (camera centre to
    ground truth after Horn alignment) within 5 mm of dense, cost <= 1.05 x
    dense. Run at the configured ``ba_cg_iters`` (48, what the loop closer's
    global BA runs) and at 6C, the size of the reduced camera system, where
    CG is exact in exact arithmetic. Both are held to the cost bar, and the
    6C run to the pose bar as well. The configured run's pose bar is only
    reported (``pose_bar_met``): CG truncated at 48 iterations misses it on
    some of these maps (ROADMAP.md Queue C)."""
    import dataclasses

    import torch

    from plslam_torch.models.local_mapping import LocalMapper
    from plslam_torch.models.loop_closing import global_ba_caps
    from plslam_torch.optim import local_ba

    mc = cfg.mapping
    n_valid = int(m.kf_valid[:m.n_kf].sum())
    mapper = LocalMapper(dataclasses.replace(cfg, mapping=dataclasses.replace(
        mc, ba_dense_camera_cap=n_valid - 1)), m)
    g = mapper.gather_ba(kf1, max_kf=m.n_kf, **global_ba_caps(m))
    require(g is not None, "no global BA problem")
    C = g.prob.cam_R.shape[0]
    nc = len(g.cams)
    gt = np.array([-(R.T @ t) for R, t in (poses[frame_of[int(m.kf_frame_id[k])]]
                                           for k in g.cams)])

    def centres(r):
        return -(r.cam_R[:nc].mT @ r.cam_t[:nc, :, None])[..., 0].cpu().numpy()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    dense, dense_ms = timed(lambda: local_ba.bundle_adjust_stepped(
        cfg.camera, g.prob, iters1=mc.local_ba_iters1, iters2=mc.local_ba_iters2))
    c_d, cost_d = centres(dense), float(dense.cost)
    err_d = float(aligned_errors(c_d, gt).mean())
    out = dict(cameras=C, keyframes=nc, points=len(g.pids), lines=len(g.lids),
               observations=len(g.oc), line_observations=len(g.lc), dense_ms=dense_ms,
               cost_dense=cost_d, kf_err_mean_dense_cm=err_d * 100)
    for cg_iters in (mc.ba_cg_iters, 6 * C):
        mapper.cfg = dataclasses.replace(mapper.cfg, mapping=dataclasses.replace(
            mapper.cfg.mapping, ba_cg_iters=cg_iters))
        (pcg, solver), ms = timed(lambda: mapper.solve_ba(g.prob))
        require(solver == "pcg", f"solve_ba took {solver} with {C} cameras, cap {n_valid - 1}")
        c_p, cost_p = centres(pcg), float(pcg.cost)
        err_p = float(aligned_errors(c_p, gt).mean())
        out[f"pcg_{cg_iters}_iters"] = dict(
            ms=ms, cost=cost_p, kf_err_mean_cm=err_p * 100,
            centre_diff_max_mm=float(np.linalg.norm(c_p - c_d, axis=1).max()) * 1e3,
            pose_bar_met=abs(err_p - err_d) < PCG_POSE_M)
        require(np.isfinite(c_p).all() and cost_p <= PCG_COST_RATIO * cost_d,
                f"PCG ({cg_iters} CG iterations) cost {cost_p} against dense {cost_d}")
    require(abs(err_p - err_d) < PCG_POSE_M,
            f"mean keyframe error {err_p * 100:.3f} cm with PCG at {6 * C} CG iterations, "
            f"{err_d * 100:.3f} dense")
    return out


def check_loop_shapes(inputs):
    """Kernel 2 at the loop closer's shapes, on the inputs the loop closer
    built in phase loop (recorded by LoopProbe): the Sim3 ratio match
    (1024 x 1024, dense gate has_point x has_point), the SearchBySim3
    expansion's two rounds (one batched launch of 2 x 1024 x 1024 each:
    the keyframe's features and the landmarks' descriptors behind one
    window gate, 15 then 9 px), the verification (4096 x 1024, 10 px) and
    SearchAndFuse (one batched launch of 10 x 4096 x 1024, 5 px). Each
    equals its plain version exactly; each expansion round's combination
    also equals the plain top-1 of the elementwise minimum of the two
    distance matrices."""
    import torch

    from plslam_torch.ops import hamming, matching

    want_kinds = ("sim3 match", "expansion round 1", "expansion round 2", "verification",
                  "search and fuse")
    missing = [k for k in want_kinds if k not in inputs]
    require(not missing, f"phase loop made no call at the shapes {missing}")
    out = []
    for kind in want_kinds:
        fn_name, q, t, gate = inputs[kind]
        out.append(hold_and_time(f"loop {kind}", fn_name, q, t, gate))
        if kind.startswith("expansion"):
            mt = matching.match_min_of_two(q, t, gate[0], 50)
            dmin = torch.minimum(hamming.hamming_matrix(q, t[0]), hamming.hamming_matrix(q, t[1]))
            ref = matching.dedupe_targets(matching.best_matches(dmin, gate[0], 50), t.shape[1])
            for a, b, what in zip(mt, ref, ("idx", "dist", "ok")):
                if not torch.equal(a, b):
                    raise AssertionError(f"min-of-two {what} differs at the loop's {kind}: "
                                         f"{(a != b).sum().item()} rows")
    return out


def hold_and_time(label, fn_name, q, t, gate):
    """Kernel 2 (``fn_name``: hamming_top2 or hamming_top2_batched) on
    recorded inputs: exactly equal to its plain version, then timed eager
    and on the device beside the plain version and torch.matmul on the
    unpacked bits, with its bound (the gate's bytes, both descriptor sets
    and the three outputs, against the tensor-core rate for the gated
    pairs). Returns the record of the shape."""
    import torch

    from plslam_torch.ops import hamming

    fn = getattr(hamming, fn_name)
    plain = getattr(hamming, fn_name + "_plain")
    hamming.dense_tiles()
    got = fn(q, t, gate)
    tiles = hamming.dense_tiles()
    want = plain(q, t, gate)
    torch.cuda.synchronize()
    for a, b, what in zip(got, want, ("best", "idx", "second")):
        if not torch.equal(a, b):
            raise AssertionError(f"{fn_name} {what} differs at the {label}: "
                                 f"{(a != b).sum().item()} rows")
    n, m_ = gate.shape[-2:]
    batch = gate.numel() // (n * m_)
    nnz = int(gate.sum())
    t_k, d_k = timings(lambda: fn(q, t, gate))
    hamming.dense_tiles()
    t_p, d_p = timings(lambda: plain(q, t, gate))
    t_l, d_l = matmul_yardstick(q, t)
    b, by = bound(gate.numel() + q.numel() + t.numel() + 12 * batch * n,
                  HAMMING_OPS_PER_PAIR * nnz, INT8_TC_OPS_S)
    shape = f"{batch} x {n}x{m_}" if gate.dim() == 3 else f"{n}x{m_}"
    log(f"  {fn_name} {label} {shape}: gated {nnz} pairs, {tiles} of "
        f"{batch * -(-n // 16) * -(-m_ // 512)} tiles on the tensor cores; kernel "
        f"{t_k:.4f} ms (device {d_k:.4f}), plain {t_p:.4f} ms (device {d_p:.4f}), matmul on "
        f"unpacked bits {t_l:.4f} ms (device {d_l:.4f}), bound {b * 1e3:.3f} us ({by})")
    return dict(shape=f"{label} {shape}", launch=fn_name, gated_pairs=nnz,
                dense_tiles=tiles, max_abs_err=0.0, ms=t_k, device_ms=d_k, plain_ms=t_p,
                plain_device_ms=d_p, library_ms=t_l, library_device_ms=d_l,
                bound_ms=b, bound_by=by)


SYSTEM_FRAMES = 60  # sub-phase (a)
SYSTEM_ATE_M = 0.03  # tests/test_system.py's bar on the healed TUM file
SYSTEM_RELOC_M = 0.05  # tests/test_checkpoint.py's bar after relocalizing


def _metres(frames, cfg):
    """The room's frames as System.track_rgbd takes them: depth in metres."""
    f = np.float32(cfg.tracking.depth_map_factor)
    return [(g, d.astype(np.float32) / f) for g, d in frames]


def _launches():
    from plslam_torch.ops import fast, hamming

    return {"fast_score_nms": fast.fast_score_nms.launches,
            "hamming_top2": hamming.hamming_top2.launches
            + hamming.hamming_top2_batched.launches}


def system_phase(cfg, dev, frames, poses, tmp):
    """The System facade, through its public API on the card, at 640x480 on
    the room's frames: (a) tests/test_system.py's full pipeline (both
    workers asynchronous, loop closing, dense cloud, tracing) over 60
    frames, then the four savers and shutdown; (b) compaction mid-run
    (tests/test_checkpoint.py::test_arena_compaction_mid_run); (c) save,
    load into a localization-only System and relocalize
    (tests/test_checkpoint.py::test_localization_against_loaded_map).
    Every count is set to 0 just before (a) and read after (a) and (c)."""
    import torch

    from plslam_torch.models.system import System
    from plslam_torch.models.tracking import LOST, OK
    from plslam_torch.utils import tum_io

    metres = _metres(frames, cfg)
    gt = np.array([-(R.T @ t) for R, t in poses])
    res = {}
    # (a) full pipeline and savers
    _reset_counts()
    t0 = time.perf_counter()
    n = SYSTEM_FRAMES
    slam = System(cfg, enable_loop_closing=True, enable_dense_cloud=True, async_mapping=True,
                  trace_path=str(tmp / "trace.jsonl"), device=dev)
    for i, (g, d) in enumerate(metres[:n]):
        slam.track_rgbd(g, d, i / 30.0)
    slam.tracker.flush()
    torch.cuda.synchronize()
    tracked = time.perf_counter() - t0
    paths = {k: str(tmp / f"{k}.txt") for k in ("tum", "kf", "kitti")}
    paths["pcd"] = str(tmp / "result.pcd")
    slam.save_trajectory_tum(paths["tum"])
    slam.save_keyframe_trajectory_tum(paths["kf"])
    slam.save_trajectory_kitti(paths["kitti"])
    slam.save_pcd(paths["pcd"])
    slam.shutdown()
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches_a = _launches()
    for w in (slam.local_mapper, slam.loop_closer):
        require(w.error is None, f"{type(w).__name__} failed: {w.error!r}")
    ts, pos, quat = tum_io.load_trajectory_tum(paths["tum"])
    require(len(ts) == n, f"TUM file has {len(ts)} rows for {n} frames")
    require(np.all(np.abs(np.linalg.norm(quat, axis=1) - 1) < 1e-3), "non-unit quaternions")
    require(np.isfinite(pos).all(), "non-finite positions")
    ate_healed = tum_io.ate_rmse(ts, pos, np.arange(n) / 30.0, gt[:n])
    require(ate_healed < SYSTEM_ATE_M, f"healed ATE {ate_healed:.4f} m")
    kitti = [line.split() for line in open(paths["kitti"])]
    require(len(kitti) == n and all(len(r) == 12 for r in kitti), "KITTI rows")
    kf_rows = len(open(paths["kf"]).read().splitlines())
    require(kf_rows == int(slam.map.kf_valid.sum()) >= 2, f"{kf_rows} keyframe rows")
    head = open(paths["pcd"]).read(400)
    require("DATA ascii" in head and "POINTS" in head, "PCD header")
    n_cloud = len(slam.cloud.cloud()[0])
    require(n_cloud > 10000, f"{n_cloud} cloud points")
    recs = [json.loads(line) for line in open(tmp / "trace.jsonl")]
    frame_recs = [r for r in recs if r["kind"] == "frame"]
    require(len(frame_recs) >= n - 5 and all(
        {"frame", "state", "local_inliers", "n_kf"} <= set(r) for r in frame_recs),
        f"{len(frame_recs)} frame records")
    require(launches_a["fast_score_nms"] > 0 and launches_a["hamming_top2"] > 0,
            f"launches {launches_a}")
    res["full"] = dict(frames=n, fps=n / tracked, seconds=wall_a, keyframes=slam.map.n_kf,
                       points=slam.map.n_points(), lines=slam.map.n_lines(),
                       ate_healed_cm=ate_healed * 100, cloud_points=n_cloud,
                       trace_frame_records=len(frame_recs), loops=slam.loop_closer.n_loops_closed,
                       launches=launches_a)
    # (b) compaction mid-run
    t0 = time.perf_counter()
    nb = 24
    slam = System(cfg, device=dev)
    for i, (g, d) in enumerate(metres[: nb // 2]):
        slam.track_rgbd(g, d, i / 30.0)
    m = slam.map
    pt_next, n_valid = m._pt_next, m.n_points()
    require(pt_next > n_valid, f"no erased point to reclaim ({pt_next}, {n_valid})")
    slam.compact_map()
    require(m._pt_next == m.n_points() == n_valid, "compaction lost points")
    for pid in m.point_ids():
        for kf, feat in m.pt_obs[pid].items():
            require(m.kf_pt_idx[kf, feat] == pid, f"observation table of point {pid}")
    ok = sum(slam.track_rgbd(g, d, (nb // 2 + i) / 30.0) is not None
             for i, (g, d) in enumerate(metres[nb // 2: nb]))
    slam.shutdown()
    require(slam.tracking_state == OK and ok >= nb // 2 - 4,
            f"after compaction: state {slam.tracking_state}, {ok} poses")
    res["compaction"] = dict(seconds=time.perf_counter() - t0, pt_next_before=pt_next,
                             points=n_valid, poses_after=ok)
    # (c) save, load, relocalize
    t0 = time.perf_counter()
    nc = 15
    slam = System(cfg, device=dev)
    for i, (g, d) in enumerate(metres[:nc]):
        slam.track_rgbd(g, d, i / 30.0)
    slam.shutdown()
    path = str(tmp / "map.npz")
    slam.save_map(path)
    loc = System(cfg, localization_only=True, device=dev)
    loc.load_map(path)
    require(loc.tracking_state == LOST, f"state {loc.tracking_state} after load_map")
    n_kf = loc.map.n_kf
    got = [loc.track_rgbd(g, d, 10.0 + i / 30.0) for i, (g, d) in enumerate(metres[:nc])]
    loc.shutdown()
    oks = sum(p is not None for p in got)
    R, t = loc.tracker.last_pose
    R0, t0_ = poses[0]
    gR, gt_ = poses[nc - 1]
    err = float(np.linalg.norm(-(R.T @ t) - (R0 @ (-(gR.T @ gt_)) + t0_)))
    require(loc.tracking_state == OK and oks >= 5, f"state {loc.tracking_state}, {oks} poses")
    require(err < SYSTEM_RELOC_M, f"relocalized centre {err:.4f} m off")
    require(loc.map.n_kf == n_kf, "localization minted keyframes")
    res["relocalize"] = dict(seconds=time.perf_counter() - t0, keyframes=n_kf, poses=oks,
                             first_pose_at=next(i for i, p in enumerate(got) if p is not None),
                             center_error_cm=err * 100)
    res["launches"] = _launches()
    return res


STEREO_FRAMES = 25        # tests/test_stereo.py's scenario and bars
STEREO_ATE_M = 0.03
STEREO_DEPTH_POINTS = 200
STEREO_DEPTH_REL = 0.03
MONO_FRAMES = 40          # tests/test_mono.py's scenario and bars
MONO_SIM_RMSE_M = 0.05
MONO_POINTS = 100


class HammingProbe:
    """For the stages named, each a module function wrapped while the probe
    is active: the inputs of the first kernel-2 call made inside the stage
    and the launches made inside it, read from the wrapper's own count
    (``matching.hamming`` is swapped for a recording proxy)."""

    def __init__(self, stages):
        import threading

        self.stages = stages  # {kind: (module, function name)}
        self.inputs = {}
        self.launches = {k: 0 for k in stages}
        self._stage = threading.local()
        self._saved = []

    def __enter__(self):
        from plslam_torch.ops import hamming, matching

        def recording(q, t, gate):
            kind = getattr(self._stage, "name", None)
            before = hamming.hamming_top2.launches
            out = hamming.hamming_top2(q, t, gate)
            if kind is not None:
                self.launches[kind] += hamming.hamming_top2.launches - before
                self.inputs.setdefault(kind, ("hamming_top2", q, t, gate))
            return out

        class Proxy:
            hamming_top2 = staticmethod(recording)

            def __getattr__(self, name):
                return getattr(hamming, name)

        def staged(kind, fn):
            def run(*a, **kw):
                self._stage.name = kind
                try:
                    return fn(*a, **kw)
                finally:
                    self._stage.name = None
            return run

        self._saved = [(matching, "hamming", hamming)]
        matching.hamming = Proxy()
        for kind, (mod, name) in self.stages.items():
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, staged(kind, getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        return False


def _latency(per_frame):
    ms = np.array(per_frame) * 1e3
    return dict(p50_ms=float(np.percentile(ms, 50)), p90_ms=float(np.percentile(ms, 90)),
                max_ms=float(ms.max()))


def stereo_phase(cfg, dev):
    """The stereo sensor: tests/test_stereo.py's scenario at its own width
    (640x480, fx 525, bf 40; RoomScene(0), smooth_trajectory(50)[:25], the
    right image rendered bf / fx to the right). Frame 0's stereo depth
    through build_frame_stereo on the card (> 200 keypoints with depth,
    median relative error < 3%), then the 25 pairs through
    System(sensor="stereo", async_mapping=False).track_stereo: state OK,
    >= 1 keyframe, >= 23 rows, ATE < 3 cm; two FAST launches and one
    stereo-band Hamming launch a frame. Counts set to 0 just before the
    run, read just after it."""
    import torch

    from plslam_torch.models import frame as mframe
    from plslam_torch.models.system import System
    from plslam_torch.models.tracking import OK
    from plslam_torch.utils import tum_io
    from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

    cam = cfg.camera
    scene = RoomScene(0)
    base = np.array([cam.bf / cam.fx, 0, 0], np.float32)
    n = STEREO_FRAMES
    poses = smooth_trajectory(2 * n)[:n]
    pairs = []
    for R, t in poses:
        gl, dl = scene.render(cam, R, t)
        gr, _ = scene.render(cam, R, t - base)
        pairs.append((np.clip(gl, 0, 255).astype(np.uint8), np.clip(gr, 0, 255).astype(np.uint8)))
        if len(pairs) == 1:
            depth0 = dl
    fd = mframe.build_frame_stereo(*(torch.as_tensor(x, device=dev) for x in pairs[0]), cfg)
    ok = (fd.kp_valid & (fd.kp_depth > 0)).cpu().numpy()
    xy = np.round(fd.kp_xy.cpu().numpy()[ok]).astype(int)
    gt_d = depth0[np.clip(xy[:, 1], 0, cam.height - 1), np.clip(xy[:, 0], 0, cam.width - 1)]
    rel = float(np.median(np.abs(fd.kp_depth.cpu().numpy()[ok] - gt_d) / np.maximum(gt_d, 1e-6)))
    require(ok.sum() > STEREO_DEPTH_POINTS, f"{ok.sum()} keypoints with stereo depth")
    require(rel < STEREO_DEPTH_REL, f"median relative stereo depth error {rel:.4f}")

    slam = System(cfg, sensor="stereo", async_mapping=False, device=dev)
    per_frame = []
    _reset_counts()
    with HammingProbe({"stereo band": (mframe, "build_frame_stereo")}) as probe:
        t0 = time.perf_counter()
        for i, (gl, gr) in enumerate(pairs):
            s = time.perf_counter()
            slam.track_stereo(gl, gr, i / 30.0)
            per_frame.append(time.perf_counter() - s)
        slam.tracker.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launches()
    tr = slam.tracker
    slam.shutdown()
    rows = len(tr.trajectory)
    require(tr.state == OK, f"tracker state {tr.state} after the run")
    require(slam.map.n_kf >= 1, f"{slam.map.n_kf} keyframes")
    require(rows >= n - 2, f"trajectory has {rows} rows for {n} frames")
    ts = np.array([s for s, _, _ in tr.trajectory])
    est = np.array([-(R.T @ t) for _, R, t in tr.trajectory])
    gt = np.array([-(R.T @ t) for R, t in poses])
    require(np.isfinite(est).all(), "non-finite camera centres")
    ate_m = tum_io.ate_rmse(ts, est, np.arange(n) / 30.0, gt)
    require(ate_m < STEREO_ATE_M, f"stereo ATE {ate_m:.4f} m")
    require(launches["fast_score_nms"] == 2 * n, f"launches {launches}: not two FAST a frame")
    require(probe.launches["stereo band"] == n,
            f"{probe.launches['stereo band']} stereo-band Hamming launches for {n} frames")
    return dict(frames=n, tracked=rows, keyframes=slam.map.n_kf, points=slam.map.n_points(),
                depth_points=int(ok.sum()), depth_median_rel_err=rel, fps=n / wall,
                **_latency(per_frame[1:]), ate_rmse_cm=ate_m * 100, launches=launches,
                stereo_band_launches=probe.launches["stereo band"]), probe.inputs


def mono_phase(cfg, dev):
    """The monocular sensor: tests/test_mono.py's scenario at its own width
    (RoomScene(0), smooth_trajectory(80)[:40]) through System(sensor="mono",
    async_mapping=False).track_monocular: fix_scale off, state OK, >= 2
    keyframes, > 100 points, >= 30 rows, camera centres within 5 cm of
    ground truth after a similarity alignment; the bootstrap's frame, model
    (H or F) and score ratio; Hamming launches of the bootstrap's window
    match and of the mapper's epipolar match (>= 1). Then three identical
    frames must leave a new System NOT_INITIALIZED with no keyframe."""
    import torch

    from plslam_torch.models import tracking as mtracking
    from plslam_torch.models import triangulation
    from plslam_torch.models.system import System
    from plslam_torch.utils import evaluate
    from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

    cam = cfg.camera
    scene = RoomScene(0)
    n = MONO_FRAMES
    poses = smooth_trajectory(2 * n)[:n]
    frames = [np.clip(scene.render(cam, R, t)[0], 0, 255).astype(np.uint8) for R, t in poses]
    slam = System(cfg, sensor="mono", async_mapping=False, device=dev)
    require(slam.cfg.loop.fix_scale is False, "a monocular System kept fix_scale")
    per_frame = []
    boot = None
    _reset_counts()
    with HammingProbe({"mono init window": (mtracking, "mono_init_match"),
                       "mono epipolar": (triangulation, "triangulate_pair_step")}) as probe:
        t0 = time.perf_counter()
        for i, g in enumerate(frames):
            s = time.perf_counter()
            slam.track_monocular(g, i / 30.0)
            per_frame.append(time.perf_counter() - s)
            if boot is None and slam.tracking_state == mtracking.OK:
                boot = i
        slam.tracker.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launches()
    tr = slam.tracker
    slam.shutdown()
    rows = len(tr.trajectory)
    require(tr.state == mtracking.OK, f"tracker state {tr.state} after the run")
    require(slam.map.n_kf >= 2, f"{slam.map.n_kf} keyframes")
    require(slam.map.n_points() > MONO_POINTS, f"{slam.map.n_points()} points")
    require(rows >= n - 10, f"trajectory has {rows} rows for {n} frames")
    ts = np.array([s for s, _, _ in tr.trajectory])
    est = np.array([-(R.T @ t) for _, R, t in tr.trajectory])
    require(np.isfinite(est).all(), "non-finite camera centres")
    idx = np.clip((ts * 30).round().astype(int), 0, n - 1)
    gt = np.array([-(poses[i][0].T @ poses[i][1]) for i in idx])
    sc, R_a, t_a = evaluate.umeyama_alignment(est, gt, with_scale=True)
    sim_rmse = float(np.sqrt((np.linalg.norm(sc * est @ R_a.T + t_a - gt, axis=1) ** 2).mean()))
    require(sim_rmse < MONO_SIM_RMSE_M, f"similarity-aligned RMSE {sim_rmse:.4f} m")
    st = tr.mono_init_stats
    require(st is not None and st["frame"] == boot and st["clear"], f"bootstrap {st}, {boot}")
    ratio = st["score_h"] / max(st["score_h"] + st["score_f"], 1e-9)
    require(probe.launches["mono init window"] >= 1, "no bootstrap window match launched")
    require(probe.launches["mono epipolar"] >= 1, "no epipolar Hamming launch from the mapper")
    # no parallax: identical frames must not bootstrap
    still = System(cfg, sensor="mono", async_mapping=False, device=dev)
    for i in range(3):
        still.track_monocular(frames[0], i / 30.0)
    require(still.tracking_state == mtracking.NOT_INITIALIZED and still.map.n_kf == 0,
            f"identical frames: state {still.tracking_state}, {still.map.n_kf} keyframes")
    still.shutdown()
    return dict(frames=n, tracked=rows, bootstrap_frame=boot, model="H" if ratio > 0.40 else "F",
                score_ratio_h=ratio, keyframes=slam.map.n_kf, points=slam.map.n_points(),
                fix_scale=slam.cfg.loop.fix_scale, fps=n / wall, **_latency(per_frame[boot + 1:]),
                sim_rmse_cm=sim_rmse * 100, scale=sc, launches=launches,
                mono_init_launches=probe.launches["mono init window"],
                epipolar_launches=probe.launches["mono epipolar"],
                no_parallax="NOT_INITIALIZED, 0 keyframes"), probe.inputs


def check_sensor_shapes(stereo_inputs, stereo_res, mono_inputs, mono_res):
    """Kernel 2 at the three shapes the sensor phases gave it, on their
    recorded inputs: the stereo left-right match (1024 x 1024, row-band /
    disparity / octave gate), the monocular bootstrap's match (1024 x 1024,
    100 px window) and the mapper's epipolar match on the monocular map
    (1024 x 1024); each exactly equal to its plain version, with the
    launches it made in its phase."""
    want = (("stereo band", stereo_inputs, stereo_res["stereo_band_launches"]),
            ("mono init window", mono_inputs, mono_res["mono_init_launches"]),
            ("mono epipolar", mono_inputs, mono_res["epipolar_launches"]))
    missing = [k for k, inputs, _ in want if k not in inputs]
    require(not missing, f"the sensor phases made no call at the shapes {missing}")
    out = []
    for kind, inputs, launches in want:
        rec = hold_and_time(kind, *inputs[kind])
        rec["launches"] = launches
        out.append(rec)
    return out


MS_B = 4                 # sequences tracked together (tests/test_multiseq.py's room)
MS_FRAMES = 40           # smooth_trajectory(80)[:40]
MS_RESCUE = (1, 12)      # (sequence, frame): a wrong velocity prior before that frame
MS_BLACKOUT = (3, (20, 21))  # (sequence, frames): uniform gray, no depth
MS_ATE_M = 0.03          # tests/test_multiseq.py's bar
MS_CENTRE_M = 0.001      # each sequence against its solo tracker
MS_STEREO = (2, 10)      # stereo sub-phase: sequences, pairs


class MultiseqProbe:
    """While active: per call of ``multiseq.batched_step`` the number of
    sequences and the FAST and Hamming launches made inside it, the batch
    sizes of the rescue stage, and the first batched FAST and per-problem
    local-map Hamming inputs (read from the wrappers' own counts)."""

    def __init__(self, n_seq):
        self.n_seq = n_seq
        self.steps = []      # (sequences, fast launches, hamming launches, rescue calls)
        self.rescue_batches = []
        self.inputs = {}
        self._saved = []

    def __enter__(self):
        from plslam_torch.models import tracking
        from plslam_torch.ops import fast, hamming, matching, orb
        from plslam_torch.parallel import multiseq

        probe = self
        step, rescue_core = multiseq.batched_step, tracking._rescue_core
        levels_fn, ham_fn = fast.fast_score_nms_levels, hamming.hamming_top2

        def counted_step(cfg, gray, depth, args, stereo=False):
            f0, h0, r0 = fast.fast_score_nms.launches, hamming.hamming_top2.launches, \
                len(probe.rescue_batches)
            out = step(cfg, gray, depth, args, stereo=stereo)
            probe.steps.append((gray.shape[0], fast.fast_score_nms.launches - f0,
                                hamming.hamming_top2.launches - h0,
                                len(probe.rescue_batches) - r0))
            return out

        def rescue(cfg, fd, *a):
            probe.rescue_batches.append(tuple(fd.kp_valid.shape[:-1]))
            return rescue_core(cfg, fd, *a)

        def levels(lv, th):
            if lv[0].dim() == 3 and lv[0].shape[0] == probe.n_seq:
                probe.inputs.setdefault("fast", ([x.clone() for x in lv], th))
            return levels_fn(lv, th)

        def ham(q, t, gate):
            if q.dim() == 3 and q.shape[0] == probe.n_seq and q.shape[1] >= 8192:
                probe.inputs.setdefault("hamming", (q.clone(), t.clone(), gate.clone()))
            return ham_fn(q, t, gate)

        class Proxy:
            hamming_top2 = staticmethod(ham)

            def __getattr__(self, name):
                return getattr(hamming, name)

        class FastProxy:
            fast_score_nms_levels = staticmethod(levels)

            def __getattr__(self, name):
                return getattr(fast, name)

        self._saved = [(multiseq, "batched_step", step), (tracking, "_rescue_core", rescue_core),
                       (matching, "hamming", hamming), (orb, "fast", fast)]
        multiseq.batched_step = counted_step
        tracking._rescue_core = rescue
        matching.hamming = Proxy()
        orb.fast = FastProxy()
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def _ms_trackers(cfg, dev, n, voc=None, sensor="rgbd"):
    """n trackers, each with its own map and synchronous LocalMapper (and,
    with a vocabulary, its own keyframe database)."""
    from plslam_torch.bow.database import KeyFrameDatabase
    from plslam_torch.models.local_mapping import LocalMapper
    from plslam_torch.models.map import SlamMap
    from plslam_torch.models.tracking import Tracker

    out = []
    for _ in range(n):
        m = SlamMap(cfg, device=dev)
        kfdb = None if voc is None else KeyFrameDatabase(voc, max_kf=cfg.capacity.max_keyframes)
        out.append(Tracker(cfg, m, local_mapper=LocalMapper(cfg, m, kfdb=kfdb), voc=voc,
                           kfdb=kfdb, sensor=sensor))
    return out


def _ms_wrong_prior(tracker, dev):
    import torch

    c, s = np.cos(np.radians(20.0)), np.sin(np.radians(20.0))
    tracker._R_vel = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=torch.float32,
                                  device=dev)
    tracker._t_vel = torch.tensor([0.4, 0.0, 0.0], device=dev)


def _ms_run(trackers, seqs, dev, batched, rescue=None):
    """Every sequence's frames through its tracker, solo (one after the
    other) or through one MultiTracker; ``rescue`` = (sequence, frame) gets
    a wrong velocity prior. Returns the per-frame states and rescue inliers
    (of the frame each call retired), the wall seconds (ending in a device
    sync) and the MultiTracker."""
    import torch

    from plslam_torch.parallel.multiseq import MultiTracker

    n = len(seqs[0])
    states = [[] for _ in seqs]
    rescued = [[] for _ in seqs]
    debug = [[] for _ in seqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mt = None
    if batched:
        mt = MultiTracker(trackers)
        for i in range(n):
            if rescue is not None and i == rescue[1]:
                _ms_wrong_prior(trackers[rescue[0]], dev)
            mt.process([q[i] for q in seqs], [i / 30.0] * len(seqs))
            for s, tr in enumerate(trackers):
                states[s].append(tr.state)
                rescued[s].append(tr.debug.get("rescue_inliers", 0))
                debug[s].append(dict(tr.debug, n_kf=tr.map.n_kf))
        mt.flush()
    else:
        for s, (tr, frames) in enumerate(zip(trackers, seqs)):
            for i, (g, d) in enumerate(frames):
                if rescue is not None and (s, i) == rescue:
                    _ms_wrong_prior(tr, dev)
                tr.process(g, d, i / 30.0)
                states[s].append(tr.state)
                rescued[s].append(tr.debug.get("rescue_inliers", 0))
                debug[s].append(dict(tr.debug, n_kf=tr.map.n_kf))
            tr.flush()
    torch.cuda.synchronize()
    return (states, rescued, debug), time.perf_counter() - t0, mt


def _ms_compare(solo, batched, log_solo, log_batched):
    """Per sequence: states and rescue inliers equal frame by frame, the
    same trajectory rows, camera centres within MS_CENTRE_M of the solo
    tracker's."""
    out, bad = [], []
    for s, (a, b) in enumerate(zip(solo, batched)):
        for k, what in enumerate(("states", "rescue inliers")):
            require(log_solo[k][s] == log_batched[k][s],
                    f"sequence {s}: {what} {log_batched[k][s]} batched, {log_solo[k][s]} solo")
        require([x[0] for x in a.trajectory] == [x[0] for x in b.trajectory],
                f"sequence {s}: {len(b.trajectory)} rows batched, {len(a.trajectory)} solo")
        d = [float(np.linalg.norm(-(Ra.T @ ta) + Rb.T @ tb))
             for (_, Ra, ta), (_, Rb, tb) in zip(a.trajectory, b.trajectory)]
        dc = max(d, default=0.0)
        if dc >= MS_CENTRE_M:
            first = next(i for i, x in enumerate(d) if x > 0)
            bad.append(f"sequence {s}: camera centres {dc * 100:.4f} cm from solo, first "
                       f"apart at row {first}; cm by row "
                       + " ".join(f"{x * 100:.3g}" for x in d)
                       + "; solo, batched at the rows around: "
                       + str([(log_solo[2][s][i], log_batched[2][s][i])
                              for i in range(max(first - 1, 0), min(first + 2, len(d)))]))
        out.append(dc)
    require(not bad, "\n".join(bad))
    return out


def multiseq_phase(cfg, dev):
    """B = 4 sequences (RoomScene(0..3) on smooth_trajectory(80)[:40], each
    tracker with its own map, synchronous LocalMapper and keyframe database)
    through one MultiTracker, against the same four run solo; sequence 1
    gets a wrong velocity prior at frame 12 (the rescue runs on a sub-batch),
    sequence 3 two blackout frames at 20-21 (it leaves the batch, steps solo,
    relocalizes or not). Then B = 2 stereo sequences (the first 10 pairs of
    tests/test_stereo.py's scenario on RoomScene(0) and (1)) against solo.
    Counts set to 0 just before the batched run, read just after it."""
    from plslam_torch.bow.vocabulary import Vocabulary
    from plslam_torch.models.tracking import OK
    from plslam_torch.utils import tum_io
    from plslam_torch.utils.synthetic import smooth_trajectory

    poses = smooth_trajectory(2 * MS_FRAMES)[:MS_FRAMES]
    f = cfg.tracking.depth_map_factor
    frames = render_jobs([(s, cfg.camera, R, t, f) for s in range(MS_B) for R, t in poses])
    seqs = [frames[s * MS_FRAMES:(s + 1) * MS_FRAMES] for s in range(MS_B)]
    bs, bframes = MS_BLACKOUT
    for i in bframes:
        g, d = seqs[bs][i]
        seqs[bs][i] = (np.full_like(g, 128), np.zeros_like(d))
    voc = Vocabulary.load(device=dev)
    solo = _ms_trackers(cfg, dev, MS_B, voc)
    st_solo, wall_solo, _ = _ms_run(solo, seqs, dev, False, MS_RESCUE)
    batched = _ms_trackers(cfg, dev, MS_B, voc)
    _reset_counts()
    with MultiseqProbe(MS_B) as probe:
        st_b, wall_b, mt = _ms_run(batched, seqs, dev, True, MS_RESCUE)
    launches = _launches()
    centres = _ms_compare(solo, batched, st_solo, st_b)
    gt = np.array([-(R.T @ t) for R, t in poses])
    ates = []
    for s, tr in enumerate(batched):
        if s == bs:
            continue
        rows = len(tr.trajectory)
        require(tr.state == OK and rows == MS_FRAMES and tr.map.n_kf >= 1,
                f"sequence {s}: state {tr.state}, {rows} rows, {tr.map.n_kf} keyframes")
        ts = np.array([x for x, _, _ in tr.trajectory])
        est = np.array([-(R.T @ t) for _, R, t in tr.trajectory])
        ate_m = tum_io.ate_rmse(ts, est, np.arange(MS_FRAMES) / 30.0, gt)
        require(ate_m < MS_ATE_M, f"sequence {s}: ATE {ate_m:.4f} m")
        ates.append(ate_m * 100)
    steps = probe.steps
    require(steps and all(f == 1 for _, f, _, _ in steps),
            f"FAST launches per batched step {[f for _, f, _, _ in steps]}")
    require(all(h == 3 + r for _, _, h, r in steps),
            f"Hamming launches per batched step {[(h, r) for _, _, h, r in steps]}")
    # the rescue runs on a sub-batch of one: sequence 1's wrong prior, and
    # sequence 3's two blackout frames, dispatched while it is still OK
    require(probe.rescue_batches == [(1,)] * 3,
            f"rescue batches {probe.rescue_batches}: not three sub-batches of one sequence")
    rs, ri = MS_RESCUE
    require(st_b[1][rs][ri + 1] > 100, f"sequence {rs}'s rescue did not carry frame {ri}: "
            f"{st_b[1][rs][ri + 1]} inliers")
    require("fast" in probe.inputs and "hamming" in probe.inputs,
            f"no batched kernel input recorded: {sorted(probe.inputs)}")
    lost = [i for i, x in enumerate(st_b[0][bs]) if x != OK]
    relocalized = bool(lost) and st_b[0][bs][-1] == OK
    seq_frames = MS_B * MS_FRAMES
    res = dict(
        sequences=MS_B, frames=MS_FRAMES, batched_steps=len(steps),
        batch_sizes=sorted({b for b, _, _, _ in steps}),
        fast_launches_per_step=sorted({f for _, f, _, _ in steps}),
        hamming_launches_per_step=sorted({h for _, _, h, _ in steps}),
        rescued_steps=sum(1 for *_, r in steps if r), launches=launches,
        seq_frames_per_s_batched=seq_frames / wall_b, seq_frames_per_s_solo=seq_frames / wall_solo,
        speedup=wall_solo / wall_b, wall_batched_s=wall_b, wall_solo_s=wall_solo,
        ate_rmse_cm=ates, centre_diff_to_solo_cm=[c * 100 for c in centres],
        keyframes=[tr.map.n_kf for tr in batched],
        seq3_lost_frames=lost, seq3_relocalized=relocalized,
        seq3_rows=len(batched[bs].trajectory))
    del solo, batched, mt

    # stereo: B = 2 sequences of pairs, batched against solo
    nb, npairs = MS_STEREO
    cam = cfg.camera
    base = np.array([cam.bf / cam.fx, 0, 0], np.float32)
    grays = render_jobs([(s, cam, R, t - shift, None) for s in range(nb)
                         for R, t in smooth_trajectory(50)[:npairs] for shift in (0, base)])
    spairs = [[(grays[2 * (s * npairs + i)], grays[2 * (s * npairs + i) + 1])
               for i in range(npairs)] for s in range(nb)]
    solo = _ms_trackers(cfg, dev, nb, sensor="stereo")
    st_solo, _, _ = _ms_run(solo, spairs, dev, False)
    batched = _ms_trackers(cfg, dev, nb, sensor="stereo")
    with MultiseqProbe(nb) as sprobe:
        st_b, _, _ = _ms_run(batched, spairs, dev, True)
    scentres = _ms_compare(solo, batched, st_solo, st_b)
    require(all(tr.state == OK for tr in batched), "a stereo sequence is not tracking")
    # a stereo step extracts ORB from both images (two FAST launches) and
    # matches left to right (one more Hamming launch)
    require(sprobe.steps and all(f == 2 and h == 4 + r for _, f, h, r in sprobe.steps),
            f"stereo launches per batched step {sprobe.steps}")
    res["stereo"] = dict(sequences=nb, pairs=npairs, batched_steps=len(sprobe.steps),
                         centre_diff_to_solo_cm=[c * 100 for c in scentres],
                         keyframes=[tr.map.n_kf for tr in batched])
    return res, probe.inputs


def check_multiseq_kernels(inputs, n_seq):
    """Both kernels on the inputs phase multiseq recorded: FAST over the B
    images' 8 pyramid levels in one launch, and the per-problem local-map
    Hamming launch (B x 8192 x 1024, one query set per sequence); each
    exactly equal to its plain version, timed beside its bound."""
    import torch

    from plslam_torch.ops import fast

    levels, th = inputs["fast"]
    before = fast.fast_score_nms.launches
    got = fast.fast_score_nms_levels(levels, th)
    require(fast.fast_score_nms.launches == before + 1,
            f"{n_seq} x 8 levels took {fast.fast_score_nms.launches - before} launches")
    for lvl, g in zip(levels, got):
        want = fast.fast_score_nms_plain(lvl, th)
        torch.cuda.synchronize()
        if not torch.equal(g, want):
            raise AssertionError(f"batched fast_score_nms differs at {tuple(lvl.shape)}: "
                                 f"{(g != want).sum().item()} pixels")
    npx = sum(x.numel() for x in levels)
    nsides = sum(pretest_sides(x[b], th) for x in levels for b in range(x.shape[0]))
    t_k, d_k = timings(lambda: fast.fast_score_nms_levels(levels, th))
    t_p, d_p = timings(lambda: [fast.fast_score_nms_plain(x, th) for x in levels])
    b, by = fast_bound(npx, nsides)
    log(f"  fast_score_nms_levels, {n_seq} images x 8 levels in one launch ({npx} px, "
        f"{nsides} sides pass the pre-test): kernel {t_k:.4f} ms (device {d_k:.4f}), plain "
        f"{t_p:.4f} ms (device {d_p:.4f}), bound {b * 1e3:.3f} us ({by})")
    fast_rec = dict(shape=f"{n_seq} x 8 pyramid levels in one launch", max_abs_err=0.0,
                    ms=t_k, device_ms=d_k, plain_ms=t_p, plain_device_ms=d_p, library_ms=None,
                    bound_ms=b, bound_by=by, pixels=npx, pretest_sides=nsides)
    ham_rec = hold_and_time("multiseq local map, per-problem queries", "hamming_top2",
                            *inputs["hamming"])
    return fast_rec, ham_rec


_SCENES = {}  # RoomScene by seed, in a render worker


def _render_job(job):
    """One frame of a render worker: (seed, camera, R, t, depth factor) ->
    uint8 gray and uint16 depth, or the gray alone without a factor."""
    from plslam_torch.utils.synthetic import RoomScene

    seed, cam, R, t, f = job
    if seed not in _SCENES:
        _SCENES[seed] = RoomScene(seed)
    gray, depth = _SCENES[seed].render(cam, R, t)
    gray = np.clip(gray, 0, 255).astype(np.uint8)
    return gray if f is None else (gray, np.clip(depth * f, 0, 65535).astype(np.uint16))


def render_jobs(jobs):
    """``_render_job`` of every job, on the host's cores (numpy rendering, no
    card: a pool of spawned processes, closed on return)."""
    import multiprocessing
    import os

    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        return pool.map(_render_job, jobs, chunksize=4)


def render(cfg, seed, poses):
    """uint8 gray and uint16 depth frames of RoomScene(seed) at ``poses``."""
    f = cfg.tracking.depth_map_factor
    return render_jobs([(seed, cfg.camera, R, t, f) for R, t in poses])


def multiseq_and_kernels(cfg, dev, kernels):
    """Phase multiseq, then both kernels on the inputs it recorded; their
    records join the kernels' entries."""
    msres, ms_inputs = multiseq_phase(cfg, dev)
    log("phase multiseq: ok, " + json.dumps(msres))
    fast_rec, ham_rec = check_multiseq_kernels(ms_inputs, MS_B)
    log("phase kernels (multiseq shapes): ok, batched FAST and per-problem Hamming exactly "
        "equal to their plain versions")
    for k, (name, rec) in enumerate((("fast_score_nms", fast_rec), ("hamming_top2", ham_rec))):
        kernels[k]["launches_multiseq_phase"] = msres["launches"][name]
        kernels[k]["multiseq_shape"] = rec


# ---------------------------------------------------------------- distributed
DIST_SHARDS = 4
# the whole-map GBA at the size of a long TUM sequence: bench.py's camera,
# cfg.orb.max_keypoints observations a keyframe, inside MapCapacity
DIST_MAP = dict(n_kf=256, n_pts=16384, obs_per_kf=1000, seed=1)
DIST_ERR_M = 0.01      # tests/test_parallel.py's bars: mean keyframe error,
DIST_VS_PCG_M = 0.005  # distributed against the single-device solver (max)

DIST_WORKER = r"""
import sys
import numpy as np
import torch
from plslam_torch.geometry.projection import Camera
from plslam_torch.parallel import ba, mesh

rank, rdv, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
assert mesh.initialize_distributed(init_method="file://" + rdv, world_size=2, rank=rank,
                                   timeout_s=120) == 2
assert torch.distributed.get_backend() == "gloo"
dev = torch.device("cuda", 0)
m = mesh.make_ba_mesh([dev] * 2)
assert (m.rank, m.world, m.n_shards) == (rank, 2, 4)
parts = [torch.stack([torch.full((4, 6, 6), 2.0 * rank + i + 1, device=dev) for i in range(2)])]
assert bool((m.psum(parts) == 10.0).all())
d = np.load(npz)
prob = ba.ShardedBA(*(d[f] for f in ba.ShardedBA._fields))
cam = Camera(*d["cam"].tolist()[:10], int(d["cam"][10]), int(d["cam"][11]))
R, t, X = ba.distributed_cg_step(cam, prob, m, lam=1e-3, cg_iters=int(d["cg_iters"]))
np.savez(out % rank, R=R.cpu().numpy(), t=t.cpu().numpy(), X=X.cpu().numpy())
torch.distributed.destroy_process_group()
print("rank", rank, "ok", flush=True)
"""


def _two_rank_step(cfg, sharded, ref, cg_iters, tmp):
    """Phase distributed (c): two gloo ranks on the same card, 2 shards each
    (a file:// rendezvous, 120 s), reduce the constants of the 4 global
    shards and take one distributed_cg_step of (b)'s problem, which must
    equal the in-process 4-shard step ``ref`` at 1e-5 relative."""
    import os

    npz = tmp / "problem.npz"
    cam = np.array(list(cfg.camera), np.float64)
    np.savez(npz, cam=cam, cg_iters=cg_iters, **dict(zip(sharded._fields, sharded)))
    script = tmp / "worker.py"
    script.write_text(DIST_WORKER)
    out = str(tmp / "out%d.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp / "rdv"), str(npz),
                               out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, log_) in enumerate(zip(procs, logs)):
        require(p.returncode == 0 and f"rank {r} ok" in log_, f"rank {r}:\n{log_[-3000:]}")
    worst = 0.0
    for r in (0, 1):
        d = np.load(out % r)
        for a, b in ((ref[0], d["R"]), (ref[1], d["t"]), (ref[2][2 * r:2 * r + 2], d["X"])):
            a = a.cpu().numpy()
            worst = max(worst, float(np.abs(a - b).max() / np.abs(a).max()))
    require(worst <= 1e-5, f"two-rank step against the in-process step: {worst:.3e} relative")
    return dict(ranks=2, backend="gloo", shards_per_rank=2, psum_1_to_4=10.0,
                step_max_rel_diff=worst, seconds=seconds)


def distributed_phase(cfg, dev):
    """Phase distributed: (a) the dry run's four phases on 4 shards of the
    card; (b) the whole-map GBA of a 256-keyframe make_synthetic_ba_map,
    gathered as the loop closer gathers it, solved by
    distributed_bundle_adjust on 4 shards of the card, by the single-device
    PCG and through the engine route (LocalMapper.run_local_ba with a
    4-shard mesh), with an abort after 2 steps; (c) two gloo ranks on the
    card against the in-process step."""
    import tempfile

    import torch

    from plslam_torch.models.local_mapping import LocalMapper
    from plslam_torch.models.loop_closing import global_ba_caps
    from plslam_torch.optim import ba_cg
    from plslam_torch.parallel import ba as pba
    from plslam_torch.parallel import dryrun
    from plslam_torch.parallel.mesh import make_ba_mesh
    from plslam_torch.utils.synthetic import make_synthetic_ba_map

    res = {}
    t0 = time.perf_counter()
    res["dry_run"] = dryrun.run(DIST_SHARDS, device=dev)
    res["dry_run"]["wall_s"] = time.perf_counter() - t0

    mc = cfg.mapping
    t0 = time.perf_counter()
    m, gt, _ = make_synthetic_ba_map(cfg, device=dev, **DIST_MAP)
    caps = global_ba_caps(m)
    g = LocalMapper(cfg, m).gather_ba(0, **caps)
    require(g is not None, "no global BA problem")
    nk = DIST_MAP["n_kf"]
    gt_c = np.array([-(R.T @ t) for R, t in gt])

    def kf_err(R, t):
        R, t = np.asarray(R)[:nk], np.asarray(t)[:nk]
        return np.linalg.norm(-np.einsum("kji,kj->ki", R, t) - gt_c, axis=1)

    err0 = kf_err(g.prob.cam_R.cpu().numpy(), g.prob.cam_t.cpu().numpy())
    mesh = make_ba_mesh([dev] * DIST_SHARDS)
    sharded = pba.shard_problem(*(t.cpu().numpy() for t in (
        g.prob.cam_R, g.prob.cam_t, g.prob.cam_fixed | ~g.prob.cam_valid, g.prob.pt_xyz,
        g.prob.pt_valid, g.prob.obs_cam, g.prob.obs_pt, g.prob.obs_uv, g.prob.obs_ur,
        g.prob.obs_w, g.prob.obs_valid)), n_shards=DIST_SHARDS)
    res["problem"] = dict(keyframes=nk, cameras=int(g.prob.cam_R.shape[0]), points=len(g.pids),
                          observations=len(g.oc), caps=caps, shards=DIST_SHARDS,
                          points_per_shard=[int(v.sum()) for v in sharded.pt_valid],
                          observations_per_shard=[int(v.sum()) for v in sharded.obs_valid],
                          initial_kf_err_mean_cm=float(err0.mean()) * 100,
                          build_s=time.perf_counter() - t0)

    def timed(fn):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - s

    calls = []
    real_step = pba.distributed_cg_step

    def counting_step(*a, **kw):
        calls.append(1)
        return real_step(*a, **kw)

    pba.distributed_cg_step = counting_step
    try:
        (Rd, td, Xd, inl), sec_d = timed(lambda: pba.distributed_bundle_adjust(
            cfg.camera, g.prob, mesh, iters=mc.distributed_ba_iters, cg_iters=mc.ba_cg_iters))
        steps = len(calls)
        calls.clear()
        pba.distributed_bundle_adjust(cfg.camera, g.prob, mesh, iters=mc.distributed_ba_iters,
                                      cg_iters=mc.ba_cg_iters,
                                      should_abort=lambda: len(calls) >= 2)
        aborted_after = len(calls)
    finally:
        pba.distributed_cg_step = real_step
    require(aborted_after == 2, f"an abort after 2 steps stopped after {aborted_after}")
    # the PCG on the observations alone: the gathered problem pads them to a
    # power of two on camera 0 and point 0, whose weight-0 terms all sum into
    # one slot of the sorted index_put_ (2.71 against 0.114 s an LM iteration
    # with the padding spread, python -m plslam_torch.utils.profile_gba)
    n_obs = len(g.oc)
    trimmed = g.prob._replace(**{f: getattr(g.prob, f)[:n_obs] for f in (
        "obs_cam", "obs_pt", "obs_uv", "obs_ur", "obs_w", "obs_valid")})
    pcg, sec_p = timed(lambda: ba_cg.bundle_adjust_cg_stepped(
        cfg.camera, trimmed, iters1=mc.local_ba_iters1, iters2=mc.local_ba_iters2,
        cg_iters=mc.ba_cg_iters))
    err_d = kf_err(Rd, td)
    err_p = kf_err(pcg.cam_R.cpu().numpy(), pcg.cam_t.cpu().numpy())
    c_d = -np.einsum("kji,kj->ki", Rd[:nk], td[:nk])
    c_p = -np.einsum("kji,kj->ki", pcg.cam_R[:nk].cpu().numpy(), pcg.cam_t[:nk].cpu().numpy())
    vs_pcg = float(np.linalg.norm(c_d - c_p, axis=1).max())
    require(np.isfinite(Xd).all() and err_d.mean() < DIST_ERR_M
            and err_d.mean() < 0.5 * err0.mean(),
            f"distributed GBA: mean keyframe error {err_d.mean() * 100:.3f} cm, initial "
            f"{err0.mean() * 100:.3f} cm")
    require(vs_pcg < DIST_VS_PCG_M, f"distributed against PCG: {vs_pcg * 1e3:.3f} mm")
    res["distributed"] = dict(seconds=sec_d, gn_steps=steps, cg_iters=steps * mc.ba_cg_iters,
                              kf_err_mean_cm=float(err_d.mean()) * 100,
                              kf_err_max_cm=float(err_d.max()) * 100,
                              inliers=int(inl.sum()), vs_pcg_max_mm=vs_pcg * 1e3,
                              abort_after_2_steps=aborted_after)
    lm_iters = mc.local_ba_iters1 + mc.local_ba_iters2
    res["pcg"] = dict(seconds=sec_p, lm_iters=lm_iters, cg_iters=lm_iters * mc.ba_cg_iters,
                      kf_err_mean_cm=float(err_p.mean()) * 100)

    # the engine route: run_local_ba on a fresh copy of the map, 4 shards
    m2, _, _ = make_synthetic_ba_map(cfg, device=dev, **DIST_MAP)
    mapper = LocalMapper(cfg, m2)
    mapper.ba_mesh = mesh
    solver, sec_e = timed(lambda: mapper.run_local_ba(0, **global_ba_caps(m2)))
    require(solver == "distributed", f"run_local_ba took {solver}")
    err_e = kf_err(m2.kf_R, m2.kf_t)
    require(err_e.mean() < DIST_ERR_M, f"engine route: {err_e.mean() * 100:.3f} cm")
    res["engine_route"] = dict(solver=solver, seconds=sec_e,
                               kf_err_mean_cm=float(err_e.mean()) * 100)

    ref = real_step(cfg.camera, sharded, mesh, lam=1e-3, cg_iters=mc.ba_cg_iters)
    with tempfile.TemporaryDirectory() as tmp:
        res["two_ranks"] = _two_rank_step(cfg, sharded, ref, mc.ba_cg_iters, Path(tmp))
    return res


# --------------------------------------------------------------------- loader
KITTI_PAIRS = 5


def _check_loader_frames(loaded, rgb_paths, depth_paths, factor):
    """Every frame TumLoader gave, bit for bit against the plain numpy + zlib
    decode of the same files (utils.png_io.decode_plain), in order."""
    from plslam_torch.utils.png_io import decode_plain

    require(len(loaded) == len(rgb_paths), f"{len(loaded)} frames of {len(rgb_paths)}")
    f32 = np.float32
    inv = f32(1.0) / f32(factor)
    for k, (rgb, d) in enumerate(zip(decode_plain(rgb_paths), decode_plain(depth_paths))):
        c = rgb.astype(f32)
        gray = f32(0.299) * c[..., 0] + f32(0.587) * c[..., 1] + f32(0.114) * c[..., 2]
        g, dep, _ = loaded[k]
        require(np.array_equal(g.view(np.int32), gray.view(np.int32)),
                f"frame {k}: gray differs from the plain decode")
        require(np.array_equal(dep.view(np.int32), (d[..., 0].astype(f32) * inv).view(np.int32)),
                f"frame {k}: depth differs from the plain decode")


def _kitti_run(cfg, dev, tmp):
    """run_kitti over KITTI_PAIRS stereo pairs of the room written as 8-bit
    gray PNGs with utils.png_io, read through the native decoder."""
    import contextlib
    import io

    from plslam_torch.utils import run_kitti
    from plslam_torch.utils.png_io import write_png
    from plslam_torch.utils.synthetic import smooth_trajectory

    cam = cfg.camera
    base = np.array([cam.bf / cam.fx, 0, 0], np.float32)
    poses = smooth_trajectory(2 * STEREO_FRAMES)[:KITTI_PAIRS]
    imgs = render_jobs([(0, cam, R, t, None) for R, t in poses]
                       + [(0, cam, R, t - base, None) for R, t in poses])
    seq = tmp / "kitti"
    for side in ("image_0", "image_1"):
        (seq / side).mkdir(parents=True)
    for i in range(KITTI_PAIRS):
        for side, img in (("image_0", imgs[i]), ("image_1", imgs[KITTI_PAIRS + i])):
            path = seq / side / f"{i:06d}.png"
            write_png(path, img)
            require(np.array_equal(run_kitti.load_gray(str(path)), img),
                    f"{path.name}: decoded gray differs from the written image")
    np.savetxt(seq / "times.txt", np.arange(KITTI_PAIRS) * 0.1)
    yaml = tmp / "KITTI.yaml"
    yaml.write_text("%YAML:1.0\n" + "".join(
        f"Camera.{k}: {getattr(cam, k)}\n" for k in ("fx", "fy", "cx", "cy", "bf", "width",
                                                     "height"))
                    + "Camera.fps: 10.0\nThDepth: 35\n")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = run_kitti.main([str(yaml), str(seq), "--out", str(tmp / "kitti_out"),
                             "--device", str(dev)])
    require(rc == 0, f"run_kitti exited {rc}")
    rows = np.loadtxt(tmp / "kitti_out" / "CameraTrajectory.txt", ndmin=2)
    require(rows.shape == (KITTI_PAIRS, 12) and np.isfinite(rows).all(),
            f"KITTI trajectory {rows.shape}")
    return dict(pairs=KITTI_PAIRS, rows=len(rows), seconds=time.perf_counter() - t0)


def loader_phase(cfg, dev, frames, poses):
    """Phase loader: the room's frames written as a TUM directory (8-bit RGB
    with equal channels, 16-bit depth x 5000, every row through one of the
    five PNG filters in turn) with utils.png_io; every frame TumLoader
    yields against the plain numpy + zlib decode, bit for bit; then
    ``python -m plslam_torch.utils.run_tum --native-loader`` (its ``main``,
    in this process, so that the launch counts are read) over the
    directory, with the counts set to 0 just before; then run_kitti over
    stereo pairs written the same way."""
    import contextlib
    import io
    import tempfile

    import torch

    from plslam_torch.native import TumLoader
    from plslam_torch.utils import run_tum, tum_io

    factor = cfg.tracking.depth_map_factor
    n = len(frames)
    res = {}
    with tempfile.TemporaryDirectory() as tmp_:
        tmp = Path(tmp_)
        seq = tmp / "seq"
        t0 = time.perf_counter()
        ts = np.arange(n) / 30.0
        tum_io.write_sequence(str(seq), [g for g, _ in frames], [d for _, d in frames], ts,
                              cfg.camera, factor)
        res["write_s"] = time.perf_counter() - t0
        assoc = tum_io.load_association(str(seq / "associate.txt"), str(seq))

        t0 = time.perf_counter()
        ld = TumLoader(str(seq / "associate.txt"), depth_factor=factor,
                       width=cfg.camera.width, height=cfg.camera.height, n_threads=4)
        loaded = list(ld)
        ld.close()
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _check_loader_frames(loaded, assoc.rgb_paths, assoc.depth_paths, factor)
        res["frames_exact"] = len(loaded)
        res["plain_check_s"] = time.perf_counter() - t0
        res["loader_fps_4_threads"] = n / decode_s
        del loaded

        out = tmp / "out"
        log_ = io.StringIO()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log_):
            rc = run_tum.main([str(seq / "settings.yaml"), str(seq / "associate.txt"),
                               "--out", str(out), "--native-loader", "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        text = log_.getvalue()
        require(rc == 0, f"run_tum exited {rc}:\n{text[-2000:]}")
        require("final state:          1" in text, f"run_tum's final state:\n{text[-2000:]}")
        fps = float(text.split("tracked fps:")[1].split()[0])
        ets, pos, _ = tum_io.load_trajectory_tum(str(out / "CameraTrajectory.txt"))
        require(len(ets) == n, f"{len(ets)} rows for {n} frames")
        gt = np.array([-(R.T @ t) for R, t in poses])
        rmse, mx = ate(pos[np.argsort(ets)], gt)
        require(rmse < ATE_LIMITS_M[0] and mx < ATE_LIMITS_M[1],
                f"run_tum ATE rmse {rmse:.4f} m max {mx:.4f} m")
        require(launches["fast_score_nms"] > 0 and launches["hamming_top2"] > 0,
                f"launches {launches}")
        res["run_tum"] = dict(rows=len(ets), tracked_fps=fps, wall_s=wall, run_fps=n / wall,
                              ate_rmse_cm=rmse * 100, ate_max_cm=mx * 100, launches=launches)
        res["kitti"] = _kitti_run(cfg, dev, tmp)
    return res


def distributed_and_log(cfg, dev):
    t0 = time.perf_counter()
    res = distributed_phase(cfg, dev)
    res["phase_s"] = time.perf_counter() - t0
    log("phase distributed: ok, " + json.dumps(res))


def loader_and_log(cfg, dev, frames, poses, kernels):
    """Phase loader; its launch counts join the kernels' entries."""
    t0 = time.perf_counter()
    res = loader_phase(cfg, dev, frames, poses)
    res["phase_s"] = time.perf_counter() - t0
    log("phase loader: ok, " + json.dumps(res))
    for k, name in enumerate(("fast_score_nms", "hamming_top2")):
        kernels[k]["launches_loader_phase"] = res["run_tum"]["launches"][name]


def main(argv) -> int:
    import faulthandler

    import torch

    faulthandler.enable()  # a crash in native code prints every thread's stack

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from plslam_torch.config import SlamConfig
    from plslam_torch.geometry.projection import Camera
    from plslam_torch.ops import cuda_build
    from plslam_torch.utils.synthetic import smooth_trajectory

    cfg = SlamConfig(camera=Camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0))
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, cuda {torch.version.cuda}")

    t = cuda_build.build(verbose=True)
    log(f"phase build: ok, {t:.1f} s for {len(cuda_build.KERNELS)} kernels")
    only = argv[2] if len(argv) == 3 and argv[1] == "--only" else None
    if argv[1:] and only not in ("multiseq", "distributed", "loader"):
        print(f"chip_smoke: unknown arguments {argv[1:]}", file=sys.stderr)
        return 2
    if only == "multiseq":  # a quick check of the one phase
        kernels = [{}, {}]
        multiseq_and_kernels(cfg, dev, kernels)
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0
    if only == "distributed":
        distributed_and_log(cfg, dev)
        return 0

    t0 = time.perf_counter()
    poses = smooth_trajectory(2 * N_FRAMES)[:N_FRAMES]
    frames = render(cfg, 0, poses)
    log(f"rendered {N_FRAMES} frames 640x480 in {time.perf_counter() - t0:.1f} s")
    if only == "loader":
        kernels = [{}, {}]
        loader_and_log(cfg, dev, frames, poses, kernels)
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0

    kernels = [check_fast(cfg, frames, dev), check_hamming(cfg, frames, dev)]
    kernels[1]["mapping_shapes"] = check_mapping_shapes(cfg, frames, poses, dev)
    kernels[1]["reloc_shape"] = check_reloc_shape(cfg, frames, dev)
    floors(cfg, dev)
    log("phase kernels: ok, both kernels exactly equal to their plain versions, "
        "Hamming also batched, at the mapper's shapes and at relocalization's")

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
    st_res, st_inputs = stereo_phase(cfg, dev)
    log("phase stereo: ok, " + json.dumps(st_res))
    mo_res, mo_inputs = mono_phase(cfg, dev)
    log("phase mono: ok, " + json.dumps(mo_res))
    for phase, r in (("stereo", st_res), ("mono", mo_res)):
        kernels[0][f"launches_{phase}_phase"] = r["launches"]["fast_score_nms"]
        kernels[1][f"launches_{phase}_phase"] = r["launches"]["hamming_top2"]
    kernels[1]["sensor_shapes"] = check_sensor_shapes(st_inputs, st_res, mo_inputs, mo_res)
    del st_inputs, mo_inputs
    log("phase kernels (sensor shapes): ok, kernel 2 exactly equal to its plain version at "
        "the stereo band, the monocular bootstrap window and the epipolar match")
    t0 = time.perf_counter()
    orbit_poses_ = orbit_poses(N_FRAMES)
    orbit = render(cfg, 3, orbit_poses_)
    log(f"rendered the orbit's {N_FRAMES} frames 640x480 in {time.perf_counter() - t0:.1f} s")
    rres = reloc_phase(cfg, dev, orbit, orbit_poses_)
    log("phase reloc: ok, " + json.dumps(rres))
    kernels[1]["launches_reloc_phase"] = (rres["blackout"]["hamming_launches"]
                                          + rres["blackout_fast"]["hamming_launches"])
    lres, loop_inputs, pcg = loop_phase(cfg, dev, orbit, orbit_poses_)
    log("phase loop: ok, " + json.dumps(lres))
    log("phase loop, PCG global BA: ok, " + json.dumps(pcg()))
    kernels[0]["launches_loop_phase"] = lres["launches"]["fast_score_nms"]
    kernels[1]["launches_loop_phase"] = (lres["launches"]["hamming_top2"]
                                         + lres["launches"]["hamming_top2_batched"])
    kernels[1]["launches_loop_phase_batched"] = lres["launches"]["hamming_top2_batched"]
    kernels[1]["launches_loop_search_and_fuse"] = lres["search_and_fuse_batched_launches"]
    kernels[1]["loop_shapes"] = check_loop_shapes(loop_inputs)
    log("phase kernels (loop shapes): ok, kernel 2 exactly equal to its plain version at "
        "the loop closer's five calls")
    with tempfile.TemporaryDirectory() as tmp:
        sres = system_phase(cfg, dev, frames, poses, Path(tmp))
    log("phase system: ok, " + json.dumps(sres))
    for k, name in enumerate(("fast_score_nms", "hamming_top2")):
        kernels[k]["launches_system_phase"] = sres["launches"][name]
    multiseq_and_kernels(cfg, dev, kernels)
    distributed_and_log(cfg, dev)
    loader_and_log(cfg, dev, frames, poses, kernels)

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
    sys.exit(main(sys.argv))
