"""Perception of the sampled frames, against the reference's recomputation
from the gray that was handed over (the wire's 6-bit reduction and the
pyramid redone):

- ``fast_mismatch_share``: the share of pyramid pixels (all levels) whose
  FAST score after NMS differs by more than ``FAST_TOL``;
- ``orb_keypoint_mismatch_share``: the keypoints (level, x, y) in one set
  and not the other, over both sets' sizes;
- ``orb_descriptor_bit_share``: over the keypoints in both sets, the share
  of descriptor bits that differ.

Every session steps in a sampled frame: one the program left out reads as
wrong in every pixel and keypoint. Control: the reference in bfloat16."""

import torch

from benchmark import reference as ref
from benchmark.checks import rows

NUMBERS = ("fast_mismatch_share", "orb_keypoint_mismatch_share", "orb_descriptor_bit_share")
CAPTURES = {"fast": "plslam_torch.ops.fast:fast_score_nms_levels",
            "frame": "plslam_torch.models.frame:build_frame"}
# FAST scores are float differences of pyramid pixels; the reference's
# bilinear resize rounds otherwise than the program's in the last bits
# (~1e-4 of a gray level), far below this
FAST_TOL = 1e-2


def readings(calls, ctx, control):
    oc = ctx.cfg.orb
    orb_cfg = dict(n_features=oc.n_features, scale_factor=oc.scale_factor,
                   n_levels=oc.n_levels, ini_th_fast=oc.ini_th_fast,
                   min_th_fast=oc.min_th_fast, cell_size=oc.cell_size,
                   max_kp_per_cell=oc.max_kp_per_cell, edge_threshold=oc.edge_threshold)
    bits = ctx.cfg.tracking.gray_wire_bits
    frames = {tag: res for tag, _, _, res in calls["frame"]}
    px = px_bad = kp_total = kp_bad = bits_total = bits_bad = 0
    for tag, _, _, maps in calls["fast"]:
        fd = frames.get(tag)
        n_img = maps[0].numel() // (maps[0].shape[-2] * maps[0].shape[-1])
        for b, s in enumerate(ctx.sessions):
            gray = torch.as_tensor(s.frame(tag)[0], device=ctx.device)
            want_maps, want = ref.orb(gray, orb_cfg, bits, torch.float32)
            if b >= n_img:
                px += sum(w.numel() for w in want_maps)
                px_bad += sum(w.numel() for w in want_maps)
                kp_total += len(want["level"])
                kp_bad += len(want["level"])
                continue
            if control:
                got_maps, got = ref.orb(gray, orb_cfg, bits, torch.bfloat16)
            else:
                got_maps = [rows(m, m.dim() - 2)[b] for m in maps]
                got = _program_keypoints(fd, b, oc) if fd is not None else None
            for w, g in zip(want_maps, got_maps):
                px += w.numel()
                px_bad += int(((w.float() - g.float()).abs() > FAST_TOL).sum())
            if got is None:
                continue
            kw = _keyed(want)
            kg = _keyed(got)
            common = kw.keys() & kg.keys()
            kp_total += len(kw) + len(kg)
            kp_bad += len(kw) + len(kg) - 2 * len(common)
            if common:
                dw = torch.stack([want["desc"][kw[k]] for k in common])
                dg = torch.stack([got["desc"][kg[k]] for k in common])
                x = (dw ^ dg).long()
                bits_bad += int(sum(((x >> i) & 1).sum() for i in range(8)))
                bits_total += 256 * len(common)
    return {
        "fast_mismatch_share": px_bad / px if px else 0.0,
        "orb_keypoint_mismatch_share": kp_bad / kp_total if kp_total else 0.0,
        "orb_descriptor_bit_share": bits_bad / bits_total if bits_total else 0.0,
    }


def _keyed(kp: dict) -> dict:
    """(level, y, x) -> row of a keypoint set."""
    keys = zip(kp["level"].tolist(), kp["y"].tolist(), kp["x"].tolist())
    return {k: i for i, k in enumerate(keys)}


def _program_keypoints(fd, b: int, oc) -> dict:
    """The program's valid keypoints of image ``b`` of a frame, at the pixel
    of their own level."""
    lead = fd.kp_valid.dim() - 1
    valid = rows(fd.kp_valid, lead)[b]
    level = rows(fd.kp_octave, lead)[b][valid].long()
    xy = rows(fd.kp_xy, lead)[b][valid].double()
    scale = torch.tensor([oc.scale_factor ** l for l in range(oc.n_levels)],
                         dtype=torch.float64, device=xy.device)[level]
    return {"level": level, "x": torch.round(xy[:, 0] / scale).long(),
            "y": torch.round(xy[:, 1] / scale).long(),
            "desc": rows(fd.kp_desc, lead)[b][valid]}
