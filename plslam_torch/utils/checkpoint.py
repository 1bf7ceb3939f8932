"""Map checkpoint / resume.

The port of the JAX package's ``utils/checkpoint.py``, in its ``.npz``
layout, so that each package loads the other's files. The reference has NO
map persistence (every ORB-SLAM2 run starts from scratch); here the whole
world model serializes to one ``.npz``: arena arrays verbatim, observation
dicts as (id, kf, feat) triples, the descriptor arenas fetched from the
device (host mirrors are zeros for tracker-created landmarks by design; see
models.map), and the keyframe feature snapshots stacked per field.

Typical use: save after a mapping session, reload with
``System(..., localization_only=True)`` and relocalize against the stored
keyframe database.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bow.vocabulary import sparse_bow
from ..models.frame import FrameData
from ..models.map import HostFrame, SlamMap

_PT_FIELDS = ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist",
              "pt_valid", "pt_first_kf", "pt_visible", "pt_found")
_LN_FIELDS = ("ln_ep", "ln_valid", "ln_first_kf", "ln_visible", "ln_found",
              "ln_normal", "ln_min_dist", "ln_max_dist")
_KF_FIELDS = ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_timestamp",
              "kf_pt_idx", "kf_ln_idx", "kf_parent",
              "kf_cull_parent", "kf_cull_Rcp", "kf_cull_tcp")


def _obs_triples(obs_list, n):
    return np.array([(i, kf, feat) for i in range(n) for kf, feat in obs_list[i].items()],
                    np.int64).reshape(-1, 3)


def save_map(m: SlamMap, path, extra: dict | None = None):
    """Serialize a SlamMap (device descriptor arenas fetched once).
    ``extra``: more named arrays for the file (diagnostics)."""
    data = {f: np.array(getattr(m, f)) for f in _PT_FIELDS + _LN_FIELDS + _KF_FIELDS}
    data.update(n_kf=np.int64(m.n_kf), pt_next=np.int64(m._pt_next),
                ln_next=np.int64(m._ln_next), big_change_idx=np.int64(m.big_change_idx),
                pt_desc=m.point_desc_arena().cpu().numpy(),
                ln_desc=m.line_desc_arena().cpu().numpy(),
                pt_obs=_obs_triples(m.pt_obs, m._pt_next),
                ln_obs=_obs_triples(m.ln_obs, m._ln_next),
                loop_edges=np.array(m.loop_edges, np.int64).reshape(-1, 2))
    # keyframe feature snapshots: the device copy where there is one (the
    # tracker's host snapshots zero-fill the device-only fields)
    kfs = [k for k in range(m.n_kf) if m.kf_valid[k]]
    data["kf_rows"] = np.array(kfs, np.int64)
    if kfs:
        for field in FrameData._fields:
            data[f"fd_{field}"] = np.stack([
                getattr(m.kf_frames_dev[k], field).cpu().numpy()
                if m.kf_frames_dev[k] is not None else getattr(m.kf_frames[k], field)
                for k in kfs])
    data.update(extra or {})
    np.savez_compressed(path, **data)


def load_map(cfg, path, device="cuda") -> SlamMap:
    """Rebuild a SlamMap on ``device`` from a ``save_map`` file of either
    package. The descriptor arenas are uploaded whole from the file; the
    keyframe snapshots are ``HostFrame``s, uploaded on first use
    (``SlamMap.device_frame``)."""
    z = np.load(path)
    m = SlamMap(cfg, device=device)
    for f in _PT_FIELDS + _LN_FIELDS + _KF_FIELDS:
        if f in z:  # tolerate checkpoints from before a field existed
            getattr(m, f)[:] = z[f]
    m.n_kf = int(z["n_kf"])
    m._pt_next = int(z["pt_next"])
    m._ln_next = int(z["ln_next"])
    m.big_change_idx = int(z["big_change_idx"])
    m.pt_desc[:] = z["pt_desc"]
    m.ln_desc[:] = z["ln_desc"]
    m._pt_desc_dev = torch.tensor(m.pt_desc, device=m.device)
    m._ln_desc_dev = torch.tensor(m.ln_desc, device=m.device)
    if "loop_edges" in z:
        m.loop_edges = [(int(a), int(b)) for a, b in z["loop_edges"]]
    for i, kf, feat in z["pt_obs"]:
        m.pt_obs[i][int(kf)] = int(feat)
    for i, kf, feat in z["ln_obs"]:
        m.ln_obs[i][int(kf)] = int(feat)
    for k in range(m.n_kf):
        p = int(m.kf_parent[k])
        if p >= 0:
            m.kf_children[p].add(k)
    for row, k in enumerate(z["kf_rows"]):
        m.kf_frames[int(k)] = HostFrame(FrameData(*(z[f"fd_{f}"][row]
                                                    for f in FrameData._fields)))
    return m


def register_keyframes(system):
    """Re-register loaded keyframes with the BoW database so that
    relocalization and loop detection work against the restored map."""
    m = system.map
    for k in range(m.n_kf):
        if m.kf_valid[k]:
            fd = m.device_frame(k)
            _, bow = system.voc.transform(fd.kp_desc, fd.kp_valid)
            system.kfdb.add(k, sparse_bow(bow))
