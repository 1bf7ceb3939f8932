"""Carry configuration and map state into the port.

There are no weights; what crosses between the JAX package and this one is
configuration and map state, as plain Python / numpy values:

- :func:`config_from_dict` builds a :class:`SlamConfig` from
  ``dataclasses.asdict`` of the JAX package's ``SlamConfig``.
- :func:`map_from_numpy` builds a :class:`SlamMap` from a JAX ``SlamMap``'s
  numpy arrays, obs dicts, counters, keyframe snapshots and descriptor
  arenas.
- :func:`ba_problem_from_numpy` builds a local-BA problem from a JAX
  ``BAProblem``'s arrays, so that both packages solve the same problem.
- :func:`vocabulary_from_numpy` builds a :class:`Vocabulary` from a JAX
  ``Vocabulary``'s node descriptors and idf, and :func:`kfdb_from_numpy` a
  :class:`KeyFrameDatabase` from a JAX database's per-keyframe sparse bows,
  so that both packages start from one database as from one map.
"""

from __future__ import annotations

import numpy as np
import torch

from .bow.database import KeyFrameDatabase
from .bow.vocabulary import Vocabulary
from .config import (CloudConfig, LineConfig, LoopConfig, MapCapacity,
                     MappingConfig, MatcherConfig, OrbConfig, SlamConfig,
                     TrackingConfig)
from .geometry.projection import Camera
from .models.frame import FrameData
from .models.map import HostFrame, SlamMap
from .optim import local_ba

_SECTIONS = dict(orb=OrbConfig, lines=LineConfig, matcher=MatcherConfig,
                 tracking=TrackingConfig, mapping=MappingConfig, loop=LoopConfig,
                 capacity=MapCapacity, cloud=CloudConfig)


def config_from_dict(d: dict) -> SlamConfig:
    """``SlamConfig`` from ``dataclasses.asdict(jax_cfg)``. The camera may
    arrive as a dict or as the JAX package's ``Camera`` NamedTuple (``asdict``
    keeps NamedTuples as they are)."""
    cam = d["camera"]
    camera = Camera(**cam) if isinstance(cam, dict) else Camera(*cam)
    kw = {name: cls(**{k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in d[name].items()})
          for name, cls in _SECTIONS.items()}
    return SlamConfig(camera=camera, use_lines=bool(d["use_lines"]), **kw)


# numpy arrays of SlamMap that carry across as they are
_ARRAYS = (
    "kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_timestamp", "kf_pt_idx",
    "kf_ln_idx", "kf_parent", "kf_cull_parent", "kf_cull_Rcp", "kf_cull_tcp",
    "pt_pos", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_valid",
    "pt_first_kf", "pt_visible", "pt_found",
    "ln_ep", "ln_desc", "ln_valid", "ln_first_kf", "ln_visible", "ln_found",
    "ln_normal", "ln_min_dist", "ln_max_dist",
)


def map_from_numpy(arrays: dict, cfg: SlamConfig, device="cuda") -> SlamMap:
    """A :class:`SlamMap` on ``device`` from a JAX ``SlamMap``'s state.

    ``arrays`` holds, by the JAX map's attribute names: every numpy array of
    ``_ARRAYS``; ``pt_obs`` / ``ln_obs`` (lists of {kf: feat} dicts);
    ``kf_children`` (list of sets); the counters ``n_kf``, ``_pt_next``,
    ``_ln_next``; ``kf_frames`` (per-keyframe snapshots with the
    ``HostFrame`` fields, or None); and the device descriptor arenas as numpy,
    ``pt_desc_arena`` (max_points, 32) and ``ln_desc_arena`` (max_lines, 72).
    Optional ``kf_frames_dev``: per keyframe its full FrameData as numpy
    fields (what the JAX map keeps on its device), or None; without it the
    port uploads a keyframe's host snapshot on first use.
    """
    m = SlamMap(cfg, device=device)
    for name in _ARRAYS:
        src = np.asarray(arrays[name])
        dst = getattr(m, name)
        if src.shape != dst.shape:
            raise ValueError(f"map_from_numpy: {name} has shape {src.shape}, "
                             f"the port's config needs {dst.shape}")
        dst[...] = src
    m.pt_obs = [dict(o) for o in arrays["pt_obs"]]
    m.ln_obs = [dict(o) for o in arrays["ln_obs"]]
    m.kf_children = [set(c) for c in arrays["kf_children"]]
    m.n_kf = int(arrays["n_kf"])
    m._pt_next = int(arrays["_pt_next"])
    m._ln_next = int(arrays["_ln_next"])
    m.kf_frames = [None if f is None else HostFrame(f) for f in arrays["kf_frames"]]
    for kf, fd in enumerate(arrays.get("kf_frames_dev") or []):
        if fd is not None:
            m.kf_frames_dev[kf] = FrameData(*(torch.from_numpy(np.array(getattr(fd, f)))
                                              .to(m.device) for f in FrameData._fields))
    m._pt_desc_dev = torch.from_numpy(np.array(arrays["pt_desc_arena"], np.uint8)).to(m.device)
    m._ln_desc_dev = torch.from_numpy(np.array(arrays["ln_desc_arena"], np.uint8)).to(m.device)
    return m


def ba_problem_from_numpy(arrays: dict, device="cuda") -> local_ba.BAProblem:
    """A :class:`local_ba.BAProblem` on ``device`` from a JAX ``BAProblem``
    as numpy arrays, by field name (``prob._asdict()``); index fields become
    int64."""
    out = {}
    for name in local_ba.BAProblem._fields:
        a = np.array(arrays[name])
        if name in ("obs_cam", "obs_pt", "lobs_cam", "lobs_ln"):
            a = a.astype(np.int64)
        out[name] = torch.from_numpy(a).to(device)
    return local_ba.BAProblem(**out)


def vocabulary_from_numpy(node_desc, idf, device="cuda") -> Vocabulary:
    """A :class:`Vocabulary` on ``device`` from per-level node descriptors
    ((k^(l+1), 32) uint8 each) and the leaf idf (k^L,)."""
    return Vocabulary([np.asarray(d, np.uint8) for d in node_desc],
                      np.asarray(idf, np.float32), device=device)


def kfdb_from_numpy(voc: Vocabulary, bows, max_kf: int) -> KeyFrameDatabase:
    """A :class:`KeyFrameDatabase` of ``max_kf`` slots holding, for keyframe
    ``kf``, the sparse bow ``bows[kf]`` = (word ids, values) (a JAX
    database's ``get_bow(kf)``), or nothing where it is None. Keyframes are
    added in index order."""
    db = KeyFrameDatabase(voc, max_kf=max_kf)
    for kf, bow in enumerate(bows):
        if bow is not None and bow[0] is not None:
            db.add(kf, (np.asarray(bow[0]), np.asarray(bow[1])))
    return db
