"""Carry configuration and map state into the port.

There are no weights; what crosses between the JAX package and this one is
configuration and map state, as plain Python / numpy values:

- :func:`config_from_dict` builds a :class:`SlamConfig` from
  ``dataclasses.asdict`` of the JAX package's ``SlamConfig``.
- :func:`map_from_numpy` builds a :class:`SlamMap` from a JAX ``SlamMap``'s
  numpy arrays, obs dicts, counters, keyframe snapshots and descriptor
  arenas.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import (CloudConfig, LineConfig, LoopConfig, MapCapacity,
                     MappingConfig, MatcherConfig, OrbConfig, SlamConfig,
                     TrackingConfig)
from .geometry.projection import Camera
from .models.map import HostFrame, SlamMap

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
    "kf_ln_idx", "kf_parent",
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
    m._pt_desc_dev = torch.as_tensor(np.asarray(arrays["pt_desc_arena"], np.uint8),
                                     device=m.device).clone()
    m._ln_desc_dev = torch.as_tensor(np.asarray(arrays["ln_desc_arena"], np.uint8),
                                     device=m.device).clone()
    return m
