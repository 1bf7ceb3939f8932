"""One run of one cell: set-up, warm-up, the measured window, the metrics,
and the comparison with the plain reference that decides ``correct``.

The configuration is built the way a user of ``run_tum`` builds it: the
settings file (here written from the configuration's ``settings``) goes
through ``plslam_torch.config.load_yaml``, and the runner's garbage
collector policy (``gctune.tune_gc``) applies. Each session is one camera:
a room of its own seen along the traffic's periodic path from its own
starting frame. Its frames are rendered on the device once, in set-up, by
the configuration's sensor (``sensors/<sensor>.py``), and handed to the
system (``systems/<system>.py``) from the host as the camera delivers them.
Where the traffic has blackouts, the sensor's blank view replaces them.

The loop is closed: the next frame of every session is handed over when the
system's step returns. The tracker retires a frame one call later, so a
frame's age runs from its hand-over to the return of the call that retired
it; the last frames retire in the ``flush`` that closes the window.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import checks, scene
from .hooks import Hooks

FORBIDDEN = ("jax", "jaxlib", "flax", "plslam_tpu")
RENDER_CHUNK = 24
# a kernel launched at a known host time at the start of the profiled slice:
# it ties the trace's clock to the host's
MARKER_KERNEL = "spin_kernel"


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def refuse_forbidden(when: str):
    """Ends the run, with no result, if a forbidden module is loaded."""
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded {when}: {', '.join(bad)}")


def host_probe_ms(reps: int = 5) -> float:
    """The median of ``reps`` timings of a fixed piece of pure-Python work
    (ms): how fast the host runs the tracker's kind of code right now, the
    evidence for a slow host (the machine's load average and clock are not
    reported inside its sandbox)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        sum(i * i for i in range(200_000))
        times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[reps // 2]


def slam_config(conf: dict):
    """The ``SlamConfig`` a user gets from the configuration's settings file,
    with the map capacity and the line budget the configuration states."""
    from plslam_torch.config import MapCapacity, load_yaml

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "settings.yaml")
        with open(path, "w") as f:
            f.write("%YAML:1.0\n")
            for k, v in conf["settings"].items():
                f.write(f"{k}: {v!r}\n")
        cfg = load_yaml(path)
    return cfg.replace(capacity=MapCapacity(**conf["capacity"]),
                       lines=dataclasses.replace(cfg.lines, **conf["lines"]))


class Session:
    """One camera: its rendered frames on the host and its ground truth.

    Camera k sees the room of textures ``scene_seed + k`` whatever the
    seed: every seed gets the same frames, and draws which of them the
    reference checks (tracking accuracy swings with any change of the
    pixels, see PERF.md)."""

    def __init__(self, k: int, cfg, conf: dict, traffic: dict, sensor, device):
        self.k = k
        self.sensor = sensor
        period = traffic["period_frames"]
        n = conf["sequence_frames"]
        first = k * traffic["session_stagger_frames"]
        self.phase = (first + np.arange(n)) % period
        self.gt_R, self.gt_t = scene.path_poses(self.phase, period, **traffic["path"])
        self.warmup = traffic["warmup_frames"]
        self.blackout = traffic.get("blackout")
        room = scene.Room(conf["scene_seed"] + k, device)
        self.streams = None
        for i in range(0, n, RENDER_CHUNK):
            R = torch.as_tensor(self.gt_R[i:i + RENDER_CHUNK], dtype=torch.float32, device=device)
            t = torch.as_tensor(self.gt_t[i:i + RENDER_CHUNK], dtype=torch.float32, device=device)
            views = sensor.render(room, cfg, R, t)
            if self.streams is None:
                self.streams = [np.empty((n,) + tuple(x.shape[1:]), dtype)
                                for x, (_, dtype) in zip(views, sensor.STREAMS)]
            for arr, x in zip(self.streams, views):
                arr[i:i + len(R)] = x.cpu().numpy().astype(arr.dtype)
        del room
        self.hand: dict[int, float] = {}   # frame counter -> hand-over time
        self.age: dict[int, float] = {}    # frame counter -> age (s)

    def blanked(self, c: int) -> bool:
        """Whether frame ``c`` falls in a blackout: the last ``frames`` of
        every ``every`` frames after warm-up."""
        b = self.blackout
        return bool(b) and c >= self.warmup and (c - self.warmup) % b["every"] >= \
            b["every"] - b["frames"]

    def frame(self, c: int):
        i = c % len(self.streams[0])
        view = tuple(arr[i] for arr in self.streams)
        return self.sensor.blank(view) if self.blanked(c) else view

    def gt(self, counters: np.ndarray):
        i = np.asarray(counters) % len(self.streams[0])
        return self.gt_R[i], self.gt_t[i]


class System:
    """What a module of ``systems/`` builds: ``n`` trackers, each with its
    own map and local mapper (on its own thread where the configuration's
    ``mapper`` is ``"async"``). A module's class sets ``counters`` (the
    object whose numeric attributes the readers see at the window's start
    and end) and ``step(frames, timestamps)``: one frame of every session."""

    def __init__(self, cfg, conf: dict, device, n: int):
        from plslam_torch.models.async_mapping import AsyncLocalMapper
        from plslam_torch.models.local_mapping import LocalMapper
        from plslam_torch.models.map import SlamMap
        from plslam_torch.models.tracking import Tracker

        self.trackers, self.mappers = [], []
        for _ in range(n):
            m = SlamMap(cfg, device=device)
            mapper = LocalMapper(cfg, m)
            if conf["mapper"] == "async":
                mapper = AsyncLocalMapper(mapper)
            self.mappers.append(mapper)
            self.trackers.append(Tracker(cfg, m, local_mapper=mapper))
        self.counters = None

    def steady(self) -> bool:
        """Every tracker tracks, with a local map: a frame of the window's
        common path."""
        from plslam_torch.models.tracking import OK

        return all(tr.state == OK and tr._lm_args is not None for tr in self.trackers)

    def flush(self):
        for tr in self.trackers:
            tr.flush()

    def settle(self):
        """Drain the trackers and let the mappers finish their keyframes."""
        self.flush()
        for mp in self.mappers:
            if hasattr(mp, "wait_idle"):
                mp.wait_idle()

    def close(self) -> list[str]:
        """Stops the mappers' threads; their errors."""
        errors = []
        for mp in self.mappers:
            if hasattr(mp, "shutdown"):
                mp.wait_idle(timeout=60.0)
                mp.shutdown()
            if getattr(mp, "error", None) is not None:
                errors.append(repr(mp.error))
        return errors


def retire(session, entries, now: float, fps: float):
    """Ages of the frames whose poses ``entries`` (trajectory rows
    (timestamp, R, t), the timestamp frame counter / fps) came back at
    ``now``; frames handed over before the window (warm-up) have none."""
    for ts, _, _ in entries:
        c = int(round(ts * fps))
        if c in session.hand:
            session.age[c] = now - session.hand[c]


class Run:
    """What a metric reader sees of one run."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.frames = 0              # sequence-frames retired in the window
        self.ages_s: list[float] = []
        self.spans: dict = {}
        self.counters = {"start": {}, "end": {}}
        self.slice = None            # the profiled slice, in a --trace 1 run
        self.host_frames = 0         # sequence-frames handed before the slice

    def span_s(self, label: str) -> float:
        """Host seconds in ``label``'s spans that started in the window
        before the profiled slice (``host_frames`` counts its frames)."""
        return sum(e - s for s, e, _ in self.spans.get(label, [])
                   if self.t_window[0] <= s < self.t_host_end)

    def host_s(self) -> float:
        """Seconds of the window before the profiled slice."""
        return self.t_host_end - self.t_window[0]

    def span_union_s(self, label: str) -> float:
        """Length of the union of ``label``'s spans, clipped to the window
        before the profiled slice."""
        iv = sorted((max(s, self.t_window[0]), min(e, self.t_host_end))
                    for s, e, _ in self.spans.get(label, []))
        total, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _snapshot(obj) -> dict:
    return {k: v for k, v in vars(obj).items() if type(v) in (int, float)}


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", tweak=None, control: bool = False) -> dict:
    """Runs ``workload`` once. ``tweak(conf, traffic)`` may change the
    configuration and traffic first (the tests' small sizes); ``control``
    adds the readings of the control (the reference, in the precision below
    the configuration's, in the program's place) to the result."""
    from plslam_torch.utils import gctune

    cell = spec.workload(workload)
    conf = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if tweak is not None:
        tweak(conf, traffic)
    cuda = device == "cuda"
    host0 = host_probe_ms()
    cfg = slam_config(conf)
    fps = traffic["fps"]
    sensor = spec.sensor(conf["sensor"])
    sessions = [Session(k, cfg, conf, traffic, sensor, device) for k in range(conf["sessions"])]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    system = spec.system(conf["system"]).build(cfg, conf, device)
    trackers = system.trackers
    gctune.tune_gc()
    corr = conf["correct"]
    oracles = {name: spec.oracle(name) for name in corr["oracles"]}

    def step(c: int):
        system.step([s.frame(c) for s in sessions], [c / fps] * len(sessions))

    hooks = Hooks()
    run = Run()
    readers = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in spec.metrics(workload, kind):
        readers[m["name"]] = (m, spec.reader(m["name"]))
    in_slice = [False]
    try:
        for name, mod in oracles.items():
            for label, target in mod.CAPTURES.items():
                hooks.record(checks.capture_label(name, label), target,
                             lambda: hooks.tag is not None, main_only=True, copy=True)
        if trace:
            for _, mod in readers.values():
                for label, target in getattr(mod, "SPANS", {}).items():
                    if label not in hooks.spans:
                        hooks.span(label, target)
                for label, target in getattr(mod, "SLICE_CALLS", {}).items():
                    if label.startswith("correct."):
                        raise ValueError(f"{label!r} is a label of the correctness captures")
                    if label not in hooks.calls:
                        hooks.record(label, target, lambda: in_slice[0])

        warm = traffic["warmup_frames"]
        for c in range(warm):
            step(c)
        system.settle()
        if cuda:
            torch.cuda.synchronize()
        prof = None
        if trace and cuda:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
        refuse_forbidden("after set-up")
        run.setup_s = time.perf_counter() - t_start

        # ---------------------------------------------------------- window
        rng = np.random.default_rng([seed, 20_211])
        every = corr["sample_every"]
        offset = int(rng.integers(every))
        n_samples = 0
        sl = conf["trace_slice"]
        slice_rec = None
        n_before = [0] * len(trackers)
        run.counters["start"] = _snapshot(system.counters)
        c = warm
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            if trace and slice_rec is None and now >= deadline - sl["before_end_s"]:
                # the profiler's tracing slows every launch once it has
                # started, so the slice closes the window and the host spans
                # end where it begins
                if cuda:
                    torch.cuda.synchronize()
                run.t_host_end = time.perf_counter()
                slice_rec = {"handed": 0, "steps": 0, "marker": None}
                if prof is not None:
                    prof.start()
                    torch.cuda.synchronize()
                    slice_rec["marker"] = time.perf_counter()
                    torch.cuda._sleep(1000)
                in_slice[0] = True
                slice_rec["t0"] = time.perf_counter()
                _log(f"profiler started in {slice_rec['t0'] - run.t_host_end:.3f} s, "
                     f"{deadline - slice_rec['t0']:.3f} s before the window's end")
            hooks.tag = None
            if (not in_slice[0] and n_samples < corr["max_samples"]
                    and (c - warm - offset) % every == 0 and system.steady()):
                hooks.tag = c
                n_samples += 1
            h = time.perf_counter()
            for s in sessions:
                s.hand[c] = h
            step(c)
            r = time.perf_counter()
            hooks.tag = None
            for k, tr in enumerate(trackers):
                retire(sessions[k], tr.trajectory[n_before[k]:], r, fps)
                n_before[k] = len(tr.trajectory)
            if in_slice[0]:
                slice_rec["handed"] += len(sessions)
                slice_rec["steps"] += 1
            elif slice_rec is None:
                run.host_frames += len(sessions)
            c += 1
            if in_slice[0] and slice_rec["steps"] == sl["steps"]:
                if cuda:
                    torch.cuda.synchronize()
                slice_rec["t1"] = time.perf_counter()
                if prof is not None:
                    prof.stop()
                in_slice[0] = False
        system.flush()
        if cuda:
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        if in_slice[0]:  # the window closed inside the slice
            slice_rec["t1"] = t_end
            if prof is not None:
                prof.stop()
            in_slice[0] = False
        for k, tr in enumerate(trackers):
            retire(sessions[k], tr.trajectory[n_before[k]:], t_end, fps)
        run.counters["end"] = _snapshot(system.counters)
        run.t_window = (t0, t_end)
        if slice_rec is None:
            run.t_host_end = t_end
        run.window_s = t_end - t0
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        refuse_forbidden("when the window closed")
    finally:
        hooks.close()

    attempted = sum(len(s.hand) for s in sessions)
    retired = sum(len(s.age) for s in sessions)
    run.frames = retired
    run.ages_s = [a for s in sessions for a in s.age.values()]
    run.spans = hooks.spans
    if trace and slice_rec is not None:
        run.slice = _read_slice(prof, slice_rec, hooks.calls, readers, cuda)

    metrics = {}
    for name, (m, mod) in readers.items():
        v = mod.read(run)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": m["unit"]}
    breakdown = _breakdown(run) if run.slice else None

    # the program's state goes before the reference runs
    errors = system.close()
    system = trackers = prof = hooks.tag = None
    gctune.untune_gc()
    if cuda:
        torch.cuda.empty_cache()

    ctx = SimpleNamespace(sessions=sessions, cfg=cfg, device=device)
    t_ref = time.perf_counter()
    readings = checks.readings(oracles, hooks.calls, ctx)
    host1 = host_probe_ms()
    _log(f"{workload} seed {seed}: setup_s {run.setup_s:.3f}, {attempted} sequence-frames "
         f"handed and {retired} retired in {run.window_s:.3f} s, {n_samples} steps sampled, "
         f"reference {time.perf_counter() - t_ref:.3f} s; host probe {host0:.3f} ms at "
         f"the start, {host1:.3f} ms at the end")
    limits = corr["limits"]
    compared = {name: {"value": readings[name], "limit": limits[name]} for name in limits}
    correct = not errors and all(v["value"] <= v["limit"] for v in compared.values())
    for e in errors:
        _log(f"mapper error: {e}")
    out = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": attempted - retired,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
        "host_probe_ms": [host0, host1],
    }
    if trace and run.slice:
        out["device"]["busy_s"] = run.slice["busy_s"]
        out["device"]["window_s"] = run.slice["wall_s"]
        out["breakdown"] = breakdown
    if control:
        out["control"] = checks.readings(oracles, hooks.calls, ctx, control=True)
        out["readings"] = readings
    out["checks"] = compared
    refuse_forbidden("when the result was made")
    return out


def _read_slice(prof, rec: dict, calls: dict, readers: dict, cuda: bool) -> dict:
    """The profiled slice: its kernels (name, start µs, end µs on the
    trace's clock), the device's busy seconds (the union of their
    intervals), the host's clock at the trace's zero (from the marker
    kernel, None without it) and the calls the readers asked for."""
    kernels, marker = [], None
    if cuda:
        dev = torch.autograd.DeviceType.CUDA
        for e in prof.events():
            if e.device_type == dev:
                if MARKER_KERNEL in e.name and marker is None:
                    marker = e.time_range.start
                    continue
                kernels.append((e.name, e.time_range.start, e.time_range.end))
    kernels.sort(key=lambda k: k[1])
    cur_s, cur_e = None, None
    merged = []
    for _, s, e in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
    busy = sum(e - s for s, e in merged) / 1e6
    labels = {label for _, mod in readers.values() for label in getattr(mod, "SLICE_CALLS", {})}
    if marker is None and cuda:
        _log("the marker kernel is not in the trace: idle gaps are not attributed")
    return {
        "t0": rec["t0"], "t1": rec["t1"], "wall_s": rec["t1"] - rec["t0"],
        "frames": rec["handed"], "kernels": kernels, "busy_intervals": merged,
        "busy_s": busy,
        # the marker launched right after the host read rec["marker"]: its
        # start, less a launch's latency (microseconds), is that moment
        "host_at_zero_s": rec["marker"] - marker / 1e6 if marker is not None else None,
        "calls": {label: calls.get(label, []) for label in labels},
    }


def _breakdown(run: Run) -> dict:
    """The ten device operations that took most time in the slice, and the
    idle gaps between kernels summed by the host span that held the main
    thread at the time (the innermost one; "other" outside every span),
    where the marker tied the trace's clock to the host's."""
    sl = run.slice
    by_name: dict[str, float] = {}
    for name, s, e in sl["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"device_ops": [[n[:200], v] for n, v in ops]}
    if sl["host_at_zero_s"] is None:
        return out
    spans = [(s, e, label) for label, iv in run.spans.items() for s, e, _ in iv
             if e >= sl["t0"] and s <= sl["t1"]]
    spans.sort(key=lambda x: x[1] - x[0])
    gaps: dict[str, float] = {}
    busy = sl["busy_intervals"]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = sl["host_at_zero_s"] + (e0 + s1) / 2e6
        label = next((lab for s, e, lab in spans if s <= mid <= e), "other")
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e6
    out["idle_gaps"] = [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]
    return out
