"""Process groups and shard layouts for the landmark-sharded bundle
adjustment, the port of the JAX package's ``parallel/mesh.py``.

The reference's parallelism is 5-7 pthreads over shared memory; there is no
distributed backend to translate. The port's scalable axes are those of the
JAX package:

- ``dp``: data parallel over keyframes or sequences;
- ``obs``: observation / landmark sharding for bundle-adjustment
  reductions: each shard Schur-eliminates its landmark block and the
  contributions to the reduced camera system are summed over this axis.

Where the JAX package names the devices of a device mesh and reduces
with ``psum`` inside ``shard_map``, the port lists the devices of this
process's shards (several shards may share one device: ``[cpu] * S`` in
the tests, ``[cuda:0] * S`` on one card) and reduces with
:meth:`BAMesh.psum`: the shards on one device are one stack with the shard
axis leading (one launch per operation for all of them), partial sums of
other devices of the process go to the first one, and the sum is
all-reduced over the process group, if there is one.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist


def _local_world_size(world_size: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, timeout_s: float = 1800.0) -> int:
    """Join the process group of a multi-process run and return the global
    device count (one device per rank: its own GPU, or its CPU or shared
    card under gloo; without a group, the GPUs of this process, or 1).

    The arguments default to the standard variables (``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, as ``torchrun`` sets them);
    ``init_method`` may name a ``tcp://`` or ``file://`` rendezvous instead.
    The backend is NCCL when every rank has a GPU of its own (the host's
    GPUs cover ``LOCAL_WORLD_SIZE`` ranks) and gloo otherwise: CPU ranks,
    or ranks that share one card. Idempotent; a no-op in a single process.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1") or 1)
    if rank is None:
        rank = int(env.get("RANK", "0") or 0)
    if world_size <= 1:
        return torch.cuda.device_count() if torch.cuda.is_available() else 1
    own_gpu = (torch.cuda.is_available()
               and torch.cuda.device_count() >= _local_world_size(world_size))
    backend = "nccl" if own_gpu else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


def _rank_device() -> torch.device:
    """The device this rank computes on inside a process group."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class BAMesh:
    """The 1-D ``obs`` layout the distributed BA reduces over: the devices of
    this process's landmark shards, and the process group that joins the
    processes, if any. Every process holds as many shards; rank r holds
    global shards ``r * n_local .. (r + 1) * n_local - 1``."""

    def __init__(self, devices, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1
        # runs of consecutive shards on one device: one stacked launch each
        self.runs = []
        start = 0
        for i in range(1, len(self.devices) + 1):
            if i == len(self.devices) or self.devices[i] != self.devices[start]:
                self.runs.append((self.devices[start], start, i))
                start = i

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        return self.n_local * self.world

    @property
    def shape(self) -> dict:
        return {"obs": self.n_shards}

    def _host_if_gloo(self, x: torch.Tensor) -> torch.Tensor:
        # gloo reduces host memory: a CUDA tensor goes through the host
        if x.is_cuda and dist.get_backend(self.group) == "gloo":
            return x.cpu()
        return x

    def psum(self, parts) -> torch.Tensor:
        """The sum over every shard of the mesh, on ``devices[0]``: ``parts``
        holds one stack per run (shard axis leading)."""
        total = None
        for p in parts:
            s = p.sum(0).to(self.devices[0])
            total = s if total is None else total + s
        if self.group is not None:
            buf = self._host_if_gloo(total)
            dist.all_reduce(buf, group=self.group)
            total = buf.to(self.devices[0])
        return total

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """This process's shard stack ``x`` (n_local, ...) joined with every
        other process's, in global shard order, on ``devices[0]``."""
        if self.group is None:
            return x
        buf = self._host_if_gloo(x.contiguous())
        out = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(out, buf, group=self.group)
        return torch.cat(out).to(self.devices[0])


def make_ba_mesh(devices=None, group=None) -> BAMesh:
    """The landmark-shard mesh: by default one shard per visible GPU of this
    process (one on the CPU without a GPU), or, inside a process group, one
    shard on this rank's device reduced over the group."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if devices is None:
        if group is not None:
            devices = [_rank_device()]
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cpu")]
    return BAMesh(devices, group)


class Mesh:
    """A 2-D ``(dp, obs)`` layout of devices (a numpy array of
    ``torch.device``): ``row(d)`` is the ``obs`` mesh of data-parallel
    index ``d``."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "obs": devices.shape[1]}

    def row(self, d: int) -> BAMesh:
        return BAMesh(list(self.devices[d]))


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              devices=None) -> Mesh:
    """A ``(dp, obs)`` mesh over the first ``n_devices`` of ``devices``
    (default: the visible GPUs, or one CPU). Without ``dp``, observation
    sharding is favoured: dp is 4 or 2 where that leaves at least 2 obs
    shards, else 1 (the JAX package's split)."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    devs = list(devices)[: n_devices or len(devices)]
    n = len(devs)
    if dp is None:
        dp = 1
        for cand in (4, 2):
            if n % cand == 0 and n >= cand * 2:
                dp = cand
                break
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(dp, n // dp))
