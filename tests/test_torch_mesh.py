"""plslam_torch.parallel.mesh: process groups and shard layouts.

- ``initialize_distributed`` is a no-op in one process;
- ``make_mesh``'s (dp, obs) split equals the JAX package's for 1, 2, 4 and
  8 devices;
- two gloo processes (a ``file://`` rendezvous, 2 CPU shards each) reduce
  the 4 global shards' constants 1..4 to 10, and one ``distributed_cg_step``
  of theirs on ``tests/test_parallel.py::small_problem`` equals the
  in-process 4-shard step at 1e-5 relative (the sums run in another order),
  as does a 2-step ``distributed_bundle_adjust``, whose points each rank
  gathers from both.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from plslam_tpu.parallel import mesh as jmesh
from plslam_torch import convert
from plslam_torch.parallel import ba as tpba
from plslam_torch.parallel import mesh as tmesh
from test_parallel import CAM, small_problem
from torch_parity import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import numpy as np
import torch
from plslam_torch import convert
from plslam_torch.parallel import ba, mesh
from test_torch_mesh import problem

rank, rdv, npz, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
assert mesh.initialize_distributed(init_method="file://" + rdv, world_size=2, rank=rank,
                                   timeout_s=50) == 2
assert torch.distributed.get_backend() == "gloo"
m = mesh.make_ba_mesh([torch.device("cpu")] * 2)
assert (m.rank, m.world, m.n_shards) == (rank, 2, 4)
parts = [torch.stack([torch.full((3, 6, 6), 2.0 * rank + i + 1) for i in range(2)])]
assert bool((m.psum(parts) == 10.0).all())
d = np.load(npz)
prob = ba.shard_problem(*(d[f"a{i}"] for i in range(11)), n_shards=4)
cam = convert.Camera(*d["cam"].tolist())
R, t, X = ba.distributed_cg_step(cam, prob, m, cg_iters=32)
Rb, tb, Xb, inl = ba.distributed_bundle_adjust(cam, problem(d), m, iters=2, cg_iters=16)
np.savez(out % rank, R=R.numpy(), t=t.numpy(), X=X.numpy(), Rb=Rb, Xb=Xb, inl=inl)
torch.distributed.destroy_process_group()
print("rank", rank, "ok", flush=True)
"""


def problem(d):
    """The engine's BA problem (float32, CPU) of the saved small_problem."""
    from plslam_torch.optim import local_ba

    a = [d[f"a{i}"] for i in range(11)]
    C, P, O = len(a[0]), len(a[3]), len(a[5])
    t = lambda x, dt=None: torch.as_tensor(np.asarray(x), dtype=dt)  # noqa: E731
    return local_ba.make_problem(C, P, O, 1, 1, device="cpu")._replace(
        cam_R=t(a[0]), cam_t=t(a[1]), cam_fixed=t(a[2]), cam_valid=torch.ones(C, dtype=bool),
        pt_xyz=t(a[3]), pt_valid=t(a[4]), obs_cam=t(a[5], torch.int64),
        obs_pt=t(a[6], torch.int64), obs_uv=t(a[7]), obs_ur=t(a[8]), obs_w=t(a[9]),
        obs_valid=t(a[10]))


def test_initialize_distributed_is_a_noop_in_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.initialize_distributed() == 1
    assert tmesh.initialize_distributed(world_size=1) == 1
    assert not dist.is_initialized()
    m = tmesh.make_ba_mesh()
    assert m.group is None and m.n_shards == 1


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_split_equals_jax(n):
    assert tmesh.make_mesh(n, devices=[torch.device("cpu")] * 8).shape == \
        dict(jmesh.make_mesh(n).shape)
    assert tmesh.make_ba_mesh([torch.device("cpu")] * n).shape == \
        dict(jmesh.make_ba_mesh(n).shape)


def test_two_gloo_processes_reduce_and_step(tmp_path):
    args, _, _ = small_problem(np.random.default_rng(0))
    npz = tmp_path / "problem.npz"
    np.savez(npz, cam=np.array(CAM, np.float64), **{f"a{i}": a for i, a in enumerate(args)})
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = str(tmp_path / "out%d.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "rdv"),
                               str(npz), out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {r} ok" in log, log[-3000:]

    mesh4 = tmesh.make_ba_mesh([torch.device("cpu")] * 4)
    R4, t4, X4 = tpba.distributed_cg_step(convert.Camera(*CAM),
                                          tpba.shard_problem(*args, n_shards=4), mesh4,
                                          cg_iters=32)
    Rb, _, Xb, inl = tpba.distributed_bundle_adjust(convert.Camera(*CAM),
                                                    problem(np.load(npz)), mesh4, iters=2,
                                                    cg_iters=16)
    for r in (0, 1):
        d = np.load(out % r)
        for a, b in ((R4.numpy(), d["R"]), (t4.numpy(), d["t"]),
                     (X4[2 * r:2 * r + 2].numpy(), d["X"]), (Rb, d["Rb"]), (Xb, d["Xb"])):
            assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
        assert (inl == d["inl"]).mean() >= 0.999  # every shard's points, gathered
