"""plslam_torch — point+line RGB-D SLAM in PyTorch + CUDA.

A port of the repository's JAX/XLA/Pallas package for one NVIDIA H100. The
module layout and names follow the JAX package: ``ops/fast.py`` here is the
counterpart of ``ops/fast.py`` there. The two Pallas kernels of the JAX
package are hand-written CUDA kernels here (``csrc/``), built with ``nvcc``
at first use; every other op is plain PyTorch. The port imports neither JAX
nor the JAX package.

Layer map:
  models/    the System facade (system.py) over tracking (the RGB-D
             state machine), local mapping and its worker thread, loop
             closing, relocalization, the map arenas (with compaction),
             frame construction and the dense point cloud (pointcloud.py)
  bow/       the BoW vocabulary and the keyframe database
  ops/       pyramid, FAST (+ CUDA kernel), ORB, LSD, LBD, Hamming top-2
             (+ CUDA kernel), point and line matching
  optim/     pose LM, local BA, Horn / Sim3 / EPnP RANSAC, the SE(3) and
             Sim(3) essential graphs, the PCG global BA
  geometry/  SE3 (and quaternions) / Sim3 / projection / Plücker primitives
  utils/     tracing, TUM / KITTI trajectory I/O and ATE evaluation, map
             checkpoints, GC tuning, the viewer, the file-driven runner
             (``python -m plslam_torch.utils.run_tum``), the synthetic
             RGB-D room, and on-card probes (bench, profile_frames,
             mma_rate, orbit_probe)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; they
never fall back to the CPU on their own.

TF32 is switched OFF for the whole package: the pose LM's normal
equations, the LBD distance matrix and the undistortion are float32 or
integer work whose results TF32 would change (it keeps ~10 mantissa bits).
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
