"""plslam_torch — the RGB-D point+line tracking frontend in PyTorch + CUDA.

A port of the repository's JAX/XLA/Pallas package for one NVIDIA H100. The
module layout and names follow the JAX package: ``ops/fast.py`` here is the
counterpart of ``ops/fast.py`` there. The two Pallas kernels of the JAX
package are hand-written CUDA kernels here (``csrc/``), built with ``nvcc``
at first use; every other op is plain PyTorch. The port imports neither JAX
nor the JAX package.

Layer map:
  models/    Frame construction, map arenas, the Tracking state machine
  ops/       pyramid, FAST (+ CUDA kernel), ORB, LSD, LBD, Hamming top-2
             (+ CUDA kernel), point and line matching
  optim/     pose-only Levenberg–Marquardt
  geometry/  SE3 / projection / Plücker primitives
  utils/     the synthetic RGB-D room

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
