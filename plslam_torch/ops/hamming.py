"""256-bit Hamming distances and the fused gated top-2 (CUDA kernel).

``hamming_top2`` is the matcher's hot loop: for each query descriptor, the
best and second-best Hamming distance over the gated target columns and the
argmin (lowest index on ties). On a CUDA tensor it launches the
hand-written kernel ``csrc/hamming_top2.cu``, which never materializes the
(N, M) distance matrix; on CPU tensors it runs :func:`hamming_top2_plain`.
The kernel chooses per 16 x 512 tile, on the device, between a sparse walk
over the gated pairs and the tensor cores; :func:`dense_tiles` counts the
tiles that took the tensor cores.

Replaces the reference's per-pair popcount loop
(``ORBmatcher::DescriptorDistance``, ORBmatcher.cc:2083-2104).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

BIG = 1 << 20  # distance of a fully gated row


def unpack_bits(desc_u8: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 descriptors -> (N, 256) uint8 bits (LSB-first per byte,
    matching the OpenCV byte layout used by ops.orb)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_u8.device)
    bits = (desc_u8[:, :, None] >> shifts) & 1  # (N, 32, 8)
    return bits.reshape(desc_u8.shape[0], 256)


def hamming_matrix(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances. a: (N, 32) u8, b: (M, 32) u8 -> (N, M) i32.

    hamming(a, b) = |a| + |b| - 2 a.b over 0/1 bit vectors: a float32 matrix
    product of integers <= 256, exact (TF32 is off, see the package init)."""
    a = unpack_bits(a_u8).float()
    b = unpack_bits(b_u8).float()
    g = a @ b.T
    return (a.sum(1)[:, None] + b.sum(1)[None, :] - 2.0 * g).to(torch.int32)


def hamming_pairs(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """Row-wise Hamming distance between aligned pairs: (N,32),(N,32)->(N,)."""
    return unpack_bits(a_u8 ^ b_u8).to(torch.int32).sum(1)


def hamming_top2_plain(q_desc, t_desc, gate):
    """Plain PyTorch version of the kernel: (best, idx, second) int32 (N,)."""
    n, m = q_desc.shape[0], t_desc.shape[0]
    big = torch.full((), BIG, dtype=torch.int32, device=q_desc.device)
    if m == 0:
        full = big.expand(n).clone()
        return full, torch.full_like(full, -1), full.clone()
    masked = torch.where(gate, hamming_matrix(q_desc, t_desc), big)
    best, idx = masked.min(1)  # first minimum
    idx = idx.to(torch.int32)
    cols = torch.arange(m, device=q_desc.device)
    second = torch.where(cols[None, :] == idx[:, None], big, masked).amin(1)
    idx = torch.where(best < BIG, idx, torch.full_like(idx, -1))
    return best, idx, second


def _check(name, x, dtype, shape):
    if x.device.type != "cuda" or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"hamming_top2: {name} must be a contiguous CUDA "
                         f"{dtype} tensor of shape {shape}, got "
                         f"{x.device} {x.dtype} {tuple(x.shape)}")


def hamming_top2(q_desc: torch.Tensor, t_desc: torch.Tensor, gate: torch.Tensor):
    """Fused gated Hamming top-2. q_desc (N,32) u8, t_desc (M,32) u8,
    gate (N,M) bool -> (best (N,), idx (N,), second (N,)) int32.

    ``best``/``second`` are BIG and ``idx`` is -1 on a row with nothing
    gated. CUDA tensors go through the kernel, CPU tensors through
    :func:`hamming_top2_plain`; both give the same values."""
    if q_desc.device.type == "cpu":
        return hamming_top2_plain(q_desc, t_desc, gate)
    n, m = q_desc.shape[0], t_desc.shape[0]
    _check("q_desc", q_desc, torch.uint8, (n, 32))
    _check("t_desc", t_desc, torch.uint8, (m, 32))
    _check("gate", gate, torch.bool, (n, m))
    for name, x in (("q_desc", q_desc), ("t_desc", t_desc)):
        if x.data_ptr() % 16:
            raise ValueError(f"hamming_top2: {name} must be 16-byte aligned")
    if m >= 1 << 22:
        raise ValueError(f"hamming_top2: at most 2^22 - 1 targets, got {m}")
    best = torch.empty(n, dtype=torch.int32, device=q_desc.device)
    idx = torch.empty_like(best)
    second = torch.empty_like(best)
    if n == 0:
        return best, idx, second
    fn = cuda_build.function("hamming_top2", "hamming_top2_launch",
                             [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    counter = _dense_counter(q_desc.device)
    with torch.cuda.device(q_desc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q_desc.data_ptr(), t_desc.data_ptr(), gate.data_ptr(), n, m,
                 best.data_ptr(), idx.data_ptr(), second.data_ptr(),
                 counter.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hamming_top2 kernel launch failed: cudaError {err}")
    hamming_top2.launches += 1
    return best, idx, second


hamming_top2.launches = 0

_dense_counters: dict[torch.device, torch.Tensor] = {}


def _dense_counter(device: torch.device) -> torch.Tensor:
    """The int32 on ``device`` that the kernel adds 1 to per tensor-core tile."""
    c = _dense_counters.get(device)
    if c is None:
        c = _dense_counters[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return c


def dense_min_pairs() -> int:
    """The kernel's threshold: a 16 x 512 tile with more gated pairs runs on
    the tensor cores (read from the built library; needs nvcc)."""
    return cuda_build.function("hamming_top2", "hamming_dense_min_pairs", [])()


def dense_tiles() -> int:
    """Tiles that took the tensor-core path since the last call, summed over
    devices; waits for the device and sets the counts back to 0.
    Instrumentation for tests and the smoke run: nothing else reads it."""
    total = 0
    for c in _dense_counters.values():
        total += int(c.item())
        c.zero_()
    return total
