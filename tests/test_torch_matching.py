"""plslam_torch Hamming top-2 and point matching against the JAX package.

Hamming distances are integers, so every comparison here is exact:

- the port's plain ``hamming_top2`` equals the JAX Pallas kernel
  (``pallas_matching.hamming_top2``, interpret mode, at the size
  ``tests/test_pallas_matching.py`` uses) including a fully gated row,
  where both give best = second = BIG and idx = -1;
- it equals a numpy brute force at a ragged 100x77 with planted ties on
  the best distance (lowest index wins, second = best);
- ``match_descriptors`` returns MatchResults identical to the JAX
  package's, with and without ratio test, rotation check and dedupe.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.ops import matching as jmatch
from plslam_tpu.ops import pallas_matching
from plslam_torch.ops import hamming as tham
from plslam_torch.ops import matching as tmatch

BIG = 1 << 20


def test_plain_equals_pallas_interpret():
    rng = np.random.default_rng(0)
    N, M = 256, 384
    q = rng.integers(0, 256, (N, 32), np.uint8)
    t = rng.integers(0, 256, (M, 32), np.uint8)
    gate = rng.random((N, M)) < 0.3
    gate[5] = False  # fully gated row
    want = pallas_matching.hamming_top2(jnp.asarray(q), jnp.asarray(t),
                                        jnp.asarray(gate), interpret=True)
    got = tham.hamming_top2(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(gate))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got[0][5] == BIG and got[1][5] == -1 and got[2][5] == BIG


def _brute(q, t, gate):
    x = q[:, None, :] ^ t[None, :, :]
    d = np.unpackbits(x, axis=-1).sum(-1).astype(np.int64)
    d = np.where(gate, d, BIG)
    best = d.min(1)
    idx = np.where(best < BIG, d.argmin(1), -1)
    d2 = d.copy()
    d2[np.arange(len(q)), np.clip(idx, 0, None)] = BIG
    return best, idx, d2.min(1)


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_equals_brute_force_ragged_with_ties(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (100, 32), np.uint8)
    t = rng.integers(0, 256, (77, 32), np.uint8)
    # planted ties: queries 0..9 have exact twins at two target columns
    t[10:20] = q[:10]
    t[40:50] = q[:10]
    gate = rng.random((100, 77)) < 0.6
    gate[:10, 10:20] = True
    gate[:10, 40:50] = True
    gate[17] = False
    got = [x.numpy() for x in tham.hamming_top2(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(gate))]
    want = _brute(q, t, gate)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert (got[0][:10] == 0).all() and (got[2][:10] == 0).all()
    np.testing.assert_array_equal(got[1][:10], 10 + np.arange(10))


def test_hamming_matrix_and_pairs():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (50, 32), np.uint8)
    b = rng.integers(0, 256, (60, 32), np.uint8)
    want = np.unpackbits(a[:, None] ^ b[None], axis=-1).sum(-1)
    np.testing.assert_array_equal(
        tham.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
    np.testing.assert_array_equal(
        tham.hamming_pairs(torch.from_numpy(a), torch.from_numpy(b[:50])).numpy(),
        np.diag(want[:, :50]))


def _match_inputs(seed, n=300, m=280):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 256, (m, 32), np.uint8)
    q = rng.integers(0, 256, (n, 32), np.uint8)
    # near-duplicates (few flipped bits) so matches pass max_dist / ratio
    src = rng.integers(0, m, n // 2)
    q[: n // 2] = t[src] ^ (rng.random((n // 2, 32)) < 0.03).astype(np.uint8)
    # two queries per target in places, for the dedupe
    q[n // 2: n // 2 + 20] = q[:20]
    gate = rng.random((n, m)) < 0.4
    gate[np.arange(n // 2), src] = True
    gate[3] = False
    ang_q = rng.uniform(0, 360, n).astype(np.float32)
    ang_t = ((ang_q[: n // 2] + rng.normal(15, 3, n // 2)) % 360).astype(np.float32)
    ang_t = np.concatenate([ang_t, rng.uniform(0, 360, m - n // 2)])[:m].astype(np.float32)
    ang_t[src] = ((ang_q[: n // 2] + 15) % 360).astype(np.float32)
    return q, t, gate, ang_q, ang_t


@pytest.mark.parametrize("nn_ratio", [None, 0.9, 0.75])
@pytest.mark.parametrize("rotation", [False, True])
@pytest.mark.parametrize("dedupe", [False, True])
def test_match_descriptors(nn_ratio, rotation, dedupe):
    q, t, gate, aq, at = _match_inputs(4)
    kw = dict(nn_ratio=nn_ratio, dedupe=dedupe, histo_length=30)
    jkw, tkw = dict(kw), dict(kw)
    if rotation:
        jkw.update(angle_q=jnp.asarray(aq), angle_t=jnp.asarray(at))
        tkw.update(angle_q=torch.from_numpy(aq), angle_t=torch.from_numpy(at))
    want = jmatch.match_descriptors(jnp.asarray(q), jnp.asarray(t), jnp.asarray(gate),
                                    100, **jkw)
    got = tmatch.match_descriptors(torch.from_numpy(q), torch.from_numpy(t),
                                   torch.from_numpy(gate), 100, **tkw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(np.asarray(want.ok).sum()) > 20
    assert int(got.count) == int(np.asarray(want.count))


def test_best_matches_and_gates():
    rng = np.random.default_rng(6)
    dist = rng.integers(0, 300, (40, 50)).astype(np.int32)
    gate = rng.random((40, 50)) < 0.5
    gate[0] = False
    for ratio in (None, 0.8):
        want = jmatch.best_matches(jnp.asarray(dist), jnp.asarray(gate), 120, ratio)
        got = tmatch.best_matches(torch.from_numpy(dist), torch.from_numpy(gate), 120, ratio)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    uv_p = rng.uniform(0, 100, (40, 2)).astype(np.float32)
    uv_t = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    r = rng.uniform(5, 30, 40).astype(np.float32)
    np.testing.assert_array_equal(
        tmatch.window_gate(torch.from_numpy(uv_p), torch.from_numpy(uv_t),
                           torch.from_numpy(r)).numpy(),
        np.asarray(jmatch.window_gate(jnp.asarray(uv_p), jnp.asarray(uv_t), jnp.asarray(r))))
    oq = rng.integers(0, 8, 40).astype(np.int32)
    ot = rng.integers(0, 8, 50).astype(np.int32)
    np.testing.assert_array_equal(
        tmatch.octave_gate(torch.from_numpy(oq), torch.from_numpy(ot), -1, 1).numpy(),
        np.asarray(jmatch.octave_gate(jnp.asarray(oq), jnp.asarray(ot), -1, 1)))
