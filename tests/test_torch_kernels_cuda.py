"""The CUDA kernels against their plain PyTorch versions, on the card.

Both kernels must give the same bits as their plain versions (FAST scores
are exact float32 min/max/subtract; Hamming distances are integers). These
tests need an NVIDIA GPU and nvcc; elsewhere they skip. Run them on the GPU
machine with ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (``--noconftest``: the suite's conftest
imports JAX, which a GPU machine for the port need not have).
"""

import numpy as np
import pytest
import torch

from plslam_torch.ops import fast, hamming

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU build)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(480, 640), (400, 533), (134, 179), (7, 9), (33, 40)])
@pytest.mark.parametrize("th", [7.0, 20.0])
def test_fast_kernel_equals_plain(dev, shape, th):
    rng = np.random.default_rng(shape[0])
    img = torch.as_tensor(rng.integers(0, 256, shape).astype(np.float32), device=dev)
    before = fast.fast_score_nms.launches
    got = fast.fast_score_nms(img, th)
    assert fast.fast_score_nms.launches == before + 1
    torch.testing.assert_close(got, fast.fast_score_nms_plain(img, th), rtol=0, atol=0)


PYRAMID = [(480, 640), (400, 533), (333, 444), (278, 370), (231, 309), (193, 257),
           (161, 214), (134, 179)]


def _check_levels(imgs, th, launches):
    before = fast.fast_score_nms.launches
    got = fast.fast_score_nms_levels(imgs, th)
    assert fast.fast_score_nms.launches == before + launches
    for img, g in zip(imgs, got):
        torch.testing.assert_close(g, fast.fast_score_nms_plain(img, th), rtol=0, atol=0)
    return got


@pytest.mark.parametrize("shapes", [PYRAMID, [(7, 9), (5, 3), (16, 64), (17, 65), (1, 1)],
                                    [(21, 67), (100, 131), (33, 40), (64, 190), (9, 250)]],
                         ids=["pyramid", "smaller-than-a-tile", "ragged"])
def test_fast_levels_one_launch(dev, shapes):
    rng = np.random.default_rng(len(shapes))
    imgs = [torch.as_tensor(rng.integers(0, 256, s).astype(np.float32), device=dev)
            for s in shapes]
    _check_levels(imgs, 7.0, 1)


def test_fast_levels_more_than_a_table(dev):
    rng = np.random.default_rng(9)
    imgs = [torch.as_tensor(rng.integers(0, 256, (40 + i, 50 + 3 * i)).astype(np.float32),
                            device=dev) for i in range(11)]
    _check_levels(imgs, 20.0, 2)  # 8 levels per launch


def test_fast_levels_flat_image(dev):
    imgs = [torch.full(s, 128.0, device=dev) for s in PYRAMID[:3]]
    for g in _check_levels(imgs, 7.0, 1):
        assert int(g.count_nonzero()) == 0


@pytest.mark.parametrize("th", [7.0, 20.0])
def test_fast_pretest_at_threshold(dev, th):
    """Corners planted with their arcs exactly at +-th (score th: not a
    corner) and one grey level past it (a corner), bright and dark, with
    the arc starting at every circle index: the compass pre-test must reject
    the first kind only."""
    circle = fast.CIRCLE_OFFSETS
    img = np.full((64, 16 * 16), 100.0, np.float32)
    for k in range(16):
        for r, (sign, extra) in enumerate([(1, 0.0), (1, 1.0), (-1, 0.0), (-1, 1.0)]):
            cy, cx = 8 + 16 * r, 8 + 16 * k
            for a in range(9):
                dx, dy = circle[(k + a) % 16]
                img[cy + dy, cx + dx] = 100.0 + sign * (th + extra)
    got = _check_levels([torch.as_tensor(img, device=dev)], th, 1)[0].cpu().numpy()
    centres = got[8::16, 8::16]
    assert (centres[[0, 2]] == 0).all()
    assert (centres[[1, 3]] == th + 1).all()


@pytest.mark.parametrize("B", [1, 4])
def test_fast_levels_batch_one_launch(dev, B):
    """B images' pyramids (each level (B, H, W)) in ONE launch equal the
    plain version image by image, and the images' own launches."""
    rng = np.random.default_rng(B)
    levels = [torch.as_tensor(rng.integers(0, 256, (B,) + s).astype(np.float32), device=dev)
              for s in PYRAMID]
    got = _check_levels(levels, 7.0, 1)
    for b in range(B):
        alone = fast.fast_score_nms_levels([x[b] for x in levels], 7.0)
        for g, a in zip(got, alone):
            torch.testing.assert_close(g[b], a, rtol=0, atol=0)


def test_fast_kernel_rejects_bad_input(dev):
    with pytest.raises(ValueError):
        fast.fast_score_nms(torch.zeros(8, 8, dtype=torch.float64, device=dev), 7.0)
    with pytest.raises(ValueError):
        fast.fast_score_nms(torch.zeros(8, 16, device=dev)[:, ::2], 7.0)


@pytest.mark.parametrize("n,m,density", [(1024, 1024, 0.05), (8192, 1024, 0.02),
                                         (8192, 1024, 1.0), (1000, 777, 0.5),
                                         (5, 2049, 0.9), (64, 0, 0.0)])
def test_hamming_kernel_equals_plain(dev, n, m, density):
    rng = np.random.default_rng(n + m)
    q = torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8), device=dev)
    t = torch.as_tensor(rng.integers(0, 256, (m, 32), dtype=np.uint8), device=dev)
    if m >= 40 and n >= 20:
        t[10:20] = q[:10]
        t[30:40] = q[:10]  # planted ties on the best distance
    gate = torch.as_tensor(rng.random((n, m)) < density, device=dev)
    if m >= 40 and n >= 20:
        gate[:10, 10:40] = True
        gate[15] = False
    before = hamming.hamming_top2.launches
    got = hamming.hamming_top2(q, t, gate)
    assert hamming.hamming_top2.launches == before + 1
    for a, b in zip(got, hamming.hamming_top2_plain(q, t, gate)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _hamming_case(dev, n, m, seed):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8), device=dev)
    t = torch.as_tensor(rng.integers(0, 256, (m, 32), dtype=np.uint8), device=dev)
    return rng, q, t


def _expected_dense(gate):
    """Tiles of 16 rows x 512 columns with more than the kernel's threshold of
    gated pairs: the ones it must run on the tensor cores."""
    g, th = gate.cpu().numpy(), hamming.dense_min_pairs()
    return sum(int(g[r:r + 16, c:c + 512].sum() > th)
               for r in range(0, g.shape[0], 16) for c in range(0, g.shape[1], 512))


def _check_hamming(q, t, gate, dense):
    hamming.dense_tiles()
    got = hamming.hamming_top2(q, t, gate)
    assert hamming.dense_tiles() == dense
    for a, b in zip(got, hamming.hamming_top2_plain(q, t, gate)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("extra", [0, 1])
def test_hamming_dense_threshold(dev, extra):
    """A 16 x 512 tile with the kernel's threshold of gated pairs takes the
    sparse walk; one pair more takes the tensor cores."""
    rng, q, t = _hamming_case(dev, 16, 512, 11)
    flat = np.zeros(16 * 512, bool)
    flat[rng.permutation(16 * 512)[:hamming.dense_min_pairs() + extra]] = True
    _check_hamming(q, t, torch.as_tensor(flat.reshape(16, 512), device=dev), extra)


@pytest.mark.parametrize("dense_first", [True, False])
def test_hamming_ties_across_dense_and_sparse_tiles(dev, dense_first):
    """Each query has exact twins in a dense tile and in a sparse tile of the
    same row tile; the lower column must win, and second == best."""
    n, m = 48, 1024
    rng, q, t = _hamming_case(dev, n, m, 12)
    dense_cols = slice(0, 512) if dense_first else slice(512, 1024)
    lo, hi = (100, 700) if dense_first else (50, 600)
    gate = torch.as_tensor(rng.random((n, m)) < 0.01, device=dev)
    gate[:, dense_cols] = True
    t[lo:lo + n] = q
    t[hi:hi + n] = q
    gate[torch.arange(n), lo + torch.arange(n)] = True
    gate[torch.arange(n), hi + torch.arange(n)] = True
    best, idx, second = _check_hamming(q, t, gate, n // 16)
    assert (best == 0).all() and (second == 0).all()
    assert (idx.cpu().numpy() == lo + np.arange(n)).all()


@pytest.mark.parametrize("n,m", [(40, 777), (40, 2049), (3, 777), (5, 2049)])
@pytest.mark.parametrize("density", [0.02, 1.0])
def test_hamming_unaligned_rows_and_small_n(dev, n, m, density):
    """M % 16 != 0 (row starts off 16-byte boundaries) and N below one
    16-row tile, on the sparse walk and on the tensor cores."""
    rng, q, t = _hamming_case(dev, n, m, n * m)
    t[m - 20:m - 20 + min(n, 20)] = q[:20]  # twins in the ragged last tile
    gate = torch.as_tensor(rng.random((n, m)) < density, device=dev)
    gate[:, m - 20:] = True
    gate[n // 2] = False  # a row with nothing gated
    dense = _expected_dense(gate)
    assert (dense > 0) == (density == 1.0 and n > 3)
    _check_hamming(q, t, gate, dense)


def test_hamming_kernel_rejects_bad_input(dev):
    q = torch.zeros(4, 32, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        hamming.hamming_top2(q, q, torch.ones(4, 4, dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError):
        hamming.hamming_top2(q, q, torch.ones(4, 5, dtype=torch.bool, device=dev))


@pytest.mark.parametrize("B", [1, 3, 10])
@pytest.mark.parametrize("density", ["sparse", "dense", "empty"])
def test_hamming_batched_equals_plain(dev, B, density):
    """One launch for B problems sharing their queries equals B plain calls;
    B = 1 equals the unbatched kernel. Each problem has its own twins, so a
    wrong per-problem stride shows as a wrong idx."""
    n, m = 200, 777
    rng, q, _ = _hamming_case(dev, n, m, 100 + B)
    t = torch.as_tensor(rng.integers(0, 256, (B, m, 32), dtype=np.uint8), device=dev)
    for b in range(B):
        t[b, 50 + b:70 + b] = q[:20]
    p = {"sparse": 0.02, "dense": 1.0, "empty": 0.0}[density]
    gate = torch.as_tensor(rng.random((B, n, m)) < p, device=dev)
    if density != "empty":
        for b in range(B):
            gate[b, :20, 50 + b:70 + b] = True
        gate[:, 7] = False
    before = hamming.hamming_top2_batched.launches
    hamming.dense_tiles()
    got = hamming.hamming_top2_batched(q, t, gate)
    tiles = hamming.dense_tiles()
    assert hamming.hamming_top2_batched.launches == before + 1
    assert (tiles > 0) == (density == "dense")
    want = hamming.hamming_top2_batched_plain(q, t, gate)
    for a, w in zip(got, want):
        assert a.shape == (B, n)
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    if density != "empty":
        rows = np.array([i for i in range(20) if i != 7])  # row 7 has nothing gated
        idx = got[1].cpu().numpy()
        assert (idx[:, rows] == 50 + np.arange(B)[:, None] + rows[None]).all()
        assert (idx[:, 7] == -1).all()
    if B == 1:
        for a, w in zip(got, hamming.hamming_top2(q, t[0], gate[0])):
            torch.testing.assert_close(a[0], w, rtol=0, atol=0)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("density", ["windowed", "dense"])
def test_hamming_per_problem_queries(dev, B, density):
    """B problems with their own queries, targets and gate (B sequences
    tracked in one step) in ONE launch, through ``hamming_top2`` with a
    leading axis: equal to the plain version and to each problem alone. Each
    problem's twins sit at its own columns, so a wrong query stride shows as
    a wrong idx."""
    n, m = 8192 if density == "windowed" else 1000, 1024
    rng = np.random.default_rng(7 + B)
    q = torch.as_tensor(rng.integers(0, 256, (B, n, 32), dtype=np.uint8), device=dev)
    t = torch.as_tensor(rng.integers(0, 256, (B, m, 32), dtype=np.uint8), device=dev)
    for b in range(B):
        t[b, 100 + 3 * b:120 + 3 * b] = q[b, :20]
    if density == "windowed":
        gate = torch.as_tensor(rng.random((B, n, m)) < 0.01, device=dev)
    else:
        gate = torch.ones(B, n, m, dtype=torch.bool, device=dev)
    for b in range(B):
        gate[b, :20, 100 + 3 * b:120 + 3 * b] = True
    before = hamming.hamming_top2.launches
    got = hamming.hamming_top2(q, t, gate)
    assert hamming.hamming_top2.launches == before + 1
    want = hamming.hamming_top2_plain(q, t, gate)
    for a, w in zip(got, want):
        assert a.shape == (B, n)
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    idx = got[1].cpu().numpy()
    assert (idx[:, :20] == 100 + 3 * np.arange(B)[:, None] + np.arange(20)[None]).all()
    with pytest.raises(ValueError):  # the shared-query launch takes one query set
        hamming.hamming_top2_batched(q, t, gate)
    for b in range(B):
        for a, w in zip(got, hamming.hamming_top2(q[b], t[b], gate[b])):
            torch.testing.assert_close(a[b], w, rtol=0, atol=0)


def test_hamming_batched_rejects_bad_input(dev):
    q = torch.zeros(4, 32, dtype=torch.uint8, device=dev)
    t = torch.zeros(2, 5, 32, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        hamming.hamming_top2_batched(q, t, torch.ones(2, 4, 4, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):
        hamming.hamming_top2_batched(q, t, torch.ones(3, 4, 5, dtype=torch.bool, device=dev))


def _window_gate(rng, dev, n, m, radius, batch=None):
    """A projection-window gate as the loop closer builds it: query i
    projects to a point in the 640 x 480 image and gates the targets within
    ``radius`` px (targets uniform over the image)."""
    shape = (n, 2) if batch is None else (batch, n, 2)
    uv_q = torch.as_tensor(rng.uniform([0, 0], [640, 480], shape), dtype=torch.float32,
                           device=dev)
    uv_t = torch.as_tensor(rng.uniform([0, 0], [640, 480], (m, 2)), dtype=torch.float32,
                           device=dev)
    return ((uv_q[..., :, None, :] - uv_t).abs() < radius).all(-1).contiguous()


# the loop closer's four shapes (models/loop_closing.py): the Sim3 ratio
# match with the dense gate has_point x has_point, the SearchBySim3
# expansion (B = 2: features and landmark descriptors behind one window
# gate), the verification projection and SearchAndFuse (B = 10)
LOOP_SHAPES = {"sim3 match 1024x1024": (1024, 1024, None, None),
               "expansion 2 x 1024x1024": (1024, 1024, 2, 15.0),
               "verification 4096x1024": (4096, 1024, None, 10.0),
               "search and fuse 10 x 4096x1024": (4096, 1024, 10, 5.0)}


@pytest.mark.parametrize("name", list(LOOP_SHAPES))
def test_hamming_loop_shapes_equal_plain(dev, name):
    n, m, B, radius = LOOP_SHAPES[name]
    rng = np.random.default_rng(n + m + (B or 0))
    q = torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8), device=dev)
    t = torch.as_tensor(rng.integers(0, 256, (B or 1, m, 32), dtype=np.uint8), device=dev)
    t[:, :200] = q[:200]  # twins, so that best distances tie across the batch
    if radius is None:
        has_q = torch.as_tensor(rng.random(n) < 0.8, device=dev)
        has_t = torch.as_tensor(rng.random(m) < 0.8, device=dev)
        gate = (has_q[:, None] & has_t[None, :])[None]
    elif B is None:
        gate = _window_gate(rng, dev, n, m, radius)[None]
    elif B == 2:
        gate = _window_gate(rng, dev, n, m, radius)[None].expand(2, n, m).contiguous()
    else:
        gate = _window_gate(rng, dev, n, m, radius, batch=B)
    gate[:, :200, :200] |= torch.eye(200, dtype=torch.bool, device=dev)
    if B is None:
        fn, plain, args = hamming.hamming_top2, hamming.hamming_top2_plain, (q, t[0], gate[0])
        counter = hamming.hamming_top2
    else:
        fn, plain, args = (hamming.hamming_top2_batched, hamming.hamming_top2_batched_plain,
                           (q, t, gate))
        counter = hamming.hamming_top2_batched
    before = counter.launches
    got = fn(*args)
    assert counter.launches == before + 1
    for a, w in zip(got, plain(*args)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_min_of_two_equals_plain_top1_of_the_minimum(dev):
    """The expansion's one B = 2 launch, combined, equals the plain top-1
    over min(d(q, t0), d(q, t1)) at every row, ties between the two rows
    and within a row included, and rows with nothing gated stay -1."""
    from plslam_torch.ops import matching

    rng = np.random.default_rng(7)
    n = m = 1024
    q = torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8), device=dev)
    t = torch.as_tensor(rng.integers(0, 256, (2, m, 32), dtype=np.uint8), device=dev)
    t[0, 100:200] = q[:100]           # twins in the features ...
    t[1, 300:400] = q[:100]           # ... and in the landmarks: a tie across rows
    t[1, 500:550] = q[100:150]
    t[1, 600:650] = q[100:150]        # a tie within one row
    gate = _window_gate(rng, dev, n, m, 60.0)
    gate[:150, 100:650] = True
    gate[700] = False
    before = hamming.hamming_top2_batched.launches
    for dedupe in (False, True):
        got = matching.match_min_of_two(q, t, gate, 50, dedupe=dedupe)
        dmin = torch.minimum(hamming.hamming_matrix(q, t[0]), hamming.hamming_matrix(q, t[1]))
        want = matching.best_matches(dmin, gate, 50)
        if dedupe:
            want = matching.dedupe_targets(want, m)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert hamming.hamming_top2_batched.launches == before + 2
    idx = got.idx.cpu().numpy()
    assert (idx[:100] == np.arange(100, 200)).all()  # the lower index of the tie
    assert (idx[100:150] == np.arange(500, 550)).all()
    assert idx[700] == -1
