"""plslam_torch BoW vocabulary and keyframe database against the JAX
package's.

- ``Vocabulary.transform`` on real ORB descriptors of the rendered room
  (320x240, the port's extractor; the same descriptors go to both
  packages): word ids identical and the bow within 1e-6, for the default
  10^4-word vocabulary and the 10^5-word one.
- ``KeyFrameDatabase``: the same keyframe bows (the JAX side dense, the
  port's as the sparse pair the tracker hands it) give an identical
  database, identical ``score_all`` / ``shared_words`` arrays and identical
  relocalization and loop candidate lists, also after an erase and with a
  culled keyframe; the port's own bows (1e-6 from JAX's) give the same
  candidate lists.
- npz, DBoW2-text and ``train_vocabulary(seed)`` round trips across the
  two packages; the port's default vocabulary is a byte copy of the JAX
  package's.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plslam_tpu.bow import vocabulary as jvoc
from plslam_tpu.bow.database import KeyFrameDatabase as JKeyFrameDatabase
from plslam_torch import convert
from plslam_torch.bow import vocabulary as tvoc
from plslam_torch.bow.database import KeyFrameDatabase
from plslam_torch.config import OrbConfig
from plslam_torch.ops import orb
from torch_parity import render
from torch_parity import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BOW = os.path.join(ROOT, "plslam_" + "tpu", "bow")
VOCABS = {"synth": os.path.join(JAX_BOW, "vocab_synth.npz"),
          "100k": os.path.join(JAX_BOW, "vocab_100k.npz")}


@pytest.fixture(scope="module")
def features():
    """(desc (N, 32) uint8, valid (N,)) of 12 frames of a 24-frame orbit."""
    out = []
    for g, _ in render(12, total=24):
        f = orb.extract_orb(torch.from_numpy(g).float(), OrbConfig())
        out.append((f.desc.numpy(), f.valid.numpy()))
    return out


@pytest.fixture(scope="module", params=sorted(VOCABS))
def vocabs(request):
    path = VOCABS[request.param]
    return jvoc.Vocabulary.load(path), tvoc.Vocabulary.load(path, device="cpu")


def _both(jv, tv, desc, valid):
    jw, jb = jv.transform(jnp.asarray(desc), jnp.asarray(valid))
    tw, tb = tv.transform(torch.from_numpy(desc), torch.from_numpy(valid))
    return np.asarray(jw), np.asarray(jb), tw.numpy(), tb


def test_transform_equals_jax(vocabs, features):
    jv, tv = vocabs
    assert (tv.k, tv.levels, tv.n_words) == (jv.k, jv.levels, jv.n_words)
    for desc, valid in features[:4]:
        assert valid.sum() > 200
        jw, jb, tw, tb = _both(jv, tv, desc, valid)
        np.testing.assert_array_equal(tw, jw)
        assert tw.dtype == np.int32
        np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-6)
        assert abs(float(tb.abs().sum()) - 1.0) < 1e-5
        # the sparse pair is the dense bow's nonzero entries
        ids, vals = tvoc.sparse_bow(tb)
        np.testing.assert_array_equal(ids, np.nonzero(jb)[0])
        np.testing.assert_allclose(vals, jb[ids], rtol=0, atol=1e-6)


def test_transform_ties_take_the_lowest_child():
    """Every child of a node at the same distance: the first one wins."""
    node = [np.zeros((4, 32), np.uint8), np.zeros((16, 32), np.uint8)]
    node[1][4:8] = 0xFF  # children of node 1: all at distance 256 from 0
    idf = np.ones(16, np.float32)
    q = np.zeros((2, 32), np.uint8)
    q[1, 0] = 0xFF
    jw, _ = jvoc.Vocabulary(node, idf).transform(jnp.asarray(q), jnp.ones(2, bool))
    tw, _ = tvoc.Vocabulary(node, idf, device="cpu").transform(
        torch.from_numpy(q), torch.ones(2, dtype=torch.bool))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tw.tolist() == [0, 0]


def test_l1_scores_equal_jax(vocabs, features):
    jv, tv = vocabs
    bows = [_both(jv, tv, d, v) for d, v in features[:4]]
    q_j, refs_j = bows[0][1], np.stack([b[1] for b in bows[1:]])
    s_j = np.asarray(jvoc.l1_scores(jnp.asarray(q_j), jnp.asarray(refs_j)))
    s_t = tvoc.l1_scores(bows[0][3], torch.stack([b[3] for b in bows[1:]])).numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5)


class _Map:
    """Covisibility and validity as a map gives them to the database:
    neighbours are the adjacent keyframes."""

    def __init__(self, n, culled=()):
        self.kf_valid = np.zeros(32, bool)
        self.kf_valid[:n] = True
        self.kf_valid[list(culled)] = False
        self.n = n

    def covisible_keyframes(self, kf, k):
        return [c for c in (kf - 1, kf + 1) if 0 <= c < self.n][:k]


@pytest.fixture(scope="module")
def databases(features):
    """Both packages' databases over keyframes = every other frame, from
    the JAX bows, and the bows (JAX's, the port's) of the frames between
    them as queries."""
    jv = jvoc.Vocabulary.load(VOCABS["synth"])
    tv = convert.vocabulary_from_numpy([np.asarray(d) for d in jv.node_desc],
                                       np.asarray(jv.idf), device="cpu")
    jdb, tdb = JKeyFrameDatabase(jv, max_kf=32), KeyFrameDatabase(tv, max_kf=32)
    queries = []
    for i, (d, v) in enumerate(features):
        _, jb, _, tb = _both(jv, tv, d, v)
        if i % 2 == 0:
            jdb.add(i // 2, jb)
            tdb.add(i // 2, tvoc.sparse_bow(torch.from_numpy(jb.copy())))
        else:
            queries.append((jb, tb))
    return jdb, tdb, queries


def _assert_same_queries(jdb, tdb, queries, fake):
    for jb, tb in queries:
        js = tvoc.sparse_bow(torch.from_numpy(jb.copy()))
        for q in (js, jb):  # both forms of a bow
            np.testing.assert_array_equal(tdb.score_all(q), jdb.score_all(jb))
            np.testing.assert_array_equal(tdb.shared_words(q), jdb.shared_words(jb))
        cands = jdb.detect_reloc_candidates(jb, fake)
        for q in (js, tvoc.sparse_bow(tb)):  # the same bow, and the port's own
            assert tdb.detect_reloc_candidates(q, fake) == cands
            for kf in range(fake.n):
                cov = set(fake.covisible_keyframes(kf, 10))
                assert (tdb.detect_loop_candidates(kf, q, 0.01, cov, fake)
                        == jdb.detect_loop_candidates(kf, jb, 0.01, cov, fake))
    return cands


def test_database_queries_equal_jax(databases):
    jdb, tdb, queries = databases
    np.testing.assert_array_equal(tdb.has, jdb.has)
    for kf in range(6):
        for a, b in zip(tdb.get_bow(kf), jdb.get_bow(kf)):
            np.testing.assert_array_equal(a, b)
    cands = _assert_same_queries(jdb, tdb, queries, _Map(6))
    assert cands, "no relocalization candidate"
    # a culled keyframe anchors nothing; an erased one leaves every list
    _assert_same_queries(jdb, tdb, queries, _Map(6, culled=[cands[0]]))
    jdb.erase(2)
    tdb.erase(2)
    assert not tdb.has[2] and all(2 not in post for post in tdb._inv.values())
    _assert_same_queries(jdb, tdb, queries, _Map(6))


def test_kfdb_from_numpy(databases):
    jdb, _, queries = databases
    tv = tvoc.Vocabulary.load(device="cpu")
    tdb = convert.kfdb_from_numpy(tv, [jdb.get_bow(k) for k in range(jdb.max_kf)], jdb.max_kf)
    np.testing.assert_array_equal(tdb.has, jdb.has)
    _assert_same_queries(jdb, tdb, queries, _Map(6))


def test_npz_round_trip(tmp_path):
    jv = jvoc.Vocabulary.load(VOCABS["synth"])
    tv = tvoc.Vocabulary.load(device="cpu")
    tv.save(str(tmp_path / "port.npz"))
    jv.save(str(tmp_path / "jax.npz"))
    for a, b in ((jvoc.Vocabulary.load(str(tmp_path / "port.npz")), jv),
                 (tvoc.Vocabulary.load(str(tmp_path / "jax.npz"), device="cpu"), tv)):
        for l in range(jv.levels):
            np.testing.assert_array_equal(np.asarray(a.node_desc[l]), np.asarray(b.node_desc[l]))
        np.testing.assert_array_equal(np.asarray(a.idf), np.asarray(b.idf))


def test_dbow2_text_round_trip(tmp_path, features):
    jv = jvoc.Vocabulary.load(VOCABS["synth"])
    tv = tvoc.Vocabulary.load(device="cpu")
    tvoc.save_dbow2_text(tv, str(tmp_path / "port.txt"))
    jvoc.save_dbow2_text(jv, str(tmp_path / "jax.txt"))
    assert filecmp.cmp(tmp_path / "port.txt", tmp_path / "jax.txt", shallow=False)
    tv2 = tvoc.load_dbow2_text(str(tmp_path / "jax.txt"), device="cpu")
    jv2 = jvoc.load_dbow2_text(str(tmp_path / "port.txt"))
    desc, valid = features[0]
    jw, jb, tw, tb = _both(jv2, tv2, desc, valid)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-6)


def test_train_vocabulary_equals_jax(features):
    desc = np.concatenate([d[v] for d, v in features[:3]])
    jv = jvoc.train_vocabulary(desc, k=5, levels=3, seed=3)
    tv = tvoc.train_vocabulary(desc, k=5, levels=3, seed=3, device="cpu")
    for l in range(3):
        np.testing.assert_array_equal(tv.node_desc[l].numpy(), np.asarray(jv.node_desc[l]))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))


def test_default_vocabulary_is_the_jax_package_copy():
    assert filecmp.cmp(tvoc.DEFAULT_PATH, VOCABS["synth"], shallow=False)
