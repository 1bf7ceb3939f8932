"""Bag-of-binary-words vocabulary as a dense array tree.

Replaces the vendored DBoW2 (TemplatedVocabulary.h): a hierarchical k-ary
tree of 256-bit ORB centroids. The reference descends the tree per
descriptor with scalar popcount loops; here ``transform`` descends every
descriptor at once: at each level the k children of each descriptor's node
are gathered, XORed with it, popcounted through a 256-entry byte table
(torch has no popcount) and the argmin picks the branch (lowest index on
ties). The node tensors live on the vocabulary's device.

Also here: the trainer (hierarchical binary k-means with k-majority
centroids, numpy), npz save/load, and the DBoW2 text format
(ORBvoc.txt) for drop-in use of existing vocabularies. The counterpart of
``bow/vocabulary.py`` in the JAX package; ``vocab_synth.npz`` beside this
file is a copy of that package's default vocabulary.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import tracing

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vocab_synth.npz")

_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


class Vocabulary:
    """k-ary tree with L levels; node descriptors stored per level.

    Level l has k^(l+1) slots (children of all level-(l-1) nodes). Leaves
    (level L-1) are the words: word id = leaf index in [0, k^L).
    """

    def __init__(self, node_desc: list[np.ndarray], idf: np.ndarray, device="cuda"):
        self.device = torch.device(device)
        self.k = int(node_desc[0].shape[0])
        self.levels = len(node_desc)
        self.node_desc = [torch.tensor(np.asarray(d, np.uint8), device=self.device)
                          for d in node_desc]  # level l: (k^(l+1), 32)
        self.idf = torch.tensor(np.asarray(idf, np.float32), device=self.device)  # (k^L,)
        self.n_words = int(idf.shape[0])
        self._popcnt = torch.as_tensor(_POPCNT8.astype(np.int32), device=self.device)
        self._child = torch.arange(self.k, device=self.device)

    # ------------------------------------------------------------- transform
    def transform(self, desc: torch.Tensor, valid: torch.Tensor):
        """Descriptors (N, 32) uint8 -> (word ids (N,) int32, bow (W,)
        tf-idf, L1-normalized). The descent is branch-free:
        node = node * k + argmin over the k children's distances. A
        ``bow.transform`` span while the recorder of utils.tracing is on."""
        with tracing.span("bow.transform"):
            node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
            for lvl in self.node_desc:
                base = node * self.k
                child_desc = lvl[base[:, None] + self._child[None, :]]  # (N, k, 32)
                x = torch.bitwise_xor(child_desc, desc[:, None, :])
                d = self._popcnt[x.long()].sum(-1)                      # (N, k)
                node = base + torch.argmin(d, dim=1)                    # first minimum
            tf = torch.zeros(self.n_words, dtype=torch.float32, device=desc.device)
            tf = tf.index_add_(0, node, valid.float())
            v = tf * self.idf
            norm = v.abs().sum()
            return node.to(torch.int32), v / torch.where(norm > 0, norm, torch.ones_like(norm))

    # ---------------------------------------------------------------- saving
    def save(self, path: str):
        np.savez_compressed(
            path, idf=self.idf.cpu().numpy(),
            **{f"level_{l}": d.cpu().numpy() for l, d in enumerate(self.node_desc)})

    @classmethod
    def load(cls, path: str = DEFAULT_PATH, device="cuda") -> "Vocabulary":
        z = np.load(path)
        levels = sorted(k for k in z.files if k.startswith("level_"))
        return cls([z[k] for k in levels], z["idf"], device=device)


def sparse_bow(bow: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero (word ids int64, values float32) of a dense bow, on the
    host: what ``KeyFrameDatabase`` builds from a dense bow, with only the
    nonzero entries copied off the device."""
    ids = torch.nonzero(bow).squeeze(1)
    return ids.cpu().numpy().astype(np.int64), bow[ids].cpu().numpy().astype(np.float32)


def l1_scores(q: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score of a query bow (W,) against (K, W) bows:
    s = 2 * sum_w min(q_w, v_w) (ScoringObject.cc L1Scoring for normalized
    vectors), for every keyframe at once."""
    return 2.0 * torch.minimum(q[None, :], refs).sum(1)


# ---------------------------------------------------------------- training


def _kmajority(desc_bits: np.ndarray, k: int, rng, iters: int = 8, chunk: int = 1 << 16):
    """Binary k-means: assign by Hamming, centroid = per-bit majority.
    Distances go through a byte-popcount table in row chunks so corpora of
    ~10^6 descriptors (the 10^5-word vocabulary scale) stay in memory."""
    n = desc_bits.shape[0]
    if n <= k:
        cents = np.zeros((k, desc_bits.shape[1]), np.uint8)
        cents[:n] = desc_bits
        assign = np.arange(n) % k
        return cents, assign
    cents = desc_bits[rng.choice(n, k, replace=False)].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            x = desc_bits[s:e, None, :] ^ cents[None, :, :]
            d = _POPCNT8[x].sum(2, dtype=np.int32)
            assign[s:e] = d.argmin(1)
        for c in range(k):
            sel = desc_bits[assign == c]
            if len(sel):
                bits = np.unpackbits(sel, axis=1)
                maj = (bits.mean(0) >= 0.5).astype(np.uint8)
                cents[c] = np.packbits(maj)
    return cents, assign


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 3,
                     seed: int = 0, device="cuda") -> Vocabulary:
    """Hierarchical binary k-means (DBoW2 creation semantics)."""
    rng = np.random.default_rng(seed)
    node_desc: list[np.ndarray] = []
    groups = [descriptors]  # recursive split, breadth-first
    for l in range(levels):
        lvl = np.zeros((k ** (l + 1), 32), np.uint8)
        next_groups: list[np.ndarray] = []
        for gi, g in enumerate(groups):
            cents, assign = _kmajority(g, k, rng)
            lvl[gi * k:(gi + 1) * k] = cents
            for c in range(k):
                next_groups.append(g[assign == c] if len(g) else g)
        node_desc.append(lvl)
        groups = next_groups
    # idf from the training corpus' leaf occupancy
    counts = np.array([len(g) for g in groups], np.float64)
    n_docs = max(len(descriptors) / 500.0, 1.0)  # pseudo-documents
    idf = np.log(np.maximum(n_docs, 2.0) / (1.0 + counts / 500.0)).astype(np.float32)
    idf = np.maximum(idf, 0.1)
    return Vocabulary(node_desc, idf, device=device)


def save_dbow2_text(voc: Vocabulary, path: str):
    """Write a vocabulary in the DBoW2 ORBvoc.txt format
    (TemplatedVocabulary::saveToTextFile, TemplatedVocabulary.h:1270-1296):
    header ``k L scoring weighting`` then one node per line (root omitted,
    BFS creation order) as ``parent_id is_leaf d0..d31 weight``. Node ids
    are implicit: the root is 0 and each line allocates the next id, which
    is what ``loadFromTextFile`` (:1206-1266) and :func:`load_dbow2_text`
    expect."""
    k, levels = voc.k, voc.levels
    idf = voc.idf.cpu().numpy()
    with open(path, "w") as f:
        f.write(f"{k} {levels} 0 0\n")
        # BFS: level l slot s has implicit node id 1 + sum_{j<l} k^(j+1) + s;
        # its parent is the root (l=0) or slot s//k at level l-1
        level_base = [1]
        for l in range(1, levels):
            level_base.append(level_base[-1] + k**l)
        for l in range(levels):
            desc = voc.node_desc[l].cpu().numpy()
            leaf = 1 if l == levels - 1 else 0
            for s in range(desc.shape[0]):
                parent = 0 if l == 0 else level_base[l - 1] + s // k
                d = " ".join(str(int(b)) for b in desc[s])
                w = float(idf[s]) if leaf else 0.0
                f.write(f"{parent} {leaf} {d} {w}\n")


def load_dbow2_text(path: str, device="cuda") -> Vocabulary:
    """Load a DBoW2 text vocabulary (ORBvoc.txt: header 'k L s w', then per
    node: parent id, leaf flag, 32 descriptor bytes, weight). The tree here
    is dense, so a node's missing children keep zero descriptors."""
    with open(path) as f:
        header = f.readline().split()
        k = int(header[0])
        levels = int(header[1])
        node_desc = [np.zeros((k ** (l + 1), 32), np.uint8) for l in range(levels)]
        weights = np.zeros(k**levels, np.float32)
        children_count: dict[int, int] = {}
        node_level: dict[int, int] = {0: -1}
        node_slot: dict[int, int] = {0: 0}
        next_id = 1
        for line in f:
            tok = line.split()
            if len(tok) < 35:
                continue
            parent = int(tok[0])
            is_leaf = int(tok[1])
            desc = np.array([int(x) for x in tok[2:34]], np.uint8)
            w = float(tok[34])
            lvl = node_level[parent] + 1
            cidx = children_count.get(parent, 0)
            children_count[parent] = cidx + 1
            slot = node_slot[parent] * k + cidx
            if lvl < levels:
                node_desc[lvl][slot] = desc
            node_level[next_id] = lvl
            node_slot[next_id] = slot
            if is_leaf and lvl == levels - 1:
                weights[slot] = w
            next_id += 1
    return Vocabulary(node_desc, weights, device=device)
