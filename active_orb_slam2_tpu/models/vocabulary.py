"""Hierarchical binary BoW vocabulary + inverted-index place recognition.

Array-program equivalent of the reference's vendored DBoW2
(``Thirdparty/DBoW2`` [U], SURVEY.md §2.2): a k-branching hierarchical
k-medians tree over 256-bit ORB descriptors, tf-idf BoW vectors, L1
scoring, and the ``KeyFrameDatabase`` loop/relocalization queries
(``src/KeyFrameDatabase.cc`` [U]).

Two ways to get a vocabulary:
  * ``train_vocabulary`` — hierarchical binary k-medians on the map's
    own descriptors (k=8-10, depth 3-4 → 1k-10k words).  Default path:
    loop recall tracks the deployment domain.
  * ``load_text_vocabulary`` — ingest a DBoW2 text-format file (the
    reference's ``Vocabulary/ORBvoc.txt``, k=10 L=6 ~1M words,
    ``TemplatedVocabulary::loadFromTextFile`` [U]) into device arrays.
    Such trees are NOT full (branches truncate early), so the tree is
    stored explicitly: per-node centers + child tables + leaf word ids.

Design notes (vs DBoW2):
  * ``transform()`` is a batched tree descent: per level one gathered
    Hamming-argmin over the k children — vmapped over all descriptors,
    with a self-loop at early leaves.
  * DBoW2's FeatureVector node-bucketed matching (levelsup=4) is
    dropped: SearchByBoW runs the full dense Hamming matrix (one
    matmul) instead of bucketing.
  * BoW vectors are dense [W] tf-idf rows (fixed shape, matmul-able)
    for small vocabularies; for large loaded vocabularies use the
    sparse fixed-width form (``transform_sparse`` — a frame touches at
    most F distinct words) and ``l1_score_sparse``.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class Vocabulary(NamedTuple):
    """Explicit k-ary tree (supports non-full trees).

    Node ids are rows of ``centers`` (the root has no center and no
    id).  ``children`` has one extra leading row for the root:
    ``children[0]`` = root's children, ``children[i + 1]`` = node i's
    children, entries are node ids or -1.
    """
    centers: jnp.ndarray    # [n_nodes, 8] uint32
    children: jnp.ndarray   # [n_nodes + 1, k] int32, -1 padded
    word_id: jnp.ndarray    # [n_nodes] int32, >=0 at leaves else -1
    idf: jnp.ndarray        # [n_words] word weights (tf-idf idf part)
    k: int                  # branching factor
    depth: int              # max levels below root

    @property
    def n_words(self):
        return self.idf.shape[0]


def _majority_center(desc_bits, weights):
    """Bitwise weighted majority -> packed uint32[8]."""
    s = (desc_bits * weights[:, None]).sum(0)
    maj = (2 * s > weights.sum()).astype(np.uint32)
    lanes = maj.reshape(8, 32)
    return (lanes << np.arange(32, dtype=np.uint32)).sum(1, dtype=np.uint32)


def _unpack_np(desc):
    bits = (desc[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(desc.shape[0], 256)


def _hamming_np(a, b):
    """[M, 8] x [N, 8] uint32 -> [M, N] int popcount (numpy oracle)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _full_tree_children(k: int, depth: int):
    """children table + word ids for a FULL k-ary tree whose nodes are
    level-major rows (level l occupies rows [(k^(l+1)-k)/(k-1), ...))."""
    offsets = [0]
    for level in range(depth):
        offsets.append(offsets[-1] + k ** (level + 1))
    n_nodes = offsets[-1]
    children = np.full((n_nodes + 1, k), -1, np.int32)
    children[0] = np.arange(k)
    for level in range(depth - 1):
        base, nxt = offsets[level], offsets[level + 1]
        n = k ** (level + 1)
        rows = np.arange(base, base + n)
        children[rows + 1] = (nxt + np.arange(n)[:, None] * k
                              + np.arange(k)[None, :])
    word_id = np.full((n_nodes,), -1, np.int32)
    leaf_base = offsets[depth - 1]
    word_id[leaf_base:] = np.arange(k ** depth)
    return children, word_id


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 3,
                     iters: int = 8, seed: int = 0) -> Vocabulary:
    """Hierarchical binary k-medians (DBoW2's build, trimmed).

    ``descriptors`` [N, 8] uint32; duplicates fine.  Host-side training
    (offline path, like the reference's vocabulary creation tooling).
    Produces a FULL tree (empty branches get random centers).
    """
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, dtype=np.uint32)
    bits = _unpack_np(desc)

    levels = []          # level l: [k^(l+1), 8] centers
    assign = np.zeros(desc.shape[0], dtype=np.int64)  # node id at cur level

    for level in range(depth):
        n_parents = k ** level
        centers = np.zeros((n_parents * k, 8), np.uint32)
        new_assign = np.zeros_like(assign)
        for parent in range(n_parents):
            sel = np.where(assign == parent)[0]
            if len(sel) == 0:
                # empty branch: random centers so the tree stays full
                centers[parent * k:(parent + 1) * k] = rng.integers(
                    0, 2**32, (k, 8), dtype=np.uint32)
                continue
            sub = desc[sel]
            sub_bits = bits[sel]
            # k-medians init: random distinct picks
            picks = rng.choice(len(sel), size=min(k, len(sel)),
                               replace=False)
            c = sub[picks]
            if len(picks) < k:
                c = np.concatenate([c, rng.integers(
                    0, 2**32, (k - len(picks), 8), dtype=np.uint32)])
            for _ in range(iters):
                d = _hamming_np(sub, c)
                a = d.argmin(1)
                for j in range(k):
                    mask = a == j
                    if mask.any():
                        c[j] = _majority_center(
                            sub_bits[mask], np.ones(mask.sum()))
            d = _hamming_np(sub, c)
            a = d.argmin(1)
            centers[parent * k:(parent + 1) * k] = c
            new_assign[sel] = parent * k + a
        levels.append(centers)
        assign = new_assign

    all_centers = np.concatenate(levels, axis=0)
    # idf from the training corpus treated as one document per 500 descs
    words = assign
    n_words = k ** depth
    df = np.bincount(words, minlength=n_words).astype(np.float32)
    idf = np.log(float(len(words) + n_words) / (df + 1.0))
    children, word_id = _full_tree_children(k, depth)
    return Vocabulary(centers=jnp.asarray(all_centers),
                      children=jnp.asarray(children),
                      word_id=jnp.asarray(word_id),
                      idf=jnp.asarray(idf), k=k, depth=depth)


# --------------------------------------------------------------- text format

def load_text_vocabulary(path: str) -> Vocabulary:
    """Parse a DBoW2 text vocabulary (the reference's
    ``ORBVocabulary::loadFromTextFile``, ``TemplatedVocabulary.h`` [U]).

    Format: header ``k L scoring weighting``; then one line per node in
    node-id order (root id 0 implicit): ``parent_id is_leaf b0..b31
    weight`` where b0..b31 are the descriptor bytes.  Word ids are
    assigned to leaves in line order, exactly like the reference.
    """
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        body = f.read()
    # C-speed parse of ~35M whitespace-separated numbers (the reference
    # spends ~10 s in loadFromTextFile on the same 145 MB file)
    with np.errstate(all="ignore"):
        try:
            vals = np.fromstring(body, dtype=np.float64, sep=" ")
        except (AttributeError, DeprecationWarning):
            vals = np.array(body.split(), dtype=np.float64)
    vals = vals.reshape(-1, 35)
    parents = vals[:, 0].astype(np.int64)        # 0 = root
    is_leaf = vals[:, 1] != 0
    desc_bytes = vals[:, 2:34].astype(np.uint8)
    weights = vals[:, 34].astype(np.float32)
    n_nodes = len(vals)

    centers = np.ascontiguousarray(desc_bytes).view(np.uint32)  # [n, 8]
    children = np.full((n_nodes + 1, k), -1, np.int32)
    node_ids = np.arange(n_nodes, dtype=np.int32)
    # vectorized child-table build: group node ids by parent, rank
    # within group = child slot (file order == DBoW2 insertion order)
    order = np.argsort(parents, kind="stable")
    sp = parents[order]
    first_of = np.searchsorted(sp, np.arange(n_nodes + 2))
    rank = np.arange(n_nodes) - first_of[sp]
    children[sp, rank] = node_ids[order]

    word_id = np.full(n_nodes, -1, np.int32)
    leaves = node_ids[is_leaf]
    word_id[leaves] = np.arange(len(leaves), dtype=np.int32)
    idf = weights[is_leaf]
    return Vocabulary(centers=jnp.asarray(centers),
                      children=jnp.asarray(children),
                      word_id=jnp.asarray(word_id),
                      idf=jnp.asarray(idf), k=k, depth=depth)


def save_text_vocabulary(voc: Vocabulary, path: str):
    """Write DBoW2 text format (``TemplatedVocabulary::saveToTextFile``
    [U]); round-trips with :func:`load_text_vocabulary`."""
    centers = np.asarray(voc.centers)
    children = np.asarray(voc.children)
    word_id = np.asarray(voc.word_id)
    idf = np.asarray(voc.idf)
    n_nodes = centers.shape[0]
    parent = np.zeros(n_nodes, np.int64)
    for row in range(children.shape[0]):
        ch = children[row]
        ch = ch[ch >= 0]
        parent[ch] = row          # row 0 = root, row i+1 = node i... but
    # our convention stores the root at children row 0 and node i at
    # row i + 1, while the FILE parent field uses 0=root, i+1=node i —
    # the same numbering, so `parent` above is already file-ready.
    bytes_view = centers.view(np.uint8).reshape(n_nodes, 32)
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")
        for i in range(n_nodes):
            w = float(idf[word_id[i]]) if word_id[i] >= 0 else 0.0
            f.write(" ".join(
                [str(parent[i]), "1" if word_id[i] >= 0 else "0"]
                + [str(int(b)) for b in bytes_view[i]]
                + [repr(w)]) + "\n")


# ------------------------------------------------------------------ descent

def _descend(voc: Vocabulary, desc):
    """Batched tree descent: descriptors [F, 8] -> leaf word ids [F]."""
    k, depth = voc.k, voc.depth
    F = desc.shape[0]
    # cur indexes the children table: 0 = root, i + 1 = node i
    cur = jnp.zeros(F, jnp.int32)
    for _ in range(depth):
        ch = voc.children[cur]                              # [F, k]
        ok = ch >= 0
        cents = voc.centers[jnp.clip(ch, 0)]                # [F, k, 8]
        x = desc[:, None, :] ^ cents
        d = jax.lax.population_count(x).sum(-1)             # [F, k]
        d = jnp.where(ok, d, jnp.iinfo(jnp.int32).max)
        best = jnp.argmin(d, axis=-1).astype(jnp.int32)
        nxt = jnp.take_along_axis(ch, best[:, None], axis=1)[:, 0] + 1
        cur = jnp.where(ok.any(-1), nxt, cur)   # early leaf: self-loop
    return jnp.clip(voc.word_id[jnp.maximum(cur - 1, 0)], 0)


def transform(voc: Vocabulary, desc, valid):
    """Descriptors [F, 8] -> (word ids [F], bow [W] L1-normalized tf-idf).

    The hot-path equivalent of DBoW2 ``TemplatedVocabulary::transform``.
    Dense BoW — use for small/self-trained vocabularies; for ~1M-word
    loaded vocabularies prefer :func:`transform_sparse`.
    """
    words = _descend(voc, desc)
    W = voc.n_words
    counts = jnp.zeros(W).at[words].add(valid.astype(jnp.float32))
    tfidf = counts * voc.idf
    norm = jnp.maximum(jnp.abs(tfidf).sum(), 1e-9)
    return words, tfidf / norm


def transform_sparse(voc: Vocabulary, desc, valid):
    """Descriptors [F, 8] -> fixed-width sparse BoW.

    Returns (words [F], uniq_words [F] int32 sorted ascending and -1
    padded at the END via sentinel sort, uniq_weights [F] f32
    L1-normalized).  A frame touches at most F distinct words, so the
    sparse form is exact, with shapes independent of vocabulary size —
    this is what makes the reference's 1M-word ORBvoc usable on device
    without [K, 1M] inverted-file matrices.
    """
    words = _descend(voc, desc)
    F = desc.shape[0]
    W = voc.n_words
    key = jnp.where(valid, words, W)            # invalid -> sentinel
    skey = jnp.sort(key)
    first = jnp.concatenate(
        [jnp.array([True]), skey[1:] != skey[:-1]]) & (skey < W)
    # segment boundaries: for each unique word, sum the tf over its run
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1            # run index
    tf = jnp.zeros((F,)).at[jnp.clip(seg, 0)].add(
        jnp.where(skey < W, 1.0, 0.0))
    uniq = jnp.where(first, skey, -1)
    uniq = jnp.sort(jnp.where(uniq < 0, jnp.iinfo(jnp.int32).max, uniq))
    n_uniq = jnp.sum(first)
    uniq = jnp.where(jnp.arange(F) < n_uniq, uniq, -1)
    w = tf * jnp.where(uniq >= 0, voc.idf[jnp.clip(uniq, 0)], 0.0)
    norm = jnp.maximum(jnp.abs(w).sum(), 1e-9)
    return words, uniq.astype(jnp.int32), w / norm


def l1_score(bow_q, bow_db):
    """DBoW2 L1 similarity: s = 1 - 0.5 * |q - d|_1 for L1-normalized
    vectors.  bow_db may be [K, W]; returns [K]."""
    diff = jnp.abs(bow_q[None, :] - bow_db).sum(-1)
    return 1.0 - 0.5 * diff


def l1_score_sparse(n_words, q_words, q_weights, db_words, db_weights):
    """Sparse-sparse L1 similarity via one dense scatter of the query.

    For L1-normalized non-negative vectors,
    ``1 - 0.5 |q - d|_1 = sum_{i in q∩d} min(q_i, d_i)`` — so scoring
    is a gather of the query's dense form at each document's word ids.

    Args: q_* [F]; db_* [K, F] (-1 padded word ids).  Returns [K].
    """
    qd = jnp.zeros((n_words,)).at[jnp.clip(q_words, 0)].add(
        jnp.where(q_words >= 0, q_weights, 0.0))
    g = qd[jnp.clip(db_words, 0)]                            # [K, F]
    g = jnp.where(db_words >= 0, g, 0.0)
    return jnp.sum(jnp.minimum(g, db_weights), axis=-1)


def detect_candidates_from_scores(s, kf_valid, covis_mask, min_score,
                                  covis_weights=None, top_n: int = 10):
    """``KeyFrameDatabase::DetectLoopCandidates`` (~L50-150 [U]) group
    rule, operating on precomputed similarity scores [K]."""
    eligible = kf_valid & ~covis_mask & (s >= min_score)
    s_eff = jnp.where(eligible, s, 0.0)
    if covis_weights is not None:
        # group score: candidate + its top-10 covisible candidates
        W = covis_weights
        topw, topi = jax.lax.top_k(W, top_n)               # [K, top_n]
        member_ok = (topw > 0) & eligible[topi]
        acc = s_eff + (jnp.where(member_ok, s_eff[topi], 0.0)).sum(-1)
        best_acc = jnp.max(acc)
        accept = eligible & (acc >= 0.75 * best_acc) & (best_acc > 0)
    else:
        accept = eligible
    return s, accept


def detect_candidates(bow_q, kf_bow, kf_valid, covis_mask, min_score,
                      covis_weights=None, top_n: int = 10):
    """``KeyFrameDatabase::DetectLoopCandidates`` (~L50-150 [U]),
    dense reformulation.

    Scores every valid KF; excludes the query's covisible group; applies
    the reference's accumulated-group-score rule (sum scores over each
    candidate's top-covisible group, keep >= 0.75 * best).

    Args:
      covis_mask [K] bool — KFs connected to the query (excluded).
      covis_weights [K, K] — for group accumulation (optional).
    Returns (scores [K], accept [K] bool).
    """
    s = l1_score(bow_q, kf_bow)
    return detect_candidates_from_scores(
        s, kf_valid, covis_mask, min_score,
        covis_weights=covis_weights, top_n=top_n)
