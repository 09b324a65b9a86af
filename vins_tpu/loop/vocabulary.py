"""Hierarchical binary bag-of-words vocabulary (DBoW2 equivalent).

Replaces the reference's DBoW2 stack (ThirdParty/DBoW/TemplatedVocabulary.h,
TemplatedDatabase.h, ScoringObject.cpp, loop/VocabularyBinary.{hpp,cpp})
with a dense, batched design:

  * **Training** (`train_vocabulary`): hierarchical k-medians on packed
    256-bit BRIEF descriptors — Lloyd iterations with Hamming-distance
    assignment (one batched XOR+popcount matrix per step, the binary
    analog of a distance matmul) and bit-majority centroid updates (the binary
    mean, exactly DBoW2's `FBrief::meanValue`,
    ThirdParty/DBoW/FBrief.cpp:21-48). The reference *loads* a pre-trained
    k=10/L=6 tree (`brief_k10L6.bin`, absent from the repo —
    .MISSING_LARGE_BLOBS:2); we train our own (k/L from `LoopConfig`)
    since the blob's format and data are unavailable.
  * **Transform** (`transform`): descend every descriptor through the
    complete k-ary tree — per level one gather of the k child centroids
    and a batched Hamming argmin (TemplatedVocabulary.h `transform`) —
    then scatter tf-idf weights into a **dense** [n_words] BoW vector.
    Sparse word lists (DBoW2's `BowVector`) make sense on a CPU; on an
    accelerator a dense vector turns database scoring into one matrix op.
  * **Scoring** (`score_database`): DBoW2 L1 scoring
    (ScoringObject.cpp L1Scoring: s = 1 − ½·‖v−w‖₁ on L1-normalized
    vectors) against ALL stored keyframes at once — a [K, n_words]
    elementwise kernel instead of an inverted-file walk
    (TemplatedDatabase.h:286-316). At K=512, n_words=1000 this is ~0.5 M
    lanes, far below one HBM round-trip of a camera frame.
  * **Persistence** (`save_vocabulary`/`load_vocabulary`): the role of
    loop/VocabularyBinary.{hpp,cpp} + TemplatedVocabulary::loadBin
    (ThirdParty/DBoW/TemplatedVocabulary.h:1505-1558) — a flat binary
    container of the level-stacked centroid arrays + idf weights.

The direct index (DBoW2 `FeatureVector`, used by the reference for
candidate-restricted descriptor matching in
TemplatedLoopDetector::isGeometricallyConsistent_DI) is intentionally
replaced by full batched Hamming matching in the geometric check
(keyframe_db._geometric_verify): matching all Nf×Nf pairs in one fused
kernel is cheaper on the device than gathering per-word candidate lists, and
strictly stronger. `word_id` is still returned per descriptor for parity
and diagnostics.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

BRIEF_WORDS = 8            # packed uint32 words per 256-bit descriptor


class Vocabulary(NamedTuple):
    """Complete k-ary tree of depth L, level-major storage.

    levels[l] has shape [k**(l+1), 8] (uint32): the centroids of tree
    level l+1; children of node j at level l are rows j*k .. j*k+k-1 of
    levels[l]. Empty branches hold a copy of their parent centroid and
    carry zero idf weight, keeping the tree complete so descent is a
    fixed-shape gather+argmin chain under jit.
    """

    levels: Tuple[jax.Array, ...]   # centroids per level
    weights: jax.Array              # [k**L] idf word weights (0 = unused)

    @property
    def k(self) -> int:
        return self.levels[0].shape[0]

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def n_words(self) -> int:
        return self.levels[-1].shape[0]


# ---------------------------------------------------------------------------
# Hamming primitives (host-callable, jit-friendly)
# ---------------------------------------------------------------------------


def _hamming(a: jax.Array, b: jax.Array) -> jax.Array:
    """[N, 8] x [M, 8] packed → [N, M] int32 Hamming distances."""
    x = jax.lax.population_count(a[:, None, :] ^ b[None, :, :])
    return jnp.sum(x.astype(jnp.int32), axis=-1)


@jax.jit
def _assign(desc: jax.Array, centers: jax.Array) -> jax.Array:
    """Nearest center (Hamming) for each descriptor: [N] int32."""
    return jnp.argmin(_hamming(desc, centers), axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(2,))
def _bit_majority(desc: jax.Array, assign: jax.Array, k: int) -> jax.Array:
    """Per-cluster bit-majority centroids (FBrief::meanValue).

    desc: [N, 8] uint32, assign: [N] int32 in [0, k) → [k, 8] uint32.
    """
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((desc[:, :, None] >> shifts[None, None, :])
            & jnp.uint32(1)).astype(jnp.float32)        # [N, 8, 32]
    onehot = (assign[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
    counts = jnp.einsum("nk,nwb->kwb", onehot, bits)     # [k, 8, 32]
    total = jnp.sum(onehot, axis=0)                      # [k]
    # Majority vote; ties (exactly half) round down like DBoW2's
    # sum*2 > n rule.
    maj = (counts * 2.0 > total[:, None, None]).astype(jnp.uint32)
    packed = jnp.sum(maj << shifts[None, None, :], axis=2, dtype=jnp.uint32)
    return packed


# Training runs ENTIRELY on the host: the tree recursion produces ~100
# descriptor subsets of ~100 distinct sizes, so doing the clustering with
# device calls means ~30 blocking round trips per node and a fresh XLA
# program per subset size — minutes of compiles for milliseconds of
# actual math. Numpy twins of _hamming/_assign/
# _bit_majority below; the device versions above serve transform/scoring.
_POPCNT = np.array([bin(i).count("1") for i in range(256)], np.uint16)


def _np_bytes(desc: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(desc, np.uint32).view(np.uint8).reshape(
        desc.shape[0], 32)


def _np_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 8] x [M, 8] packed uint32 → [N, M] int32 Hamming distances."""
    x = _np_bytes(a)[:, None, :] ^ _np_bytes(b)[None, :, :]
    return _POPCNT[x].sum(-1).astype(np.int32)


def _np_bit_majority(desc: np.ndarray, assign: np.ndarray,
                     k: int) -> np.ndarray:
    """Per-cluster bit-majority centroids, numpy twin of _bit_majority."""
    bits = np.unpackbits(_np_bytes(desc), axis=1, bitorder="little")
    counts = np.zeros((k, 256), np.int64)
    np.add.at(counts, assign, bits)
    total = np.bincount(assign, minlength=k)
    maj = (counts * 2 > total[:, None]).astype(np.uint8)
    return np.packbits(maj, axis=1, bitorder="little").view(
        np.uint32).reshape(k, 8)


def _kmedians(desc: np.ndarray, k: int, rng: np.random.Generator,
              iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """One k-medians run over a descriptor subset (pure numpy).

    Returns (centers [k, 8] uint32, assign [N]). Empty clusters are
    reseeded from the farthest points once, then tolerated.
    """
    n = desc.shape[0]
    if n == 0:
        return np.zeros((k, 8), np.uint32), np.zeros((0,), np.int32)
    # kmeans++-style greedy seeding on Hamming distance.
    centers = np.zeros((k, 8), np.uint32)
    centers[0] = desc[rng.integers(n)]
    d_min = None
    for i in range(1, k):
        d = _np_hamming(desc, centers[i - 1:i])[:, 0]
        d_min = d if d_min is None else np.minimum(d_min, d)
        centers[i] = desc[int(np.argmax(d_min))]

    assign = np.zeros(n, np.int32)
    for _ in range(iters):
        assign = np.argmin(_np_hamming(desc, centers), axis=1).astype(
            np.int32)
        new = _np_bit_majority(desc, assign, k)
        # Reseed empty clusters from the worst-served descriptors.
        counts = np.bincount(assign, minlength=k)
        empty = np.where(counts == 0)[0]
        if len(empty):
            # Reseed as many empty clusters as there are descriptors to
            # donate; surplus empties (n < k) stay as harmless duplicates.
            d_best = _np_hamming(desc, new)[np.arange(n), assign]
            m = min(len(empty), n)
            far = np.argsort(-d_best)[:m]
            new[empty[:m]] = desc[far]
        if np.array_equal(new, centers):
            break
        centers = new
    assign = np.argmin(_np_hamming(desc, centers), axis=1).astype(np.int32)
    return centers, assign


def train_vocabulary(desc: np.ndarray, k: int = 10, levels: int = 3,
                     seed: int = 0, iters: int = 8,
                     image_ids: Optional[np.ndarray] = None) -> Vocabulary:
    """Build the hierarchical vocabulary from a descriptor pool.

    desc: [M, 8] uint32 packed BRIEF (invalid rows already removed).
    image_ids: optional [M] source-image index per descriptor; when given,
    idf weights use image document frequency exactly like DBoW2
    (TemplatedVocabulary::setNodeWeights); otherwise descriptor frequency
    is used.
    """
    desc = np.ascontiguousarray(desc, np.uint32)
    rng = np.random.default_rng(seed)
    n_words = k ** levels

    level_arrays = []
    # subsets[j] = descriptor indices under node j of the current level.
    subsets = [np.arange(desc.shape[0])]
    for _ in range(levels):
        centers_lvl = np.zeros((len(subsets) * k, 8), np.uint32)
        next_subsets = []
        for j, idx in enumerate(subsets):
            if len(idx) == 0:
                # Empty branch: complete the tree with zero-weight copies.
                parent = (level_arrays[-1][j]
                          if level_arrays else np.zeros(8, np.uint32))
                centers_lvl[j * k:(j + 1) * k] = parent
                next_subsets.extend([idx] * k)
                continue
            c, a = _kmedians(desc[idx], k, rng, iters)
            centers_lvl[j * k:(j + 1) * k] = c
            next_subsets.extend([idx[a == ci] for ci in range(k)])
        level_arrays.append(centers_lvl)
        subsets = next_subsets

    # idf weights over the leaf partition.
    word_of = np.zeros(desc.shape[0], np.int64)
    for j, idx in enumerate(subsets):
        word_of[idx] = j
    if image_ids is not None:
        n_docs = len(np.unique(image_ids))
        df = np.zeros(n_words, np.int64)
        for w in range(n_words):
            df[w] = len(np.unique(image_ids[word_of == w]))
    else:
        n_docs = desc.shape[0]
        df = np.bincount(word_of, minlength=n_words)
    ratio = np.maximum(n_docs / np.maximum(df, 1), 1.0)
    weights = np.where(df > 0, np.log(ratio), 0.0).astype(np.float32)
    if weights.max() <= 0:
        # Degenerate pool (every word everywhere): fall back to uniform.
        weights = (df > 0).astype(np.float32)

    return Vocabulary(
        levels=tuple(jnp.asarray(a) for a in level_arrays),
        weights=jnp.asarray(weights))


# ---------------------------------------------------------------------------
# Transform + scoring
# ---------------------------------------------------------------------------


@jax.jit
def transform(vocab: Vocabulary, desc: jax.Array,
              valid: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Descend descriptors through the tree → (word_id [N], bow [n_words]).

    The per-level step gathers each descriptor's k child centroids and
    takes the Hamming argmin (TemplatedVocabulary::transform). The BoW
    vector is tf-idf, L1-normalized (DBoW2 TF_IDF + L1_NORM default).
    """
    k = vocab.k
    node = jnp.zeros(desc.shape[0], jnp.int32)          # index within level
    for lvl in vocab.levels:
        child0 = node * k
        cand = lvl[child0[:, None] + jnp.arange(k)[None, :]]  # [N, k, 8]
        x = jax.lax.population_count(desc[:, None, :] ^ cand)
        d = jnp.sum(x.astype(jnp.int32), axis=-1)       # [N, k]
        node = child0 + jnp.argmin(d, axis=1).astype(jnp.int32)
    word_id = node
    n_words = vocab.n_words
    tf = jnp.zeros(n_words, jnp.float32).at[word_id].add(
        valid.astype(jnp.float32))
    bow = tf * vocab.weights
    s = jnp.sum(bow)
    bow = bow / jnp.maximum(s, 1e-12)
    return word_id, bow


@jax.jit
def score_database(bow_db: jax.Array, bow_q: jax.Array) -> jax.Array:
    """L1 BoW similarity of a query against every database row.

    bow_db: [K, n_words] L1-normalized, bow_q: [n_words] → [K] scores in
    [0, 1] (ScoringObject.cpp L1Scoring: 1 − ½‖v−w‖₁). Empty rows score 0.
    """
    l1 = jnp.sum(jnp.abs(bow_db - bow_q[None, :]), axis=1)
    score = 1.0 - 0.5 * l1
    nonempty = jnp.sum(bow_db, axis=1) > 0
    return jnp.where(nonempty, score, 0.0)


# ---------------------------------------------------------------------------
# Persistence (role of loop/VocabularyBinary + loadBin)
# ---------------------------------------------------------------------------


def save_vocabulary(path: str, vocab: Vocabulary) -> None:
    arrs = {f"level_{i}": np.asarray(a) for i, a in enumerate(vocab.levels)}
    arrs["weights"] = np.asarray(vocab.weights)
    np.savez_compressed(path, **arrs)


def load_vocabulary(path: str) -> Vocabulary:
    with np.load(path) as z:
        n_levels = sum(1 for f in z.files if f.startswith("level_"))
        levels = tuple(jnp.asarray(z[f"level_{i}"]) for i in range(n_levels))
        weights = jnp.asarray(z["weights"])
    return Vocabulary(levels=levels, weights=weights)


_DEFAULT_VOCAB_PATH = None  # resolved lazily; overridable for tests
_default_cache = {}


def default_vocabulary() -> Optional[Vocabulary]:
    """The shipped pre-trained vocabulary asset (the role of the
    reference's brief_k10L6.bin, loaded at startup —
    ViewController.mm:892-900). Trained OFFLINE on a held-out synthetic
    corpus by tools/train_vocab.py; returns None if the asset is absent
    (callers then fall back to runtime training)."""
    import os

    path = _DEFAULT_VOCAB_PATH
    if path is None:
        assets = os.path.join(os.path.dirname(__file__), "..", "assets")
        # Prefer the deepest shipped tree (k10L4 ~ 10^4 words, trained on
        # the diversified corpus; the reference ships k10L6 ~ 10^6,
        # TemplatedVocabulary.h:1505) and fall back to smaller ones.
        for name in ("brief_k10L4.npz", "brief_k10L3.npz"):
            cand = os.path.join(assets, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            path = os.path.join(assets, "brief_k10L3.npz")
    path = os.path.abspath(path)
    if path not in _default_cache:
        _default_cache[path] = (load_vocabulary(path)
                                if os.path.exists(path) else None)
    return _default_cache[path]
