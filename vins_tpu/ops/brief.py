"""BRIEF descriptors + Hamming matching as batched XLA kernels.

Replaces the reference's DVision BRIEF (ThirdParty/DVision/BRIEF.cpp:40-175:
256 fixed test pairs over a Gaussian-smoothed patch, boost::dynamic_bitset
output) and its O(N²) scalar Hamming matcher (loop/keyframe.cpp:161-193)
with:
  * a fixed Gaussian test-pair pattern (generated once, seeded — the
    reference ships a learned pattern in Resources/brief_pattern.yml; the
    pattern's only requirement is consistency between extraction and
    matching);
  * batched bilinear-gather bit extraction → packed uint32[8] descriptors;
  * Hamming distance via XOR + `lax.population_count`, batched over whole
    descriptor sets in one fused program.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import image as image_mod

BRIEF_BITS = 256
BRIEF_WORDS = BRIEF_BITS // 32
PATCH_HALF = 24          # reference pattern spans a 48x48 patch


def make_pattern(seed: int = 7) -> np.ndarray:
    """[256, 4] (x1, y1, x2, y2) test-pair offsets, N(0, (S/5)²) clipped —
    the classic BRIEF-48 construction. Offsets are rounded to integers,
    as the reference's learned pattern is (brief_pattern.yml); the
    shipped vocabularies (assets/brief_k10L*.npz) were trained on these
    bits."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_HALF / 2.0
    pts = rng.normal(0.0, sigma, (BRIEF_BITS, 4))
    return np.rint(
        np.clip(pts, -PATCH_HALF, PATCH_HALF)).astype(np.float32)


_PATTERN = make_pattern()


def _pack_bits(bits: jax.Array) -> jax.Array:
    """[N, 256] {0,1} → [N, 8] packed uint32."""
    w = bits.reshape(bits.shape[0], BRIEF_WORDS, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(w << shifts[None, None, :], axis=2, dtype=jnp.uint32)


def extract_brief(img: jax.Array, pts: jax.Array, valid: jax.Array,
                  blur_sigma: float = 2.0) -> jax.Array:
    """Packed BRIEF descriptors for keypoints.

    img: [H, W] float; pts: [N, 2] pixel (x, y); valid: [N] bool.
    Returns [N, 8] uint32 (invalid rows = 0). Bit k is
    smoothed(pt + a_k) < smoothed(pt + b_k), each tap a bilinear sample.
    """
    smoothed = image_mod.gaussian_blur(img, blur_sigma)
    pat = jnp.asarray(_PATTERN)

    def one(pt):
        a = pt[None, :] + pat[:, 0:2]          # [256, 2]
        b = pt[None, :] + pat[:, 2:4]
        ia = image_mod.bilinear_sample(smoothed, a)
        ib = image_mod.bilinear_sample(smoothed, b)
        return (ia < ib).astype(jnp.uint32)    # [256]

    desc = _pack_bits(jax.vmap(one)(pts))
    return jnp.where(valid[:, None], desc, jnp.zeros_like(desc))


def hamming_matrix(a: jax.Array, b: jax.Array) -> jax.Array:
    """All-pairs Hamming distances between packed descriptor sets.

    a: [N, 8] uint32, b: [M, 8] uint32 → [N, M] int32.
    """
    x = jax.lax.population_count(a[:, None, :] ^ b[None, :, :])
    return jnp.sum(x.astype(jnp.int32), axis=-1)


class MatchResult(NamedTuple):
    idx: jax.Array    # [N] best match in b for each a (int32)
    dist: jax.Array   # [N] best Hamming distance
    ok: jax.Array     # [N] passes distance + ratio gates


def match_descriptors(a: jax.Array, b: jax.Array,
                      a_valid: jax.Array, b_valid: jax.Array,
                      max_dist: int = 80,
                      ratio: float = 1.0) -> MatchResult:
    """Mutual-gated nearest-neighbor Hamming matching.

    The reference accepts best-distance < 80 with no ratio test
    (keyframe.cpp:161-193 searchByDes); ratio<1.0 adds the DBoW-style
    neigh-ratio gate (TemplatedLoopDetector.h getMatches_neighratio).
    """
    BIG = jnp.int32(10_000)
    d = hamming_matrix(a, b)
    d = jnp.where(b_valid[None, :], d, BIG)
    d = jnp.where(a_valid[:, None], d, BIG)

    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.min(d, axis=1)
    # Second best for the ratio test.
    d2 = d.at[jnp.arange(d.shape[0]), idx].set(BIG)
    second = jnp.min(d2, axis=1)

    ok = (best < max_dist) & a_valid
    if ratio < 1.0:
        ok = ok & (best.astype(jnp.float32)
                   <= ratio * second.astype(jnp.float32))
    return MatchResult(idx=idx, dist=best, ok=ok)


def global_descriptor(desc: jax.Array, valid: jax.Array,
                      pts: jax.Array, shape: Tuple[int, int]) -> jax.Array:
    """Compact per-image place-recognition descriptor.

    Spatially-pooled bit statistics: the image is split into a 2×2 grid;
    per cell, the mean of each of the 256 BRIEF bits over that cell's
    keypoints → [4·256] float, L2-normalized. Scoring a query against the
    whole keyframe database is then ONE [K, 1024] @ [1024] matvec — the
    dense replacement for DBoW2's inverted-file lookup
    (SURVEY.md §2.2), serving the same role as the BoW L1 score
    (ScoringObject.cpp) with spatial layout added.
    """
    H, W = shape
    bits = _unpack_bits(desc)                              # [N, 256] float
    gx = (pts[:, 0] >= (W / 2)).astype(jnp.int32)
    gy = (pts[:, 1] >= (H / 2)).astype(jnp.int32)
    cell = gy * 2 + gx                                     # [N] in 0..3
    w = valid.astype(jnp.float32)

    def cell_mean(c):
        m = w * (cell == c)
        s = jnp.sum(m)
        mean = jnp.sum(bits * m[:, None], axis=0) / jnp.maximum(s, 1.0)
        # Center around 0.5 so an empty cell contributes exactly zero.
        return jnp.where(s > 0, mean - 0.5, 0.0)

    g = jnp.concatenate([cell_mean(c) for c in range(4)])  # [1024]
    n = jnp.linalg.norm(g)
    return g / jnp.maximum(n, 1e-8)


def _unpack_bits(desc: jax.Array) -> jax.Array:
    """[N, 8] uint32 → [N, 256] float32 of 0/1."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    b = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return b.reshape(desc.shape[0], -1).astype(jnp.float32)
