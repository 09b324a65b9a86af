"""Core image ops: separable filtering, pyramids, bilinear sampling, CLAHE.

Replacements for the OpenCV image plumbing the reference leans
on (SURVEY.md §2.2): `cv::buildOpticalFlowPyramid` feeding
calcOpticalFlowPyrLK (feature_tracker.cpp:181) and `cv::createCLAHE(3.0)`
(ViewController.mm:439-441).

Formulation: every separable filter here is a banded Toeplitz matmul,
`RowBand @ img @ ColBand`, with decimation fused into the band matrix for
pyramid levels. CLAHE's per-tile histograms use a fused compare-reduce
instead of a scatter-add, and the per-pixel LUT blend is a tile-grouped
one-hot contraction instead of a gather. (These forms were chosen for a
compiler that lowered small convolutions, scatters and gathers poorly;
whether they still pay on the GPU is ROADMAP Queue 3 item 2.)

Images are [H, W] float32 in [0, 1] (single channel).
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Banded-matmul separable filtering
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _band_np(n: int, kernel: Tuple[float, ...], decimate: int = 1
             ) -> np.ndarray:
    """[ceil(n/decimate), n] banded Toeplitz matrix applying `kernel`
    (odd length, centered) with reflect-101 padding and stride `decimate`.
    Cached per (n, kernel, decimate); embedded as a jit constant."""
    p = len(kernel) // 2
    m = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, kv in enumerate(kernel):
            j = i + t - p
            if j < 0:
                j = -j
            if j >= n:
                j = 2 * n - 2 - j
            m[i, j] += kv
    return m[::decimate].copy()


def _sep_filter(img: jax.Array, kernel: Tuple[float, ...],
                decimate: int = 1) -> jax.Array:
    """Separable 2D filter with reflect padding as two banded matmuls,
    optionally fused with 2D decimation (used by pyr_down)."""
    H, W = img.shape
    r = jnp.asarray(_band_np(H, kernel, decimate))
    c = jnp.asarray(_band_np(W, kernel, decimate))
    pr = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(r, img, precision=pr), c.T, precision=pr)


def _sep_conv(img: jax.Array, k) -> jax.Array:
    """Back-compat wrapper: kernel as array-like → banded matmul."""
    kernel = tuple(float(v) for v in np.asarray(k).reshape(-1))
    return _sep_filter(img, kernel)


def gaussian_blur(img: jax.Array, sigma: float = 1.0,
                  radius: int = 2) -> jax.Array:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = k / np.sum(k)
    return _sep_filter(img, tuple(float(v) for v in k))


_PYR_K = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def pyr_down(img: jax.Array) -> jax.Array:
    """One pyramid level: 5-tap Gaussian then 2x decimation (cv::pyrDown),
    fused into the band matrices."""
    return _sep_filter(img, _PYR_K, decimate=2)


def build_pyramid(img: jax.Array, levels: int) -> List[jax.Array]:
    """[level0=full, level1=half, ...] — static list, shapes halve."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def bilinear_sample(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Sample img at float (x, y) positions with border clamping.

    xy: [..., 2] in pixel coordinates (x = column, y = row).
    Returns [...] samples.
    """
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11))


_SCHARR_D = (-0.5, 0.0, 0.5)
_SCHARR_S = (3.0 / 16, 10.0 / 16, 3.0 / 16)


def sobel_gradients(img: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Scharr-weighted image gradients (what OpenCV LK uses internally)."""
    H, W = img.shape
    rd = jnp.asarray(_band_np(H, _SCHARR_D))
    rs = jnp.asarray(_band_np(H, _SCHARR_S))
    cd = jnp.asarray(_band_np(W, _SCHARR_D))
    cs = jnp.asarray(_band_np(W, _SCHARR_S))
    pr = jax.lax.Precision.HIGHEST
    gx = jnp.matmul(jnp.matmul(rs, img, precision=pr), cd.T, precision=pr)
    gy = jnp.matmul(jnp.matmul(rd, img, precision=pr), cs.T, precision=pr)
    return gx, gy


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------


def clahe(img: jax.Array, clip_limit: float = 3.0, grid: int = 8,
          n_bins: int = 256) -> jax.Array:
    """Contrast-limited adaptive histogram equalization.

    Equivalent of cv::createCLAHE(clip, (8,8))->apply (the reference
    equalizes every camera frame before tracking, ViewController.mm:439).
    Static-shape and gather-free:
      * per-tile histograms: fused compare-reduce against the bin iota
        (instead of a scatter-add);
      * per-pixel LUT application: pixels grouped into half-tile blocks,
        within which the 4 bilinear-neighbor tiles are CONSTANT, so the
        4 LUT evaluations become one one-hot [px,bins] x [bins,4]
        contraction per block.
    Requires even tile sides for the half-block grouping (true for all
    supported camera profiles); falls back to the gather path otherwise.
    """
    H, W = img.shape
    th, tw = H // grid, W // grid
    img_c = img[: th * grid, : tw * grid]
    v = jnp.clip((img_c * (n_bins - 1)).astype(jnp.int32), 0, n_bins - 1)
    tiles = v.reshape(grid, th, grid, tw).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(grid * grid, th * tw)

    # Histogram per tile: compare-reduce against the bin index vector.
    bins = jnp.arange(n_bins, dtype=jnp.int32)
    hist = jnp.sum((tiles[:, :, None] == bins[None, None, :])
                   .astype(jnp.float32), axis=1)        # [tiles, bins]

    # Clip + redistribute (cv::CLAHE semantics).
    limit = jnp.maximum(clip_limit * (th * tw) / n_bins, 1.0)
    excess = jnp.sum(jnp.maximum(hist - limit, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, limit) + excess / n_bins

    cdf = jnp.cumsum(hist, axis=1)
    cdf = (cdf - cdf[:, :1]) / jnp.maximum(cdf[:, -1:] - cdf[:, :1], 1.0)
    luts = cdf.reshape(grid, grid, n_bins)  # [gy, gx, bins]

    if th % 2 == 0 and tw % 2 == 0:
        out = _apply_luts_blocked(v, luts, grid, th, tw, n_bins)
    else:
        out = _apply_luts_gather(v, luts, grid, th, tw)

    # Paste back into the original frame size (edges beyond the tiled
    # region keep their equalized nearest value by padding replication).
    full = jnp.zeros_like(img)
    full = full.at[: th * grid, : tw * grid].set(out.astype(img.dtype))
    if th * grid < H:
        full = full.at[th * grid:, :].set(full[th * grid - 1:th * grid, :])
    if tw * grid < W:
        full = full.at[:, tw * grid:].set(full[:, tw * grid - 1:tw * grid])
    return full


def _corner_weights(Hc: int, Wc: int, th: int, tw: int, dtype):
    """Bilinear blend fractions per pixel (relative to tile centers)."""
    yy = (jnp.arange(Hc, dtype=dtype) + 0.5) / th - 0.5
    xx = (jnp.arange(Wc, dtype=dtype) + 0.5) / tw - 0.5
    fy = (yy - jnp.floor(yy))[:, None]
    fx = (xx - jnp.floor(xx))[None, :]
    return fy, fx


def _apply_luts_blocked(v: jax.Array, luts: jax.Array, grid: int,
                        th: int, tw: int, n_bins: int) -> jax.Array:
    """Gather-free LUT blend: half-tile blocks have constant neighbor
    tiles, so each block evaluates its pixels' bins against a [bins, 4]
    stack of corner LUTs in one contraction."""
    Hc, Wc = th * grid, tw * grid
    h2, w2 = th // 2, tw // 2
    g2 = 2 * grid

    # Pad LUT grid by 1 on each side with edge replication: corner tile
    # index y0+1 then lies in [0, grid+1] for all half-blocks.
    lutsP = jnp.pad(luts, ((1, 1), (1, 1), (0, 0)), mode="edge")

    # Per half-block constant corner tile indices (+1 for the pad); the
    # same formula serves rows and columns (square tile grid).
    hb = np.arange(g2)
    i0 = (hb - 1) // 2 + 1                       # [2g] in [0, grid]
    i1 = i0 + 1
    ly0 = lutsP[i0]                              # [2g, grid+2, bins]
    ly1 = lutsP[i1]
    c00 = ly0[:, i0]                             # [2g, 2g, bins]
    c01 = ly0[:, i1]
    c10 = ly1[:, i0]
    c11 = ly1[:, i1]
    corners = jnp.stack([c00, c01, c10, c11], axis=2)  # [2g, 2g, 4, bins]
    corners = corners.reshape(g2 * g2, 4, n_bins)

    # Group pixels into half-blocks: [2g*2g, h2*w2].
    vb = v.reshape(g2, h2, g2, w2).transpose(0, 2, 1, 3)
    vb = vb.reshape(g2 * g2, h2 * w2)
    # bf16 contraction with f32 accumulation: the one-hot is exact in
    # bf16 and the LUT values lose ~2^-8 — the same scale as the n_bins
    # quantization already inherent to CLAHE — and bf16 operands are
    # exempt from the HIGHEST (full fp32) precision the package sets for
    # every f32 matmul (this einsum was the bulk of the per-frame CLAHE
    # cost).
    onehot = jax.nn.one_hot(vb, n_bins, dtype=jnp.bfloat16)  # [B, px, bins]
    evals = jnp.einsum("bpk,bck->bcp", onehot,
                       corners.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)  # [B, 4, px]

    # Un-group back to [4, Hc, Wc].
    evals = evals.reshape(g2, g2, 4, h2, w2).transpose(2, 0, 3, 1, 4)
    evals = evals.reshape(4, Hc, Wc)

    fy, fx = _corner_weights(Hc, Wc, th, tw, jnp.float32)
    return ((1 - fy) * (1 - fx) * evals[0] + (1 - fy) * fx * evals[1]
            + fy * (1 - fx) * evals[2] + fy * fx * evals[3])


def _apply_luts_gather(v: jax.Array, luts: jax.Array, grid: int,
                       th: int, tw: int) -> jax.Array:
    """Fallback per-pixel gather LUT blend (odd tile sides)."""
    Hc, Wc = th * grid, tw * grid
    yy = (jnp.arange(Hc, dtype=jnp.float32) + 0.5) / th - 0.5
    xx = (jnp.arange(Wc, dtype=jnp.float32) + 0.5) / tw - 0.5
    y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, grid - 1)
    x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, grid - 1)
    y1 = jnp.clip(y0 + 1, 0, grid - 1)
    x1 = jnp.clip(x0 + 1, 0, grid - 1)
    # Fractions relative to the CLAMPED lower tile (zero weight on the
    # out-of-range neighbor at the borders).
    fy = jnp.clip(yy - y0.astype(jnp.float32), 0.0, 1.0)[:, None]
    fx = jnp.clip(xx - x0.astype(jnp.float32), 0.0, 1.0)[None, :]

    def lut_at(gy, gx):
        return luts[gy[:, None], gx[None, :], v]

    return ((1 - fy) * (1 - fx) * lut_at(y0, x0)
            + (1 - fy) * fx * lut_at(y0, x1)
            + fy * (1 - fx) * lut_at(y1, x0)
            + fy * fx * lut_at(y1, x1))
