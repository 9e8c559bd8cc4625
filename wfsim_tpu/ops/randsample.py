"""Vectorized sampling primitives used by the physics models.

Everything here is shape-static and branch-free so it jits and vmaps cleanly.
Counter-based PRNG (jax threefry) replaces the reference's sequential global
``np.random`` state: keys are folded in per (chunk, cluster, stage), so any
cluster is reproducible in isolation — a capability the reference lacks
(it acknowledges this at wfsim/strax_interface.py:543-549).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    'categorical_from_cdf', 'search_sorted_rows', 'sample_inverse_cdf',
    'truncated_exponential', 'binomial', 'poisson',
]


def binomial(key, n, p):
    """Binomial(n, p) elementwise. jax.random.binomial with guards for the
    degenerate edges the physics hits constantly (p<=0, n==0)."""
    n = jnp.asarray(n, dtype=jnp.float32)
    p = jnp.clip(jnp.asarray(p, dtype=jnp.float32), 0.0, 1.0)
    out = jax.random.binomial(key, n=jnp.maximum(n, 0.0), p=p)
    return jnp.where((n <= 0) | (p <= 0), 0.0, out).astype(jnp.int32)


def _threefry_key(key):
    """jax.random.poisson is threefry-only; when the configuration picks
    another generator (``prng_impl``, e.g. rbg), fold the key's data into a
    threefry key just for the poisson draw."""
    try:
        if 'threefry' in str(jax.random.key_impl(key)):
            return key
        data = jax.random.key_data(key).reshape(-1)[:2]
        return jax.random.wrap_key_data(data, impl='threefry2x32')
    except Exception:
        return key


def poisson(key, lam):
    lam = jnp.asarray(lam, dtype=jnp.float32)
    out = jax.random.poisson(_threefry_key(key), jnp.maximum(lam, 0.0))
    return jnp.where(lam <= 0, 0, out).astype(jnp.int32)


def _plan_widths(C: int):
    """Block widths (outermost first) for the hierarchical row search:
    innermost block <= 32 lanes, inner levels 16, outermost whatever remains
    — minimizes the number of block gathers, on the premise that a gather
    costs per index, so one (1, 32) block costs about one scalar element
    (unmeasured on H100, ROADMAP C2)."""
    if C <= 32:
        return [max(C, 1)]
    prod = 32
    n_mid = 0
    while prod * 16 < C:
        prod *= 16
        n_mid += 1
    first = -(-C // prod)
    return [first] + [16] * n_mid + [32]


def _level_tables(tab: jnp.ndarray, widths):
    """Per-level block-end tables for :func:`search_sorted_rows`.

    Level l is a (R * w0*...*w_{l-1}, w_l) table whose entry j holds the
    LAST value of sub-block j — for nondecreasing rows that is the block
    max, so one (1, w_l) block gather decides which sub-block to descend
    into.  Rows are edge-padded (the row's final value repeats), which
    keeps search semantics exact AND makes the level-0 gather's last lane
    the row total (used by :func:`categorical_from_cdf` for free).
    """
    R, C = tab.shape
    c_pad = int(np.prod(widths))
    if c_pad != C:
        tab = jnp.pad(tab, ((0, 0), (0, c_pad - C)), mode='edge')
    x = tab.reshape((R, *widths))
    tabs = []
    for l in range(len(widths)):
        ends = x
        for _ in range(len(widths) - 1 - l):
            ends = ends[..., -1]
        tabs.append(ends.reshape(-1, widths[l]))
    return tabs


def _descend(tabs, widths, row_idx, q, count_lt, g0=None):
    idx = row_idx.astype(jnp.int32)
    for l, w in enumerate(widths):
        g = tabs[l][idx] if (g0 is None or l > 0) else g0
        c = jnp.sum(g < q[:, None] if count_lt else g <= q[:, None],
                    axis=1).astype(jnp.int32)
        idx = idx * w + jnp.minimum(c, w - 1)
    return idx


def search_sorted_rows(tab: jnp.ndarray, row_idx: jnp.ndarray,
                       q: jnp.ndarray, *, side: str = 'right') -> jnp.ndarray:
    """Per-sample searchsorted on per-row NONDECREASING tables, as a
    hierarchy of wide block gathers.

    Returns, per sample, the smallest index i with ``tab[row, i] > q``
    (side='right') or ``tab[row, i] >= q`` (side='left'), clamped to
    [0, C-1].  Bitwise-identical to the log2(C)-round binary search it
    replaces, but costs len(_plan_widths(C)) block gathers (2 for C<=512,
    3 for C<=8192) instead of log2(C) scalar gathers: ~2 instead of ~11
    dependent passes at bench shapes (unmeasured on H100, ROADMAP C2).
    """
    R, C = tab.shape
    widths = _plan_widths(C)
    tabs = _level_tables(tab, widths)
    idx = _descend(tabs, widths, row_idx, q, side == 'left')
    base = row_idx.astype(jnp.int32) * int(np.prod(widths))
    return jnp.minimum(idx - base, C - 1)


def categorical_from_cdf(cdf_rows: jnp.ndarray,
                         row_idx: jnp.ndarray,
                         u: jnp.ndarray) -> jnp.ndarray:
    """Per-sample categorical draw via hierarchical inverse-CDF search.

    Replaces the reference's per-event ``np.random.choice(channels, p=pattern)``
    loops (wfsim/core/s1.py:152-158, s2.py:657-679).  Draws are identical to
    the former log2(C)-round binary search (same uniforms, same first-index-
    above rule); the row total rides the level-0 block gather for free.

    :param cdf_rows: (R, C) row-wise inclusive CDFs, last column == total mass.
    :param row_idx:  (N,) int — which CDF row each sample draws from.
    :param u:        (N,) uniforms in [0, 1).
    :returns: (N,) int32 category indices; -1 where the row has zero mass
              (matching the reference's nan-pattern sentinel, s2.py:670-671).
    """
    n_cat = cdf_rows.shape[-1]
    widths = _plan_widths(n_cat)
    tabs = _level_tables(cdf_rows, widths)
    g0 = tabs[0][row_idx.astype(jnp.int32)]
    total = g0[:, -1]
    target = u * total
    idx = _descend(tabs, widths, row_idx, target, False, g0=g0)
    base = row_idx.astype(jnp.int32) * int(np.prod(widths))
    out = jnp.minimum(idx - base, n_cat - 1).astype(jnp.int32)
    return jnp.where(total > 0, out, -1)


def sample_inverse_cdf(key, inv_cdf: jnp.ndarray, n: int,
                       interpolate: bool = True):
    """Sample from a tabulated inverse CDF (grid of quantiles).

    Mirrors the grid-inverse-CDF idea the reference already uses for SPE gains
    (wfsim/core/pulse.py:211-227) and garfield timings (s2.py:411-457).
    """
    m = inv_cdf.shape[-1]
    u = jax.random.uniform(key, (n,)) * (m - 1)
    if not interpolate:
        return inv_cdf[jnp.round(u).astype(jnp.int32)]
    i0 = jnp.floor(u).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, m - 1)
    w = u - i0
    return inv_cdf[i0] * (1 - w) + inv_cdf[i1] * w


def truncated_exponential(key, scale, maximum, shape):
    """Exponential(scale) clipped at ``maximum`` (the reference clips rather
    than renormalizes, e.g. maximum_recombination_time at s1.py:229)."""
    return jnp.clip(jax.random.exponential(key, shape) * scale, 0.0, maximum)
