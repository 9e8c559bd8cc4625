"""Contiguous-span gathers built from row-indexed block gathers.

These forms replace arbitrary-start 1-D slice gathers
(``vmap(dynamic_slice)`` or ``lax.gather`` with a >1 slice size) by a
row-indexed block gather from a 2-D table (``tab[idx]``), on the premise
that a gather costs per index rather than per byte (unmeasured on H100,
ROADMAP C2).

:func:`gather_spans` reads ``width`` consecutive elements starting at an
arbitrary flat offset per query by gathering the covering 128-aligned
blocks as table rows and aligning them with a log-step barrel shift
(7 static-shift select passes).
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ['gather_spans', 'stream_compact']


def stream_compact(vals: jnp.ndarray, mask: jnp.ndarray, out_len: int):
    """Order-preserving stream compaction WITHOUT a gather: returns the
    first ``out_len`` masked elements of ``vals`` in order.

    Elements move left by (index - rank), applied bit by bit (LSB first)
    as log2(n) static-shift select passes.  Nondecreasing shift distances
    make the per-bit moves collision-free: two live elements at distance
    d = 2^k with remaining shifts (r_a, r_b), r_a <= r_b, both multiples
    of d, can only collide if r_b - r_a < d AND bit k differs — impossible.
    Vacated slots that receive nothing are invalidated (shift -1) so stale
    copies never move again.  Exactness is pinned by
    tests/test_ops.py::test_stream_compact_matches_compress; whether it
    beats the equivalent-index gather is unmeasured on H100 (ROADMAP C2).
    """
    n = vals.shape[0]
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    idx = jnp.arange(n, dtype=jnp.int32)
    shift = jnp.where(mask, idx - rank, -1)          # -1 marks holes
    v = vals
    k = 1
    while k < n:
        sh_r = jnp.concatenate([shift[k:], jnp.full(k, -1, jnp.int32)])
        v_r = jnp.concatenate([v[k:], jnp.zeros(k, v.dtype)])
        take = (sh_r >= 0) & ((sh_r & k) != 0)
        sent = (shift >= 0) & ((shift & k) != 0)
        v = jnp.where(take, v_r, v)
        shift = jnp.where(take, sh_r - k, jnp.where(sent, -1, shift))
        k <<= 1
    return v[:out_len]


def gather_spans(flat: jnp.ndarray, starts: jnp.ndarray, width: int):
    """``out[i, k] == flat[starts[i] + k]`` for ``k < width``.

    Reads past the end of ``flat`` return the pad value 0 (callers mask).
    ``width`` is static.  Cost: ceil((width+127)/128)+1 row gathers per
    query plus 7 select passes over the (N, blocks*128) working set.
    """
    nblk = (width + 127) // 128 + 1
    pad = nblk * 128 + 128
    flat = jnp.concatenate(
        [flat, jnp.zeros(pad, flat.dtype)]) if flat.ndim == 1 else flat
    nb = flat.shape[0] // 128
    f2 = flat[:nb * 128].reshape(nb, 128)
    b0 = jnp.clip(starts // 128, 0, nb - 1)
    off = starts - b0 * 128
    parts = [f2[jnp.minimum(b0 + j, nb - 1)] for j in range(nblk)]
    x = jnp.concatenate(parts, axis=1)
    for sh in (64, 32, 16, 8, 4, 2, 1):
        bit = (off & sh) > 0
        x = jnp.where(bit[:, None], jnp.pad(x[:, sh:], ((0, 0), (0, sh))), x)
    return x[:, :width]
