"""Fixed-capacity ragged helpers.

The physics is ragged (each instruction produces a different number of
photons/electrons); compiled programs want static shapes.  The core trick in
this framework: lay the ragged axis out in a fixed-capacity padded buffer,
derive a per-slot segment id by searchsorted on the count cumsum, and carry a
validity mask.  This replaces every ``np.repeat`` in the reference
(e.g. wfsim/core/s1.py:180, s2.py:111,555).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ['segment_ids_from_counts', 'repeat_to_capacity',
           'ordered_segment_sum']


def segment_ids_from_counts(counts: jnp.ndarray, capacity: int):
    """Given per-segment counts (S,), produce (seg_id (capacity,), valid mask,
    total).  Slot i belongs to the segment whose cumulative range contains i.
    Overflow beyond ``capacity`` is truncated (callers check ``total``)."""
    counts = jnp.asarray(counts, dtype=jnp.int32)
    csum = jnp.cumsum(counts)
    total = csum[-1] if counts.shape[0] > 0 else jnp.int32(0)
    slots = jnp.arange(capacity, dtype=jnp.int32)
    # seg_id[i] == #{s : csum[s] <= i} (searchsorted side='right'), computed
    # as a segment-boundary scatter + prefix sum: O(S + capacity) instead of
    # log2(S) binary-search gathers per slot (~5x faster at 2^21 slots)
    marks = jnp.zeros(capacity, jnp.int32).at[csum].add(1, mode='drop')
    seg_id = jnp.cumsum(marks)
    valid = slots < total
    seg_id = jnp.where(valid, seg_id, counts.shape[0] - 1)
    seg_id = jnp.clip(seg_id, 0, max(counts.shape[0] - 1, 0))
    return seg_id, valid, total


def repeat_to_capacity(values: jnp.ndarray, counts: jnp.ndarray, capacity: int):
    """np.repeat(values, counts) into a fixed-size buffer + validity mask."""
    seg_id, valid, total = segment_ids_from_counts(counts, capacity)
    return values[seg_id], seg_id, valid, total


def segment_edges(seg_id_sorted: jnp.ndarray, n_segments: int):
    """Boundary indices of ASCENDING segment ids: ``edges[s]`` is the first
    position with ``seg_id >= s``, so segment s occupies
    ``[edges[s], edges[s+1])``.

    NOTE: searchsorted over a large device array lowers to a loop
    (unmeasured on H100, ROADMAP C2); when the ids came from
    :func:`segment_ids_from_counts`, build the edges directly from the
    counts with :func:`edges_from_counts` instead.
    """
    return jnp.searchsorted(
        seg_id_sorted, jnp.arange(n_segments + 1, dtype=jnp.int32),
        side='left').astype(jnp.int32)


def edges_from_counts(counts: jnp.ndarray, capacity: int):
    """Exact segment boundaries (S+1,) for ids produced by
    :func:`segment_ids_from_counts` — one tiny cumsum, no search."""
    csum = jnp.clip(jnp.cumsum(counts.astype(jnp.int32)), 0, capacity)
    return jnp.concatenate(
        [jnp.zeros(1, jnp.int32), csum]).astype(jnp.int32)


def expand_rows(vals: jnp.ndarray, edges: jnp.ndarray, capacity: int):
    """Broadcast per-segment INTEGER values to the element axis for
    contiguous ascending segments: ``out[i] == vals[r]`` for
    ``i in [edges[r], edges[r+1])`` (positions past ``edges[-1]`` repeat the
    last value; callers mask).

    This replaces ``vals[seg_id]`` — a (capacity,)-index scalar gather —
    with one tiny diff-scatter plus one cumsum (unmeasured on H100,
    ROADMAP C2): exact for integers because the cumsum of the int32
    difference sequence telescopes.
    """
    vals = vals.astype(jnp.int32)
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), vals[:-1]])
    d = jnp.zeros(capacity, jnp.int32).at[
        jnp.clip(edges[:-1], 0, capacity)].add(vals - prev, mode='drop')
    return jnp.cumsum(d)


def segment_min_max(values: jnp.ndarray, seg_id: jnp.ndarray,
                    edges: jnp.ndarray, n_segments: int,
                    valid=None, big: int = 2 ** 31 - 1):
    """Per-segment (min, max) of int32 values for contiguous ASCENDING
    segment ids, via a log-step shifted reduction instead of scatter-min/max
    into a small output (unmeasured on H100, ROADMAP C2).  ~log2(N)
    elementwise passes, exact.

    Empty segments return (big, -big), matching the scatter identities.
    """
    n = values.shape[0]
    big = jnp.int32(big)
    mx = jnp.where(valid, values, -big) if valid is not None else values
    mn = jnp.where(valid, values, big) if valid is not None else values
    d = 1
    while d < n:
        same = seg_id[d:] == seg_id[:-d]
        mx = mx.at[d:].set(jnp.where(same, jnp.maximum(mx[d:], mx[:-d]),
                                     mx[d:]))
        mn = mn.at[d:].set(jnp.where(same, jnp.minimum(mn[d:], mn[:-d]),
                                     mn[d:]))
        d *= 2
    last = jnp.clip(edges[1:] - 1, 0, n - 1)
    empty = edges[1:] <= edges[:-1]
    seg_mn = jnp.where(empty, big, mn[last])
    seg_mx = jnp.where(empty, -big, mx[last])
    return seg_mn[:n_segments], seg_mx[:n_segments]


def ordered_segment_sum(values: jnp.ndarray, seg_id: jnp.ndarray,
                        n_segments: int):
    """``zeros((n_segments,) + values.shape[1:]).at[seg_id].add(values)``
    for ids in any order, with each segment's float sum taken in one fixed
    order, so a seed gives the same bits on every run.

    A float scatter-add runs as atomics on the GPU, summing colliding
    elements in an order that changes from run to run.  Here the elements
    are stably sorted by segment, each run is summed by a segmented scan
    (whose tree depends only on the length), and each segment's total is
    stored once.  Ids outside ``[0, n_segments)`` are dropped.
    """
    order = jnp.argsort(seg_id, stable=True)
    k = seg_id[order]
    v = values[order]
    new = k[1:] != k[:-1]
    start = jnp.concatenate([jnp.ones(1, bool), new])
    last = jnp.concatenate([new, jnp.ones(1, bool)])
    tail = (1,) * (values.ndim - 1)

    def add_in_segment(a, b):
        restart = b[0].reshape(b[0].shape + tail)
        return a[0] | b[0], jnp.where(restart, b[1], a[1] + b[1])
    _, total = jax.lax.associative_scan(add_in_segment, (start, v))
    ok = last & (k >= 0) & (k < n_segments)
    return jnp.zeros((n_segments,) + values.shape[1:], values.dtype).at[
        jnp.where(ok, k, n_segments)].set(total, mode='drop')


def sorted_segment_sum(values: jnp.ndarray, edges: jnp.ndarray, valid=None):
    """Per-segment sum for ascending segment ids: one cumsum plus boundary
    gathers.

    Replaces a scatter-add of a large batch into a small per-segment
    output with two vector passes (unmeasured on H100, ROADMAP C2).
    Integer values sum exactly; float32 cumsum carries O(N*eps*magnitude)
    error — fine for counts/areas, not for second moments.
    """
    if valid is not None:
        values = jnp.where(valid, values, jnp.zeros((), values.dtype))
    c = jnp.cumsum(values)
    tot = jnp.concatenate([jnp.zeros(1, c.dtype), c])
    return tot[edges[1:]] - tot[edges[:-1]]
