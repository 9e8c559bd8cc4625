"""Zero-length-encoding (self-trigger) interval finding, vectorized on device.

The reference scans each channel's waveform sequentially in numba
(``find_intervals_below_threshold``, reference: wfsim/utils.py:14-58, called
from wfsim/core/rawdata.py:274-311).  Here the same semantics are computed
for ALL channels at once with data-parallel primitives:

- ``below`` mask per sample,
- gap-bridging via a running maximum of the last below-threshold index
  (a gap of <= holdoff samples between below-threshold samples joins runs,
  exactly the reference's holdoff rule),
- interval extraction via scatter-min/max into a fixed-capacity buffer.

Output is (starts, ends, count) per channel with static shapes; the ragged
packing into records happens at the host boundary (pipeline/packing.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ['find_intervals', 'zle_all_channels']

_BIG = jnp.int32(2 ** 30)


@partial(jax.jit, static_argnames=('holdoff', 'max_intervals'))
def find_intervals(below: jnp.ndarray, *, holdoff: int, max_intervals: int):
    """All-channel interval finder. ``below``: (C, T) bool. Returns
    starts (C, K), ends (C, K), counts (C,).

    Start/end samples are detected with running max/min of below-threshold
    indices (the holdoff gap rule), then the first K per channel are
    extracted with ``top_k`` — no scatters.
    """
    C, T = below.shape
    idx = jnp.arange(T, dtype=jnp.int32)[None, :]
    # any below-threshold sample within `holdoff` strictly before / after i:
    # windowed-any == windowed-count > 0, one cumulative sum + two shifted
    # differences (a reduce_window of width `holdoff` lowers to O(T*holdoff))
    csum = jnp.cumsum(below.astype(jnp.int32), axis=1)
    zero = jnp.zeros((C, 1), jnp.int32)
    csum_p = jnp.concatenate([zero, csum], axis=1)   # csum_p[i] = sum(x[:i])

    def shifted(s):
        # csum_p[clip(i + s, 0, T)] for i in 0..T-1, STATIC shift s: an
        # edge-padded slice instead of a (C, T) take_along_axis gather —
        # the four windowed-sum gathers were ~25% of the ZLE pass's HBM
        # time (gathers don't stream; slices do)
        if s == 0:
            return jax.lax.slice(csum_p, (0, 0), (C, T))
        if s <= -T:
            return jnp.broadcast_to(csum_p[:, :1], (C, T))
        if s < 0:
            pad = jnp.broadcast_to(csum_p[:, :1], (C, -s))
            return jnp.concatenate(
                [pad, jax.lax.slice(csum_p, (0, 0), (C, T + s))], axis=1)
        # s > 0: take csum_p[:, s : s+T], edge-padding past T
        avail = csum_p.shape[1] - s          # columns available from s
        if avail >= T:
            return jax.lax.slice(csum_p, (0, s), (C, s + T))
        if avail <= 0:
            return jnp.broadcast_to(csum_p[:, -1:], (C, T))
        tail = jnp.broadcast_to(csum_p[:, -1:], (C, T - avail))
        return jnp.concatenate(
            [jax.lax.slice(csum_p, (0, s), (C, csum_p.shape[1])), tail],
            axis=1)

    def win_sum(lo_shift, hi_shift):
        # sum over x[i+lo_shift .. i+hi_shift] inclusive
        return shifted(hi_shift + 1) - shifted(lo_shift)

    prev_any = win_sum(-holdoff, -1) > 0
    next_any = win_sum(1, holdoff) > 0
    # Interval start: no below sample within holdoff before
    # (reference close rule: utils.py:44-45); end: none within holdoff after
    new_start = below & ~prev_any
    is_end = below & ~next_any

    # Extract the first K starts/ends per channel in ascending sample order.
    # Consecutive starts (and ends) are at least holdoff+1 samples apart, so a
    # block of S <= holdoff+1 samples holds at most one marker: compress to one
    # candidate per block, then a tiny per-row sort compacts them — avoiding a
    # full-width top_k, which lowers to a sort (unmeasured on H100, ROADMAP
    # C2).
    S = 64
    if holdoff + 1 >= S and T % S == 0:
        nb = T // S
        pos = jax.lax.broadcasted_iota(jnp.int32, (C, nb, S), 2)

        def first_k(mask):
            m = mask.reshape(C, nb, S)
            cand = jnp.min(jnp.where(m, pos, _BIG), axis=2)
            cand = jnp.where(cand < _BIG,
                             cand + jnp.arange(nb, dtype=jnp.int32)[None, :] * S,
                             _BIG)
            cand = jnp.sort(cand, axis=1)
            if nb >= max_intervals:
                return cand[:, :max_intervals]
            return jnp.pad(cand, ((0, 0), (0, max_intervals - nb)),
                           constant_values=_BIG)

        starts = first_k(new_start)
        ends = first_k(is_end)
    else:
        def first_k(mask):
            vals, _ = jax.lax.top_k(jnp.where(mask, T - idx, 0), max_intervals)
            return jnp.where(vals > 0, T - vals, _BIG)

        starts = first_k(new_start)
        ends = first_k(is_end)
    counts = jnp.minimum(new_start.sum(axis=1), max_intervals)
    ends = jnp.where(ends >= _BIG, -_BIG, ends)
    return starts, ends, counts


@partial(jax.jit, static_argnames=('holdoff', 'max_intervals', 'trigger_window'))
def zle_all_channels(data: jnp.ndarray,
                     thresholds: jnp.ndarray,
                     ch_left: jnp.ndarray,
                     ch_right: jnp.ndarray,
                     ch_mask: jnp.ndarray,
                     *,
                     holdoff: int,
                     trigger_window: int,
                     max_intervals: int):
    """Full ZLE pass over the digitized grid.

    Mirrors RawData.ZLE (reference: wfsim/core/rawdata.py:274-311): per active
    channel, scan data[ch_left:ch_right+1] for below-threshold intervals, pad
    by +-trigger_window, clip to the channel window, land bounds on even
    sample offsets (digitizer quirk), and return window-relative inclusive
    bounds.

    :param data: (C, T) int32 digitized waveform grid
    :param thresholds: (C,) int32 per-channel ZLE threshold (ADC)
    :param ch_left/ch_right: (C,) int32 active window per channel (grid-relative)
    :param ch_mask: (C,) bool channel active mask
    :returns: (starts, ends, counts) — starts/ends are (C, K) int32 offsets
        relative to each channel's ``ch_left`` (like the reference's per-channel
        view), counts (C,) int32.  Inactive channels have count 0.
    """
    C, T = data.shape
    idx = jnp.arange(T, dtype=jnp.int32)
    in_window = (idx[None, :] >= ch_left[:, None]) & (idx[None, :] <= ch_right[:, None])
    below = (data < thresholds[:, None]) & in_window & ch_mask[:, None]

    starts, ends, counts = find_intervals(below, holdoff=holdoff,
                                          max_intervals=max_intervals)
    # Make bounds relative to the channel window (reference views the
    # per-channel slice before searching)
    starts = starts - ch_left[:, None]
    ends = ends - ch_left[:, None]
    length = (ch_right - ch_left + 1)[:, None]

    starts = starts - trigger_window
    ends = ends + trigger_window
    starts = jnp.clip(starts, 0, length - 1)
    ends = jnp.clip(ends, 0, length - 1)
    # Land trigger window on even offsets (reference: rawdata.py:306-308)
    starts = ((starts + 1) // 2) * 2
    ends = (ends // 2) * 2
    counts = jnp.where(ch_mask, counts, 0)
    return starts, ends, counts
