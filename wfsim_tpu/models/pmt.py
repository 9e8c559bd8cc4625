"""PMT response stage: transit-time spread, double-PE emission, SPE gain
sampling, and truth counters.

Vectorized replacement for the reference's per-channel python loop in
``Pulse.__call__`` (reference: wfsim/core/pulse.py:39-144): all photons of a
batch are processed at once; per-truth-row aggregation uses scatter-adds
instead of accumulating dicts.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.segment import ordered_segment_sum
from .common import trunc_int

__all__ = ['pmt_response', 'photon_time_stats']


def pmt_response(params, const, t, ch, valid, truth_row, key,
                 *, n_truth_rows: int, preset_gain=None, count_truth=True,
                 row_edges=None):
    """Apply the PMT response to a photon batch.

    :param t: (N,) int32 photon times (window-relative ns)
    :param ch: (N,) int32 channels
    :param valid: (N,) bool
    :param truth_row: (N,) int32 truth-row id per photon
    :param preset_gain: (N,) float32 — set for PMT afterpulse photons, whose
        gains are assigned from amplitude CDFs and which skip TTS and DPE
        (reference: pulse.py:52-56, 95-107)
    :param row_edges: optional (n_truth_rows+1,) int32 photon boundaries per
        truth row (truth_row ascending); enables cumsum-based truth counters
        instead of scatter-adds into the small per-row output
    :returns: (photons dict, truth dict or None)

    ``key`` may be a pre-split (>=4,) key array — the sim chains split
    once at their top and pass key slices down (see models/common.py
    _key2).
    """
    if getattr(key, 'ndim', 0) >= 1 and key.shape[0] >= 4:
        k_tts, k_dpe, k_g1, k_g2 = key[0], key[1], key[2], key[3]
    else:
        k_tts, k_dpe, k_g1, k_g2 = jax.random.split(key, 4)
    n = t.shape[0]

    chc = jnp.clip(ch, 0, params.gains.shape[0] - 1)
    # one 4-wide block gather for every per-channel scalar this stage
    # needs (gain, threshold, live, bottom): one index per photon instead
    # of four (unmeasured on H100, ROADMAP C2)
    cp = params.chan_pack[chc]
    gain_ch = cp[:, 0]
    if preset_gain is None:
        tts = jax.random.normal(k_tts, (n,)) * (
            const.pmt_transit_time_spread / 2.35482) + const.pmt_transit_time_mean
        t = t + trunc_int(tts)
        is_dpe = jax.random.uniform(k_dpe, (n,)) < const.p_double_pe_emision
        u1 = jax.random.uniform(k_g1, (n,))
        u2 = jax.random.uniform(k_g2, (n,))
        idx1 = (u1 * 2000).astype(jnp.int32) + 1
        idx2 = (u2 * 2000).astype(jnp.int32) + 1
        # flat 1-D indexing with a precomputed flat index (unmeasured on H100,
        # ROADMAP C2)
        ut = params.uniform_to_pe.reshape(-1)
        m = params.uniform_to_pe.shape[1]
        base = chc * m
        g1 = gain_ch * ut[base + idx1]
        g2 = gain_ch * ut[base + idx2]
        gain = g1 + jnp.where(is_dpe, g2, 0.0)
    else:
        is_dpe = jnp.zeros(n, dtype=bool)
        gain = preset_gain

    # Photons on turned-off PMTs are dropped entirely (reference: pulse.py:89)
    valid = valid & (ch >= 0) & (ch < params.gains.shape[0]) & (cp[:, 2] > 0)

    # invalid slots are marked with channel -1 so downstream consumers can
    # carry padded buffers without a separate mask
    photons = dict(t=t, ch=jnp.where(valid, ch, -1),
                   gain=gain.astype(jnp.float32),
                   is_dpe=is_dpe, valid=valid, truth_row=truth_row)

    truth = None
    if count_truth:
        truth = _pulse_truth(params, const, photons, n_truth_rows,
                             row_edges=row_edges)
    return photons, truth


def _pulse_truth(params, const, ph, n_truth_rows: int, row_edges=None):
    """Truth counters per row (reference: wfsim/core/pulse.py:229-271).

    The trigger test: the photon's peak amplitude in ADC
    (gain * template-peak(remainder) * current_2_adc) must exceed the channel
    threshold.  Note: the reference counts triggered DPE photons with a
    positional quirk (``above_threshold[:n_double_pe]``, pulse.py:255); we use
    the exact DPE mask — statistically identical.
    """
    from ..ops.segment import sorted_segment_sum
    t, ch, gain, valid = ph['t'], ph['ch'], ph['gain'], ph['valid']
    row = jnp.where(valid, ph['truth_row'], 0)
    chc = jnp.clip(ch, 0, params.gains.shape[0] - 1)
    cp = params.chan_pack[chc]       # [gain, threshold, live, bottom]
    dt = const.sample_duration

    remainder = jnp.where(t >= 0, t % dt, (t % dt + dt) % dt)
    # 10-entry table lookup as a one-hot masked sum, which fuses into one
    # elementwise pass over the photon axis (unmeasured on H100, ROADMAP C2)
    cm = jnp.sum(
        jnp.where(remainder[:, None]
                  == jnp.arange(dt, dtype=jnp.int32)[None, :],
                  params.current_max[None, :dt], 0.0), axis=1)
    max_amp_adc = gain * cm * const.current_2_adc
    above = valid & (max_amp_adc > cp[:, 1])
    is_dpe = ph['is_dpe'] & valid

    v1 = valid.astype(jnp.float32)
    pe_w = v1 + is_dpe.astype(jnp.float32)       # photons + dpe
    trig = above.astype(jnp.float32)
    pe_trig = trig + (above & is_dpe).astype(jnp.float32)
    gain_over_g = jnp.where(valid, gain / jnp.maximum(cp[:, 0], 1e-30), 0.0)
    area_trig = jnp.where(above, gain_over_g, 0.0)

    # truth_row is ascending by construction (photons are generated grouped
    # by instruction), so per-row sums are cumsum+boundary-gather segment
    # sums rather than scatter-adds into the small (n_truth_rows,) output
    # (unmeasured on H100, ROADMAP C2). Callers pass
    # the boundaries precomputed from count cumsums; the searchsorted
    # fallback also lowers poorly at large N, so an order-fixed sort + scan
    # sum is the fallback.
    if row_edges is not None:
        def acc(x):
            return sorted_segment_sum(x, row_edges, valid=valid)
    else:
        def acc(x):
            return ordered_segment_sum(
                jnp.where(valid, x.astype(jnp.float32), 0.0), row,
                n_truth_rows)

    out = {
        'n_photon': acc(v1),
        'n_pe': acc(pe_w),
        'n_photon_trigger': acc(trig),
        'n_pe_trigger': acc(pe_trig),
        'raw_area': acc(gain_over_g),
        'raw_area_trigger': acc(area_trig),
    }
    if const.per_pmt_truth:
        nc = params.gains.shape[0]
        def acc2(x):
            return ordered_segment_sum(
                jnp.where(valid, x, 0.0), row * nc + chc,
                n_truth_rows * nc).reshape(n_truth_rows, nc)
        for name, x in [('n_photon', v1), ('n_pe', pe_w),
                        ('n_photon_trigger', trig), ('n_pe_trigger', pe_trig),
                        ('raw_area', gain_over_g), ('raw_area_trigger', area_trig)]:
            out[name + '_per_pmt'] = acc2(x)
    else:
        bot = (cp[:, 3] > 0) & valid
        if row_edges is not None:
            def accb(x):
                return sorted_segment_sum(x, row_edges, valid=bot)
        else:
            def accb(x):
                return ordered_segment_sum(
                    jnp.where(bot, x.astype(jnp.float32), 0.0), row,
                    n_truth_rows)
        for name, x in [('n_photon', v1), ('n_pe', pe_w),
                        ('n_photon_trigger', trig), ('n_pe_trigger', pe_trig),
                        ('raw_area', gain_over_g), ('raw_area_trigger', area_trig)]:
            out[name + '_bottom'] = accb(x)
    return out


def photon_time_stats(t, valid, truth_row, n_truth_rows: int,
                      row_edges=None):
    """Per-row timing statistics (count, min, max, mean, std) used by the
    truth output (reference: wfsim/core/rawdata.py:325-332).

    Times are int32 window-relative; sums are centered on the per-row minimum
    to keep f32 accumulation exact enough for sub-ns moments.

    With ``row_edges`` (rows contiguous ascending — true for every sim
    chain), everything runs as segment ops over the sorted axis: cumsum
    segment sums, a log-step shifted reduction for min/max, and a
    diff-cumsum broadcast of the per-row minimum — replacing five
    scatter-reductions into the small (n_truth_rows,) output plus a
    (N,)-index gather (unmeasured on H100, ROADMAP C2).  The scatter path
    remains for unsorted callers.
    """
    BIG = jnp.int32(2 ** 31 - 1)
    if row_edges is not None:
        from ..ops.segment import (sorted_segment_sum, segment_min_max,
                                   expand_rows)
        tmin, tmax = segment_min_max(t, truth_row, row_edges, n_truth_rows,
                                     valid=valid, big=2 ** 31 - 1)
        cnt = sorted_segment_sum(valid.astype(jnp.int32), row_edges)
        tmin_ph = expand_rows(jnp.where(cnt > 0, tmin, 0), row_edges,
                              t.shape[0])
        centered = (t - tmin_ph).astype(jnp.float32)
        s1_ = sorted_segment_sum(centered, row_edges, valid=valid)
        s2_ = sorted_segment_sum(centered * centered, row_edges, valid=valid)
    else:
        row = jnp.where(valid, truth_row, 0)
        cnt = jnp.zeros(n_truth_rows, jnp.int32).at[row].add(
            valid.astype(jnp.int32))
        tmin = jnp.full(n_truth_rows, BIG, jnp.int32).at[row].min(
            jnp.where(valid, t, BIG))
        tmax = jnp.full(n_truth_rows, -BIG, jnp.int32).at[row].max(
            jnp.where(valid, t, -BIG))
        centered = jnp.where(valid, (t - tmin[row]).astype(jnp.float32), 0.0)
        s1_, s2_ = ordered_segment_sum(
            jnp.stack([centered, centered * centered], axis=1), row,
            n_truth_rows).T
    cntf = jnp.maximum(cnt.astype(jnp.float32), 1.0)
    mean_c = s1_ / cntf
    var = jnp.maximum(s2_ / cntf - mean_c * mean_c, 0.0)
    return dict(count=cnt, t_min=tmin, t_max=tmax,
                t_mean_offset=mean_c, t_sigma=jnp.sqrt(var))
