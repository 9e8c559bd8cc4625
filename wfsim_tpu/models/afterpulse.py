"""Afterpulse models.

1. PMT afterpulses (device): per incident photon, per ion species, a uniform
   draw against the channel's delay-time CDF selects afterpulse photons;
   delay and amplitude come from CDF inversions (reference:
   wfsim/core/afterpulse.py:143-249).  Computed batched over all photons and
   species; selected photons are compacted (stable, grouped by instruction)
   into a fixed-capacity buffer.

2. Electron afterpulses (host+device): photoionization (pi_el, type 4) and
   gate photoelectric (pe_el, type 6) emit *new instructions* that re-enter
   the scheduling queue (reference: afterpulse.py:14-139).  The device
   provides per-instruction photon counts and candidate time-zeros; the
   (tiny) instruction synthesis happens on host.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ['pmt_afterpulse_photons', 'photon_summaries',
           'generate_pi_el_instructions', 'generate_pe_el_instructions',
           'reduce_instruction_timing']


def _argmin_abs_monotone(rows, row_idx, r):
    """index minimizing |rows[row_idx, i] - r| for nondecreasing rows —
    the vectorized equivalent of the reference's dense
    ``np.argmin(np.abs(cdf - rU[:, None]), axis=-1)`` lookups
    (afterpulse.py:219-233), via the hierarchical block search (2-3 block
    gathers, ops/randsample.py) instead of an (N, T) matrix or a log2(T)
    scalar-gather binary search."""
    from ..ops.randsample import search_sorted_rows
    R = rows.shape[-1]
    i1 = search_sorted_rows(rows, row_idx, r, side='left')
    i0 = jnp.clip(i1 - 1, 0, R - 1)
    # the (i0, i1) bracket is adjacent, so both candidates ride one
    # row-indexed 2-wide block gather of a pre-paired table (never
    # vmap-of-dynamic_slice — ~800x slower lowering on this backend)
    if R >= 2:
        pairs = jnp.stack([rows[:, :-1], rows[:, 1:]], axis=-1)
        pair = pairs.reshape(-1, 2)[
            row_idx.astype(jnp.int32) * (R - 1) + jnp.minimum(i0, R - 2)]
        v0 = jnp.where(i0 <= R - 2, pair[:, 0], pair[:, 1])
        v1 = jnp.where(i1 > i0, pair[:, 1], v0)
    else:
        v0 = v1 = rows.reshape(-1)[row_idx.astype(jnp.int32)]
    pick_lo = jnp.abs(v0 - r) <= jnp.abs(v1 - r)
    return jnp.where(pick_lo, i0, i1)


@partial(jax.jit, static_argnames=('const', 'ap_capacity', 'n_truth_rows'))
def pmt_afterpulse_photons(params, const, photons, key, *, ap_capacity: int,
                           n_truth_rows: int = 0):
    """Generate PMT afterpulse photons from a primary photon batch.

    :param photons: dict from pmt_response (t, ch, is_dpe, valid, truth_row)
    :returns: photon dict with preset gains (t, ch, gain, valid, truth_row),
        compacted to ``ap_capacity`` slots grouped by truth_row, plus the
        total count.
    """
    n = photons['t'].shape[0]
    n_elements = params.pmt_ap_delay_cdf.shape[0]
    n_ch = params.gains.shape[0]
    ch = jnp.clip(photons['ch'], 0, n_ch - 1)

    # ---- stage 0: selection only, over all (element, photon) slots ----
    # The expensive CDF inversions (log2(R)-step binary searches with a
    # table gather per step) run AFTER compaction, on ap_capacity slots
    # instead of n_elements*n: selection needs just three table gathers per
    # slot — the per-channel AP probability and, for argmin-style elements,
    # the first two amplitude-CDF values, because the reference's
    # ``ap_amp > 0`` cut (afterpulse.py:236-243) is exactly
    # ``2*rU1 > amp_cdf[ch,0] + amp_cdf[ch,1]`` for a nondecreasing row
    # (argmin index 0 is chosen iff rU1 lies at or below that midpoint,
    # tie picking index 0 like the reference's np.argmin).  Draw order and
    # shapes are unchanged, so outputs are bitwise identical.
    # ONE wide key split for all elements (the per-element split(4) chain
    # was n_elements serialized splits)
    eks = jax.random.split(key, 3 * n_elements)
    all_sel, all_rU0, all_aux = [], [], []
    for e in range(n_elements):
        k0, k1, k2 = eks[3 * e], eks[3 * e + 1], eks[3 * e + 2]
        delay_cdf = params.pmt_ap_delay_cdf[e]
        rU0 = 1.0 - jax.random.uniform(k0, (n,))
        rU0 = rU0 / const.pmt_ap_modifier
        rU0 = jnp.where(photons['is_dpe'], rU0 / 2.0, rU0)
        prob_ap = delay_cdf[ch, -1]
        sel = photons['valid'] & (rU0 <= prob_ap)
        if const.pmt_ap_element_uniform[e]:
            aux = jax.random.uniform(k1, (n,))
        else:
            amp_cdf = params.pmt_ap_amp_cdf[e]
            aux = 1.0 - jax.random.uniform(k2, (n,))      # rU1
            if amp_cdf.shape[1] < 2:       # degenerate table: argmin idx
                amp_pos = jnp.zeros(n, bool)    # is always 0 -> amp 0
            else:
                amp_pos = 2.0 * aux > amp_cdf[ch, 0] + amp_cdf[ch, 1]
            sel = sel & amp_pos & (const.pmt_ap_amp_bin[e] > 0)
        all_sel.append(sel)
        all_rU0.append(rU0)
        all_aux.append(aux)

    sel = jnp.concatenate(all_sel)
    rU0_cat = jnp.concatenate(all_rU0)
    aux_cat = jnp.concatenate(all_aux)

    # Compact selected AP photons, keeping them grouped by truth_row so the
    # digitizer can gather contiguous per-group ranges.  Two stages, neither
    # sorting the full n_elements*n axis (a 1.8M-slot stable argsort was
    # this kernel's dominant device cost): (1) compact the selected photons
    # in flat element-major order via cumsum + boundary search; (2) group
    # the ap_capacity survivors by truth_row with a small stable argsort.
    # Both stages preserve flat order within a row, so the output is
    # bitwise identical to the single big argsort whenever total fits
    # ap_capacity (overflowing calls are regenerated larger by the caller).
    pos = jnp.cumsum(sel.astype(jnp.int32))
    total = pos[-1]
    # invert the running selection count with the hierarchical block search
    # (jnp.searchsorted lowers to log2(E*n) scalar-gather rounds)
    from ..ops.randsample import search_sorted_rows
    take1 = search_sorted_rows(
        pos[None, :], jnp.zeros(ap_capacity, jnp.int32),
        jnp.arange(1, ap_capacity + 1, dtype=jnp.int32), side='left')
    take1 = jnp.clip(take1, 0, sel.shape[0] - 1)
    valid1 = jnp.arange(ap_capacity, dtype=jnp.int32) < total

    # ---- stage 1b: per-slot physics at ap_capacity width ----
    e_of = (take1 // n).astype(jnp.int32)
    i_of = (take1 % n).astype(jnp.int32)
    ch_s = ch[i_of]
    rU0_s = rU0_cat[take1]
    aux_s = aux_cat[take1]

    E, C, Rd = params.pmt_ap_delay_cdf.shape
    Ra = params.pmt_ap_amp_cdf.shape[2]
    drows = params.pmt_ap_delay_cdf.reshape(E * C, Rd)
    arows = params.pmt_ap_amp_cdf.reshape(E * C, Ra)
    ridx = e_of * C + ch_s
    delay_bin = jnp.asarray(const.pmt_ap_delay_bin, jnp.float32)[e_of]
    uniform_e = jnp.asarray(const.pmt_ap_element_uniform, bool)[e_of]

    lo0 = drows[ridx, 0]
    hi0 = drows[ridx, 1]
    delay_u = (lo0 + aux_s * (hi0 - lo0)) * delay_bin
    didx = _argmin_abs_monotone(drows, ridx, rU0_s)
    delay_s = (didx.astype(jnp.float32) * delay_bin
               - const.pmt_ap_t_modifier)
    ap_delay = jnp.where(uniform_e, delay_u, delay_s)

    aidx = _argmin_abs_monotone(arows, ridx, aux_s)
    amp_s = aidx.astype(jnp.float32) * \
        jnp.asarray(const.pmt_ap_amp_bin, jnp.float32)[e_of]
    ap_amp = jnp.where(uniform_e, 1.0, amp_s)

    t1 = photons['t'][i_of] + ap_delay.astype(jnp.int32)
    ch1 = photons['ch'][i_of]
    g1 = params.gains[ch_s] * ap_amp
    row1 = photons['truth_row'][i_of]
    order = jnp.argsort(jnp.where(valid1, row1, jnp.int32(2 ** 30)),
                        stable=True)
    valid_o = valid1[order]
    out = dict(t=t1[order], ch=jnp.where(valid_o, ch1[order], -1),
               gain=g1[order].astype(jnp.float32),
               is_dpe=jnp.zeros(ap_capacity, bool),
               valid=valid_o, truth_row=row1[order])
    info = dict(total=total.astype(jnp.int32))
    if n_truth_rows:
        BIG = jnp.int32(2 ** 31 - 1)
        rc = jnp.where(out['valid'], out['truth_row'], 0)
        info['counts'] = jnp.zeros(n_truth_rows, jnp.int32).at[rc].add(
            out['valid'].astype(jnp.int32))
        info['t_min'] = jnp.full(n_truth_rows, BIG, jnp.int32).at[rc].min(
            jnp.where(out['valid'], out['t'], BIG))
        info['t_max'] = jnp.full(n_truth_rows, -BIG, jnp.int32).at[rc].max(
            jnp.where(out['valid'], out['t'], -BIG))
    return out, info


@partial(jax.jit, static_argnames=('n_inst', 'k_candidates'))
def photon_summaries(photons, key, *, n_inst: int, k_candidates: int = 64):
    """Per-instruction photon counts and random time-zero candidates for
    electron-afterpulse generation (the reference samples t-zeros directly
    from the pulse's photon array, afterpulse.py:48-51)."""
    valid = photons['valid']
    row = jnp.where(valid, photons['truth_row'], 0)
    counts = jnp.zeros(n_inst, jnp.int32).at[row].add(valid.astype(jnp.int32))
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    # photons are grouped by instruction: slot = offset[i] + floor(u * count)
    u = jax.random.uniform(key, (n_inst, k_candidates))
    slot = offsets[:, None] + (u * jnp.maximum(counts[:, None], 1)).astype(jnp.int32)
    slot = jnp.clip(slot, 0, photons['t'].shape[0] - 1)
    t_zero = photons['t'][slot]
    return counts, t_zero


_coarse_grid_cache: dict = {}


def _coarse_grid(bin_centers, config):
    """The diffusion-matched coarse delay grid of reduce_instruction_timing.
    It depends only on (bin_centers, two config scalars) — NOT on the delays
    being binned — so it is built once and cached: the sequential
    grid-growing loop (an argmin over bin_centers per step) otherwise reran
    identically for every source S2 instruction in every round."""
    bc = np.asarray(bin_centers)
    key = (bc.tobytes(), float(config['diffusion_constant_longitudinal']),
           float(config['drift_velocity_liquid']))
    coarse = _coarse_grid_cache.get(key)
    if coarse is None:
        spread = np.sqrt(2 * config['diffusion_constant_longitudinal'] * bc)
        spread = spread / config['drift_velocity_liquid']
        grid, ct = [], 100.0
        while ct < bc[-1]:
            grid.append(ct)
            ct += spread[np.argmin(np.abs(ct - bc))]
        coarse = np.array(grid)
        if len(_coarse_grid_cache) > 16:
            _coarse_grid_cache.clear()
        _coarse_grid_cache[key] = coarse
    return coarse


def reduce_instruction_timing(ap_delay, bin_centers, config):
    """Host-side: coarse-bin photoionization delays so electrons that diffuse
    together share one instruction (reference: afterpulse.py:63-80)."""
    coarse = _coarse_grid(bin_centers, config)
    sel = ap_delay < coarse[-1]
    idx = np.digitize(ap_delay[sel], coarse)
    idxs, n = np.unique(idx, return_counts=True)
    return coarse[np.clip(idxs, 0, len(coarse) - 1)], n


def generate_pi_el_instructions(config, resource, rng, counts, t_zero_cand,
                                source_inst, base_time):
    """Host-side photoionization (pi_el, type 4) instruction synthesis
    (reference: afterpulse.py:29-61). One call per source S2 instruction.

    :param counts: per-source-instruction detected photon counts (numpy)
    :param t_zero_cand: (I, K) candidate photon times (window-relative)
    :param source_inst: the numpy instruction array these photons came from
    :param base_time: int64 absolute base of the relative times
    :returns: numpy instruction array (possibly empty)
    """
    hist = resource.uniform_to_ele_ap
    out = []
    for i in range(len(source_inst)):
        n_photons = int(counts[i])
        if n_photons <= 0:
            continue
        n_electron = rng.poisson(hist.n * n_photons
                                 * config['photoionization_modifier'])
        if n_electron <= 0:
            continue
        ap_delay = hist.get_random(n_electron, rng=rng)
        delay_i, n_i = reduce_instruction_timing(ap_delay, hist.bin_centers, config)
        n_instruction = len(delay_i)
        if n_instruction == 0:
            continue
        cand = t_zero_cand[i]
        # cand holds int32 window-relative times; promote before adding the
        # int64 absolute base (spans past ~2.1 s overflow int32)
        t_zeros = base_time + cand[rng.integers(
            0, len(cand), n_instruction)].astype(np.int64)
        new = np.repeat(source_inst[i:i + 1], n_instruction)
        new['type'] = 4
        new['time'] = t_zeros - config['drift_time_gate']
        r = np.sqrt(rng.uniform(0, config['tpc_radius'] ** 2, n_instruction))
        angle = rng.uniform(-np.pi, np.pi, n_instruction)
        new['x'], new['y'] = r * np.cos(angle), r * np.sin(angle)
        new['z'] = -delay_i * config['drift_velocity_liquid']
        new['amp'] = n_i
        out.append(new)
    if not out:
        return np.zeros(0, dtype=source_inst.dtype)
    return np.concatenate(out)


def generate_pe_el_instructions(config, rng, counts, t_zero_cand,
                                source_inst, base_time):
    """Host-side gate photoelectric (pe_el, type 6) instruction synthesis
    (reference: afterpulse.py:92-139)."""
    out = []
    for i in range(len(source_inst)):
        n_photons = int(counts[i])
        if n_photons <= 0:
            continue
        n_electron = rng.poisson(config['photoelectric_p'] * n_photons
                                 * config['photoelectric_modifier'])
        if n_electron <= 0:
            continue
        ap_delay = np.clip(
            rng.normal(config['photoelectric_t_center'] + config['drift_time_gate'],
                       config['photoelectric_t_spread'], n_electron), 0, None)
        cand = t_zero_cand[i]
        t_zeros = base_time + cand[rng.integers(
            0, len(cand), n_electron)].astype(np.int64)
        new = np.repeat(source_inst[i:i + 1], n_electron)
        new['type'] = 6
        new['time'] = t_zeros + config['drift_time_gate']
        r = np.sqrt(rng.uniform(0, config['tpc_radius'] ** 2, n_electron))
        angle = rng.uniform(-np.pi, np.pi, n_electron)
        new['x'], new['y'] = r * np.cos(angle), r * np.sin(angle)
        new['z'] = -ap_delay * config['drift_velocity_liquid']
        new['amp'] = 1
        out.append(new)
    if not out:
        return np.zeros(0, dtype=source_inst.dtype)
    return np.concatenate(out)
