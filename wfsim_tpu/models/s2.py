"""S2 electroluminescence model: field distortion, electron drift/diffusion/
extraction, luminescence photon timing, channel patterns.

Vectorized fixed-capacity equivalent of the reference S2 chain
(reference: wfsim/core/s2.py).  The three luminescence models are supported:

- ``simple``   — analytic anode-field integration (reference s2.py:317-378),
  computed as per-instruction CDF grids + per-photon inverse-CDF search;
- ``garfield`` — wire-distance-indexed timing table (s2.py:380-409);
- ``garfield_gas_gap`` — gas-gap-interpolated inverse CDFs (s2.py:411-483).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import units
from ..ops.randsample import categorical_from_cdf, binomial, poisson
from ..ops.segment import segment_ids_from_counts, ordered_segment_sum
from .common import singlet_triplet_delays, skew_normal, rz_lookup, trunc_int
from .pmt import pmt_response, photon_time_stats

__all__ = ['simulate_s2', 'inverse_field_distortion_correction',
           'field_distortion_comsol', 'get_s2_drift_time_params',
           'get_electron_yield', 'get_s2_light_yield']

#: top-level key-split width of the S2 chain (one device split per kernel,
#: see models/common.py _key2)
N_S2_KEYS = 20


# ---------------------------------------------------------------------------
# Field distortion


def inverse_field_distortion_correction(params, x, y, z):
    """6-iteration fixed-point inversion of the field-distortion correction
    (reference: s2.py:29-53)."""
    positions = jnp.stack([x, y, z], axis=1)
    dr_pre = jnp.zeros_like(x)
    x_obs, y_obs, z_obs = x, y, z
    for i_iter in range(6):
        dr = params.fdc_3d(positions)
        if dr.ndim > 1:
            dr = dr[..., 0]
        dr = jnp.where(i_iter > 0, 0.5 * dr + 0.5 * dr_pre, dr)
        dr_pre = dr
        r_obs = jnp.sqrt(x ** 2 + y ** 2) - dr
        x_obs = x * r_obs / (r_obs + dr)
        y_obs = y * r_obs / (r_obs + dr)
        z_obs = -jnp.sqrt(z ** 2 + dr ** 2)
        positions = jnp.stack([x_obs, y_obs, z_obs], axis=1)
    return z_obs, jnp.stack([x_obs, y_obs], axis=1)


def field_distortion_comsol(params, x, y, z):
    """COMSOL (r, z) -> observed r distortion (reference: s2.py:55-71)."""
    pos = jnp.stack([jnp.sqrt(x ** 2 + y ** 2), z], axis=1)
    theta = jnp.arctan2(y, x)
    r_obs = params.fd_comsol(pos)
    if r_obs.ndim > 1:
        r_obs = r_obs[..., 0]
    return z, jnp.stack([r_obs * jnp.cos(theta), r_obs * jnp.sin(theta)], axis=1)


# ---------------------------------------------------------------------------
# Drift / extraction


def get_avg_drift_velocity(params, const, z, xy):
    """(reference: s2.py:138-155)"""
    if const.en_drift_speed and params.drift_speed_map is not None:
        v = rz_lookup(params.drift_speed_map, z, xy)
        if v.ndim > 1:
            v = v[..., 0]
        return v * 1e-4 * const.drift_velocity_scaling
    return jnp.full_like(z, const.drift_velocity_liquid)


def get_s2_drift_time_params(params, const, z_int, xy_int):
    """Mean drift time and longitudinal-diffusion spread
    (reference: s2.py:157-179)."""
    v = get_avg_drift_velocity(params, const, z_int, xy_int)
    if const.en_diff_long and params.diffusion_long_map is not None:
        dlong = rz_lookup(params.diffusion_long_map, z_int, xy_int)
        if dlong.ndim > 1:
            dlong = dlong[..., 0]
    else:
        dlong = const.diffusion_constant_longitudinal
    drift_time_mean = jnp.clip(-z_int / v + const.drift_time_gate, 0.0, None)
    drift_time_spread = jnp.sqrt(2 * dlong * drift_time_mean) / v
    return drift_time_mean, drift_time_spread


def get_s2_light_yield(params, const, positions):
    """Photons per extracted electron (reference: s2.py:181-209)."""
    if const.se_gain_from_map and params.se_gain is not None:
        sc_gain = params.se_gain(positions)
    else:
        sc_gain = params.s2_correction(positions)
        if sc_gain.ndim > 1:
            sc_gain = sc_gain[..., 0]
        sc_gain = sc_gain * const.s2_secondary_sc_gain
    if sc_gain.ndim > 1:
        sc_gain = sc_gain[..., 0]
    sc_gain = sc_gain / (1 + const.p_double_pe_emision)
    return jnp.nan_to_num(sc_gain, nan=0.0)


def get_electron_yield(params, const, key, n_electron, xy_int, z_int, positions):
    """Surviving electrons after extraction efficiency, lifetime and
    survival-probability losses (reference: s2.py:211-256)."""
    drift_time_mean, _ = get_s2_drift_time_params(params, const, z_int, xy_int)
    if const.ext_eff_from_map:
        rel_s2_cor = params.s2_correction(positions)
        if rel_s2_cor.ndim > 1:
            rel_s2_cor = rel_s2_cor[..., 0]
        if const.se_gain_from_map and params.se_gain is not None:
            se_gains = params.se_gain(positions)
            if se_gains.ndim > 1:
                se_gains = se_gains[..., 0]
        else:
            se_gains = rel_s2_cor * const.s2_secondary_sc_gain
        cy = const.g2_mean * rel_s2_cor / jnp.maximum(se_gains, 1e-30)
    else:
        cy = jnp.full_like(z_int, const.electron_extraction_yield)
    cy = cy * jnp.exp(-drift_time_mean / const.electron_lifetime_liquid)
    if const.en_survival_prob and params.survival_prob_map is not None:
        p_surv = rz_lookup(params.survival_prob_map, z_int, xy_int)
        if p_surv.ndim > 1:
            p_surv = p_surv[..., 0]
        cy = cy * jnp.clip(p_surv, 0.0, 1.0)
    return binomial(key, n_electron, cy)


# ---------------------------------------------------------------------------
# Luminescence timing models


def _interp_rows(x_rows, y_rows, row_idx, q):
    """Per-sample linear interpolation y(q) on per-row monotone tables:
    the vectorized analogue of the reference's per-instruction
    ``np.interp(probabilities, y, t)`` (s2.py:338)."""
    R = x_rows.shape[-1]
    # hierarchical block search (2-3 block gathers instead of log2(R)
    # scalar-gather rounds; bitwise-identical bracketing index), then the four
    # lerp operands ride ONE 4-wide block gather of an interleaved (x, y) pair
    # table: fewer indices for the same bytes (unmeasured on H100, ROADMAP C2)
    from ..ops.randsample import search_sorted_rows
    i1 = jnp.clip(search_sorted_rows(x_rows, row_idx, q, side='left'),
                  1, R - 1)
    i0 = i1 - 1
    # (x0, y0, x1, y1) as ONE row-indexed 4-wide block gather of a
    # pre-paired table (vmap-of-dynamic_slice lowers ~800x slower on this
    # backend — measured; row-indexed block gathers are the fast form)
    quad = jnp.stack([x_rows[:, :-1], y_rows[:, :-1],
                      x_rows[:, 1:], y_rows[:, 1:]], axis=-1)   # (I, R-1, 4)
    blk = quad.reshape(-1, 4)[row_idx.astype(jnp.int32) * (R - 1) + i0]
    x0, y0, x1, y1 = blk[:, 0], blk[:, 1], blk[:, 2], blk[:, 3]
    w = jnp.where(x1 > x0, (q - x0) / jnp.maximum(x1 - x0, 1e-30), 0.0)
    w = jnp.clip(w, 0.0, 1.0)
    return y0 * (1 - w) + y1 * w


def luminescence_simple(params, const, key, xy, ph_inst, ph_valid):
    """Analytic single-electron luminescence timing (reference: s2.py:317-378).

    Per instruction, integrate the electron drift through the anode field on a
    fixed radius grid to get (t(r), y(r)) curves, then sample photons by
    inverse-CDF interpolation.  The mean-centering offset ``avgt`` is computed
    per instruction over its own gas gap (the reference computes it over the
    batch max gap; identical when gas-gap warping is off).
    """
    number_density_gas = const.pressure / (units.boltzmannConstant * const.temperature)
    alpha = const.gas_drift_velocity_slope / number_density_gas
    uE = units.kV / units.cm
    pressure = const.pressure / units.bar
    rA = const.anode_field_domination_distance
    rW = const.anode_wire_radius

    if const.enable_gas_gap_warping and params.gas_gap_map is not None:
        dG = params.gas_gap_map(xy)
        if dG.ndim > 1:
            dG = dG[..., 0]
    else:
        dG = jnp.full(xy.shape[0], const.elr_gas_gap_length)
    dL = const.gate_to_anode_distance - dG
    VG = const.anode_voltage / (1 + dL / dG / const.lxe_dielectric_constant)
    E0 = VG / ((dG - rA) / rA + np.log(rA / rW))  # V/cm

    # Fixed descending radius grid covering the largest possible gas gap
    dr = 1e-4
    r = jnp.arange(const.gate_to_anode_distance, rW, -dr, dtype=jnp.float32)
    rr = jnp.clip(1 / r, 1 / rA, 1 / rW)

    # Per-instruction integration, masked below each instruction's gas gap
    mask = (r[None, :] <= dG[:, None])
    dt = dr / (alpha * E0[:, None] * rr[None, :])
    dy = E0[:, None] * rr[None, :] / uE - 0.8 * pressure  # arXiv:physics/0702142
    dt_m = jnp.where(mask, dt, 0.0)
    dy_m = jnp.where(mask, dy, 0.0)
    t_cum = jnp.cumsum(dt_m, axis=1)
    y_cum = jnp.cumsum(dy_m, axis=1)
    avgt = jnp.sum(t_cum * dy_m, axis=1) / jnp.maximum(jnp.sum(dy_m, axis=1), 1e-30)
    t_cum = t_cum - avgt[:, None]
    y_last = y_cum[:, -1]

    # Resample each instruction's inverse CDF onto a uniform quantile grid
    # once (I x Q lerp queries on the fine ~5k-point tables), then photons
    # sample with two gathers + lerp instead of a log2(5k)-round binary
    # search each — ~2.5x fewer random HBM gathers at bench shapes.
    Q = 1024
    n_i = xy.shape[0]
    qs = jnp.linspace(0.0, 1.0, Q, dtype=jnp.float32)
    rq = jnp.repeat(jnp.arange(n_i, dtype=jnp.int32), Q)
    uq = (qs[None, :] * y_last[:, None]).reshape(-1)
    inv = _interp_rows(y_cum, t_cum, rq, uq).reshape(n_i, Q)

    u = jax.random.uniform(key, ph_inst.shape) * (Q - 1)
    i0 = jnp.floor(u).astype(jnp.int32)
    w = u - i0
    # i0 <= Q-2 (u < Q-1), so the (i0, i0+1) pair rides ONE row-indexed
    # 2-wide block gather of a pre-paired table — one gather pass instead
    # of two (and never vmap-of-dynamic_slice, which lowers ~800x slower
    # on this backend)
    pairs = jnp.stack([inv[:, :-1], inv[:, 1:]], axis=-1)     # (I, Q-1, 2)
    pair = pairs.reshape(-1, 2)[ph_inst.astype(jnp.int32) * (Q - 1) + i0]
    t_ph = pair[:, 0] * (1 - w) + pair[:, 1] * w
    return trunc_int(jnp.where(ph_valid, t_ph, 0.0))


def luminescence_garfield(params, const, key, xy, ph_inst, ph_valid):
    """Garfield wire-distance timing table (reference: s2.py:380-409).
    ``key`` may be a pre-split pair (models/common.py _key2)."""
    from .common import _key2
    k1, k2 = _key2(key)
    if const.s2_garfield_confine_position > 0:
        d = jax.random.uniform(k1, (xy.shape[0],),
                               minval=-const.s2_garfield_confine_position,
                               maxval=const.s2_garfield_confine_position)
    else:
        tilt = const.anode_xaxis_angle
        pitch = const.anode_pitch
        rot_y = xy[:, 0] * jnp.sin(tilt) + xy[:, 1] * jnp.cos(tilt)
        d = (rot_y + pitch / 2) % pitch - pitch / 2
    index_row = jnp.argmin(jnp.abs(d[:, None] - params.garfield_x[None, :]), axis=1)
    rows = index_row[ph_inst]
    cols = jax.random.randint(k2, ph_inst.shape, 0, params.garfield_t.shape[1])
    avgt = jnp.mean(params.garfield_t).astype(jnp.int32)
    return params.garfield_t[rows, cols].astype(jnp.int32) - avgt


def luminescence_garfield_gasgap(params, const, key, xy, ph_inst, ph_valid,
                                 n_truth_rows_hint: int):
    """Gas-gap-interpolated inverse-CDF timing (reference: s2.py:411-483),
    including the per-instruction mean subtraction that preserves the
    drift-time/z correlation."""
    gg = params.garfield_gas_gap_map(xy)
    if gg.ndim > 1:
        gg = gg[..., 0]
    gaps = params.gg_gas_gap
    d_gasgap = gaps[1] - gaps[0]
    ind = jnp.clip(jnp.searchsorted(gaps, gg, side='right') - 1, 0, gaps.shape[0] - 1)
    upper = jnp.clip(ind + 1, 0, gaps.shape[0] - 1)
    frac = (gg - gaps[ind]) / d_gasgap

    inv_len = params.gg_inv_cdf.shape[1]
    # don't sample the last odd tail bin (reference: s2.py:446-447)
    samples = jax.random.uniform(key, ph_inst.shape) * (inv_len - 2)
    i0 = jnp.floor(samples).astype(jnp.int32)
    i1 = jnp.ceil(samples).astype(jnp.int32)
    w = samples - i0
    rows_lo = ind[ph_inst]
    rows_hi = upper[ph_inst]
    f = frac[ph_inst]

    def grab(i):
        lo = params.gg_inv_cdf[rows_lo, i]
        hi = params.gg_inv_cdf[rows_hi, i]
        return (hi - lo) * f + lo

    t1 = grab(i0)
    t2 = grab(i1)
    T = (t2 - t1) * w + t1
    # per-instruction mean subtraction
    n_inst = xy.shape[0]
    vald = ph_valid.astype(jnp.float32)
    cnt, s = ordered_segment_sum(
        jnp.stack([vald, jnp.where(ph_valid, T, 0.0)], axis=1), ph_inst,
        n_inst).T
    mean = s / jnp.maximum(cnt, 1.0)
    return (T - mean[ph_inst])


# ---------------------------------------------------------------------------
# Channels


def s2_pattern_map_diffuse(params, const, key, n_electron_like, z, xy,
                           e_inst, e_valid):
    """Per-interaction pattern averaged over transverse-diffused electron
    positions (reference: s2.py:559-613).

    Each (padded) electron gets a radial/azimuthal Gaussian displacement
    scaled by sqrt(drift time); patterns are looked up per electron and
    averaged per instruction.  ``key`` may be a pre-split pair.
    """
    from .common import _key2
    k1, k2 = _key2(key)
    v = get_avg_drift_velocity(params, const, z, xy)
    if const.en_diff_trans and params.diffusion_radial_map is not None:
        d_rad = rz_lookup(params.diffusion_radial_map, z, xy) * 1e-9
        d_azi = rz_lookup(params.diffusion_azimuthal_map, z, xy) * 1e-9
        if d_rad.ndim > 1:
            d_rad, d_azi = d_rad[..., 0], d_azi[..., 0]
    else:
        d_rad = d_azi = jnp.full_like(z, const.diffusion_constant_transverse)
    drift_time_mean = -z / v
    std_r = jnp.sqrt(2 * d_rad * jnp.maximum(drift_time_mean, 0.0))
    std_a = jnp.sqrt(2 * d_azi * jnp.maximum(drift_time_mean, 0.0))

    E = e_inst.shape[0]
    hr = jax.random.normal(k1, (E,)) * std_r[e_inst]
    ha = jax.random.normal(k2, (E,)) * std_a[e_inst]
    theta = jnp.arctan2(xy[:, 1], xy[:, 0])[e_inst]
    dx = hr * jnp.cos(theta) - ha * jnp.sin(theta)
    dy = hr * jnp.sin(theta) + ha * jnp.cos(theta)
    xy_e = xy[e_inst] + jnp.stack([dx, dy], axis=1)
    inside = (jnp.sum(xy_e ** 2, axis=1) <= const.tpc_radius ** 2) & e_valid

    pat_e = params.s2_pattern(xy_e)                      # (E, C)
    if pat_e.ndim == 1:
        pat_e = pat_e[:, None] * jnp.ones((1, params.gains.shape[0]))
    w = inside.astype(pat_e.dtype)
    n_inst = xy.shape[0]
    num = ordered_segment_sum(pat_e * w[:, None], e_inst, n_inst)
    den = ordered_segment_sum(w, e_inst, n_inst)
    return num / jnp.maximum(den, 1.0)[:, None]


def s2_photon_channels(params, const, key, xy_obs, ph_inst, ph_valid,
                       pattern_override=None):
    """Channel assignment from the S2 pattern map with optional skew-normal
    AFT smearing (reference: s2.py:615-682).  ``key`` may be a pre-split
    (>=3,) key array: [k_ch, k_aft1, k_aft2]."""
    if getattr(key, 'ndim', 0) >= 1 and key.shape[0] >= 3:
        k_ch, k_aft = key[0], (key[1], key[2])
    else:
        k_aft, k_ch = jax.random.split(key)
    if pattern_override is not None:
        pattern = pattern_override
    else:
        pattern = params.s2_pattern(xy_obs)
    if pattern.ndim == 1:
        pattern = pattern[:, None] * jnp.ones((1, params.gains.shape[0]))
    pattern = pattern * params.live_mask[None, :].astype(pattern.dtype)

    if const.s2_aft_sigma != 0:
        top = params.top_mask[None, :].astype(pattern.dtype)
        sum_all = jnp.sum(pattern, axis=1)
        sum_top = jnp.sum(pattern * top, axis=1)
        cur_aft = sum_top / jnp.maximum(sum_all, 1e-30)
        new_aft = cur_aft * skew_normal(k_aft, 1.0, const.s2_aft_sigma,
                                        const.s2_aft_skewness, cur_aft.shape)
        new_aft = jnp.clip(new_aft, 0.0, 1.0)
        scale_top = new_aft / jnp.maximum(cur_aft, 1e-30)
        scale_bot = (1 - new_aft) / jnp.maximum(1 - cur_aft, 1e-30)
        pattern = pattern * jnp.where(top > 0, scale_top[:, None], scale_bot[:, None])

    cdf = jnp.cumsum(pattern, axis=1)
    u = jax.random.uniform(k_ch, ph_inst.shape)
    return categorical_from_cdf(cdf, ph_inst, u)


# ---------------------------------------------------------------------------
# Full chain


def _s2_electron_stage(params, const, inst, keys, *, e_capacity: int):
    """FDC + yields + per-electron arrivals + per-electron photon counts —
    everything that determines the photon demand, split out so a cheap
    demand pre-pass (:func:`s2_photon_demand`) can size the photon axis
    exactly before the full kernel runs.  Draw-for-draw identical between
    the pre-pass and the full chain: both split the same key the same way.

    ``keys`` is the one wide top-level split (N_S2_KEYS slots): the whole
    chain splits exactly once and threads key slices down (slots 0-4 here;
    see simulate_s2 for the full layout).
    """
    x, y, z = inst['x'], inst['y'], inst['z']

    # Field distortion (reference: s2.py:81-88)
    if const.field_distortion_model == 'inverse_fdc' and params.fdc_3d is not None:
        z_obs, positions = inverse_field_distortion_correction(params, x, y, z)
    elif const.field_distortion_model == 'comsol' and params.fd_comsol is not None:
        z_obs, positions = field_distortion_comsol(params, x, y, z)
    else:
        z_obs, positions = z, jnp.stack([x, y], axis=1)
    xy_int = jnp.stack([x, y], axis=1)

    n_electron = get_electron_yield(params, const, keys[0],
                                    jnp.where(inst['valid'], inst['amp'], 0),
                                    xy_int, z, positions)
    sc_gain = get_s2_light_yield(params, const, positions)

    # Electron arrival times (reference: s2.py:258-315)
    drift_time_mean, drift_time_spread = get_s2_drift_time_params(
        params, const, z, xy_int)
    e_inst, e_valid, total_e = segment_ids_from_counts(n_electron, e_capacity)
    timing = (jax.random.exponential(keys[1], (e_capacity,))
              * const.electron_trapping_time)
    timing = timing + (jax.random.normal(keys[2], (e_capacity,))
                       * drift_time_spread[e_inst] + drift_time_mean[e_inst])
    e_t = inst['time'][e_inst].astype(jnp.int32) + trunc_int(timing)

    n_ph_per_e = poisson(keys[3], sc_gain[e_inst])
    if const.s2_gain_spread > 0:
        n_ph_per_e = n_ph_per_e + trunc_int(
            jax.random.normal(keys[4], (e_capacity,)) * const.s2_gain_spread)
    n_ph_per_e = jnp.where(e_valid, jnp.maximum(n_ph_per_e, 0), 0)
    return dict(z_obs=z_obs, positions=positions, xy_int=xy_int,
                n_electron=n_electron, sc_gain=sc_gain, e_inst=e_inst,
                e_valid=e_valid, total_e=total_e, e_t=e_t,
                n_ph_per_e=n_ph_per_e)


def s2_photon_demand(params, const, inst, key, *, e_capacity: int):
    """Exact total photon demand of a batch (int32 scalar) — the electron
    stage only, ~e_capacity work instead of photon-capacity work.  Lets the
    host size the photon axis exactly (the worst-case gain bound oversized
    it ~4-5x at bench shapes)."""
    keys = jax.random.split(key, N_S2_KEYS)
    st = _s2_electron_stage(params, const, inst, keys, e_capacity=e_capacity)
    return jnp.sum(jnp.where(st['e_valid'], st['n_ph_per_e'],
                             0)).astype(jnp.int32)


def simulate_s2(params, const, inst, key, *, e_capacity: int, capacity: int,
                n_truth_rows: int):
    """Simulate a padded batch of S2-like instructions (types 2, 4, 6 all use
    this chain, as in the reference where pi_el/pe_el subclass S2).

    :param inst: dict with (I,) arrays: time (i32 rel), x, y, z, amp (=
        electrons), recoil, valid, truth_row
    :returns: (photons, truth, totals dict)

    Key layout (ONE device split, see models/common.py _key2):
    0-4 electron stage / 5 channel draw / 6-7 AFT skew / 8-9 diffuse
    pattern / 10-11 luminescence / 12-13 singlet-triplet / 14 time model /
    15-18 PMT response.
    """
    keys = jax.random.split(key, N_S2_KEYS)
    st = _s2_electron_stage(params, const, inst, keys, e_capacity=e_capacity)
    z_obs, positions, xy_int = st['z_obs'], st['positions'], st['xy_int']
    n_electron, sc_gain = st['n_electron'], st['sc_gain']
    e_inst, e_valid, total_e = st['e_inst'], st['e_valid'], st['total_e']
    e_t, n_ph_per_e = st['e_t'], st['n_ph_per_e']

    ph_e, ph_valid, total_ph = segment_ids_from_counts(n_ph_per_e, capacity)
    # per-electron -> per-photon broadcasts as diff-scatter + cumsum
    # (ops/segment.py expand_rows) instead of (capacity,)-index gathers: the
    # cumsum is one vector pass (unmeasured on H100, ROADMAP C2); values are
    # identical
    from ..ops.segment import edges_from_counts, expand_rows
    e_ph_edges = edges_from_counts(n_ph_per_e, capacity)           # (E+1,)
    ph_inst = expand_rows(e_inst, e_ph_edges, capacity)

    # diffusion-smeared per-electron pattern averaging
    # (reference: s2.py:637-640 gates on diffusion_constant_transverse > 0)
    pattern_override = None
    if const.diffusion_constant_transverse > 0 or const.en_diff_trans:
        pattern_override = s2_pattern_map_diffuse(
            params, const, (keys[8], keys[9]), n_electron, z_obs, positions,
            e_inst, e_valid)

    ch = s2_photon_channels(params, const, keys[5:8], positions, ph_inst,
                            ph_valid, pattern_override=pattern_override)
    ph_valid = ph_valid & (ch >= 0)

    # Photon timing: luminescence + gas excimer + optical/spread + electron
    # arrival (reference: s2.py:503-557)
    lum_model = const.s2_luminescence_model
    if lum_model == 'simple':
        t_lum = luminescence_simple(params, const, keys[10], positions,
                                    ph_inst, ph_valid)
    elif lum_model == 'garfield':
        t_lum = luminescence_garfield(params, const, (keys[10], keys[11]),
                                      positions, ph_inst, ph_valid)
    elif lum_model == 'garfield_gas_gap':
        t_lum = trunc_int(luminescence_garfield_gasgap(
            params, const, keys[10], positions, ph_inst, ph_valid,
            n_truth_rows))
    else:
        raise KeyError(f'{lum_model} is not a valid s2_luminescence_model')

    t = t_lum.astype(jnp.int32)
    t = t + singlet_triplet_delays((keys[12], keys[13]), (capacity,),
                                   const.singlet_fraction_gas,
                                   const.singlet_lifetime_gas,
                                   const.triplet_lifetime_gas)
    if 'optical_propagation' in const.s2_time_model and params.s2_prop_top is not None:
        ur = jax.random.uniform(keys[14], (capacity,))[:, None]
        prop_t = params.s2_prop_top(ur)
        prop_b = params.s2_prop_bottom(ur)
        is_top = ch < const.n_top_pmts
        t = t + trunc_int(jnp.where(is_top, prop_t, prop_b))
    elif 'zero_delay' in const.s2_time_model:
        pass
    elif 's2_time_spread around zero' in const.s2_time_model:
        t = t + trunc_int(jax.random.normal(keys[14], (capacity,))
                          * const.s2_time_spread)
    else:
        raise KeyError(f'{const.s2_time_model} is not a valid s2_time_model')

    t = t + expand_rows(e_t, e_ph_edges, capacity)

    # per-instruction and per-truth-row photon boundaries, derived from the
    # count cumsums (no large searchsorted/scatter, see ops/segment.py;
    # unmeasured on H100 (ROADMAP C2))
    e_off = edges_from_counts(n_electron, e_capacity)              # (I+1,)
    tot_ph = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(jnp.where(e_valid, n_ph_per_e, 0))])
    inst_ph_off = jnp.clip(tot_ph[e_off], 0, capacity)             # (I+1,)
    # jnp.searchsorted lowers to a vmapped while-loop; the hierarchical
    # block search is the exact alternative (unmeasured on H100, ROADMAP C2).
    # A sentinel column keeps the one-past-the-end result searchsorted can
    # return (the search clamps to its table width).
    from ..ops.randsample import search_sorted_rows
    tr_ext = jnp.concatenate([inst['truth_row'].astype(jnp.int32),
                              jnp.full(1, 2 ** 30, jnp.int32)])
    row_first_inst = search_sorted_rows(
        tr_ext[None, :], jnp.zeros(n_truth_rows + 1, jnp.int32),
        jnp.arange(n_truth_rows + 1, dtype=jnp.int32), side='left')
    row_edges = inst_ph_off[jnp.clip(row_first_inst, 0,
                                     inst['x'].shape[0])]

    truth_row = expand_rows(inst['truth_row'], inst_ph_off, capacity)
    photons, truth = pmt_response(params, const, t, ch, ph_valid, truth_row,
                                  keys[15:19], n_truth_rows=n_truth_rows,
                                  row_edges=row_edges)
    stats = photon_time_stats(photons['t'], photons['valid'],
                              photons['truth_row'], n_truth_rows,
                              row_edges=row_edges)
    truth.update({'photon_' + k: v for k, v in stats.items()})
    row_e_edges = e_off[jnp.clip(row_first_inst, 0, inst['x'].shape[0])]
    e_stats = photon_time_stats(e_t, e_valid,
                                expand_rows(inst['truth_row'], e_off,
                                            e_capacity),
                                n_truth_rows, row_edges=row_e_edges)
    truth.update({'electron_' + k: v for k, v in e_stats.items()})
    truth['n_electron'] = jnp.zeros(n_truth_rows, jnp.int32).at[
        jnp.where(inst['valid'], inst['truth_row'], 0)].add(
        jnp.where(inst['valid'], n_electron, 0))
    # Field-distorted mean electron position per truth row
    # (reference: rawdata.py:377-390)
    if const.field_distortion_model in ('inverse_fdc', 'comsol'):
        row = jnp.where(inst['valid'], inst['truth_row'], 0)
        v1 = inst['valid'].astype(jnp.float32)
        sums = ordered_segment_sum(
            jnp.concatenate([v1[:, None], jnp.where(
                inst['valid'][:, None], positions[:, :2], 0.0)], axis=1),
            row, n_truth_rows)
        cnt = jnp.maximum(sums[:, 0], 1.0)
        truth['x_mean_electron'] = sums[:, 1] / cnt
        truth['y_mean_electron'] = sums[:, 2] / cnt
    # per-instruction photon demand: photon-count cumsum differenced at the
    # electron boundaries of each instruction (the scatter-add form was the
    # single hottest op of the whole sim chain, 1.8 s/call at 2^18
    # electrons; a searchsorted over the electron axis lowered to a 1.4 s
    # loop fusion — both gone)
    req_counts = tot_ph[e_off[1:]] - tot_ph[e_off[:-1]]
    totals = dict(electrons=total_e, photons=total_ph, req_counts=req_counts)
    return photons, truth, totals
