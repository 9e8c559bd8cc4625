"""S1 scintillation model: detected-photon counts, channels and timings.

Vectorized, fixed-capacity equivalent of the reference S1 chain
(reference: wfsim/core/s1.py:60-238).  All instructions of a batch are
simulated at once; the per-event ``np.random.choice`` channel loops become a
batched inverse-CDF categorical; the per-recoil timing models are evaluated
branchlessly and selected by recoil class.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.randsample import categorical_from_cdf, binomial
from ..ops.segment import segment_ids_from_counts
from .common import singlet_triplet_delays, trunc_int
from .pmt import pmt_response, photon_time_stats

__all__ = ['simulate_s1', 'NestId']

#: top-level key-split width of the S1 chain (one device split per kernel)
N_S1_KEYS = 21


class NestId:
    """NEST interaction-type ids per recoil class (reference: s1.py:21-30)."""
    NR = (0,)
    ALPHA = (6,)
    ER = (7, 8, 11, 12)
    LED = (20,)


def _recoil_class(recoil):
    """0=ER, 1=NR, 2=alpha, 3=LED (default ER like the reference's lookup)."""
    cls = jnp.zeros_like(recoil)
    for v in NestId.NR:
        cls = jnp.where(recoil == v, 1, cls)
    for v in NestId.ALPHA:
        cls = jnp.where(recoil == v, 2, cls)
    for v in NestId.LED:
        cls = jnp.where(recoil == v, 3, cls)
    return cls


def s1_n_photon_hits(params, const, positions, amp, valid, key):
    """Detected photons: Binomial(amp, LCE/(1+p_dpe) * efficiency)
    (reference: s1.py:116-135)."""
    ly = params.s1_lce(positions)
    if ly.ndim > 1:
        ly = ly[..., 0]
    ly = ly / (1 + const.p_double_pe_emision) * const.s1_detection_efficiency
    n = binomial(key, amp, ly)
    return jnp.where(valid, n, 0)


def _custom_recoil_delays(const, keys, recoil_cls, n):
    """Per-recoil-class excimer/recombination timing models
    (reference: s1.py:262-337), all classes computed and selected.
    ``keys``: a (>=8,) pre-split key array (the chain splits once at its
    top)."""
    if getattr(keys, 'ndim', 0) == 0:
        keys = jax.random.split(keys, 11)
    shape = (n,)
    # ER (reference: s1.py:281-327)
    excfrac = const.er_primary_excimer_fraction
    reco_time = const.er_recombination_time
    primary = jax.random.uniform(keys[0], shape) < excfrac
    st_prim = singlet_triplet_delays(
        (keys[1], keys[2]), shape, const.s1_ER_primary_singlet_fraction,
        const.singlet_lifetime_liquid, const.triplet_lifetime_liquid)
    u = jax.random.uniform(keys[3], shape, minval=1e-12, maxval=1.0)
    reco = reco_time * (-1.0 + 1.0 / u)
    reco = jnp.clip(reco, 0.0, 1000.0)   # reference pins max reco time to 1000
    st_sec = singlet_triplet_delays(
        (keys[4], keys[5]), shape, const.s1_ER_secondary_singlet_fraction,
        const.singlet_lifetime_liquid, const.triplet_lifetime_liquid)
    er = jnp.where(primary, st_prim.astype(jnp.float32),
                   reco + st_sec.astype(jnp.float32))
    # NR (reference: s1.py:329-337)
    nr = singlet_triplet_delays(
        (keys[6], keys[7]), shape, const.s1_NR_singlet_fraction,
        const.singlet_lifetime_liquid, const.triplet_lifetime_liquid
    ).astype(jnp.float32)
    # alpha (reference: s1.py:262-270)
    alpha = singlet_triplet_delays(
        (keys[8], keys[9]), shape, const.s1_ER_alpha_singlet_fraction,
        const.singlet_lifetime_liquid, const.triplet_lifetime_liquid
    ).astype(jnp.float32)
    # LED (reference: s1.py:272-279)
    led = jax.random.uniform(keys[10], shape) * const.led_pulse_length

    out = er
    out = jnp.where(recoil_cls == 1, nr, out)
    out = jnp.where(recoil_cls == 2, alpha, out)
    out = jnp.where(recoil_cls == 3, led, out)
    return out


def _grid_pos(axis, x):
    """Fractional position of x on a 1-d grid: (i0, i1, w)."""
    n = axis.shape[0]
    i1 = jnp.clip(jnp.searchsorted(axis, x), 1, n - 1)
    i0 = i1 - 1
    w = (x - axis[i0]) / jnp.maximum(axis[i1] - axis[i0], 1e-30)
    return i0, i1, jnp.clip(w, 0.0, 1.0)


def _nest_table_delays(params, key, recoil_cls, field, energy, n):
    """Sample scintillation delays from the (class, field, energy) quantile
    table by bilinear interpolation in (field, energy) and linear inverse-CDF
    sampling in the quantile axis."""
    tbl = params.nest_inv_cdf
    M = tbl.shape[-1]
    fi0, fi1, fw = _grid_pos(params.nest_fields, field)
    ei0, ei1, ew = _grid_pos(params.nest_energies, energy)
    u = jax.random.uniform(key, (n,)) * (M - 1)
    k0 = jnp.floor(u).astype(jnp.int32)
    k1 = jnp.minimum(k0 + 1, M - 1)
    kw = u - k0

    def gather(fi, ei, k):
        return tbl[recoil_cls, fi, ei, k]

    out = 0.0
    for fi, fwgt in ((fi0, 1 - fw), (fi1, fw)):
        for ei, ewgt in ((ei0, 1 - ew), (ei1, ew)):
            q = gather(fi, ei, k0) * (1 - kw) + gather(fi, ei, k1) * kw
            out = out + fwgt * ewgt * q
    return out


def s1_photon_demand(params, const, inst, key):
    """Exact total detected-photon demand of a batch (int32 scalar): the
    binomial yield draw only, (I,)-sized work.  Same key split as
    :func:`simulate_s1`, so the full kernel reproduces the same counts."""
    keys = jax.random.split(key, N_S1_KEYS)
    positions = jnp.stack([inst['x'], inst['y'], inst['z']], axis=1)
    n_hits = s1_n_photon_hits(params, const, positions, inst['amp'],
                              inst['valid'], keys[0])
    return jnp.sum(n_hits).astype(jnp.int32)


def simulate_s1(params, const, inst, key, *, capacity: int, n_truth_rows: int):
    """Simulate a padded batch of S1 instructions into a photon batch.

    :param inst: dict with (I,)-arrays: time (i32, window-relative ns), x, y,
        z (f32), amp (i32), recoil (i32), valid (bool), truth_row (i32)
    :param capacity: photon slot capacity (static)
    :returns: (photons, truth, total_photons) — photons as in pmt_response,
        truth with counter + timing-stat arrays per truth row.

    Key layout (ONE device split, see models/common.py _key2): 0 yield /
    1 channel / 2 optical / 3 decay / 4 spread / 5-15 custom recoil /
    16 nest / 17-20 PMT response.
    """
    keys = jax.random.split(key, N_S1_KEYS)
    positions = jnp.stack([inst['x'], inst['y'], inst['z']], axis=1)
    n_hits = s1_n_photon_hits(params, const, positions, inst['amp'],
                              inst['valid'], keys[0])

    # Channel assignment from the pattern map (reference: s1.py:137-159)
    pattern = params.s1_pattern(positions)
    if pattern.ndim == 1:
        pattern = pattern[:, None] * jnp.ones((1, params.gains.shape[0]))
    pattern = pattern * params.live_mask[None, :].astype(pattern.dtype)
    cdf = jnp.cumsum(pattern, axis=1)

    ph_inst, ph_valid, total = segment_ids_from_counts(n_hits, capacity)
    u = jax.random.uniform(keys[1], (capacity,))
    ch = categorical_from_cdf(cdf, ph_inst, u)
    ph_valid = ph_valid & (ch >= 0)

    # Timings (reference: s1.py:161-238)
    t = inst['time'][ph_inst].astype(jnp.int32)
    model = const.s1_model_type
    if 'optical_propagation' in model and params.s1_prop_top is not None:
        zs = inst['z'][ph_inst]
        ur = jax.random.uniform(keys[2], (capacity,))
        pts = jnp.stack([zs, ur], axis=1)
        prop_t = params.s1_prop_top(pts)
        prop_b = params.s1_prop_bottom(pts)
        is_top = ch < const.n_top_pmts
        t = t + trunc_int(jnp.where(is_top, prop_t, prop_b))
    if 'simple' in model:
        t = t + trunc_int(jax.random.exponential(keys[3], (capacity,))
                          * const.s1_decay_time)
        t = t + trunc_int(jax.random.normal(keys[4], (capacity,))
                          * const.s1_decay_spread)
    if 'custom' in model:
        rc = _recoil_class(inst['recoil'])[ph_inst]
        t = t + trunc_int(_custom_recoil_delays(const, keys[5:16], rc,
                                                capacity))
    if 'nest' in model and params.nest_inv_cdf is not None:
        # tabulated NEST photon-time CDFs sampled on device (the reference
        # loops nestpy.GetPhotonTimes per instruction, s1.py:217-234)
        rc = _recoil_class(inst['recoil'])[ph_inst]
        fld = inst.get('local_field', jnp.full(inst['x'].shape,
                                               const.drift_field))[ph_inst]
        edep = inst.get('e_dep', jnp.full(inst['x'].shape, 10.0))[ph_inst]
        t = t + trunc_int(_nest_table_delays(params, keys[16], rc, fld, edep,
                                             capacity))

    # per-truth-row photon boundaries from the count cumsum (no large
    # searchsorted/scatter on device — see ops/segment.py)
    from ..ops.segment import edges_from_counts
    inst_ph_off = edges_from_counts(n_hits, capacity)              # (I+1,)
    # hierarchical block search with a sentinel column (jnp.searchsorted
    # lowers to a vmapped while-loop; unmeasured on H100 (ROADMAP C2))
    from ..ops.randsample import search_sorted_rows
    tr_ext = jnp.concatenate([inst['truth_row'].astype(jnp.int32),
                              jnp.full(1, 2 ** 30, jnp.int32)])
    row_first_inst = search_sorted_rows(
        tr_ext[None, :], jnp.zeros(n_truth_rows + 1, jnp.int32),
        jnp.arange(n_truth_rows + 1, dtype=jnp.int32), side='left')
    row_edges = inst_ph_off[jnp.clip(row_first_inst, 0,
                                     inst['x'].shape[0])]

    truth_row = inst['truth_row'][ph_inst]
    photons, truth = pmt_response(params, const, t, ch, ph_valid, truth_row,
                                  keys[17:21], n_truth_rows=n_truth_rows,
                                  row_edges=row_edges)
    stats = photon_time_stats(photons['t'], photons['valid'],
                              photons['truth_row'], n_truth_rows,
                              row_edges=row_edges)
    truth.update({'photon_' + k: v for k, v in stats.items()})
    truth['n_electron'] = jnp.zeros(n_truth_rows, jnp.int32)
    totals = dict(photons=total, req_counts=n_hits)
    return photons, truth, totals
