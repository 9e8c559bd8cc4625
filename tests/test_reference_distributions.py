"""Statistical parity of the device samplers vs numpy oracles of the
reference's sampling semantics.

Each oracle is an independent numpy implementation of the reference's
documented sampling procedure at fixed parameters:

- S1 recoil timing models  (reference: wfsim/core/s1.py:262-337)
- S1 'simple' timing        (reference: wfsim/core/s1.py:191-194)
- S2 electron timings       (reference: wfsim/core/s2.py:258-286)
- luminescence 'simple'     (reference: wfsim/core/s2.py:317-378)
- luminescence 'garfield'   (reference: wfsim/core/s2.py:380-409)
- luminescence 'garfield_gas_gap' (reference: wfsim/core/s2.py:411-483)

Agreement is asserted with two-sample Kolmogorov-Smirnov tests at p > 0.01
(fixed seeds; the KS statistic on these sample sizes resolves percent-level
shape errors such as a dropped spread term or a mis-scaled lifetime).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.stats import ks_2samp

from wfsim_tpu import units
from wfsim_tpu.config import default_config
from wfsim_tpu.resources.loader import load_config
from wfsim_tpu.models.params import build_params, build_constants

N = 40_000
P_MIN = 0.01


def setup_models(**overrides):
    c = default_config(**overrides)
    res = load_config(c)
    params = build_params(c, res)
    const = build_constants(c)
    return c, res, params, const


def ks_ok(a, b):
    res = ks_2samp(np.asarray(a, float), np.asarray(b, float))
    assert res.pvalue > P_MIN, \
        f'KS stat={res.statistic:.4f} p={res.pvalue:.2e} ' \
        f'(means {np.mean(a):.2f} vs {np.mean(b):.2f}, ' \
        f'stds {np.std(a):.2f} vs {np.std(b):.2f})'


def np_singlet_triplet(rng, n, frac, t1, t3):
    """Oracle of Pulse.singlet_triplet_delays (reference pulse.py:320-341)."""
    delay = np.where(rng.random(n) < frac, t1, t3)
    return (rng.exponential(1.0, n) * delay).astype(np.int64)


# ---------------------------------------------------------------------------
# S1 recoil models ('custom' timing)


def _custom_delays(recoil_cls, key=7):
    from wfsim_tpu.models.s1 import _custom_recoil_delays
    c, res, params, const = setup_models(s1_model_type='custom')
    cls = jnp.full(N, recoil_cls, jnp.int32)
    t = _custom_recoil_delays(const, jax.random.key(key), cls, N)
    return c, const, np.trunc(np.asarray(t))


def test_ks_s1_er():
    """ER: primary-excimer fraction + Kubota recombination tail
    (oracle of reference s1.py:281-327)."""
    c, const, ours = _custom_delays(0)
    # independent re-derivation of the inferred constants
    density = 1.872452802978054e+30 / (units.g / units.cm ** 3)
    excfrac = 0.4 - 0.11131 * density - 0.0026651 * density ** 2
    excfrac = 1 / (1 + excfrac)
    excfrac /= 1 - (1 - excfrac) * (1 - c['s1_ER_recombination_fraction'])
    efield = c['drift_field'] / (units.V / units.cm)
    reco_time = 3.5 / 0.18 * (1 / 20 + 0.41) * np.exp(-0.009 * efield)
    assert abs(const.er_primary_excimer_fraction - excfrac) < 1e-9
    assert abs(const.er_recombination_time - reco_time) < 1e-6

    rng = np.random.default_rng(11)
    primary = rng.random(N) < excfrac
    t = np.where(primary, 0.0, reco_time)
    n_sec = int((~primary).sum())
    t[primary] += np_singlet_triplet(
        rng, int(primary.sum()), c['s1_ER_primary_singlet_fraction'],
        c['singlet_lifetime_liquid'], c['triplet_lifetime_liquid'])
    # Kubota 1979 non-exponential recombination (reference s1.py:320-322)
    t[~primary] *= 1 / (-1 + 1 / rng.random(n_sec))
    t[~primary] = np.clip(t[~primary], 0, 1000)
    t[~primary] += np_singlet_triplet(
        rng, n_sec, c['s1_ER_secondary_singlet_fraction'],
        c['singlet_lifetime_liquid'], c['triplet_lifetime_liquid'])
    ks_ok(ours, np.trunc(t))


def test_ks_s1_nr():
    c, const, ours = _custom_delays(1)
    rng = np.random.default_rng(12)
    oracle = np_singlet_triplet(rng, N, c['s1_NR_singlet_fraction'],
                                c['singlet_lifetime_liquid'],
                                c['triplet_lifetime_liquid'])
    ks_ok(ours, oracle)


def test_ks_s1_alpha():
    c, const, ours = _custom_delays(2)
    rng = np.random.default_rng(13)
    oracle = np_singlet_triplet(rng, N, c['s1_ER_alpha_singlet_fraction'],
                                c['singlet_lifetime_liquid'],
                                c['triplet_lifetime_liquid'])
    ks_ok(ours, oracle)


def test_ks_s1_led():
    c, const, ours = _custom_delays(3)
    rng = np.random.default_rng(14)
    ks_ok(ours, np.trunc(rng.uniform(0, c['led_pulse_length'], N)))


def test_ks_s1_simple_full_chain():
    """'simple' S1 timing through the full simulate_s1 path: TTS + exp decay
    + Gaussian spread (reference s1.py:191-194 + pulse.py:52-56)."""
    from wfsim_tpu.models.s1 import simulate_s1
    c, res, params, const = setup_models(s1_model_type='simple')
    n_inst = 8
    inst = dict(
        time=jnp.zeros(n_inst, jnp.int32),
        x=jnp.full(n_inst, 10.0, jnp.float32),
        y=jnp.full(n_inst, -5.0, jnp.float32),
        z=jnp.full(n_inst, -50.0, jnp.float32),
        amp=jnp.full(n_inst, 20000, jnp.int32),
        recoil=jnp.full(n_inst, 7, jnp.int32),
        valid=jnp.ones(n_inst, bool),
        truth_row=jnp.arange(n_inst, dtype=jnp.int32),
    )
    ph, _, _ = jax.jit(simulate_s1, static_argnames=('const', 'capacity',
                                                     'n_truth_rows'))(
        params, const, inst, jax.random.key(21), capacity=2 ** 17,
        n_truth_rows=n_inst)
    ours = np.asarray(ph['t'])[np.asarray(ph['valid'])]

    rng = np.random.default_rng(15)
    n = len(ours)
    t = np.trunc(rng.exponential(c['s1_decay_time'], n))
    t += np.trunc(rng.normal(0, c['s1_decay_spread'], n))
    t += np.trunc(rng.normal(c['pmt_transit_time_mean'],
                             c['pmt_transit_time_spread'] / 2.35482, n))
    ks_ok(ours, t)


# ---------------------------------------------------------------------------
# S2 electron timings (isolated by zeroing every later timing term)


def test_ks_s2_electron_timings():
    """Electron arrival = exp(trapping) + N(drift mean, diffusion spread)
    (oracle of reference s2.py:258-286).  Isolated by a zero luminescence
    table and zeroed gas-excimer / S2-spread / TTS terms, so the photon times
    equal their parent electron's arrival time exactly."""
    from wfsim_tpu.models.s2 import simulate_s2, get_s2_drift_time_params
    zero_table = {'t': np.zeros((11, 64), np.float32),
                  'x': np.linspace(-0.25, 0.25, 11).astype(np.float32)}
    # s2_secondary_sc_gain ~1 keeps photons ~= electrons: every KS sample is
    # then (nearly) an independent electron draw rather than ~17 photons
    # inheriting one electron time, which would inflate the KS statistic
    c, res, params, const = setup_models(
        s2_luminescence_model='garfield', s2_luminescence=zero_table,
        singlet_lifetime_gas=0.0, triplet_lifetime_gas=0.0,
        s2_time_spread=0.0, pmt_transit_time_mean=0.0,
        pmt_transit_time_spread=0.0, s2_secondary_sc_gain=1.2)
    z = -60.0
    n_inst = 8
    inst = dict(
        time=jnp.zeros(n_inst, jnp.int32),
        x=jnp.full(n_inst, 10.0, jnp.float32),
        y=jnp.full(n_inst, -5.0, jnp.float32),
        z=jnp.full(n_inst, z, jnp.float32),
        amp=jnp.full(n_inst, 8000, jnp.int32),
        recoil=jnp.full(n_inst, 7, jnp.int32),
        valid=jnp.ones(n_inst, bool),
        truth_row=jnp.arange(n_inst, dtype=jnp.int32),
    )
    ph, _, _ = jax.jit(simulate_s2, static_argnames=('const', 'e_capacity',
                                                     'capacity',
                                                     'n_truth_rows'))(
        params, const, inst, jax.random.key(22), e_capacity=2 ** 16,
        capacity=2 ** 17, n_truth_rows=n_inst)
    ours = np.asarray(ph['t'])[np.asarray(ph['valid'])]
    assert len(ours) > 10_000

    zs = jnp.full(n_inst, z, jnp.float32)
    xy = jnp.stack([inst['x'], inst['y']], axis=1)
    mean, spread = get_s2_drift_time_params(params, const, zs, xy)
    mean, spread = float(mean[0]), float(spread[0])
    rng = np.random.default_rng(16)
    oracle = np.trunc(rng.exponential(c['electron_trapping_time'], N)
                      + rng.normal(mean, spread, N))
    ks_ok(ours, oracle)


# ---------------------------------------------------------------------------
# Luminescence models


def test_ks_luminescence_simple():
    """Anode-field integration + inverse-CDF draw (oracle of reference
    s2.py:317-378) at a fixed position with warping off."""
    from wfsim_tpu.models.s2 import luminescence_simple
    c, res, params, const = setup_models(enable_gas_gap_warping=False)
    xy = jnp.zeros((1, 2), jnp.float32)
    ph_inst = jnp.zeros(N, jnp.int32)
    ours = np.asarray(luminescence_simple(
        params, const, jax.random.key(23), xy, ph_inst, jnp.ones(N, bool)))

    # oracle: numerical integration of the electron drift through the anode
    # field (reference s2.py:343-378 setup + :317-341 sampling)
    number_density_gas = c['pressure'] / (units.boltzmannConstant
                                          * c['temperature'])
    alpha = c['gas_drift_velocity_slope'] / number_density_gas
    uE = units.kV / units.cm
    pressure = c['pressure'] / units.bar
    dG = c['elr_gas_gap_length']
    rA = c['anode_field_domination_distance']
    rW = c['anode_wire_radius']
    dL = c['gate_to_anode_distance'] - dG
    VG = c['anode_voltage'] / (1 + dL / dG / c['lxe_dielectric_constant'])
    E0 = VG / ((dG - rA) / rA + np.log(rA / rW))
    dr = 1e-4
    r = np.arange(dG, rW, -dr)
    rr = np.clip(1 / r, 1 / rA, 1 / rW)
    dt = dr / (alpha * E0 * rr)
    dy = E0 * rr / uE - 0.8 * pressure
    avgt = np.sum(np.cumsum(dt) * dy) / np.sum(dy)
    t = np.cumsum(dt) - avgt
    y = np.cumsum(dy)
    rng = np.random.default_rng(17)
    oracle = np.interp(rng.random(N), y / y[-1], t).astype(np.int64)
    ks_ok(ours, oracle)


def test_ks_luminescence_garfield():
    """Wire-distance-indexed timing table draw (oracle of reference
    s2.py:380-409) on a synthetic table."""
    from wfsim_tpu.models.s2 import luminescence_garfield
    rng0 = np.random.default_rng(3)
    x_axis = np.linspace(-0.25, 0.25, 11)
    table = (rng0.exponential(300, (11, 500))
             + np.abs(x_axis)[:, None] * 1000)
    c, res, params, const = setup_models(
        s2_luminescence_model='garfield',
        s2_luminescence={'t': table.astype(np.float32),
                         'x': x_axis.astype(np.float32)})
    xy = jnp.asarray([[12.0, -7.0]], jnp.float32)
    ph_inst = jnp.zeros(N, jnp.int32)
    ours = np.asarray(luminescence_garfield(
        params, const, jax.random.key(24), xy, ph_inst, jnp.ones(N, bool)))

    tilt = c.get('anode_xaxis_angle', np.pi / 4)
    pitch = c.get('anode_pitch', 0.5)
    rot = np.array([[np.cos(tilt), -np.sin(tilt)],
                    [np.sin(tilt), np.cos(tilt)]])
    d = (np.matmul(np.asarray(xy), rot)[:, 1] + pitch / 2) % pitch - pitch / 2
    row = int(np.argmin(np.abs(d[0] - x_axis)))
    rng = np.random.default_rng(18)
    cols = rng.integers(0, table.shape[1], N)
    avgt = int(np.average(table.astype(np.float32)))
    oracle = table.astype(np.float32)[row, cols].astype(np.int64) - avgt
    ks_ok(ours, oracle)


def test_ks_luminescence_garfield_gasgap():
    """Gas-gap-interpolated inverse-CDF draw with per-instruction mean
    subtraction (oracle of reference s2.py:411-483)."""
    from wfsim_tpu.models.s2 import luminescence_garfield_gasgap
    c, res, params, const = setup_models(
        s2_luminescence_model='garfield_gas_gap')
    xy = jnp.asarray([[12.0, -7.0]], jnp.float32)
    ph_inst = jnp.zeros(N, jnp.int32)
    ours = np.asarray(luminescence_garfield_gasgap(
        params, const, jax.random.key(25), xy, ph_inst, jnp.ones(N, bool),
        n_truth_rows_hint=1))

    gaps = np.asarray(params.gg_gas_gap, float)
    inv_cdf = np.asarray(params.gg_inv_cdf, float)
    gg = float(np.asarray(params.garfield_gas_gap_map(xy)).reshape(-1)[0])
    d_gasgap = gaps[1] - gaps[0]
    ind = int(np.digitize(gg, gaps) - 1)
    upper = int(np.clip(ind + 1, 0, len(gaps) - 1))
    dngg = gg - gaps[ind]
    interp_cdf = ((inv_cdf[upper] - inv_cdf[ind]) * (dngg / d_gasgap)
                  + inv_cdf[ind])
    rng = np.random.default_rng(19)
    samples = rng.uniform(0, inv_cdf.shape[1] - 2, N)
    t1 = interp_cdf[np.floor(samples).astype(int)]
    t2 = interp_cdf[np.ceil(samples).astype(int)]
    T = (t2 - t1) * (samples - np.floor(samples)) + t1
    oracle = T - T.mean()
    ks_ok(ours, oracle)


# ---------------------------------------------------------------------------
# Gas singlet/triplet excimer delay (shared by every S2 timing model)


def test_ks_gas_excimer_delay():
    from wfsim_tpu.models.common import singlet_triplet_delays
    c, res, params, const = setup_models()
    ours = np.asarray(singlet_triplet_delays(
        jax.random.key(26), N, c['singlet_fraction_gas'],
        c['singlet_lifetime_gas'], c['triplet_lifetime_gas']))
    rng = np.random.default_rng(20)
    oracle = np_singlet_triplet(rng, N, c['singlet_fraction_gas'],
                                c['singlet_lifetime_gas'],
                                c['triplet_lifetime_gas'])
    ks_ok(ours, oracle)


def test_nest_v2_fallback_timing_ks():
    """The tabulated 'nest' S1 timing sampler must reproduce the NEST v2
    LXe photon-timing formulas it tabulates (field/LET-dependent
    singlet-triplet ratios + 1/u-1 recombination-time kernel; constants
    cited in resources/nest_tables.py): two-sample KS against a direct draw
    from the formula implementation, per recoil class, at off-grid
    (field, energy) points."""
    import jax
    import jax.numpy as jnp
    from types import SimpleNamespace
    from scipy import stats as sps
    from wfsim_tpu.resources.nest_tables import (
        build_nest_timing_tables, _nest_photon_times)
    from wfsim_tpu.models.s1 import _nest_table_delays

    cfg = {'maximum_recombination_time': 10000.0}
    tbl, flds, engs = build_nest_timing_tables(cfg, n_samples=100_000)
    params = SimpleNamespace(nest_inv_cdf=jnp.asarray(tbl),
                             nest_fields=jnp.asarray(flds),
                             nest_energies=jnp.asarray(engs))
    n = 60_000
    rng = np.random.default_rng(123)
    for cls, field, energy in ((0, 81.0, 9.3), (1, 81.0, 33.0),
                               (2, 120.0, 150.0)):
        t_tbl = np.asarray(_nest_table_delays(
            params, jax.random.key(cls), jnp.full(n, cls, jnp.int32),
            jnp.full(n, field, jnp.float32),
            jnp.full(n, energy, jnp.float32), n)).astype(np.float64)
        t_dir = np.clip(_nest_photon_times(cls, field, energy, n, rng),
                        0, cfg['maximum_recombination_time'])
        # table timings are truncated to integer ns by the device path;
        # compare on the same footing
        d, p = sps.ks_2samp(np.floor(t_tbl), np.floor(t_dir))
        # grid + quantile discretization bounds the KS distance; 0.015 is
        # ~5x the pure-sampling KS scale at this n
        assert d < 0.015, (cls, d, p)
