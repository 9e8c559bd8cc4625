"""Statistical tests of the physics models against analytic expectations and
numpy oracles of the reference's documented behaviour."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wfsim_tpu.config import default_config
from wfsim_tpu.resources.loader import load_config
from wfsim_tpu.models.params import build_params, build_constants
from wfsim_tpu.models.s1 import simulate_s1
from wfsim_tpu.models.s2 import simulate_s2
from wfsim_tpu.models.afterpulse import pmt_afterpulse_photons


def setup_models(**overrides):
    c = default_config(**overrides)
    res = load_config(c)
    params = build_params(c, res)
    const = build_constants(c)
    return c, res, params, const


def inst_batch(n=8, typ=2, amp=200, z=-50.0):
    return dict(
        time=jnp.zeros(n, jnp.int32),
        x=jnp.full(n, 10.0, jnp.float32),
        y=jnp.full(n, -5.0, jnp.float32),
        z=jnp.full(n, z, jnp.float32),
        amp=jnp.full(n, amp, jnp.int32),
        recoil=jnp.full(n, 7, jnp.int32),
        valid=jnp.ones(n, bool),
        truth_row=jnp.arange(n, dtype=jnp.int32),
    )


S1_JIT = jax.jit(simulate_s1, static_argnames=('const', 'capacity', 'n_truth_rows'))
S2_JIT = jax.jit(simulate_s2, static_argnames=('const', 'e_capacity', 'capacity',
                                               'n_truth_rows'))


def run_s2(c, params, const, n=8, amp=200, z=-50.0, key=0):
    inst = inst_batch(n=n, amp=amp, z=z)
    return S2_JIT(params, const, inst, jax.random.key(key),
                  e_capacity=4096, capacity=2 ** 16, n_truth_rows=8)


def test_s1_custom_recoil_models():
    """'custom' timing: NR should be faster (more singlets) than ER."""
    c, res, params, const = setup_models(s1_model_type='custom')
    out = {}
    for recoil, name in [(7, 'er'), (0, 'nr')]:
        inst = inst_batch(n=8, typ=1, amp=3000)
        inst['recoil'] = jnp.full(8, recoil, jnp.int32)
        ph, tr, tot = S1_JIT(params, const, inst, jax.random.key(1),
                             capacity=8192, n_truth_rows=8)
        t = np.asarray(ph['t'])[np.asarray(ph['valid'])]
        out[name] = t.mean()
    # both include the ~46 ns transit mean; ER adds recombination delays
    assert out['er'] > out['nr']
    assert 30 < out['nr'] < 120


def test_s2_drift_time_and_spread():
    c, res, params, const = setup_models()
    z = -50.0
    _, truth, _ = run_s2(c, params, const, z=z, amp=300)
    drift = -z / c['drift_velocity_liquid'] + c['drift_time_gate']
    e_mean = np.asarray(truth['electron_t_min']
                        + truth['electron_t_mean_offset'])
    # electron arrival ~ drift + trapping(140)
    assert np.all(np.abs(e_mean - (drift + c['electron_trapping_time'])) < 2000)
    spread = np.sqrt(2 * c['diffusion_constant_longitudinal'] * drift) \
        / c['drift_velocity_liquid']
    sig = np.asarray(truth['electron_t_sigma'])
    assert np.all(np.abs(sig - spread) < 0.35 * spread + 160)


@pytest.mark.parametrize('model', ['simple', 'garfield_gas_gap'])
def test_s2_luminescence_models(model):
    c, res, params, const = setup_models(s2_luminescence_model=model)
    ph, truth, _ = run_s2(c, params, const, amp=100)
    t = np.asarray(ph['t'])[np.asarray(ph['valid'])]
    assert len(t) > 500
    # photon spread within an S2 should be dominated by drift diffusion
    # plus luminescence transit (~us scale), not wildly larger
    sig = np.asarray(truth['photon_t_sigma'])
    assert np.all(sig > 0)
    assert np.all(sig < 10000)


def test_s2_luminescence_simple_distribution():
    """The 'simple' model should produce a luminescence time distribution
    spanning the electron transit of the gas gap (sub-microsecond, centred)."""
    c, res, params, const = setup_models()
    from wfsim_tpu.models.s2 import luminescence_simple
    n = 20000
    xy = jnp.zeros((4, 2), jnp.float32)
    ph_inst = jnp.zeros(n, jnp.int32)
    valid = jnp.ones(n, bool)
    t = np.asarray(luminescence_simple(params, const, jax.random.key(2),
                                       xy, ph_inst, valid))
    # mean-centred by construction (avgt subtraction)
    assert abs(t.mean()) < 0.15 * (t.max() - t.min())
    assert 50 < t.std() < 2000


def test_pmt_afterpulses_rate_and_delay():
    c, res, params, const = setup_models(enable_pmt_afterpulses=True)
    n = 50000
    photons = dict(
        t=jnp.zeros(n, jnp.int32),
        ch=jnp.asarray(np.random.default_rng(0).integers(0, 494, n), jnp.int32),
        gain=jnp.full(n, 2e6, jnp.float32),
        is_dpe=jnp.zeros(n, bool),
        valid=jnp.ones(n, bool),
        truth_row=jnp.zeros(n, jnp.int32),
    )
    ap, info = pmt_afterpulse_photons(params, const, photons,
                                      jax.random.key(3), ap_capacity=8192,
                                      n_truth_rows=1)
    total = int(info['total'])
    assert int(info['counts'][0]) == min(total, 8192)
    # synthetic AP probability is ~2.5% over two species (measured
    # R11410-21 scale — see PARITY.md "Synthetic asset magnitudes")
    assert 0.012 * n < total < 0.05 * n
    t = np.asarray(ap['t'])[np.asarray(ap['valid'])]
    # delays can undershoot by up to pmt_ap_t_modifier (reference
    # afterpulse.py:223 subtracts it from the CDF index)
    assert t.min() >= -const.pmt_ap_t_modifier
    assert 200 < np.median(t) < 4000
    g = np.asarray(ap['gain'])[np.asarray(ap['valid'])]
    assert np.all(g >= 0)


def test_electron_afterpulse_feedback_end_to_end():
    from wfsim_tpu.dtypes import instruction_dtype
    from wfsim_tpu.pipeline.rawdata import RawDataTPU
    c = default_config(enable_electron_afterpulses=True,
                       enable_gate_afterpulses=True, seed=11)
    inst = np.zeros(1, dtype=instruction_dtype)
    inst['type'] = 2
    inst['time'] = 10_000_000
    inst['x'], inst['y'], inst['z'] = 5., 5., -30.
    inst['amp'] = 3000   # ~50k photons -> expect pi_el electrons
    inst['recoil'] = 7
    rd = RawDataTPU(c)
    truth = []
    n_pulses = sum(1 for _ in rd(inst, truth_buffer=truth))
    types = {int(r['type']) for r in truth}
    assert 2 in types
    assert 4 in types or 6 in types, f'no afterpulse truth rows, got {types}'
    assert n_pulses > 0


def test_pi_el_instructions_int64_base_time():
    """Secondary-instruction synthesis must survive absolute bases past
    int32 (super-batches late in a long run have base_time > 2.1 s; the
    candidate photon times are int32 window-relative offsets)."""
    from wfsim_tpu.dtypes import instruction_dtype
    from wfsim_tpu.models.afterpulse import (generate_pi_el_instructions,
                                             generate_pe_el_instructions)
    c = default_config(enable_electron_afterpulses=True,
                       enable_gate_afterpulses=True)
    resource = load_config(c)
    rng = np.random.default_rng(5)
    src = np.zeros(2, dtype=instruction_dtype)
    src['type'] = 2
    src['amp'] = 1000
    base_time = 2_740_000_000          # > 2**31 - 1
    counts = np.array([50_000, 50_000])
    cand = rng.integers(0, 1_000_000, (2, 16)).astype(np.int32)
    pi = generate_pi_el_instructions(c, resource, rng, counts, cand,
                                     src, base_time)
    pe = generate_pe_el_instructions(c, rng, counts, cand, src, base_time)
    assert len(pi) > 0 and len(pe) > 0
    for new in (pi, pe):
        assert new['time'].dtype == np.int64
        assert (np.abs(new['time'].astype(np.float64)
                       - base_time) < 5e9).all()


def test_noise_and_baseline():
    from wfsim_tpu.pipeline.digitize import digitize_window
    c, res, params, const = setup_models(enable_noise=True)
    assert params.noise_data is not None
    n, T = 256, 512
    rng = np.random.default_rng(1)
    t = jnp.asarray(rng.integers(1500, 3000, n).astype(np.int32))
    ch = jnp.asarray(rng.integers(0, 494, n).astype(np.int32))
    g = jnp.full(n, 2e6, jnp.float32)
    v = jnp.ones(n, bool)
    out = digitize_window(params, const, t, ch, g, v, jax.random.key(0),
                          jnp.int32(1234), n_samples=T, max_intervals=32)
    data = np.asarray(out['data'])
    mask = np.asarray(out['ch_mask'])
    cl = np.asarray(out['ch_left'])
    cr = np.asarray(out['ch_right'])
    # in-window quiet samples fluctuate around the 16000 baseline
    c0 = int(np.nonzero(mask)[0][0])
    quiet = data[c0, cl[c0]:cl[c0] + 20]
    assert 15900 < quiet.mean() < 16100
    assert quiet.std() > 0.5     # noise present
    # outside the window: exactly zero
    if cr[c0] + 2 < T:
        assert np.all(data[c0, cr[c0] + 1:] == 0)


def test_per_pmt_truth():
    c, res, params, const = setup_models(per_pmt_truth=True)
    inst = inst_batch(n=4, amp=100)
    ph, truth, _ = S1_JIT(params, const, inst, jax.random.key(5),
                          capacity=2048, n_truth_rows=4)
    per_pmt = np.asarray(truth['n_photon_per_pmt'])
    tot = np.asarray(truth['n_photon'])
    np.testing.assert_array_equal(per_pmt.sum(axis=1), tot)


def test_diffuse_pattern_without_spread_is_the_point_pattern():
    """With zero transverse diffusion every electron of an instruction sits
    at its interaction point, so the per-instruction average of the
    electrons' patterns is that point's pattern; padding electrons and
    instructions without electrons do not disturb it."""
    from wfsim_tpu.models.s2 import s2_pattern_map_diffuse
    c, res, params, const = setup_models()
    rng = np.random.default_rng(4)
    n_inst, E = 5, 64
    xy = jnp.asarray(rng.uniform(-30, 30, (n_inst, 2)), jnp.float32)
    z = jnp.full(n_inst, -40.0, jnp.float32)
    e_inst = jnp.asarray(np.sort(rng.integers(0, n_inst - 1, E)), jnp.int32)
    e_valid = jnp.arange(E) < E - 6
    pat = np.asarray(s2_pattern_map_diffuse(
        params, const, jax.random.key(2), None, z, xy, e_inst, e_valid))
    ref = np.asarray(params.s2_pattern(xy))
    if ref.ndim == 1:
        ref = ref[:, None] * np.ones((1, pat.shape[1]))
    has = np.isin(np.arange(n_inst), np.asarray(e_inst)[np.asarray(e_valid)])
    np.testing.assert_allclose(pat[has], ref[has], rtol=1e-5, atol=1e-7)
    assert np.all(pat[~has] == 0)


def test_photon_time_stats_scatter_path_matches_segment_path():
    """Unsorted callers' sort + scan sums agree with the segment path."""
    from wfsim_tpu.models.pmt import photon_time_stats
    from wfsim_tpu.ops.segment import edges_from_counts
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 50, 9).astype(np.int32)
    counts[2] = 0
    cap = int(counts.sum()) + 17
    row = np.concatenate([np.repeat(np.arange(9), counts),
                          np.full(17, 8)]).astype(np.int32)
    t = rng.integers(0, 10 ** 6, cap).astype(np.int32)
    valid = np.arange(cap) < counts.sum()
    a = photon_time_stats(jnp.asarray(t), jnp.asarray(valid),
                          jnp.asarray(row), 9)
    b = photon_time_stats(jnp.asarray(t), jnp.asarray(valid),
                          jnp.asarray(row), 9,
                          row_edges=edges_from_counts(jnp.asarray(counts),
                                                      cap))
    for k in ('count', 't_min', 't_max'):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    for k in ('t_mean_offset', 't_sigma'):
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=1e-4, atol=1e-2)


def test_special_thresholds():
    c, res, params, const = setup_models(special_thresholds={'5': 100})
    thr = np.asarray(params.trigger_thresholds)
    assert thr[5] == 99.5
    assert thr[6] == 14.5
    zthr = np.asarray(params.zle_thresholds)
    assert zthr[5] == 16000 - 100 - 1
    assert zthr[6] == 16000 - 15 - 1


def test_s2_luminescence_garfield_table():
    """'garfield' model with a synthetic wire-distance timing table
    (reference: s2.py:380-409)."""
    rng = np.random.default_rng(0)
    n_rows, n_cols = 11, 500
    x_axis = np.linspace(-0.25, 0.25, n_rows)
    table = rng.exponential(300, (n_rows, n_cols)) + \
        np.abs(x_axis)[:, None] * 1000
    c, res, params, const = setup_models(
        s2_luminescence_model='garfield',
        s2_luminescence={'t': table.astype(np.float32),
                         'x': x_axis.astype(np.float32)})
    assert params.garfield_t is not None
    ph, truth, _ = run_s2(c, params, const, amp=100)
    t = np.asarray(ph['t'])[np.asarray(ph['valid'])]
    assert len(t) > 500
    sig = np.asarray(truth['photon_t_sigma'])
    assert np.all(sig > 0)
