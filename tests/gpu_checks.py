"""Correctness checks meant for the card, at the detector's real widths.

Each check raises ``AssertionError`` on failure and returns a dict of
findings.  ``chip_smoke.py`` calls them in its own process (a second JAX
process could not get the card's memory); ``tests/test_gpu.py`` wraps them
as tests marked ``gpu``.  They import nothing that pins the platform, so
they run on whatever backend the calling process uses.
"""
import numpy as np


#: The DAQ oracle works in float64, the device in float32, whose sums the
#: GPU takes in another order.  A sample whose oracle value before ADC
#: rounding lies within this many ADC counts of the .5 edge (plus a 1e-6
#: relative share of its size) may round the other way, by exactly 1 ADC.
#: PARITY.md deviation 6 states the same bound.
ADC_EDGE_EPS = 1e-3


def _edge_eps(x):
    return ADC_EDGE_EPS + 1e-6 * np.abs(x)


def digitize_parity(seed=0, n_channels=None, n_samples=2048,
                    n_photons=20_000, max_intervals=64):
    """Fixed photon lists through ``gather_digitize`` + ``pack_records``
    against the numpy DAQ oracle of ``tests/test_digitize_parity.py``.

    Record metadata must match exactly.  Payload samples must match exactly,
    except that a sample may be off by 1 ADC where the oracle's pre-rounding
    value lies within :func:`_edge_eps` of a rounding edge; such samples are
    counted and returned.  ``n_channels`` defaults to every TPC channel.
    """
    import jax
    import jax.numpy as jnp
    from wfsim_tpu.config import default_config
    from wfsim_tpu.resources.loader import load_config
    from wfsim_tpu.models.params import build_params, build_constants
    from wfsim_tpu.ops.waveform import make_templates
    from wfsim_tpu.pipeline.digitize import gather_digitize, pack_records
    from .reference_semantics import scatter_spe
    from .test_digitize_parity import numpy_digitize

    c = default_config()
    params = build_params(c, load_config(c))
    const = build_constants(c)
    templates = make_templates(c['pe_pulse_ts'], c['pe_pulse_ys'])
    n_channels = const.n_tpc_pmts if n_channels is None else n_channels
    T = n_samples

    rng = np.random.default_rng(seed)
    t = rng.integers(1500, T * 10 - 3000, n_photons).astype(np.int64)
    ch = rng.integers(0, n_channels, n_photons).astype(np.int32)
    gain = rng.uniform(1e6, 3e6, n_photons).astype(np.float32)

    n_cap = 512
    while n_cap < n_photons:
        n_cap *= 2
    pieces = np.zeros((1, 4, 3), np.int32)
    pieces[0, 0] = (0, n_photons, 0)
    with jax.default_matmul_precision('highest'):
        res = gather_digitize(params, const, jnp.asarray(t.astype(np.int32)),
                              jnp.asarray(ch), jnp.asarray(gain),
                              jnp.asarray(pieces), jnp.zeros(1, jnp.int32),
                              n_samples=T, n_pieces=4, n_cap=n_cap,
                              max_intervals=max_intervals)
        n_rec = int(res['n_records'])
        max_records = 1024
        while max_records < n_rec:
            max_records *= 2
        packed = pack_records(res['data'], res['left_all'], res['starts'],
                              res['ends'], res['itv_valid'],
                              n_channels_total=int(res['data'].shape[1]),
                              n_samples=T, max_intervals=max_intervals,
                              max_records=max_records)
        meta = np.asarray(packed['rec_meta'])[:n_rec]
        rdata = np.asarray(packed['rec_data'])[:n_rec]

    oracle = numpy_digitize(c, templates, t, ch, gain, T, const.n_tpc_pmts)
    pre = scatter_spe(t, ch, gain, 0, const.n_tpc_pmts, T,
                      templates) * c['current_2_adc']

    ours = {}
    for w, cch, start_s, length, plen, rec_i in meta:
        ours.setdefault(int(cch), []).append(
            (int(start_s), int(length), int(plen), int(rec_i)))
    payload = {}
    for i, row in enumerate(meta):
        payload.setdefault(int(row[1]), []).append(rdata[i])

    assert set(ours) == set(oracle), 'channels with records differ'
    n_samples_cmp = n_edge = 0
    for cch, recs in oracle.items():
        assert len(ours[cch]) == len(recs), f'channel {cch}: record count'
        for got, got_data, ref in zip(ours[cch], payload[cch], recs):
            assert got == tuple(ref[:4]), (cch, got, ref[:4])
            length = ref[1]
            diff = (got_data[:length].astype(np.int64)
                    - ref[4][:length].astype(np.int64))
            n_samples_cmp += length
            bad = np.nonzero(diff)[0]
            if not len(bad):
                continue
            x = pre[cch, ref[0] + bad]
            near = np.abs(x - np.floor(x) - 0.5) < _edge_eps(x)
            assert np.all(np.abs(diff[bad]) == 1) and np.all(near), (
                f'channel {cch}: {len(bad)} payload samples differ, '
                f'diffs {diff[bad][:8]}, pre-rounding {x[:8]}')
            n_edge += len(bad)
    return dict(channels=int(n_channels), n_samples=T,
                photons=int(n_photons), records=int(n_rec),
                samples_compared=int(n_samples_cmp),
                samples_off_by_one_at_edge=int(n_edge),
                edge_eps_adc=ADC_EDGE_EPS)


#: The KS oracles run on the card: S1 ER/NR timing, S2 electron timings and
#: 'simple' luminescence, each N=40k samples at p > 0.01.
SAMPLER_ORACLES = ('test_ks_s1_er', 'test_ks_s1_nr',
                   'test_ks_s2_electron_timings',
                   'test_ks_luminescence_simple')


def sampler_oracles(names=SAMPLER_ORACLES):
    """Run the named KS oracles of ``tests/test_reference_distributions.py``;
    each raises with its KS statistic and p-value when it fails."""
    from . import test_reference_distributions as rd
    for name in names:
        getattr(rd, name)()
    return dict(passed=list(names), n=rd.N, p_min=rd.P_MIN)
