"""Extended benchmark suite: the five BASELINE.json configurations.

Prints one JSON line per config, each naming the device it ran on.
``bench.py`` remains the single headline metric; this suite gives the full
picture.
"""
import json
import time

import numpy as np

from wfsim_tpu.config import default_config
from wfsim_tpu.dtypes import instruction_dtype, optical_extra_dtype
from wfsim_tpu.interface.simulator import Simulator

from bench import device_info


def make_inst(n, types=(1, 2), amps=(2000, 300), spacing=4_000_000, seed=7):
    k = len(types)
    rng = np.random.default_rng(seed)
    inst = np.zeros(k * n, dtype=instruction_dtype)
    inst['event_number'] = np.repeat(np.arange(n), k)
    inst['type'] = np.tile(types, n)
    inst['time'] = np.repeat((np.arange(n) + 1) * spacing, k)
    r = np.sqrt(rng.uniform(0, 45 ** 2, n))
    th = rng.uniform(-np.pi, np.pi, n)
    inst['x'] = np.repeat(r * np.cos(th), k)
    inst['y'] = np.repeat(r * np.sin(th), k)
    inst['z'] = np.repeat(rng.uniform(-90, -10, n), k)
    inst['amp'] = np.tile(amps, n)
    inst['recoil'] = 7
    return inst


def _run_geant4_row():
    """BASELINE config 4 measured for real (round-4 verdict item 6): the
    reference's own GEANT4 fixture (tests/geant_test_data_small.root, read
    by the vendored pure-python ROOT reader) driven through the nVeto
    optical chain, with a matched CPU baseline over the SAME photon lists.
    The fixture is small (~10 events), so the instruction set is tiled in
    time to a bench-sized batch."""
    from wfsim_tpu.config import default_config
    from wfsim_tpu.interface.instructions import read_optical
    from wfsim_tpu.pipeline.chunker import ChunkRawRecords
    from wfsim_tpu.pipeline.optical import RawDataOpticalTPU
    from wfsim_tpu.ops.waveform import make_templates

    fixture = '/root/reference/tests/geant_test_data_small.root'
    c = default_config(detector='XENONnT_neutron_veto', seed=8,
                       chunk_size=1000)
    c['fax_file'] = fixture
    c['_truth_extra_instruction_dtype'] = optical_extra_dtype
    try:
        ins0, channels, timings = read_optical(c)
    except (OSError, FileNotFoundError):
        print(json.dumps({'metric': 'GEANT4 optical (nVeto, real fixture)',
                          'skipped': 'fixture not available',
                          'device': device_info()}), flush=True)
        return

    reps = max(1, 256 // max(len(ins0), 1))
    span = int(ins0['time'].max()) + 2_000_000
    parts = []
    for i in range(reps):
        p = ins0.copy()
        p['time'] += i * span
        p['event_number'] += i * (int(ins0['event_number'].max()) + 1)
        parts.append(p)
    ins = np.concatenate(parts)
    n_ev = len(np.unique(ins['event_number']))

    def run_once():
        sim = ChunkRawRecords(c, rawdata_generator=RawDataOpticalTPU,
                              channels=channels, timings=timings)
        return list(sim(ins))

    run_once()    # warmup
    dts = []
    outs = None
    for _ in range(2):
        t0 = time.perf_counter()
        outs = run_once()
        dts.append(time.perf_counter() - t0)
    dt = float(np.median(dts))

    # matched CPU baseline: the reference optical chain over the SAME
    # photon lists (PMT response + add_current loop + sequential ZLE)
    cfg = default_config()
    templates = make_templates(cfg['pe_pulse_ts'], cfg['pe_pulse_ys'])
    charge_grid = np.linspace(0, 2, 2001)
    rng = np.random.default_rng(0)
    cpu_runs = []
    for _run in range(3):
        t0 = time.perf_counter()
        for _rep in range(reps):
            for k in range(len(ins0)):
                lo, hi = int(ins0['_first'][k]), int(ins0['_last'][k])
                tt = timings[lo:hi].astype(np.int64)
                cc = channels[lo:hi]
                if not len(tt):
                    continue
                tt = tt + rng.normal(46, 9 / 2.35, len(tt)).astype(np.int64)
                gains = 2e6 * charge_grid[
                    (rng.random(len(tt)) * 2000).astype(int)]
                order = np.argsort(cc, kind='stable')
                tt, cc, gains = tt[order], cc[order], gains[order]
                for channel in np.unique(cc):
                    m = cc == channel
                    ts, gs = tt[m], gains[m]
                    left = int(ts.min() // 10) - 52
                    right = int(ts.max() // 10) + 70
                    wave = np.zeros(right - left + 1)
                    s = (ts // 10).astype(int) - left
                    r = (ts % 10).astype(int)
                    for j in range(len(ts)):
                        wave[s[j]:s[j] + 22] += templates[r[j]] * gs[j]
                    adc = -np.around(wave * cfg['current_2_adc']).astype(
                        np.int64)
                    adc += 16000
                    np.clip(adc, 0, None, out=adc)
                    below = adc < 15984
                    if below.any():
                        blo = max(int(np.argmax(below)) - 50, 0)
                        bhi = min(len(adc) - 1,
                                  int(len(below) - np.argmax(below[::-1]))
                                  + 50)
                        pulse = adc[blo:bhi + 1]
                        plen = len(pulse)
                        nrec = -(-plen // 110)
                        np.pad(pulse, (0, nrec * 110 - plen),
                               'constant').reshape(-1, 110).astype(np.int16)
        cpu_runs.append(n_ev / (time.perf_counter() - t0))
    cpu_ev = float(np.median(cpu_runs))

    print(json.dumps({
        'metric': 'GEANT4 optical (nVeto, real fixture)',
        'value': round(n_ev / dt, 3), 'unit': 'events/s',
        'device': device_info(),
        'runs_events_per_sec': [round(n_ev / d, 1) for d in dts],
        'stable': bool(max(dts) / min(dts) < 1.2),
        'fixture_events': int(len(np.unique(ins0['event_number']))),
        'tiled_reps': reps,
        'photons': int(len(channels)) * reps,
        'records': int(sum(len(o['raw_records']) for o in outs)),
        'events_per_sec_cpu_baseline': round(cpu_ev, 3),
        'vs_baseline': round(n_ev / dt / cpu_ev, 2),
    }), flush=True)


def run_config(name, config, inst, cpu_baseline=None):
    """Two consecutive timed runs per row (after a compile warmup); the row
    reports the median and carries an explicit stable flag (runs within
    20%) — one-run rows with excuses don't belong in end-of-round tables.

    ``cpu_baseline``: callable(truth) -> baseline dict (bench.py
    measure_cpu_baseline-style), run AFTER the device timing so the matched
    single-core numpy reference work never overlaps the device runs."""
    device = device_info()
    sim = Simulator(config)
    _ = sim.get_arrays(inst)           # warmup/compile
    dts = []
    for _ in range(2):
        sim = Simulator(config)
        t0 = time.perf_counter()
        out = sim.get_arrays(inst)
        dts.append(time.perf_counter() - t0)
    dt = float(np.median(dts))
    n_events = len(np.unique(inst['event_number']))
    n_ph = int(out['truth']['n_photon'].sum())
    row = {
        'metric': name, 'value': round(n_events / dt, 3),
        'unit': 'events/s', 'device': device,
        'runs_events_per_sec': [round(n_events / d, 1) for d in dts],
        'stable': bool(max(dts) / min(dts) < 1.2),
        'photons_per_sec': round(n_ph / dt, 1),
        'records': int(len(out['raw_records'])),
    }
    if cpu_baseline is not None:
        cpu = cpu_baseline(out['truth'])
        row['events_per_sec_cpu_baseline'] = round(cpu['events_per_sec'], 3)
        row['vs_baseline'] = round(n_events / dt / cpu['events_per_sec'], 2)
    print(json.dumps(row), flush=True)


def main(only=None):
    from bench import measure_cpu_baseline, measure_cpu_optical_baseline
    n = 256
    base = dict(chunk_size=1000, seed=1234)

    def want(name):
        return only is None or only in name

    if want('S1-only'):
        # S1-only events carry ~26 photons each — per-event work is tiny,
        # so 4096 events amortize the fixed costs the way any production
        # batch would.
        run_config('S1-only', default_config(**base),
                   make_inst(4096, types=(1,), amps=(2000,)),
                   cpu_baseline=lambda truth: measure_cpu_baseline(
                       n_runs=3, with_s2=False))
    if want('S2-only'):
        run_config('S2-only', default_config(**base),
                   make_inst(n, types=(2,), amps=(300,)),
                   cpu_baseline=lambda truth: measure_cpu_baseline(
                       n_runs=3, with_s1=False))
    def _noise_baseline(truth):
        n_tot = truth['n_photon'].sum()
        frac = float(truth['n_photon'][truth['type'] > 2].sum()
                     / max(n_tot, 1))
        return measure_cpu_baseline(n_runs=3, realistic=True,
                                    ap_photon_frac=frac)

    if want('noise'):
        run_config('full S1+S2 + afterpulses + noise',
                   default_config(enable_pmt_afterpulses=True,
                                  enable_electron_afterpulses=True,
                                  enable_noise=True, **base),
                   make_inst(n), cpu_baseline=_noise_baseline)
    # high-rate: per-event work on the reference is the same as the
    # headline (spacing changes window merging, not per-photon cost), so
    # the standard baseline is the matched comparison
    if want('high-rate'):
        run_config('high-rate S1+S2 (1 kHz)',
                   default_config(**base),
                   make_inst(1024, spacing=1_000_000),
                   cpu_baseline=lambda truth: measure_cpu_baseline(n_runs=3))
    if want('geant4'):
        _run_geant4_row()
    if not want('optical'):
        return

    # optical (GEANT4-like photon lists), nVeto detector
    from wfsim_tpu.pipeline.chunker import ChunkRawRecords
    from wfsim_tpu.pipeline.optical import RawDataOpticalTPU
    rng = np.random.default_rng(3)
    n_ev, ppe = 256, 300
    channels = rng.integers(0, 120, n_ev * ppe).astype(np.int32)
    timings = rng.integers(0, 400, n_ev * ppe).astype(np.int64)
    oinst = np.zeros(n_ev, dtype=instruction_dtype + optical_extra_dtype)
    oinst['type'] = 1
    oinst['time'] = (np.arange(n_ev) + 1) * 2_000_000
    oinst['event_number'] = np.arange(n_ev)
    oinst['amp'] = ppe
    oinst['recoil'] = 1
    oinst['_first'] = np.arange(n_ev) * ppe
    oinst['_last'] = (np.arange(n_ev) + 1) * ppe
    c = default_config(detector='XENONnT_neutron_veto', seed=8,
                       chunk_size=1000)
    c['_truth_extra_instruction_dtype'] = optical_extra_dtype

    def run_optical():
        sim = ChunkRawRecords(c, rawdata_generator=RawDataOpticalTPU,
                              channels=channels, timings=timings)
        return [o for o in sim(oinst)]

    run_optical()   # warmup
    dts = []
    for _ in range(2):
        t0 = time.perf_counter()
        outs = run_optical()
        dts.append(time.perf_counter() - t0)
    dt = float(np.median(dts))
    cpu = measure_cpu_optical_baseline(ppe=ppe, n_channels=120)
    print(json.dumps({
        'metric': 'optical photon-list (nVeto)', 'value': round(n_ev / dt, 3),
        'unit': 'events/s', 'device': device_info(),
        'runs_events_per_sec': [round(n_ev / d, 1) for d in dts],
        'stable': bool(max(dts) / min(dts) < 1.2),
        'photons_per_sec': round(n_ev * ppe / dt, 1),
        'records': int(sum(len(o['raw_records']) for o in outs)),
        'events_per_sec_cpu_baseline': round(cpu['events_per_sec'], 3),
        'vs_baseline': round(n_ev / dt / cpu['events_per_sec'], 2),
    }), flush=True)


if __name__ == '__main__':
    import sys
    main(only=sys.argv[1] if len(sys.argv) > 1 else None)
