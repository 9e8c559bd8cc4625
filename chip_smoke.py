"""Smoke test of the simulator's main path on one GPU.

    python chip_smoke.py           # phases a-f on jax.devices()[0]
    python chip_smoke.py --four    # phase g only: the mesh path on 4 GPUs
    python chip_smoke.py --events 64 --four   # fewer events (default 512)

Phases:
  a. environment: the card's name and power limit, JAX, the native host
     extension and the compile-cache directory; fails without a GPU.
  b. headline main path: 512 events (S1 2000, S2 300, 494 channels) through
     ``Simulator.get_arrays``; set-up (compile) and run seconds, peak memory.
  c. realistic main path: the same events with noise and PMT and electron
     afterpulses on.
  d. DAQ parity at real widths: fixed photon lists through gather_digitize
     and pack_records against the numpy oracle (tests/gpu_checks.py).
  e. sampler KS oracles on the card (tests/gpu_checks.py).
  f. run-to-run reproducibility: the two runs of one seed in phase b, and
     those in phase c, must give identical records and truth.
  g. (--four) ``Simulator(mesh=make_mesh(4, 1))`` against the one-card run
     of the same seed, with threefry2x32: identical records and truth.

Everything runs in this one process, which holds the card.  Findings go to
earlier lines; the last line is one JSON object, printed only when every
phase passed.
"""
import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

N_EVENTS = 512


def _nvidia_smi():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60)
        return (out.stdout or out.stderr).strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'unavailable ({e})'


def _make_inst(n, amp_s1=2000, amp_s2=300):
    """The benchmark's headline events (bench.py ``_make_inst``)."""
    from bench import _make_inst as make
    return make(n, amp_s1, amp_s2)


def _config(realistic=False, prng_impl=None):
    from wfsim_tpu.config import default_config
    if realistic:
        c = default_config(enable_noise=True, enable_pmt_afterpulses=True,
                           enable_electron_afterpulses=True)
    else:
        c = default_config()
    c['chunk_size'] = 100
    c['seed'] = 1234
    if prng_impl:
        c['prng_impl'] = prng_impl
    return c


def check_outputs(out, inst, n_channels_total, field_distortion=False):
    """Structural checks of one ``get_arrays`` result; returns counts."""
    rr, truth = out['raw_records'], out['truth']
    primary = np.isin(truth['type'], (1, 2))
    assert int(primary.sum()) == len(inst), \
        f'{int(primary.sum())} primary truth rows for {len(inst)} instructions'
    assert len(rr) > 0, 'no records'
    ch = rr['channel'].astype(np.int64)
    assert ch.min() >= 0 and ch.max() < n_channels_total, \
        f'channel out of range: [{ch.min()}, {ch.max()}]'
    assert rr['length'].min() > 0 and rr['length'].max() <= 110, \
        f'record length out of range: [{rr["length"].min()}, ' \
        f'{rr["length"].max()}]'
    order = np.argsort(ch, kind='stable')
    same = np.diff(ch[order]) == 0
    assert not np.any(same & (np.diff(rr['time'][order]) < 0)), \
        'records out of time order within a channel'
    # NaN marks an absent quantity, as in the reference: photon timing of a
    # row without photons, electron timing of a row without electrons, and
    # the field-distorted electron position when no field-distortion model
    # runs (reference rawdata.py:377-390)
    no_photon = truth['n_photon'] == 0
    no_electron = truth['n_electron'] == 0
    for name in truth.dtype.names:
        if truth.dtype[name].kind != 'f':
            continue
        absent = np.zeros(len(truth), bool)
        if name.endswith('_photon') and name.startswith('t_'):
            absent = no_photon
        elif name.startswith('t_') and name.endswith('_electron'):
            absent = no_electron
        elif name in ('x_mean_electron', 'y_mean_electron'):
            absent = no_electron | (not field_distortion)
        nan = np.isnan(truth[name])
        nan = nan.reshape(len(truth), -1).any(axis=1)
        assert not np.any(nan & ~absent), f'NaN in truth[{name!r}]'
    return dict(records=int(len(rr)), truth_rows=int(len(truth)),
                photons=int(truth['n_photon'].sum()))


def _identical(a, b):
    """Byte equality of two structured arrays: (equal, rows that differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, max(len(a), len(b))
    av = np.ascontiguousarray(a).view(np.uint8).reshape(len(a), -1)
    bv = np.ascontiguousarray(b).view(np.uint8).reshape(len(b), -1)
    n = int(np.any(av != bv, axis=1).sum())
    return n == 0, n


def _how_they_differ(a, b):
    """Rows that differ in each field, and the largest payload difference."""
    if a.shape != b.shape:
        return f'{len(a)} vs {len(b)} rows'
    found = {}
    for name in a.dtype.names:
        d = np.any(np.ascontiguousarray(a[name]).view(np.uint8).reshape(
            len(a), -1) != np.ascontiguousarray(b[name]).view(
            np.uint8).reshape(len(b), -1), axis=1)
        if d.any():
            found[name] = int(d.sum())
    if 'data' in found:
        found['data_max_abs_diff'] = int(np.abs(
            a['data'].astype(np.int64) - b['data'].astype(np.int64)).max())
    return found


def compare_runs(x, y):
    """Records and truth of two runs must be identical."""
    found = {}
    for key in ('raw_records', 'truth'):
        equal, n = _identical(x[key], y[key])
        found[f'{key}_rows_differ'] = n
        assert equal, (f'{key}: {n} rows differ between runs: '
                       f'{_how_they_differ(x[key], y[key])}')
    return found


def run_main_path(config, inst, mesh=None):
    """Two fresh ``Simulator`` runs of one config: the first compiles
    (set-up), the second is timed.  Returns both outputs and the times."""
    from wfsim_tpu.interface.simulator import Simulator
    t0 = time.perf_counter()
    sim = Simulator(config, mesh=mesh)
    first = sim.get_arrays(inst)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = Simulator(config, mesh=mesh)
    second = sim.get_arrays(inst)
    run_s = time.perf_counter() - t0
    return first, second, setup_s, run_s, sim


def _peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get('peak_bytes_in_use')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the four-card mesh phase (g)')
    ap.add_argument('--events', type=int, default=N_EVENTS,
                    help='events per main-path run (default %(default)s)')
    args = ap.parse_args(argv)

    # a. environment -- nvidia-smi before JAX touches the card
    smi = _nvidia_smi()
    print(f'[a] nvidia-smi: {smi}', flush=True)
    import jax
    import wfsim_tpu
    from wfsim_tpu import native
    devices = jax.devices()
    dev = devices[0]
    print(f'[a] jax {jax.__version__}; devices {devices}', flush=True)
    print(f'[a] native host extension: {native.HAVE_NATIVE}; compile cache: '
          f'{jax.config.jax_compilation_cache_dir}', flush=True)
    if dev.platform != 'gpu':
        print(f'[a] FAIL: platform is {dev.platform!r}, not gpu; this check '
              'needs the card', file=sys.stderr, flush=True)
        return 2
    n_need = 4 if args.four else 1
    if len(devices) < n_need:
        print(f'[a] FAIL: {len(devices)} devices, need {n_need}',
              file=sys.stderr, flush=True)
        return 2
    print(f'[a] PASS {dev.device_kind}', flush=True)

    failed = []

    def phase(tag, fn):
        t0 = time.perf_counter()
        try:
            found = fn()
        except Exception:
            failed.append(tag)
            print(f'[{tag}] FAIL after {time.perf_counter() - t0:.1f} s',
                  flush=True)
            traceback.print_exc()
            sys.stdout.flush()
            return None
        print(f'[{tag}] PASS {json.dumps(found)}', flush=True)
        return found

    n_events = args.events
    inst = _make_inst(n_events)
    runs = {}

    def main_path(tag, realistic):
        def fn():
            cfg = _config(realistic)
            first, second, setup_s, run_s, sim = run_main_path(cfg, inst)
            runs[tag] = (first, second)
            const = sim.sim.rawdata.const
            fdc = const.field_distortion_model in ('inverse_fdc', 'comsol')
            found = check_outputs(second, inst, const.n_channels_total, fdc)
            check_outputs(first, inst, const.n_channels_total, fdc)
            found.update(events=n_events, setup_seconds=round(setup_s, 3),
                         run_seconds=round(run_s, 3),
                         events_per_second=round(n_events / run_s, 2),
                         peak_bytes_in_use=_peak_bytes(dev))
            return found
        return fn

    if args.four:
        from wfsim_tpu.interface.simulator import Simulator
        from wfsim_tpu.parallel.sharding import make_mesh

        def four():
            cfg = _config(prng_impl='threefry2x32')
            t0 = time.perf_counter()
            one = Simulator(cfg).get_arrays(inst)
            one_s = time.perf_counter() - t0
            mesh = make_mesh(4, 1, devices=devices[:4])
            first, second, setup_s, run_s, sim = run_main_path(
                cfg, inst, mesh=mesh)
            n_ch = sim.sim.rawdata.const.n_channels_total
            found = check_outputs(second, inst, n_ch)
            found.update(compare_runs(one, second))
            compare_runs(first, second)
            found.update(devices=len(mesh.devices.flat), events=n_events,
                         one_card_seconds_with_compile=round(one_s, 3),
                         mesh_setup_seconds=round(setup_s, 3),
                         mesh_run_seconds=round(run_s, 3))
            return found
        phase('g', four)
    else:
        from tests import gpu_checks
        phase('b', main_path('b', realistic=False))
        phase('c', main_path('c', realistic=True))
        phase('d', gpu_checks.digitize_parity)
        phase('e', gpu_checks.sampler_oracles)

        def repro():
            found = {}
            for tag in ('b', 'c'):
                if tag not in runs:
                    raise RuntimeError(f'phase {tag} produced no runs to '
                                       'compare')
                found[tag] = compare_runs(*runs[tag])
            return found
        phase('f', repro)

    if failed:
        print(f'FAILED phases: {failed}', flush=True)
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(devices)}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
