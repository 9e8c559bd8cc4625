"""Full-run device trace of the bench workload.

Runs the bench workload once under ``jax.profiler.trace`` and reduces the
trace to device time by XLA module (jit_* program), device busy share and
the largest idle gaps, so we can see which compiled programs occupy the GPU
during a production-shaped run.

Usage: python prof_trace_full.py [n_events] [realistic(0/1)] [ceiling(0/1)]
"""
import collections
import glob
import gzip
import json
import os
import sys
import time


def _device_pids(events):
    """pid -> name of the trace's GPU device processes."""
    return {e['pid']: e['args'].get('name', '') for e in events
            if e.get('ph') == 'M' and e.get('name') == 'process_name'
            and '/device:GPU' in e.get('args', {}).get('name', '')}


def _module_of(event):
    args = event.get('args') or {}
    name = (args.get('hlo_module') or args.get('group_name')
            or event.get('name', ''))
    # module rows look like jit_foo(12345...); strip the id
    return name.split('(')[0]


def reduce_trace(trace):
    """Per-module device time, busy share and idle gaps of a Chrome-format
    trace dict (``traceEvents``).  Raises if the trace has no GPU device
    lane: a reduction that silently reads zero is worse than none."""
    events = trace['traceEvents']
    pids = _device_pids(events)
    if not pids:
        raise ValueError('trace has no GPU device lanes (process names '
                         'containing "/device:GPU")')
    mod_us = collections.Counter()
    n_exec = collections.Counter()
    spans = []
    for e in events:
        if e.get('ph') != 'X' or e.get('pid') not in pids:
            continue
        dur = e.get('dur', 0)
        mod_us[_module_of(e)] += dur
        n_exec[_module_of(e)] += 1
        spans.append((e['ts'], e['ts'] + dur))
    out = dict(modules=[(name, us, n_exec[name])
                        for name, us in mod_us.most_common()],
               busy_us=0.0, span_us=0.0, busy_share=0.0, gaps=[])
    if not spans:
        return out
    spans.sort()
    merged = [list(spans[0])]
    for s, t in spans[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    t0, t1 = merged[0][0], merged[-1][1]
    busy = sum(b - a for a, b in merged)
    out.update(busy_us=busy, span_us=t1 - t0,
               busy_share=busy / max(t1 - t0, 1),
               gaps=sorted(((merged[i + 1][0] - merged[i][1],
                             merged[i][1] - t0)
                            for i in range(len(merged) - 1)), reverse=True))
    return out


def main(n_events=256, realistic=True, ceiling=False,
         trace_dir='build/trace_full'):
    import jax
    from wfsim_tpu.config import default_config
    from wfsim_tpu.interface.simulator import Simulator
    from bench import _make_inst, device_info

    if realistic:
        c = default_config(enable_noise=True, enable_pmt_afterpulses=True,
                           enable_electron_afterpulses=True)
    else:
        c = default_config()
    c['chunk_size'] = 100
    c['seed'] = 1234
    if ceiling:
        c['_bench_device_ceiling'] = True
    inst = _make_inst(n_events, 2000, 300)

    sim = Simulator(c)
    _ = sim.get_arrays(inst)          # warmup/compile

    sim = Simulator(c)
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        out = sim.get_arrays(inst)
    dt = time.perf_counter() - t0
    phases = {k: round(v, 3)
              for k, v in sorted(sim.sim.rawdata.diag.seconds.items())}
    print(json.dumps({'device': device_info(),
                      'events_per_sec': round(n_events / dt, 2),
                      'total_s': round(dt, 2),
                      'n_records': len(out['raw_records']),
                      'phases': phases}))

    d = sorted(glob.glob(os.path.join(trace_dir, 'plugins/profile/*')))[-1]
    path = sorted(glob.glob(os.path.join(d, '*.trace.json.gz')))[0]
    with gzip.open(path) as f:
        red = reduce_trace(json.load(f))
    print(f'total device time: {red["busy_us"] / 1e6:.3f} s busy of '
          f'{red["span_us"] / 1e6:.3f} s span '
          f'({100 * red["busy_share"]:.1f}%); wall {dt:.3f} s')
    for name, us, n in red['modules'][:24]:
        print(f'{us / 1e3:9.1f} ms x{n:<5d} {name}')
    print('top idle gaps (ms @ s-into-span): '
          + ', '.join(f'{g / 1e3:.1f}@{at / 1e6:.2f}'
                      for g, at in red['gaps'][:12]))


if __name__ == '__main__':
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    r = bool(int(sys.argv[2])) if len(sys.argv) > 2 else True
    ceil = bool(int(sys.argv[3])) if len(sys.argv) > 3 else False
    main(n, r, ceil)
