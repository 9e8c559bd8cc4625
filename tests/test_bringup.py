"""Platform plumbing that runs on the CPU: the compile-cache directory, the
default PRNG, the device-memory budget, the benchmark's peak table, the
trace reduction, the DAQ parity check at a small width, and chip_smoke.py's
refusal to run without a GPU."""
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

import wfsim_tpu
from wfsim_tpu.pipeline import rawdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_env():
    d = '/some/where/xla'
    assert wfsim_tpu.compile_cache_dir(
        {'JAX_COMPILATION_CACHE_DIR': d}) == d


def test_compile_cache_fixed_path_in_checkout():
    d = wfsim_tpu.compile_cache_dir({})
    assert d == os.path.join(REPO, '.jax_cache')
    # the same path in every process: no hash, pid or time in it
    assert wfsim_tpu.compile_cache_dir({}) == d


@pytest.mark.parametrize('env', [{'JAX_PLATFORMS': 'cpu'},
                                 {'JAX_PLATFORM_NAME': 'CPU'},
                                 {'WFSIM_TPU_NO_COMPILE_CACHE': '1'}])
def test_compile_cache_off_for_cpu_and_opt_out(env):
    assert wfsim_tpu.compile_cache_dir(
        dict(env, JAX_COMPILATION_CACHE_DIR='/x')) is None


@pytest.mark.parametrize('backend', ['gpu', 'tpu'])
def test_default_prng_is_threefry(monkeypatch, backend):
    from wfsim_tpu.config import default_config
    monkeypatch.setattr(jax, 'default_backend', lambda: backend)
    rd = rawdata.RawDataTPU(default_config(seed=3))
    assert 'threefry2x32' in str(jax.random.key_impl(rd.key))


def test_prng_impl_option_still_honoured():
    from wfsim_tpu.config import default_config
    rd = rawdata.RawDataTPU(dict(default_config(seed=3), prng_impl='rbg'))
    assert 'rbg' in str(jax.random.key_impl(rd.key))


def _fake_device(platform, stats):
    return types.SimpleNamespace(platform=platform, device_kind='fake',
                                 memory_stats=lambda: stats)


@pytest.mark.parametrize('platform,stats,expect', [
    ('gpu', {'bytes_limit': 60_000_000_000}, 45_000_000_000),
    ('cpu', None, 6_000_000_000),
    ('gpu', None, RuntimeError),
    ('gpu', {'bytes_in_use': 0}, RuntimeError),
])
def test_device_memory_budget(monkeypatch, platform, stats, expect):
    monkeypatch.setattr(rawdata, '_MEM_BUDGET_CACHE', None)
    monkeypatch.setattr(rawdata.jax, 'local_devices',
                        lambda: [_fake_device(platform, stats)])
    if expect is RuntimeError:
        with pytest.raises(RuntimeError, match='no memory limit'):
            rawdata._device_memory_budget()
    else:
        assert rawdata._device_memory_budget() == expect


def test_device_peaks_h100():
    import bench
    kind, peaks = bench._device_peaks('NVIDIA H100 80GB HBM3')
    assert kind == 'NVIDIA H100 80GB HBM3'
    assert peaks == dict(bf16_tflops=989.0, tf32_tflops=495.0,
                         f32_tflops=67.0, hbm_gbps=3350.0,
                         rated_power_w=700.0)
    assert bench._device_peaks(kind, '700.00 W')[1] is peaks


@pytest.mark.parametrize('limit', ['400.00 W', '699.9 W'])
def test_device_peaks_refuse_a_capped_card(limit):
    """A share of the 700 W peaks would understate a card held lower."""
    import bench
    with pytest.raises(ValueError, match='below the 700.0 W'):
        bench._device_peaks('NVIDIA H100 80GB HBM3', limit)


@pytest.mark.parametrize('text,watts', [('400.00 W', 400.0), ('700 W', 700.0),
                                        ('[N/A]', None), (None, None)])
def test_power_limit_parsing(text, watts):
    import bench
    assert bench._watts(text) == watts


@pytest.mark.parametrize('kind', ['NVIDIA H200', 'cpu',
                                  'NVIDIA A100-SXM4-40GB'])
def test_device_peaks_unknown_kind_raises(kind):
    import bench
    with pytest.raises(KeyError, match='no published peaks'):
        bench._device_peaks(kind)


def test_bench_device_info_refuses_cpu():
    import bench
    with pytest.raises(RuntimeError, match='needs a GPU'):
        bench.device_info()


def _trace(device_name):
    meta = [{'ph': 'M', 'name': 'process_name', 'pid': 1,
             'args': {'name': device_name}},
            {'ph': 'M', 'name': 'process_name', 'pid': 2,
             'args': {'name': '/host:CPU'}}]
    ev = [{'ph': 'X', 'pid': 1, 'ts': 0, 'dur': 10, 'name': 'fusion',
           'args': {'hlo_module': 'jit_gather_digitize(42)'}},
          {'ph': 'X', 'pid': 1, 'ts': 5, 'dur': 10, 'name': 'fusion.1',
           'args': {'hlo_module': 'jit_gather_digitize(42)'}},
          {'ph': 'X', 'pid': 1, 'ts': 40, 'dur': 20, 'name': 'jit_pack'},
          {'ph': 'X', 'pid': 2, 'ts': 0, 'dur': 100, 'name': 'host'}]
    return {'traceEvents': meta + ev}


def test_reduce_trace_gpu_lanes():
    from prof_trace_full import reduce_trace
    red = reduce_trace(_trace('/device:GPU:0 (pid 1)'))
    assert red['modules'][0] == ('jit_gather_digitize', 20, 2)
    assert ('jit_pack', 20, 1) in red['modules']
    # busy [0, 15] + [40, 60] of a 60 us span; one 25 us gap at 15 us
    assert red['busy_us'] == 35 and red['span_us'] == 60
    assert red['gaps'] == [(25, 15)]


def test_reduce_trace_without_gpu_lanes_raises():
    from prof_trace_full import reduce_trace
    with pytest.raises(ValueError, match='no GPU device lanes'):
        reduce_trace(_trace('/device:TPU:0'))


@pytest.mark.parametrize('seed', [0, 1])
def test_digitize_parity_check_small_width(seed):
    """The card's DAQ parity check, at a CPU-sized width."""
    from .gpu_checks import digitize_parity
    found = digitize_parity(seed=seed, n_channels=48, n_samples=1024,
                            n_photons=800, max_intervals=16)
    assert found['records'] > 0 and found['samples_compared'] > 0


def test_digitize_parity_check_rejects_a_wrong_sample(monkeypatch):
    """A payload sample off by one far from a rounding edge must fail."""
    from wfsim_tpu.pipeline import digitize
    from . import gpu_checks
    real = digitize.pack_records

    def corrupt(*a, **k):
        out = dict(real(*a, **k))
        out['rec_data'] = out['rec_data'].at[0, 0].add(1)
        return out
    monkeypatch.setattr(digitize, 'pack_records', corrupt)
    with pytest.raises(AssertionError, match='payload samples differ'):
        gpu_checks.digitize_parity(n_channels=16, n_samples=1024,
                                   n_photons=200, max_intervals=16)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('XLA_FLAGS', None)
    p = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    lines = p.stdout.strip().splitlines()
    assert lines and lines[0].startswith('[a] nvidia-smi')
    last = lines[-1]
    assert '"ok"' not in last
    with pytest.raises(json.JSONDecodeError):
        json.loads(last)


@pytest.mark.parametrize('budget,T,expect', [
    (6_000_000_000, 2048, 32),      # the CPU budget
    (45_000_000_000, 2048, 128),    # an H100's budget: the 128 ceiling
    (45_000_000_000, 4096, 64),     # the int32 histogram index binds
    (45_000_000_000, 1 << 20, 1),   # never below one window
])
def test_window_batch_cap(budget, T, expect):
    C, dt = 494, 10
    bytes_per_win = C * T * dt * 4 * 2 + 801 * T * 8 + 4096 * 16
    cap = rawdata._window_batch_cap(budget, bytes_per_win, C * dt * T)
    assert cap == expect
    assert cap * C * dt * T < 2 ** 31 or cap == 1
