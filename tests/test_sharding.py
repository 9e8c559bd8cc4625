"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wfsim_tpu.config import default_config
from wfsim_tpu.resources.loader import load_config
from wfsim_tpu.models.params import build_params, build_constants
from wfsim_tpu.parallel.sharding import make_mesh, make_sharded_step


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 virtual devices')
def test_sharded_step_events_by_channels():
    config = default_config()
    resource = load_config(config)
    params = build_params(config, resource)
    const = build_constants(config)

    mesh = make_mesh(4, 2)
    inst_per_shard = 4
    n_inst = inst_per_shard * mesh.shape['events']
    rng = np.random.default_rng(0)
    inst = dict(
        time=jnp.asarray((np.arange(n_inst) % inst_per_shard) * 100_000,
                         dtype=jnp.int32),
        x=jnp.asarray(rng.uniform(-40, 40, n_inst), dtype=jnp.float32),
        y=jnp.asarray(rng.uniform(-40, 40, n_inst), dtype=jnp.float32),
        z=jnp.asarray(rng.uniform(-90, -10, n_inst), dtype=jnp.float32),
        amp=jnp.asarray(rng.integers(50, 500, n_inst), dtype=jnp.int32),
        recoil=jnp.full(n_inst, 7, dtype=jnp.int32),
        type=jnp.asarray(np.tile([1, 2], n_inst // 2), dtype=jnp.int32),
        valid=jnp.ones(n_inst, dtype=bool),
        truth_row=jnp.asarray(np.arange(n_inst) % inst_per_shard,
                              dtype=jnp.int32),
    )
    step = make_sharded_step(params, const, mesh,
                             inst_per_shard=inst_per_shard,
                             photon_capacity=2048, electron_capacity=512,
                             n_samples=512)
    adc, sum_signal, totals = step(params, inst, jax.random.key(0))
    jax.block_until_ready((adc, sum_signal, totals))
    assert adc.ndim == 3
    assert int(totals[0]) > 0          # photons were produced
    assert int(totals[1]) >= int(totals[0])  # n_pe >= n_photon
    # grid is sharded over both mesh axes
    assert adc.shape[0] == mesh.shape['events']


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 virtual devices')
def test_sharded_pipeline_matches_single_device():
    """The PRODUCTION pipeline (Simulator -> RawDataTPU.iter_windows ->
    gather_digitize -> encoded transport) run over an 8-device 'events' mesh
    must produce exactly the records and truth of the single-device run:
    instruction and window batches are sharded, the partitionable-threefry
    draws are sharding-invariant, and the DAQ chain is integer."""
    from wfsim_tpu.dtypes import instruction_dtype
    from wfsim_tpu.interface.simulator import Simulator

    n = 12
    rng = np.random.default_rng(5)
    inst = np.zeros(2 * n, dtype=instruction_dtype)
    inst['event_number'] = np.repeat(np.arange(n), 2)
    inst['type'] = np.tile([1, 2], n)
    inst['time'] = np.repeat((np.arange(n) + 1) * 2_000_000, 2)
    r = np.sqrt(rng.uniform(0, 45 ** 2, n))
    th = rng.uniform(-np.pi, np.pi, n)
    inst['x'] = np.repeat(r * np.cos(th), 2)
    inst['y'] = np.repeat(r * np.sin(th), 2)
    inst['z'] = np.repeat(rng.uniform(-80, -20, n), 2)
    inst['amp'] = np.tile([600, 80], n)
    inst['recoil'] = 7

    c = default_config()
    c['seed'] = 11
    c['prng_impl'] = 'threefry2x32'   # match what the mesh path forces

    single = Simulator(dict(c)).get_arrays(inst.copy())
    mesh = make_mesh(8, 1)
    sharded = Simulator(dict(c), mesh=mesh).get_arrays(inst.copy())

    ra, rb = single['raw_records'], sharded['raw_records']
    assert len(ra) == len(rb) > 0
    for f in ra.dtype.names:
        np.testing.assert_array_equal(ra[f], rb[f], err_msg=f'records.{f}')
    ta, tb = single['truth'], sharded['truth']
    assert len(ta) == len(tb) == 2 * n
    for f in ('n_photon', 'n_pe', 'n_electron', 't_first_photon',
              't_last_photon', 'raw_area'):
        np.testing.assert_allclose(ta[f], tb[f], rtol=1e-6, atol=1e-6,
                                   err_msg=f'truth.{f}')


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 virtual devices')
def test_graft_entry_dryrun():
    import importlib.util
    spec = importlib.util.spec_from_file_location('graft', '__graft_entry__.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    mod.dryrun_multichip(8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 virtual devices')
def test_sharded_step_hlo_has_only_documented_collectives():
    """Compiled-HLO audit of the multi-chip step: the ONLY cross-device
    communication must be the documented reductions — the bottom-array
    sum-signal psum over 'channels' and the truth-aggregate psum over
    'events' (parallel/sharding.py:113-126).  Catches regressions where a
    layout/sharding change makes GSPMD insert all-gathers or reshards of
    the big per-shard arrays (photon buffers, waveform grid) — multi-chip
    efficiency evidenced on the compiler IR since real multi-chip hardware
    is unavailable here."""
    import re

    config = default_config()
    resource = load_config(config)
    params = build_params(config, resource)
    const = build_constants(config)

    mesh = make_mesh(4, 2)
    inst_per_shard = 4
    n_inst = inst_per_shard * mesh.shape['events']
    rng = np.random.default_rng(0)
    inst = dict(
        time=jnp.asarray((np.arange(n_inst) % inst_per_shard) * 100_000,
                         dtype=jnp.int32),
        x=jnp.asarray(rng.uniform(-40, 40, n_inst), dtype=jnp.float32),
        y=jnp.asarray(rng.uniform(-40, 40, n_inst), dtype=jnp.float32),
        z=jnp.asarray(rng.uniform(-90, -10, n_inst), dtype=jnp.float32),
        amp=jnp.asarray(rng.integers(50, 500, n_inst), dtype=jnp.int32),
        recoil=jnp.full(n_inst, 7, dtype=jnp.int32),
        type=jnp.asarray(np.tile([1, 2], n_inst // 2), dtype=jnp.int32),
        valid=jnp.ones(n_inst, dtype=bool),
        truth_row=jnp.asarray(np.arange(n_inst) % inst_per_shard,
                              dtype=jnp.int32),
    )
    step = make_sharded_step(params, const, mesh,
                             inst_per_shard=inst_per_shard,
                             photon_capacity=2048, electron_capacity=512,
                             n_samples=512)
    # run once to make sure it executes, then compile-inspect the jitted step
    adc, sum_signal, totals = step(params, inst, jax.random.key(0))
    jax.block_until_ready((adc, sum_signal, totals))

    # lower the same computation and read the compiled module text
    # (make_sharded_step returns a closure; lowering the closure compiles
    # the shard_map body it wraps)
    lowered = jax.jit(lambda p, i, k: step(p, i, k)).lower(
        params, inst, jax.random.key(0))
    txt = lowered.compile().as_text()

    # forbidden: data-moving collectives (a resharded big array shows up as
    # one of these)
    for bad in ('all-gather', 'all-to-all', 'collective-permute',
                'reduce-scatter'):
        assert bad not in txt, f'unexpected {bad} in compiled sharded step'

    # allowed: all-reduce (psum) — but only on SMALL aggregates (sum-signal
    # row + truth scalars), never on the waveform grid / photon buffers
    big = []
    for m in re.finditer(r'all-reduce[^=\n]*=\s*([a-z0-9]+)\[([0-9,]*)\]',
                         txt):
        dtype_s, shape_s = m.group(1), m.group(2)
        n_elem = 1
        for d in filter(None, shape_s.split(',')):
            n_elem *= int(d)
        itemsize = 8 if '64' in dtype_s else 4
        if n_elem * itemsize > 1_000_000:
            big.append((dtype_s, shape_s))
    assert not big, f'all-reduce on large arrays: {big}'
    assert 'all-reduce' in txt, \
        'expected the documented psum collectives in the compiled step'


@pytest.mark.skipif(len(jax.devices()) < 4, reason='needs 4 virtual devices')
def test_mesh_digitize_sorts_each_windows_photons_locally():
    """On the production mesh path the window batch of gather_digitize is
    sharded over 'events'; the phase histogram's sort runs along each
    window's photon axis, so each device sorts only its own windows and
    nothing is all-gathered."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from wfsim_tpu.pipeline.digitize import gather_digitize
    config = default_config()
    params = build_params(config, load_config(config))
    const = build_constants(config)
    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    B, n_cap, T = 8, 512, 256
    rng = np.random.default_rng(0)
    A = B * (n_cap - 64)
    rep = NamedSharding(mesh, P())
    ev = NamedSharding(mesh, P('events'))
    arena = [jax.device_put(jnp.asarray(a), rep) for a in (
        rng.integers(0, T * 10 - 300, A).astype(np.int32),
        rng.integers(0, const.n_tpc_pmts, A).astype(np.int32),
        rng.uniform(1e6, 3e6, A).astype(np.float32))]
    pieces = np.zeros((B, 4, 3), np.int32)
    for b in range(B):
        pieces[b, 0] = (b * (n_cap - 64), n_cap - 64, 0)
    txt = gather_digitize.lower(
        params, const, *arena, jax.device_put(jnp.asarray(pieces), ev),
        jax.device_put(jnp.zeros(B, jnp.int32), ev), n_samples=T,
        n_pieces=4, n_cap=n_cap, max_intervals=64).compile().as_text()
    assert 'all-gather' not in txt
    sorts = [ln for ln in txt.splitlines()
             if ' sort(' in ln and 'argsort' in ln]
    assert sorts, 'no histogram sort in the compiled program'
    for ln in sorts:
        assert f's32[{B // 4},{n_cap}]' in ln, ln
