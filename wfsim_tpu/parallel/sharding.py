"""Multi-chip scaling via jax.sharding + shard_map.

The reference is strictly single-process (SURVEY s2.4: no parallelism of any
kind); this module is where this framework goes beyond it.  The physics is
embarrassingly parallel in *events* (photons never interact), and the
digitization grid is embarrassingly parallel in *channels* except for the
bottom-array sum signal — so the natural mesh is

    Mesh(axes = ('events', 'channels'))

- instruction batches are sharded over 'events' (pure data parallelism —
  each device simulates its own events end-to-end);
- the per-window digitization grid is sharded over 'channels' (each chip owns
  a contiguous PMT block, builds its waveform from the full photon list, and
  runs ZLE locally);
- the only physics collective is a ``psum`` over the channel axis for the
  bottom-array sum-signal channel, plus an optional ``psum`` of truth
  aggregates over events.

Across hosts the work splits into independent instruction streams per
chunk — no collectives at all — matching SURVEY s5.8.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models.s1 import simulate_s1
from ..models.s2 import simulate_s2
from ..ops.waveform import photons_to_waveform

__all__ = ['make_mesh', 'make_sharded_step']


def make_mesh(n_events_axis: int = None, n_channel_axis: int = 1,
              devices=None) -> Mesh:
    """Create an ('events', 'channels') device mesh.  Defaults to all
    devices on the events axis."""
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    if n_events_axis is None:
        n_events_axis = n_dev // n_channel_axis
    assert n_events_axis * n_channel_axis == n_dev, \
        f'{n_events_axis} x {n_channel_axis} != {n_dev} devices'
    dev_array = np.array(devices).reshape(n_events_axis, n_channel_axis)
    return Mesh(dev_array, ('events', 'channels'))


def make_sharded_step(params, const, mesh: Mesh, *,
                      inst_per_shard: int = 8,
                      photon_capacity: int = 4096,
                      electron_capacity: int = 1024,
                      n_samples: int = 1024):
    """Build a jitted multi-chip simulation step.

    The returned function takes (params, inst, key) where ``inst`` is an
    instruction batch dict with leading axis = events_axis * inst_per_shard,
    interleaved S1/S2 as marked by inst['type'], and returns per-shard
    waveform grids (sharded over both mesh axes) and psum-aggregated truth
    counters — one full step of simulate -> digitize, the unit that a
    multi-chip production run repeats per chunk.
    """
    n_ch_shards = mesh.shape['channels']
    C = int(const.n_tpc_pmts)
    C_pad = -(-C // n_ch_shards) * n_ch_shards
    C_loc = C_pad // n_ch_shards

    inst_spec = {k: P('events') for k in
                 ('time', 'x', 'y', 'z', 'amp', 'recoil', 'type', 'valid',
                  'truth_row')}

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), inst_spec, P('events')),
             out_specs=(P('events', 'channels'), P('events'), P()),
             check_vma=False)  # truth counters replicate over 'channels'
    def step(p, inst, keys):
        key = keys[0]
        k1, k2, k3 = jax.random.split(key, 3)
        # simulate both chains on the local instruction shard; validity masks
        # select which instructions feed which chain
        inst_s1 = dict(inst, valid=inst['valid'] & (inst['type'] == 1))
        inst_s2 = dict(inst, valid=inst['valid'] & (inst['type'] == 2))
        inst_s1.pop('type'); inst_s2.pop('type')
        ph1, truth1, _ = simulate_s1(p, const, inst_s1, k1,
                                     capacity=photon_capacity,
                                     n_truth_rows=inst_per_shard)
        ph2, truth2, _ = simulate_s2(p, const, inst_s2, k2,
                                     e_capacity=electron_capacity,
                                     capacity=photon_capacity,
                                     n_truth_rows=inst_per_shard)
        t = jnp.concatenate([ph1['t'], ph2['t']])
        ch = jnp.concatenate([ph1['ch'], ph2['ch']])
        gain = jnp.concatenate([ph1['gain'], ph2['gain']])
        valid = jnp.concatenate([ph1['valid'], ph2['valid']])

        # channel-block shard of the digitization grid: each chip keeps only
        # photons landing in its PMT block
        ch_block = jax.lax.axis_index('channels') * C_loc
        ch_loc = ch - ch_block
        in_block = (ch_loc >= 0) & (ch_loc < C_loc)
        W = photons_to_waveform(t, jnp.where(in_block, ch_loc, 0),
                                gain, valid & in_block, 0, p.templates,
                                n_channels=C_loc, n_samples=n_samples,
                                sample_duration=const.sample_duration)
        adc = (-jnp.round(W * const.current_2_adc)).astype(jnp.int32)

        # bottom-array sum signal needs a cross-chip reduction over the
        # channel axis (the one physics collective)
        ch_ids = ch_block + jnp.arange(C_loc)
        bottom = (ch_ids >= const.n_top_pmts) & (ch_ids < C)
        local_sum = jnp.sum(jnp.where(bottom[:, None], adc, 0), axis=0,
                            keepdims=False)
        sum_signal = jax.lax.psum(local_sum, 'channels')

        # aggregate truth across event shards
        n_photon = jax.lax.psum(
            truth1['n_photon'].sum() + truth2['n_photon'].sum(), 'events')
        n_pe = jax.lax.psum(
            truth1['n_pe'].sum() + truth2['n_pe'].sum(), 'events')
        totals = jnp.stack([n_photon, n_pe])
        return adc[None], sum_signal[None], totals

    def run(p, inst, key):
        n_ev = mesh.shape['events']
        keys = jax.random.split(key, n_ev)
        return jax.jit(step)(p, inst, keys)

    return run
