"""Host-side orchestration: instructions -> photon pool -> digitized pulses.

Device-batched restructuring of the reference event loop
(reference: wfsim/core/rawdata.py:38-157).  The reference interleaves
simulation and digitization cluster by cluster in one sequential generator;
here the dataflow is phase-parallel:

 A) cluster instructions by *signal arrival time* (S2-types shifted by
    z / v_drift; same odd/even type convention, rawdata.py:58-63);
 B) simulate ALL primary instructions in large padded device batches
    (S1 chain, S2 chain), including PMT afterpulses;
 C) generate electron-afterpulse instructions (pi_el / pe_el) from the
    primaries' photon statistics and simulate them the same way — this is the
    feedback edge of the reference (rawdata.py:133-140), unrolled: the
    reference's secondary generation terminates after one step because only
    type-2 (s2) pulses spawn electron afterpulses (rawdata.py:193-201);
 D) group pulse extents into digitization windows (flush-on-gap rule,
    rawdata.py:96-98) and run the fused digitize+ZLE kernel per window;
 E) yield (channel, left, right, data) pulses exactly like the reference
    generator, so the chunker is interchangeable.

Absolute times are int64 on the host; the device only ever sees int32 offsets
from per-batch/per-window bases.
"""
from __future__ import annotations

import logging
import time
import typing as ty
from concurrent import futures
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import finalize_config
from ..dtypes import PULSE_TYPE_NAMES
from ..resources.loader import load_config
from ..models.params import build_params, build_constants
from ..models.s1 import simulate_s1, s1_photon_demand
from ..models.s2 import simulate_s2, s2_photon_demand
from ..models.afterpulse import (
    pmt_afterpulse_photons, photon_summaries,
    generate_pi_el_instructions, generate_pe_el_instructions)
from .digitize import digitize_window
from ..diagnostics import Timers

log = logging.getLogger('wfsim_tpu.core')

__all__ = ['RawDataTPU']


def _bucket(n, lo=256, hi=2 ** 26):
    # hi is a sanity guard, not a size hint: callers that can legitimately
    # exceed it must pass a larger cap (silent clamping truncates device
    # buffers — the 2^22 default once dropped value-stream data on
    # high-volume chunks)
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


_MEM_BUDGET_CACHE = None


def _device_memory_budget():
    """Usable device-memory budget in bytes for digitize batch sizing.

    Three quarters of the limit the device reports
    (``memory_stats()['bytes_limit']``), leaving room for the simulation
    buffers and XLA scratch.  The CPU backend reports no limit and gets a
    fixed 6 GB; an accelerator that reports none is an error, because a
    guess either wastes the card or runs it out of memory.
    """
    global _MEM_BUDGET_CACHE
    if _MEM_BUDGET_CACHE is None:
        dev = jax.local_devices()[0]
        if dev.platform == 'cpu':
            budget = int(6e9)
        else:
            limit = (dev.memory_stats() or {}).get('bytes_limit', 0)
            if not limit:
                raise RuntimeError(
                    f'{dev.device_kind} ({dev.platform}) reports no memory '
                    'limit; cannot size digitize batches')
            budget = int(limit * 0.75)
        _MEM_BUDGET_CACHE = budget
    return _MEM_BUDGET_CACHE


def _window_batch_cap(budget, bytes_per_win, hist_cells_per_win):
    """Windows per digitize call, a power of two (shape bucketing): as many
    as the memory budget holds, few enough that the batch's phase
    histogram (``hist_cells_per_win`` cells per window) holds fewer than
    2^31 cells, so int32 indices over the batch grid stay in range, and at
    most 128, which keeps the pack's 2-word bit-packed
    interval meta applicable (w*2048+c needs <= 18 bits) and bounds the
    transient grid working set."""
    b = min(budget // bytes_per_win, (2 ** 31 - 1) // hist_cells_per_win,
            128)
    return 2 ** int(np.log2(max(b, 1)))


_sim_s1_jit = jax.jit(simulate_s1, static_argnames=('const', 'capacity',
                                                    'n_truth_rows'))
_sim_s2_jit = jax.jit(simulate_s2, static_argnames=('const', 'e_capacity',
                                                    'capacity', 'n_truth_rows'))
_s1_demand_jit = jax.jit(s1_photon_demand, static_argnames=('const',))
_s2_demand_jit = jax.jit(s2_photon_demand,
                         static_argnames=('const', 'e_capacity'))


@jax.jit
def _flat_concat_mixed(int_arrays, float_arrays):
    """ravel+cast+concat of a whole fetch tree as ONE program and ONE int32
    buffer (floats bit-cast, so the values roundtrip exactly); retraces per
    (shapes, dtypes) signature, which the bucketed caps keep bounded.  The
    eager formulation dispatched 2N+1 small programs per pack and two
    blocking transfers per fetch."""
    parts = [jnp.ravel(a).astype(jnp.int32) for a in int_arrays]
    parts += [jax.lax.bitcast_convert_type(
        jnp.ravel(a).astype(jnp.float32), jnp.int32) for a in float_arrays]
    return jnp.concatenate(parts)


@jax.jit
def _split_pieces_jit(buf):
    """Split the packed (B, P*3+1) digitize-dispatch upload back into the
    (B, P, 3) piece table and the (B,) noise offsets."""
    B = buf.shape[0]
    return buf[:, :-1].reshape(B, -1, 3), buf[:, -1]


@partial(jax.jit, static_argnames=('names',))
def _unpack_inst_jit(buf, names):
    """Split a packed (F, icap) int32 instruction upload back into the
    per-field dict the sim kernels take (see _make_inst_batch): float
    fields were bit-cast on the host, bools ride as 0/1."""
    out = {}
    for i, (nm, kind) in enumerate(names):
        row = buf[i]
        if kind == 'f':
            out[nm] = jax.lax.bitcast_convert_type(row, jnp.float32)
        elif kind == 'b':
            out[nm] = row.astype(bool)
        else:
            out[nm] = row
    return out


def _start_sliced_copies(arrays, target_bytes=16_000_000):
    """Begin async device->host copies of `arrays` in ~16 MB slices; returns
    a token for `_collect_sliced`.

    Every slice is its own device op and every collect a blocking wait,
    so slices are kept large and sub-slicing is skipped entirely for
    buffers under 2x the target; whether slicing pays at all over PCIe is
    unmeasured on H100 (ROADMAP C1).  Splitting start/collect lets the
    caller overlap host-side work on early arrays with later transfers.
    """
    token = []
    for a in arrays:
        n = int(a.shape[0])
        if a.nbytes <= 2 * target_bytes or n <= 1:
            sl = [a]
        else:
            k = min(max(1, int(round(a.nbytes / target_bytes))), n)
            bounds = np.linspace(0, n, k + 1).astype(int)
            sl = [a[bounds[i]:bounds[i + 1]] for i in range(k)
                  if bounds[i + 1] > bounds[i]] or [a]
        for s in sl:
            try:
                s.copy_to_host_async()
            except Exception:
                pass
        token.append(sl)
    return token


def _collect_sliced(token):
    """Block on and reassemble arrays whose copies were started by
    `_start_sliced_copies`."""
    out = []
    for sl in token:
        parts = [np.asarray(s) for s in sl]
        out.append(parts[0] if len(parts) == 1
                   else np.concatenate(parts, axis=0))
    return out


def _fetch_in_slices(arrays, target_bytes=3_000_000):
    """One-shot sliced fetch (start + collect)."""
    return _collect_sliced(_start_sliced_copies(arrays, target_bytes))


class _Pulse(ty.NamedTuple):
    """Host record of one simulated instruction-group's photons (a contiguous
    slot range in one registered device photon buffer)."""
    inst_idx: np.ndarray      # indices into the instruction array
    buf: int                  # photon-buffer id (RawDataTPU._buffers key)
    buf_start: int            # first slot within that buffer
    pool_count: int
    t_min: int                # abs ns (first photon)
    t_max: int                # abs ns (last photon)
    truth_key: int
    event_number: int
    base_time: int            # abs ns base of the buffer's relative times


class RawDataTPU:
    """Drop-in behavioural equivalent of the reference ``RawData``.

    Pass ``mesh`` (a :class:`jax.sharding.Mesh` with an ``'events'`` axis,
    see :func:`wfsim_tpu.parallel.sharding.make_mesh`) to run the SAME
    pipeline multi-chip: instruction batches and window batches are sharded
    over the 'events' axis and XLA partitions the already-batched kernels
    (GSPMD), so the sharded run produces the same records/truth as the
    single-device run (the default PRNG, partitionable threefry, draws the
    same numbers under any sharding).  The reference has no parallelism of
    any kind (SURVEY §2.4); this is where this framework goes beyond it.
    """

    #: process-level record-arena high-water mark (rows) — see _arena_alloc
    _arena_hw = 0
    #: process-level high-water fraction of records whose masks escape the
    #: compact 2-run transport form (see _pack_digitize); starts at the
    #: measured realistic-config average + margin, raised on overflow.
    #: Deliberately NOT lowered adaptively: the bound feeds device slice /
    #: concat shapes, and a drifting bound recompiles those programs every
    #: round for ~1-2 MB of transfer — the payload_mesc_rows/shipped diag
    #: counters quantify the padding instead
    _mesc_frac = 0.25

    def __init__(self, config, mesh=None, **kwargs):
        self.config = finalize_config(dict(config))
        self.resource = load_config(self.config)
        # build_params records AP-table metadata into config before
        # build_constants snapshots it
        self.params = build_params(self.config, self.resource)
        self.const = build_constants(self.config)
        seed = self.config.get('seed') or 0
        self.rng = np.random.default_rng(seed if seed else None)
        # bench-only: run the FULL device pipeline (sim, digitize, encode,
        # pack) but never start the payload copies and skip the host
        # decode — measures the device-bound throughput ceiling (records
        # come back empty; truth is unaffected)
        self._device_ceiling = bool(
            self.config.get('_bench_device_ceiling', False))
        self.mesh = mesh
        self._ev_shards = int(mesh.shape['events']) if mesh is not None else 1
        # threefry2x32 on every platform: counter-based, and with
        # partitionable threefry its draws do not depend on the sharding, so
        # a mesh run reproduces the single-device run of the same seed
        impl = self.config.get('prng_impl', 'threefry2x32')
        if mesh is not None and impl != 'threefry2x32':
            log.warning(
                "mesh run with prng_impl=%r: this generator's draws "
                'depend on the sharding, so records/truth will change '
                'with the device count; use threefry2x32 for '
                'sharding-invariant output (PARITY.md deviation 2)', impl)
        self.key = jax.random.key(
            seed if seed else np.random.randint(2 ** 31), impl=impl)
        self._key_ctr = 0
        self.source_finished = False
        self.last_pulse_end_time = -np.inf
        self._pipeline_live = False
        self._rec_arena = None
        self._rec_arena_used = 0
        self._rec_run_rows = 0
        self.diag = Timers()
        self._validate_model_types()
        # exact upper bound on the S1 light yield (multilinear interpolation
        # never exceeds the grid max) — sizes S1 photon buffers by expected
        # yield instead of the quanta count (was ~5x oversized)
        try:
            lce_max = float(np.max(np.asarray(self.params.s1_lce.values)))
        except Exception:
            lce_max = 1.0
        self._s1_ly_bound = min(
            max(lce_max, 0.0) / (1 + float(self.config['p_double_pe_emision']))
            * float(self.config.get('s1_detection_efficiency', 1.0)), 1.0)

    # -- utilities ---------------------------------------------------------

    def _next_key(self):
        self._key_ctr += 1
        return jax.random.fold_in(self.key, self._key_ctr)

    def _validate_model_types(self):
        """Fail bad model strings at construction, not mid-trace.

        The reference validates s1_model_type up front (s1.py:50-58) but lets
        bad S2 model strings fail deep inside the chain (s2.py:380,503); here
        all three selectors are checked before any device work is queued.
        """
        valid = {'', 'simple', 'custom', 'optical_propagation', 'nest'}
        s = str(self.config['s1_model_type'])
        for part0 in s.split('+'):
            for part1 in part0.split(' '):
                for part in part1.split(','):
                    assert part in valid, \
                        f'Model type "{part}" not in {sorted(valid)}'
        lum = str(self.config['s2_luminescence_model'])
        valid_lum = {'simple', 'garfield', 'garfield_gas_gap'}
        assert lum in valid_lum, \
            f's2_luminescence_model "{lum}" not in {sorted(valid_lum)}'
        tm = str(self.config['s2_time_model'])
        valid_tm = ('optical_propagation', 'zero_delay',
                    's2_time_spread around zero')
        assert any(v in tm for v in valid_tm), \
            f's2_time_model "{tm}" must contain one of {valid_tm}'

    @staticmethod
    def symtype(ptype):
        return PULSE_TYPE_NAMES[ptype]

    def _arrival_times(self, instructions):
        v = self.config['drift_velocity_liquid']
        return (instructions['time']
                + (instructions['z'] / v
                   * (instructions['type'] % 2 - 1)).astype(np.int64))

    # -- simulation --------------------------------------------------------

    def _shard_events(self, a):
        """Place a batch-leading device array sharded over the mesh 'events'
        axis (no-op without a mesh; replicates when the dim doesn't divide)."""
        if self.mesh is None:
            return a
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = P('events') if a.shape[0] % self._ev_shards == 0 else P()
        return jax.device_put(a, NamedSharding(self.mesh, spec))

    def _replicate(self, a):
        """Replicate a device array over the mesh (no-op without a mesh)."""
        if self.mesh is None:
            return a
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(a, NamedSharding(self.mesh, P()))

    def _make_inst_batch(self, instructions, idx, base_time, truth_rows, n_rows):
        """Pad a host instruction selection into a device batch dict.

        Single-chip path: every field rides ONE (F, icap) int32 upload
        (floats bit-cast) + one jitted unpack program — the per-field
        formulation paid 8-10 host-to-device transfers per prepared
        batch.  Mesh runs keep the per-field device_put so each field gets
        its explicit 'events' sharding."""
        icap = _bucket(max(len(idx), 1), lo=max(8, self._ev_shards),
                       hi=2 ** 16)
        sel = instructions[idx]
        n = len(idx)
        # (name, host values, kind) in kernel-input order; padding slots of
        # truth_row carry the LAST row (not 0) so the per-photon truth_row
        # stays ascending — the truth counters are cumsum-based segment sums
        # that require sorted ids (models/pmt.py); padded contributions are
        # masked to zero either way
        fields = [
            ('time', (sel['time'] - base_time).astype(np.int64), 'i', 0),
            ('x', sel['x'], 'f', 0),
            ('y', sel['y'], 'f', 0),
            ('z', sel['z'], 'f', 0),
            ('amp', sel['amp'], 'i', 0),
            ('recoil', sel['recoil'], 'i', 0),
        ]
        if 'local_field' in sel.dtype.names:
            fields.append(('local_field', sel['local_field'], 'f', 0))
        if 'e_dep' in sel.dtype.names:
            fields.append(('e_dep', sel['e_dep'], 'f', 0))
        fields.append(('valid', np.ones(n, bool), 'b', 0))
        fields.append(('truth_row', truth_rows, 'i', n_rows - 1))

        if self.mesh is None:
            buf = np.empty((len(fields), icap), np.int32)
            for i, (_, x, kind, fill) in enumerate(fields):
                row = buf[i]
                row[n:] = fill
                if kind == 'f':
                    row[:n] = np.asarray(x, np.float32).view(np.int32)
                else:
                    row[:n] = np.asarray(x).astype(np.int32)
            names = tuple((nm, kind) for nm, _, kind, _ in fields)
            return _unpack_inst_jit(jnp.asarray(buf), names), icap

        out = {}
        for nm, x, kind, fill in fields:
            dtype = {'i': np.int32, 'f': np.float32, 'b': bool}[kind]
            a = np.full(icap, fill, dtype=dtype)
            a[:n] = x
            out[nm] = self._shard_events(jnp.asarray(a))
        return out, icap

    def _prepare_type_batch(self, instructions, idx, kind):
        """Host-side batch prep: truth-row layout, padded instruction batch,
        RNG key and capacity bounds — everything needed to dispatch either
        the demand pre-pass or the full kernel."""
        base_time = int(np.min(instructions['time'][idx]))
        # truth rows: one per instruction for s1/s2 (save_full_truth, the
        # default), or grouped — S1s within 100 ns, S2s within 2 mm of drift —
        # when save_full_truth is off (reference: rawdata.py:110-123); one
        # shared row per batch for afterpulse types (rawdata.py:124-125)
        if kind in ('s1', 's2'):
            if self.config.get('save_full_truth', True):
                truth_rows = np.arange(len(idx), dtype=np.int32)
            else:
                # group on signal-arrival times like the reference buffer
                arrival = self._arrival_times(instructions[idx])
                if kind == 's1':
                    gap = 100
                else:
                    gap = int(0.2 / self.config['drift_velocity_liquid'])
                new_grp = np.concatenate([[True], np.diff(arrival) > gap])
                truth_rows = (np.cumsum(new_grp) - 1).astype(np.int32)
            n_rows = int(truth_rows.max()) + 1
            row_members = [list(np.nonzero(truth_rows == r)[0])
                           for r in range(n_rows)]
        else:
            # afterpulse types: one truth row per arrival cluster (the
            # reference simulates all same-type secondaries of one buffer
            # cluster in a single call, rawdata.py:124-125)
            arrival = self._arrival_times(instructions[idx])
            rext = int(self.config['right_raw_extension'])
            new_grp = np.concatenate([[True], np.diff(arrival) > rext])
            truth_rows = (np.cumsum(new_grp) - 1).astype(np.int32)
            n_rows = int(truth_rows.max()) + 1
            row_members = [list(np.nonzero(truth_rows == r)[0])
                           for r in range(n_rows)]
        n_rows_cap = _bucket(n_rows, lo=8, hi=2 ** 16)

        inst, icap = self._make_inst_batch(instructions, idx, base_time,
                                           truth_rows, n_rows_cap)
        amps = instructions['amp'][idx].astype(np.float64)
        ecap = _bucket(int(amps.sum()) + 64, lo=256) if kind != 's1' else 0
        return dict(kind=kind, idx=idx, base_time=base_time,
                    truth_rows=truth_rows, row_members=row_members,
                    n_rows_cap=n_rows_cap, inst=inst, icap=icap,
                    amps=amps, ecap=ecap, key=self._next_key())

    def _conservative_cap(self, prep):
        """Worst-case photon capacity when no demand pre-pass ran."""
        amps = prep['amps']
        if prep['kind'] == 's1':
            mean = amps.sum() * self._s1_ly_bound
            return _bucket(int(mean + 6.0 * np.sqrt(max(mean, 1.0))) + 64)
        sc = (self.config['s2_secondary_sc_gain']
              / (1 + self.config['p_double_pe_emision']))
        return _bucket(int(amps.sum() * max(sc, 1.0) * 1.4) + 256)

    def _dispatch_demand(self, prep):
        """Queue the (tiny) exact photon-demand kernel for a prepared batch;
        same key and shapes as the full kernel, so the draws agree."""
        if prep['kind'] == 's1':
            return _s1_demand_jit(self.params, self.const, prep['inst'],
                                  prep['key'])
        return _s2_demand_jit(self.params, self.const, prep['inst'],
                              prep['key'], e_capacity=prep['ecap'])

    def _dispatch_prepared(self, prep, want_gen, cap):
        """Launch all device work for one prepared batch at photon capacity
        ``cap`` and return a job handle.  Nothing here blocks on the device,
        so compute for many batches pipelines; the results are collected
        later by :meth:`_finalize_type_batch`."""
        kind, idx = prep['kind'], prep['idx']
        base_time = prep['base_time']
        n_rows_cap = prep['n_rows_cap']
        row_members = prep['row_members']
        inst, key, ecap = prep['inst'], prep['key'], prep['ecap']
        if kind == 's1':
            photons, truth, totals = _sim_s1_jit(
                self.params, self.const, inst, key,
                capacity=cap, n_truth_rows=n_rows_cap)
        else:
            photons, truth, totals = _sim_s2_jit(
                self.params, self.const, inst, key,
                e_capacity=ecap, capacity=cap, n_truth_rows=n_rows_cap)

        job = dict(kind=kind, idx=idx, base_time=base_time,
                   row_members=row_members, n_rows_cap=n_rows_cap,
                   inst=inst, key=key, cap=cap, ecap=ecap,
                   photons=photons,
                   fetch_trees={'truth':
                                dict(truth, _req=totals['req_counts'])})

        if self.const.enable_pmt_afterpulses and \
                self.params.pmt_ap_delay_cdf is not None:
            ap_cap = _bucket(max(cap // 16, 256))
            ap_key = self._next_key()
            ap_photons, ap_info = pmt_afterpulse_photons(
                self.params, self.const, photons, ap_key,
                ap_capacity=ap_cap, n_truth_rows=n_rows_cap)
            job.update(ap_photons=ap_photons, ap_key=ap_key, ap_cap=ap_cap)
            job['fetch_trees']['ap'] = {
                k: ap_info[k] for k in ('counts', 't_min', 't_max', 'total')}

        if want_gen and kind == 's2' and (
                self.const.enable_electron_afterpulses
                or self.const.enable_gate_afterpulses):
            summ_key = self._next_key()
            counts_d, tz_d = photon_summaries(photons, summ_key,
                                              n_inst=n_rows_cap)
            job['summ_key'] = summ_key
            job['fetch_trees']['summ'] = dict(counts=counts_d, tz=tz_d)
        return job

    def _dispatch_type_batch(self, instructions, idx, kind, want_gen):
        """Legacy one-shot dispatch (subclass override point; the production
        loop uses prepare + batched demand pre-pass + dispatch instead)."""
        prep = self._prepare_type_batch(instructions, idx, kind)
        return self._dispatch_prepared(prep, want_gen,
                                       self._conservative_cap(prep))

    def _pack_job_group(self, jobs):
        """Merge every job's pending ``fetch_trees`` (truth / afterpulse /
        summary device arrays) into ONE shared :meth:`_pack_device` transfer
        pair, so a super-batch pays one blocking wait for ALL its sim
        results instead of one per pack — with afterpulses on that is up to
        nine packs (truth+ap per s1/s2/pi_el/pe_el job plus the s2
        summary).
        Jobs without ``fetch_trees`` (e.g. the optical subclass's own packed
        jobs) pass through untouched."""
        tree = {}
        shared = {'handle': None, 'host': None}
        for ji, job in enumerate(jobs):
            trees = job.pop('fetch_trees', None)
            if not trees:
                continue
            job['ji'] = ji
            job['group_fetch'] = shared
            for g, sub in trees.items():
                for k, v in sub.items():
                    tree[f'{ji}|{g}|{k}'] = v
        if tree:
            shared['handle'] = self._pack_device(tree)

    def _job_fetched(self, job, group):
        """This job's host-side dict for ``group`` ('truth'/'ap'/'summ') out
        of the shared group pack; None if the job wasn't group-packed or has
        no such group.  The first call blocks on the one stacked transfer."""
        if 'group_fetch' not in job:
            return None
        trees = job.get('fetched')
        if trees is None:
            shared = job['group_fetch']
            if shared['host'] is None:
                t0 = time.perf_counter()
                shared['host'] = self._unpack_host(*shared['handle'])
                self.diag.seconds['sim_group_fetch'] += \
                    time.perf_counter() - t0
            ji = str(job['ji'])
            trees = {}
            for key, arr in shared['host'].items():
                j, g, k = key.split('|', 2)
                if j == ji:
                    trees.setdefault(g, {})[k] = arr
            job['fetched'] = trees
        return trees.get(group)

    def _finalize_type_batch(self, job, instructions, truth_sink, gen_sink):
        """Collect one dispatched batch: fetch packed summaries (blocking, but
        the device compute was already queued and the whole super-batch's
        results ride one stacked transfer), handle rare capacity overflows,
        register photons in the arena and emit truth rows."""
        kind, idx = job['kind'], job['idx']
        base_time = job['base_time']
        n_rows_cap = job['n_rows_cap']
        photons = job['photons']

        truth_h = self._job_fetched(job, 'truth')
        truth_h = (dict(truth_h) if truth_h is not None
                   else self._unpack_host(*job['truth_pack']))
        ap_h = self._job_fetched(job, 'ap')
        summ_h = self._job_fetched(job, 'summ')
        req = truth_h.pop('_req')[:len(idx)]

        cap = job['cap']
        for _attempt in range(6):
            if int(req.sum()) <= cap:
                break
            cap = _bucket(max(int(req.sum()), cap * 2))
            if kind == 's1':
                photons, truth, totals = _sim_s1_jit(
                    self.params, self.const, job['inst'], job['key'],
                    capacity=cap, n_truth_rows=n_rows_cap)
            else:
                photons, truth, totals = _sim_s2_jit(
                    self.params, self.const, job['inst'], job['key'],
                    e_capacity=job['ecap'], capacity=cap,
                    n_truth_rows=n_rows_cap)
            job['photons'] = photons
            truth_h = self._fetch_packed(
                dict(truth, _req=totals['req_counts']))
            req = truth_h.pop('_req')[:len(idx)]
            if 'ap_photons' in job:
                ap_photons, ap_info = pmt_afterpulse_photons(
                    self.params, self.const, photons, job['ap_key'],
                    ap_capacity=job['ap_cap'], n_truth_rows=n_rows_cap)
                job['ap_photons'] = ap_photons
                ap_h = self._fetch_packed(
                    {k: ap_info[k] for k in ('counts', 't_min', 't_max',
                                             'total')})
            if 'summ_key' in job:
                # the electron-afterpulse instructions derive from these
                # photon statistics — recompute from the UNtruncated retry
                # photons (same key, so the thinning draws agree)
                counts_d, tz_d = photon_summaries(photons, job['summ_key'],
                                                  n_inst=n_rows_cap)
                summ_h = self._fetch_packed(dict(counts=counts_d, tz=tz_d))
        else:
            raise RuntimeError('photon capacity runaway')

        ap_photons = None
        if 'ap_photons' in job:
            ap_photons = job['ap_photons']
            if ap_h is None:
                ap_h = self._unpack_host(*job['ap_pack'])
            ap_cap = job['ap_cap']
            for _attempt in range(6):
                if int(ap_h['total']) <= ap_cap:
                    break
                ap_cap = _bucket(int(ap_h['total']))
                ap_photons, ap_info = pmt_afterpulse_photons(
                    self.params, self.const, photons, job['ap_key'],
                    ap_capacity=ap_cap, n_truth_rows=n_rows_cap)
                ap_h = self._fetch_packed(
                    {k: ap_info[k] for k in ('counts', 't_min', 't_max',
                                             'total')})
            else:
                raise RuntimeError('afterpulse capacity runaway')
            # PMT-afterpulse photon accounting (bench fairness: these ride
            # the device digitize but are not in the truth n_photon sums)
            self.diag.add('pmt_ap_photons', int(ap_h['total']))
        else:
            ap_h = None

        # electron-afterpulse feedback: only true S2 pulses spawn them
        # (reference: rawdata.py:193-201)
        if gen_sink is not None and summ_h is not None:
            counts_h = summ_h['counts'][:len(idx)]
            tz_h = summ_h['tz'][:len(idx)]
            src = instructions[idx]
            if self.const.enable_electron_afterpulses and \
                    getattr(self.resource, 'uniform_to_ele_ap', None) is not None:
                gen_sink.append(generate_pi_el_instructions(
                    self.config, self.resource, self.rng, counts_h, tz_h,
                    src, base_time))
            if self.const.enable_gate_afterpulses:
                gen_sink.append(generate_pe_el_instructions(
                    self.config, self.rng, counts_h, tz_h, src, base_time))

        # ---- arena registration (range-based; no per-row scans) ----
        t0 = time.perf_counter()
        self._pool_append(photons, ap_photons, ap_h, idx, instructions,
                          base_time, truth_h, req, job['row_members'], kind,
                          truth_sink)
        self.diag.seconds['sim_pool_append'] += time.perf_counter() - t0

    def _append_buffer(self, photons, base_time):
        """Register a DEVICE photon buffer (no transfer); returns its id.
        Buffers stay registered until no pending pulse references them —
        each digitize round builds its arena from the buffers its window
        batch actually needs, so pipelined rounds can defer boundary pulses
        without holding every buffer alive."""
        bid = self._buf_ctr
        self._buf_ctr += 1
        self._buffers[bid] = (photons, int(base_time))
        return bid

    @staticmethod
    def _pack_device(tree):
        """Concatenate a dict of device arrays into at most two flat device
        arrays (int32 + float32) so fetching costs two transfers, not one per
        field.  Returns (groups, spec); nothing blocks — the device->host
        copies are STARTED here (async, queued behind the producing
        kernels), so the later blocking unpack waits for no transfer
        latency per batch.

        The whole tree rides ONE jitted ravel/cast/concat program and ONE
        int32 device buffer (floats bit-cast): the eager formulation
        dispatched 2N+1 lazy ops per pack and two blocking transfers per
        fetch."""
        items = sorted(tree.items())
        ints = [(k, v) for k, v in items
                if jnp.issubdtype(v.dtype, jnp.integer) or v.dtype == bool]
        flts = [(k, v) for k, v in items
                if not (jnp.issubdtype(v.dtype, jnp.integer) or v.dtype == bool)]
        buf = _flat_concat_mixed([v for _, v in ints], [v for _, v in flts])
        spec = ([(k, v.shape, 'i') for k, v in ints]
                + [(k, v.shape, 'f') for k, v in flts])
        try:
            buf.copy_to_host_async()
        except Exception:
            pass
        return buf, spec

    @staticmethod
    def _unpack_host(buf, spec):
        """Blocking fetch + unpack of a _pack_device result."""
        host = np.asarray(buf)
        out = {}
        o = 0
        for k, shape, kind in spec:
            n = int(np.prod(shape))
            part = host[o:o + n]
            if kind == 'f':
                part = part.view(np.float32)
            out[k] = part.reshape(shape)
            o += n
        return out

    def _fetch_packed(self, tree):
        """device_get a dict of arrays with at most two transfers."""
        return self._unpack_host(*self._pack_device(tree))

    def _pool_append(self, photons, ap_photons, ap_h, idx, instructions,
                     base_time, truth_h, req, row_members, kind, truth_sink):
        off = np.concatenate([[0], np.cumsum(req)]).astype(np.int64)

        prim_buf = self._append_buffer(photons, base_time)

        ap_buf = None
        if ap_photons is not None:
            ap_off = np.concatenate(
                [[0], np.cumsum(ap_h['counts'])]).astype(np.int64)
            ap_buf = self._append_buffer(ap_photons, base_time)

        for r, members in enumerate(row_members):
            n_primary = int(truth_h['photon_count'][r])
            trow = self._assemble_truth_row(
                kind, truth_h, r, base_time, instructions[idx][members],
                n_primary)
            if trow is not None:
                truth_sink.append(trow)
            ev = int(instructions[idx[members[0]]]['event_number'])

            if n_primary > 0:
                slot_lo = int(off[members[0]])
                cnt = int(off[members[-1] + 1] - slot_lo)
                self._pulses.append(_Pulse(
                    inst_idx=np.asarray(idx)[members],
                    buf=prim_buf, buf_start=slot_lo, pool_count=cnt,
                    t_min=int(truth_h['photon_t_min'][r]) + base_time,
                    t_max=int(truth_h['photon_t_max'][r]) + base_time,
                    truth_key=len(truth_sink) - 1, event_number=ev,
                    base_time=base_time))

            if ap_buf is not None and int(ap_h['counts'][r]) > 0:
                self._pulses.append(_Pulse(
                    inst_idx=np.asarray(idx)[members],
                    buf=ap_buf, buf_start=int(ap_off[r]),
                    pool_count=int(ap_h['counts'][r]),
                    t_min=int(ap_h['t_min'][r]) + base_time,
                    t_max=int(ap_h['t_max'][r]) + base_time,
                    truth_key=-1, event_number=ev, base_time=base_time))

    def _assemble_truth_row(self, kind, truth_h, r, base_time, insts, n_primary):
        """Build one truth dict (reference: rawdata.py:313-375)."""
        if n_primary == 0 and kind not in ('s1', 's2'):
            # zero-photon afterpulses don't get truth rows (rawdata.py:334-337)
            return None
        dt = self.const.sample_duration
        row = {}
        row['type'] = {'s1': 1, 's2': 2, 'pi_el': 4, 'pe_el': 6}[kind]
        if truth_h['photon_count'][r] > 0:
            tmin = float(truth_h['photon_t_min'][r]) + base_time
            tmax = float(truth_h['photon_t_max'][r]) + base_time
            row.update(
                t_first_photon=tmin,
                t_last_photon=tmax,
                t_mean_photon=float(truth_h['photon_t_min'][r]
                                    + truth_h['photon_t_mean_offset'][r]) + base_time,
                t_sigma_photon=float(truth_h['photon_t_sigma'][r]))
            row['endtime'] = int(tmax) + (
                self.const.samples_before_pulse_center
                + self.const.samples_after_pulse_center + 1) * dt
        else:
            row.update(t_first_photon=np.nan, t_last_photon=np.nan,
                       t_mean_photon=np.nan, t_sigma_photon=np.nan)
            row['endtime'] = int(insts['time'][0])
        if 'electron_count' in truth_h and truth_h['electron_count'][r] > 0:
            row.update(
                n_electron=int(truth_h['n_electron'][r]),
                t_first_electron=float(truth_h['electron_t_min'][r]) + base_time,
                t_last_electron=float(truth_h['electron_t_max'][r]) + base_time,
                t_mean_electron=float(truth_h['electron_t_min'][r]
                                      + truth_h['electron_t_mean_offset'][r])
                                + base_time,
                t_sigma_electron=float(truth_h['electron_t_sigma'][r]))
        else:
            row.update(n_electron=0, t_first_electron=np.nan,
                       t_last_electron=np.nan, t_mean_electron=np.nan,
                       t_sigma_electron=np.nan)

        row['n_photon'] = int(truth_h['photon_count'][r])
        for f in ('n_pe', 'n_photon_trigger', 'n_pe_trigger',
                  'raw_area', 'raw_area_trigger'):
            row[f] = float(truth_h[f][r])
        if self.const.per_pmt_truth:
            for f in ('n_photon', 'n_pe', 'n_photon_trigger', 'n_pe_trigger',
                      'raw_area', 'raw_area_trigger'):
                row[f + '_per_pmt'] = truth_h[f + '_per_pmt'][r]
            row['n_photon'] = int(truth_h['n_photon'][r])
        else:
            for f in ('n_photon', 'n_pe', 'n_photon_trigger', 'n_pe_trigger',
                      'raw_area', 'raw_area_trigger'):
                row[f + '_bottom'] = float(truth_h[f + '_bottom'][r])

        # instruction summary (reference: rawdata.py:363-372)
        for field in insts.dtype.names:
            v = insts[field]
            if len(insts) > 1 and field in 'xyz':
                row[field] = float(np.mean(v))
            elif len(insts) > 1 and field == 'amp':
                row[field] = int(np.sum(v))
            else:
                row[field] = v[0]
        if 'x_mean_electron' in truth_h:
            row['x_mean_electron'] = float(truth_h['x_mean_electron'][r])
            row['y_mean_electron'] = float(truth_h['y_mean_electron'][r])
        else:
            row['x_mean_electron'] = np.nan
            row['y_mean_electron'] = np.nan
        return row

    # -- main generators -------------------------------------------------------

    def __call__(self, instructions, truth_buffer=None, progress_bar=False,
                 **kwargs):
        """Legacy tuple interface: yields (channel, left, right, data) pulses
        like the reference RawData generator (used by the pax output path).
        The production path is :meth:`iter_windows`."""
        for win in self.iter_windows(instructions, truth_buffer, **kwargs):
            recs = win['records']
            dt = self.const.sample_duration
            if len(recs):
                # windows stream time-sorted; regroup per channel so the
                # records of one pulse are adjacent again (stable sort keeps
                # the per-channel time order, hence record_i order)
                recs = recs[np.argsort(recs['channel'], kind='stable')]
            i = 0
            n = len(recs)
            while i < n:
                plen = int(recs['pulse_length'][i])
                nrec = -(-plen // len(recs['data'][i]))
                data = np.concatenate(
                    [recs['data'][i + j] for j in range(nrec)])[:plen]
                left = int(recs['time'][i]) // dt
                yield (int(recs['channel'][i]), left, left + plen - 1, data)
                i += nrec

    def iter_windows(self, instructions, truth_buffer=None, **kwargs):
        """Production interface: yields per digitization window a dict with
        win_left/win_right (absolute samples) and a ready strax raw_record
        array (sorted by channel, then interval, like the reference's per
        flush yield order).

        Runs as a depth-2 pipeline over arrival-ordered SUPER-BATCHES of
        instructions: while super-batch k's packed records stream back to
        the host, super-batch k+1's simulation kernels execute on the
        device.  Flush groups that
        could still absorb pulses arriving after the batch boundary are
        deferred to the next digitize round (see ``_dispatch_digitize``), so
        the window framing is identical to a single-pass run."""
        if truth_buffer is None:
            truth_buffer = []
        rext = int(self.config['right_raw_extension'])
        dt = self.const.sample_duration

        self.source_finished = False
        self._buffers: ty.Dict[int, tuple] = {}
        self._buf_ctr = 0
        self._pulses: ty.List[_Pulse] = []
        # fresh record arena per run: arrays returned from a previous run
        # keep their own base alive; the heap reuses those pages once the
        # caller drops them, so steady-state refills avoid first-touch
        self._rec_arena = None
        self._rec_arena_used = 0
        self._rec_run_rows = 0

        instructions = np.asarray(instructions)
        self.instruction_event_number = int(np.min(instructions['event_number'])) \
            if len(instructions) else 0
        arrival = self._arrival_times(instructions)
        order = np.argsort(arrival, kind='stable')

        batches = self._split_super_batches(arrival, order)
        self._pipeline_live = len(batches) > 1

        # Pre-dispatch EVERY super-batch's demand pre-pass and fetch all
        # counts in one stacked transfer: the demand kernels land in the
        # device queue before any heavy sim/digitize work, so this single
        # sync costs one round trip — per-super-batch demand fetches used
        # to block behind the previous round's whole digitize compute.
        preps_all = demands = None
        if self._use_demand_prepass():
            prep_pairs = [self._sim_prepare(instructions, order_k)
                          for order_k, _ in batches]
            t0 = time.perf_counter()
            flat = [h for _, hs in prep_pairs for h in hs]
            demands = (np.asarray(jnp.stack(flat)) if flat
                       else np.zeros(0, np.int32))
            self.diag.seconds['sim_demand_fetch'] += time.perf_counter() - t0
            preps_all = [p for p, _ in prep_pairs]

        def stage_a(jobs, safe_t):
            """Finalize one super-batch's PRIMARY sim (group fetch — its
            kernels and truth-pack copy executed behind the intervening
            host work, so the fetch costs ~a round trip) and PREPARE its
            electron-afterpulse feedback step (ref rawdata.py:133-140):
            secondary instructions are synthesized and their tiny photon-
            demand kernels dispatched (async count copy), but the full
            kernels wait one rotation (stage_a2) so the demand join lands
            on data that already reached the host — the eager form blocked
            behind the next batch's queued sim kernels."""
            truth_rows: ty.List[dict] = []
            gen_sink: ty.List[np.ndarray] = []
            with self.diag.phase('simulate'):
                self._sim_finalize(jobs, instructions, truth_rows, gen_sink)
            gen_sink = [g for g in gen_sink if len(g)]
            sec_state = None
            if gen_sink:
                sec = np.concatenate(gen_sink)
                if len(sec):
                    arr2 = self._arrival_times(sec)
                    order2 = np.argsort(arr2, kind='stable')
                    with self.diag.phase('simulate_afterpulses'):
                        if self._use_demand_prepass():
                            preps, demands_d = self._sim_prepare(sec, order2)
                            tok = (_start_sliced_copies(
                                [jnp.stack(demands_d)]) if demands_d
                                else None)
                            sec_state = ('prep', preps, tok, sec)
                        else:
                            # subclass dispatch path (no demand pre-pass)
                            jobs2 = self._sim_dispatch(sec, order2,
                                                       want_gen=False)
                            sec_state = ('jobs', jobs2, None, sec)
            return (sec_state, truth_rows, safe_t)

        def stage_a2(sec_state, truth_rows, safe_t):
            """Join the secondary demand counts (their copy streamed behind
            one full rotation of host work) and dispatch the secondary sim
            kernels at exact capacities."""
            jobs2 = secondaries = None
            if sec_state is not None:
                mode, payload, tok, sec = sec_state
                secondaries = sec
                if mode == 'jobs':
                    jobs2 = payload
                else:
                    with self.diag.phase('simulate_afterpulses'):
                        t0 = time.perf_counter()
                        demands = (_collect_sliced(tok)[0] if tok is not None
                                   else np.zeros(0, np.int32))
                        self.diag.seconds['sim_demand_fetch'] += \
                            time.perf_counter() - t0
                        jobs2 = self._sim_dispatch_prepared(
                            payload, demands, want_gen=False)
            return (jobs2, secondaries, truth_rows, safe_t)

        def stage_b(jobs2, secondaries, truth_rows, safe_t):
            """Finalize the batch's afterpulse secondaries (their kernels
            ran behind the next batch's stage-a work), drain its truth and
            dispatch its digitize round."""
            if jobs2 is not None:
                with self.diag.phase('simulate_afterpulses'):
                    self._sim_finalize(jobs2, secondaries, truth_rows, None)
            # truth out before this batch's windows can be yielded
            self._drain_truth(truth_buffer, truth_rows)
            return self._dispatch_digitize(safe_t, rext, dt)

        # Software pipeline over super-batches, one stage per dependency edge:
        # dispatch sim(k); stage_a(k-1) = finalize primaries + prepare
        # afterpulse secondaries (demand kernels dispatched, counts copy
        # async); stage_a2(k-2) = join demand counts + dispatch the secondary
        # sim kernels; stage_b(k-3) = finalize secondaries + drain truth +
        # dispatch digitize; pack round k-4's records (counts long ready);
        # collect round k-5's payload (on the wire since the previous
        # iteration).  Every blocking fetch thus waits on device work queued >=
        # one full stage earlier instead of draining the device queue (whether
        # that pays on this card is unmeasured on H100 (ROADMAP C2)).  Windows
        # still yield in exact time order (framing is safe_t-driven, not
        # arrival-driven); only their latency grows.  The sim-key counter
        # interleaving differs from the unpipelined order, so draws differ from
        # a depth<=1 run exactly as PARITY deviation 5 documents.
        pending = None        # packed round awaiting payload collect
        pre_pending = None    # dispatched digitize round awaiting pack
        ap_pending = None     # stage_a2 output awaiting stage_b
        sec_pending = None    # stage_a output awaiting stage_a2
        sim_pending = None    # (jobs, safe_t) dispatched sim awaiting stage_a
        di = 0
        collector = futures.ThreadPoolExecutor(max_workers=1)

        def advance(dispatch_sim):
            """Rotate the pipeline one super-batch forward; yields any
            round whose payload completed.  Stage order within a rotation
            is sim dispatch, stage_a, stage_b, pack, collect, so payload
            copies stay in flight across the rotation boundary while the
            next batch's kernels execute (unmeasured on H100, ROADMAP C2).

            The pending round's payload wait + native decode + record
            split run on a worker thread STARTED before the rotation's
            stages: the native decode drops the GIL (native/fastpath.c)
            and numpy's big ops do too, so on this single-core host the
            round's host CPU work fills the rotation's otherwise-idle
            blocking waits (sim_group_fetch, counts fetch) instead of
            extending the wall after them.  Only one worker round is in
            flight at a time, so the record arena and diag counters stay
            single-writer; window yields keep their exact rotation slot."""
            nonlocal pending, pre_pending, ap_pending, sec_pending, \
                sim_pending
            work = (collector.submit(self._collect_digitize_work, pending)
                    if pending is not None else None)
            sim_next = dispatch_sim() if dispatch_sim is not None else None
            sec_new = stage_a(*sim_pending) if sim_pending is not None else None
            ap_new = stage_a2(*sec_pending) if sec_pending is not None else None
            pre_new = stage_b(*ap_pending) if ap_pending is not None else None
            with self.diag.phase('digitize'):
                packed_new = self._pack_digitize(pre_pending)
                if work is not None:
                    t0 = time.perf_counter()
                    results = work.result()
                    self.diag.seconds['digitize_collect_join'] += \
                        time.perf_counter() - t0
                    yield from self._yield_digitize(pending, results)
            pending = packed_new
            pre_pending = pre_new
            ap_pending = ap_new
            sec_pending = sec_new
            sim_pending = sim_next

        def _dispatch_sim_batch(k, order_k, safe_t):
            nonlocal di
            with self.diag.phase('simulate'):
                if preps_all is not None:
                    preps = preps_all[k]
                    jobs = self._sim_dispatch_prepared(
                        preps, demands[di:di + len(preps)], want_gen=True)
                    di += len(preps)
                else:
                    jobs = self._sim_dispatch(instructions, order_k,
                                              want_gen=True)
            return (jobs, safe_t)

        try:
            for k, (order_k, safe_t) in enumerate(batches):
                yield from advance(partial(_dispatch_sim_batch, k, order_k,
                                           safe_t))
            # drain: trailing rotations flush sim -> secondary prep ->
            # secondary dispatch -> digitize -> pack -> collect for the
            # last batches
            for _ in range(5):
                if (sim_pending is None and sec_pending is None
                        and ap_pending is None and pre_pending is None
                        and pending is None):
                    break
                yield from advance(None)
        finally:
            collector.shutdown(wait=True)
        self.source_finished = True

    def _split_super_batches(self, arrival, order):
        """Cut the arrival-ordered instruction stream into pipeline
        super-batches; returns [(order_slice, safe_t), ...].

        ``safe_t`` is the earliest time any LATER batch can contribute a
        pulse: the next batch's first signal arrival minus a slack for
        pre-arrival photons (S2 drift-diffusion spread, luminescence and
        gate-afterpulse jitter are all well under it).  Cuts are only placed
        at arrival gaps > gap_thr so that, combined with flush-group
        deferral, pipelined window framing matches a single-pass run."""
        n = len(order)
        depth = int(self.config.get('pipeline_depth', 3))
        min_batch = int(self.config.get('pipeline_min_batch', 64))
        if n < 2 * min_batch or depth <= 1:
            return [(order, np.inf)]
        rext = int(self.config['right_raw_extension'])
        slack = 3 * rext + 100_000
        gap_thr = slack + 2 * rext
        target = max(int(np.ceil(n / depth)), min_batch)
        sa = np.asarray(arrival)[order]
        cuts = np.flatnonzero(np.diff(sa) > gap_thr) + 1
        batches = []
        start = 0
        for c in cuts:
            if c - start >= target and n - c >= target // 2:
                batches.append((order[start:c], float(sa[c]) - slack))
                start = c
        batches.append((order[start:], np.inf))
        return batches

    def _sim_batch_list(self, instructions, order):
        """Cut arrival-ordered instructions into same-chain device batches
        bounded by instruction count, summed amplitude and int32 time span;
        returns [(kind, index_array), ...]."""
        MAX_BATCH_INST = 1024
        MAX_BATCH_AMP = {'s1': 3_000_000, 's2': 200_000}
        MAX_SPAN_NS = int(15e8)  # int32 time offsets allow up to ~2.1e9 ns

        types = instructions['type']
        kind_of = {1: 's1', 2: 's2', 4: 'pi_el', 6: 'pe_el'}
        batches: ty.Dict[str, list] = {'s1': [], 's2': [], 'pi_el': [], 'pe_el': []}
        for i in order:
            k = kind_of.get(int(types[i]))
            if k is None:
                continue
            batches[k].append(i)

        batch_list = []
        for kind, idxs in batches.items():
            if not idxs:
                continue
            idxs = np.asarray(idxs)
            t0 = instructions['time'][idxs].astype(np.int64)
            amps = instructions['amp'][idxs].astype(np.float64)
            limit = MAX_BATCH_AMP['s1' if kind == 's1' else 's2']
            cur, cur_amp, cur_t0 = [], 0.0, None
            for j, i in enumerate(idxs):
                if cur and (len(cur) >= MAX_BATCH_INST
                            or cur_amp + amps[j] > limit
                            or t0[j] - cur_t0 > MAX_SPAN_NS):
                    batch_list.append((kind, np.asarray(cur)))
                    cur, cur_amp, cur_t0 = [], 0.0, None
                if cur_t0 is None:
                    cur_t0 = t0[j]
                cur.append(i)
                cur_amp += amps[j]
            if cur:
                batch_list.append((kind, np.asarray(cur)))
        return batch_list

    def _use_demand_prepass(self):
        return (type(self)._dispatch_type_batch
                is RawDataTPU._dispatch_type_batch)

    def _sim_prepare(self, instructions, order):
        """Host-side prep + demand-kernel dispatch for one super-batch; the
        (tiny) demand kernels are queued immediately, so a caller preparing
        ALL super-batches up front can fetch every demand count in one
        stacked transfer before any heavy kernel sits in the device queue.
        Returns (preps, demand_handles)."""
        t_d0 = time.perf_counter()
        batch_list = self._sim_batch_list(instructions, order)
        preps = [self._prepare_type_batch(instructions, idx, kind)
                 for kind, idx in batch_list]
        demands_d = [self._dispatch_demand(p) for p in preps]
        self.diag.seconds['sim_dispatch'] += time.perf_counter() - t_d0
        return preps, demands_d

    def _sim_dispatch_prepared(self, preps, demands, want_gen):
        """Dispatch the full sim kernels for prepared batches at the exact
        capacities the demand pre-pass measured (the worst-case gain bound
        oversized the S2 photon axis 4-5x)."""
        t_d0 = time.perf_counter()
        jobs = [self._dispatch_prepared(p, want_gen, _bucket(int(d) + 64))
                for p, d in zip(preps, demands)]
        self._pack_job_group(jobs)
        self.diag.seconds['sim_dispatch'] += time.perf_counter() - t_d0
        return jobs

    def _sim_dispatch(self, instructions, order, want_gen):
        """Batch same-chain instructions in arrival order and dispatch all
        device work (demand pre-pass + full kernels); returns job handles
        for :meth:`_sim_finalize`.  Nothing blocks on sim compute — only the
        tiny demand-count fetch syncs, so a caller can overlap the queued
        kernels with wire transfers."""
        if self._use_demand_prepass():
            preps, demands_d = self._sim_prepare(instructions, order)
            demands = (np.asarray(jnp.stack(demands_d)) if demands_d
                       else np.zeros(0, np.int32))
            return self._sim_dispatch_prepared(preps, demands, want_gen)
        # subclass with a custom dispatch (e.g. optical photons-from-
        # file): legacy per-batch path with conservative capacities
        t_d0 = time.perf_counter()
        batch_list = self._sim_batch_list(instructions, order)
        jobs = [self._dispatch_type_batch(instructions, idx, kind, want_gen)
                for kind, idx in batch_list]
        # base-class jobs carry fetch_trees; subclass jobs with their own
        # truth_pack/ap_pack handles pass through _pack_job_group untouched
        self._pack_job_group(jobs)
        self.diag.seconds['sim_dispatch'] += time.perf_counter() - t_d0
        return jobs

    def _sim_finalize(self, jobs, instructions, truth_rows, gen_sink):
        """Collect every dispatched sim batch (blocking truth fetches ride
        the async copies started at dispatch)."""
        t_f0 = time.perf_counter()
        for job in jobs:
            self._finalize_type_batch(job, instructions, truth_rows, gen_sink)
        self.diag.seconds['sim_finalize'] += time.perf_counter() - t_f0
        self.diag.add('sim_batches', len(jobs))

    def _drain_truth(self, truth_buffer, truth_rows):
        if isinstance(truth_buffer, list):
            truth_buffer.extend(truth_rows)
            return
        for row in truth_rows:
            ix = np.argmin(truth_buffer['fill'])
            for k, v in row.items():
                if k in truth_buffer.dtype.names:
                    truth_buffer[ix][k] = v
            truth_buffer[ix]['fill'] = True

    def _dispatch_digitize(self, safe_t, rext, dt):
        """Group pending pulses into digitization windows and dispatch the
        batched digitize+ZLE kernels for them (flush-on-gap grouping);
        returns the pre-pack state consumed by :meth:`_pack_digitize`.

        Flush groups that could still absorb a pulse arriving at/after
        ``safe_t`` (within ``rext`` of the group end) are NOT digitized:
        their pulses stay queued for the next round, so pipelined runs frame
        windows exactly like a single-pass run (groups are time-ordered, so
        the deferred set is always a suffix and yields stay time-sorted).
        """
        from .digitize import gather_digitize

        if not self._pulses:
            return None
        t_grp0 = time.perf_counter()
        margin_l = (self.const.samples_to_store_before
                    + self.const.samples_before_pulse_center
                    + self.const.trigger_window)
        margin_r = (self.const.samples_to_store_after
                    + self.const.samples_after_pulse_center
                    + self.const.trigger_window)

        pulses = sorted(self._pulses, key=lambda p: p.t_min)

        # Sub-split threshold: a flush group (reference cache) is digitized
        # in sub-windows when it contains internal gaps so large that no ZLE
        # interval, pad or holdoff bridge can cross them.  This collapses
        # the grid cost of drift-dominated S1+S2 windows (mostly empty span
        # between the pulses) by ~4x.  With noise on this is fine too: the
        # bank offset is host-drawn PER WINDOW (PARITY.md deviation 3), so
        # each sub-window just gets its own independent noise alignment —
        # same policy, different draw.  Only an active HE deamp factor
        # (deamp_int != 0, exotic) keeps the unsplit framing.
        # Deviation note: PARITY.md "Documented deviations" 1.
        holdoff_w = 2 * self.const.trigger_window + 1
        split_gap = self.config.get('split_digitize_gap_ns')
        if split_gap is None:
            split_gap = (max(4 * (margin_l + margin_r + holdoff_w) * dt,
                             20_000)
                         if self.const.high_energy_deamp_int == 0 else 0)

        groups: ty.List[ty.List[_Pulse]] = []
        cur = [pulses[0]]
        cur_end = pulses[0].t_max + margin_r * dt
        for p in pulses[1:]:
            if p.t_min - cur_end > rext:
                groups.append(cur)
                cur = [p]
            else:
                cur.append(p)
            cur_end = max(cur_end, p.t_max + margin_r * dt)
        groups.append(cur)

        # defer groups a future pulse (t >= safe_t) could still join; group
        # ends are strictly increasing, so the deferred set is a suffix
        if safe_t != np.inf:
            live = []
            deferred: ty.List[_Pulse] = []
            for grp in groups:
                g_end = max(p.t_max for p in grp) + margin_r * dt
                if deferred or g_end >= safe_t - rext:
                    deferred.extend(grp)
                else:
                    live.append(grp)
            groups = live
            self._pulses = deferred
        else:
            self._pulses = []
        if not groups:
            return None

        # build the round's photon arena from the buffers its pulses
        # reference (device-side concatenation; under a mesh the arena
        # replicates — every chip gathers its window shard from it), then
        # drop buffers no deferred pulse still needs
        used = sorted({p.buf for grp in groups for p in grp})
        base_of = {}
        off = 0
        bufs = []
        for bid in used:
            ph, _bt = self._buffers[bid]
            base_of[bid] = off
            off += int(ph['t'].shape[0])
            bufs.append(ph)
        arena_t = self._replicate(jnp.concatenate(
            [b['t'].astype(jnp.int32) for b in bufs]))
        arena_ch = self._replicate(jnp.concatenate(
            [b['ch'].astype(jnp.int32) for b in bufs]))
        arena_g = self._replicate(jnp.concatenate(
            [b['gain'] for b in bufs]))
        still = {p.buf for p in self._pulses}
        for bid in list(self._buffers):
            if bid not in still:
                del self._buffers[bid]

        # sub-split each flush group at unbridgeable internal gaps; the
        # first sub-window of each group keeps flush=True so the chunker's
        # pause/boundary-extension semantics still see reference flush
        # granularity (strax_interface.py:398-418)
        subs: ty.List[ty.Tuple[ty.List[_Pulse], bool]] = []
        for grp in groups:
            if not split_gap:
                subs.append((grp, True))
                continue
            cur = [grp[0]]
            first = True
            cur_end = grp[0].t_max + margin_r * dt
            for p in grp[1:]:
                if p.t_min - margin_l * dt - cur_end > split_gap:
                    subs.append((cur, first))
                    first = False
                    cur = [p]
                else:
                    cur.append(p)
                cur_end = max(cur_end, p.t_max + margin_r * dt)
            subs.append((cur, first))

        # window descriptors (in time order); the noise-bank start row is
        # drawn HOST-side per window (PARITY.md deviation 3) so the decode
        # stage can regenerate the overlay the transport strips
        noise_on = (self.const.enable_noise
                    and self.params.noise_data is not None)
        noise_len = int(self.params.noise_data.shape[0]) if noise_on else 0
        wins = []
        for grp, flush in subs:
            t_min = min(p.t_min for p in grp)
            t_max = max(p.t_max for p in grp)
            win_left = t_min // dt - margin_l
            if win_left % 2 != 0:
                win_left -= 1      # digitizer quirk (reference rawdata.py:221)
            win_right = t_max // dt + margin_r
            T = int(win_right - win_left + 1)
            assert T < 1_000_000, 'Pulse cache too long'
            n_phot = sum(p.pool_count for p in grp)
            nix = int(self.rng.integers(0, max(noise_len - T - 1, 1))) \
                if noise_on else 0
            wins.append(dict(grp=grp, win_left=int(win_left),
                             win_right=int(win_right),
                             T_cap=_bucket(T, lo=512, hi=2 ** 20),
                             n_phot=n_phot, flush=flush, noise_ix=nix))

        # Bucket windows by (T_cap, photon-capacity TIER) only — NOT the
        # exact (T, N, P) triple: per-round digitize calls are the unit of
        # program-dispatch overhead (the round-3 ceiling was dominated by
        # program boundaries, ~6 shape buckets x pipeline rotations), and
        # the grid cost depends on T alone.  Within a bucket the photon
        # axis pads to the bucket max (gather/scatter work is ~n_cap*16 B
        # per window — noise vs the C*T*10 grid), so windows of one T share
        # one call.  The 16x tier keeps a lone monster window (high-rate
        # configs) from inflating every small window's photon axis.
        t_floor = int(self.config.get('digitize_t_floor', 512))
        n_floor = int(self.config.get('digitize_n_floor', 2048))
        by_t: ty.Dict[int, list] = {}
        for i, w in enumerate(wins):
            by_t.setdefault(max(w['T_cap'], t_floor), []).append(i)
        buckets: ty.Dict[tuple, list] = {}
        for t_cap, t_indices in by_t.items():
            n_max = _bucket(max(wins[i]['n_phot'] for i in t_indices),
                            lo=n_floor)
            if n_max <= 16 * n_floor:
                tiers = {n_max: t_indices}
            else:
                # only a monster window (high-rate configs) splits the T
                # group, so it can't inflate every small window's photon axis
                tiers = {}
                for i in t_indices:
                    nc = _bucket(wins[i]['n_phot'], lo=n_floor)
                    tiers.setdefault(
                        n_max if nc > 16 * n_floor else 16 * n_floor,
                        []).append(i)
            for tier_cap, indices in tiers.items():
                n_cap = _bucket(max(wins[i]['n_phot'] for i in indices),
                                lo=n_floor)
                p_cap = _bucket(max(len(wins[i]['grp']) for i in indices),
                                lo=4, hi=2 ** 14)
                buckets[(t_cap, n_cap, p_cap)] = indices

        max_itv = int(self.config.get('zle_max_intervals', 64))
        self.diag.seconds['digitize_group'] += time.perf_counter() - t_grp0

        def dispatch(batch, T_cap, n_cap, p_cap):
            B = _bucket(len(batch), lo=max(1, self._ev_shards), hi=2 ** 30)
            pieces = np.zeros((B, p_cap, 3), np.int32)
            nix = np.zeros(B, np.int32)
            for bi, wi in enumerate(batch):
                w = wins[wi]
                win_base = w['win_left'] * dt
                nix[bi] = w['noise_ix']
                for pi, p in enumerate(w['grp']):
                    pieces[bi, pi, 0] = base_of[p.buf] + p.buf_start
                    pieces[bi, pi, 1] = p.pool_count
                    pieces[bi, pi, 2] = p.base_time - win_base
            if self.mesh is None:
                # one host-to-device transfer for pieces+nix (plus a
                # tiny split program)
                buf = np.concatenate(
                    [pieces.reshape(B, -1), nix[:, None]], axis=1)
                pieces_d, nix_d = _split_pieces_jit(jnp.asarray(buf))
            else:
                pieces_d = self._shard_events(jnp.asarray(pieces))
                nix_d = self._shard_events(jnp.asarray(nix))
            return nix, gather_digitize(
                self.params, self.const, arena_t, arena_ch, arena_g,
                pieces_d, nix_d,
                n_samples=T_cap, n_pieces=p_cap, n_cap=n_cap,
                max_intervals=max_itv)

        # phase 1: dispatch every digitize batch (compute pipelines); with
        # the super-batch pipeline live, two rounds' grids can coexist on
        # the device, so each round gets half the memory budget
        calls = []
        t_disp0 = time.perf_counter()
        budget = _device_memory_budget() // (2 if self._pipeline_live else 1)
        for (T_cap, n_cap, p_cap), indices in buckets.items():
            # batch size bounded by HBM: the phase histogram dominates at
            # n_tpc_pmts * T * 10 * 4 bytes per window (plus the int grid)
            bytes_per_win = (self.const.n_tpc_pmts * T_cap * 10 * 4 * 2
                             + self.const.n_channels_total * T_cap * 8
                             + n_cap * 16)
            b_max = _window_batch_cap(
                budget, bytes_per_win,
                self.const.n_tpc_pmts * self.const.sample_duration * T_cap)
            for lo in range(0, len(indices), b_max):
                batch = indices[lo:lo + b_max]
                nix, res = dispatch(batch, T_cap, n_cap, p_cap)
                calls.append((batch, T_cap, nix, res))

        self.diag.add('windows', len(wins))
        self.diag.add('photons',
                      sum(p.pool_count for grp in groups for p in grp))
        self.diag.add('digitize_calls', len(calls))
        # start the (tiny) stacked record-counts copy async right away: it
        # completes as soon as the digitize kernels do, so by the time
        # _pack_digitize blocks on it the RTT has already been paid behind
        # the previous round's payload stream
        counts_tok = _start_sliced_copies([jnp.stack(
            [jnp.stack([res['n_records'], res['n_values'],
                        res['n_intervals']])
             for *_, res in calls])])
        self.diag.seconds['digitize_dispatch'] += time.perf_counter() - t_disp0
        return dict(wins=wins, calls=calls, max_itv=max_itv, dt=dt,
                    noise_on=noise_on, counts_tok=counts_tok)

    def _pack_digitize(self, pre):
        """Block on a dispatched digitize round's record counts, dispatch the
        exact-size pack kernels and start the async payload copies; returns
        the round state consumed by :meth:`_collect_digitize`.

        Runs AFTER the previous round's payload collect (see iter_windows),
        so the counts wait — digitize compute + one transfer — overlaps
        that collect's payload transfer and host-side decode."""
        from .digitize import pack_records_accumulate

        if pre is None:
            return None
        wins, calls, max_itv, dt = (pre['wins'], pre['calls'],
                                    pre['max_itv'], pre['dt'])
        noise_on = pre['noise_on']

        # phase 1b: ONE tiny fetch of all record counts (the trailer
        # values), then pack every call's streams DIRECTLY into five
        # donated round-level buffers at host-computed offsets
        # (pack_records_accumulate) and start the async wire copies; the
        # blocking collects happen in _collect_digitize, typically one
        # super-batch later, so the transfers stream while the next batch's
        # sim kernels execute.  The per-call slice + concat formulation
        # this replaces dispatched ~6 extra device programs per call.
        t0 = time.perf_counter()
        counts_h = _collect_sliced(pre['counts_tok'])[0]
        self.diag.seconds['digitize_counts_fetch'] += time.perf_counter() - t0
        t0 = time.perf_counter()
        baseline = int(self.const.digitizer_reference_baseline)
        sizes = []
        batches_meta = []
        plan = []
        lens_tot = [0, 0, 0, 0, 0]
        caps_max = [0, 0, 0, 0, 0]
        offs_list = []
        for ci, (batch, T_cap, nix, res) in enumerate(calls):
            n_rec = int(counts_h[ci, 0])
            n_val = int(counts_h[ci, 1])
            n_itv = int(counts_h[ci, 2])
            # hi well above any real chunk: _bucket's default 2^22 cap
            # silently truncated the value stream on noise/high-rate
            # workloads (>4.2M masked samples per call)
            max_records = _bucket(max(n_rec, 1), lo=1024, hi=2 ** 28)
            max_values = _bucket(max(n_val, 1), lo=4096, hi=2 ** 28)
            assert max_records >= n_rec and max_values >= n_val, \
                (n_rec, n_val)   # truncation here silently loses records
            n = max(n_rec, 1)
            nv = max(n_val, 1)
            # the escape / escaped-mask exact counts live on device, so
            # their slices use generous host-side bounds (DPCM escapes
            # measured ~1e-5 of values; >2-run masks ~17% of records ON
            # AVERAGE but per-call fractions vary, so the mask bound is a
            # process-level adaptive high-water mark — an overflow refetch
            # drains the live device queue (~0.5-1 s), so it must fire at
            # most once per fraction step, not once per hot call)
            ne_bound = min(nv // 256 + 512, nv)
            me_bound = min(int(n * RawDataTPU._mesc_frac) + 64, n)
            # meta width: same static condition as the pack kernel
            B_call = _bucket(len(batch), lo=max(1, self._ev_shards),
                             hi=2 ** 30)
            w_meta = 2 if (B_call <= 128 and T_cap <= 8192) else 4
            lens = (max(n_itv, 1) * w_meta, n, me_bound, nv, ne_bound)
            # each accumulate call writes its FULL stream widths (see
            # pack_records_accumulate); buffers must absorb that past the
            # last exact offset
            from .digitize import esc_capacity
            full = (max_records * w_meta, max_records, max_records,
                    max_values, esc_capacity(max_values))
            offs_list.append(list(lens_tot))
            for k in range(5):
                lens_tot[k] += lens[k]
                caps_max[k] = max(caps_max[k], full[k])
            plan.append((max_records, max_values, w_meta))
            sizes.append([n_rec, n_val, n_itv, ne_bound, me_bound, None,
                          nix, w_meta])
            batches_meta.append(batch)

        tok = None
        round_bufs = None
        if sizes:
            # round buffers sized so no write window can clamp
            sz = [_bucket(lens_tot[k] + caps_max[k], lo=256, hi=2 ** 30)
                  for k in range(5)]
            out_itv = jnp.zeros(sz[0], jnp.int32)
            out_mask4 = jnp.zeros((sz[1], 4), jnp.uint8)
            out_mesc = jnp.zeros((sz[2], 14), jnp.uint8)
            out_vals = jnp.zeros(sz[3], jnp.int8)
            out_escs = jnp.zeros(sz[4], jnp.int16)
            state = (out_itv, out_mask4, out_mesc, out_vals, out_escs)
            offs_all = jnp.asarray(np.asarray(offs_list, np.int32))
            for ci, (batch, T_cap, nix, res) in enumerate(calls):
                max_records, max_values, w_meta = plan[ci]
                *state, mesc_full, escs_full = pack_records_accumulate(
                    *state, offs_all[ci],
                    res['data'], res['left_all'], res['starts'],
                    res['ends'], res['itv_valid'],
                    # the slim digitize path returns TPC rows only
                    n_channels_total=int(res['data'].shape[1]),
                    n_samples=T_cap, max_intervals=max_itv,
                    max_records=max_records, max_values=max_values,
                    baseline=baseline)
                state = tuple(state)
                sizes[ci][5] = {'rec_mask_esc': mesc_full,
                                'rec_escapes': escs_full}
            round_bufs = state
            if not self._device_ceiling:
                # ONE async wire copy per stream for the WHOLE round,
                # sliced to the exact totals (the donation chain has the
                # last pack call depending on all earlier ones, so these
                # copies see every region filled)
                tok = _start_sliced_copies(
                    [buf[:max(tot, 1)] for buf, tot
                     in zip(round_bufs, lens_tot)])
            # ceiling mode: the pack kernels + in-place stream writes above
            # still execute (transport prep a real deployment pays) but no
            # wire copy ever starts
        self.diag.seconds['digitize_pack_dispatch'] += \
            time.perf_counter() - t0
        return dict(wins=wins, sizes=[tuple(s) for s in sizes],
                    batches=batches_meta, tok=tok,
                    round_bufs=round_bufs,
                    baseline=baseline, dt=dt,
                    ceiling=self._device_ceiling,
                    noise_host=(self._noise_host_bank()
                                if noise_on else None))

    def _noise_host_bank(self):
        """(bank, ext_cm) host-side pair for the decode-stage noise re-add,
        cached on the shared resource: the raw (L, Cn) bank comes straight
        from the resource's numpy asset (no device fetch), and the
        wrap-extended channel-major copy is built once per process."""
        from .digitize import noise_bank_ext_cm
        cached = getattr(self.resource, '_noise_host_cm_cache', None)
        if cached is None:
            bank = getattr(self.resource, 'noise_data', None)
            bank = (np.asarray(bank, dtype=np.int32) if bank is not None
                    else np.asarray(self.params.noise_data))
            cached = (bank, noise_bank_ext_cm(bank))
            try:
                self.resource._noise_host_cm_cache = cached
            except Exception:
                pass
        return cached

    def _arena_alloc(self, n, dtype):
        """Allocate ``n`` record rows as a slice of the run-level record
        arena.

        Consecutive digitize rounds land in consecutive slices of ONE base
        array, so the chunker's per-chunk concatenation collapses to a
        zero-copy base slice even when a chunk spans several pipelined
        rounds (a fresh ~250 MB copy ran at ~25-90 MB/s on this host class).
        The arena is created fresh per run — previously returned record
        arrays keep their own base alive — and its high-water mark persists
        so steady-state runs allocate full size up front (the glibc heap
        retains the freed pages, so the refill pays no new first-touch
        faults).  On overflow a new base is started: the boundary chunk
        falls back to the copy path once, then slices coalesce again."""
        dtype = np.dtype(dtype)
        a = self._rec_arena
        if a is None or a.dtype != dtype \
                or self._rec_arena_used + n > len(a):
            # the high-water mark is PROCESS-level (class attribute) and
            # tracks the RUN-TOTAL row count: fresh Simulator instances in
            # the same process (bench repeats, strax reruns) allocate full
            # size on their first round, keeping every round in one base
            cap = max(n, RawDataTPU._arena_hw,
                      2 * (len(a) if a is not None else 0))
            a = np.zeros(cap, dtype)   # zeros: 'baseline' is never assigned
            self._rec_arena = a
            self._rec_arena_used = 0
        out = a[self._rec_arena_used:self._rec_arena_used + n]
        self._rec_arena_used += n
        self._rec_run_rows += n
        RawDataTPU._arena_hw = max(RawDataTPU._arena_hw, self._rec_run_rows)
        return out

    def _collect_digitize(self, state):
        """Block on a dispatched digitize round's payload transfers, decode
        the residual stream (re-applying the noise overlay host-side), split
        records per window and yield the windows in time order."""
        if state is None:
            return
        yield from self._yield_digitize(state, self._collect_digitize_work(state))

    def _collect_digitize_work(self, state):
        """The blocking/CPU half of :meth:`_collect_digitize` — payload
        wait, native decode, per-window record split.  No generator state
        and no Simulator time-cursor mutation, so iter_windows can run it
        in a worker thread: the payload wait and the (GIL-free) native
        decode + numpy split overlap the main thread's blocking device
        fetches for the NEXT rotation (sim_group_fetch), which release the
        GIL inside the runtime.  Returns the per-window record views."""
        from ..dtypes import raw_record_dtype, DEFAULT_RECORD_LENGTH
        from .digitize import expand_interval_meta
        from ..native import decode_residual_records
        wins = state['wins']
        baseline = state['baseline']
        noise_host = state['noise_host']
        dt = state['dt']
        spr = DEFAULT_RECORD_LENGTH

        if state.get('ceiling'):
            # device-ceiling bench mode: block until every pack kernel of
            # the round has executed (the donation chain makes the final
            # round buffer depend on every pack call, so ONE tiny fetch
            # joins them all), then skip the wire payload and host decode
            t0 = time.perf_counter()
            if state.get('round_bufs') is not None:
                _fetch_in_slices([state['round_bufs'][3][-1:]])
            self.diag.seconds['digitize_payload_fetch'] += \
                time.perf_counter() - t0
            empty = np.empty(0, raw_record_dtype(spr))
            return [empty] * len(wins)

        t0 = time.perf_counter()
        nbytes = 0
        payload_rows = []
        if state['sizes']:
            t_w0 = time.perf_counter()
            itv_all, mask4_all, mesc_all, vals_all, escs_all = \
                _collect_sliced(state['tok'])
            self.diag.seconds['digitize_payload_wait'] += \
                time.perf_counter() - t_w0
            nbytes += (itv_all.nbytes + mask4_all.nbytes + mesc_all.nbytes
                       + vals_all.nbytes + escs_all.nbytes)
            # per-stream accounting so payload work targets the right stream
            self.diag.add('payload_meta_bytes', itv_all.nbytes)
            self.diag.add('payload_mask_bytes',
                          mask4_all.nbytes + mesc_all.nbytes)
            self.diag.add('payload_value_bytes', vals_all.nbytes)
            self.diag.add('payload_escape_bytes', escs_all.nbytes)
        offs = [0, 0, 0, 0, 0]
        for n_rec, n_val, n_itv, ne_bound, me_bound, packed, nix, w_meta \
                in state['sizes']:
            lens = (max(n_itv, 1) * w_meta, max(n_rec, 1), me_bound,
                    max(n_val, 1), ne_bound)
            itv, mask4, mesc, vals, escs = (
                arr[o:o + ln] for arr, o, ln in
                zip((itv_all, mask4_all, mesc_all, vals_all, escs_all),
                    offs, lens))
            offs = [o + ln for o, ln in zip(offs, lens)]
            itv = itv.reshape(-1, w_meta)
            mask4 = mask4[:n_rec]
            # meta expansion only — sample decode is deferred until the
            # global record order is known, so the decoder can scatter
            # rows straight into their final arena slots
            n_esc = int(np.count_nonzero(vals[:n_val] == -128))
            if n_esc > ne_bound:
                esc_full = int(packed['rec_escapes'].shape[0])
                if n_esc > esc_full:
                    # device escape buffer is statically capped ~256x above
                    # the measured rate (digitize.esc_capacity); decoding
                    # past it would silently corrupt samples
                    raise RuntimeError(
                        f'DPCM escape overflow: {n_esc} escapes exceed the '
                        f'device capacity {esc_full} — raise esc_capacity')
                escs = _fetch_in_slices([packed['rec_escapes'][:n_esc]])[0]
            n_mesc = int(np.count_nonzero(mask4[:, 0] == 255))
            if n_mesc > me_bound:
                mesc = _fetch_in_slices(
                    [packed['rec_mask_esc'][:n_mesc]])[0]
                # raise the process-level bound so subsequent rounds ship
                # enough up front instead of paying this queue-drain again
                RawDataTPU._mesc_frac = min(
                    1.0, max(RawDataTPU._mesc_frac,
                             1.25 * n_mesc / max(n_rec, 1)))
            self.diag.add('payload_mesc_rows', n_mesc)
            self.diag.add('payload_mesc_shipped', me_bound)
            self.diag.append('mesc_frac', (n_rec, n_mesc))
            m = expand_interval_meta(itv[:n_itv])
            assert len(m[0]) == n_rec, (len(m[0]), n_rec)
            payload_rows.append((n_rec, m, mask4, mesc[:n_mesc],
                                 vals[:n_val], escs[:n_esc], nix))
        self.diag.seconds['digitize_payload_fetch'] += \
            time.perf_counter() - t0
        self.diag.add('payload_bytes', nbytes)

        # phase 2: split per window and time-sort during the copy (records
        # arrive in natural window/channel/interval order; applying the
        # permutation here rides the record-array build, so the on-device
        # lexsort — measured ~2 s per bench chunk — is gone for free).
        # All windows fill slices of ONE round-level array in stream order,
        # so the chunker's per-chunk concatenation collapses to a view
        # (first-touch page faults on fresh chunk-sized arrays cost seconds
        # on virtualized hosts — pay them once, here).
        t_split0 = time.perf_counter()
        results = [None] * len(wins)
        win_counts = np.zeros(len(wins), np.int64)
        W_p, C_p, S_p, PLEN_p, RECI_p = ([] for _ in range(5))
        for batch, (n_rec, m, *_rest) in zip(state['batches'],
                                             payload_rows):
            # split records by window (ascending by design)
            bounds = np.searchsorted(m[0], np.arange(len(batch) + 1))
            win_counts[np.asarray(batch)] = np.diff(bounds)
            W_p.append(np.asarray(batch, np.int64)[m[0]])
            C_p.append(m[1])
            S_p.append(m[2])
            PLEN_p.append(m[4])
            RECI_p.append(m[5])
        offsets = np.concatenate([[0], np.cumsum(win_counts)])
        N = int(offsets[-1])
        chunk_arr = self._arena_alloc(N, raw_record_dtype(spr))
        if N:
            # ONE global sort (window, then start, then channel — the same
            # per-window (start, channel) key the old per-window loop used;
            # lexsort is stable, so tie order is unchanged) and ONE
            # vectorized fill per field: the per-window python loop ran
            # thousands of tiny strided copies per round and degraded
            # super-linearly under memory pressure (13.6 s at 1024 noisy
            # events vs ~1 s for this form)
            W = np.concatenate(W_p)
            S = np.concatenate(S_p)
            C = np.concatenate(C_p)
            order = np.lexsort((C, S, W))
            win_left_all = np.fromiter((w['win_left'] for w in wins),
                                       np.int64, len(wins))
            recs = chunk_arr[:N]
            # header fields ride the decode scatter below (stream-order
            # inputs, written into each row's final sorted slot in the
            # same pass that writes its samples) — the six strided
            # structured-array assignments this replaces each re-touched
            # every 244-byte record row
            time64 = (win_left_all[W] + S.astype(np.int64)) * dt
            # decode each batch's sample stream DIRECTLY into its records'
            # final sorted slots (inverse permutation as the row map): the
            # dense temp, np.concatenate and permuted 'data' gather this
            # replaces were ~3 extra full-payload memory passes per round
            inv = np.empty(N, np.int64)
            inv[order] = np.arange(N, dtype=np.int64)
            roff = 0
            for (n_rec, m, mask4, mesc, vals, escs, nix), plen, reci in zip(
                    payload_rows, PLEN_p, RECI_p):
                rmap = inv[roff:roff + n_rec]
                t64 = time64[roff:roff + n_rec]
                roff += n_rec
                if not n_rec:
                    continue
                if noise_host is not None:
                    decode_residual_records(
                        m[3], mask4, mesc, vals, escs, baseline,
                        channel=m[1], start_s=m[2], left_ch=m[6],
                        nix_rec=nix[m[0]], bank=noise_host[0],
                        ext_cm=noise_host[1], out_records=recs,
                        rowmap=rmap, time_ns=t64, pulse_length=plen,
                        record_i=reci, rec_dt=dt)
                else:
                    decode_residual_records(
                        m[3], mask4, mesc, vals, escs, baseline,
                        channel=m[1], out_records=recs,
                        rowmap=rmap, time_ns=t64, pulse_length=plen,
                        record_i=reci, rec_dt=dt)
        for wi in range(len(wins)):
            results[wi] = chunk_arr[offsets[wi]:offsets[wi + 1]]
        self.diag.add('records', N)
        self.diag.seconds['digitize_host_split'] += \
            time.perf_counter() - t_split0
        return results

    def _yield_digitize(self, state, results):
        """Yield a collected round's windows in time order, advancing the
        Simulator time cursors (main-thread only)."""
        wins = state['wins']
        dt = state['dt']
        for wi, w in enumerate(wins):
            self.left = w['win_left']
            self.right = w['win_right']
            self.last_pulse_end_time = w['win_right'] * dt
            self.instruction_event_number = min(p.event_number
                                                for p in w['grp'])
            yield dict(win_left=w['win_left'], win_right=w['win_right'],
                       flush=w.get('flush', True), records=results[wi])
