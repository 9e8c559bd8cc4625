"""Window digitization: photons -> digitized multi-channel grid -> ZLE.

One fused jitted pass per digitization window, replacing the reference's
``digitize_pulse_cache`` + ``ZLE`` (reference: wfsim/core/rawdata.py:204-311):

1. superpose SPE templates into the TPC waveform (ops/waveform.py),
2. ADC conversion with banker's rounding and sign flip,
3. high-energy channel copies and bottom sum-signal channel,
4. real-noise overlay (wrap-around indexed noise bank),
5. baseline addition and digitizer saturation (clip at zero),
6. zero-length encoding (ops/zle.py).

Everything is masked per channel to its active window, matching the
reference's channel-mask bookkeeping exactly.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.waveform import photons_to_waveform
from ..ops.zle import zle_all_channels

__all__ = ['esc_capacity',
           'digitize_window', 'gather_digitize', 'pack_records',
           'pack_records_encoded', 'decode_records', 'compact_mask4',
           'expand_mask4', 'SAMPLES_PER_RECORD', 'NOISE_PAD']

#: Wraparound margin (samples) of the channel-major extended noise bank
#: (params.noise_ext); digitize windows up to this length take the
#: contiguous-slice noise path. Banks shorter than this skip the extension.
NOISE_PAD = 16384

SAMPLES_PER_RECORD = 110


def esc_capacity(max_values: int) -> int:
    """Static capacity of the pack kernels' DPCM escape-value stream: the
    measured escape rate is ~1e-5 of values and the host transport bound is
    V/256+512, so a V-sized buffer (and the (V,)-update scatter that filled
    it) was ~256x oversized.  Shared by the pack kernels and the round-
    buffer sizing in pipeline/rawdata.py.  If a pathological workload ever
    produces more escapes than this, the host decode raises (loudly, not
    silently) — raise the cap there."""
    return min(max_values, max(65536, max_values // 64))


def _channel_extents(t, ch, valid, n_channels, dt, before, after, store_b, store_a):
    """Per-channel pulse extents in samples (reference: pulse.py:117-127 for
    the margins, rawdata.py:231-235 for the min/max bookkeeping)."""
    BIG = jnp.int32(2 ** 30)
    s = t // dt
    chc = jnp.where(valid, jnp.clip(ch, 0, n_channels - 1), 0)
    smin = jnp.full(n_channels, BIG, jnp.int32).at[chc].min(
        jnp.where(valid, s, BIG))
    smax = jnp.full(n_channels, -BIG, jnp.int32).at[chc].max(
        jnp.where(valid, s, -BIG))
    has = smax >= smin - 0  # any photon
    pl = smin - store_b - before
    pr = smax + store_a + after
    return pl, pr, has


def _noise_gather(params, noise_ix, left, T):
    """Noise-bank rows aligned to each channel's window start, wrap-around:
    value (b, c, t) = bank[(noise_ix[b] + t - left[b, c]) % L, c]
    (reference: rawdata.py:407-431).  Uses one contiguous dynamic slice per
    (window, channel) from the wrap-extended channel-major bank when
    available, instead of a pointwise modular gather."""
    B, nch = left.shape
    L = params.noise_data.shape[0]
    if params.noise_ext is not None and T <= NOISE_PAD:
        from ..ops.gather import gather_spans
        start = (NOISE_PAD + noise_ix[:, None] - left).astype(jnp.int32)
        start = jnp.clip(start, 0, params.noise_ext.shape[1] - T)
        c_io = jax.lax.broadcasted_iota(jnp.int32, (B, nch), 1)
        # one barrel-shift span gather per (window, channel) row instead
        # of vmap(dynamic_slice) (unmeasured on H100, ROADMAP C2)
        Lrow = params.noise_ext.shape[1]
        flat_start = (c_io.reshape(-1) * Lrow + start.reshape(-1))
        noise = gather_spans(params.noise_ext.reshape(-1), flat_start, T)
        return noise.reshape(B, nch, T).astype(jnp.int32)
    idxT = jnp.arange(T, dtype=jnp.int32)
    col = (noise_ix[:, None, None] + idxT[None, None, :]
           - left[:, :, None]) % L
    return params.noise_data[:, :nch].T[
        jax.lax.broadcasted_iota(jnp.int32, col.shape, 1), col]


@partial(jax.jit, static_argnames=('const', 'n_samples', 'max_intervals'))
def digitize_window(params, const, t, ch, gain, valid, key, noise_ix,
                    *, n_samples: int, max_intervals: int = 128):
    """Digitize one window.

    :param t: (N,) int32 photon times, ns relative to the window's left edge
        (sample 0 starts at t=0)
    :param ch/gain/valid: photon arrays
    :param noise_ix: int32 random noise-bank start offset (host-drawn)
    :returns: dict with data (C_all, T) int16, ch_mask/ch_left/ch_right
        (C_all,), zle starts/ends/counts
    """
    dt = const.sample_duration
    C = const.n_tpc_pmts
    C_all = const.n_channels_total
    T = n_samples

    # 1-2. waveform + ADC (reference: rawdata.py:236 '-np.around(...)')
    W = photons_to_waveform(t, ch, gain, valid, 0, params.templates,
                            n_channels=C, n_samples=T, sample_duration=dt)
    adc = (-jnp.round(W * const.current_2_adc)).astype(jnp.int32)

    # channel windows +- trigger window (reference: rawdata.py:258-259)
    pl, pr, has = _channel_extents(
        t, ch, valid, C, dt,
        const.samples_before_pulse_center, const.samples_after_pulse_center,
        const.samples_to_store_before, const.samples_to_store_after)
    ch_left = jnp.clip(pl - const.trigger_window, 0, T - 1)
    ch_right = jnp.clip(pr + const.trigger_window, 0, T - 1)

    # 3. assemble the full digitizer grid
    data = jnp.zeros((C_all, T), jnp.int32)
    data = data.at[:C].set(adc)
    mask = jnp.zeros(C_all, bool).at[:C].set(has)
    left_all = jnp.full(C_all, 0, jnp.int32).at[:C].set(ch_left)
    right_all = jnp.full(C_all, 0, jnp.int32).at[:C].set(ch_right)

    if const.detector == 'XENONnT' and const.he_channel_end >= const.he_channel_start:
        # HE copies of top-array channels, deamplified with the reference's
        # integer cast (rawdata.py:242: adc * int(factor) — 0 for factor<1)
        n_top = const.n_top_pmts
        he_lo = const.he_channel_start
        adc_he = adc[:n_top] * const.high_energy_deamp_int
        data = data.at[he_lo:he_lo + n_top].set(adc_he)
        mask = mask.at[he_lo:he_lo + n_top].set(has[:n_top])
        left_all = left_all.at[he_lo:he_lo + n_top].set(ch_left[:n_top])
        right_all = right_all.at[he_lo:he_lo + n_top].set(ch_right[:n_top])
        # bottom-array sum signal on the sum channel; note the reference does
        # NOT set the channel mask there (rawdata.py:250-254), so it is
        # excluded from noise/baseline/ZLE — replicated for parity.
        bot_sum = jnp.sum(
            adc[n_top:C] * const.high_energy_deamp_int, axis=0)
        data = data.at[const.sum_signal_channel].add(bot_sum)

    idx = jnp.arange(T, dtype=jnp.int32)
    in_win = (idx[None, :] >= left_all[:, None]) & \
             (idx[None, :] <= right_all[:, None]) & mask[:, None]

    # 4. noise overlay (reference: rawdata.py:398-437): per channel, the noise
    # trace starts at the same random bank offset, aligned to the channel's
    # own window start, wrapping around the bank.
    if const.enable_noise and params.noise_data is not None:
        L = params.noise_data.shape[0]
        Cn = params.noise_data.shape[1]
        nch = min(Cn, C_all)
        col = (noise_ix + idx[None, :] - left_all[:nch, None]) % L
        noise = jnp.take_along_axis(
            params.noise_data[:, :nch].T, col, axis=1)
        data = data.at[:nch].add(jnp.where(in_win[:nch], noise, 0))

    # 5. baseline + saturation (reference: rawdata.py:439-458)
    data = data + jnp.where(in_win, const.digitizer_reference_baseline, 0)
    data = jnp.where(in_win, jnp.maximum(data, 0), data)

    # 6. ZLE (reference: rawdata.py:274-311)
    holdoff = 2 * const.trigger_window + 1
    starts, ends, counts = zle_all_channels(
        data, params.zle_thresholds, left_all, right_all, mask,
        holdoff=holdoff, trigger_window=const.trigger_window,
        max_intervals=max_intervals)

    return dict(data=data.astype(jnp.int16),
                ch_mask=mask, ch_left=left_all, ch_right=right_all,
                zle_starts=starts, zle_ends=ends, zle_counts=counts)


@partial(jax.jit, static_argnames=('const', 'n_samples', 'max_intervals',
                                   'n_pieces', 'n_cap'))
def gather_digitize(params, const, arena_t, arena_ch, arena_gain,
                    pieces, noise_ix, *,
                    n_samples: int,
                    n_pieces: int,
                    n_cap: int,
                    max_intervals: int = 64):
    """Device-resident production path: gather each window's photons straight
    from the on-device photon arena, then digitize + pack records.

    Natively batched: each window's photons are histogrammed on their own
    (a sort along the window's photon axis, so a batch sharded over windows
    sorts locally), then the window batch is flattened into the channel
    axis (window w, channel c -> row w*C + c), so the template convolution,
    channel-extent reduction and ZLE run as single wide kernels.

    Host traffic: the tiny piece table in, packed records out.

    The returned grid is the SIGNAL-RESIDUAL view for transport: ZLE and
    saturation are computed on the full noisy waveform (reference semantics,
    rawdata.py:398-458), but the noise overlay — which the host can
    regenerate exactly from the bank and the host-drawn ``noise_ix`` — is
    subtracted again before the data leaves the device, so the wire payload
    keeps no-noise sparsity.  :func:`add_noise_host` is the inverse.

    :param arena_t/ch/gain: (A,) photon arena (concatenated sim buffers);
        times are int32 ns relative to each buffer's base
    :param pieces: (B, n_pieces, 3) int32 [arena_lo, count, t_offset];
        count==0 marks padding pieces
    :param noise_ix: (B,) int32 host-drawn noise-bank start row per window
        (ignored when noise is off; pass zeros)
    :returns: dict with the residual grid, channel windows, ZLE intervals
        and exact record/interval/value counts (fetched in one tiny
        transfer to size the pack stage).
    """
    B = pieces.shape[0]
    spr = SAMPLES_PER_RECORD
    T = n_samples
    dt = const.sample_duration
    C = const.n_tpc_pmts
    C_all = const.n_channels_total

    # ---- arena gather, flattened over (B, n_cap) ----
    lo = pieces[:, :, 0]
    cnt = pieces[:, :, 1]
    toff = pieces[:, :, 2]
    cum = jnp.cumsum(cnt, axis=1)                      # (B, P)
    total = cum[:, -1]                                 # (B,)
    j = jnp.arange(n_cap, dtype=jnp.int32)[None, :]    # (1, N)
    pidx = jnp.sum(j[:, :, None] >= cum[:, None, :], axis=2).astype(jnp.int32)
    pidx = jnp.minimum(pidx, n_pieces - 1)

    if n_pieces <= 32:
        # one-hot select instead of take_along_axis: the (B, N, P) masked
        # sum fuses into one elementwise pass instead of three (B, N)
        # row-gathers from tiny (B, P) tables (unmeasured on H100, ROADMAP C2)
        onehot = (pidx[:, :, None]
                  == jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_pieces), 2))

        def sel(tab):
            return jnp.sum(jnp.where(onehot, tab[:, None, :], 0), axis=2)

        prev = jnp.where(pidx > 0, sel(jnp.pad(cum, ((0, 0), (1, 0)))[:, :-1]),
                         0)
        aidx = sel(lo) + (j - prev)
        toff_ph = sel(toff)
    else:
        prev = jnp.where(pidx > 0,
                         jnp.take_along_axis(cum, jnp.maximum(pidx - 1, 0),
                                             axis=1), 0)
        aidx = jnp.take_along_axis(lo, pidx, axis=1) + (j - prev)
        toff_ph = jnp.take_along_axis(toff, pidx, axis=1)
    aidx = jnp.clip(aidx, 0, arena_t.shape[0] - 1)
    in_range = j < total[:, None]
    t = arena_t[aidx] + toff_ph                                   # (B, N)
    ch = jnp.where(in_range, arena_ch[aidx], -1)
    gain = arena_gain[aidx]
    valid = ch >= 0

    # ---- waveform: per-window histograms, windows flattened into the
    # channel axis of W (B*C, T) ----
    w_of_ph = jax.lax.broadcasted_iota(jnp.int32, (B, n_cap), 0)
    W = photons_to_waveform(t, ch, gain, valid, 0, params.templates,
                            n_channels=C, n_samples=T, sample_duration=dt)

    # ---- channel extents (flattened scatter) ----
    BIG = jnp.int32(2 ** 30)
    s_ph = t // dt
    rows = jnp.where(valid, w_of_ph * C + jnp.clip(ch, 0, C - 1), 0).reshape(-1)
    smin = jnp.full(B * C, BIG, jnp.int32).at[rows].min(
        jnp.where(valid, s_ph, BIG).reshape(-1))
    smax = jnp.full(B * C, -BIG, jnp.int32).at[rows].max(
        jnp.where(valid, s_ph, -BIG).reshape(-1))
    smin = smin.reshape(B, C)
    smax = smax.reshape(B, C)
    has = smax >= smin
    pl = smin - const.samples_to_store_before - const.samples_before_pulse_center
    pr = smax + const.samples_to_store_after + const.samples_after_pulse_center
    ch_left = jnp.clip(pl - const.trigger_window, 0, T - 1)
    ch_right = jnp.clip(pr + const.trigger_window, 0, T - 1)

    holdoff = 2 * const.trigger_window + 1
    noise_on = bool(const.enable_noise and params.noise_data is not None)
    Cn = int(params.noise_data.shape[1]) if noise_on else 0

    if const.high_energy_deamp_int == 0 and (not noise_on or Cn <= C):
        # ---- slim grid: the HE copies are all-zero (int deamp quirk,
        # reference: rawdata.py:242) and the noise bank covers at most the
        # TPC rows (reference skips ch >= noise_data_channels,
        # rawdata.py:419-421), so the HE rows sit at constant baseline and
        # the (unmasked) sum channel gets neither noise nor baseline —
        # neither can ever cross threshold.  Digitize, ZLE and pack over
        # the C TPC rows only (1.6x less HBM traffic on the grid).
        # Record channel ids stay correct because TPC channels are 0..C-1.
        adc = (-jnp.round(W * const.current_2_adc)).astype(jnp.int32)
        data = adc.reshape(B, C, T)
        left_all, right_all, mask = ch_left, ch_right, has

        idxT = jnp.arange(T, dtype=jnp.int32)
        in_win = (idxT[None, None, :] >= left_all[:, :, None]) & \
                 (idxT[None, None, :] <= right_all[:, :, None]) & mask[:, :, None]
        novl = None
        if noise_on:
            nch = min(Cn, C)
            noise = _noise_gather(params, noise_ix, left_all[:, :nch], T)
            novl = jnp.where(in_win[:, :nch], noise, 0)
            data = data.at[:, :nch].add(novl)
        data = data + jnp.where(in_win, const.digitizer_reference_baseline, 0)
        data = jnp.where(in_win, jnp.maximum(data, 0), data)
        # int16 from here on: every in-window sample is clipped to
        # [0, baseline + noise] and ZLE/pack/counts never read out-of-window
        # cells (whose wrap was equally present in the old end-of-kernel
        # cast) — halves the HBM bytes of the ZLE threshold pass and the
        # pack gathers
        data = data.astype(jnp.int16)

        K = max_intervals
        zthr = jnp.broadcast_to(params.zle_thresholds[None, :C],
                                (B, C)).reshape(-1)
        starts, ends, counts = zle_all_channels(
            data.reshape(B * C, T), zthr,
            left_all.reshape(-1), right_all.reshape(-1), mask.reshape(-1),
            holdoff=holdoff, trigger_window=const.trigger_window,
            max_intervals=K)
        starts = starts.reshape(B, C, K)
        ends = ends.reshape(B, C, K)
        counts = counts.reshape(B, C)
        kk = jnp.arange(K, dtype=jnp.int32)[None, None, :]
        itv_valid = kk < counts[:, :, None]
        if novl is not None:
            # transport view: ZLE/saturation saw the noisy waveform; strip
            # the (host-reconstructible) overlay so the wire payload keeps
            # no-noise sparsity (add_noise_host re-applies it exactly);
            # residual values are in-window signal+baseline minus noise —
            # they fit int16 exactly as the old int32-subtract-then-cast did
            data = data.at[:, :nch].add((-novl).astype(jnp.int16))
    else:
        adc = (-jnp.round(W * const.current_2_adc)).astype(jnp.int32)
        adc = adc.reshape(B, C, T)

        # ---- assemble full digitizer grid (B, C_all, T) by concatenation
        he_on = (const.detector == 'XENONnT'
                 and const.he_channel_end >= const.he_channel_start)
        n_top = const.n_top_pmts
        he_lo = const.he_channel_start

        blocks = [adc]
        mask_blocks = [has]
        left_blocks = [ch_left]
        right_blocks = [ch_right]
        if he_on:
            gap1 = he_lo - C
            adc_he = adc[:, :n_top] * const.high_energy_deamp_int
            he_hi = he_lo + n_top
            gap2 = const.sum_signal_channel - he_hi
            bot_sum = jnp.sum(adc[:, n_top:] * const.high_energy_deamp_int,
                              axis=1, keepdims=True)
            z1 = jnp.zeros((B, gap1, T), jnp.int32)
            z2 = jnp.zeros((B, gap2, T), jnp.int32)
            blocks += [z1, adc_he, z2, bot_sum]
            zb1 = jnp.zeros((B, gap1), bool)
            zb2 = jnp.zeros((B, gap2), bool)
            mask_blocks += [zb1, has[:, :n_top], zb2,
                            jnp.zeros((B, 1), bool)]   # sum channel unmasked
            zi1 = jnp.zeros((B, gap1), jnp.int32)
            zi2 = jnp.zeros((B, gap2), jnp.int32)
            left_blocks += [zi1, ch_left[:, :n_top], zi2,
                            jnp.zeros((B, 1), jnp.int32)]
            right_blocks += [zi1, ch_right[:, :n_top], zi2,
                             jnp.zeros((B, 1), jnp.int32)]
            n_rows = const.sum_signal_channel + 1
        else:
            n_rows = C

        data = jnp.concatenate(blocks, axis=1)
        mask = jnp.concatenate(mask_blocks, axis=1)
        left_all = jnp.concatenate(left_blocks, axis=1)
        right_all = jnp.concatenate(right_blocks, axis=1)
        if n_rows < C_all:
            pad = C_all - n_rows
            data = jnp.concatenate([data, jnp.zeros((B, pad, T), jnp.int32)],
                                   axis=1)
            mask = jnp.concatenate([mask, jnp.zeros((B, pad), bool)], axis=1)
            left_all = jnp.concatenate(
                [left_all, jnp.zeros((B, pad), jnp.int32)], axis=1)
            right_all = jnp.concatenate(
                [right_all, jnp.zeros((B, pad), jnp.int32)], axis=1)

        idxT = jnp.arange(T, dtype=jnp.int32)
        in_win = (idxT[None, None, :] >= left_all[:, :, None]) & \
                 (idxT[None, None, :] <= right_all[:, :, None]) & mask[:, :, None]

        # ---- noise overlay (host-drawn bank offsets) ----
        novl = None
        if noise_on:
            nch = min(Cn, C_all)
            noise = _noise_gather(params, noise_ix, left_all[:, :nch], T)
            novl = jnp.where(in_win[:, :nch], noise, 0)
            data = data.at[:, :nch].add(novl)

        # ---- baseline + saturation ----
        data = data + jnp.where(in_win, const.digitizer_reference_baseline, 0)
        data = jnp.where(in_win, jnp.maximum(data, 0), data)

        # ---- ZLE over flattened rows ----
        zle_rows = C_all
        if not noise_on and const.high_energy_deamp_int == 0:
            zle_rows = C
        zthr = jnp.broadcast_to(params.zle_thresholds[None, :zle_rows],
                                (B, zle_rows)).reshape(-1)
        K = max_intervals
        starts, ends, counts = zle_all_channels(
            data[:, :zle_rows].reshape(B * zle_rows, T), zthr,
            left_all[:, :zle_rows].reshape(-1),
            right_all[:, :zle_rows].reshape(-1),
            mask[:, :zle_rows].reshape(-1),
            holdoff=holdoff, trigger_window=const.trigger_window,
            max_intervals=K)
        starts = starts.reshape(B, zle_rows, K)
        ends = ends.reshape(B, zle_rows, K)
        counts = counts.reshape(B, zle_rows)
        if zle_rows < C_all:
            padr = C_all - zle_rows
            starts = jnp.pad(starts, ((0, 0), (0, padr), (0, 0)))
            ends = jnp.pad(ends, ((0, 0), (0, padr), (0, 0)))
            counts = jnp.pad(counts, ((0, 0), (0, padr)))
        kk = jnp.arange(K, dtype=jnp.int32)[None, None, :]
        itv_valid = kk < counts[:, :, None]
        if novl is not None:
            data = data.at[:, :nch].add(-novl)   # transport residual view
        data = data.astype(jnp.int16)

    # ---- record/interval counts (exact; size the pack kernel + host
    # slicing of the interval-table transport) ----
    plen = jnp.where(itv_valid, ends - starts + 1, 0)
    nrec = jnp.where(itv_valid, (plen + spr - 1) // spr, 0)
    total_rec = nrec.sum().astype(jnp.int32)
    total_itv = (nrec > 0).sum().astype(jnp.int32)

    # ---- count of record samples that differ from the predicted row
    # (baseline inside the pulse, zero in the tail pad) — sizes the encoded
    # transport's value buffer; rides the same tiny counts fetch. The host
    # decoder slices values by the actual mask popcount, so a slight
    # overestimate only costs a few extra wire bytes.  The grid is the
    # signal-residual view in every regime (noise stripped above), so the
    # count is a pure elementwise reduce over the channel windows —
    # measured +0.2% over the exact per-interval count, without that
    # version's 2x ~40 ms endpoint cumsum gathers.
    rows = data.shape[1]
    if rows == C:
        w_l, w_r, w_m = ch_left, ch_right, has
    else:
        w_l, w_r, w_m = left_all, right_all, mask
    idxT = jnp.arange(T, dtype=jnp.int32)
    in_w = (idxT[None, None, :] >= w_l[:, :, None]) & \
           (idxT[None, None, :] <= w_r[:, :, None]) & w_m[:, :, None]
    neq = (data != const.digitizer_reference_baseline) & in_w
    total_nnz = neq.sum().astype(jnp.int32)
    return dict(data=data, left_all=left_all,
                starts=starts, ends=ends, itv_valid=itv_valid,
                n_records=total_rec, n_intervals=total_itv,
                n_values=total_nnz)


@partial(jax.jit, static_argnames=('n_channels_total', 'n_samples',
                                   'max_intervals', 'max_records'))
def pack_records(data, left_all, starts, ends, itv_valid, *,
                 n_channels_total: int,
                 n_samples: int,
                 max_intervals: int,
                 max_records: int):
    """Pack ZLE intervals into strax 110-sample record rows (exact-capacity
    second stage of the digitize pipeline; the payload is sliced on device
    and streamed to the host)."""
    spr = SAMPLES_PER_RECORD
    T = n_samples
    C_all = n_channels_total
    K = starts.shape[2]          # interval slots per channel (path-dependent)

    plen = jnp.where(itv_valid, ends - starts + 1, 0)
    left_rel = left_all[:, :, None] + starts
    nrec = jnp.where(itv_valid, (plen + spr - 1) // spr, 0)

    nrec_f = nrec.reshape(-1)
    csum = jnp.cumsum(nrec_f)
    total_rec = csum[-1]
    r = jnp.arange(max_records, dtype=jnp.int32)
    itv_of_r = jnp.searchsorted(csum, r, side='right').astype(jnp.int32)
    itv_of_r = jnp.minimum(itv_of_r, nrec_f.shape[0] - 1)
    base = jnp.where(itv_of_r > 0, csum[itv_of_r - 1], 0)
    record_i = (r - base).astype(jnp.int32)
    rec_valid = r < total_rec

    w_of = itv_of_r // (C_all * K)
    c_of = (itv_of_r // K) % C_all
    plen_f = plen.reshape(-1)[itv_of_r]
    left_f = left_rel.reshape(-1)[itv_of_r]

    start_s = left_f + record_i * spr
    length = jnp.clip(plen_f - record_i * spr, 0, spr)

    # natural (window, channel, interval, record_i) order — same ordering
    # as pack_records_encoded; the host time-sorts per window

    flat = data.reshape(-1).astype(jnp.int16)
    col = start_s[:, None] + jnp.arange(spr, dtype=jnp.int32)[None, :]
    gidx = ((w_of * C_all + c_of)[:, None] * T + jnp.clip(col, 0, T - 1))
    rws = flat[gidx]
    in_len = (jnp.arange(spr, dtype=jnp.int32)[None, :] < length[:, None])
    rws = jnp.where(in_len & rec_valid[:, None], rws, 0).astype(jnp.int16)

    meta = jnp.stack([
        jnp.where(rec_valid, w_of, -1),
        c_of, start_s, length, plen_f, record_i], axis=1).astype(jnp.int32)
    return dict(rec_data=rws, rec_meta=meta)


def _pack_streams(data, left_all, starts, ends, itv_valid, *,
                  n_channels_total: int,
                  n_samples: int,
                  max_intervals: int,
                  max_records: int,
                  max_values: int,
                  baseline: int):
    """Traced core of :func:`pack_records_encoded` (see its docstring for
    the transport format); also reused by
    :func:`pack_records_accumulate`, which writes the streams into
    donated round-level buffers instead of returning per-call arrays."""
    spr = SAMPLES_PER_RECORD
    T = n_samples
    C_all = n_channels_total
    K = starts.shape[2]

    plen = jnp.where(itv_valid, ends - starts + 1, 0)
    left_rel = left_all[:, :, None] + starts
    nrec = jnp.where(itv_valid, (plen + spr - 1) // spr, 0)

    # ---- interval compaction + record->interval mapping, loop-free ----
    # Every live (nrec > 0) interval owns >= 1 record, so n_live <= total
    # records <= max_records: compact the live intervals' flat indices into
    # max_records slots with ONE unique-index scatter, and derive each
    # record's interval with a collision-free marks scatter + cumsum (the
    # compacted record cumsum is STRICTLY increasing over the live prefix).
    # The flat jnp.searchsorted over the (B*C*K,) cumsum this replaces
    # lowered to a vmapped while-loop carrying the whole cumsum
    # (unmeasured on H100, ROADMAP C2).  `pack_records`
    # (the dense variant) keeps the searchsorted form as an independent
    # oracle for the parity tests.
    nrec_f = nrec.reshape(-1)                                # (M,)
    live_f = nrec_f > 0
    lpos = jnp.cumsum(live_f.astype(jnp.int32))              # 1-based rank
    n_live = lpos[-1]
    iq = jnp.arange(max_records, dtype=jnp.int32)
    # rank inversion via the hierarchical block search (the (M,)-index
    # scatter it replaces cost ~10 ns per SOURCE slot — M = B*C*K is ~15x
    # the live count at bench shapes)
    from ..ops.randsample import search_sorted_rows
    take_i = search_sorted_rows(lpos[None, :],
                                jnp.zeros(max_records, jnp.int32),
                                iq + 1, side='left')
    valid_i = iq < n_live
    nrec_c = jnp.where(valid_i, nrec_f[take_i], 0)
    csum_c = jnp.cumsum(nrec_c)
    total_rec = csum_c[-1]
    r = jnp.arange(max_records, dtype=jnp.int32)
    marks_r = jnp.zeros(max_records, jnp.int32).at[
        jnp.where(valid_i, csum_c, max_records)].add(1, mode='drop')
    itv_of_rc = jnp.minimum(jnp.cumsum(marks_r), max_records - 1)
    base = jnp.where(itv_of_rc > 0,
                     csum_c[jnp.maximum(itv_of_rc - 1, 0)], 0)
    record_i = (r - base).astype(jnp.int32)
    rec_valid = r < total_rec

    # per-interval fields once on the COMPACTED axis (max_records gathers),
    # then broadcast to records with diff-cumsum expands (records of one
    # interval are consecutive) — replaces three more per-RECORD gathers
    from ..ops.segment import expand_rows
    start_c = left_rel.reshape(-1)[take_i]
    plen_c = plen.reshape(-1)[take_i]
    wc_c = take_i // K                      # == w * C_all + c
    rec_edges = jnp.concatenate([jnp.zeros(1, jnp.int32), csum_c])
    wc_f = expand_rows(wc_c, rec_edges, max_records)
    w_of = wc_f // C_all
    c_of = wc_f % C_all
    plen_f = expand_rows(plen_c, rec_edges, max_records)
    left_f = expand_rows(start_c, rec_edges, max_records)

    start_s = left_f + record_i * spr
    length = jnp.clip(plen_f - record_i * spr, 0, spr)

    # Records are emitted in natural (window, channel, interval, record_i)
    # order — ascending window by construction, time-ordered within each
    # channel. The host applies the per-window time sort as a permutation
    # during the record-array copy it makes anyway (rawdata phase 2)
    # instead of an on-device lexsort.

    # record samples via TWO aligned 128-wide row gathers + a log-step barrel
    # shift instead of arbitrary-start (110,)-slice gathers (unmeasured on
    # H100, ROADMAP C2).  The per-record sub-block shift is 7 static-shift
    # select passes.  Blocks can overrun a record's own (clamped) row into the
    # next channel's — every overrun sample sits past `length` and is masked
    # below, exactly like the old clamp-to-row-end reads.
    from ..ops.gather import gather_spans
    row_base = (w_of * C_all + c_of) * T
    start_blk = row_base + jnp.clip(start_s, 0, T - 1)
    rws = gather_spans(data.reshape(-1).astype(jnp.int16), start_blk, spr)
    in_len = (jnp.arange(spr, dtype=jnp.int32)[None, :] < length[:, None])
    rws = jnp.where(in_len & rec_valid[:, None], rws, 0).astype(jnp.int16)

    # ---- encode: mask of samples differing from the predicted row ----
    pred = jnp.where(in_len, jnp.int16(baseline), jnp.int16(0))
    dm = (rws != pred) & rec_valid[:, None]                   # (R, 110)
    dm_p = jnp.pad(dm, ((0, 0), (0, 112 - spr)))              # bit-pad to 112
    bits = dm_p.reshape(max_records, 14, 8)
    w8 = (2 ** (7 - jnp.arange(8, dtype=jnp.int32)))          # big-endian,
    masks = jnp.sum(bits * w8[None, None, :], axis=2).astype(jnp.uint8)
    #                                           matches np.unpackbits default

    # compact differing values row-major (matches numpy boolean assignment).
    # Each row's differing samples are packed to its front by ONE stable
    # 110-wide row sort carrying the samples as payload (replacing an
    # argsort plus two (V,)-element random gathers); slots map to rows with
    # the boundary-marks cumsum instead of a (V,)-query binary search
    # (unmeasured on H100, ROADMAP C2), and each slot's row
    # offset comes from a boundary scatter + running max instead of a
    # (V,)-element gather of off[row_of].
    nnz_r = dm.sum(axis=1).astype(jnp.int32)                  # (R,)
    csum_r = jnp.cumsum(nnz_r)
    vq = jnp.arange(max_values, dtype=jnp.int32)
    valid_v = vq < csum_r[-1]
    off = csum_r - nnz_r                                       # (R,) exclusive
    bnd = jnp.zeros(max_values, jnp.int32).at[
        jnp.where(nnz_r > 0, off, max_values)].max(off, mode='drop')
    off_v = jax.lax.cummax(bnd)                                # == off[row_of]
    k_in_row = vq - off_v                                      # (for valid v)
    # the value stream is the row-major masked elements: a gather-free
    # log-step stream compaction (ops/gather.py stream_compact) instead of
    # a row sort + per-index flat gather (unmeasured on H100, ROADMAP C2)
    from ..ops.gather import stream_compact
    vals_c = stream_compact(rws.reshape(-1), dm.reshape(-1), max_values)
    values = jnp.where(valid_v, vals_c, 0).astype(jnp.int16)

    # ---- DPCM the value stream: delta from the previous masked value of the
    # same record (baseline for each record's first masked value) ----
    v32 = values.astype(jnp.int32)
    prev = jnp.where(k_in_row == 0, jnp.int32(baseline), jnp.roll(v32, 1))
    d = v32 - prev
    esc = (jnp.abs(d) > 127) & valid_v
    d8 = jnp.where(valid_v & ~esc, d, jnp.where(valid_v, -128, 0)) \
        .astype(jnp.int8)
    # escapes are rare (~1e-5 of values, host bound V/256+512): compact them
    # by inverting the running escape count with the hierarchical block
    # search (a handful of block gathers instead of log2(V) scalar-gather
    # rounds — the unrolled binary search this replaces cost ~23 serialized
    # gather passes at e_cap queries)
    from ..ops.randsample import search_sorted_rows
    epos1 = jnp.cumsum(esc.astype(jnp.int32))                  # 1-based
    n_escapes = epos1[-1]
    e_cap = esc_capacity(max_values)
    eq = jnp.arange(e_cap, dtype=jnp.int32) + 1
    # first index with epos1 >= eq  <=>  side='left' (int compares: exact)
    lo = search_sorted_rows(epos1[None, :], jnp.zeros(e_cap, jnp.int32),
                            eq, side='left')
    esc_vals = jnp.where(eq <= n_escapes,
                         values[jnp.clip(lo, 0, max_values - 1)],
                         0).astype(jnp.int16)

    # ---- compact mask transport: masked samples form <=2 contiguous runs
    # for ~83% of records (measured, realistic config), so each record ships
    # a 4-byte (start1, len1, start2, len2) descriptor; start1 == 255 (no
    # real start exceeds 109) escapes to a full 14-byte bitmask side stream.
    # 14 B/record was 35% of the wire payload; this cuts it to ~4-6 B ----
    prev_dm = jnp.pad(dm, ((0, 0), (1, 0)))[:, :-1]
    rise = dm & ~prev_dm
    runid = jnp.cumsum(rise.astype(jnp.int32), axis=1)
    n_runs = runid[:, -1]
    col_r = jnp.arange(spr, dtype=jnp.int32)[None, :]
    r1s = jnp.sum(jnp.where(rise & (runid == 1), col_r, 0), axis=1)
    r2s = jnp.sum(jnp.where(rise & (runid == 2), col_r, 0), axis=1)
    l1 = jnp.sum((dm & (runid == 1)).astype(jnp.int32), axis=1)
    l2 = jnp.sum((dm & (runid == 2)).astype(jnp.int32), axis=1)
    m_esc = n_runs > 2
    rec_mask4 = jnp.stack(
        [jnp.where(m_esc, 255, r1s), jnp.where(m_esc, 0, l1),
         jnp.where(m_esc, 0, r2s), jnp.where(m_esc, 0, l2)],
        axis=1).astype(jnp.uint8)
    mpos = jnp.cumsum(m_esc.astype(jnp.int32)) - 1
    rec_mask_esc = jnp.zeros((max_records, 14), jnp.uint8).at[
        jnp.where(m_esc, mpos, max_records)].set(masks, mode='drop')

    # ---- interval table: one row per non-empty interval, natural order;
    # the window-start word lets the host realign the noise bank to
    # reconstruct the overlay the device stripped.  When the (static)
    # shapes fit — B <= 128 windows, T <= 8192 samples — the four fields
    # bit-pack into TWO int32 words (word0 = start_rel<<14 | plen,
    # word1 = (w*2048+c)<<13 | left_ch; start_rel < 2T needs 14 bits,
    # plen <= T needs 14, wc <= 128*2048 needs 18, left_ch < T needs 13),
    # halving the meta wire bytes; expand_interval_meta dispatches on the
    # row width ----
    # per-interval fields gathered on the COMPACTED axis (take_i is the
    # live intervals' flat indices in ascending order — itv_live == live_f
    # because plen >= 1  <=>  nrec >= 1), so the table is a plain masked
    # write instead of a (B*C*K)-update scatter
    B_w = starts.shape[0]
    # start_c / plen_c / wc_c already computed on the compacted axis above
    w_i = wc_c // C_all
    c_i = wc_c % C_all
    left_ch_c = left_all.reshape(-1)[wc_c]
    if B_w <= 128 and T <= 8192:
        itv_rows = jnp.stack(
            [(start_c << 14) | plen_c,
             ((w_i * 2048 + c_i) << 13) | left_ch_c], axis=1)
    else:
        itv_rows = jnp.stack([w_i * 2048 + c_i, start_c, plen_c, left_ch_c],
                             axis=1)
    itv_meta = jnp.where(valid_i[:, None], itv_rows, 0).astype(jnp.int32)

    return dict(itv_meta=itv_meta, rec_masks=masks, rec_mask4=rec_mask4,
                rec_mask_esc=rec_mask_esc, rec_values=d8,
                rec_escapes=esc_vals, n_escapes=n_escapes)


@partial(jax.jit, static_argnames=('n_channels_total', 'n_samples',
                                   'max_intervals', 'max_records',
                                   'max_values', 'baseline'))
def pack_records_encoded(data, left_all, starts, ends, itv_valid, *,
                         n_channels_total: int,
                         n_samples: int,
                         max_intervals: int,
                         max_records: int,
                         max_values: int,
                         baseline: int):
    """Pack ZLE intervals into records in *encoded transport* form.

    Instead of the dense (max_records, 110) int16 payload, emits per record a
    110-bit mask of samples that differ from the predicted row — baseline
    inside the pulse, zero in the tail pad — plus the differing samples as a
    DPCM stream: each masked sample is sent as an int8 delta from the
    *previous masked sample of the same record* (baseline for the first one),
    with -128 reserved as an escape marker whose absolute int16 value rides a
    separate (tiny) escape buffer. Noise-free pulses are ~65% exactly
    baseline + ~17% tail pad; noisy/bright pulses are sample-to-sample smooth
    (noise deltas are a few ADC counts, S2 envelopes rise over ~50+ samples),
    so deltas almost always fit int8 and the value stream halves again vs
    int16. Metadata is sent per ZLE INTERVAL, not per record —
    [window*2048+channel, start, pulse_length, window_left], bit-packed
    into 2 int32 words when the static shapes allow, else 4 plain words;
    the host re-derives every record's (start, length, record_i) with
    `expand_interval_meta` (records of an interval are consecutive in the
    natural emission order). Exact by construction for any input.

    Returns dict(itv_meta (R, 2 or 4) int32 — R bounds the interval count
    since every live interval has >=1 record — rec_masks (R,14) uint8 (the
    full bitmask form, kept for oracles/tests; not shipped), rec_mask4
    (R,4) uint8 + rec_mask_esc (R,14) uint8 (the compact wire form: <=2-run
    descriptors with escaped full masks compacted in record order),
    rec_values (V,) int8, rec_escapes (esc_capacity(V),) int16,
    n_escapes () int32).
    """
    return _pack_streams(data, left_all, starts, ends, itv_valid,
                         n_channels_total=n_channels_total,
                         n_samples=n_samples, max_intervals=max_intervals,
                         max_records=max_records, max_values=max_values,
                         baseline=baseline)


@partial(jax.jit,
         static_argnames=('n_channels_total', 'n_samples', 'max_intervals',
                          'max_records', 'max_values', 'baseline'),
         donate_argnums=(0, 1, 2, 3, 4))
def pack_records_accumulate(out_itv, out_mask4, out_mesc, out_vals, out_escs,
                            offs,
                            data, left_all, starts, ends, itv_valid, *,
                            n_channels_total: int,
                            n_samples: int,
                            max_intervals: int,
                            max_records: int,
                            max_values: int,
                            baseline: int):
    """:func:`pack_records_encoded`, but the five transport streams are
    written in place into donated ROUND-level buffers at host-computed
    offsets, so one digitize round ships a handful of contiguous buffers
    instead of per-call slices + concatenations, each of which would be
    its own device program.

    Each call writes its FULL natural-size streams (max_records rows /
    max_values values) while offsets advance by the EXACT sizes, and calls
    execute in offset order (the donation chain serializes them), so each
    call's padded tail is overwritten by the next call's real data; the
    final tail past the last exact offset is sliced off host-side.  The
    full-width writes cost ~15 MB of extra HBM stores per call but keep
    the static-shape signature to (shape, max_records, max_values) — a
    per-call power-of-two write cap would multiply the compiled program
    variety ~5x.  Callers must size each buffer >= sum(exact sizes) +
    (that stream's full width) so no dynamic_update_slice start gets
    clamped (clamping would silently corrupt an earlier call's region).

    :param offs: (5,) int32 device array — write offsets for (itv words,
        mask4 rows, escaped-mask rows, values, escape values)
    :returns: (out_itv, out_mask4, out_mesc, out_vals, out_escs,
        rec_mask_esc_full, rec_escapes_full) — the last two keep the
        per-call full streams available for the rare host-side
        bound-overflow refetch.
    """
    p = _pack_streams(data, left_all, starts, ends, itv_valid,
                      n_channels_total=n_channels_total,
                      n_samples=n_samples, max_intervals=max_intervals,
                      max_records=max_records, max_values=max_values,
                      baseline=baseline)
    out_itv = jax.lax.dynamic_update_slice(
        out_itv, p['itv_meta'].reshape(-1), (offs[0],))
    out_mask4 = jax.lax.dynamic_update_slice(
        out_mask4, p['rec_mask4'], (offs[1], 0))
    out_mesc = jax.lax.dynamic_update_slice(
        out_mesc, p['rec_mask_esc'], (offs[2], 0))
    out_vals = jax.lax.dynamic_update_slice(
        out_vals, p['rec_values'], (offs[3],))
    out_escs = jax.lax.dynamic_update_slice(
        out_escs, p['rec_escapes'], (offs[4],))
    return (out_itv, out_mask4, out_mesc, out_vals, out_escs,
            p['rec_mask_esc'], p['rec_escapes'])


def expand_interval_meta(itv_meta):
    """Host-side record derivation from the per-interval transport table:
    returns (window, channel, start_sample, length, pulse_length, record_i,
    window_left), each (n_records,) numpy — records of an interval are
    consecutive in the natural emission order, so the expansion is a
    repeat + ramp.  Accepts both layouts the pack emits: the 2-word
    bit-packed form (row width 2) and the plain 4-word form."""
    spr = SAMPLES_PER_RECORD
    if itv_meta.shape[1] == 2:
        w0 = itv_meta[:, 0].astype(np.int64)
        w1 = itv_meta[:, 1].astype(np.int64)
        wc = w1 >> 13
        start = w0 >> 14
        plen = w0 & 0x3FFF
        left_ch_tab = w1 & 0x1FFF
    else:
        wc = itv_meta[:, 0].astype(np.int64)
        start = itv_meta[:, 1].astype(np.int64)
        plen = itv_meta[:, 2].astype(np.int64)
        left_ch_tab = itv_meta[:, 3].astype(np.int64)
    nrec = (plen + spr - 1) // spr
    rec_itv = np.repeat(np.arange(len(itv_meta)), nrec)
    k = np.arange(len(rec_itv)) - np.repeat(np.cumsum(nrec) - nrec, nrec)
    w_of = wc[rec_itv] >> 11
    c_of = wc[rec_itv] & 2047
    start_s = start[rec_itv] + k * spr
    m_plen = plen[rec_itv]
    length = np.clip(m_plen - k * spr, 0, spr)
    left_ch = left_ch_tab[rec_itv]
    return w_of, c_of, start_s, length, m_plen, k, left_ch


def noise_bank_ext_cm(bank):
    """Wrap-extended CHANNEL-MAJOR int16 host copy of the (L, Cn) noise
    bank: ``ext[c, x] == bank[x % L, c]`` for ``x < L + SAMPLES_PER_RECORD``.
    In this layout one record's overlay is a contiguous 110-sample slice of
    one row — the channel-minor gather it replaces touched a ~1 KB-strided
    cache line per sample (measured ~10x slower over ~400k records)."""
    cm = np.ascontiguousarray(bank.T).astype(np.int16, copy=False)
    return np.concatenate([cm, cm[:, :SAMPLES_PER_RECORD]], axis=1)


def add_noise_host(out, channel, start_s, length, left_ch, noise_ix_rec,
                   bank, ext_cm=None):
    """Re-apply, in place, the noise overlay the device stripped from the
    transport payload: ``out[r, k] += bank[(noise_ix_rec[r] + start_s[r] + k
    - left_ch[r]) % L, channel[r]]`` for k < length[r] and channels covered
    by the bank — the exact inverse of the residual view
    (:func:`gather_digitize` docstring; alignment semantics from reference
    rawdata.py:407-431).

    ``ext_cm``: optional precomputed :func:`noise_bank_ext_cm` of ``bank``
    (the production path caches it; built on the fly otherwise)."""
    L, Cn = bank.shape
    rows = np.flatnonzero((channel < Cn) & (length > 0))
    if not len(rows):
        return out
    if ext_cm is None:
        ext_cm = noise_bank_ext_cm(bank)
    spr = out.shape[1]
    assert spr <= SAMPLES_PER_RECORD
    k = np.arange(spr, dtype=np.int32)
    s0 = ((noise_ix_rec[rows].astype(np.int64) + start_s[rows]
           - left_ch[rows]) % L).astype(np.int32)
    nv = ext_cm[channel[rows, None], s0[:, None] + k[None, :]]
    out[rows] = out[rows] + np.where(k[None, :] < length[rows, None], nv, 0)
    return out


def decode_records(lengths, masks, d8, esc_vals, baseline):
    """Host-side inverse of `pack_records_encoded` (numpy, vectorized):
    rebuild the (n, 110) int16 record payload from per-record lengths,
    difference bitmasks, the int8 DPCM delta stream and the int16 escape
    values.

    `d8` may carry zero padding beyond the actual count (the device-side
    size is an upper bound); it is sliced to the mask popcount. `esc_vals`
    must be sliced exactly (its count comes from the pack's n_escapes)."""
    n = len(lengths)
    spr = SAMPLES_PER_RECORD
    length = np.asarray(lengths)
    out = np.where(np.arange(spr, dtype=np.int32)[None, :] < length[:, None],
                   np.int16(baseline), np.int16(0))
    if not n:
        return out
    mb = np.unpackbits(masks, axis=1, count=spr).astype(bool)
    V = int(mb.sum())
    if not V:
        return out
    d = d8[:V].astype(np.int32)
    nnz = mb.sum(axis=1)
    rows = np.flatnonzero(nnz)
    row_start = (np.cumsum(nnz) - nnz)[rows]
    row_end = row_start + nnz[rows]
    esc_pos = np.flatnonzero(d == -128)

    # fast vector path: per-row DPCM chains seeded at baseline are a global
    # cumsum minus its value at each row start (escapes — DPCM outliers, a
    # few per chunk — are patched by a tiny sequential pass; the general
    # reset-aware formulation costs ~8 passes over V vs 3 here)
    d[esc_pos] = 0
    g = np.cumsum(d)
    base_at_start = g[row_start] - d[row_start]
    v = (baseline + g) - np.repeat(base_at_start, nnz[rows])

    if len(esc_pos):
        assert len(esc_vals) >= len(esc_pos), (len(esc_vals), len(esc_pos))
        # each escape rebases its row's chain from that position to the next
        # escape in the same row (processed in order) or the row end
        e_row = np.searchsorted(row_start, esc_pos, side='right') - 1
        for e, r, val in zip(esc_pos, e_row, esc_vals[:len(esc_pos)]):
            v[e:row_end[r]] += int(val) - v[e]
    out[mb] = v.astype(np.int16)
    return out


def compact_mask4(masks):
    """Numpy reference of the pack kernel's compact mask transport: per
    record a (start1, len1, start2, len2) uint8 descriptor when the masked
    samples form <= 2 contiguous runs, start1 == 255 escaping to the full
    14-byte bitmask (returned compacted, in record order).  Returns
    (mask4 (R, 4) uint8, mask_esc (E, 14) uint8)."""
    spr = SAMPLES_PER_RECORD
    bits = np.unpackbits(masks, axis=1, count=spr).astype(bool)
    prev = np.zeros_like(bits)
    prev[:, 1:] = bits[:, :-1]
    rise = bits & ~prev
    runid = np.cumsum(rise, axis=1)
    n_runs = runid[:, -1]
    col = np.arange(spr)
    r1s = ((rise & (runid == 1)) * col).sum(axis=1)
    r2s = ((rise & (runid == 2)) * col).sum(axis=1)
    l1 = (bits & (runid == 1)).sum(axis=1)
    l2 = (bits & (runid == 2)).sum(axis=1)
    esc = n_runs > 2
    mask4 = np.stack([np.where(esc, 255, r1s), np.where(esc, 0, l1),
                      np.where(esc, 0, r2s), np.where(esc, 0, l2)],
                     axis=1).astype(np.uint8)
    return mask4, np.ascontiguousarray(masks[esc])


def expand_mask4(mask4, mask_esc):
    """Inverse of :func:`compact_mask4`: rebuild the (R, 14) uint8 bitmask
    array from the 4-byte run descriptors + escaped-mask side stream."""
    spr = SAMPLES_PER_RECORD
    R = len(mask4)
    esc = mask4[:, 0] == 255
    s1 = np.where(esc, 0, mask4[:, 0]).astype(np.int64)
    l1 = mask4[:, 1].astype(np.int64)
    s2 = np.where(esc, 0, mask4[:, 2]).astype(np.int64)
    l2 = mask4[:, 3].astype(np.int64)
    diff = np.zeros((R, spr + 1), np.int8)
    rows = np.arange(R)
    np.add.at(diff, (rows, s1), 1)
    np.add.at(diff, (rows, s1 + l1), -1)
    np.add.at(diff, (rows, s2), 1)
    np.add.at(diff, (rows, s2 + l2), -1)
    bits = np.cumsum(diff[:, :spr], axis=1) > 0
    out = np.packbits(bits, axis=1, bitorder='big')
    if out.shape[1] < 14:
        out = np.pad(out, ((0, 0), (0, 14 - out.shape[1])))
    n_esc = int(esc.sum())
    assert len(mask_esc) >= n_esc, (len(mask_esc), n_esc)
    out[esc] = mask_esc[:n_esc]
    return out
