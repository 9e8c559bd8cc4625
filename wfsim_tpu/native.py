"""Native host kernels with numpy fallbacks.

The C extension (native/fastpath.c, built by ``pip install -e .`` or
``python setup.py build_ext --inplace``) accelerates the host hot loops;
everything here works identically without it.
"""
from __future__ import annotations

import os

import numpy as np


def _autobuild():
    """Best-effort build of the C extension when no built copy is importable.

    Compiles ``native/fastpath.c`` into ``build/native/`` of the checkout
    (listed in ``.gitignore``), under a name keyed by a hash of the source
    and the Python ABI tag, so a fresh copy of the same tree finds the
    build again and an edited source never loads a stale one.  Any failure
    (no compiler, read-only tree, installed-wheel layout without the
    source) leaves the numpy fallbacks in charge.  Set
    WFSIM_TPU_NO_AUTOBUILD=1 to disable.
    """
    if os.environ.get('WFSIM_TPU_NO_AUTOBUILD'):
        return None
    import hashlib
    import importlib.util
    import subprocess
    import sysconfig
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        src = os.path.join(root, 'native', 'fastpath.c')
        if not os.path.isfile(src):
            return None
        with open(src, 'rb') as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        suffix = sysconfig.get_config_var('EXT_SUFFIX') or '.so'
        out_dir = os.path.join(root, 'build', 'native')
        so = os.path.join(out_dir, '_fastpath_%s%s' % (digest, suffix))
        if not os.path.isfile(so):
            os.makedirs(out_dir, exist_ok=True)
            cc = os.environ.get('CC', 'cc')
            tmp = so + '.tmp%d' % os.getpid()
            subprocess.run(
                [cc, '-O3', '-fPIC', '-shared', src,
                 '-I' + sysconfig.get_paths()['include'], '-o', tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)   # atomic: concurrent builders agree
        spec = importlib.util.spec_from_file_location(
            'wfsim_tpu._fastpath', so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except Exception:
        return None


try:
    from . import _fastpath
    HAVE_NATIVE = True
except ImportError:
    _fastpath = _autobuild()
    HAVE_NATIVE = _fastpath is not None

__all__ = ['HAVE_NATIVE', 'pack_windows', 'find_intervals_below_threshold',
           'decode_residual_records']


def pack_windows(pool_t, pool_ch, pool_gain, piece_lo, piece_cnt, piece_win,
                 win_base_ns, out):
    """Gather photon-pool ranges into padded (B, 3, N) device-input arrays.

    ``out`` must be pre-filled with the padding sentinel (channel -1).
    Pieces must be grouped by window.  Returns per-window photon counts.
    """
    if HAVE_NATIVE and out.flags['C_CONTIGUOUS']:
        return _fastpath.pack_windows(
            np.ascontiguousarray(pool_t, np.int64),
            np.ascontiguousarray(pool_ch, np.int32),
            np.ascontiguousarray(pool_gain, np.float32).view(np.int32),
            np.ascontiguousarray(piece_lo, np.int64),
            np.ascontiguousarray(piece_cnt, np.int64),
            np.ascontiguousarray(piece_win, np.int32),
            np.ascontiguousarray(win_base_ns, np.int64),
            out)
    # numpy fallback
    B = len(win_base_ns)
    fill = [0] * B
    slot_n = out.shape[2]
    gain_bits = np.asarray(pool_gain, np.float32).view(np.int32)
    for m in range(len(piece_lo)):
        w = int(piece_win[m])
        if w < 0 or w >= B:
            continue
        lo, c = int(piece_lo[m]), int(piece_cnt[m])
        c = min(c, slot_n - fill[w])
        if c <= 0:
            continue
        f = fill[w]
        out[w, 0, f:f + c] = (pool_t[lo:lo + c] - win_base_ns[w]).astype(np.int32)
        out[w, 1, f:f + c] = pool_ch[lo:lo + c]
        out[w, 2, f:f + c] = gain_bits[lo:lo + c]
        fill[w] += c
    return fill


def find_intervals_below_threshold(w, threshold, holdoff, result_buffer):
    """Sequential ZLE hitfinder with the reference's exact semantics
    (reference: wfsim/utils.py:14-58).  API-compatible replacement for the
    reference's numba kernel."""
    if HAVE_NATIVE:
        return _fastpath.find_intervals_below_threshold(
            np.ascontiguousarray(w, np.int64), int(threshold), int(holdoff),
            np.ascontiguousarray(result_buffer, np.int64))
    n = 0
    in_interval = False
    start = end = -1
    T = len(w)
    K = len(result_buffer)
    for i, x in enumerate(w):
        if x < threshold:
            if not in_interval:
                in_interval = True
                start = i
            end = i
        if in_interval and ((i == T - 1)
                            or (x >= threshold and i >= end + holdoff)):
            in_interval = False
            if n < K:
                result_buffer[n, 0] = start
                result_buffer[n, 1] = end
                n += 1
            else:
                break
    return n


def decode_residual_records(lengths, mask4, mask_esc, d8, esc_vals, baseline,
                            channel=None, start_s=None, left_ch=None,
                            nix_rec=None, bank=None, ext_cm=None,
                            out_records=None, rowmap=None,
                            time_ns=None, pulse_length=None, record_i=None,
                            rec_dt=None):
    """Decode the residual record transport and (optionally) re-apply the
    noise overlay, in one fused native pass when the extension is built;
    otherwise via the numpy reference path (pipeline.digitize.decode_records
    + add_noise_host), which this must match bitwise (tests/test_native.py).

    :param lengths: (R,) per-record sample counts
    :param mask4: (R, 4) uint8 compact mask descriptors (see
        pipeline.digitize.compact_mask4); start1 == 255 rows consume the
        next full bitmask of ``mask_esc``
    :param mask_esc: (Em, 14) uint8 escaped full bitmasks, record order
    :param d8/esc_vals: the DPCM/escape streams (esc_vals sliced exactly to
        the escape count)
    :param channel/start_s/left_ch/nix_rec/bank/ext_cm: noise re-add inputs
        (all None = no noise); ``ext_cm`` is noise_bank_ext_cm(bank)
    :param out_records: optional C-contiguous structured record array with a
        ``(110,) int16 'data'`` field — record r's samples are written
        straight into ``out_records['data'][rowmap[r]]`` (``rowmap`` None =
        row r), skipping the dense temp entirely (the collect stage passes
        the time-sorted arena slice with the sort permutation here)
    :param time_ns/pulse_length/record_i/rec_dt: optional strax header fill
        (requires ``out_records`` + ``channel``): the time/length/dt/channel/
        pulse_length/record_i fields of each destination row are written in
        the same pass as its samples, replacing six strided structured-array
        assignments that each re-touch every record row on the host
    :returns: (R, 110) int16 record payload, or None with ``out_records``
    """
    from .pipeline.digitize import (decode_records, add_noise_host,
                                    noise_bank_ext_cm, expand_mask4,
                                    SAMPLES_PER_RECORD)
    R = len(lengths)
    noise_on = bank is not None
    hdr_on = time_ns is not None
    if hdr_on and (out_records is None or channel is None):
        raise ValueError('header fill requires out_records and channel')
    if HAVE_NATIVE:
        if out_records is not None:
            dtf = out_records.dtype
            data_off = dtf.fields['data'][1]
            pitch = dtf.itemsize
            dest = out_records
            rm = (np.ascontiguousarray(rowmap, np.int64)
                  if rowmap is not None else np.zeros(0, np.int64))
        else:
            dtf = None
            dest = np.empty((R, SAMPLES_PER_RECORD), np.int16)
            data_off, pitch = 0, 2 * SAMPLES_PER_RECORD
            rm = np.zeros(0, np.int64)
        if noise_on and ext_cm is None:
            ext_cm = noise_bank_ext_cm(bank)
        L = int(bank.shape[0]) if noise_on else 0
        zi32 = np.zeros(0, np.int32)
        zi64 = np.zeros(0, np.int64)
        if hdr_on:
            ht = np.ascontiguousarray(time_ns, np.int64)
            hp = np.ascontiguousarray(pulse_length, np.int32)
            hr = np.ascontiguousarray(record_i, np.int32)
            ho = np.asarray([dtf.fields[f][1] for f in
                             ('time', 'length', 'dt', 'channel',
                              'pulse_length', 'record_i')]
                            + [int(rec_dt)], np.int64)
        else:
            ht = ho = zi64
            hp = hr = zi32
        _fastpath.decode_records_noise(
            np.ascontiguousarray(mask4, np.uint8),
            np.ascontiguousarray(mask_esc, np.uint8),
            np.ascontiguousarray(d8, np.int8),
            np.ascontiguousarray(esc_vals, np.int16),
            np.ascontiguousarray(lengths, np.int32),
            dest, int(baseline),
            np.ascontiguousarray(channel, np.int32)
            if (noise_on or hdr_on) else zi32,
            np.ascontiguousarray(start_s, np.int64) if noise_on else zi64,
            np.ascontiguousarray(left_ch, np.int64) if noise_on else zi64,
            np.ascontiguousarray(nix_rec, np.int32) if noise_on else zi32,
            np.ascontiguousarray(ext_cm, np.int16) if noise_on
            else np.zeros(0, np.int16),
            L, rm, pitch, int(data_off),
            ht, hp, hr, ho)
        return None if out_records is not None else dest
    out = decode_records(lengths, expand_mask4(np.asarray(mask4),
                                               np.asarray(mask_esc)),
                         d8, esc_vals, baseline)
    if noise_on:
        add_noise_host(out, channel, start_s, lengths, left_ch, nix_rec,
                       bank, ext_cm=ext_cm)
    if out_records is not None:
        idx = (np.asarray(rowmap, np.int64) if rowmap is not None
               else slice(0, R))
        out_records['data'][idx] = out
        if hdr_on:
            rows = out_records[idx]
            rows['time'] = time_ns
            rows['length'] = np.asarray(lengths, np.int32)
            rows['dt'] = np.int16(rec_dt)
            rows['channel'] = np.asarray(channel).astype(np.int16)
            rows['pulse_length'] = np.asarray(pulse_length, np.int32)
            rows['record_i'] = np.asarray(record_i).astype(np.int16)
            if rowmap is not None:
                out_records[idx] = rows
        return None
    return out
