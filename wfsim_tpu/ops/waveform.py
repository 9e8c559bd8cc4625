"""Photons -> per-channel waveform grid.

This replaces the reference's innermost hot loop ``Pulse.add_current``
(reference: wfsim/core/pulse.py:276-318), which scatter-adds a 22-sample SPE
current template (one of 10 one-nanosecond sub-sample phases) per photon into
a per-channel waveform, one channel at a time in numba.

Device formulation (two phases, both dense):

1. **Phase histogram** — add each photon's gain into a (channels, 10,
   samples) histogram ``H`` indexed by (channel, remainder = t%dt,
   sample = t//dt - left).  Photons are sorted by cell and each cell summed
   in a fixed order, so the result is the same on every run (the reference
   coalesced same-ns photons by sorting too, pulse.py:297-313).  A batch
   of windows is histogrammed window by window, so a batch sharded over
   windows sorts on each device only its own windows' photons.
2. **Template convolution** — the waveform is then exactly a 1-D convolution
   along the sample axis with the (10 -> 1)-feature template bank:
   ``W[c, u] = sum_{r,k} H[c, r, u-k] * T[r, k]``, computed as banded
   matmuls over 128-sample blocks in full f32.

All shapes are static; validity is carried as a mask.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .segment import ordered_segment_sum

__all__ = ['make_templates', 'photons_to_waveform', 'template_extent']


def make_templates(pe_pulse_ts, pe_pulse_ys,
                   sample_duration: int = 10,
                   samples_before: int = 2,
                   samples_after: int = 20) -> np.ndarray:
    """Build the (sample_duration, template_length) SPE current template bank.

    Same construction as the reference (wfsim/core/pulse.py:146-187):
    interpolate the SPE pulse CDF so every template integrates to exactly one
    PE per sample_duration, one template per 1-ns sub-sample remainder.
    Template row r applies to photons with ``t % dt == r``.
    """
    ts = np.asarray(pe_pulse_ts, dtype=np.float64)
    cdf_y = np.cumsum(np.asarray(pe_pulse_ys, dtype=np.float64))

    def pe_pulse_cdf(x):
        return np.interp(x, ts, cdf_y, left=0.0, right=1.0)

    samples = np.linspace(-samples_before * sample_duration,
                          samples_after * sample_duration,
                          1 + samples_before + samples_after)
    templates = []
    for r in range(sample_duration):
        current = np.diff(pe_pulse_cdf(samples - r)) / sample_duration
        current *= (1 / sample_duration) / np.sum(current)
        templates.append(current)
    return np.asarray(templates, dtype=np.float32)


def template_extent(config) -> tuple:
    """(samples_before_pulse_center, samples_after_pulse_center)."""
    return (int(config.get('samples_before_pulse_center', 2)),
            int(config.get('samples_after_pulse_center', 20)))


@partial(jax.jit, static_argnames=('n_channels', 'n_samples', 'sample_duration'))
def photons_to_waveform(times, channels, gains, valid,
                        left_sample,
                        templates,
                        *,
                        n_channels: int,
                        n_samples: int,
                        sample_duration: int = 10):
    """Accumulate photon hits into a dense (n_channels, n_samples) waveform.

    Photon arrays may carry a leading window axis, (B, N): each window is
    histogrammed on its own and the result is (B * n_channels, n_samples),
    window b's channels in rows ``b * n_channels ...``.

    Device-side times are int32 nanosecond offsets from a host-tracked int64
    base time (windows are bounded well below 2^31 ns); this keeps the whole
    compute path in 32-bit arithmetic.

    :param times:    (N,) or (B, N) int32 photon arrival times [ns,
        window-relative]
    :param channels: int32 PMT channel per photon, shaped as ``times``
    :param gains:    float32 per-photon gain (electrons / PE)
    :param valid:    bool validity mask (padding slots are False)
    :param left_sample: scalar int — sample index (in the same relative frame)
        of waveform column 0
    :param templates: (sample_duration, L) float32 SPE template bank
    :returns: (n_channels, n_samples) float32 current waveform, in the same
        current units as the reference (pe / sample_duration scaled by gain).

    Placement matches the reference exactly: a photon at time t adds
    ``gain * templates[t % dt]`` starting at sample ``t // dt``
    (reference: wfsim/core/pulse.py:303-318).
    """
    dt = sample_duration
    t32 = times.astype(jnp.int32)
    s = (t32 // dt - left_sample).astype(jnp.int32)
    r = (t32 % dt).astype(jnp.int32)

    ok = valid & (s >= 0) & (s < n_samples) & (channels >= 0) & (channels < n_channels)
    g = jnp.where(ok, gains, 0.0).astype(jnp.float32)
    # Route masked photons to slot 0 with zero gain
    s = jnp.where(ok, s, 0)
    r = jnp.where(ok, r, 0)
    ch = jnp.where(ok, channels, 0).astype(jnp.int32)

    # Histogram layout (C, dt, T): the sample axis stays minormost, which
    # is the layout the superposition reads.  The sums are order-fixed: a
    # float scatter-add would run as GPU atomics, and a sample within an
    # ulp of an ADC rounding edge could digitize differently run to run.
    cell = (ch * dt + r) * n_samples + s
    size = n_channels * dt * n_samples
    if cell.ndim == 1:
        H = ordered_segment_sum(g, cell, size)
    else:
        H = jax.vmap(ordered_segment_sum, in_axes=(0, 0, None))(g, cell, size)
    H = H.reshape(-1, dt, n_samples)
    return _superpose_templates(H, templates.astype(jnp.float32))


#: output samples per superposition block
_BLOCK = 128


def _superpose_templates(H, templates):
    """Causal phase-bank convolution as a banded matmul, in full f32.

    ``W[c, u] = sum_{r,k} H[c, r, u-k] * T[r, k]`` over 128-sample output
    blocks: each block's (10, 128+L-1) input patch (L-1 samples of history)
    contracts its flattened (10*(128+L-1),) axis against a banded template
    matrix ``B[(r, m), u] = T[r, u-m+L-1]`` — one (rows, 1490) x (1490, 128)
    matmul per block, an unrolled loop of ``dynamic_slice`` + ``dot_general``
    that reads the padded histogram in place.  A sample count that is not a
    multiple of 128 is padded at the end and the padding sliced off; the
    samples kept depend only on earlier histogram columns.

    On the H100 this form beat ``lax.conv_general_dilated`` with the same
    precision (PERF.md, bring-up).  ``Precision.HIGHEST`` keeps the products
    in f32: TF32 would move samples across ADC rounding edges.
    """
    L = templates.shape[1]
    R, dt, T = H.shape
    S = _BLOCK
    nseg = -(-T // S)
    Hp = jnp.pad(H, ((0, 0), (0, 0), (L - 1, nseg * S - T)))
    M = S + L - 1
    u = jnp.arange(S, dtype=jnp.int32)[None, :]
    m = jnp.arange(M, dtype=jnp.int32)[:, None]
    k = u - m + (L - 1)                                     # (M, S)
    band = jnp.where((k >= 0) & (k < L),
                     templates[:, jnp.clip(k, 0, L - 1)],   # (dt, M, S)
                     0.0).reshape(dt * M, S)
    outs = []
    for j in range(nseg):
        Pj = jax.lax.dynamic_slice(Hp, (0, 0, j * S), (R, dt, M))
        outs.append(jax.lax.dot_general(
            Pj.reshape(R, dt * M), band,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST))
    return jnp.concatenate(outs, axis=1)[:, :T]
