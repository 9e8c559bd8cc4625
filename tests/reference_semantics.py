"""Plain-numpy oracles implementing the documented behaviour of the reference
simulator's numba kernels, used to property-test our device ops.

These are written from the behavioural contracts in SURVEY.md (s2.3): a
sequential hitfinder with holdoff, and per-photon SPE template scatter-add.
They intentionally mirror *behaviour*, not code.
"""
import numpy as np


def intervals_below_threshold(w, threshold, holdoff):
    """Sequential oracle for ZLE interval finding (behaviour of
    reference wfsim/utils.py:14-58): inclusive [l, r] bounds of runs of
    samples < threshold, where runs separated by <= holdoff above-threshold
    samples are merged; r is the last below-threshold index."""
    out = []
    in_interval = False
    start = end = -1
    last = len(w) - 1
    for i, x in enumerate(w):
        if x < threshold:
            if not in_interval:
                in_interval = True
                start = i
            end = i
        if in_interval and ((i == last) or (x >= threshold and i >= end + holdoff)):
            in_interval = False
            out.append((start, end))
    return out


def scatter_spe(times, channels, gains, left_sample, n_channels, n_samples,
                templates, dt=10):
    """Dense oracle for photon->waveform accumulation: photon at time t adds
    gain * templates[t % dt] starting at sample t // dt."""
    W = np.zeros((n_channels, n_samples), dtype=np.float64)
    L = templates.shape[1]
    for t, c, g in zip(times, channels, gains):
        s = int(t // dt) - left_sample
        r = int(t % dt)
        lo = max(s, 0)
        hi = min(s + L, n_samples)
        if hi <= lo or c < 0 or c >= n_channels:
            continue
        W[c, lo:hi] += g * templates[r][lo - s:hi - s]
    return W
