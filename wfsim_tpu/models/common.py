"""Shared physics sampling helpers (branchless, fixed-shape)."""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ['singlet_triplet_delays', 'skew_normal', 'rz_lookup', 'trunc_int']


def trunc_int(x):
    """float -> int32 with truncation toward zero — matches numpy's
    ``.astype(np.int64)`` used throughout the reference for timing draws."""
    return jnp.trunc(x).astype(jnp.int32)


def _key2(key):
    """Accept either one key (split on the spot) or a pre-split pair.

    The hot kernels do ONE wide split at their top and thread concrete
    keys down, so that key splits do not multiply into many small device
    operations (unmeasured on H100, ROADMAP C2); the single-key form
    remains for casual callers.
    """
    if isinstance(key, (tuple, list)):
        return key[0], key[1]
    if getattr(key, 'ndim', 0) >= 1 and key.shape[0] >= 2:
        return key[0], key[1]
    return jax.random.split(key)


def singlet_triplet_delays(key, n_or_shape, singlet_ratio, t1, t3):
    """Excimer decay delays: choose singlet/triplet lifetime per sample, then
    exponential (reference: wfsim/core/pulse.py:320-341).  ``key`` may be a
    pre-split pair (see :func:`_key2`)."""
    shape = (n_or_shape,) if isinstance(n_or_shape, int) else n_or_shape
    k1, k2 = _key2(key)
    is_singlet = jax.random.uniform(k1, shape) < singlet_ratio
    lifetime = jnp.where(is_singlet, t1, t3)
    return trunc_int(jax.random.exponential(k2, shape) * lifetime)


def skew_normal(key, loc, scale, a, shape):
    """Azzalini skew-normal sampler (scipy.stats.skewnorm.rvs equivalent,
    used for the S2 area-fraction-top smearing, reference s2.py:660-665).
    ``key`` may be a pre-split pair (see :func:`_key2`)."""
    k1, k2 = _key2(key)
    delta = a / jnp.sqrt(1.0 + a ** 2)
    u0 = jax.random.normal(k1, shape)
    v = jax.random.normal(k2, shape)
    z = delta * jnp.abs(u0) + jnp.sqrt(1 - delta ** 2) * v
    return loc + scale * z


def rz_lookup(gridmap, z, xy):
    """Evaluate an (r, z) map at cartesian positions — the reference wraps its
    field-dependency maps the same way (load_resource.py:335-338)."""
    r = jnp.sqrt(xy[:, 0] ** 2 + xy[:, 1] ** 2)
    return gridmap(jnp.stack([r, z], axis=1))
