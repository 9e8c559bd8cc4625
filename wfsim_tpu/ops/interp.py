"""On-device regular-grid interpolation.

The reference wraps detector maps in ``straxen.InterpolatingMap`` with
scattered-point weighted-nearest-neighbour interpolation evaluated on the
host (reference: wfsim/load_resource.py:383-402).  Scattered-point lookup is
a data-dependent neighbour search, so this framework re-grids
every map ONCE at load time onto a regular grid (host side, numpy/scipy) and
performs multilinear interpolation on device — a handful of gathers plus FMAs
that XLA fuses, constant-shape and vmappable.

A :class:`GridMap` is a pytree, so it can be passed straight into jitted
functions and sharded.
"""
from __future__ import annotations

import typing as ty
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ['GridMap', 'grid_lookup', 'regrid_scattered']


@jax.tree_util.register_pytree_node_class
class GridMap:
    """Regular-grid map: values on an N-d grid (N in 0..3) with an optional
    trailing output dimension (e.g. per-PMT patterns).

    values: (g1, ..., gN, out_dim) array. ``out_dim == 1`` for scalar maps.
    lows / highs: (N,) float arrays — grid extents per input dimension.
    """

    def __init__(self, values, lows, highs):
        self.values = jnp.asarray(values)
        self.lows = jnp.asarray(lows, dtype=jnp.float32)
        self.highs = jnp.asarray(highs, dtype=jnp.float32)

    # -- pytree protocol -----------------------------------------------------
    def tree_flatten(self):
        return (self.values, self.lows, self.highs), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.values, obj.lows, obj.highs = children
        return obj

    # -- constructors ----------------------------------------------------------
    @classmethod
    def constant(cls, const: float, out_dim: int = 1, ndim_in: int = 1):
        """Constant map (same role as the reference's DummyMap,
        wfsim/load_resource.py:437-457)."""
        shape = (2,) * ndim_in + (out_dim,)
        vals = np.full(shape, float(const), dtype=np.float32)
        return cls(vals, np.zeros(ndim_in), np.ones(ndim_in))

    @classmethod
    def from_axes(cls, values: np.ndarray, axes: ty.Sequence[np.ndarray]):
        """Build from grid axis coordinate arrays (must be uniformly spaced;
        non-uniform axes are resampled by the loader before reaching here)."""
        values = np.asarray(values)
        if values.ndim == len(axes):
            values = values[..., None]
        lows = np.array([a[0] for a in axes], dtype=np.float32)
        highs = np.array([a[-1] for a in axes], dtype=np.float32)
        return cls(values.astype(np.float32), lows, highs)

    @property
    def ndim_in(self) -> int:
        return self.values.ndim - 1

    @property
    def out_dim(self) -> int:
        return self.values.shape[-1]

    def __call__(self, points):
        """Interpolate at ``points`` of shape (n, ndim_in) (or (n,) for 1-d).
        Returns (n, out_dim), or (n,) if out_dim == 1."""
        return grid_lookup(self.values, self.lows, self.highs, points)


@partial(jax.jit, static_argnames=())
def grid_lookup(values, lows, highs, points):
    """Multilinear interpolation of ``values`` (grid shape + out_dim) at
    ``points`` (n, d).  Clamps to the grid boundary (maps are defined over the
    detector volume; out-of-range queries saturate like the reference's
    nearest-neighbour behaviour at the hull)."""
    points = jnp.atleast_2d(jnp.asarray(points, dtype=jnp.float32))
    if points.ndim == 1:
        points = points[:, None]
    d = values.ndim - 1
    grid_shape = jnp.array(values.shape[:-1], dtype=jnp.float32)
    # normalized fractional grid coordinates
    span = jnp.maximum(highs - lows, 1e-30)
    f = (points - lows) / span * (grid_shape - 1.0)
    f = jnp.clip(f, 0.0, grid_shape - 1.0)
    i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0,
                  jnp.array(values.shape[:-1], dtype=jnp.int32) - 2 + 1)
    # Frac weight per dim
    w = f - i0.astype(jnp.float32)

    flat_vals = values.reshape(-1, values.shape[-1])
    strides = np.ones(d, dtype=np.int64)
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * values.shape[k + 1]
    strides = jnp.asarray(strides, dtype=jnp.int32)

    out = jnp.zeros((points.shape[0], values.shape[-1]), dtype=values.dtype)
    # Unrolled 2^d corner accumulation (d <= 3 in practice)
    for corner in range(2 ** d):
        bits = [(corner >> k) & 1 for k in range(d)]
        idx = i0 + jnp.array(bits, dtype=jnp.int32)
        idx = jnp.minimum(idx, jnp.array(values.shape[:-1], dtype=jnp.int32) - 1)
        flat_idx = (idx * strides).sum(axis=1)
        weight = jnp.ones(points.shape[0], dtype=values.dtype)
        for k, b in enumerate(bits):
            weight = weight * jnp.where(b, w[:, k], 1.0 - w[:, k])
        out = out + weight[:, None] * flat_vals[flat_idx]
    if values.shape[-1] == 1:
        return out[:, 0]
    return out


def regrid_scattered(points: np.ndarray,
                     values: np.ndarray,
                     n_grid: int = 50,
                     lows=None, highs=None,
                     power: float = 1.0,
                     k_neighbors: int = None) -> GridMap:
    """Host-side: resample a scattered-point map (the straxen
    ``WeightedNearestNeighbors`` representation) onto a regular grid so the
    device only ever does multilinear lookups.

    Grid-node values use straxen's own estimator (InterpolateAndExtrapolate,
    straxen/itp_map.py as wrapped by wfsim/load_resource.py:383-402):
    inverse-distance (power 1) weighting over the ``2 * ndim`` nearest
    points — paid once at load time instead of per query, so the only
    residual error vs the reference is the multilinear interpolation
    between grid nodes (bounded by tests/test_ops.py's WNN-oracle test).
    """
    from scipy.spatial import cKDTree

    points = np.asarray(points, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if values.ndim == 1:
        values = values[:, None]
    d = points.shape[1]
    if k_neighbors is None:
        k_neighbors = 2 * d
    if lows is None:
        lows = points.min(axis=0)
    if highs is None:
        highs = points.max(axis=0)
    axes = [np.linspace(lows[i], highs[i], n_grid) for i in range(d)]
    mesh = np.meshgrid(*axes, indexing='ij')
    grid_pts = np.stack([mm.ravel() for mm in mesh], axis=1)

    tree = cKDTree(points)
    k = min(k_neighbors, len(points))
    dist, idx = tree.query(grid_pts, k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    wgt = 1.0 / np.maximum(dist, 1e-12) ** power
    wgt /= wgt.sum(axis=1, keepdims=True)
    est = np.einsum('nk,nko->no', wgt, values[idx])
    grid_vals = est.reshape(*(n_grid,) * d, values.shape[1])
    return GridMap.from_axes(grid_vals.astype(np.float32), axes)
