"""Resource resolution: config -> in-memory detector-response assets.

Same role as the reference's ``load_resource.py`` (reference:
wfsim/load_resource.py:34-380): turn config entries into maps, SPE tables,
afterpulse CDFs and noise banks, cached by config hash.  Differences, by
design, for the device:

* every spatial map is re-gridded at load time into a :class:`GridMap`
  (regular grid + device multilinear lookup) instead of host-side
  scattered-point interpolation;
* missing external calibration files fall back to synthetic, physically
  shaped stand-ins (resources/synthetic.py) so the chain is hermetic;
* no network access — files resolve from absolute paths, the configured
  ``url_base`` when it is a local directory, or ``$WFSIM_TPU_AUX_DIR``.

Supported file formats: .json / .json.gz (straxen InterpolatingMap layout,
scattered or regular-grid), .npy / .npz, .pkl / .pkl.gz, .csv.
"""
from __future__ import annotations

import gzip
import json
import os
import os.path as osp
import pickle
import logging

import numpy as np

from ..config import deterministic_hash
from ..ops.interp import GridMap, regrid_scattered
from .spe import build_uniform_to_pe, spe_table_from_csv, GRID_POINTS
from . import synthetic as synth

log = logging.getLogger('wfsim_tpu.resource')

__all__ = ['Resource', 'load_config', 'make_map', 'DummyMap', 'MultiMap']

_cached_configs = {}


def load_config(config):
    """Cached Resource factory (reference: wfsim/load_resource.py:34-46)."""
    h = deterministic_hash({k: config.get(k) for k in _RESOURCE_KEYS
                            if k in config})
    if h in _cached_configs:
        return _cached_configs[h]
    result = Resource(config)
    _cached_configs[h] = result
    return result


_RESOURCE_KEYS = [
    'detector', 'gains', 'n_tpc_pmts', 'n_top_pmts',
    's1_pattern_map', 's1_lce_correction_map', 's2_pattern_map',
    's2_correction_map', 'se_gain_map', 'photon_area_distribution',
    'photon_ap_cdfs', 'ele_ap_pdfs', 'noise_file', 'fdc_3d',
    'field_distortion_comsol_map', 'field_dependencies_map',
    'diffusion_longitudinal_map', 'gas_gap_map', 'garfield_gas_gap_map',
    's2_luminescence', 's2_luminescence_gg', 's1_time_spline',
    's2_time_spline', 'nv_pmt_qe', 'url_base',
    'enable_gas_gap_warping', 'enable_pmt_afterpulses',
    'enable_electron_afterpulses', 'enable_noise',
    'enable_field_dependencies', 'field_distortion_model',
    's2_luminescence_model', 's2_mean_area_fraction_top',
]


# ---------------------------------------------------------------------------
# File access


def _search_dirs(config):
    dirs = []
    base = config.get('url_base', '')
    if isinstance(base, str) and base.startswith('/'):
        dirs.append(base)
    env = os.environ.get('WFSIM_TPU_AUX_DIR')
    if env:
        dirs.append(env)
    return dirs


#: GitHub raw bases the reference falls back to for named public aux files
#: (load_resource.py:178-196: private ntauxfiles checkout first, then the
#: public repositories raw URLs)
_GITHUB_RAW_BASES = (
    'https://raw.githubusercontent.com/XENONnT/private_nt_aux_files/master/sim_files/',  # noqa: E501
    'https://raw.githubusercontent.com/XENONnT/WFSim/master/files/',
    'https://raw.githubusercontent.com/XENON1T/WFSim/master/files/',
)


def _download_cache_dir():
    d = os.environ.get('WFSIM_TPU_DOWNLOAD_CACHE') or osp.join(
        osp.expanduser('~'), '.cache', 'wfsim_tpu_aux')
    os.makedirs(d, exist_ok=True)
    return d


def _fetch_remote(config, fname):
    """Remote acquisition chain for a NAMED public resource, mirroring the
    reference's get_file_path (load_resource.py:131-196): straxen
    MongoDownloader when a straxen install + DB credentials exist, then
    GitHub raw URLs (``url_base`` may override the first base).  Downloads
    land in a persistent cache dir keyed by file name.  Disabled unless
    ``WFSIM_TPU_ALLOW_DOWNLOAD=1`` (simulation hosts are often air-gapped;
    this environment has no egress, so the chain is exercised only by the
    mocked unit test)."""
    if os.environ.get('WFSIM_TPU_ALLOW_DOWNLOAD') != '1':
        return None
    cache = _download_cache_dir()
    cached = osp.join(cache, fname)
    if osp.exists(cached):
        return cached
    try:                                   # straxen MongoDownloader path
        from straxen import MongoDownloader
        path = MongoDownloader().download_single(fname)
        if path and osp.exists(path):
            return path
    except Exception:
        pass
    bases = []
    ub = config.get('url_base', '')
    if isinstance(ub, str) and ub.startswith('http'):
        bases.append(ub if ub.endswith('/') else ub + '/')
    bases += list(_GITHUB_RAW_BASES)
    import urllib.request
    for base in bases:
        try:
            tmp = cached + '.part'
            urllib.request.urlretrieve(base + fname, tmp)
            os.replace(tmp, cached)
            log.info('downloaded %s from %s', fname, base)
            return cached
        except Exception:
            continue
    return None


def get_file_path(config, fname):
    """Resolve a resource file name to a local path, or None.

    Resolution chain (reference: load_resource.py:131-196): absolute path →
    local ``url_base`` dir / $WFSIM_TPU_AUX_DIR → remote acquisition
    (straxen MongoDownloader, then GitHub raw URLs into a persistent cache;
    opt-in via WFSIM_TPU_ALLOW_DOWNLOAD=1)."""
    if not fname or not isinstance(fname, str):
        return None
    if fname.startswith('/'):
        return fname if osp.exists(fname) else None
    for d in _search_dirs(config):
        p = osp.join(d, fname)
        if osp.exists(p):
            return p
    return _fetch_remote(config, fname)


def _read_any(path):
    """Load a resource file by extension."""
    if path.endswith('.json'):
        with open(path) as f:
            return json.load(f)
    if path.endswith('.json.gz'):
        with gzip.open(path, 'rt') as f:
            return json.load(f)
    if path.endswith('.npy'):
        return np.load(path, allow_pickle=True)
    if path.endswith('.npz'):
        d = np.load(path, allow_pickle=True)
        return d['arr_0'] if 'arr_0' in d else d
    if path.endswith('.pkl'):
        with open(path, 'rb') as f:
            return pickle.load(f)
    if path.endswith(('.pkl.gz', '.pklz')):
        with gzip.open(path, 'rb') as f:
            return pickle.load(f)
    if path.endswith('.csv'):
        import pandas as pd
        return pd.read_csv(path)
    raise ValueError(f'Unknown resource format: {path}')


# ---------------------------------------------------------------------------
# Map construction


class DummyMap:
    """Constant map (API-compatible with the reference's DummyMap,
    wfsim/load_resource.py:437-457), backed by a GridMap for device use."""

    def __init__(self, const, shape=()):
        self.const = const
        self.shape = tuple(shape)
        out_dim = int(np.prod(self.shape)) if self.shape else 1
        self.grid = GridMap.constant(const, out_dim=max(out_dim, 1), ndim_in=3)

    def __call__(self, x, **kwargs):
        shape = [len(x)] + list(self.shape)
        return np.ones(shape) * self.const

    def reduce_last_dim(self):
        assert len(self.shape) >= 1, 'Need at least 1 dim to reduce further'
        const = self.const * self.shape[-1]
        shape = list(self.shape)
        shape[-1] = 1
        return DummyMap(const, shape)


class MultiMap:
    """Named-submap container (straxen InterpolatingMap files may hold several
    maps selected with ``map_name``)."""

    def __init__(self, maps: dict, default: str = 'map'):
        self.maps = maps
        self.default = default

    def __call__(self, points, map_name=None, **kw):
        m = self.maps[map_name or self.default]
        return np.asarray(m(points))

    def __getitem__(self, name):
        return self.maps[name]

    def names(self):
        return list(self.maps)


def _axes_are_regular_spec(cs):
    # straxen regular-grid spec: [['x', [min, max, n]], ...]
    return (len(cs) > 0 and isinstance(cs[0], (list, tuple)) and len(cs[0]) == 2
            and isinstance(cs[0][0], str))


def interpolating_map_to_grid(map_data: dict, n_grid: int = 50) -> MultiMap:
    """Convert a straxen InterpolatingMap payload into GridMaps.

    Handles both the scattered-point layout (list of coordinates + values,
    re-gridded via inverse-distance weighting) and the regular-grid layout.
    """
    cs = map_data['coordinate_system']
    ignore = {'coordinate_system', 'name', 'description', 'timestamp',
              'compressed', 'quantized', 'irregular', 'deviation_matrix'}
    map_names = [k for k in map_data if k not in ignore]
    out = {}
    if _axes_are_regular_spec(cs):
        axes = []
        for _, spec in cs:
            if len(spec) == 3:
                axes.append(np.linspace(spec[0], spec[1], int(spec[2])))
            else:
                axes.append(np.asarray(spec, dtype=np.float64))
        for name in map_names:
            vals = np.asarray(map_data[name], dtype=np.float32)
            # resample non-uniform axes onto uniform grids if needed
            vals, axes_u = _uniformize(vals, axes)
            out[name] = GridMap.from_axes(vals, axes_u)
    else:
        pts = np.asarray(cs, dtype=np.float64)
        if pts.ndim == 1:
            pts = pts[:, None]
        for name in map_names:
            vals = np.asarray(map_data[name], dtype=np.float64)
            out[name] = regrid_scattered(pts, vals, n_grid=n_grid)
    default = 'map' if 'map' in out else map_names[0]
    return MultiMap(out, default=default)


def _uniformize(vals, axes):
    """Resample map values defined on possibly non-uniform axes onto uniform
    axes (multilinear lookup assumes uniform spacing)."""
    new_axes = []
    need = False
    for a in axes:
        d = np.diff(a)
        if len(d) and not np.allclose(d, d[0], rtol=1e-3):
            need = True
        new_axes.append(np.linspace(a[0], a[-1], len(a)))
    if not need:
        return vals, axes
    from scipy.interpolate import RegularGridInterpolator
    extra = vals.shape[len(axes):]
    rgi = RegularGridInterpolator(tuple(axes), vals, bounds_error=False,
                                  fill_value=None)
    mesh = np.meshgrid(*new_axes, indexing='ij')
    q = np.stack([mm.ravel() for mm in mesh], axis=1)
    newvals = rgi(q).reshape(*[len(a) for a in new_axes], *extra)
    return newvals.astype(np.float32), new_axes


def _decompress_pattern(map_data: dict) -> dict:
    map_data = dict(map_data)
    if 'compressed' in map_data:
        compressor, dtype, shape = map_data['compressed']
        raw = map_data['map']
        if compressor in ('zstd', 'blosc'):
            try:
                if compressor == 'zstd':
                    import zstandard
                    raw = zstandard.ZstdDecompressor().decompress(raw)
                else:
                    import blosc
                    raw = blosc.decompress(raw)
            except ImportError as e:
                raise RuntimeError(
                    f'Pattern map uses {compressor} compression but the codec '
                    f'is not installed') from e
        map_data['map'] = np.frombuffer(raw, dtype=dtype).reshape(*shape)
        del map_data['compressed']
    if 'quantized' in map_data:
        map_data['map'] = map_data['quantized'] * map_data['map'].astype(np.float32)
        del map_data['quantized']
    return map_data


def make_map(entry, config=None, n_grid: int = 50, method=None):
    """Resolve one config map entry: dummy-list / file name / None."""
    config = config or {}
    if entry is None or entry is False or entry == '':
        return None
    if isinstance(entry, list) and entry and entry[0] == 'constant dummy':
        return DummyMap(entry[1], entry[2] if len(entry) > 2 else ())
    if isinstance(entry, str):
        path = get_file_path(config, entry)
        if path is None:
            raise FileNotFoundError(
                f'Resource file {entry!r} not found locally. Set url_base to a '
                f'local directory or $WFSIM_TPU_AUX_DIR, or use a '
                f'["constant dummy", value, shape] entry.')
        data = _read_any(path)
        if isinstance(data, dict) and 'coordinate_system' in data:
            return interpolating_map_to_grid(_decompress_pattern(data), n_grid)
        raise ValueError(f'Unsupported map payload in {path}')
    raise TypeError(f"Can't handle map entry {entry!r}")


def make_patternmap(entry, config=None, pmt_mask=None, n_grid: int = 30):
    """Pattern-map variant: decompress/dequantize and zero masked PMTs
    (reference: wfsim/load_resource.py:403-435)."""
    if isinstance(entry, list) and entry and entry[0] == 'constant dummy':
        return DummyMap(entry[1], entry[2] if len(entry) > 2 else ())
    m = make_map(entry, config, n_grid=n_grid)
    if m is not None and pmt_mask is not None and isinstance(m, MultiMap):
        for g in m.maps.values():
            vals = np.asarray(g.values)
            if vals.shape[-1] == len(pmt_mask):
                vals[..., ~np.asarray(pmt_mask)] = 0.0
                g.values = __import__('jax.numpy', fromlist=['asarray']).asarray(vals)
    return m


def _as_gridmap(m, out_dim=1, ndim_in=2):
    """Normalize DummyMap / MultiMap / GridMap / None to a GridMap."""
    if m is None:
        return None
    if isinstance(m, DummyMap):
        want = int(np.prod(m.shape)) if m.shape else 1
        return GridMap.constant(m.const, out_dim=max(want, 1), ndim_in=ndim_in)
    if isinstance(m, MultiMap):
        return m.maps[m.default]
    return m


# ---------------------------------------------------------------------------
# Resource


class Resource:
    """All in-memory assets for one configuration.

    Mirrors the reference Resource construction flow per detector
    (wfsim/load_resource.py:198-380) including the derived-map fallbacks:
    LCE map from pattern-map sum, S2 correction from pattern-map sum with
    median scaling, and the S2 area-fraction-top rescale.
    """

    def __init__(self, config):
        detector = config.get('detector', 'XENONnT')
        n_pmts = int(config['n_tpc_pmts'])
        n_top = int(config['n_top_pmts'])
        gains = np.asarray(config['gains'], dtype=np.float64)
        pmt_mask = gains > 0

        # --- Pattern maps -------------------------------------------------
        self.s1_pattern_map = make_patternmap(
            config.get('s1_pattern_map'), config, pmt_mask)
        self.s2_pattern_map = make_patternmap(
            config.get('s2_pattern_map'), config, pmt_mask)
        self.se_gain_map = make_map(config.get('se_gain_map'), config)

        # S1 LCE: data-driven map if given, else sum of the pattern map over
        # live PMTs (reference: load_resource.py:243-250)
        lce = config.get('s1_lce_correction_map')
        if lce:
            self.s1_lce_correction_map = make_map(lce, config)
        elif isinstance(self.s1_pattern_map, DummyMap):
            self.s1_lce_correction_map = self.s1_pattern_map.reduce_last_dim()
        else:
            g = _as_gridmap(self.s1_pattern_map)
            summed = np.asarray(g.values)[..., pmt_mask].sum(axis=-1, keepdims=True)
            self.s1_lce_correction_map = GridMap(summed, g.lows, g.highs)

        # S2 AFT rescale (reference: load_resource.py:252-267)
        aft = config.get('s2_mean_area_fraction_top', -1)
        if aft is not None and aft >= 0 and not isinstance(self.s2_pattern_map, DummyMap):
            g = _as_gridmap(self.s2_pattern_map)
            vals = np.asarray(g.values).copy()
            top_eff = vals[..., :n_top].sum(axis=-1)
            tot_eff = vals.sum(axis=-1)
            orig = np.mean((top_eff / tot_eff)[tot_eff > 0])
            vals[..., :n_top] *= aft / orig
            vals[..., n_top:n_pmts] *= (1 - aft) / (1 - orig)
            import jax.numpy as jnp
            g.values = jnp.asarray(vals)

        # S2 correction: data-driven map or pattern-sum / median
        # (reference: load_resource.py:269-280)
        s2c = config.get('s2_correction_map')
        if s2c:
            self.s2_correction_map = make_map(s2c, config)
        elif isinstance(self.s2_pattern_map, DummyMap):
            self.s2_correction_map = self.s2_pattern_map.reduce_last_dim()
        else:
            g = _as_gridmap(self.s2_pattern_map)
            summed = np.asarray(g.values)[..., pmt_mask].sum(axis=-1, keepdims=True)
            summed = summed / np.median(summed[summed > 0])
            self.s2_correction_map = GridMap(summed, g.lows, g.highs)

        # --- Luminescence tables -------------------------------------------
        lum_model = config.get('s2_luminescence_model', 'simple')
        if 'garfield_gas_gap' in str(lum_model):
            entry = config.get('s2_luminescence_gg')
            if isinstance(entry, str):
                path = get_file_path(config, entry)
                self.s2_luminescence_gg = (_read_any(path) if path else
                                           synth.synthetic_garfield_gas_gap())
            elif isinstance(entry, dict):
                self.s2_luminescence_gg = entry
            else:
                self.s2_luminescence_gg = synth.synthetic_garfield_gas_gap()
            ggm = config.get('garfield_gas_gap_map',
                             ['constant dummy',
                              float(np.mean(self.s2_luminescence_gg['gas_gap'])), []])
            self.garfield_gas_gap_map = make_map(ggm, config)
        elif 'garfield' in str(lum_model):
            entry = config.get('s2_luminescence')
            if isinstance(entry, str):
                path = get_file_path(config, entry)
                if path is None:
                    raise FileNotFoundError(f'garfield table {entry} not found')
                table = _read_any(path)
                if not isinstance(table, np.ndarray):
                    table = table['arr_0']
                if 'll' in (table.dtype.names or ()):
                    # select liquid level closest to configured one
                    lls = np.unique(table['ll'])
                    ll = config['gate_to_anode_distance'] - config['elr_gas_gap_length']
                    ll = lls[np.argmin(np.abs(lls - ll))]
                    table = table[table['ll'] == ll]
                self.s2_luminescence = table
            else:
                self.s2_luminescence = entry

        # --- Field distortion ----------------------------------------------
        fdm = config.get('field_distortion_model', 'none')
        if fdm == 'inverse_fdc':
            m = make_map(config.get('fdc_3d'), config)
            self.fdc_3d = _as_gridmap(m, ndim_in=3)
            if self.fdc_3d is not None:
                # reference scales the z axis by -drift_velocity
                # (load_resource.py:311-313): the map is stored vs drift time
                import jax.numpy as jnp
                v = config['drift_velocity_liquid']
                self.fdc_3d.lows = self.fdc_3d.lows * jnp.asarray([1., 1., -v])
                self.fdc_3d.highs = self.fdc_3d.highs * jnp.asarray([1., 1., -v])
                lo, hi = self.fdc_3d.lows, self.fdc_3d.highs
                import jax.numpy as jnp2
                self.fdc_3d.lows = jnp2.minimum(lo, hi)
                self.fdc_3d.highs = jnp2.maximum(lo, hi)
        elif fdm == 'comsol':
            self.fd_comsol = make_map(config.get('field_distortion_comsol_map'),
                                      config)

        # --- Gas gap --------------------------------------------------------
        if config.get('enable_gas_gap_warping', False):
            entry = config.get('gas_gap_map',
                               ['constant dummy', config.get('elr_gas_gap_length', 0.25), []])
            self.gas_gap_length = make_map(entry, config)

        # --- Field dependencies (r,z maps) -----------------------------------
        efd = config.get('enable_field_dependencies', {})
        if isinstance(efd, dict) and any(bool(v) for k, v in efd.items()
                                         if k != 'norm_drift_velocity'):
            m = make_map(config.get('field_dependencies_map'), config)
            if isinstance(m, DummyMap):
                names = ['drift_speed_map', 'survival_probability_map',
                         'diffusion_radial_map', 'diffusion_azimuthal_map']
                m = MultiMap({n: GridMap.constant(m.const, 1, 2) for n in names},
                             default='survival_probability_map')
            self.field_dependencies_map = m
            self.drift_velocity_scaling = 1.0
            if efd.get('norm_drift_velocity', False):
                norm = float(np.asarray(
                    m(np.array([[0.0, -config['tpc_length']]]),
                      map_name='drift_speed_map')).ravel()[0]) * 1e-4
                self.drift_velocity_scaling = config['drift_velocity_liquid'] / norm
        if isinstance(efd, dict) and efd.get('diffusion_longitudinal_map', False):
            dm = make_map(config.get('diffusion_longitudinal_map'), config)
            self.diffusion_longitudinal_map = dm

        # --- Afterpulses ------------------------------------------------------
        if config.get('enable_pmt_afterpulses', False):
            entry = config.get('photon_ap_cdfs')
            path = get_file_path(config, entry) if isinstance(entry, str) else None
            if path:
                data = _read_any(path)
                for k in data:
                    for q in data[k]:
                        if isinstance(data[k][q], list):
                            data[k][q] = np.array(data[k][q])
                self.uniform_to_pmt_ap = data
            elif isinstance(entry, dict):
                self.uniform_to_pmt_ap = entry
            else:
                self.uniform_to_pmt_ap = synth.synthetic_pmt_ap_cdfs(n_pmts)

        if config.get('enable_electron_afterpulses', False):
            entry = config.get('ele_ap_pdfs')
            path = get_file_path(config, entry) if isinstance(entry, str) else None
            if path:
                self.uniform_to_ele_ap = _read_any(path)
            elif entry is not None and not isinstance(entry, str):
                self.uniform_to_ele_ap = entry
            else:
                self.uniform_to_ele_ap = synth.synthetic_ele_ap_pmf()

        # --- Optical propagation splines ---------------------------------------
        if config.get('s1_time_spline', False):
            self.s1_optical_propagation_spline = make_map(
                config.get('s1_time_spline'), config)
        if config.get('s2_time_spline', False):
            self.s2_optical_propagation_spline = make_map(
                config.get('s2_time_spline'), config)

        # --- nVeto QE ------------------------------------------------------------
        if detector == 'XENONnT_neutron_veto':
            entry = config.get('nv_pmt_qe')
            path = get_file_path(config, entry) if isinstance(entry, str) else None
            self.nv_pmt_qe = _read_any(path) if path else (
                entry if isinstance(entry, dict) else None)

        # --- SPE gain table -----------------------------------------------------
        spe_entry = config.get('photon_area_distribution')
        spe_path = (get_file_path(config, spe_entry)
                    if isinstance(spe_entry, str) else None)
        if spe_path:
            self.uniform_to_pe = spe_table_from_csv(spe_path, n_pmts)
            self.photon_area_distribution = _read_any(spe_path)
        else:
            charge, pdfs = synth.synthetic_spe_distribution(n_pmts)
            self.uniform_to_pe = build_uniform_to_pe(charge, pdfs)
            self.photon_area_distribution = None

        # --- Noise bank -----------------------------------------------------------
        if config.get('enable_noise', False):
            entry = config.get('noise_file')
            path = get_file_path(config, entry) if isinstance(entry, str) else None
            if path:
                self.noise_data = _read_any(path)
                if not isinstance(self.noise_data, np.ndarray):
                    self.noise_data = self.noise_data['arr_0']
            else:
                self.noise_data = synth.synthetic_noise(n_pmts)

        log.debug('Resource fully initialized')
