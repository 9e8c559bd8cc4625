"""Device parameter bundle and static constants.

``SimParams`` is a pytree of device arrays — everything the jitted physics
needs (maps, SPE tables, templates, AP CDFs, noise).  ``SimConstants`` is a
frozen (hashable) dataclass of scalars and switches used as a static jit
argument, so each configuration compiles to a specialized program with all
branches folded away — the compiled analogue of the reference's config dict
threading (reference passes `config` into every kernel).
"""
from __future__ import annotations

import dataclasses
import typing as ty

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.interp import GridMap
from ..ops.waveform import make_templates
from ..resources.loader import Resource, DummyMap, MultiMap, _as_gridmap

__all__ = ['SimParams', 'SimConstants', 'build_params', 'build_constants']


def _reg(cls):
    """Register a dataclass of arrays as a pytree (None fields are static)."""
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        vals = [getattr(obj, n) for n in fields]
        return vals, None

    def unflatten(aux, vals):
        return cls(**dict(zip(fields, vals)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_reg
@dataclasses.dataclass
class SimParams:
    # PMT response
    gains: jnp.ndarray                 # (C,) f32 electrons/PE
    uniform_to_pe: jnp.ndarray         # (C, 2001) f32
    templates: jnp.ndarray             # (dt, L) f32 SPE current templates
    current_max: jnp.ndarray           # (dt,) f32 per-phase template peak
    trigger_thresholds: jnp.ndarray    # (C,) f32 (zle or special) - 0.5
    zle_thresholds: jnp.ndarray        # (C_all,) i32 digitized thresholds
    top_mask: jnp.ndarray              # (C,) bool
    bottom_mask: jnp.ndarray           # (C,) bool
    live_mask: jnp.ndarray             # (C,) bool gains > 0
    #: (C, 4) f32 [gain, trigger_threshold, live, bottom] — the per-channel
    #: scalars the PMT stage reads per photon, packed so one 4-wide block
    #: gather replaces four/five independent (N,)-element random gathers
    #: (unmeasured on H100, ROADMAP C2)
    chan_pack: jnp.ndarray
    # Maps
    s1_lce: GridMap
    s1_pattern: GridMap
    s2_pattern: GridMap
    s2_correction: GridMap
    se_gain: ty.Optional[GridMap]
    fdc_3d: ty.Optional[GridMap]
    fd_comsol: ty.Optional[GridMap]
    drift_speed_map: ty.Optional[GridMap]
    survival_prob_map: ty.Optional[GridMap]
    diffusion_long_map: ty.Optional[GridMap]
    diffusion_radial_map: ty.Optional[GridMap]
    diffusion_azimuthal_map: ty.Optional[GridMap]
    gas_gap_map: ty.Optional[GridMap]
    garfield_gas_gap_map: ty.Optional[GridMap]
    s1_prop_top: ty.Optional[GridMap]
    s1_prop_bottom: ty.Optional[GridMap]
    s2_prop_top: ty.Optional[GridMap]
    s2_prop_bottom: ty.Optional[GridMap]
    # S2 luminescence tables
    lum_r_dt: ty.Optional[jnp.ndarray]        # (I-free) see s2.py simple model
    garfield_t: ty.Optional[jnp.ndarray]      # (rows, cols) garfield timing table
    garfield_x: ty.Optional[jnp.ndarray]      # (rows,) wire-distance axis
    gg_gas_gap: ty.Optional[jnp.ndarray]      # (G,) gas gap axis
    gg_inv_cdf: ty.Optional[jnp.ndarray]      # (G, M) inverse CDFs
    # NEST timing tables (see resources/nest_tables.py)
    nest_inv_cdf: ty.Optional[jnp.ndarray]       # (4, F, E, M) f32
    nest_fields: ty.Optional[jnp.ndarray]        # (F,)
    nest_energies: ty.Optional[jnp.ndarray]      # (E,)
    # Afterpulses
    pmt_ap_delay_cdf: ty.Optional[jnp.ndarray]   # (E, C, Td) f32
    pmt_ap_amp_cdf: ty.Optional[jnp.ndarray]     # (E, C, Ta) f32
    ele_ap_bin_centers: ty.Optional[jnp.ndarray]  # (B,)
    ele_ap_cdf: ty.Optional[jnp.ndarray]          # (B,)
    # Noise
    noise_data: ty.Optional[jnp.ndarray]       # (L, Cn) i32
    # Channel-major noise bank extended by NOISE_PAD columns of wraparound
    # on both sides: noise_ext[c, NOISE_PAD + x] == noise_data[x % L, c] for
    # x in [-NOISE_PAD, L + NOISE_PAD). Lets the digitize overlay fetch each
    # channel's window as ONE contiguous slice instead of a pointwise
    # modular gather.
    noise_ext: ty.Optional[jnp.ndarray]        # (Cn, L + 2*NOISE_PAD) i32


@dataclasses.dataclass(frozen=True)
class SimConstants:
    """Hashable scalar/switch config snapshot (static jit argument)."""
    detector: str
    n_tpc_pmts: int
    n_top_pmts: int
    n_channels_total: int
    he_channel_start: int
    he_channel_end: int
    sum_signal_channel: int
    sample_duration: int
    samples_before_pulse_center: int
    samples_after_pulse_center: int
    samples_to_store_before: int
    samples_to_store_after: int
    trigger_window: int
    digitizer_reference_baseline: int
    high_energy_deamp_int: int
    current_2_adc: float
    # model switches
    s1_model_type: str
    s2_time_model: str
    s2_luminescence_model: str
    field_distortion_model: str
    enable_gas_gap_warping: bool
    enable_pmt_afterpulses: bool
    enable_electron_afterpulses: bool
    enable_gate_afterpulses: bool
    enable_noise: bool
    en_survival_prob: bool
    en_drift_speed: bool
    en_diff_long: bool
    en_diff_trans: bool
    # physics scalars
    p_double_pe_emision: float
    pmt_transit_time_mean: float
    pmt_transit_time_spread: float
    s1_decay_time: float
    s1_decay_spread: float
    s1_detection_efficiency: float
    s1_ER_alpha_singlet_fraction: float
    s1_ER_primary_singlet_fraction: float
    s1_ER_recombination_fraction: float
    s1_ER_secondary_singlet_fraction: float
    s1_NR_singlet_fraction: float
    maximum_recombination_time: float
    led_pulse_length: float
    singlet_fraction_gas: float
    singlet_lifetime_gas: float
    singlet_lifetime_liquid: float
    triplet_lifetime_gas: float
    triplet_lifetime_liquid: float
    drift_field: float
    drift_velocity_liquid: float
    drift_time_gate: float
    diffusion_constant_longitudinal: float
    diffusion_constant_transverse: float
    electron_extraction_yield: float
    electron_lifetime_liquid: float
    electron_trapping_time: float
    s2_secondary_sc_gain: float
    s2_gain_spread: float
    s2_time_spread: float
    s2_aft_sigma: float
    s2_aft_skewness: float
    se_gain_from_map: bool
    ext_eff_from_map: bool
    g2_mean: float
    tpc_length: float
    tpc_radius: float
    anode_wire_radius: float
    anode_field_domination_distance: float
    elr_gas_gap_length: float
    gate_to_anode_distance: float
    anode_voltage: float
    lxe_dielectric_constant: float
    gas_drift_velocity_slope: float
    pressure: float
    temperature: float
    anode_xaxis_angle: float
    anode_pitch: float
    s2_garfield_confine_position: float
    # afterpulse scalars
    pmt_ap_modifier: float
    pmt_ap_t_modifier: float
    pmt_ap_element_uniform: ty.Tuple[bool, ...]
    pmt_ap_delay_bin: ty.Tuple[float, ...]
    pmt_ap_amp_bin: ty.Tuple[float, ...]
    photoionization_modifier: float
    photoelectric_modifier: float
    photoelectric_p: float
    photoelectric_t_center: float
    photoelectric_t_spread: float
    ele_ap_n: float
    drift_velocity_scaling: float
    per_pmt_truth: bool
    # derived recoil-model constants (reference computes these on the fly,
    # wfsim/core/s1.py:281-327)
    er_primary_excimer_fraction: float
    er_recombination_time: float


def _er_derived(config):
    """ER model derived constants (reference: wfsim/core/s1.py:289-307)."""
    from .. import units
    density = config.get('liquid_density', 1.872452802978054e+30) / (units.g / units.cm ** 3)
    excfrac = 0.4 - 0.11131 * density - 0.0026651 * density ** 2
    excfrac = 1 / (1 + excfrac)
    excfrac /= 1 - (1 - excfrac) * (1 - config['s1_ER_recombination_fraction'])
    efield = config['drift_field'] / (units.V / units.cm)
    reco_time = 3.5 / 0.18 * (1 / 20 + 0.41) * np.exp(-0.009 * efield)
    return float(excfrac), float(reco_time)


def build_constants(config) -> SimConstants:
    cm = config['channel_map']
    he = cm.get('he', (0, -1))
    efd = config.get('enable_field_dependencies', {}) or {}
    excfrac, reco_time = _er_derived(config)

    # PMT AP element metadata (static ordering)
    ap_uniform, ap_dbin, ap_abin = (), (), ()
    if config.get('enable_pmt_afterpulses', False):
        ap = config.get('_pmt_ap_elements')
        if ap:
            ap_uniform = tuple(bool(e['uniform']) for e in ap)
            ap_dbin = tuple(float(e['delaytime_bin_size']) for e in ap)
            ap_abin = tuple(float(e['amplitude_bin_size']) for e in ap)

    return SimConstants(
        detector=config['detector'],
        n_tpc_pmts=int(config['n_tpc_pmts']),
        n_top_pmts=int(config['n_top_pmts']),
        n_channels_total=int(config.get('n_digitizer_channels', 801)),
        he_channel_start=int(he[0]),
        he_channel_end=int(he[1]),
        sum_signal_channel=int(cm.get('sum_signal', 800)),
        sample_duration=int(config['sample_duration']),
        samples_before_pulse_center=int(config['samples_before_pulse_center']),
        samples_after_pulse_center=int(config['samples_after_pulse_center']),
        samples_to_store_before=int(config['samples_to_store_before']),
        samples_to_store_after=int(config['samples_to_store_after']),
        trigger_window=int(config['trigger_window']),
        digitizer_reference_baseline=int(config['digitizer_reference_baseline']),
        high_energy_deamp_int=int(config['high_energy_deamplification_factor']),
        current_2_adc=float(config['current_2_adc']),
        s1_model_type=str(config['s1_model_type']),
        s2_time_model=str(config['s2_time_model']),
        s2_luminescence_model=str(config['s2_luminescence_model']),
        field_distortion_model=str(config.get('field_distortion_model', 'none')),
        enable_gas_gap_warping=bool(config.get('enable_gas_gap_warping', False)),
        enable_pmt_afterpulses=bool(config.get('enable_pmt_afterpulses', False)),
        enable_electron_afterpulses=bool(config.get('enable_electron_afterpulses', False)),
        enable_gate_afterpulses=bool(config.get('enable_gate_afterpulses', False)),
        enable_noise=bool(config.get('enable_noise', False)),
        en_survival_prob=bool(efd.get('survival_probability_map', False)),
        en_drift_speed=bool(efd.get('drift_speed_map', False)),
        en_diff_long=bool(efd.get('diffusion_longitudinal_map', False)),
        en_diff_trans=bool(efd.get('diffusion_transverse_map', False)),
        p_double_pe_emision=float(config['p_double_pe_emision']),
        pmt_transit_time_mean=float(config['pmt_transit_time_mean']),
        pmt_transit_time_spread=float(config['pmt_transit_time_spread']),
        s1_decay_time=float(config.get('s1_decay_time', 0.0)),
        s1_decay_spread=float(config.get('s1_decay_spread', 0.0)),
        s1_detection_efficiency=float(config.get('s1_detection_efficiency', 1.0)),
        s1_ER_alpha_singlet_fraction=float(config.get('s1_ER_alpha_singlet_fraction', 0.0)),
        s1_ER_primary_singlet_fraction=float(config.get('s1_ER_primary_singlet_fraction', 0.0)),
        s1_ER_recombination_fraction=float(config.get('s1_ER_recombination_fraction', 0.0)),
        s1_ER_secondary_singlet_fraction=float(config.get('s1_ER_secondary_singlet_fraction', 0.0)),
        s1_NR_singlet_fraction=float(config.get('s1_NR_singlet_fraction', 0.0)),
        maximum_recombination_time=float(config.get('maximum_recombination_time', 10000.0)),
        led_pulse_length=float(config.get('led_pulse_length', 100.0)),
        singlet_fraction_gas=float(config.get('singlet_fraction_gas', 0.0)),
        singlet_lifetime_gas=float(config.get('singlet_lifetime_gas', 0.0)),
        singlet_lifetime_liquid=float(config.get('singlet_lifetime_liquid', 0.0)),
        triplet_lifetime_gas=float(config.get('triplet_lifetime_gas', 0.0)),
        triplet_lifetime_liquid=float(config.get('triplet_lifetime_liquid', 0.0)),
        drift_field=float(config['drift_field']),
        drift_velocity_liquid=float(config['drift_velocity_liquid']),
        drift_time_gate=float(config['drift_time_gate']),
        diffusion_constant_longitudinal=float(config['diffusion_constant_longitudinal']),
        diffusion_constant_transverse=float(config.get('diffusion_constant_transverse', 0.0)),
        electron_extraction_yield=float(config['electron_extraction_yield']),
        electron_lifetime_liquid=float(config['electron_lifetime_liquid']),
        electron_trapping_time=float(config['electron_trapping_time']),
        s2_secondary_sc_gain=float(config['s2_secondary_sc_gain']),
        s2_gain_spread=float(config.get('s2_gain_spread', 0.0)),
        s2_time_spread=float(config.get('s2_time_spread', 0.0)),
        s2_aft_sigma=float(config.get('s2_aft_sigma', 0.0)),
        s2_aft_skewness=float(config.get('s2_aft_skewness', 0.0)),
        se_gain_from_map=bool(config.get('se_gain_from_map', False)),
        ext_eff_from_map=bool(config.get('ext_eff_from_map', False)),
        g2_mean=float(config.get('g2_mean', 0.0)),
        tpc_length=float(config['tpc_length']),
        tpc_radius=float(config['tpc_radius']),
        anode_wire_radius=float(config['anode_wire_radius']),
        anode_field_domination_distance=float(config['anode_field_domination_distance']),
        elr_gas_gap_length=float(config['elr_gas_gap_length']),
        gate_to_anode_distance=float(config['gate_to_anode_distance']),
        anode_voltage=float(config['anode_voltage']),
        lxe_dielectric_constant=float(config['lxe_dielectric_constant']),
        gas_drift_velocity_slope=float(config['gas_drift_velocity_slope']),
        pressure=float(config['pressure']),
        temperature=float(config['temperature']),
        anode_xaxis_angle=float(config.get('anode_xaxis_angle', np.pi / 4)),
        anode_pitch=float(config.get('anode_pitch', 0.5)),
        s2_garfield_confine_position=float(config.get('s2_garfield_confine_position', -1.0)),
        pmt_ap_modifier=float(config.get('pmt_ap_modifier', 1.0)),
        pmt_ap_t_modifier=float(config.get('pmt_ap_t_modifier', 0.0)),
        pmt_ap_element_uniform=ap_uniform,
        pmt_ap_delay_bin=ap_dbin,
        pmt_ap_amp_bin=ap_abin,
        photoionization_modifier=float(config.get('photoionization_modifier', 1.0)),
        photoelectric_modifier=float(config.get('photoelectric_modifier', 1.0)),
        photoelectric_p=float(config.get('photoelectric_p', 0.0)),
        photoelectric_t_center=float(config.get('photoelectric_t_center', 0.0)),
        photoelectric_t_spread=float(config.get('photoelectric_t_spread', 0.0)),
        ele_ap_n=float(config.get('_ele_ap_n', 0.0)),
        drift_velocity_scaling=float(config.get('_drift_velocity_scaling', 1.0)),
        per_pmt_truth=bool(config.get('per_pmt_truth', False)),
        er_primary_excimer_fraction=excfrac,
        er_recombination_time=reco_time,
    )


def _field_map(resource, name):
    m = getattr(resource, 'field_dependencies_map', None)
    if m is None:
        return None
    if isinstance(m, MultiMap) and name in m.maps:
        return m.maps[name]
    if isinstance(m, MultiMap):
        return None
    return _as_gridmap(m, ndim_in=2)


def _prop_spline(resource, attr, which):
    m = getattr(resource, attr, None)
    if m is None:
        return None
    if isinstance(m, MultiMap) and which in m.maps:
        return m.maps[which]
    return _as_gridmap(m, ndim_in=2)


def build_params(config, resource: Resource) -> SimParams:
    """Assemble the device parameter bundle from a Resource."""
    n_pmts = int(config['n_tpc_pmts'])
    n_all = int(config.get('n_digitizer_channels', 801))
    gains = np.asarray(config['gains'], dtype=np.float32)
    templates = make_templates(
        config['pe_pulse_ts'], config['pe_pulse_ys'],
        sample_duration=int(config['sample_duration']),
        samples_before=int(config['samples_before_pulse_center']),
        samples_after=int(config['samples_after_pulse_center']))
    current_max = templates.max(axis=1)

    # Per-channel trigger thresholds for the truth counters
    # (reference: wfsim/core/pulse.py:240-243)
    thr = np.full(n_pmts, float(config['zle_threshold']) - 0.5, dtype=np.float32)
    # Per-channel digitized ZLE thresholds (reference: rawdata.py:290-294)
    zle_thr = np.full(n_all,
                      int(config['digitizer_reference_baseline'])
                      - int(config['zle_threshold']) - 1, dtype=np.int32)
    for ch_str, v in (config.get('special_thresholds') or {}).items():
        ch = int(ch_str)
        if ch < n_pmts:
            thr[ch] = float(v) - 0.5
        if ch < n_all:
            zle_thr[ch] = int(config['digitizer_reference_baseline']) - int(v) - 1

    top_mask = np.zeros(n_pmts, bool)
    top_mask[:int(config['n_top_pmts'])] = True
    bottom_mask = ~top_mask

    # Luminescence tables
    garfield_t = garfield_x = gg_gas_gap = gg_inv_cdf = None
    lum = str(config.get('s2_luminescence_model', 'simple'))
    if 'garfield_gas_gap' in lum:
        gg = resource.s2_luminescence_gg
        gg_gas_gap = jnp.asarray(np.asarray(gg['gas_gap'], dtype=np.float32))
        gg_inv_cdf = jnp.asarray(np.asarray(gg['timing_inv_cdf'], dtype=np.float32))
    elif 'garfield' in lum:
        tbl = resource.s2_luminescence
        garfield_t = jnp.asarray(np.asarray(tbl['t'], dtype=np.float32))
        garfield_x = jnp.asarray(np.asarray(tbl['x'], dtype=np.float32))

    # PMT AP tables stacked per element; element metadata goes into constants
    # via config['_pmt_ap_elements'] (set by Simulator before build_constants)
    ap_delay = ap_amp = None
    if getattr(resource, 'uniform_to_pmt_ap', None):
        elements = sorted(resource.uniform_to_pmt_ap.keys())
        d_list, a_list, meta = [], [], []
        max_td = max(np.asarray(resource.uniform_to_pmt_ap[e]['delaytime_cdf']).shape[-1]
                     for e in elements)
        max_ta = max(np.atleast_2d(
            np.asarray(resource.uniform_to_pmt_ap[e]['amplitude_cdf'])).shape[-1]
            for e in elements)
        for e in elements:
            d = np.asarray(resource.uniform_to_pmt_ap[e]['delaytime_cdf'], dtype=np.float32)
            if d.ndim == 1:
                d = np.tile(d, (n_pmts, 1))
            d = np.pad(d, [(0, 0), (0, max_td - d.shape[-1])], mode='edge')
            a = np.asarray(resource.uniform_to_pmt_ap[e]['amplitude_cdf'], dtype=np.float32)
            a = np.atleast_2d(a)
            if a.shape[0] == 1:
                a = np.tile(a, (n_pmts, 1))
            a = np.pad(a, [(0, 0), (0, max_ta - a.shape[-1])], mode='edge')
            d_list.append(d)
            a_list.append(a)
            meta.append(dict(
                uniform='Uniform' in e,
                delaytime_bin_size=float(resource.uniform_to_pmt_ap[e]['delaytime_bin_size']),
                amplitude_bin_size=float(resource.uniform_to_pmt_ap[e]['amplitude_bin_size'])))
        ap_delay = jnp.asarray(np.stack(d_list))
        ap_amp = jnp.asarray(np.stack(a_list))
        config['_pmt_ap_elements'] = meta

    ele_bins = ele_cdf = None
    if getattr(resource, 'uniform_to_ele_ap', None) is not None:
        h = resource.uniform_to_ele_ap
        config['_ele_ap_n'] = float(h.n)
        centers = np.asarray(h.bin_centers, dtype=np.float32)
        if hasattr(h, 'cdf'):
            cdf = np.asarray(h.cdf, dtype=np.float32)
        else:
            pmf = np.asarray(getattr(h, 'histogram', getattr(h, 'pmf', None)),
                             dtype=np.float64)
            cdf = np.cumsum(pmf)
            cdf = (cdf / cdf[-1]).astype(np.float32)
        ele_bins, ele_cdf = jnp.asarray(centers), jnp.asarray(cdf)

    if getattr(resource, 'drift_velocity_scaling', None) is not None:
        config['_drift_velocity_scaling'] = float(resource.drift_velocity_scaling)

    noise = None
    noise_ext = None
    if getattr(resource, 'noise_data', None) is not None:
        # the noise bank is the largest device asset (~200 MB + the
        # wrap-extended copy); cache the device arrays on the resource —
        # resources are shared across Simulator constructions via the
        # config-hash cache, so the upload happens once per process, not
        # once per Simulator
        cached = getattr(resource, '_noise_device_cache', None)
        if cached is not None:
            noise, noise_ext = cached
        else:
            noise_np = np.asarray(resource.noise_data, dtype=np.int32)
            noise = jnp.asarray(noise_np)
            from ..pipeline.digitize import NOISE_PAD
            if noise_np.shape[0] >= NOISE_PAD:
                # int16 halves the extended bank (ADC noise counts fit
                # comfortably); the overlay add upcasts to the grid dtype
                nt = noise_np.T.astype(np.int16)
                noise_ext = jnp.asarray(np.concatenate(
                    [nt[:, -NOISE_PAD:], nt, nt[:, :NOISE_PAD]], axis=1))
            try:
                resource._noise_device_cache = (noise, noise_ext)
            except Exception:
                pass

    nest_table = nest_fields = nest_energies = None
    if 'nest' in str(config.get('s1_model_type', '')):
        from ..resources.nest_tables import build_nest_timing_tables
        tbl, flds, engs = build_nest_timing_tables(config)
        nest_table = jnp.asarray(tbl)
        nest_fields = jnp.asarray(flds)
        nest_energies = jnp.asarray(engs)

    def g(m, ndim=2):
        return _as_gridmap(m, ndim_in=ndim)

    return SimParams(
        gains=jnp.asarray(gains),
        uniform_to_pe=jnp.asarray(resource.uniform_to_pe),
        templates=jnp.asarray(templates),
        current_max=jnp.asarray(current_max),
        trigger_thresholds=jnp.asarray(thr),
        zle_thresholds=jnp.asarray(zle_thr),
        top_mask=jnp.asarray(top_mask),
        bottom_mask=jnp.asarray(bottom_mask),
        live_mask=jnp.asarray(gains > 0),
        chan_pack=jnp.stack(
            [jnp.asarray(gains, jnp.float32),
             jnp.asarray(thr, jnp.float32),
             jnp.asarray(gains > 0, jnp.float32),
             jnp.asarray(bottom_mask, jnp.float32)], axis=1),
        s1_lce=g(resource.s1_lce_correction_map, 3),
        s1_pattern=g(resource.s1_pattern_map, 3),
        s2_pattern=g(resource.s2_pattern_map, 2),
        s2_correction=g(resource.s2_correction_map, 2),
        se_gain=g(getattr(resource, 'se_gain_map', None), 2),
        fdc_3d=g(getattr(resource, 'fdc_3d', None), 3),
        fd_comsol=g(getattr(resource, 'fd_comsol', None), 2),
        drift_speed_map=_field_map(resource, 'drift_speed_map'),
        survival_prob_map=_field_map(resource, 'survival_probability_map'),
        diffusion_long_map=g(getattr(resource, 'diffusion_longitudinal_map', None), 2),
        diffusion_radial_map=_field_map(resource, 'diffusion_radial_map'),
        diffusion_azimuthal_map=_field_map(resource, 'diffusion_azimuthal_map'),
        gas_gap_map=g(getattr(resource, 'gas_gap_length', None), 2),
        garfield_gas_gap_map=g(getattr(resource, 'garfield_gas_gap_map', None), 2),
        s1_prop_top=_prop_spline(resource, 's1_optical_propagation_spline', 'top'),
        s1_prop_bottom=_prop_spline(resource, 's1_optical_propagation_spline', 'bottom'),
        s2_prop_top=_prop_spline(resource, 's2_optical_propagation_spline', 'top'),
        s2_prop_bottom=_prop_spline(resource, 's2_optical_propagation_spline', 'bottom'),
        lum_r_dt=None,
        nest_inv_cdf=nest_table,
        nest_fields=nest_fields,
        nest_energies=nest_energies,
        garfield_t=garfield_t,
        garfield_x=garfield_x,
        gg_gas_gap=gg_gas_gap,
        gg_inv_cdf=gg_inv_cdf,
        pmt_ap_delay_cdf=ap_delay,
        pmt_ap_amp_cdf=ap_amp,
        ele_ap_bin_centers=ele_bins,
        ele_ap_cdf=ele_cdf,
        noise_data=noise,
        noise_ext=noise_ext,
    )
