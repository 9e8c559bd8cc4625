"""wfsim_tpu — an accelerator waveform simulator for dual-phase xenon TPCs.

Same capabilities and I/O contracts as XENONnT/WFSim (instructions in,
strax raw_records + truth out), written in plain JAX: fixed-shape vmapped
Monte Carlo for the physics chain, a dense histogram + convolution for PMT
pulse synthesis, vectorized zero-length encoding, and event parallelism
over device meshes.
"""
__version__ = '0.1.0'

import os as _os

# Keep large allocations on the reusable glibc heap (M_MMAP_THRESHOLD /
# M_TRIM_THRESHOLD).  By default glibc mmaps >128 kB allocations and
# returns them to the OS on free, so every fresh chunk-sized record array
# pays first-touch page faults again — measured at ~50 MB/s on
# virtualized hosts (6+ s per 200 MB bench chunk, the dominant host cost).
# With the heap retained, pages fault once per process. Opt out with
# WFSIM_TPU_NO_MALLOPT=1.
if not _os.environ.get('WFSIM_TPU_NO_MALLOPT'):
    try:
        import ctypes as _ctypes
        _libc = _ctypes.CDLL('libc.so.6', use_errno=True)
        _libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        _libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except Exception:  # pragma: no cover - non-glibc platforms
        pass


def compile_cache_dir(environ=None):
    """Directory of the persistent XLA compilation cache, or None.

    The pipeline compiles one program per (photon-capacity, window-length)
    bucket, so a warm cache turns minutes of set-up into seconds.  A set
    ``JAX_COMPILATION_CACHE_DIR`` is used as given.  Otherwise the cache is
    ``.jax_cache`` at the root of the checkout: a fixed path, because the
    path is part of what the cache is found by.  Explicit CPU runs and
    ``WFSIM_TPU_NO_COMPILE_CACHE=1`` get none: XLA:CPU executables are
    specialised to the host's instruction set and cheap to compile.
    """
    env = _os.environ if environ is None else environ
    if env.get('WFSIM_TPU_NO_COMPILE_CACHE'):
        return None
    if 'cpu' in (env.get('JAX_PLATFORMS', '').strip().lower(),
                 env.get('JAX_PLATFORM_NAME', '').strip().lower()):
        return None
    return env.get('JAX_COMPILATION_CACHE_DIR') or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        '.jax_cache')


_cache_dir = compile_cache_dir()
if _cache_dir:
    import jax as _jax
    _jax.config.update('jax_compilation_cache_dir', _cache_dir)
    _jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)

from .units import *                        # noqa: F401,F403
from . import units                         # noqa: F401
from .dtypes import (                       # noqa: F401
    instruction_dtype, optical_extra_dtype, truth_extra_dtype,
    extra_truth_dtype_per_pmt, raw_record_dtype, DEFAULT_RECORD_LENGTH,
    PULSE_TYPE_NAMES)
from .config import (                       # noqa: F401
    default_config, load_fax_config, finalize_config, deterministic_hash)
from .resources import Resource, load_config, make_map, DummyMap  # noqa: F401
from .pipeline import (                      # noqa: F401
    RawDataTPU, RawDataOpticalTPU, ChunkRawRecords, digitize_window)
from .interface import (                     # noqa: F401
    Simulator, rand_instructions, random_instructions,
    instruction_from_csv, read_optical)
from .utils import optical_adjustment        # noqa: F401

# Aliases matching the reference's public names (wfsim/__init__.py exports
# everything flat; RawData/RawDataOptical are the core entry classes)
RawData = RawDataTPU
RawDataOptical = RawDataOpticalTPU

# strax plugin layer and contexts load lazily only when strax is installed
from .interface.strax_plugins import *       # noqa: F401,F403
from .interface.contexts import *            # noqa: F401,F403
