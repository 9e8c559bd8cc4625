import os

# Force the test suite onto a virtual 8-device CPU mesh so multi-device
# sharding logic is exercised without accelerator hardware.  The platform is
# set through jax.config before first backend use, which holds whatever the
# environment preselects.  Tests that need the card are marked ``gpu`` and
# skip here (tests/test_gpu.py).
# NO persistent compile cache on the CPU test platform: XLA:CPU AOT
# (de)serialization is unreliable here — entries cached on another machine
# type SIGILL on load, and in long suite processes even cache WRITES were
# observed to segfault inside put_executable_and_time.  CPU compiles are
# cheap; the cache pays off on the GPU (wfsim_tpu.compile_cache_dir).
os.environ['WFSIM_TPU_NO_COMPILE_CACHE'] = '1'
os.environ.pop('JAX_COMPILATION_CACHE_DIR', None)

flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

# XLA:CPU leaks a few anonymous JIT-code mappings per compiled executable
# for the life of the process (see _bounded_jit_code_maps below); the
# suite's program count keeps growing with coverage and can cross the
# kernel's default vm.max_map_count (65530) even with per-module cache
# drops, after which mmap failures surface as segfaults inside the XLA
# compiler.  Best-effort raise (privileged CI containers allow it;
# silently skipped elsewhere — the per-module cache clearing remains the
# first line of defense).
try:
    with open('/proc/sys/vm/max_map_count', 'r+') as _f:
        if int(_f.read()) < 262144:
            _f.seek(0)
            _f.write('262144')
except (OSError, PermissionError):
    pass

import jax  # noqa: E402

# JAX_PLATFORMS=cuda (or gpu) keeps the card, for the tests marked ``gpu``
if os.environ.get('JAX_PLATFORMS', '').strip().lower() not in ('cuda',
                                                                 'gpu'):
    jax.config.update('jax_platforms', 'cpu')
    assert jax.default_backend() == 'cpu'


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _bounded_jit_code_maps():
    """XLA:CPU keeps ~3-5 small anonymous mappings of ORC-JIT code per
    compiled executable alive for the life of the process. A full suite run
    compiles thousands of (function, shape, sharding) programs on the
    8-virtual-device backend and crosses vm.max_map_count (65530 — observed
    ~50k mappings, >16k of them r-xp JIT segments, right before the crash),
    after which mmap failures surface as segfaults inside the XLA compiler
    or the compile-cache (de)serializers. Dropping the executable caches
    after each test module keeps the mapping count bounded; CPU recompiles
    of the few cross-module shared shapes are cheap."""
    yield
    import gc
    jax.clear_caches()
    gc.collect()
