"""Checks that need the card, at the detector's real widths.

Marked ``gpu``; they skip on any other platform.  On a machine with a CUDA
GPU:

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu

``chip_smoke.py`` runs the same checks (tests/gpu_checks.py) in its own
process as phases d and e.
"""
import pytest

from . import gpu_checks

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    platform = jax.devices()[0].platform
    if platform != 'gpu':
        pytest.skip(f'needs a CUDA GPU; this process runs on {platform}')


def test_digitize_parity_full_width(gpu):
    found = gpu_checks.digitize_parity()
    assert found['channels'] == 494 and found['n_samples'] == 2048
    assert found['records'] > 0


def test_sampler_oracles_on_card(gpu):
    gpu_checks.sampler_oracles()
