"""Test harness config: run JAX on a virtual 8-device CPU mesh so
multi-chip sharding logic is exercised without a pod (SURVEY.md §4,
"CPU-simulated multi-host mode")."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Pin the default device to the CPU so the suite runs on the virtual
# 8-device CPU pool (fast compiles, deterministic) even when a GPU is
# visible; the card tests (tests/test_gpu_smoke.py) pick their device.
jax.config.update("jax_default_device", jax.devices("cpu")[0])

from zflac_tpu import format as fmt  # noqa: E402
from zflac_tpu.testing import make_corpus  # noqa: E402

_CORPUS = None


@pytest.fixture(scope="session")
def corpus():
    """name -> (flac_bytes, pcm, sample_rate, bps); built once."""
    global _CORPUS
    if _CORPUS is None:
        _CORPUS = make_corpus()
    return _CORPUS


def expected_output(pcm: np.ndarray, bps: int) -> np.ndarray:
    """Expected decoder output for encoder input `pcm`: natural-width
    samples shifted to container MSBs (zflac.zig:287-306), interleaved."""
    from zflac_tpu.result import container_dtype
    shift = fmt.normalization_shift(bps)
    arr = (pcm.astype(np.int64) << shift).astype(container_dtype(bps))
    return arr.reshape(-1)
