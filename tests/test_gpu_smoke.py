"""Card tests: every device path compiled for the GPU at real widths
and checked bit-exact. They skip where JAX has no GPU; on a GPU host
run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu_smoke.py -m gpu

(the rest of the suite pins the CPU, tests/conftest.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zflac_tpu.encoder import EncoderConfig, encode
from zflac_tpu.testing import correlated_stereo, tone_mix

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    """The first GPU as the default device; skips without one."""
    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")
    with jax.default_device(dev):
        yield dev


def _stream(bps, ch=2, mode=None, n=1 << 17, block=4096):
    pcm = (correlated_stereo(n, bps, seed=1) if ch == 2
           else tone_mix(n, ch, bps, seed=2))
    return encode(pcm, 48000, bps, EncoderConfig(
        block_size=block, stereo_mode=mode))


@pytest.mark.parametrize("bps", [16, 24])
def test_gpu_rows_path(gpu, bps):
    """decode(engine="tpu"): the rows graph (GPU LPC kernel for the
    int32 class, int64 scans under x64 for 24-bit) == native."""
    import zflac_tpu

    data = _stream(bps)
    got = zflac_tpu.decode(data, engine="tpu")
    ref = zflac_tpu.decode(data, engine="native")
    np.testing.assert_array_equal(got.interleaved, ref.interleaved)


@pytest.mark.parametrize("bps,ch,mode",
                         [(16, 2, None), (16, 2, "mid_side"),
                          (8, 2, None), (24, 2, None), (24, 8, None),
                          (32, 2, "independent"), (32, 2, "mid_side"),
                          (32, 2, "left_side")])
def test_gpu_pack2(gpu, bps, ch, mode):
    """decode_to_device on the card: Rice unpack + LPC kernels (int32,
    hi/lo wide for 17-32 bps, 33-bit pairs for 32-bit side channels),
    to_host() with MD5 and interleaved_device(), bit-exact vs native."""
    import zflac_tpu

    data = _stream(bps, ch, mode)
    dd = zflac_tpu.decode_to_device(data)
    assert dd is not None, "pack2 declined an admissible stream"
    assert dd.chunks[0].devices() == {gpu}
    ref = zflac_tpu.decode(data, engine="native")
    np.testing.assert_array_equal(dd.to_host().interleaved,
                                  ref.interleaved)
    np.testing.assert_array_equal(
        np.asarray(dd.interleaved_device()).reshape(-1), ref.interleaved)


def test_gpu_pack2_sharded_mesh(gpu):
    """The sharded pack2 path on a one-GPU mesh: the kernels traced and
    run under shard_map with the psum collective."""
    import zflac_tpu
    from zflac_tpu.parallel.shard import (decode_to_device_sharded,
                                          make_mesh, sharded_to_host)

    data = _stream(16, mode="mid_side")
    r = decode_to_device_sharded(data, make_mesh([gpu]), chunk_frames=8)
    assert r is not None, "pack2 sharded declined an admissible stream"
    assert r[1]["rounds"] >= 2
    ref = zflac_tpu.decode(data, engine="native")
    np.testing.assert_array_equal(sharded_to_host(*r), ref.interleaved)


@pytest.mark.parametrize("cls", ["int32", "wide", "wide33"])
def test_gpu_lpc_kernels_real_width(gpu, cls):
    """Each LPC kernel at the bench width (Bp 4096, 2048 subframes),
    every history bucket, == its plain XLA scan on the card."""
    from test_lpc_triton import CLASSES

    from zflac_tpu.testing import lpc_case

    kernel, ref, wide, n_rows = CLASSES[cls]
    for hist in (8, 16, 32):
        rows, cf, shift, order = map(
            jnp.asarray, lpc_case(hist, 4096, 2048, hist, wide))
        args = ((rows >> 31, rows) if n_rows == 2 else (rows,)) + (
            cf, shift, order)
        got = jax.jit(lambda *a: kernel(*a, hist=hist))(*args)
        want = jax.jit(lambda *a: ref(*a, hist=hist))(*args)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
