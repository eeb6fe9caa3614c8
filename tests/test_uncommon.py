"""Uncommon-stream suite: extreme-but-legal configurations must decode
(mirrors /root/reference/tests/std_uncommon.zig:33-51 — 32 bps, 768 kHz,
15-bit, blocksize 65535, partition order 15)."""

import numpy as np
import pytest

import zflac_tpu
from conftest import expected_output
from zflac_tpu.encoder import EncoderConfig, encode
from zflac_tpu.testing import tone_mix

DECODERS = [zflac_tpu.decode_oracle, zflac_tpu.decode]


def roundtrip(decode, pcm, sr, bps, cfg):
    data = encode(pcm, sr, bps, cfg)
    r = decode(data)
    np.testing.assert_array_equal(r.interleaved, expected_output(pcm, bps))
    return r


@pytest.mark.parametrize("decode", DECODERS)
def test_32bps(decode):
    roundtrip(decode, tone_mix(2048, 2, 32, seed=1), 48000, 32,
              EncoderConfig(block_size=512))


@pytest.mark.parametrize("decode", DECODERS)
def test_768khz(decode):
    r = roundtrip(decode, tone_mix(2048, 2, 16, seed=2), 768000, 16,
                  EncoderConfig(block_size=512))
    assert r.sample_rate == 768000  # via the 16-bit Hz/10 uncommon path


@pytest.mark.parametrize("decode", DECODERS)
def test_15bit(decode):
    # 15 bps has no frame-header code: stored via STREAMINFO (bd code 0).
    r = roundtrip(decode, tone_mix(2048, 2, 15, seed=3), 44100, 15,
                  EncoderConfig(block_size=512, bps_from_streaminfo=True))
    assert r.bits_per_sample == 15


@pytest.mark.parametrize("decode", DECODERS)
def test_blocksize_65535(decode):
    roundtrip(decode, tone_mix(65535, 1, 16, seed=4), 44100, 16,
              EncoderConfig(block_size=65535, max_lpc_order=2))


@pytest.mark.parametrize("decode", DECODERS)
def test_partition_order_15(decode):
    roundtrip(decode, tone_mix(1 << 15, 1, 16, seed=5), 44100, 16,
              EncoderConfig(block_size=1 << 15, partition_order=15,
                            max_lpc_order=0, subframe_mode=("fixed", 1)))


def _device_and_sharded(data, n_dev=2):
    """Format-extreme streams through decode_to_device AND the sharded
    pack2 path (r4 verdict task 5: previously only engine='auto'
    covered these). The envelope admits them — a decline is a
    failure."""
    import jax

    from zflac_tpu.parallel.shard import (decode_to_device_sharded,
                                          make_mesh, sharded_to_host)
    from zflac_tpu.runtime.device import decode_to_device

    ref = zflac_tpu.decode(data, engine="native")
    dd = decode_to_device(data)
    assert dd is not None, "decode_to_device declined"
    np.testing.assert_array_equal(dd.to_host().interleaved,
                                  ref.interleaved)
    r = decode_to_device_sharded(data, make_mesh(jax.devices("cpu")
                                                 [:n_dev]))
    assert r is not None, "sharded pack2 declined"
    host = sharded_to_host(*r)
    from zflac_tpu import format as fmt
    sh = fmt.normalization_shift(r[1]["bits_per_sample"])
    np.testing.assert_array_equal(host, ref.interleaved >> sh
                                  if sh else ref.interleaved)


def test_device_blocksize_65535():
    """Block size 65535 (Bp 65536) through the device paths: the
    padded geometry and chunk estimates must hold at the format maximum
    (std_uncommon.zig:33-51)."""
    pcm = tone_mix(65535 + 1000, 1, 16, seed=24)
    data = encode(pcm, 44100, 16,
                  EncoderConfig(block_size=65535, max_lpc_order=2))
    _device_and_sharded(data)


def test_device_partition_order_15():
    """Partition order 15 (1-residual partitions, group-grid
    unaligned): the scan routes the whole span through the patch list;
    the device paths must serve it rather than decline."""
    pcm = tone_mix(1 << 15, 1, 16, seed=25)
    data = encode(pcm, 44100, 16,
                  EncoderConfig(block_size=1 << 15, partition_order=15,
                                max_lpc_order=0,
                                subframe_mode=("fixed", 1)))
    _device_and_sharded(data)


def test_device_rice2_high_k():
    """Rice2 with k >= 24 (5-bit parameter territory, zigzag values up
    to ~2^30 — inside the kernel's zz < 2^31 envelope) through the
    device paths."""
    from zflac_tpu.index.native_indexer import pack2_range
    from zflac_tpu.bitio import BitReader
    from zflac_tpu.oracle import parse_metadata
    from zflac_tpu.testing import noise

    pcm = noise(8192, 1, 32, seed=26, scale=0.24)  # |v| <= 2^29
    data = encode(pcm, 96000, 32,
                  EncoderConfig(block_size=1024, coding_method=1,
                                subframe_mode=("fixed", 0)))
    # Confirm the stream actually carries k >= 24 rice2 groups.
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info)
    assert ck is not None
    meta = ck.buf[ck.off["meta"]:ck.off["meta"] + ck.NGp]
    ks = (meta >> 5) & 63
    assert int(((ks >= 24) & (ks < 62)).sum()) > 0, \
        "stream has no k>=24 rice groups — adjust the generator"
    _device_and_sharded(data)


@pytest.mark.parametrize("decode", DECODERS)
def test_mono_and_8ch(decode):
    roundtrip(decode, tone_mix(1024, 1, 16, seed=6), 8000, 16,
              EncoderConfig(block_size=256))
    roundtrip(decode, tone_mix(1024, 8, 16, seed=7), 8000, 16,
              EncoderConfig(block_size=256))


@pytest.mark.parametrize("decode", DECODERS)
def test_tiny_blocks(decode):
    roundtrip(decode, tone_mix(64, 2, 16, seed=8), 44100, 16,
              EncoderConfig(block_size=16, max_lpc_order=2))
