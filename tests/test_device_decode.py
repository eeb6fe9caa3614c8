"""Device-resident decode (pack2 fast path, runtime/device.py):
differential tests against the native engine across the corpus, plus
kernel-level checks for the Rice bit-unpack (G2=8 groups, windows
emitted by the C++ scan) and the transposed-form LPC kernel.

The CPU suite runs the plain XLA math (runtime/backend.py picks "cpu");
the GPU kernels are covered by interpret-mode tests here and in
tests/test_lpc_triton.py, and compiled for the card by
tests/test_gpu_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import zflac_tpu
from zflac_tpu.errors import InvalidChecksum
from zflac_tpu.index.native_indexer import (
    build_plan_native,
    native_available,
    pack2_range,
)
from zflac_tpu.ops.rice16 import G2, _unpack16_math
from zflac_tpu.testing import make_corpus

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native indexer unavailable")

_NAMES = sorted(make_corpus().keys())


def _rows_from_pack2(ck):
    """Host-side reference reconstruction of residual rows from a
    packed chunk (the same math the device runs). The buffer is
    CLASS-SORTED with v3 P-MAJOR group slots (slot = p * Ssort +
    sorted): the flat kernel math output re-lays to the time-major
    rows the device writes directly; the inv permutation restores
    stream order."""
    import jax
    buf, off = ck.buf, ck.off
    W, NGp, Bp, S = ck.W, ck.NGp, ck.Bp, ck.S
    Ss = ck.Ssort
    win = buf[off["win"]:off["win"] + W * NGp].view(np.uint32)
    win = win.reshape(W, NGp)
    meta = buf[off["meta"]:off["meta"] + NGp].reshape(1, NGp)
    out = np.array(jax.jit(_unpack16_math)(win, meta))
    GP1 = NGp // Ss
    rows_t = out.reshape(G2, GP1, Ss).transpose(1, 0, 2).reshape(
        GP1 * G2, Ss).copy()
    # Patches land in the time-major layout (idx = pos * Ssort +
    # sorted); the sentinel is the dead +1 p-row at Bp*Ssort,
    # discarded by the [:Bp] slice.
    pidx = buf[off["pidx"]:off["pidx"] + ck.n_patch_p]
    pval = buf[off["pval"]:off["pval"] + ck.n_patch_p]
    rows_t.reshape(-1)[pidx] = pval
    rows = np.ascontiguousarray(rows_t[:Bp].T)    # [Ss, Bp] row-major
    order = buf[off["order"]:off["order"] + Ss]
    warmlen = buf[off["warmlen"]:off["warmlen"] + Ss]
    warm = buf[off["warm"]:off["warm"] + Ss * 32].reshape(32, Ss).T
    col = np.arange(Bp)[None, :]
    warm_p = np.zeros((Ss, Bp), np.int32)
    warm_p[:, :32] = warm
    rows = np.where(col < warmlen[:, None], warm_p, rows)
    bssub = buf[off["bssub"]:off["bssub"] + Ss]
    rows = np.where(col < bssub[:, None], rows, 0)
    assert int(order.max(initial=0)) <= 32
    inv = buf[off["inv"]:off["inv"] + ck.Sp]
    return rows[inv[:S]]


@pytest.mark.parametrize("name", _NAMES)
def test_pack2_rows_match_host(name, corpus):
    """The C++ pack2 scan + v2 unpack math reproduce the host-decoded
    residual rows bit-exactly."""
    data, pcm, sr, bps = corpus[name]
    plan = build_plan_native(data)
    if plan.rows is None:
        pytest.skip("skim plan (no host rows)")
    # int64 host plans (hi-res) cast exactly: residuals/warm-ups fit
    # int32 in the pack2-admitted domain.
    from zflac_tpu.bitio import BitReader
    from zflac_tpu.oracle import parse_metadata
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info)
    if ck is None:
        pytest.skip("pack2 declined (exotic stream)")
    assert ck.F == plan.num_frames
    rows = _rows_from_pack2(ck)
    ref = np.zeros((plan.num_subframes, ck.Bp), np.int32)
    ref[:, :plan.rows.shape[1]] = plan.rows.astype(np.int32)[:, :ck.Bp]
    np.testing.assert_array_equal(rows, ref)


@pytest.mark.parametrize("name", _NAMES)
def test_device_decode_matches_native(name, corpus):
    """decode_to_device -> to_host() equals the native engine end to
    end (samples, metadata, MD5 verification)."""
    data, pcm, sr, bps = corpus[name]
    ref = zflac_tpu.decode(data, engine="native")
    dd = zflac_tpu.decode_to_device(data)
    if dd is None:
        pytest.skip("pack2 declined (wide/exotic stream)")
    got = dd.to_host()  # verifies stream MD5
    np.testing.assert_array_equal(got.interleaved, ref.interleaved)
    assert (got.channels, got.sample_rate, got.bits_per_sample) == (
        ref.channels, ref.sample_rate, ref.bits_per_sample)


def test_device_decode_parallel_scan(corpus):
    """Anchor-split parallel scan (scan_workers > 0 forces the split
    path on small streams): chunk chain verified, output bit-exact vs
    the sequential scan and the native engine."""
    data, *_ = corpus["lpc order 8"]
    ref = zflac_tpu.decode(data, engine="native")
    for workers in (2, 4):
        dd = zflac_tpu.decode_to_device(data, scan_workers=workers,
                                        chunk_frames=2)
        assert dd is not None
        got = dd.to_host()
        np.testing.assert_array_equal(got.interleaved, ref.interleaved)


def test_device_decode_parallel_scan_unknown_total(corpus):
    """Parallel scan composed with probe-based frame estimation."""
    data, *_ = corpus["unknown length"]
    ref = zflac_tpu.decode(data, engine="native")
    dd = zflac_tpu.decode_to_device(data, scan_workers=3)
    assert dd is not None
    np.testing.assert_array_equal(dd.to_host().interleaved,
                                  ref.interleaved)


def test_device_decode_chunked(corpus):
    """Multi-chunk pipeline: same output as single-shot, chunk shapes
    pinned so the stream compiles once."""
    data, *_ = corpus["lpc order 8"]
    ref = zflac_tpu.decode(data, engine="native")
    dd = zflac_tpu.decode_to_device(data, chunk_frames=2)
    assert dd is not None and len(dd.chunks) > 1
    got = dd.to_host()
    np.testing.assert_array_equal(got.interleaved, ref.interleaved)


def test_device_decode_detects_corruption(corpus):
    """A flipped residual bit fails MD5 at to_host (the reference's
    decode-time integrity check, zflac.zig:267-280)."""
    data, *_ = corpus["lpc order 8"]
    bad = bytearray(data)
    bad[-200] ^= 0x10
    dd = zflac_tpu.decode_to_device(bytes(bad))
    if dd is None:
        pytest.skip("corruption declined the fast path")
    with pytest.raises(InvalidChecksum):
        dd.to_host()


@pytest.mark.parametrize("name", ["lpc order 8", "variable blocksize",
                                  "bps 24", "channels 5"])
def test_interleaved_device_matches_host(name, corpus):
    """The on-device assembly surface (DeviceDecoded.interleaved_device)
    equals the host assembly for constant AND variable blocking, in
    both normalization domains."""
    data, *_ = corpus[name]
    dd = zflac_tpu.decode_to_device(data)
    assert dd is not None
    host = dd.to_host()
    dev = np.asarray(dd.interleaved_device())
    assert dev.shape == (host.num_samples, host.channels)
    np.testing.assert_array_equal(dev.reshape(-1), host.interleaved)
    from zflac_tpu import format as fmt
    sh = fmt.normalization_shift(host.bits_per_sample)
    raw = np.asarray(dd.interleaved_device(normalized=False))
    np.testing.assert_array_equal(
        raw.reshape(-1) << sh if sh else raw.reshape(-1),
        host.interleaved)


def test_device_decode_mutation_robustness(corpus):
    """Byte-mutation fuzz over the decode_to_device orchestration
    (chunk scanning, parallel ranges, spec unification, stop
    semantics): every mutated stream must decline (None), raise a
    typed FlacError, or decode — and if it decodes with verify_md5,
    either match the stream MD5 or raise InvalidChecksum. Never an
    untyped crash."""
    from zflac_tpu.errors import FlacError

    data, *_ = corpus["lpc order 8"]
    rng = np.random.default_rng(77)
    arr = np.frombuffer(data, dtype=np.uint8).copy()
    for i in range(40):
        mutated = arr.copy()
        n_flips = int(rng.integers(1, 4))
        idx = rng.integers(0, len(arr), size=n_flips)
        mutated[idx] ^= rng.integers(1, 256, size=n_flips).astype(
            np.uint8)
        try:
            dd = zflac_tpu.decode_to_device(bytes(mutated),
                                            scan_workers=2)
            if dd is not None:
                dd.to_host(verify_md5=True)
        except FlacError:
            pass


def _lpc_kernel_vs_scan(seed, n, B, hist):
    """Transposed-form GPU LPC kernel (interpret mode) against the XLA
    scan reference across random orders/shifts."""
    from zflac_tpu.ops.lpc_triton import lpc_triton
    from zflac_tpu.runtime.reconstruct import _lpc_scan

    rng = np.random.default_rng(seed)
    rows = rng.integers(-3000, 3000, (n, B)).astype(np.int32)
    order = rng.integers(1, hist + 1, n).astype(np.int32)
    shift = rng.integers(0, 14, n).astype(np.int32)
    cf = np.zeros((n, 32), np.int32)
    for i in range(n):
        cf[i, :order[i]] = rng.integers(-2048, 2048, order[i])
    ref = np.asarray(jax.jit(_lpc_scan)(
        jnp.asarray(rows), jnp.asarray(cf[:, ::-1].copy()),
        jnp.asarray(shift), jnp.asarray(order)))
    out = lpc_triton(
        jnp.asarray(rows.T), jnp.asarray(cf[:, :hist].T.copy()),
        jnp.asarray(shift[None, :]), jnp.asarray(order[None, :]),
        hist=hist, interpret=True)
    np.testing.assert_array_equal(np.asarray(out).T, ref)


def test_lpc_kernel_interpret_matches_scan():
    _lpc_kernel_vs_scan(7, 128, 64, 8)


@pytest.mark.parametrize("B", [640, 1152, 2304])
def test_lpc2_kernel_non_pow2_block(B):
    """Padded block sizes that are 128-multiples but not powers of two
    (FLAC blocks 576/1152/2304) run the whole time axis in one program:
    the kernel needs only B % 8 == 0."""
    _lpc_kernel_vs_scan(B, 128, B, 8)


def test_rice16_meta_packing_sanity(corpus):
    """Group metadata invariants: valid groups carry pos0 in [0, 32),
    k in [0, 32) or escape, skip <= order."""
    data, *_ = corpus["lpc order 8"]
    from zflac_tpu.bitio import BitReader
    from zflac_tpu.oracle import parse_metadata
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info)
    assert ck is not None
    meta = ck.buf[ck.off["meta"]:ck.off["meta"] + ck.NGp]
    k6 = (meta >> 5) & 63
    valid = k6 != 63
    assert valid.any()
    assert ((meta[valid] & 31) >= 0).all()
    assert (((meta[valid] >> 16) & 31) <= 32).all()
    # W adaptively 8 or 16
    assert ck.W in (8, 16)


@pytest.mark.parametrize("name", ["constant heavy", "lpc order 8",
                                  "variable blocksize",
                                  "stereo mid_side",
                                  "escaped partitions"])
def test_sorted_layout_padded_chunks(name, corpus):
    """The class-sorted pack2 layout with forced frame padding
    (force_fp > F) and mixed subframe classes decodes bit-exactly —
    padded stream slots ride the inv sentinel to the dead row."""
    import functools
    from zflac_tpu import format as fmt
    from zflac_tpu.bitio import BitReader
    from zflac_tpu.oracle import parse_metadata
    from zflac_tpu.runtime.device import _reconstruct_pack2_core

    data, *_ = corpus[name]
    br = BitReader(data)
    info = parse_metadata(br)
    ck = pack2_range(data, br.pos // 8, len(data), info,
                     max_frames=64, force_fp=64)
    if ck is None:
        pytest.skip("pack2 declined")
    core = functools.partial(
        _reconstruct_pack2_core, spec=ck.spec_key(), num_channels=ck.C,
        container_bits=fmt.container_bits(ck.bits_per_sample),
        do_decorrelate=ck.do_decorrelate, backend="cpu")
    buf = jnp.asarray(ck.device_buf)
    full = np.asarray(jax.jit(lambda b: core(b))(buf))
    ref = zflac_tpu.decode(data, engine="native")
    shift = fmt.normalization_shift(ck.bits_per_sample)
    refv = (ref.interleaved >> shift) if shift else ref.interleaved
    if full.ndim == 2:  # packed stereo int16/int8 pairs
        got = full.reshape(full.shape[0], -1, ck.C)
    else:
        got = full
    at = 0
    for f in range(ck.F):
        bs = int(ck.f_block_size[f])
        want = refv[at:at + bs * ck.C].reshape(bs, ck.C)
        np.testing.assert_array_equal(got[f, :bs, :], want)
        at += bs * ck.C


def test_scatter_rows_sentinel_geometry():
    """Regression: XLA:CPU wraps OOB scatter indices to row 0 at this
    geometry ([2, 256] canvas, 128 update rows) instead of dropping
    them under mode="drop" — which corrupted single-frame pack2 chunks
    (channel 1 decoded into channel 0). scatter_rows must discard the
    sentinel updates exactly."""
    from zflac_tpu.runtime.scatter import scatter_flat, scatter_rows

    canvas = jnp.zeros((2, 256), jnp.int32)
    idx = jnp.asarray([0, 1] + [2] * 126)  # sentinel Sp == 2
    upd = jnp.tile(jnp.arange(128, dtype=jnp.int32)[:, None] + 100,
                   (1, 256))
    out = np.asarray(jax.jit(scatter_rows)(canvas, idx, upd))
    assert out[0, 0] == 100 and out[1, 0] == 101
    flat = jnp.zeros((512,), jnp.int32)
    fidx = jnp.asarray([3, 512, 512, 512], jnp.int32)
    fval = jnp.asarray([7, 8, 9, 10], jnp.int32)
    fout = np.asarray(jax.jit(scatter_flat)(flat, fidx, fval))
    assert fout[3] == 7 and fout[0] == 0 and fout.sum() == 7


def test_device_decode_single_frame_chunks(corpus):
    """Single-frame chunking (chunk_frames=1) over a stream whose
    frames mix channel modes — the geometry that exposed the scatter
    sentinel wrap."""
    data, *_ = corpus["blocksize 192"]
    ref = zflac_tpu.decode(data, engine="native")
    dd = zflac_tpu.decode_to_device(data, chunk_frames=1)
    assert dd is not None
    got = dd.to_host()
    np.testing.assert_array_equal(got.interleaved, ref.interleaved)
