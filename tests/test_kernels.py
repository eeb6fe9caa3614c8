"""Kernel unit tests: the GPU LPC kernels (Pallas interpret mode on
CPU) and the plain XLA scans against numpy references, over randomized
orders, shifts, and coefficients; the backend chooser."""

import numpy as np
import pytest

import jax.numpy as jnp

from zflac_tpu.ops.lpc_triton import lpc_triton
from zflac_tpu.runtime.reconstruct import _lpc_scan


def _random_case(rng, S, B, max_order=32):
    order = rng.integers(1, max_order + 1, size=S).astype(np.int32)
    shift = rng.integers(0, 16, size=S).astype(np.int32)
    coeffs_rev = np.zeros((S, 32), np.int32)
    for s in range(S):
        o = order[s]
        coeffs_rev[s, 32 - o:] = rng.integers(-2**13, 2**13, size=o)
    rows = rng.integers(-2**14, 2**14, size=(S, B)).astype(np.int32)
    return order, shift, coeffs_rev, rows


def _numpy_lpc(rows, coeffs_rev, shift, order):
    S, B = rows.shape
    X = np.zeros((S, 32 + B), np.int64)
    out = np.zeros((S, B), np.int32)
    for t in range(B):
        pred = (X[:, t:t + 32] * coeffs_rev).sum(1)
        pred = pred.astype(np.int32) >> shift
        o = np.where(t >= order, rows[:, t] + pred,
                     rows[:, t]).astype(np.int32)
        X[:, 32 + t] = o
        out[:, t] = o
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    order, shift, coeffs_rev, rows = _random_case(rng, 64, 256)
    ref = _numpy_lpc(rows, coeffs_rev, shift, order)
    out = np.asarray(_lpc_scan(jnp.array(rows), jnp.array(coeffs_rev),
                               jnp.array(shift), jnp.array(order)))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("lanes,hist", [(128, 32), (128, 16)])
def test_pallas_interpret_matches_numpy(lanes, hist):
    """The int32 GPU LPC kernel (transposed form, forward coefficients
    cfwd[r] = c_{r+1} = coeffs_rev slot 31-r) == the direct-form numpy
    recurrence over `lanes` subframes."""
    rng = np.random.default_rng(2)
    order, shift, coeffs_rev, rows = _random_case(
        rng, lanes, 64, max_order=hist)
    ref = _numpy_lpc(rows, coeffs_rev, shift, order)
    out = lpc_triton(
        jnp.array(np.ascontiguousarray(rows.T)),
        jnp.array(np.ascontiguousarray(coeffs_rev[:, ::-1][:, :hist].T)),
        jnp.array(shift[None, :]), jnp.array(order[None, :]),
        hist=hist, interpret=True)
    np.testing.assert_array_equal(np.asarray(out).T, ref)


def test_fixed_integrate_matches_scalar():
    from zflac_tpu.plan import fixed_seeds_from_warmup
    from zflac_tpu.runtime.reconstruct import _fixed_integrate
    from zflac_tpu import format as fmt

    rng = np.random.default_rng(3)
    B, n = 128, 16
    orders = rng.integers(0, 5, size=n).astype(np.int32)
    rows = np.zeros((n, B), np.int32)
    seeds = np.zeros((n, 4), np.int32)
    expected = np.zeros((n, B), np.int64)
    for i, k in enumerate(orders):
        warm = rng.integers(-1000, 1000, size=k)
        res = rng.integers(-50, 50, size=B - k)
        rows[i, :k] = warm
        rows[i, k:] = res
        seeds[i] = fixed_seeds_from_warmup(warm, k, np.int32)
        # scalar reference (zflac.zig:481-490)
        sig = list(warm) + list(res)
        coeffs = fmt.FIXED_COEFFS[int(k)]
        for t in range(k, B):
            sig[t] += sum(c * sig[t - 1 - j]
                          for j, c in enumerate(coeffs))
        expected[i] = sig
    out = np.asarray(_fixed_integrate(jnp.array(rows),
                                      jnp.array(orders),
                                      jnp.array(seeds)))
    np.testing.assert_array_equal(out.astype(np.int64), expected)


def _numpy_lpc64(rows, cf, shift, order):
    """Scalar reference of the 64-bit-accumulator LPC recurrence
    (InterType i64, zflac.zig:314-319,526-533)."""
    S, B = rows.shape
    out = rows.astype(np.int64).copy()
    for s in range(S):
        o = int(order[s])
        for t in range(o, B):
            acc = 0
            for j in range(o):
                acc += int(cf[s, j]) * int(out[s, t - 1 - j])
            out[s, t] = int(rows[s, t]) + (acc >> int(shift[s]))
    return out


def _numpy_lpc64_33(rows_hi, rows_lo, cf, shift, order):
    """Scalar reference of the 33-bit-sample recurrence: samples are
    (hi, lo) int64 values, accumulator int64."""
    rows = (rows_hi.astype(np.int64) << 32) | (
        rows_lo.astype(np.int64) & 0xFFFFFFFF)
    return _numpy_lpc64(rows, cf, shift, order)


def _wide_case(seed, S, B, hist):
    rng = np.random.default_rng(seed)
    order = rng.integers(1, hist + 1, S).astype(np.int32)
    shift = np.full(S, 14, np.int32)
    cf = np.zeros((S, hist), np.int32)
    rows = np.zeros((S, B), np.int32)
    for s in range(S):
        o = order[s]
        # sum|c| <= 2^14 = 2^shift keeps the recurrence contractive so
        # true samples stay in int32 while products reach ~2^40.
        lim = 2048 * 8 // hist
        cf[s, :o] = rng.integers(-lim, lim + 1, o)
        rows[s, :o] = rng.integers(-2**29, 2**29, o)      # warm-ups
        rows[s, o:] = rng.integers(-1024, 1025, B - o)     # residuals
    return rows, cf, shift, order


def test_lpc2w_kernel_interpret_matches_numpy64():
    """The wide (hi/lo dual-int32) GPU LPC kernel in interpret mode and
    its lax.scan twin == a scalar int64 reference, on values whose dot
    products exceed 32 bits (the high-res domain)."""
    from zflac_tpu.ops.lpc2w import lpc2w_scan
    from zflac_tpu.ops.lpc_triton import lpc_triton_wide

    hist = 8
    rows, cf, shift, order = _wide_case(13, 128, 64, hist)
    ref = _numpy_lpc64(rows, cf, shift, order)
    assert np.abs(ref).max() < 2**31  # in the kernel's exactness domain
    args = (jnp.asarray(rows.T.copy()), jnp.asarray(cf.T.copy()),
            jnp.asarray(shift[None, :]), jnp.asarray(order[None, :]))
    got_scan = np.asarray(lpc2w_scan(*args, hist=hist)).T
    np.testing.assert_array_equal(got_scan, ref)
    got_kern = np.asarray(lpc_triton_wide(*args, hist=hist,
                                          interpret=True)).T
    np.testing.assert_array_equal(got_kern, ref)


@pytest.mark.parametrize("hist", [8, 16, 32])
def test_lpc2w_scan_matches_numpy64(hist):
    """The plain wide scan == the scalar int64 recurrence for every
    history bucket (kept whether or not the kernel is used)."""
    from zflac_tpu.ops.lpc2w import lpc2w_scan

    rows, cf, shift, order = _wide_case(hist, 64, 96, hist)
    ref = _numpy_lpc64(rows, cf, shift, order)
    got = np.asarray(lpc2w_scan(
        jnp.asarray(rows.T.copy()), jnp.asarray(cf.T.copy()),
        jnp.asarray(shift[None, :]), jnp.asarray(order[None, :]),
        hist=hist)).T
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hist", [8, 16, 32])
def test_lpc2w33_scan_matches_numpy64(hist):
    """The 33-bit scan == the scalar int64 recurrence on samples past
    int32 (the side channel of 32-bit stereo): warm-ups and residuals
    span +-2^32, outputs reassembled from (hi, lo)."""
    from zflac_tpu.ops.lpc2w import lpc2w33_scan

    rng = np.random.default_rng(100 + hist)
    S, B = 64, 96
    rows, cf, shift, order = _wide_case(hist + 1, S, B, hist)
    # Contractive coefficients with 33-bit warm-ups keep |out| < 2^33.
    big = rng.integers(-2**32, 2**32, (S, B))
    warm = np.arange(B)[None, :] < order[:, None]
    rows64 = np.where(warm, big, rows.astype(np.int64))
    hi = (rows64 >> 32).astype(np.int32)
    lo = (rows64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    ref = _numpy_lpc64_33(hi, lo, cf, shift, order)
    assert np.abs(ref).max() < 2**33
    oh, ol = lpc2w33_scan(
        jnp.asarray(hi.T.copy()), jnp.asarray(lo.T.copy()),
        jnp.asarray(cf.T.copy()), jnp.asarray(shift[None, :]),
        jnp.asarray(order[None, :]), hist=hist)
    got = (np.asarray(oh).T.astype(np.int64) << 32) | (
        np.asarray(ol).T.astype(np.int64) & 0xFFFFFFFF)
    np.testing.assert_array_equal(got, ref)


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platforms,want", [
    (["cpu"], "cpu"), (["gpu"], "gpu"), (["gpu"] * 4, "gpu"),
    (["metal"], None), (["gpu", "cpu"], None), (["rocm"], None)])
def test_backend_chooser(platforms, want):
    """cpu -> the plain XLA math, gpu -> the kernels; any other or a
    mixed set of platforms raises instead of falling back."""
    from zflac_tpu.runtime.backend import backend

    devs = [_Dev(p) for p in platforms]
    if want is None:
        with pytest.raises(ValueError):
            backend(devs)
    else:
        assert backend(devs) == want


def test_backend_chooser_default_device():
    """Without devices the chooser answers for the default device,
    including under jax.default_device."""
    import jax

    from zflac_tpu.runtime.backend import backend

    assert backend() == "cpu"
    with jax.default_device(jax.devices("cpu")[0]):
        assert backend() == "cpu"
