"""64-bit (hi, lo) pair arithmetic for the wide pack2 path.

33-bit side-channel subframes (32-bit stream + stereo decorrelation —
the reference's i64 InterType domain, zflac.zig:256-264,314-319) do not
fit the int32 lanes the device path runs on. The path was built for an
accelerator without native int64 vector ops, so wide chunks carry
every value as an (hi: int32, lo: uint32) pair and emulate the handful
of 64-bit operations the decode needs: add/sub (bitwise carry/borrow, no unsigned compares),
left shift by 0..31 (wasted bits), the decorrelation ops including the
mid-side `(mid +/- side) >> 1` whose bit 32 is the whole reason the
pair exists, and a pairwise associative scan for the fixed-predictor
cumsums. Bit-exactness vs the int64 host engine is pinned by
tests/test_device_decode.py and the v_32bit_side hand vector.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import format as fmt


def _u32(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _carry(a_u, b_u, s_u):
    """Carry-out of the uint32 add s = a + b, as int32 0/1."""
    return _i32(((a_u & b_u) | ((a_u | b_u) & ~s_u)) >> 31)


def add64(ah, al, bh, bl):
    lo = al + bl
    return ah + bh + _carry(al, bl, lo), lo


def sub64(ah, al, bh, bl):
    """a - b via a + (~b) + 1 (the +1 rides as carry-in on the lo add:
    lo = al + ~bl + 1 == al - bl; carry-out of that 33-bit sum is
    carry(al, ~bl, al + ~bl) | (al + ~bl == 0xFFFFFFFF and +1 wraps)."""
    nbl = ~bl
    lo0 = al + nbl
    lo = lo0 + jnp.uint32(1)
    c = _carry(al, nbl, lo0) + _i32((lo0 == jnp.uint32(0xFFFFFFFF))
                                    .astype(jnp.uint32))
    return ah + (~bh) + c, lo


def shl64(h, l, w):
    """(h, l) << w for w in [0, 31] (per-row wasted-bits shifts)."""
    wu = w.astype(jnp.uint32)
    lo = l << wu
    spill = (l >> jnp.uint32(1)) >> (jnp.uint32(31) - wu)  # l >> (32-w)
    return _i32((_u32(h) << wu) | spill), lo


def shr1(h, l):
    """Arithmetic (h, l) >> 1."""
    lo = (l >> jnp.uint32(1)) | (_u32(h) << jnp.uint32(31))
    return h >> 1, lo


def shl1_or(h, l, bit_u):
    """((h, l) << 1) | bit — the mid-side `(mid << 1) | (side & 1)`."""
    hi = _i32((_u32(h) << jnp.uint32(1)) | (l >> jnp.uint32(31)))
    return hi, (l << jnp.uint32(1)) | bit_u


def widen(lo_i32):
    """Sign-extend int32 rows into a pair."""
    return lo_i32 >> 31, _u32(lo_i32)


def _pair_add(a, b):
    h, l = add64(a[0], a[1], b[0], b[1])
    return (h, l)


def fixed_integrate_wide(rows_h, rows_l, order, seeds_h, seeds_l):
    """64-bit twin of reconstruct._fixed_integrate: k-fold seeded
    cumsum over (hi, lo) pairs (associative, so lax.associative_scan
    applies per fold). rows_l/seeds_l: uint32."""
    n, B = rows_h.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (n, B), 1)
    wh, wl = rows_h, rows_l
    zero_h = jnp.zeros_like(wh)
    zero_l = jnp.zeros_like(wl)
    for j in range(3, -1, -1):
        active = (order > j)[:, None]
        mh = jnp.where(col < j, zero_h,
                       jnp.where(col == j, seeds_h[:, j:j + 1], wh))
        ml = jnp.where(col < j, zero_l,
                       jnp.where(col == j, seeds_l[:, j:j + 1], wl))
        ch, cl = jax.lax.associative_scan(_pair_add, (mh, ml), axis=1)
        keep = active & (col >= j)
        wh = jnp.where(keep, ch, wh)
        wl = jnp.where(keep, cl, wl)
    return wh, wl


def fixed_integrate_wide_t(rows_h, rows_l, order, seeds_h_t, seeds_l_t):
    """Time-major twin of fixed_integrate_wide (pack2 v3 layout):
    rows [B, n] pairs, order [n], seeds [4, n] pairs (lo as uint32).
    Cumsums run along axis 0 (time)."""
    B, n = rows_h.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (B, n), 0)
    wh, wl = rows_h, rows_l
    zero_h = jnp.zeros_like(wh)
    zero_l = jnp.zeros_like(wl)
    for j in range(3, -1, -1):
        active = (order > j)[None, :]
        mh = jnp.where(row < j, zero_h,
                       jnp.where(row == j, seeds_h_t[j:j + 1, :], wh))
        ml = jnp.where(row < j, zero_l,
                       jnp.where(row == j, seeds_l_t[j:j + 1, :], wl))
        ch, cl = jax.lax.associative_scan(_pair_add, (mh, ml), axis=0)
        keep = active & (row >= j)
        wh = jnp.where(keep, ch, wh)
        wl = jnp.where(keep, cl, wl)
    return wh, wl


def decorrelate2_wide(h0, l0, h1, l1, mode):
    """Stereo decorrelation (zflac.zig:553-578) on 64-bit pair planes.
    mode: [F, 1] channel code. Returns int32 planes (true L/R fit the
    32-bit container by construction)."""
    sr_h, sr_l = add64(h0, l0, h1, l1)         # side-right: L = S + R
    ls_h, ls_l = sub64(h0, l0, h1, l1)         # left-side:  R = L - S
    mh, ml = shl1_or(h0, l0, l1 & jnp.uint32(1))   # mid-side
    ms0h, ms0l = shr1(*add64(mh, ml, h1, l1))
    ms1h, ms1l = shr1(*sub64(mh, ml, h1, l1))
    del sr_h, ls_h, ms0h, ms1h  # outputs fit int32: lo word suffices
    new0 = jnp.where(mode == fmt.CH_SIDE_RIGHT, _i32(sr_l),
                     jnp.where(mode == fmt.CH_MID_SIDE, _i32(ms0l),
                               _i32(l0)))
    new1 = jnp.where(mode == fmt.CH_LEFT_SIDE, _i32(ls_l),
                     jnp.where(mode == fmt.CH_MID_SIDE, _i32(ms1l),
                               _i32(l1)))
    return new0, new1
