"""Rice/bit-unpack of the pack2 buffer: residuals from per-group bit
windows.

Measured-offset two-phase design (SURVEY.md §7 fact 4): the host scan
walks the serial bitstream once and records, for every group of G2
residuals, a window of W words and packed metadata; extraction is then
data-parallel over groups.

  * G2 = 8 residuals per group: a 16-residual span rarely fits an
    8-word window on real streams, forcing W=16 and doubling the
    per-residual select-chain cost;
  * the window is emitted by the C++ scan directly into the packed
    device buffer (pack2_helpers.inc), so there is no device-side
    window gather;
  * W = 8 words per group (adaptively 16 for extreme-k streams),
    chosen by the scan from the measured spans — 4 bytes of upload per
    residual;
  * ONE 64-bit extract per residual: the host envelope guarantees
    q <= 40 and q + 1 + k <= 64, so the quotient, the terminator, and
    the remainder all live in the 64 bits at the residual's start;
  * per-group metadata packed in one int32:
    pos0(5) | k(6: 0-31 rice, 62 escape, 63 invalid) | depth(5) |
    skip(5).

Escaped partitions (fixed-width raw residuals) ride the same math.
Groups outside the envelope are invalidated by the host and patched
from scan-recorded values. Mirrors the semantics of zflac.zig:635-666
(decode_residual_partition).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

G2 = 8  # must match kG2 in index/native/pack2_helpers.inc
K2_ESCAPE = 62
K2_INVALID = 63


def _clz32(u):
    """Count leading zeros of a uint32 vector (exact integer math:
    smear the MSB down, then SWAR popcount)."""
    u = u | (u >> 1)
    u = u | (u >> 2)
    u = u | (u >> 4)
    u = u | (u >> 8)
    u = u | (u >> 16)
    v = u - ((u >> 1) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> 2) & jnp.uint32(0x33333333))
    v = (v + (v >> 4)) & jnp.uint32(0x0F0F0F0F)
    pop = (v * jnp.uint32(0x01010101)) >> 24
    return (jnp.uint32(32) - pop).astype(jnp.int32)


def _bitcast_i32(u):
    return jax.lax.bitcast_convert_type(u, jnp.int32)


def _select_word(win, wi, c_lo, c_hi):
    """win[wi] per element via a select chain (win: [W, *S] uint32;
    wi: [*S] int32; rows outside [c_lo, c_hi] read as 0)."""
    acc = jnp.zeros_like(win[0])
    for c in range(c_lo, c_hi + 1):
        acc = jnp.where(wi == c, win[c], acc)
    return acc


def _unpack16_list(win, meta):
    """Shape-generic group extraction: win[c] (c < W) has the same
    spatial shape as meta. Returns a list of G2 arrays of meta's shape
    (residual j of every group)."""
    W = len(win)
    pos = meta & 31
    k6 = (meta >> 5) & 63
    depth = (meta >> 11) & 31
    skip = (meta >> 16) & 31

    valid = k6 != K2_INVALID
    is_escape = k6 == K2_ESCAPE
    kk = jnp.where(is_escape | ~valid, 0, k6).astype(jnp.uint32)
    d = depth.astype(jnp.uint32)
    du = jnp.minimum(32 - depth, 31)

    outs = []
    for j in range(G2):
        active = valid & (j >= skip)
        wi = pos >> 5
        b = (pos & 31).astype(jnp.uint32)
        # Tight fetch bounds: before residual j, pos <= pos0 + 64*j
        # (the host envelope caps every residual at q + 1 + k <= 64
        # bits) and pos0 < 32, so wi <= (31 + 64*j) >> 5. Residual 0's
        # rows are static (wi == 0); later residuals walk shorter
        # select chains than the worst case.
        hi = min((31 + 64 * j) >> 5, W - 3)
        if hi == 0:
            w0, w1, w2 = win[0], win[1], win[2]
        else:
            w0 = _select_word(win, wi, 0, hi)
            w1 = _select_word(win, wi + 1, 1, hi + 1)
            w2 = _select_word(win, wi + 2, 2, hi + 2)
        # (x >> 1) >> (31 - b) == x >> (32 - b), defined for b == 0.
        chunk = (w0 << b) | ((w1 >> 1) >> (jnp.uint32(31) - b))
        chunk2 = (w1 << b) | ((w2 >> 1) >> (jnp.uint32(31) - b))

        # Unary quotient from the 64 bits at pos (host: q <= 40).
        zeros = jnp.where(chunk != 0, _clz32(chunk),
                          32 + _clz32(chunk2))
        # Remainder: k bits starting at zeros+1 within (chunk, chunk2);
        # host envelope q + 1 + k <= 64 keeps it inside. sh is clamped
        # so garbage lanes (decoding past their last real residual)
        # stay shift-defined; their values are masked downstream.
        sh = jnp.minimum(zeros + 1, 41).astype(jnp.uint32)
        fhi = jnp.where(
            sh < 32,
            (chunk << sh) | ((chunk2 >> 1) >> (jnp.uint32(31) - sh)),
            chunk2 << (sh & 31))
        rem = jnp.where(kk > 0, fhi >> (jnp.uint32(32) - kk),
                        jnp.uint32(0))
        q = zeros.astype(jnp.uint32)
        zz = (q << kk) | rem
        # Zigzag decode in uint32 wraparound == the int32 bit pattern
        # (zflac.zig:663-664).
        rice_val = _bitcast_i32((zz >> 1) ^ (jnp.uint32(0) - (zz & 1)))
        rice_adv = zeros + 1 + kk.astype(jnp.int32)

        # Escape path: fixed-width signed residual (arithmetic shift
        # sign-extends the depth-bit value; depth == 0 -> all zeros).
        esc_val = jnp.where(depth > 0, _bitcast_i32(chunk) >> du, 0)
        esc_adv = depth

        value = jnp.where(is_escape, esc_val, rice_val)
        adv = jnp.where(is_escape, esc_adv, rice_adv)
        outs.append(jnp.where(active, value, 0).astype(jnp.int32))
        pos = jnp.where(active, pos + adv, pos)
    return outs


def _unpack16_math(win, meta):
    """Flat-layout wrapper of _unpack16_list (the CPU-reference form):
    win [W, L] uint32, meta [1, L] int32. Returns out [G2, L] int32."""
    return jnp.concatenate(
        _unpack16_list(win[:, None, :], meta), axis=0)


def unpack16_rows_math(win, meta, *, Ssort: int):
    """Time-major residual rows: the C++ scan emits groups P-MAJOR
    (slot = p * Ssort + sorted subframe), so the flat [G2, NGp] math
    output re-lays to [(NGp/Ssort)*G2, Ssort] — row t = p*G2 + j is
    time, the lane is the sorted subframe (the layout the LPC
    reconstruction consumes)."""
    W, NGp = win.shape
    GP1 = NGp // Ssort
    out = _unpack16_math(win, meta)
    return out.reshape(G2, GP1, Ssort).transpose(1, 0, 2).reshape(
        GP1 * G2, Ssort)



