"""CPU-reference math for the v1 measured-offset Rice group table.

SUPERSEDED ON DEVICE by the pack2 path (ops/rice16.py + the C++
pack2 scan): pack2 moved window assembly into the native scan and
ships class-sorted packed buffers, removing the device-side window
gather that dominated this design (PERF.md). What remains here is the
*reference implementation* of group-table extraction — `_unpack_math`
as plain XLA/numpy ops plus the host-side window gather — kept as the
differential oracle for the C++ scan's group table (emit_groups;
tests/test_rice_kernel.py). No Pallas kernel lives here anymore.

The group-table design itself (measured bit offsets -> data-parallel
extraction; SURVEY.md §7 fact 4) mirrors zflac.zig:635-666.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

G = 8           # residuals per group (indexer kGroupG)
W = 12          # window words per group (kGroupWindowWords)
K_ESCAPE = 0xFE
K_INVALID = 0xFF


def _clz32(u):
    """Count leading zeros of a uint32 vector (exact, no float tricks):
    smear the MSB down, then SWAR popcount."""
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


def _select_word(win, wi, c_lo, c_hi):
    """win[wi] per lane for wi in [c_lo, c_hi] via a select chain
    (win: [W, L] uint32; wi: [1, L] int32)."""
    acc = jnp.zeros_like(win[0:1])
    for c in range(c_lo, c_hi + 1):
        acc = jnp.where(wi == c, win[c:c + 1], acc)
    return acc


def _extract64(win, pos, max_word):
    """(chunk, chunk2): two consecutive MSB-first 32-bit big-endian
    chunks starting at bit `pos` of the lane's window."""
    wi = pos >> 5
    b = (pos & 31).astype(jnp.uint32)
    w0 = _select_word(win, wi, 0, max_word)
    w1 = _select_word(win, wi + 1, 1, min(max_word + 1, W - 1))
    w2 = _select_word(win, wi + 2, 2, min(max_word + 2, W - 1))
    # (x >> 1) >> (31 - b) == x >> (32 - b), defined for b == 0.
    lo_part0 = (w1 >> 1) >> (jnp.uint32(31) - b)
    lo_part1 = (w2 >> 1) >> (jnp.uint32(31) - b)
    chunk = (w0 << b) | lo_part0
    chunk2 = (w1 << b) | lo_part1
    return chunk, chunk2


def _unpack_math(win, pos0, k, depth, skip):
    """Reference group-extraction math (plain XLA ops). All inputs [*, L]:
    win [W, L] uint32, pos0/k/depth/skip [1, L] int32.
    Returns out [G, L] int32."""
    valid = (k != K_INVALID)
    is_escape = (k == K_ESCAPE)
    kk = jnp.where(is_escape | ~valid, 0, k).astype(jnp.uint32)
    d = depth.astype(jnp.uint32)

    pos = pos0
    outs = []
    for j in range(G):
        active = valid & (j >= skip)
        chunk, chunk2 = _extract64(win, pos, W - 2)

        # --- Rice path: unary quotient (q <= 40 guaranteed by host) ---
        zeros1 = _clz32(chunk)
        zeros = jnp.where(chunk != 0, zeros1, 32 + _clz32(chunk2))
        q = zeros
        rem_pos = pos + q + 1
        rem_chunk, _ = _extract64(win, rem_pos, W - 1)
        rem = jnp.where(kk > 0,
                        (rem_chunk >> 1) >> (jnp.uint32(31) - kk),
                        jnp.uint32(0))
        zz = (q.astype(jnp.uint32) << kk) | rem
        # Zigzag decode in uint32 wraparound == the int32 bit pattern.
        rice_val = _bitcast_i32(
            (zz >> 1) ^ (jnp.uint32(0) - (zz & 1)))
        rice_adv = q + 1 + kk.astype(jnp.int32)

        # --- escape path: fixed-width signed residual ---
        # int32 min (no unsigned min needed); arithmetic shift
        # sign-extends the depth-bit value.
        esc_shift = jnp.minimum(32 - depth, 31)
        esc_val = jnp.where(depth > 0,
                            _bitcast_i32(chunk) >> esc_shift, 0)
        esc_adv = depth

        value = jnp.where(is_escape, esc_val, rice_val)
        adv = jnp.where(is_escape, esc_adv, rice_adv)
        outs.append(jnp.where(active, value, 0).astype(jnp.int32))
        pos = jnp.where(active, pos + adv, pos)
    return jnp.concatenate(outs, axis=0)


def _bitcast_i32(u):
    """uint32 -> int32 bit reinterpretation."""
    return jax.lax.bitcast_convert_type(u, jnp.int32)


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------


def build_group_inputs(data: bytes, plan):
    """Gather per-group bit windows + per-lane metadata from the plan's
    group table (numpy, vectorized). Returns (windows [W, NG] uint32,
    pos0, k, depth, skip [1, NG] i32, valid_mask [S, GPB] bool) with
    NG = S * GPB padded to a lane multiple by the caller."""
    g = plan.groups
    assert g is not None, "plan built without emit_groups"
    off = g["off"]                      # [S, GPB] i64
    S, GPB = off.shape

    # Bitstream as big-endian u32 words, padded so that a full window
    # gather at the last group stays in bounds.
    pad = (-len(data)) % 4 + 4 * (W + 1)
    words = np.frombuffer(data + b"\x00" * pad, dtype=">u4")

    flat_off = off.reshape(-1)
    valid = (g["k"].reshape(-1) != K_INVALID) & (flat_off >= 0)
    word_idx = np.where(valid, flat_off >> 5, 0).astype(np.int64)
    # [NG, W] gather of each group's window.
    win = words[word_idx[:, None] + np.arange(W)[None, :]]
    win = np.ascontiguousarray(win.astype(np.uint32).T)   # [W, NG]

    pos0 = np.where(valid, flat_off & 31, 0).astype(np.int32)
    k = np.where(valid, g["k"].reshape(-1), K_INVALID).astype(np.int32)
    depth = g["depth"].reshape(-1).astype(np.int32)

    # skip: leading warm-up positions in the first recorded group.
    order = plan.order                  # [S]
    gidx = np.tile(np.arange(GPB)[None, :], (S, 1))
    skip = np.clip(order[:, None] - gidx * G, 0, G).astype(np.int32)
    skip = skip.reshape(-1)

    return (win, pos0[None, :], k[None, :], depth[None, :],
            skip[None, :], valid.reshape(S, GPB))


def rows_from_groups(data: bytes, plan, lanes: int = 512,
                     impl: str = "jnp", interpret: bool = False):
    """Residual rows decoded from the bitstream windows via the
    reference group-table math, with host patching of invalid groups
    and warm-up positions. Returns [S, B] int32 rows equivalent to
    plan.rows (the differential check for the C++ group scan)."""
    if plan.groups is None:
        # No Rice-coded subframes (constant/verbatim-only stream).
        return plan.rows.astype(np.int32)
    win, pos0, k, depth, skip, valid = build_group_inputs(data, plan)
    S, GPB = valid.shape
    NG = S * GPB
    NGp = -(-NG // lanes) * lanes
    if NGp != NG:
        pad = NGp - NG
        win = np.pad(win, ((0, 0), (0, pad)))
        pos0 = np.pad(pos0, ((0, 0), (0, pad)))
        k = np.pad(k, ((0, 0), (0, pad)), constant_values=K_INVALID)
        depth = np.pad(depth, ((0, 0), (0, pad)))
        skip = np.pad(skip, ((0, 0), (0, pad)))

    del impl, interpret  # single (reference) implementation remains
    out = jax.jit(_unpack_math)(win, pos0, k, depth, skip)
    out = np.asarray(out)[:, :NG]                  # [G, NG]
    rows = out.T.reshape(S, GPB * G)[:, :plan.max_block]

    # Patch invalid groups + warm-up region from the host rows, and
    # zero the padding past each subframe's block size (a short final
    # group decodes past the subframe into the next one's bits).
    col = np.arange(plan.max_block)[None, :]
    group_valid = np.repeat(valid, G, axis=1)[:, :plan.max_block]
    host_rows = plan.rows.astype(np.int32)
    bs_sub = np.repeat(plan.block_size, plan.channels)[:, None]
    rows = np.where(col < plan.order[:, None], host_rows,
                    np.where(group_valid, rows, host_rows))
    return np.where(col < bs_sub, rows, 0)
