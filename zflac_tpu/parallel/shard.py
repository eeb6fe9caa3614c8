"""Frame-parallel sharded reconstruction via shard_map.

FLAC frames are mutually independent once indexed (warm-ups, predictor
state, and residuals are all in-frame — zflac.zig:340-581 carries no
state across frames except the locked stream parameters), so the frame
axis shards cleanly over a ('dp',) mesh: each device reconstructs its
contiguous frame shard with the same batched kernels as the single-chip
path, and the PCM output stays sharded for assembly (or is all-gathered
when a replicated result is requested).

Per-device class gather lists are host-built and padded to a common
shape so the shard_map body is uniform across devices (SPMD).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import format as fmt
from ..plan import StreamPlan
from ..runtime.scatter import scatter_rows
from ..utils.log import get_logger

_log_shard = get_logger("shard")
from ..runtime.reconstruct import (
    _fixed_integrate,
    _lpc_scan,
)

shard_map = jax.shard_map


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _local_reconstruct(rows, kind, order, wasted, shift, coeffs, seeds,
                       idx_const, idx_verb, idx_fixed, idx_lpc,
                       idx_lpc_wide, channel_code, *, num_channels,
                       container_bits):
    """Per-device reconstruction body (runs under shard_map on each
    device's frame shard). Mirrors runtime.reconstruct.reconstruct but
    with positional padded class-index arrays."""
    S, B = rows.shape
    dtype = rows.dtype
    signal = jnp.zeros((S, B), dtype=dtype)

    vals = jnp.broadcast_to(rows[idx_const, 0:1], (idx_const.shape[0], B))
    signal = scatter_rows(signal, idx_const, vals)
    signal = scatter_rows(signal, idx_verb, rows[idx_verb])

    out = _fixed_integrate(rows[idx_fixed], order[idx_fixed],
                           seeds[idx_fixed])
    signal = scatter_rows(signal, idx_fixed, out)

    out = _lpc_scan(rows[idx_lpc], coeffs[idx_lpc], shift[idx_lpc],
                    order[idx_lpc])
    signal = scatter_rows(signal, idx_lpc, out)

    out = _lpc_scan(rows[idx_lpc_wide].astype(jnp.int64),
                    coeffs[idx_lpc_wide], shift[idx_lpc_wide],
                    order[idx_lpc_wide])
    signal = scatter_rows(signal, idx_lpc_wide, out.astype(dtype))

    signal = jnp.left_shift(signal, wasted.astype(dtype)[:, None])

    F = S // num_channels
    frames = signal.reshape(F, num_channels, B)
    if num_channels == 2:
        mode = channel_code[:, None]
        c0, c1 = frames[:, 0], frames[:, 1]
        mid = (c0 << 1) | (c1 & 1)
        new0 = jnp.where(
            mode == fmt.CH_SIDE_RIGHT, c0 + c1,
            jnp.where(mode == fmt.CH_MID_SIDE, (mid + c1) >> 1, c0))
        new1 = jnp.where(
            mode == fmt.CH_LEFT_SIDE, c0 - c1,
            jnp.where(mode == fmt.CH_MID_SIDE, (mid - c1) >> 1, c1))
        frames = jnp.stack([new0, new1], axis=1)

    pcm = frames.transpose(0, 2, 1)
    cdtype = {8: jnp.int8, 16: jnp.int16, 32: jnp.int32}[container_bits]
    # Tiny cross-device stat (exercises a real collective on the mesh and
    # feeds decode stats): global count of decoded samples.
    total = jax.lax.psum(jnp.sum(jnp.ones((F,), jnp.int32)) * B, "dp")
    return pcm.astype(cdtype), total


def _pad_pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def shard_plan(plan: StreamPlan, num_devices: int):
    """Pad + split plan arrays into [n_dev, ...] leading-axis chunks with
    uniform per-device class index lists. Returns (arrays dict, meta)."""
    C = plan.channels
    F = plan.num_frames
    B = max(plan.max_block, 8)
    F_loc = max(1, -(-F // num_devices))
    Fp = F_loc * num_devices
    Sp = Fp * C
    S_loc = F_loc * C

    dtype = plan.rows.dtype
    rows = np.zeros((Sp, B), dtype=dtype)
    rows[:plan.num_subframes, :plan.max_block] = plan.rows

    def pad1(a, n, dt=None):
        out = np.zeros(n, dtype=dt or a.dtype)
        out[:len(a)] = a
        return out

    kind = pad1(plan.kind, Sp)
    order = pad1(plan.order, Sp)
    wasted = pad1(plan.wasted, Sp)
    shift = pad1(plan.shift, Sp)
    coeffs = np.zeros((Sp, 32), np.int32)
    coeffs[:plan.num_subframes] = plan.coeffs_rev
    seeds = np.zeros((Sp, 4), plan.fixed_seeds.dtype)
    seeds[:plan.num_subframes] = plan.fixed_seeds
    channel_code = pad1(plan.channel_code, Fp)
    wide = pad1(plan.wide, Sp, np.bool_)

    # Per-device local class lists, padded to the max size across
    # devices (uniform SPMD shapes). OOB sentinel = S_loc.
    kinds_split = kind.reshape(num_devices, S_loc)
    wide_split = wide.reshape(num_devices, S_loc)
    class_defs = {
        "const": lambda k, w: k == 0,
        "verbatim": lambda k, w: k == 1,
        "fixed": lambda k, w: k == 2,
        "lpc": lambda k, w: (k == 3) & ~w,
        "lpc_wide": lambda k, w: (k == 3) & w,
    }
    class_idx = {}
    for name, pred in class_defs.items():
        locals_ = [np.nonzero(pred(kinds_split[d], wide_split[d]))[0]
                   for d in range(num_devices)]
        width = _pad_pow2(max((len(a) for a in locals_), default=1))
        arr = np.full((num_devices, width), S_loc, dtype=np.int32)
        for d, a in enumerate(locals_):
            arr[d, :len(a)] = a
        class_idx[name] = arr

    arrays = dict(
        rows=rows.reshape(num_devices, S_loc, B),
        kind=kinds_split,
        order=order.reshape(num_devices, S_loc),
        wasted=wasted.reshape(num_devices, S_loc),
        shift=shift.reshape(num_devices, S_loc),
        coeffs=coeffs.reshape(num_devices, S_loc, 32),
        seeds=seeds.reshape(num_devices, S_loc, 4),
        idx_const=class_idx["const"],
        idx_verb=class_idx["verbatim"],
        idx_fixed=class_idx["fixed"],
        idx_lpc=class_idx["lpc"],
        idx_lpc_wide=class_idx["lpc_wide"],
        channel_code=channel_code.reshape(num_devices, F_loc),
    )
    meta = dict(F=F, Fp=Fp, F_loc=F_loc, B=B, C=C)
    return arrays, meta


def reconstruct_sharded(plan: StreamPlan, mesh: Mesh):
    """Decode-phase-2 across the mesh: returns host PCM [F, B, C]."""
    num_devices = mesh.devices.size
    arrays, meta = shard_plan(plan, num_devices)
    C = meta["C"]

    import functools

    body = functools.partial(
        _local_reconstruct,
        num_channels=C,
        container_bits=fmt.container_bits(plan.info.bits_per_sample))

    spec = P("dp")
    fn = shard_map(
        body, mesh=mesh,
        in_specs=tuple(spec for _ in range(13)),
        out_specs=(spec, P()),
    )
    jfn = jax.jit(fn)

    def run():
        # Device-put each chunked array with its sharding (leading axis
        # dp); shard_map consumes the global array, split on axis 0.
        sharded_inputs = []
        for name in ("rows", "kind", "order", "wasted", "shift", "coeffs",
                     "seeds", "idx_const", "idx_verb", "idx_fixed",
                     "idx_lpc", "idx_lpc_wide", "channel_code"):
            a = arrays[name]
            flat = a.reshape(-1, *a.shape[2:])
            sh = NamedSharding(mesh, P("dp", *([None] * (flat.ndim - 1))))
            sharded_inputs.append(jax.device_put(flat, sh))
        return jfn(*sharded_inputs)

    if plan.rows.dtype == np.int64 or bool(np.any(plan.wide)):
        # High-res path: scoped x64 (see runtime/__init__.py).
        with jax.enable_x64(True):
            pcm, total = run()
    else:
        pcm, total = run()
    pcm = np.asarray(pcm)[:meta["F"]]
    return pcm, int(total)


# ---------------------------------------------------------------------------
# pack2 sharded decode: one packed chunk per device
# ---------------------------------------------------------------------------

def class_caps(cks):
    """Union class capacities (name -> max member count) and patch
    capacity over a chunk list — the force_* inputs that make a
    re-scan of each chunk produce one identical spec."""
    from ..index.native_indexer import PACK2_CLASSES
    caps = {}
    for ck in cks:
        for name, cn, _ in ck.classes:
            caps[name] = max(caps.get(name, 0), cn)
    cnp = [caps.get(n, 0) for n in PACK2_CLASSES]
    pnp = max([ck.n_patch_p for ck in cks] + [1])
    wide = any(ck.wide for ck in cks)
    return cnp, pnp, wide


def repack_common(cks, num_devices: int):
    """Stack Pack2Chunks scanned with one forced geometry (Fp/Bp/W/
    class caps/patch cap/wide) into a [D, L] int32 array sharing one
    static spec. The class-sorted buffer layout is deterministic given
    the forced geometry, so chunks are byte-layout compatible and this
    is a pure row copy; missing devices get an empty (all-invalid)
    fill. Raises ValueError when the chunks' specs diverge (caller
    re-scans with wider forcing or falls back)."""
    from ..ops.rice16 import K2_INVALID

    ck0 = cks[0]
    spec = ck0.spec_key()
    for ck in cks[1:]:
        if ck.spec_key() != spec:
            raise ValueError("pack2 chunk specs diverge")
    off = dict(spec[9])
    NGp, n_patch_p, Sp, Bp = spec[5], spec[6], spec[1], spec[2]
    GPB = spec[3]
    Ssort = sum(np_ for _, np_ in spec[8])
    L = len(ck0.device_buf)
    bufs = np.zeros((num_devices, L), np.int32)
    # Empty-device fill: invalid groups, dead-row patch indices,
    # sentinel permutation entries (all land in the dead row / dropped
    # slot of the v3 time-major layout).
    bufs[:, off["meta"]:off["meta"] + NGp] = K2_INVALID << 5
    from ..ops.rice16 import G2
    bufs[:, off["pidx"]:off["pidx"] + n_patch_p] = GPB * G2 * Ssort
    bufs[:, off["inv"]:off["inv"] + Sp] = Ssort
    for d, ck in enumerate(cks):
        bufs[d, :] = ck.device_buf
    return bufs, spec


def make_pack2_body(spec, num_channels: int, container_bits: int,
                    do_decorrelate: bool, backend: str):
    """shard_map body for one pack2 chunk per device: full unpack +
    reconstruction on the local [1, L] buffer shard, plus a psum
    completeness collective over the valid sample counts. Shared by the
    single-process sharded path below and the multi-process path
    (parallel/distributed.py)."""
    from ..runtime.device import _reconstruct_pack2_core

    def body(b):  # [1, L] local shard
        pcm = _reconstruct_pack2_core(
            b[0], spec=spec, num_channels=num_channels,
            container_bits=container_bits,
            do_decorrelate=do_decorrelate, backend=backend)
        off = dict(spec[9])
        Ssort = sum(np_ for _, np_ in spec[8])
        local = jnp.sum(
            jax.lax.dynamic_slice_in_dim(b[0], off["bssub"], Ssort))
        total = jax.lax.psum(local, "dp")
        return pcm[None], total[None]

    return body


def estimate_total_frames(data: bytes, pos: int, info,
                          check_crc: bool = False):
    """Frame-count estimate that does NOT trust STREAMINFO
    total_samples (legal streams may declare 0 — the reference grows
    its buffer, zflac.zig:394-402 — or a wrong value): probe-scan the
    first ~64 frames and extrapolate from measured bytes/frame.
    Returns an int >= 1, or None when even the probe declines."""
    from ..index.native_indexer import pack2_range

    nominal = max(info.min_block_size, 16)
    if info.total_samples:
        return -(-info.total_samples // nominal)
    probe = pack2_range(data, pos, len(data), info, check_crc=check_crc,
                        max_frames=64)
    if probe is None or probe.F == 0:
        return None
    if probe.landed >= len(data):
        return probe.F
    bpf = max(1, (probe.landed - pos) // probe.F)
    return max(probe.F, -(-(len(data) - pos) // bpf))


def decode_to_device_sharded(data: bytes, mesh: Mesh,
                             check_crc: bool = False,
                             chunk_frames: int = 0):
    """Frame-parallel device-resident decode over a ('dp',) mesh using
    the pack2 path: the stream is scanned into packed chunks, the
    [D, L] buffer array of each ROUND of D chunks is sharded on its
    leading axis, and each device runs the full unpack +
    reconstruction on its shard under shard_map (no cross-device data
    dependencies: frames are independent; a psum reduces the
    per-device sample counts as the completeness check). Streams
    longer than one chunk per device dispatch ceil(chunks/D) rounds
    through the SAME compiled executable (uniform spec across rounds);
    unknown/wrong STREAMINFO totals are handled by probe-scan frame
    estimation, not trusted metadata.

    Returns (pcm_rounds: list of [D, Fp, Bp, C] arrays with
    'dp'-sharded leading axes, DeviceDecoded-style metadata dict).
    None when the fast path declines."""
    from ..bitio import BitReader
    from ..index.native_indexer import native_available, pack2_range
    from ..oracle import parse_metadata
    from ..runtime.device import _bucket_block

    if not native_available():
        return None
    br = BitReader(data)
    info = parse_metadata(br)
    if info.bits_per_sample > 32:
        return None
    pos = br.pos // 8
    D = mesh.devices.size
    Bp = _bucket_block(max(info.max_block_size, 16))
    if chunk_frames <= 0:
        est_frames = estimate_total_frames(data, pos, info,
                                           check_crc=check_crc)
        if est_frames is None:
            return None
        chunk_frames = _pad_pow2(max(1, -(-est_frames // D)))
        # Per-device memory cap (~64 MiB of padded rows per chunk):
        # pod-scale streams (BASELINE.json config 5) dispatch multiple
        # rounds instead of one oversized chunk per device.
        while chunk_frames > 1 and \
                chunk_frames * info.channel_count * Bp >= (1 << 25):
            chunk_frames //= 2

    # Pass 1: natural-geometry scan of the whole stream, parallelized
    # across anchor-split byte ranges (runtime/device.py).
    from ..runtime.device import _scan_pack2_chunks
    chunks = _scan_pack2_chunks(data, pos, info, chunk_frames, Bp,
                                check_crc)
    if not chunks:
        return None
    chunk_starts = [a for a, _ in chunks]
    cks = [ck for _, ck in chunks]
    # Stream-consistency rules across chunk boundaries, matching the
    # non-sharded path (zflac.zig:376-392 semantics).
    for ck in cks[1:]:
        if (ck.sample_rate != cks[0].sample_rate or
                ck.C != cks[0].C or
                ck.bits_per_sample != cks[0].bits_per_sample):
            from ..errors import InconsistentParameters
            raise InconsistentParameters(
                "stream parameters changed mid-stream")
    n_rounds = -(-len(cks) // D)
    _log_shard.debug(
        "pack2 sharded: %d chunks over %d devices in %d rounds, "
        "%s frames/chunk, Bp=%d", len(cks), D, n_rounds,
        [ck.F for ck in cks], Bp)
    # One spec across ALL rounds (one compiled executable): if any
    # chunk's natural spec diverges from the first, re-scan every
    # chunk with the forced union geometry.
    spec0 = cks[0].spec_key()
    if any(ck.spec_key() != spec0 for ck in cks[1:]):
        cnp, pnp, wide_u = class_caps(cks)
        force_w = max(ck.W for ck in cks)
        cks = [pack2_range(data, a, ck.landed, info,
                           check_crc=check_crc, max_frames=chunk_frames,
                           force_fp=chunk_frames, force_bp=Bp,
                           force_w=force_w, force_class_np=cnp,
                           force_patch_np=pnp, force_wide=wide_u)
               for a, ck in zip(chunk_starts, cks)]
        if any(ck is None for ck in cks):
            return None

    from ..runtime.backend import backend
    container_bits = fmt.container_bits(info.bits_per_sample)
    do_decor = any(ck.do_decorrelate for ck in cks)
    spec = cks[0].spec_key()
    body = make_pack2_body(spec, cks[0].C, container_bits, do_decor,
                           backend(mesh.devices.flat))
    fn = jax.jit(shard_map(
        body, mesh=mesh, in_specs=P("dp"), out_specs=(P("dp"), P("dp"))))
    sh = NamedSharding(mesh, P("dp"))
    pcm_rounds = []
    totals = None
    for r0 in range(0, len(cks), D):
        bufs, _ = repack_common(cks[r0:r0 + D], D)
        # Dispatches are asynchronous: round r+1's repack overlaps
        # round r's device compute.
        pcm_r, totals_r = fn(jax.device_put(bufs, sh))
        pcm_rounds.append(pcm_r)
        totals = totals_r if totals is None else totals + totals_r

    num_frames = [ck.F for ck in cks]
    block_sizes = [ck.f_block_size for ck in cks]
    # Reference stop semantics at the STREAMINFO total (see
    # runtime/device.py): whole frames starting at/after the total are
    # dropped; a frame crossing it invalidates the total (keep all).
    decoded = sum(int(bs.sum()) for bs in block_sizes)
    if info.total_samples and decoded > info.total_samples:
        total, offset, valid = info.total_samples, 0, True
        cut = None
        for ci, bs_arr in enumerate(block_sizes):
            for fi, b in enumerate(bs_arr):
                if valid and offset >= total:
                    cut = (ci, fi)
                    break
                if valid and offset + int(b) > total:
                    valid = False
                offset += int(b)
            if cut is not None:
                break
        if cut is not None:
            ci, fi = cut
            bs = block_sizes[ci].copy()
            bs[fi:] = 0
            block_sizes[ci] = bs
            num_frames[ci] = fi
            for cj in range(ci + 1, len(block_sizes)):
                num_frames[cj] = 0
                block_sizes[cj] = block_sizes[cj][:0]

    meta = {
        "channels": cks[0].C,
        "sample_rate": cks[0].sample_rate,
        "bits_per_sample": cks[0].bits_per_sample,
        "num_frames": num_frames,
        "block_sizes": block_sizes,
        "md5": info.md5,
        "psum_samples": totals,
        "rounds": len(pcm_rounds),
    }
    return pcm_rounds, meta


def sharded_to_host(pcm, meta):
    """Assemble a sharded pack2 result into interleaved host PCM
    (pre-normalization domain), honoring per-frame block sizes. `pcm`
    is the list of per-round [D, Fp, Bp, C] arrays (a single array is
    accepted as one round); chunk i lives at round i // D, row i % D."""
    C = meta["channels"]
    rounds = pcm if isinstance(pcm, (list, tuple)) else [pcm]
    rounds = [np.asarray(r) for r in rounds]
    D = rounds[0].shape[0]
    parts = []
    for i, (F, bs) in enumerate(zip(meta["num_frames"],
                                    meta["block_sizes"])):
        p = rounds[i // D][i % D][:F]
        if F and np.all(bs == bs[0]):
            parts.append(p[:, :bs[0], :].reshape(-1)[:bs.sum() * C])
        else:
            for f in range(F):
                parts.append(p[f, :bs[f], :].reshape(-1))
    return (np.concatenate(parts) if parts
            else rounds[0].reshape(0))
