"""Multi-process (multi-host) long-stream decode over jax.distributed.

This is the executable form of the multi-host claim in longstream.py:
the same boundary-exchange design, but the shards live in DIFFERENT
PROCESSES (each with its own device pool), and the boundary state and
PCM slices cross process boundaries through real XLA collectives on the
global mesh — on a pod these ride ICI/DCN; in the CPU-simulated mode
(SURVEY.md §4) they ride Gloo between local processes.

Per process p of P (after jax.distributed.initialize):
  1. every process parses STREAMINFO and computes the deterministic
     anchor table (sync-scan + CRC-validated frame starts at the P
     byte-range boundaries) — header-scan work only, no decode;
  2. process p indexes and decodes ONLY its own byte range
     [anchor_p, anchor_{p+1});
  3. boundary rows (anchor, landed, frames, samples) cross the global
     mesh via all_gather; every process computes the same prefix-sum
     PCM offsets and verifies chain consistency
     (landed_p == anchor_{p+1}: no gaps, no overlaps);
  4. per-shard PCM slices cross the mesh via a second all_gather
     (padded to the max shard length, exact int32 lanes);
  5. every process assembles the full PCM, verifies the stream MD5
     (zflac.zig:267-280), and returns an identical DecodedFLAC.

Run one process standalone for testing:
  python -m zflac_tpu.parallel.distributed <stream.flac> <out.npy> \
      <coordinator host:port> <process_id> <num_processes>

Counters are exchanged as hi/lo int32 pairs: the transfer lanes stay
int32 (no jax x64 mode), yet byte offsets beyond 2^31 (hour-long
hi-res streams, BASELINE.json config 5) remain exact.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bitio import BitReader
from ..errors import InvalidChecksum, InvalidFrameHeader
from ..oracle import parse_metadata
from ..utils.log import get_logger

_log_shard = get_logger("shard")

shard_map = jax.shard_map


def _global_mesh() -> Mesh:
    """1-D ('dp',) mesh over all global devices, ordered process-major
    so row d // local_device_count belongs to process d of the mesh."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs), ("dp",))


def _split_i64(row: np.ndarray) -> np.ndarray:
    """int64 [K] -> int32 [2K] as (hi, lo) pairs (exact)."""
    u = row.astype(np.uint64)
    hi = (u >> np.uint64(32)).astype(np.uint32).astype(np.int64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).astype(np.int64)
    out = np.empty(2 * len(row), dtype=np.int64)
    out[0::2], out[1::2] = hi, lo
    return out.astype(np.uint32).view(np.int32).astype(np.int32)


def _join_i64(pairs: np.ndarray) -> np.ndarray:
    """int32 [..., 2K] (hi, lo) -> int64 [..., K]."""
    u = pairs.view(np.uint32).astype(np.uint64)
    hi, lo = u[..., 0::2], u[..., 1::2]
    return ((hi << np.uint64(32)) | lo).astype(np.int64)


def _allgather_rows(mesh: Mesh, local_row: np.ndarray) -> np.ndarray:
    """Gather one int32 row per PROCESS over the global mesh.

    local_row: [K] int32, this process's contribution (replicated over
    its local devices). Returns [num_processes, K] — identical on
    every process."""
    K = len(local_row)
    L = jax.local_device_count()
    local = np.tile(local_row[None, :], (L, 1))
    sharding = NamedSharding(mesh, P("dp", None))
    garr = jax.make_array_from_process_local_data(sharding, local)
    D = int(mesh.devices.size)

    def body(x):
        g = jax.lax.all_gather(x, "dp").reshape(D, K)
        return jnp.broadcast_to(g[None], (x.shape[0], D, K))

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp", None),),
                           out_specs=P("dp", None, None)))
    out = np.asarray(fn(garr).addressable_shards[0].data)[0]  # [D, K]
    return out[::L][:jax.process_count()]


def decode_longstream_distributed(data: bytes, check_crc: bool = False,
                                  verify_md5: bool = True):
    """Steps 1-5 above. Call in every process of an initialized
    jax.distributed job; every process returns the full result."""
    from ..format import normalization_shift
    from ..index.native_indexer import find_anchor, index_range
    from ..result import DecodedFLAC, container_dtype
    from ..runtime.decode import (
        _assemble,
        _run_reconstruct,
        verify_stream_md5,
    )

    Pn = jax.process_count()
    p = jax.process_index()
    mesh = _global_mesh()

    # 1. deterministic anchor table (identical in every process).
    br = BitReader(data)
    info = parse_metadata(br)
    first = br.pos // 8
    span = len(data) - first
    bounds = [first + span * h // Pn for h in range(Pn + 1)]
    anchors = [first] + [find_anchor(data, bounds[h], bounds[h + 1], info)
                         for h in range(1, Pn)]
    starts = sorted(set(a for a in anchors if a >= 0))

    # 2. index + decode only our own range.
    if p < len(starts):
        a = starts[p]
        stop = starts[p + 1] if p + 1 < len(starts) else len(data)
        plan, landed = index_range(data, a, stop, info,
                                   check_crc=check_crc)
        with jax.default_device(jax.local_devices()[0]):
            part = _assemble(plan, _run_reconstruct(plan))
        row64 = np.array([a, landed, plan.num_frames,
                          plan.total_samples], dtype=np.int64)
    else:  # empty shard (window held no frame start)
        part = np.zeros(0, dtype=container_dtype(info.bits_per_sample))
        row64 = np.array([-1, -1, 0, 0], dtype=np.int64)

    # 3. boundary exchange + chain verify (identical result everywhere).
    g = _join_i64(_allgather_rows(mesh, _split_i64(row64)))  # [Pn, 4]
    _log_shard.debug("process %d/%d boundary rows: %s", p, Pn,
                     g.tolist())
    live = g[g[:, 0] >= 0]
    for h in range(len(live) - 1):
        if live[h, 1] != live[h + 1, 0]:
            raise InvalidFrameHeader(
                f"shard {h} landed at {live[h, 1]}, next anchor "
                f"{live[h + 1, 0]}")
    samples = live[:, 3]
    offsets = np.cumsum(samples) - samples

    # 4. PCM exchange: pad each slice to the global max (in int32
    # lanes; container dtypes are narrower or equal).
    channels = info.channel_count
    max_vals = int(samples.max(initial=0)) * channels
    padded = np.zeros(max_vals, dtype=np.int32)
    padded[:len(part)] = part
    gathered = _allgather_rows(mesh, padded)  # [Pn, max_vals]

    # 5. assemble + verify (every process identically).
    dtype = container_dtype(info.bits_per_sample)
    total = int(samples.sum())
    out = np.empty(total * channels, dtype=dtype)
    for h in range(len(live)):
        n = int(live[h, 3]) * channels
        start = int(offsets[h]) * channels
        out[start:start + n] = gathered[h, :n].astype(dtype)

    if verify_md5:
        if not verify_stream_md5(out, info.bits_per_sample, info.md5):
            raise InvalidChecksum("stream MD5 mismatch")
    shift = normalization_shift(info.bits_per_sample)
    if shift:
        out = out << shift

    return DecodedFLAC(
        channels=channels,
        sample_rate=info.sample_rate,
        bits_per_sample=info.bits_per_sample,
        interleaved=out,
        stats={"shards": len(live), "processes": Pn,
               "frames": int(live[:, 2].sum()),
               "engine": "longstream-distributed"},
    )


def decode_pack2_distributed(data: bytes, check_crc: bool = False,
                             verify_md5: bool = True):
    """Multi-process decode through the FLAGSHIP pack2 device path: one
    packed chunk per global device, reconstructed under shard_map on
    the global mesh, with the psum completeness collective crossing
    real process boundaries.

    Per process p of P (L local devices each):
      1. anchor table over P*L byte ranges (identical everywhere);
      2. process p scans its L ranges with the C++ pack2 scan
         (measure-only; natural geometry);
      3. the chunk GEOMETRY (frame/patch/class counts, W, wide flag)
         crosses the mesh so every process computes the same union
         spec; each process re-scans with the forced union geometry
         and repacks its chunks into the unified buffer layout;
      4. the [D, L] buffer array is assembled from process-local rows
         (jax.make_array_from_process_local_data) and one shard_map
         dispatch reconstructs PCM on every device, psum-reducing the
         global sample count across processes;
      5. per-shard PCM and frame tables cross the mesh via all_gather;
         every process assembles the full stream, applies the
         reference's STREAMINFO-total stop semantics, verifies MD5,
         and returns an identical DecodedFLAC.

    Falls back to decode_longstream_distributed when any process's
    range declines the pack2 scan (the flag itself is exchanged, so
    every process takes the same branch)."""
    from ..format import container_bits as fmt_container_bits
    from ..format import normalization_shift
    from ..index.native_indexer import find_anchor, pack2_range
    from ..result import DecodedFLAC, container_dtype
    from ..runtime.decode import verify_stream_md5
    from ..runtime.backend import backend
    from ..runtime.device import _bucket_block
    from .shard import _pad_pow2, make_pack2_body, repack_common
    from ..index.native_indexer import PACK2_CLASSES

    Pn = jax.process_count()
    p = jax.process_index()
    L = jax.local_device_count()
    D = Pn * L
    mesh = _global_mesh()

    # 1. anchor table over D ranges (identical in every process).
    br = BitReader(data)
    info = parse_metadata(br)
    first = br.pos // 8
    span = len(data) - first
    bounds = [first + span * h // D for h in range(D + 1)]
    anchors = [first] + [find_anchor(data, bounds[h], bounds[h + 1],
                                     info)
                         for h in range(1, D)]
    starts = sorted(set(a for a in anchors if a >= 0))

    # 2. natural-geometry scan of our local ranges.
    my = list(range(p * L, (p + 1) * L))
    cks = []
    ok = 1
    for d in my:
        if d >= len(starts):
            cks.append(None)
            continue
        a = starts[d]
        stop = starts[d + 1] if d + 1 < len(starts) else len(data)
        try:
            ck = pack2_range(data, a, stop, info, check_crc=check_crc,
                             max_frames=1 << 20)
        except Exception:
            ck = None
        if ck is None or ck.landed < stop:
            ok = 0
        cks.append(ck)
    if not any(ck is not None for ck in cks):
        # A process with zero anchor ranges cannot derive the unified
        # spec (no chunk to size the buffer from): everyone falls back
        # to the longstream path, which handles empty shards.
        ok = 0

    # 3. geometry union exchange: per process, the max over its local
    # chunks of every capacity plus the ok flag.
    def cap(fn, default=0):
        vals = [fn(ck) for ck in cks if ck is not None]
        return max(vals) if vals else default

    def class_n(ck, name):
        return dict((n, cn) for n, cn, _ in ck.classes).get(name, 0)

    row = np.array(
        [ok, cap(lambda c: c.F), cap(lambda c: c.B),
         cap(lambda c: c.W, 8), cap(lambda c: c.n_patch_p),
         cap(lambda c: int(getattr(c, "wide", False)))] +
        [cap(lambda c, n=n: class_n(c, n)) for n in PACK2_CLASSES],
        dtype=np.int32)
    g = _allgather_rows(mesh, row)  # [Pn, 6 + n_classes]
    if not int(g[:, 0].min()):
        return decode_longstream_distributed(
            data, check_crc=check_crc, verify_md5=verify_md5)
    FpU = _pad_pow2(max(1, int(g[:, 1].max())))
    BpU = _bucket_block(max(int(g[:, 2].max()), 16))
    WU = int(g[:, 3].max())
    n_patch_pU = int(g[:, 4].max())
    wideU = bool(g[:, 5].max())
    cnpU = [int(g[:, 6 + i].max()) for i in range(len(PACK2_CLASSES))]

    # Re-scan with the forced union geometry: the class-sorted buffer
    # layout is deterministic given (Fp, Bp, W, class caps, patch cap,
    # wide), so every process derives byte-identical section offsets
    # => one global spec.
    cks2 = []
    for d in my:
        if d >= len(starts):
            cks2.append(None)  # empty row: repack fills all-invalid
            continue
        a = starts[d]
        stop = starts[d + 1] if d + 1 < len(starts) else len(data)
        ck = pack2_range(data, a, stop, info, check_crc=check_crc,
                         max_frames=FpU, force_fp=FpU, force_bp=BpU,
                         force_w=WU, force_class_np=cnpU,
                         force_patch_np=n_patch_pU, force_wide=wideU)
        # The union geometry only widens capacities, so a forced
        # re-scan of a range that succeeded naturally must land at the
        # same stop. A violation means the processes would disagree on
        # the buffer layout — raising here (in every process, since the
        # inputs are identical) is the only safe outcome; silently
        # proceeding would produce corrupt PCM, and a unilateral
        # fallback would deadlock the collectives. Not an assert: must
        # survive python -O (ADVICE r4).
        if ck is None or ck.landed != stop:
            raise InvalidFrameHeader(
                f"pack2 union re-scan of [{a}, {stop}) landed at "
                f"{getattr(ck, 'landed', None)} (geometry mismatch)")
        cks2.append(ck)
    live_cks = [ck for ck in cks2 if ck is not None]
    bufs, spec = repack_common(live_cks, L)

    # 4. global [D, L] array + one shard_map dispatch.
    sharding = NamedSharding(mesh, P("dp", None))
    garr = jax.make_array_from_process_local_data(sharding, bufs)
    # do_decorrelate must be uniform across processes (it selects the
    # traced program); True is safe — frames with independent channel
    # codes pass through decorrelation unchanged.
    body = make_pack2_body(
        spec, info.channel_count,
        fmt_container_bits(info.bits_per_sample), True,
        backend(mesh.devices.flat))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("dp", None),
                           out_specs=(P("dp"), P("dp"))))
    pcm, totals = fn(garr)
    local_pcm = [np.asarray(s.data)[0] for s in
                 sorted(pcm.addressable_shards, key=lambda s: s.index)]
    psum_total = int(np.asarray(
        totals.addressable_shards[0].data)[0])

    # 5. PCM + frame-table exchange, assembly, stop semantics, MD5.
    C = info.channel_count
    flat_parts = []
    bs_parts = []
    for ck, arr in zip(cks2, local_pcm):
        if ck is None or ck.F == 0:
            flat_parts.append(np.zeros(0, np.int32))
            bs_parts.append(np.zeros(0, np.int32))
            continue
        vals = [arr[f, :ck.f_block_size[f], :].reshape(-1)
                for f in range(ck.F)]
        flat_parts.append(np.concatenate(vals).astype(np.int32))
        bs_parts.append(ck.f_block_size.astype(np.int32))
    my_pcm = (np.concatenate(flat_parts) if flat_parts
              else np.zeros(0, np.int32))
    my_bs = (np.concatenate(bs_parts) if bs_parts
             else np.zeros(0, np.int32))

    # lengths first (so rows can be padded identically everywhere)
    lens = _join_i64(_allgather_rows(mesh, _split_i64(np.array(
        [len(my_pcm), len(my_bs)], dtype=np.int64))))  # [Pn, 2]
    max_pcm = int(lens[:, 0].max())
    max_bs = int(lens[:, 1].max())
    pad_pcm = np.zeros(max_pcm, np.int32)
    pad_pcm[:len(my_pcm)] = my_pcm
    pad_bs = np.zeros(max_bs, np.int32)
    pad_bs[:len(my_bs)] = my_bs
    g_pcm = _allgather_rows(mesh, pad_pcm)   # [Pn, max_pcm]
    g_bs = _allgather_rows(mesh, pad_bs)     # [Pn, max_bs]

    block_sizes = [g_bs[h, :int(lens[h, 1])] for h in range(Pn)]
    parts = [g_pcm[h, :int(lens[h, 0])] for h in range(Pn)]
    all_bs = (np.concatenate(block_sizes) if block_sizes
              else np.zeros(0, np.int32))
    out32 = (np.concatenate(parts) if parts
             else np.zeros(0, np.int32))
    # Cross-process completeness invariant: the on-mesh psum of decoded
    # samples must equal the gathered frame tables' total. A mismatch
    # means a device decoded different geometry than its process
    # reported — corrupt-PCM territory, so fail loudly even under
    # python -O (ADVICE r4: was a bare assert).
    if psum_total != int(all_bs.sum(dtype=np.int64)) * C:
        raise InvalidChecksum(
            f"pack2 distributed sample-count mismatch: psum "
            f"{psum_total} != frame tables "
            f"{int(all_bs.sum(dtype=np.int64)) * C}")

    # Reference stop semantics (zflac.zig:343-350,394-402).
    decoded = int(all_bs.sum(dtype=np.int64))
    if info.total_samples and decoded > info.total_samples:
        total, offset, valid = info.total_samples, 0, True
        cut = None
        for fi, b in enumerate(all_bs):
            if valid and offset >= total:
                cut = fi
                break
            if valid and offset + int(b) > total:
                valid = False
            offset += int(b)
        if cut is not None:
            out32 = out32[:offset * C]

    dtype = container_dtype(info.bits_per_sample)
    out = out32.astype(dtype)
    if verify_md5:
        if not verify_stream_md5(out, info.bits_per_sample, info.md5):
            raise InvalidChecksum("stream MD5 mismatch")
    shift = normalization_shift(info.bits_per_sample)
    if shift:
        out = out << shift
    return DecodedFLAC(
        channels=C,
        sample_rate=info.sample_rate,
        bits_per_sample=info.bits_per_sample,
        interleaved=out,
        stats={"shards": len(starts), "processes": Pn,
               "frames": int(len(all_bs)),
               "engine": "pack2-distributed"},
    )


def _worker_main(argv) -> int:
    stream_path, out_path, coordinator, pid, nprocs = argv[:5]
    engine = argv[5] if len(argv) > 5 else "longstream"
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=int(nprocs),
                               process_id=int(pid))
    with open(stream_path, "rb") as f:
        data = f.read()
    if engine == "pack2":
        r = decode_pack2_distributed(data)
    else:
        r = decode_longstream_distributed(data)
    np.save(out_path, r.interleaved)
    print(f"process {pid}/{nprocs}: {r.stats}", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_worker_main(sys.argv[1:]))
