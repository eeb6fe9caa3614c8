"""Pure-Python host frame indexer (fallback + executable spec for the
C++ scanner).

Walks the serial bitstream once (the only inherently sequential pass —
SURVEY.md §7 fact 1) and emits the dense StreamPlan: warmup-seeded
residual rows, predictor descriptors, and frame geometry. No sample
reconstruction happens here — that is phase 2, on the device.

Bitstream semantics mirror /root/reference/src/zflac.zig:312-666; see
oracle.py for the scalar reference decoder that shares the header
parsing helpers.
"""

from __future__ import annotations

import numpy as np

from .. import format as fmt
from ..bitio import BitReader
from ..crc import crc8, crc16
from ..errors import (
    EndOfStream,
    InconsistentParameters,
    InvalidChecksum,
    InvalidFrameHeader,
    InvalidSubframeHeader,
)
from ..oracle import parse_metadata, read_coded_number, _decode_residuals
from ..plan import StreamPlan, fixed_seeds_from_warmup, stream_dtype
from ..utils.log import get_logger

_log_frame = get_logger("frame")
_log_subframe = get_logger("subframe")


def build_plan(data: bytes, check_crc: bool = False) -> StreamPlan:
    br = BitReader(data)
    stream_info = parse_metadata(br)
    dtype = stream_dtype(stream_info.bits_per_sample)

    valid_total = stream_info.total_samples > 0
    expected_channels = stream_info.channel_count
    total_count = expected_channels * (
        stream_info.total_samples if valid_total else 4096)

    first_frame = True
    sample_rate = 0
    channel_count = 0
    bit_depth_code = -1
    bits_per_sample = 0

    # Per-frame collections (stacked at the end).
    f_block_size: list[int] = []
    f_channel_code: list[int] = []
    f_pcm_start: list[int] = []
    f_byte_offset: list[int] = []
    f_coded: list[int] = []
    variable_blocking = False
    s_rows: list[np.ndarray] = []
    s_kind: list[int] = []
    s_order: list[int] = []
    s_wasted: list[int] = []
    s_shift: list[int] = []
    s_coeffs: list[np.ndarray] = []
    s_seeds: list[np.ndarray] = []
    s_wide: list[bool] = []

    offset = 0
    pcm_start = 0
    while True:
        if valid_total and offset >= total_count:
            break
        frame_start_byte = br.pos // 8
        try:
            header_word = br.read_u32()
        except EndOfStream:
            if valid_total:
                raise
            break

        if (header_word >> 17) != fmt.FRAME_SYNC:
            raise InvalidFrameHeader()
        block_size_code = (header_word >> 12) & 0xF
        sample_rate_code = (header_word >> 8) & 0xF
        channels_code = (header_word >> 4) & 0xF
        bd_code = (header_word >> 1) & 0x7
        if not f_block_size:
            variable_blocking = bool((header_word >> 16) & 1)

        coded_number = read_coded_number(br)

        if block_size_code == fmt.BS_RESERVED:
            raise InvalidFrameHeader()
        elif block_size_code == fmt.BS_UNCOMMON_U8:
            block_size = br.read_u8() + 1
        elif block_size_code == fmt.BS_UNCOMMON_U16:
            raw = br.read_u16()
            if raw == 0xFFFF:
                raise InvalidFrameHeader()
            block_size = raw + 1
        else:
            block_size = fmt.block_size_value(block_size_code)

        sr_entry = fmt.SAMPLE_RATE_TABLE[sample_rate_code]
        if sr_entry == fmt.SR_STREAMINFO:
            frame_sample_rate = stream_info.sample_rate
        elif sr_entry == fmt.SR_U8_KHZ:
            frame_sample_rate = br.read_u8() * 1000
        elif sr_entry == fmt.SR_U16_HZ:
            frame_sample_rate = br.read_u16()
        elif sr_entry == fmt.SR_U16_HZ_X10:
            frame_sample_rate = br.read_u16() * 10
        elif sr_entry == fmt.SR_FORBIDDEN:
            raise InvalidFrameHeader()
        else:
            frame_sample_rate = sr_entry

        if first_frame:
            sample_rate = frame_sample_rate
            channel_count = fmt.channel_count(channels_code)
            bit_depth_code = bd_code
            if bd_code == 0:
                bits_per_sample = stream_info.bits_per_sample
            elif fmt.BIT_DEPTH_TABLE[bd_code] is None:
                raise InvalidFrameHeader()
            else:
                bits_per_sample = fmt.BIT_DEPTH_TABLE[bd_code]
            if channel_count != expected_channels:
                raise InconsistentParameters()
            first_frame = False
        else:
            if (sample_rate != frame_sample_rate
                    or channel_count != fmt.channel_count(channels_code)
                    or bit_depth_code != bd_code):
                raise InconsistentParameters()

        expected_end = offset + block_size * channel_count
        if valid_total and expected_end > total_count:
            valid_total = False  # metadata total was wrong (growth path)

        if block_size == 1 and (valid_total and expected_end < total_count):
            raise InvalidFrameHeader()

        header_crc = br.read_u8()
        if check_crc:
            if crc8(data[frame_start_byte:br.pos // 8 - 1]) != header_crc:
                raise InvalidChecksum("frame header CRC-8 mismatch")

        if _log_frame.isEnabledFor(10):  # DEBUG
            # Per-frame trace line (zflac.zig:412-421).
            _log_frame.debug(
                "frame %d: byte %d, coded %d, bs %d, sr %d, chmode %d, "
                "bd code %d", len(f_block_size), frame_start_byte,
                coded_number, block_size, frame_sample_rate,
                channels_code, bd_code)

        side = fmt.side_channel(channels_code)
        for channel in range(channel_count):
            if br.read_bits(1) != 0:
                raise InvalidSubframeHeader()
            type_bits = br.read_bits(6)
            wasted_flag = br.read_bits(1)
            wasted = (br.read_unary() + 1) if wasted_flag else 0
            sub_bps = bits_per_sample + (1 if channel == side else 0)

            kind_order = fmt.classify_subframe(type_bits)
            if kind_order is None:
                raise InvalidSubframeHeader()
            kind, order = kind_order
            if kind == fmt.SF_FIXED and order > 4:
                raise InvalidSubframeHeader()

            read_depth = sub_bps - wasted
            if read_depth <= 0:
                raise InvalidSubframeHeader()
            row = np.zeros(block_size, dtype=dtype)
            coeffs = np.zeros(32, dtype=np.int32)
            seeds = np.zeros(4, dtype=dtype)
            shift = 0
            wide = False

            if kind == fmt.SF_CONSTANT:
                row[:1] = br.read_signed(read_depth)
            elif kind == fmt.SF_VERBATIM:
                for i in range(block_size):
                    row[i] = br.read_signed(read_depth)
            elif kind == fmt.SF_FIXED:
                warm = [br.read_signed(read_depth) for _ in range(order)]
                row[:order] = warm
                row[order:] = _decode_residuals(br, block_size, order)
                seeds = fixed_seeds_from_warmup(warm, order, dtype)
            else:  # SF_LPC
                warm = [br.read_signed(read_depth) for _ in range(order)]
                row[:order] = warm
                precision = br.read_bits(4) + 1
                shift = br.read_bits(5)
                # Reversed layout: slot 31-j multiplies s[i-1-j]
                # (zflac.zig:512-514).
                for j in range(order):
                    coeffs[31 - j] = br.read_signed(precision)
                row[order:] = _decode_residuals(br, block_size, order)
                # The reference accumulates ≤16-bit streams in i32
                # unconditionally (InterType, zflac.zig:314-319) and
                # passes the conformance corpus that way; mirror it.
                # decode(safe_lpc=True) re-routes LPC rows to the
                # widened class for hardened decoding.
                wide = False

            if _log_subframe.isEnabledFor(10):
                # Per-subframe trace line (zflac.zig:446,456,476,516).
                _log_subframe.debug(
                    "  subframe #%d: kind %d order %d wasted %d shift %d",
                    channel, kind, order, wasted, shift)
            s_rows.append(row)
            s_kind.append(kind)
            s_order.append(order)
            s_wasted.append(wasted)
            s_shift.append(shift)
            s_coeffs.append(coeffs)
            s_seeds.append(seeds)
            s_wide.append(wide)

        br.align_to_byte()
        frame_crc = br.read_u16()
        if check_crc:
            if crc16(data[frame_start_byte:br.pos // 8 - 2]) != frame_crc:
                raise InvalidChecksum("frame CRC-16 mismatch")

        f_block_size.append(block_size)
        f_channel_code.append(channels_code)
        f_pcm_start.append(pcm_start)
        f_byte_offset.append(frame_start_byte)
        f_coded.append(coded_number)
        offset = expected_end
        pcm_start += block_size

    num_frames = len(f_block_size)
    max_block = max(f_block_size) if num_frames else 0
    rows = np.zeros((len(s_rows), max_block), dtype=dtype)
    for i, r in enumerate(s_rows):
        rows[i, :len(r)] = r

    return StreamPlan(
        info=stream_info,
        sample_rate=sample_rate,
        channels=channel_count,
        bits_per_sample=bits_per_sample,
        block_size=np.asarray(f_block_size, dtype=np.int32),
        channel_code=np.asarray(f_channel_code, dtype=np.int32),
        pcm_start=np.asarray(f_pcm_start, dtype=np.int64),
        frame_byte_offset=np.asarray(f_byte_offset, dtype=np.int64),
        coded_number=np.asarray(f_coded, dtype=np.int64),
        variable_blocking=variable_blocking,
        rows=rows,
        kind=np.asarray(s_kind, dtype=np.int32),
        order=np.asarray(s_order, dtype=np.int32),
        wasted=np.asarray(s_wasted, dtype=np.int32),
        shift=np.asarray(s_shift, dtype=np.int32),
        coeffs_rev=(np.stack(s_coeffs) if s_coeffs
                    else np.zeros((0, 32), np.int32)),
        fixed_seeds=(np.stack(s_seeds) if s_seeds
                     else np.zeros((0, 4), dtype)),
        wide=np.asarray(s_wide, dtype=bool),
        total_samples=pcm_start,
        stats={"frames": num_frames},
    )
