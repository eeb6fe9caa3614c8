"""FLAC (RFC 9639) format model: every constant, code table, and header
layout rule the engine needs, in one place.

This encodes the same format facts the reference derives from its enums
(/root/reference/src/zflac.zig:57-185) but as plain data so that the host
indexer (Python and C++), the oracle decoder, the encoder, and the device
kernels all share a single source of truth.
"""

from __future__ import annotations

from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Stream-level constants
# ---------------------------------------------------------------------------

#: 'fLaC' stream magic, big-endian u32 (zflac.zig:10)
SIGNATURE = 0x664C6143
SIGNATURE_BYTES = b"fLaC"

#: 15-bit frame sync code 0b111111111111100 (zflac.zig:351: 0xFFF8 >> 1)
FRAME_SYNC = 0xFFF8 >> 1

# Metadata block types (zflac.zig:30-43)
META_STREAMINFO = 0
META_PADDING = 1
META_APPLICATION = 2
META_SEEKTABLE = 3
META_VORBIS_COMMENT = 4
META_CUESHEET = 5
META_PICTURE = 6
#: Block types 7..126 are reserved/invalid; 127 is forbidden.
META_MAX_VALID = 6

# ---------------------------------------------------------------------------
# Frame header code tables
# ---------------------------------------------------------------------------

#: Sample-rate code (u4) -> Hz, or one of the sentinels below
#: (zflac.zig:57-91).
SR_STREAMINFO = "streaminfo"   # 0b0000: rate only in STREAMINFO
SR_U8_KHZ = "u8khz"            # 0b1100: 8-bit value, kHz
SR_U16_HZ = "u16hz"            # 0b1101: 16-bit value, Hz
SR_U16_HZ_X10 = "u16hzx10"     # 0b1110: 16-bit value, Hz/10
SR_FORBIDDEN = "forbidden"     # 0b1111

SAMPLE_RATE_TABLE = {
    0b0000: SR_STREAMINFO,
    0b0001: 88200,
    0b0010: 176400,
    0b0011: 192000,
    0b0100: 8000,
    0b0101: 16000,
    0b0110: 22050,
    0b0111: 24000,
    0b1000: 32000,
    0b1001: 44100,
    0b1010: 48000,
    0b1011: 96000,
    0b1100: SR_U8_KHZ,
    0b1101: SR_U16_HZ,
    0b1110: SR_U16_HZ_X10,
    0b1111: SR_FORBIDDEN,
}

#: Inverse map for the encoder: Hz -> code (common rates only).
SAMPLE_RATE_CODE = {v: k for k, v in SAMPLE_RATE_TABLE.items()
                    if isinstance(v, int)}

# Channel-layout codes (u4) (zflac.zig:93-123).
CH_INDEPENDENT_MAX = 0b0111   # codes 0..7: (code+1) independent channels
CH_LEFT_SIDE = 0b1000         # 2ch, stored L / S (= L - R)
CH_SIDE_RIGHT = 0b1001        # 2ch, stored S (= L - R) / R
CH_MID_SIDE = 0b1010          # 2ch, stored M / S
#: codes 0b1011..0b1111 reserved -> channel count 0 (zflac.zig:120)


def channel_count(code: int) -> int:
    """Channel count for a channel-layout code; 0 for reserved codes
    (zflac.zig:107-122)."""
    if code <= CH_INDEPENDENT_MAX:
        return code + 1
    if code in (CH_LEFT_SIDE, CH_SIDE_RIGHT, CH_MID_SIDE):
        return 2
    return 0


def is_stereo_decorrelated(code: int) -> bool:
    return code in (CH_LEFT_SIDE, CH_SIDE_RIGHT, CH_MID_SIDE)


def side_channel(code: int) -> int:
    """Index of the side channel (which carries +1 bit of depth,
    zflac.zig:435-441), or -1 for non-decorrelated layouts."""
    if code == CH_LEFT_SIDE:
        return 1
    if code == CH_SIDE_RIGHT:
        return 0
    if code == CH_MID_SIDE:
        return 1
    return -1


# Bit-depth codes (u3) (zflac.zig:125-146). None = streaminfo / reserved.
BIT_DEPTH_TABLE = {
    0b000: None,    # stored in STREAMINFO
    0b001: 8,
    0b010: 12,
    0b011: None,    # reserved
    0b100: 16,
    0b101: 20,
    0b110: 24,
    0b111: 32,
}
BIT_DEPTH_CODE = {8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101,
                  24: 0b110, 32: 0b111}
BD_RESERVED = 0b011

# Block-size codes (u4) (zflac.zig:148-163).
BS_RESERVED = 0b0000
BS_192 = 0b0001
BS_UNCOMMON_U8 = 0b0110
BS_UNCOMMON_U16 = 0b0111


def block_size_value(code: int) -> int | None:
    """Fixed block size for a block-size code, or None if uncommon/reserved
    (zflac.zig:155-162): 192 for code 1; 144*2^c for 2..5; 2^c for 8..15."""
    if code == BS_192:
        return 192
    if 0b0010 <= code <= 0b0101:
        return 144 * (2 ** code)
    if 0b1000 <= code <= 0b1111:
        return 2 ** code
    return None


BLOCK_SIZE_CODE = {}
for _c in range(16):
    _v = block_size_value(_c)
    if _v is not None:
        BLOCK_SIZE_CODE[_v] = _c

# ---------------------------------------------------------------------------
# Subframe types (zflac.zig:175-185, 444-543)
# ---------------------------------------------------------------------------

SF_CONSTANT = 0   # type bits 0b000000
SF_VERBATIM = 1   # type bits 0b000001
SF_FIXED = 2      # type bits 0b001000..0b001100, order = bits - 8
SF_LPC = 3        # type bits 0b100000..0b111111, order = bits - 31


def classify_subframe(type_bits: int) -> tuple[int, int] | None:
    """Map the 6-bit subframe type field to (kind, order) or None if
    reserved (zflac.zig:177-182,542)."""
    if type_bits == 0b000000:
        return (SF_CONSTANT, 0)
    if type_bits == 0b000001:
        return (SF_VERBATIM, 0)
    if 0b001000 <= type_bits <= 0b001100:
        return (SF_FIXED, type_bits - 8)
    if type_bits >= 0b100000:
        return (SF_LPC, type_bits - 31)
    return None


def subframe_type_bits(kind: int, order: int) -> int:
    """Inverse of classify_subframe, for the encoder."""
    if kind == SF_CONSTANT:
        return 0b000000
    if kind == SF_VERBATIM:
        return 0b000001
    if kind == SF_FIXED:
        assert 0 <= order <= 4
        return 8 + order
    if kind == SF_LPC:
        assert 1 <= order <= 32
        return 31 + order
    raise ValueError(kind)


#: Fixed-predictor coefficients by order (zflac.zig:481-490). Prediction for
#: order k is sum(FIXED_COEFFS[k][j] * s[i-1-j]).
FIXED_COEFFS = {
    0: (),
    1: (1,),
    2: (2, -1),
    3: (3, -3, 1),
    4: (4, -6, 4, -1),
}

MAX_LPC_ORDER = 32
MAX_FIXED_ORDER = 4

# Residual coding (zflac.zig:614-666)
RICE_PARAM_BITS = {0: 4, 1: 5}     # coding method -> rice parameter width
RICE_ESCAPE = {0: 0b1111, 1: 0b11111}

# ---------------------------------------------------------------------------
# Sample-width machinery (zflac.zig:256-264, 287-306, 314-319)
# ---------------------------------------------------------------------------


def container_bits(bps: int) -> int:
    """Output container width: bps rounded up to 8, with 24 stored in 32
    (zflac.zig:256-264). Returns 8, 16, or 32."""
    aligned = (bps + 7) & ~7
    if aligned == 24:
        return 32
    return aligned


def md5_bytes_per_sample(bps: int) -> int:
    """MD5 hashes the smallest whole number of little-endian bytes per
    sample (zflac.zig:267-277): ceil(bps/8)."""
    return (bps + 7) // 8


def normalization_shift(bps: int) -> int:
    """Post-MD5 left shift applied to each sample so that 9-15-bit audio
    fills 16 bits and 17-31-bit audio fills 32 (zflac.zig:287-306)."""
    if 9 <= bps <= 15:
        return 16 - bps
    if 17 <= bps <= 31:
        return 32 - bps
    return 0


# ---------------------------------------------------------------------------
# STREAMINFO
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StreamInfo:
    """Parsed STREAMINFO block (zflac.zig:45-55,228-242).

    channel_count and bits_per_sample are the *actual* values (the raw
    fields store count-1 / bps-1)."""

    min_block_size: int
    max_block_size: int
    min_frame_size: int
    max_frame_size: int
    sample_rate: int
    channel_count: int
    bits_per_sample: int
    total_samples: int     # per channel; 0 = unknown
    md5: bytes


def coded_number_bytes(value: int) -> bytes:
    """Encode a frame/sample number in FLAC's extended-UTF-8 style
    (inverse of zflac.zig:203-214); used by the encoder."""
    if value < 0x80:
        return bytes([value])
    # n continuation bytes carry 6 bits each; the lead byte carries
    # (7 - (n+1)) bits under a prefix of n+1 ones and a zero.
    for nbytes in range(2, 8):
        payload_bits = 6 * (nbytes - 1) + (7 - nbytes if nbytes < 7 else 0)
        if value < (1 << payload_bits):
            break
    else:
        raise ValueError("coded number too large")
    out = bytearray(nbytes)
    for i in range(nbytes - 1, 0, -1):
        out[i] = 0x80 | (value & 0x3F)
        value >>= 6
    lead_prefix = ((1 << nbytes) - 1) << (8 - nbytes)
    out[0] = lead_prefix | value
    return bytes(out)
