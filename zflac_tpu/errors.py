"""Typed error set for the FLAC engine.

Mirrors the reference decoder's error API one-for-one (zflac's Zig error
union values, see /root/reference/src/zflac.zig):

  error.InvalidSignature             zflac.zig:220
  error.InvalidMetadataHeader        zflac.zig:248
  error.MissingStreaminfo            zflac.zig:309
  error.InvalidFrameHeader           zflac.zig:352,357,361,372,405
  error.InconsistentParameters       zflac.zig:386,391
  error.InvalidSubframeHeader        zflac.zig:431,471,542
  error.InvalidResidualCodingMethod  zflac.zig:618
  error.InvalidCodedNumber           zflac.zig:206
  error.InvalidChecksum              zflac.zig:280
  error.EndOfStream                  (Zig reader EOF mid-structure)
  error.Unimplemented                zflac.zig:263

Each is a distinct exception class so callers (and the faulty-stream test
suite, cf. /root/reference/tests/std_faulty.zig:17-61) can match on exact
error identity.
"""

__all__ = [
    "FlacError",
    "InvalidSignature",
    "InvalidMetadataHeader",
    "MissingStreaminfo",
    "InvalidFrameHeader",
    "InconsistentParameters",
    "InvalidSubframeHeader",
    "InvalidResidualCodingMethod",
    "InvalidCodedNumber",
    "InvalidChecksum",
    "EndOfStream",
    "Unimplemented",
]


class FlacError(Exception):
    """Base class for all FLAC decode errors."""


class InvalidSignature(FlacError):
    """Stream does not begin with the 'fLaC' magic (0x664C6143)."""


class InvalidMetadataHeader(FlacError):
    """Metadata block type is invalid/reserved."""


class MissingStreaminfo(FlacError):
    """No STREAMINFO metadata block before the first audio frame."""


class InvalidFrameHeader(FlacError):
    """Bad frame sync code, reserved/forbidden field value, or illegal
    block size (0xFFFF uncommon-16-bit, reserved code, or a block size of
    1 in a non-final frame)."""


class InconsistentParameters(FlacError):
    """Sample rate / channel layout / bit depth changed mid-stream, or the
    first frame disagrees with STREAMINFO's channel count."""


class InvalidSubframeHeader(FlacError):
    """Subframe header non-zero pad bit or reserved subframe type."""


class InvalidResidualCodingMethod(FlacError):
    """Residual coding method field >= 0b10 (reserved)."""


class InvalidCodedNumber(FlacError):
    """Malformed UTF-8-style coded frame/sample number."""


class InvalidChecksum(FlacError):
    """Decoded PCM does not match the STREAMINFO MD5 (or, beyond the
    reference: an enforced frame CRC mismatch when crc checking is on)."""


class EndOfStream(FlacError):
    """Unexpected end of stream inside a structure (only legal on a frame
    boundary when the total sample count is unknown, zflac.zig:343-350)."""


class Unimplemented(FlacError):
    """Stream configuration outside the supported envelope."""
