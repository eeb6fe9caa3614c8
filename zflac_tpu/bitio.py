"""MSB-first bit I/O over byte buffers.

BitReader matches the semantics of the reference's generic bit reader
(/root/reference/src/bit_reader.zig): big-endian bit order, `read_bits`
== readBitsNoEof (bit_reader.zig:25-70), `read_unary` == readUnary
(bit_reader.zig:95-120, counts zero bits up to and excluding the first
one bit), `align_to_byte` == alignToByte (bit_reader.zig:90-93).

Unlike the reference (streaming, 8-bit internal buffer) this reader
addresses an in-memory buffer by absolute bit position, which is what the
two-phase design needs: every structure's *bit offset* is a first-class
value that the indexer records into the frame table.

BitWriter is the encoder-side mirror (no reference equivalent; zflac is
decode-only).
"""

from __future__ import annotations

from .errors import EndOfStream


class BitReader:
    """Bit cursor over a bytes-like buffer. `pos` is the absolute bit
    position from the start of the buffer."""

    __slots__ = ("buf", "pos", "nbits")

    def __init__(self, buf: bytes, pos_bits: int = 0):
        self.buf = buf
        self.pos = pos_bits
        self.nbits = 8 * len(buf)

    # -- byte-aligned helpers (the reference reads these through the raw
    # -- byte reader, zflac.zig:218,224,245) ------------------------------

    def byte_pos(self) -> int:
        assert self.pos % 8 == 0
        return self.pos // 8

    def read_bytes(self, n: int) -> bytes:
        assert self.pos % 8 == 0
        start = self.pos // 8
        if start + n > len(self.buf):
            raise EndOfStream()
        self.pos += 8 * n
        return self.buf[start:start + n]

    def read_u8(self) -> int:
        return self.read_bytes(1)[0]

    def read_u16(self) -> int:
        b = self.read_bytes(2)
        return (b[0] << 8) | b[1]

    def read_u24(self) -> int:
        b = self.read_bytes(3)
        return (b[0] << 16) | (b[1] << 8) | b[2]

    def read_u32(self) -> int:
        b = self.read_bytes(4)
        return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]

    def skip_bytes(self, n: int) -> None:
        assert self.pos % 8 == 0
        if self.pos // 8 + n > len(self.buf):
            raise EndOfStream()
        self.pos += 8 * n

    # -- bit-granular reads ----------------------------------------------

    def read_bits(self, n: int) -> int:
        """Read n bits MSB-first as an unsigned int
        (bit_reader.zig:25-70)."""
        pos = self.pos
        end = pos + n
        if end > self.nbits:
            raise EndOfStream()
        self.pos = end
        first = pos >> 3
        last = (end + 7) >> 3
        word = int.from_bytes(self.buf[first:last], "big")
        return (word >> ((last << 3) - end)) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        """Read n bits and sign-extend (zflac.zig:188-196)."""
        v = self.read_bits(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count zero bits up to (and consuming) the first one bit
        (bit_reader.zig:95-120)."""
        buf, pos, nbits = self.buf, self.pos, self.nbits
        count = 0
        # Finish the current partial byte.
        bit_in_byte = pos & 7
        if bit_in_byte:
            byte = buf[pos >> 3] & (0xFF >> bit_in_byte)
            if byte:
                zeros = 8 - bit_in_byte - byte.bit_length()
                self.pos = pos + zeros + 1
                return zeros
            count = 8 - bit_in_byte
            pos += count
        # Whole bytes.
        i = pos >> 3
        n = len(buf)
        while i < n and buf[i] == 0:
            count += 8
            i += 1
        if i >= n:
            raise EndOfStream()
        byte = buf[i]
        zeros = 8 - byte.bit_length()
        total = count + zeros
        self.pos = (i << 3) + zeros + 1
        if self.pos > nbits:
            raise EndOfStream()
        return total

    def align_to_byte(self) -> None:
        """Discard bits up to the next byte boundary
        (bit_reader.zig:90-93)."""
        self.pos = (self.pos + 7) & ~7

    def at_eof(self) -> bool:
        return self.pos >= self.nbits


class BitWriter:
    """MSB-first bit writer (encoder side)."""

    __slots__ = ("_bytes", "_bitbuf", "_bitcount")

    def __init__(self):
        self._bytes = bytearray()
        self._bitbuf = 0
        self._bitcount = 0

    def write_bits(self, value: int, n: int) -> None:
        assert 0 <= value < (1 << n), (value, n)
        self._bitbuf = (self._bitbuf << n) | value
        self._bitcount += n
        while self._bitcount >= 8:
            self._bitcount -= 8
            self._bytes.append((self._bitbuf >> self._bitcount) & 0xFF)
        self._bitbuf &= (1 << self._bitcount) - 1

    def write_signed(self, value: int, n: int) -> None:
        self.write_bits(value & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write_bits(0, 32)
            q -= 32
        self.write_bits(1, q + 1)

    def write_bytes(self, data: bytes) -> None:
        assert self._bitcount == 0
        self._bytes.extend(data)

    def align_to_byte(self) -> None:
        if self._bitcount:
            self.write_bits(0, 8 - self._bitcount)

    def bit_length(self) -> int:
        return 8 * len(self._bytes) + self._bitcount

    def getvalue(self) -> bytes:
        assert self._bitcount == 0, "unaligned"
        return bytes(self._bytes)
