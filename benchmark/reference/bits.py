"""MSB-first bit reader with exp-Golomb codes (H.264 clause 9.1).

Each read takes the 64-bit window at the read position from the byte
buffer, so a read costs the same wherever it falls in a large slice.
The buffer must already be free of emulation-prevention bytes.
"""

from __future__ import annotations

_PAD = bytes(16)


class BitReader:
    __slots__ = ("data", "nbits", "pos", "_buf", "_stop")

    def __init__(self, data) -> None:
        data = bytes(data)
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = 0
        self._buf = data + _PAD
        self._stop = None

    def _window(self, pos: int) -> int:
        """The 64 bits from bit `pos` (zero past the end)."""
        b = pos >> 3
        w = int.from_bytes(self._buf[b:b + 9], "big")
        return (w >> (8 - (pos & 7))) & 0xFFFFFFFFFFFFFFFF

    def peek(self, n: int) -> int:
        """n <= 64 bits without consuming them; zero past the end."""
        if n == 0:
            return 0
        return self._window(self.pos) >> (64 - n)

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        end = self.pos + n
        if end > self.nbits:
            raise EOFError(f"bitstream overrun: need {n} bits at "
                           f"{self.pos}/{self.nbits}")
        v = self._window(self.pos) >> (64 - n)
        self.pos = end
        return v

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.nbits:
            raise EOFError("bitstream overrun in skip")

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        w = self._window(self.pos)
        if w == 0:
            raise EOFError("ue(v) with more than 63 leading zeros")
        lz = 64 - w.bit_length()
        if lz < 32:
            n = 2 * lz + 1
            end = self.pos + n
            if end > self.nbits:
                raise EOFError("ue(v) ran off end of bitstream")
            self.pos = end
            return (w >> (64 - n)) - 1
        self.skip(lz + 1)
        return (1 << lz) - 1 + self.u(lz)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def te(self, x: int) -> int:
        if x == 1:
            return 1 - self.u(1)
        return self.ue()

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def more_rbsp_data(self) -> bool:
        """True while data precedes the rbsp_stop_one_bit."""
        if self._stop is None:
            d = self.data.rstrip(b"\x00")
            self._stop = (8 * len(d) - 1 - ((d[-1] & -d[-1]).bit_length()
                                              - 1)) if d else -1
        return self.pos < self._stop
