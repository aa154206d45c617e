"""Bit-level I/O: MSB-first bit reader and writer with exp-Golomb
codes (H.264 §9.1).

Copied from openh264_tpu/bitstream/bits.py. The writer serves the
encoders' parameter sets and slice headers; the reader serves the
decoder's parameter sets and slice headers on the host (slice data is
parsed by the host C in csrc/parse_cavlc.c).
"""

from __future__ import annotations

import numpy as np


class BitReader:
    """MSB-first bit reader over a bytes-like RBSP buffer.

    The buffer must already have emulation-prevention bytes removed
    (see nal.unescape_rbsp).
    """

    __slots__ = ("data", "nbits", "pos", "_val")

    def __init__(self, data) -> None:
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = 0  # bit position
        # One big int holding the whole buffer; Python big-int shifts are
        # fast (C loops) and make reads branch-free.
        self._val = int.from_bytes(data, "big") if data else 0

    # -- raw bits -------------------------------------------------------
    def u(self, n: int) -> int:
        """Read n bits as an unsigned integer (u(n))."""
        if n == 0:
            return 0
        end = self.pos + n
        if end > self.nbits:
            raise EOFError(f"bitstream overrun: need {n} bits at {self.pos}/{self.nbits}")
        v = (self._val >> (self.nbits - end)) & ((1 << n) - 1)
        self.pos = end
        return v

    def peek(self, n: int) -> int:
        """Peek n bits without consuming; short reads are zero-padded."""
        end = self.pos + n
        if end <= self.nbits:
            return (self._val >> (self.nbits - end)) & ((1 << n) - 1)
        avail = self.nbits - self.pos
        if avail <= 0:
            return 0
        v = self._val & ((1 << avail) - 1)
        return v << (n - avail)

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.nbits:
            raise EOFError("bitstream overrun in skip")

    def flag(self) -> bool:
        return bool(self.u(1))

    # -- exp-Golomb -----------------------------------------------------
    def ue(self) -> int:
        """ue(v): unsigned exp-Golomb (H.264 §9.1)."""
        # Count leading zeros.
        lz = 0
        while True:
            chunk = self.peek(32)
            if chunk == 0:
                if self.pos + lz + 32 >= self.nbits + 64:
                    raise EOFError("ue(v) ran off end of bitstream")
                self.skip(32)
                lz += 32
                continue
            z = 32 - chunk.bit_length()
            lz += z
            self.skip(z)
            break
        self.skip(1)  # the terminating 1 bit
        if lz == 0:
            return 0
        return (1 << lz) - 1 + self.u(lz)

    def se(self) -> int:
        """se(v): signed exp-Golomb (H.264 §9.1.1)."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def te(self, x: int) -> int:
        """te(v): truncated exp-Golomb with range [0, x]."""
        if x == 1:
            return 1 - self.u(1)
        return self.ue()

    # -- trailing bits --------------------------------------------------
    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def more_rbsp_data(self) -> bool:
        """H.264 §7.2: true if there is data before rbsp_stop_one_bit."""
        if self.pos >= self.nbits:
            return False
        # Find last 1 bit in the stream (the rbsp_stop_one_bit).
        rem = self._val & ((1 << (self.nbits - self.pos)) - 1)
        if rem == 0:
            return False  # degenerate stream
        stop_pos = self.nbits - ((rem & -rem).bit_length() - 1) - 1
        return self.pos < stop_pos

    def rbsp_trailing_bits(self) -> None:
        assert self.u(1) == 1, "rbsp_stop_one_bit must be 1"
        while not self.byte_aligned():
            self.u(1)


class BitWriter:
    """MSB-first bit writer producing an RBSP byte buffer.

    Mirrors the write-side golomb semantics of the reference
    (codec/common/inc/golomb_common.h WRITE_UE/WRITE_SE); emulation
    prevention is applied afterwards by nal.escape_rbsp.
    """

    __slots__ = ("_chunks", "_acc", "_accbits")

    def __init__(self) -> None:
        self._chunks: list[bytes] = []
        self._acc = 0  # bit accumulator (left-aligned semantics via _accbits)
        self._accbits = 0

    def bit_length(self) -> int:
        """Bits written so far."""
        return 8 * sum(len(c) for c in self._chunks) + self._accbits

    def u(self, n: int, v: int) -> None:
        if n == 0:
            return
        if v < 0 or v >> n:
            raise ValueError(f"value {v} does not fit in {n} bits")
        self._acc = (self._acc << n) | v
        self._accbits += n
        # Flush whole bytes out of the accumulator periodically to keep
        # the big int small.
        if self._accbits >= 4096:
            nbytes = self._accbits // 8
            keep = self._accbits - nbytes * 8
            self._chunks.append((self._acc >> keep).to_bytes(nbytes, "big"))
            self._acc &= (1 << keep) - 1
            self._accbits = keep

    def flag(self, b) -> None:
        self.u(1, 1 if b else 0)

    def bit_array(self):
        """Current contents as a numpy 0/1 uint8 array (no padding)."""
        by = b"".join(self._chunks)
        bits = (np.unpackbits(np.frombuffer(by, np.uint8))
                if by else np.zeros(0, np.uint8))
        if self._accbits:
            rem = np.array([(self._acc >> (self._accbits - 1 - i)) & 1
                            for i in range(self._accbits)], np.uint8)
            bits = np.concatenate([bits, rem])
        return bits

    def byte_align(self, bit: int = 0) -> None:
        """Pad with `bit` to the next byte boundary (e.g. CABAC
        cabac_alignment_one_bit, §7.3.4)."""
        while self._accbits % 8:
            self.u(1, bit)

    def ue(self, v: int) -> None:
        if v < 0:
            raise ValueError("ue(v) requires v >= 0")
        code = v + 1
        n = code.bit_length()
        self.u(2 * n - 1, code)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    @property
    def nbits(self) -> int:
        return sum(len(c) for c in self._chunks) * 8 + self._accbits

    def byte_aligned(self) -> bool:
        return (self.nbits & 7) == 0

    def rbsp_trailing_bits(self) -> None:
        self.u(1, 1)
        while not self.byte_aligned():
            self.u(1, 0)

    def put_bytes(self, data: bytes) -> None:
        """Append whole bytes (writer must be byte-aligned)."""
        if self._accbits % 8:
            raise ValueError("put_bytes requires byte alignment")
        if self._accbits:
            self._chunks.append(self._acc.to_bytes(self._accbits // 8, "big"))
            self._acc = 0
            self._accbits = 0
        self._chunks.append(data)

    def get_bytes(self) -> bytes:
        """Return the RBSP bytes; requires byte alignment."""
        if not self.byte_aligned():
            raise ValueError("bitstream not byte aligned; call rbsp_trailing_bits()")
        tail = b""
        if self._accbits:
            tail = self._acc.to_bytes(self._accbits // 8, "big")
        return b"".join(self._chunks) + tail
