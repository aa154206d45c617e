"""MSB-first bit writer with exp-Golomb codes (H.264 §9.1).

Copied from openh264_tpu/bitstream/bits.py, writer side only: the port
writes parameter sets and slice headers on the host and parses nothing.
"""

from __future__ import annotations

import numpy as np


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

    def get_bytes(self) -> bytes:
        """Return the RBSP bytes; requires byte alignment."""
        if not self.byte_aligned():
            raise ValueError("bitstream not byte aligned; call rbsp_trailing_bits()")
        tail = b""
        if self._accbits:
            tail = self._acc.to_bytes(self._accbits // 8, "big")
        return b"".join(self._chunks) + tail
