"""Incremental Annex-B buffering (fragmented NAL input).

A NAL unit is only provably complete once the NEXT start code appears
(or the stream ends); `split_complete` cuts an input buffer at the last
start-code prefix so everything before it can be decoded now and the
(possibly partial) tail waits for more bytes. This is the analog of the reference's per-call bitstream buffering in
CWelsDecoder::DecodeFrame2 (welsDecoderExt.cpp:918) + ExpandBsBuffer
(decoder_core.cpp:648).

Copied from openh264_tpu/decoder/nalbuf.py.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.nal import find_start_codes


def split_complete(buf: bytes) -> tuple[bytes, bytes]:
    """Return (complete, tail): `complete` holds whole NAL units
    (every one terminated by the start code that begins `tail`);
    `tail` starts at the final start-code prefix, or holds leading
    garbage/partial prefixes when no second start code exists yet."""
    if len(buf) < 4:
        return b"", buf
    arr = np.frombuffer(buf, dtype=np.uint8)
    scs = find_start_codes(arr)
    if len(scs) < 2:
        return b"", buf
    last_start, last_len = scs[-1]
    cut = last_start - last_len
    return buf[:cut], buf[cut:]
