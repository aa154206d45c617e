"""The decode cells' committed streams: Annex-B access units and GOPs.

Each configuration that names a "stream" has `streams/<stream>.264`,
made once by make_streams.py, and its manifest `streams/<stream>.json`
(one file per stream, so that a new stream adds files and edits none).
`load` refuses a file whose SHA-256 differs from the manifest's, so an
encoder change can never change a decode cell's input.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
STREAM_DIR = HERE / "streams"
SLICE_NAL_TYPES = (1, 5)
IDR_NAL_TYPE = 5


def nal_units(data: bytes) -> list[tuple[int, bytes]]:
    """(nal_unit_type, bytes with its start code) of each NAL unit of an
    Annex-B stream, in order."""
    starts = []
    i, n = 0, len(data)
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        # a 4-byte start code begins one zero earlier
        starts.append(j - 1 if j > 0 and data[j - 1] == 0 else j)
        i = j + 3
    out = []
    for k, s in enumerate(starts):
        e = starts[k + 1] if k + 1 < len(starts) else n
        hdr = data.index(b"\x00\x00\x01", s) + 3
        out.append((data[hdr] & 0x1F, data[s:e]))
    return out


def access_units(data: bytes) -> list[bytes]:
    """The stream's access units, for streams of one slice per picture:
    each ends with its slice NAL unit, after any parameter sets."""
    aus, cur = [], b""
    for typ, nal in nal_units(data):
        cur += nal
        if typ in SLICE_NAL_TYPES:
            aus.append(cur)
            cur = b""
    if cur:
        raise ValueError("stream ends in NAL units of no picture")
    return aus


def is_idr(au: bytes) -> bool:
    return any(t == IDR_NAL_TYPE for t, _ in nal_units(au))


def gops(aus: list[bytes]) -> list[list[bytes]]:
    """Access units grouped into closed GOPs, each from its IDR."""
    out: list[list[bytes]] = []
    for au in aus:
        if is_idr(au):
            out.append([])
        if not out:
            raise ValueError("stream does not start with an IDR")
        out[-1].append(au)
    return out


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def load(name: str) -> tuple[list[list[bytes]], dict]:
    """The GOPs of streams/<name>.264 and its manifest entry. Raises if
    the file's SHA-256 is not the manifest's."""
    entry = json.loads((STREAM_DIR / f"{name}.json").read_text())
    data = (STREAM_DIR / f"{name}.264").read_bytes()
    got = sha256(data)
    if got != entry["sha256"]:
        raise ValueError(f"stream {name}: sha256 {got} is not the "
                         f"manifest's {entry['sha256']}")
    g = gops(access_units(data))
    if len(g) != entry["gops"] or sum(map(len, g)) != entry["frames"]:
        raise ValueError(f"stream {name}: {len(g)} GOPs of "
                         f"{sum(map(len, g))} pictures, not the manifest's")
    return g, entry
