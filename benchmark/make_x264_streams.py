#!/usr/bin/env python3
"""Makes the streams that x264 writes, once: the hls_1080p30_high decode
cell's stream and the small streams of the CPU tests.

    python3 benchmark/make_x264_streams.py [--only <stream>]

Builds x264_tool.c (beside this file) with gcc against libavcodec and
libavutil into a temporary directory, then, for each stream of STREAMS,
encodes benchmark/content.py frames with libx264 at preset medium,
profile High, one thread (so the bytes are deterministic), GOPs closed
and of a fixed length, the average rate, the VBV's maxrate and bufsize
and the level given, every other setting at medium's default. Each
stream goes to its .264 file with a manifest beside it: the fields of
make_streams.py's manifests; the tool's versions (libavcodec's, and
x264's own from the SEI it writes); the count of I, P and B pictures and
of reference B pictures; num_ref_frames, transform_8x8_mode,
weighted_pred, weighted_bipred_idc and the crop; and the MD5 of each
picture as libavcodec's own decoder outputs it, in output order, a
witness beside the plain reference.

Only this maker needs libavcodec; the benchmark's runs and the tests
read the committed bytes, which streams.load checks by their SHA-256.
The headers are parsed with the plain reference's parsers.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark import content, streams  # noqa: E402

SEED = 2024
X264_PARAMS = "keyint={k}:min-keyint={k}:scenecut=0:open-gop=0:threads=1"

TESTS = HERE.parent / "tests" / "data"

# name: (output path, config or None, frames, width, height, fps, keyint,
#        bit rate, maxrate, bufsize in bit/s and bits, level_idc, further
#        x264 settings). At 320x192 medium's adaptive B decision places
# one B picture between P pictures on this content; the "pyramid" test
# stream asks for 3 always (b-adapt=0), so that B-pyramid writes
# reference B pictures.
STREAMS = {
    "hls_1080p30_high": (streams.STREAM_DIR / "hls_1080p30_high.264",
                         "hls_1080p30_high", 180, 1920, 1080, 30, 60,
                         6_000_000, 6_600_000, 12_000_000, 40, ""),
    "x264_high_320x192": (TESTS / "x264_high_320x192.264", None, 24, 320,
                          192, 30, 12, 600_000, 660_000, 1_200_000, 40, ""),
    "x264_high_320x192_pyramid": (TESTS / "x264_high_320x192_pyramid.264",
                                  None, 24, 320, 192, 30, 12, 600_000,
                                  660_000, 1_200_000, 40, ":b-adapt=0"),
}


def build_tool(folder: Path) -> Path:
    exe = folder / "x264_tool"
    subprocess.run(["gcc", "-O2", str(HERE / "x264_tool.c"), "-o", str(exe),
                    "-lavcodec", "-lavutil"], check=True)
    return exe


def encode(exe: Path, frames, w, h, fps, rate, maxrate, bufsize, level,
           params: str) -> bytes:
    raw = b"".join(p.tobytes() for f in frames for p in f)
    return subprocess.run(
        [str(exe), "enc", str(w), str(h), str(fps), str(rate), str(maxrate),
         str(bufsize), str(level), params],
        input=raw, capture_output=True, check=True).stdout


def libavcodec_md5(exe: Path, data: bytes, w: int, h: int) -> list[str]:
    """The MD5 of each picture (y, u, v, cropped) that libavcodec's
    decoder outputs, in output order."""
    out = subprocess.run([str(exe), "dec"], input=data, capture_output=True,
                         check=True).stdout
    n = w * h * 3 // 2
    if len(out) % n:
        raise ValueError("libavcodec returned a partial picture")
    return [hashlib.md5(out[i:i + n]).hexdigest()
            for i in range(0, len(out), n)]


def describe(data: bytes, fps: float) -> dict:
    """The manifest entry of a stream, from its headers."""
    from benchmark.reference.bits import BitReader
    from benchmark.reference.nal import split_annexb
    from benchmark.reference.params import parse_pps, parse_sps
    from benchmark.reference.slicehdr import parse_slice_header
    sps_map, pps_map, qps = {}, {}, []
    kinds = {"I": 0, "P": 0, "B": 0}
    b_ref = 0
    sps_bytes = tool = None
    for nal in split_annexb(data):
        t = nal.nal_unit_type
        if t == 7:
            sps = parse_sps(nal.rbsp)
            sps_map[sps.sps_id] = sps
            sps_bytes = bytes(nal.rbsp[:3])
        elif t == 8:
            pps = parse_pps(nal.rbsp, sps_map)
            pps_map[pps.pps_id] = pps
        elif t == 6 and tool is None:
            m = re.search(rb"x264 - core \d+ r\d+ [0-9a-f]+", nal.rbsp)
            tool = m and m.group(0).decode()
        elif t in streams.SLICE_NAL_TYPES:
            sh = parse_slice_header(BitReader(nal.rbsp), nal, sps_map,
                                    pps_map)
            qps.append(sh.qp)
            kinds["PBI"[sh.slice_type]] += 1
            b_ref += sh.slice_type == 1 and nal.nal_ref_idc > 0
    g = streams.gops(streams.access_units(data))
    n = sum(map(len, g))
    return {
        "sha256": streams.sha256(data), "bytes": len(data), "frames": n,
        "gops": len(g), "bytes_per_gop": [sum(map(len, x)) for x in g],
        "frames_per_gop": [len(x) for x in g],
        "bitrate_bps": round(8 * len(data) * fps / n),
        "mean_qp": round(sum(qps) / len(qps), 3),
        "sps_profile_idc": sps_bytes[0],
        "sps_constraint_flags": f"0x{sps_bytes[1]:02x}",
        "sps_level_idc": sps_bytes[2],
        "x264": tool,
        "pictures": kinds, "b_ref_pictures": int(b_ref),
        "num_ref_frames": sps.max_num_ref_frames,
        "transform_8x8_mode": int(pps.transform_8x8_mode),
        "weighted_pred": int(pps.weighted_pred),
        "weighted_bipred_idc": pps.weighted_bipred_idc,
        "crop": {"left": sps.crop_left, "right": sps.crop_right,
                 "top": sps.crop_top, "bottom": sps.crop_bottom,
                 "width": sps.width, "height": sps.height},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        exe = build_tool(Path(tmp))
        version = subprocess.run([str(exe), "version"], capture_output=True,
                                 text=True, check=True).stdout.strip()
        for name, (path, cfg, n, w, h, fps, keyint, rate, maxrate, bufsize,
                   level, more) in STREAMS.items():
            if args.only and args.only != name:
                continue
            params = X264_PARAMS.format(k=keyint) + more
            frames = content.frames(n, SEED, w, h)
            data = encode(exe, frames, w, h, fps, rate, maxrate, bufsize,
                          level, params)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(data)
            entry = {**describe(data, fps),
                     "content": f"benchmark/content.py frames({n}, "
                                f"seed={SEED}, width={w}, height={h})",
                     "tool": f"{version}; {params}; "
                             f"preset medium, profile high, level {level}, "
                             f"{rate} bit/s, maxrate {maxrate}, bufsize "
                             f"{bufsize}",
                     "libavcodec_md5": libavcodec_md5(exe, data, w, h)}
            if cfg:
                entry["config"] = cfg
            path.with_suffix(".json").write_text(
                json.dumps(entry, indent=1, sort_keys=True) + "\n")
            print(name, json.dumps({k: v for k, v in entry.items()
                                    if k != "libavcodec_md5"}), flush=True)


if __name__ == "__main__":
    main()
