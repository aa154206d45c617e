#!/usr/bin/env python3
"""Makes the decode cells' committed streams, once.

    python3 benchmark/make_streams.py [--only <stream>] [--device cpu]

For each configuration under configs/ that names a "stream", encodes
content.frames(96, seed=2024) (three closed GOPs of 32 pictures) with
the port's encoder at the configuration's settings: CAVLC through
DeviceSessionEncoder, CABAC through H264Encoder (the port's only CABAC
writer). Writes streams/<stream>.264 and its manifest
streams/<stream>.json: sha256, pictures, GOPs, bytes per GOP, the
achieved bit rate, the mean slice QP, and the profile, constraint
flags and level that the SPS carries. The port's CPU and CUDA bytes
are equal, so the CPU serves. The benchmark's runs only read the
streams; they never remake them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark import content, streams  # noqa: E402

FRAMES, SEED = 96, 2024


def encode(cfg_json: dict, frames, device: str) -> bytes:
    from openh264_tpu_torch.encoder.config import EncoderConfig
    cfg = EncoderConfig(width=cfg_json["width"], height=cfg_json["height"],
                        **cfg_json["encoder"])
    if cfg.entropy_cabac:
        from openh264_tpu_torch.encoder.encoder import H264Encoder
        enc = H264Encoder(cfg, device=device)
        return b"".join(enc.encode_frame(*f) for f in frames)
    from openh264_tpu_torch.encoder.session_device import \
        DeviceSessionEncoder
    enc = DeviceSessionEncoder(cfg, device=device)
    return b"".join(enc.encode_stream(frames))


def describe(data: bytes, fps: float) -> dict:
    """The manifest entry of a stream."""
    from openh264_tpu_torch.bitstream import BitReader, split_annexb
    from openh264_tpu_torch.decoder.params import parse_pps, parse_sps
    from openh264_tpu_torch.decoder.slicehdr import parse_slice_header
    sps_map, pps_map, qps = {}, {}, []
    sps_bytes = None
    for nal in split_annexb(data):
        if nal.nal_unit_type == 7:
            sps = parse_sps(nal.rbsp)
            sps_map[sps.sps_id] = sps
            sps_bytes = bytes(nal.rbsp[:3])
        elif nal.nal_unit_type == 8:
            pps = parse_pps(nal.rbsp, sps_map)
            pps_map[pps.pps_id] = pps
        elif nal.nal_unit_type in streams.SLICE_NAL_TYPES:
            sh = parse_slice_header(BitReader(nal.rbsp), nal, sps_map,
                                    pps_map, {})
            qps.append(sh.qp)
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
        "content": f"benchmark/content.py frames({FRAMES}, seed={SEED})",
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    for path in sorted((HERE / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        name = cfg.get("stream")
        if not name or (args.only and args.only != name):
            continue
        frames = content.frames(FRAMES, SEED, cfg["width"], cfg["height"])
        data = encode(cfg, frames, args.device)
        (streams.STREAM_DIR / f"{name}.264").write_bytes(data)
        entry = {**describe(data, cfg["fps"]), "config": cfg["name"]}
        (streams.STREAM_DIR / f"{name}.json").write_text(
            json.dumps(entry, indent=1, sort_keys=True) + "\n")
        print(name, json.dumps(entry), flush=True)


if __name__ == "__main__":
    main()
