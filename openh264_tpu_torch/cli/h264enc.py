"""YUV420 → Annex-B encoder console app.

Port of openh264_tpu/cli/h264enc.py, byte-identical with it: the same
options, the same key-value .cfg files and the same SEncParamExt, so the
same input gives the same stream. Mirrors the reference `h264enc`
(codec/console/enc/src/welsenc.cpp:1123 main, :221 ParseConfig): reads
the reference's key-value .cfg format (welsenc.cfg + per-layer LayerCfg
files, parsed like codec/console/common/src/read_config.cpp) with CLI
overrides, encodes with the port's API on `device` (the card unless the
caller of `main` asks for the CPU), writes the Annex-B stream and prints
FPS like the reference console.

As in the JAX CLI, -denois, -scene, -aq and -bgd are accepted and never
read, and -qp sets iInitialQp, which the API ignores because the
parameters always carry a spatial layer whose iDLayerQp (26) wins
(ROADMAP.md, queue C).

Usage:
  python -m openh264_tpu_torch.cli.h264enc welsenc.cfg [options]
  python -m openh264_tpu_torch.cli.h264enc -org in.yuv -sw W -sh H -bf out.264
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..api import CAMERA_VIDEO_REAL_TIME, SEncParamExt, WelsCreateSVCEncoder
from ..api.params import SSpatialLayerConfig

# CLI overrides (subset of welsenc.cpp:221-680 option table)
OPTIONS = {"-org": "InputFile", "-bf": "OutputFile", "-sw": "SourceWidth",
           "-sh": "SourceHeight", "-frms": "FramesToBeEncoded",
           "-frin": "MaxFrameRate", "-numtl": "TemporalLayerNum",
           "-iper": "IntraPeriod", "-rc": "RCMode",
           "-tarb": "TargetBitrate", "-fs": "EnableFrameSkip",
           "-qp": "InitialQP", "-slcmd": "SliceMode", "-slcnum": "SliceNum",
           "-cabac": "EntropyCodingModeFlag", "-denois": "EnableDenoise",
           "-scene": "EnableSceneChangeDetection",
           "-aq": "EnableAdaptiveQuant", "-bgd": "EnableBackgroundDetection",
           "-ltr": "EnableLongTermReference",
           "-deblockIdc": "LoopFilterDisableIDC",
           "-maxqp": "MaxQp", "-minqp": "MinQp"}


def read_config(path: str) -> dict[str, list[str]]:
    """Key-value cfg parser (read_config.cpp semantics: first token is
    the key, second the value; '#'/'//' comments; repeated keys append)."""
    cfg: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("//"):
                continue
            parts = line.split()
            if len(parts) >= 2:
                cfg.setdefault(parts[0], []).append(parts[1])
    return cfg


def _first(cfg, key, default=None, cast=str):
    v = cfg.get(key)
    return cast(v[0]) if v else default


def settings(argv) -> tuple[dict[str, list[str]], str]:
    """(settings, directory of the cfg file) from the arguments: an
    optional cfg file first, then option/value pairs, then the LayerCfg
    files' keys where the rest did not set them. Raises ValueError on an
    unknown or incomplete option."""
    argv = list(argv)
    cfg: dict[str, list[str]] = {}
    cfg_dir = "."
    if argv and not argv[0].startswith("-"):
        cfg_path = argv.pop(0)
        cfg = read_config(cfg_path)
        cfg_dir = os.path.dirname(os.path.abspath(cfg_path))
    i = 0
    while i < len(argv):
        key = OPTIONS.get(argv[i])
        if key is None or i + 1 >= len(argv):
            raise ValueError(f"unknown/incomplete option {argv[i]}")
        cfg[key] = [argv[i + 1]]
        i += 2
    # per-layer cfg (layerN.cfg) — last layer wins for single-layer encode
    for layer_path in cfg.get("LayerCfg", []):
        p = layer_path if os.path.isabs(layer_path) else \
            os.path.join(cfg_dir, layer_path)
        if os.path.exists(p):
            for k, v in read_config(p).items():
                cfg.setdefault(k, v)
    return cfg, cfg_dir


def encoder_param(cfg: dict[str, list[str]]) -> SEncParamExt:
    """The SEncParamExt that the console builds from its settings."""
    width = _first(cfg, "SourceWidth", 0, int)
    height = _first(cfg, "SourceHeight", 0, int)
    param = SEncParamExt(
        iUsageType=_first(cfg, "UsageType", CAMERA_VIDEO_REAL_TIME, int),
        iPicWidth=width, iPicHeight=height,
        fMaxFrameRate=_first(cfg, "MaxFrameRate", 30.0, float),
        iTargetBitrate=_first(cfg, "TargetBitrate", 5000, int) * 1000,
        iRCMode=_first(cfg, "RCMode", 0, int),
        iTemporalLayerNum=_first(cfg, "TemporalLayerNum", 1, int),
        uiIntraPeriod=max(0, _first(cfg, "IntraPeriod", 0, int)),
        iEntropyCodingModeFlag=_first(cfg, "EntropyCodingModeFlag", 0, int),
        bEnableFrameSkip=bool(_first(cfg, "EnableFrameSkip", 1, int)),
        iLoopFilterDisableIdc=_first(cfg, "LoopFilterDisableIDC", 0, int),
        iMaxQp=_first(cfg, "MaxQp", 51, int),
        iMinQp=_first(cfg, "MinQp", 0, int),
        iInitialQp=_first(cfg, "InitialQP", 26, int),
        iMultipleThreadIdc=_first(cfg, "MultipleThreadIdc", 1, int),
        bEnableLongTermReference=bool(
            _first(cfg, "EnableLongTermReference", 0, int)),
    )
    # slice mode / count (SliceMode 1 = SM_FIXEDSLCNUM_SLICE)
    slc_mode = _first(cfg, "SliceMode", 0, int)
    slc_num = _first(cfg, "SliceNum", 1, int)
    layer = SSpatialLayerConfig(iVideoWidth=width, iVideoHeight=height)
    layer.sSliceArgument.uiSliceMode = slc_mode
    layer.sSliceArgument.uiSliceNum = slc_num if slc_mode else 1
    param.sSpatialLayers = [layer]
    return param


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    try:
        cfg, cfg_dir = settings(argv)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1

    width = _first(cfg, "SourceWidth", 0, int)
    height = _first(cfg, "SourceHeight", 0, int)
    in_file = _first(cfg, "InputFile")
    out_file = _first(cfg, "OutputFile", "out.264")
    n_frames = _first(cfg, "FramesToBeEncoded", -1, int)
    if not in_file or not width or not height:
        print("need InputFile/-org, SourceWidth/-sw, SourceHeight/-sh",
              file=sys.stderr)
        return 1
    if not os.path.isabs(in_file) and not os.path.exists(in_file):
        cand = os.path.join(cfg_dir, in_file)
        if os.path.exists(cand):
            in_file = cand
    if n_frames < 0:
        n_frames = os.path.getsize(in_file) // (width * height * 3 // 2)

    enc = WelsCreateSVCEncoder(device=device)
    enc.InitializeExt(encoder_param(cfg))

    fsz = width * height * 3 // 2
    t_enc = 0.0
    n_done = 0
    with open(in_file, "rb") as f, open(out_file, "wb") as out:
        for _ in range(n_frames):
            raw = f.read(fsz)
            if len(raw) < fsz:
                break
            y = np.frombuffer(raw[:width * height], np.uint8).reshape(
                height, width)
            u = np.frombuffer(raw[width * height:width * height * 5 // 4],
                              np.uint8).reshape(height // 2, width // 2)
            v = np.frombuffer(raw[width * height * 5 // 4:],
                              np.uint8).reshape(height // 2, width // 2)
            t0 = time.perf_counter()
            bs = enc.EncodeFrame(y, u, v)
            t_enc += time.perf_counter() - t0
            out.write(bs)
            n_done += 1
    print(f"Width:\t\t{width}\nHeight:\t\t{height}")
    print(f"Frames:\t\t{n_done}")
    print(f"encode time:\t{t_enc:.6f} sec")
    if t_enc > 0:
        print(f"FPS:\t\t{n_done / t_enc:.6f} fps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
