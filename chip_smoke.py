#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (openh264_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the deblock kernel from csrc/deblock.cu with nvcc, and the
     host C of the host encoder from csrc/host_native.c with cc;
  3. each kernel against its plain PyTorch version on the card, exact
     equality, on many grids and in 50 repeats, and both timed with
     CUDA events;
  4. the main path: DeviceSessionEncoder(device="cuda").encode_stream on
     16 frames of synthetic 720p content in two configs, 2 timed runs
     each (frames/s), the kernels' launch counts over exactly each run,
     and a torch.profiler table of 3 more P frames per config;
  5. the same 720p frames encoded on "cuda" and on "cpu" must give the
     same Annex-B bytes;
  6. the host encoder path: CWelsH264SVCEncoder / H264Encoder(device=
     "cuda") on 720p content in four configs (the API with I4x4 in host
     C; 4 fixed slices in band mode; screen content with the scroll
     candidate, adaptive quant, GOM rate control and LTR recovery;
     size-limited slices), 2 timed runs of 8 frames each (frames/s), the
     deblock kernel's launches against the deblocked frames of each run,
     the CUDA stream against the CPU stream over 3 frames, and a
     torch.profiler device-busy share over 2 more P frames.
It prints a `kernels` JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
W720, H720 = 1280, 720
N_FRAMES = 16          # per main-path run: 1 IDR + 15 P
REPEATS = 2            # timed runs of each main-path config
HOST_FRAMES = 8        # per host-encoder run: 1 IDR + 7 P
HOST_REPEATS = 2       # timed runs of each host-encoder config
SCROLL_ROWS = 8        # screen content scrolls this many rows a frame
# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, used for 32-bit integer work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def frames_720p(n: int, seed: int):
    """Synthetic moving 720p content: a textured gradient panning 2 px a
    frame, a slowly drifting chroma wave, a static logo block and
    camera noise, all from a numpy seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H720, 0:W720].astype(np.float32)
    tex = np.random.default_rng(seed + 1).integers(0, 64, (H720, W720 + 64))
    cy, cx = np.mgrid[0:H720 // 2, 0:W720 // 2].astype(np.float32)
    out = []
    for i in range(n):
        y = (0.08 * xx + 0.06 * yy + 40 * np.sin((xx - 2 * i) / 37.0)
             * np.cos(yy / 23.0) + tex[:, 2 * i % 64:2 * i % 64 + W720] + 30)
        y = y + rng.integers(-2, 3, y.shape)
        y[600:680, 1040:1200] = 200                       # static logo
        u = 128 + 30 * np.sin((cx - i) / 19.0) + rng.integers(-1, 2, cx.shape)
        v = 128 + 25 * np.cos((cy + i) / 13.0)
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out


def frames_720p_scroll(n: int, seed: int, step: int = SCROLL_ROWS):
    """Screen content scrolling `step` luma rows a frame: the first two
    frames of frames_720p stacked into one tall page, read through a
    720-row window that moves down the page. Rows repeat exactly between
    frames, as on a screen."""
    base = frames_720p(2, seed)
    page = [np.concatenate([base[0][k], base[1][k]]) for k in range(3)]
    return [tuple(np.ascontiguousarray(p[(step >> s) * i:
                                         (step >> s) * i + (H720 >> s)])
                  for p, s in zip(page, (0, 1, 1))) for i in range(n)]


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int, warmup: int = 3, setup=lambda: ()):
    """Median and all run times (ms) of fn(*setup()) with CUDA events;
    setup() runs before the start event, outside the timed span."""
    import torch
    for _ in range(warmup):
        fn(*setup())
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        x = setup()
        a.record()
        fn(*x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def deblock_inputs(mbw, mbh, seed, dev, blocky=False):
    """Random planes, bS 0-4 and QP 18-41. blocky: flat MBs a few levels
    apart plus noise, so that most edges pass the filter's alpha/beta
    tests (uniform random pixels rarely do)."""
    import torch
    rng = np.random.default_rng(seed)

    def plane(size):
        if not blocky:
            return rng.integers(0, 256, (size * mbh, size * mbw), np.uint8)
        base = rng.integers(80, 120, (mbh, mbw)).repeat(size, 0).repeat(
            size, 1)
        return (base + rng.integers(-3, 4, base.shape)).astype(np.uint8)
    arrs = (plane(16), plane(8), plane(8),
            rng.integers(0, 5, (4 * mbh, 4 * mbw), np.int32),
            rng.integers(0, 5, (4 * mbh, 4 * mbw), np.int32),
            rng.integers(18, 42, mbw * mbh, np.int32),
            rng.integers(18, 42, mbw * mbh, np.int32))
    return [torch.from_numpy(a).to(dev) for a in arrs]


def deblock_bound_ms(mbw, mbh, BSV, BSH):
    """Least time for one frame's deblock on the card: the larger of the
    bytes it must move (planes, bS grids and QPs read once, planes
    written once) over HBM bandwidth, and the integer operations this
    bS data asks for over the scalar rate: ~60 ops for each luma line
    and ~25 for each chroma line across an edge with bS > 0."""
    plane = 16 * mbh * 16 * mbw * 3 // 2
    nbytes = 2 * plane + 2 * BSV.numel() * 4 + 2 * mbw * mbh * 4
    bsv, bsh = BSV.clone(), BSH.clone()
    bsv[:, 0] = 0                  # picture-border edges stay unfiltered
    bsh[0, :] = 0
    luma_lines = 4 * int((bsv > 0).sum() + (bsh > 0).sum())
    # chroma filters MB-internal edges 0 and 2 (even bS columns / rows),
    # 2 lines per bS entry in each of 2 planes
    chroma_lines = 4 * int((bsv[:, 0::2] > 0).sum() + (bsh[0::2] > 0).sum())
    ops = 60 * luma_lines + 25 * chroma_lines
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def idc2_inputs(dev):
    """The main path's deblock at 720p: 80x45 MBs, bS from random
    encoder symbols with the band tops of 4 slices zeroed (deblock idc
    2), blocky planes, QP 33 / chroma QP 31."""
    import torch
    from openh264_tpu_torch.encoder import deblock_torch
    rng = np.random.default_rng(4)
    mbw, mbh = 80, 45
    n = mbw * mbh
    nz = torch.from_numpy(rng.random((n, 16)) < 0.3).to(dev)
    intra = torch.from_numpy(rng.random(n) < 0.2).to(dev)
    mv = torch.from_numpy(rng.integers(-9, 10, (n, 2)).astype(np.int32)
                          ).to(dev)
    BSV, BSH = deblock_torch.encoder_bs(nz, intra, mv, mbw, mbh)
    for r in (12, 23, 34):
        BSH[4 * r, :] = 0
    planes = deblock_inputs(mbw, mbh, 5, dev, blocky=True)[:3]
    qp = torch.full((n,), 33, dtype=torch.int32, device=dev)
    cqp = torch.full((n,), 31, dtype=torch.int32, device=dev)
    return planes + [BSV, BSH, qp, cqp]


def phase_kernels(dev):
    """Kernel vs plain on the card, exact equality: random bS/QP on the
    (6,5), (4,7), (9,3) and 80x45 MB grids (random and blocky planes);
    the schedule's corner grids (1,1), (1,3), (2,300) (more MB rows than
    SMs, so blocks take several rows by ticket) and 1080p's (120,68);
    one deblock-idc-2 frame (band-top MB rows with zeroed bS); then 50
    repeats at 80x45, where a fault in the progress counters would show
    now and then. The kernel filters its planes in place, so it always
    gets clones."""
    import torch
    from openh264_tpu_torch.encoder import deblock_cuda, deblock_torch
    mbw, mbh = 80, 45
    results = []
    max_err = 0

    def check(args, mbw, mbh, label):
        nonlocal max_err
        want = deblock_torch.deblock_frame_device(*args, mbw, mbh)
        got = deblock_cuda.deblock_frame_cuda(
            *[t.clone() for t in args[:3]], *args[3:], mbw, mbh)
        torch.cuda.synchronize()
        err = max(int((g.int() - w.int()).abs().max()) for g, w in
                  zip(got, want))
        eq = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"deblock kernel vs plain {label}: equal={eq} "
              f"max_abs_err={err}")
        results.append(eq)
        max_err = max(max_err, err)

    for w, h, seed, blocky in [(6, 5, 0, False), (4, 7, 1, False),
                               (9, 3, 2, False), (80, 45, 3, False),
                               (80, 45, 6, True), (1, 1, 7, True),
                               (1, 3, 8, True), (2, 300, 9, True),
                               (120, 68, 10, True)]:
        check(deblock_inputs(w, h, seed, dev, blocky), w, h,
              f"{w}x{h} MBs{' blocky' if blocky else ''}")
    args = idc2_inputs(dev)
    check(args, mbw, mbh, "80x45 idc2 zero rows")
    for label, a in (("blocky", deblock_inputs(mbw, mbh, 6, dev, True)),
                     ("idc2", args)):
        want = deblock_torch.deblock_frame_device(*a, mbw, mbh)
        bad = 0
        for _ in range(50):
            got = deblock_cuda.deblock_frame_cuda(
                *[t.clone() for t in a[:3]], *a[3:], mbw, mbh)
            torch.cuda.synchronize()
            bad += not all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"deblock kernel 50 repeats 80x45 {label}: {bad} differ")
        results.append(bad == 0)
    if not all(results):
        fail("deblock kernel disagrees with its plain version")

    # timing at the main path's shape (80x45 MBs, encoder bS); each
    # kernel run filters fresh clones of the same planes, cloned outside
    # the timed span
    k_ms, k_all = cuda_ms(
        lambda *a: deblock_cuda.deblock_frame_cuda(*a, mbw, mbh), runs=25,
        setup=lambda: [p.clone() for p in args[:3]] + args[3:])
    p_ms, p_all = cuda_ms(
        lambda *a: deblock_torch.deblock_frame_device(*a, mbw, mbh),
        runs=10, setup=lambda: args)
    bound, bound_by, nbytes, ops = deblock_bound_ms(mbw, mbh, *args[3:5])
    steps = mbw + 2 * (mbh - 1)
    print(f"deblock 80x45: kernel {k_ms:.4f} ms (min {min(k_all):.4f}, "
          f"max {max(k_all):.4f}, 25 runs, one launch each), plain "
          f"{p_ms:.4f} ms (10 runs), bound {bound:.6f} ms by {bound_by} "
          f"({nbytes} B, {ops} ops); critical path {steps} MB steps: "
          f"{k_ms / steps * 1e3:.2f} us per step")
    return {"name": "deblock_wavefront", "route": "cuda",
            "source": "openh264_tpu_torch/csrc/deblock.cu",
            "wrapper": "openh264_tpu_torch/encoder/deblock_cuda.py",
            "replaces": "openh264_tpu/encoder/deblock_pallas.py:279",
            "match": True, "max_abs_err": max_err,
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def phase_main_path(dev, card: str):
    """The port's session on 720p frames in two configs; the deblock
    wrapper's launch count must grow by one per deblocked frame."""
    import torch
    from openh264_tpu_torch.encoder import deblock_cuda
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.session_device import \
        DeviceSessionEncoder
    configs = {
        "constqp": dict(qp=28),
        "rc_4slice_2tid": dict(qp=28, rc_mode=1, target_bitrate=4_000_000,
                               max_frame_rate=30.0, num_slices=4,
                               temporal_layers=2),
    }
    fr = frames_720p(N_FRAMES, seed=2024)
    # warm-up: first-use costs (allocator, cached constants) stay out of
    # the timed runs
    DeviceSessionEncoder(EncoderConfig(width=W720, height=H720, qp=28),
                         device=dev).encode_stream(iter(fr[:3]))
    torch.cuda.synchronize()
    out = {}
    launches = 0
    for name, kw in configs.items():
        runs = []
        for _ in range(REPEATS):
            cfg = EncoderConfig(width=W720, height=H720, **kw)
            enc = DeviceSessionEncoder(cfg, device=dev)
            deblock_cuda.launches = 0
            t0 = time.perf_counter()
            bs = enc.encode_stream(iter(fr))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_launch = deblock_cuda.launches
            coded = sum(1 for b in bs if b)
            print(f"main path {name}: {len(fr)} frames 1280x720 in "
                  f"{dt:.3f} s = {len(fr) / dt:.3f} frames/s ({coded} "
                  f"coded, {sum(map(len, bs))} bytes) on {card}; deblock "
                  f"kernel launches {n_launch}; stats {enc.last_stats}")
            if len(bs) != len(fr) or coded < len(fr) // 2:
                fail(f"{name}: {coded} of {len(fr)} frames coded")
            if not all(b.startswith(b"\x00\x00\x00\x01") for b in bs if b):
                fail(f"{name}: output is not Annex-B")
            if n_launch != coded:
                fail(f"{name}: deblock kernel launched {n_launch} times "
                     f"for {coded} deblocked frames")
            launches += n_launch
            runs.append({"fps": len(fr) / dt, "seconds": dt,
                         "coded": coded, "bytes": sum(map(len, bs)),
                         "deblock_launches": n_launch})
        fps = [r["fps"] for r in runs]
        out[name] = {"frames": len(fr), "fps_median": statistics.median(fps),
                     "fps_runs": fps, "runs": runs}
        profile_p_frames(enc, fr, name)
    return out, launches


def profile_p_frames(enc, fr, name):
    """torch.profiler over 3 more P frames of a warmed-up session."""
    profile_frames(lambda: enc.encode_stream(iter(fr[:3])), 3, name)


def profile_frames(run, n: int, name: str):
    """torch.profiler over run(), which encodes n frames: device time by
    op, and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    ka = prof.key_averages()
    table = ka.table(sort_by="cuda_time_total", row_limit=20)
    # device rows only, as the table's "Self CUDA time total" sums them:
    # an op's CPU row repeats the device time of the kernels it launched
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    print(f"profile {name}: {n} frames wall {wall * 1e3:.1f} ms, device "
          f"busy {dev_us / 1e3:.1f} ms "
          f"({100 * dev_us / 1e6 / wall:.1f}% of wall)")
    print(table)
    return {"wall_ms": wall * 1e3, "device_busy_ms": dev_us / 1e3,
            "busy_share": dev_us / 1e6 / wall}


def phase_cross_check(dev):
    """The first 3 frames (I + 2 P) of the 720p content, constant QP:
    CUDA and CPU sessions must write the same bytes."""
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.session_device import \
        DeviceSessionEncoder
    fr = frames_720p(3, seed=2024)
    streams = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        cfg = EncoderConfig(width=W720, height=H720, qp=28)
        streams[d] = DeviceSessionEncoder(cfg, device=d).encode_stream(
            iter(fr))
        print(f"cross-check: {d} encoded 3 frames in "
              f"{time.perf_counter() - t0:.2f} s, sizes "
              f"{[len(b) for b in streams[d]]}")
    if streams[dev] != streams["cpu"]:
        fail("CUDA and CPU streams differ")
    print("cross-check: CUDA and CPU Annex-B byte-identical")


# the host encoder's configs: (entry point, settings, content, frame
# index -> call made on the encoder before that frame)
HOST_CONFIGS = {
    # the API's normal path: one CAVLC slice, so I4x4 runs in host C on
    # the IDR; intra-in-P on the P frames; RC off, QP 28, deblocking on
    "api_cavlc": ("api", dict(iRCMode=-1, iInitialQp=28), "camera", {}),
    # 4 fixed slices (band mode, row_off) under bitrate RC
    "host_4slice_rc": ("host", dict(qp=28, rc_mode=1,
                                    target_bitrate=4_000_000,
                                    max_frame_rate=30.0, num_slices=4),
                       "camera", {}),
    # one slice of screen content: the scroll candidate (extra_mv), per-MB
    # QP from adaptive quant and GOM RC, LTR marking and one recovery
    "host_screen_aq_ltr": ("host", dict(qp=28, rc_mode=1,
                                        target_bitrate=4_000_000,
                                        max_frame_rate=30.0, usage_type=1,
                                        enable_adaptive_quant=True,
                                        enable_gom_rc=True, enable_ltr=True,
                                        ltr_mark_period=2),
                           "screen", {5: "ltr_recovery_request"}),
    # SM_SIZELIMITED: slices close at 1500 bytes (per-MB host writer)
    "host_sizelimited": ("host", dict(qp=28, slice_size_constraint=1500),
                         "camera", {}),
}


def host_encoder(kind: str, kw: dict, dev):
    """(encoder, encode(y, u, v) -> bytes, the H264Encoder behind it)."""
    if kind == "api":
        from openh264_tpu_torch.api import SEncParamExt, WelsCreateSVCEncoder
        api = WelsCreateSVCEncoder(device=dev)
        if api.InitializeExt(SEncParamExt(iPicWidth=W720, iPicHeight=H720,
                                          **kw)) != 0:
            fail("InitializeExt refused the api_cavlc parameters")
        return api.EncodeFrame, api._enc
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.encoder import H264Encoder
    enc = H264Encoder(EncoderConfig(width=W720, height=H720, **kw),
                      device=dev)
    return enc.encode_frame, enc


def host_encode(kind, kw, dev, frames, calls):
    """(Annex-B bytes per frame, host seconds per frame, encode)."""
    encode, enc = host_encoder(kind, kw, dev)
    out, secs = [], []
    for i, f in enumerate(frames):
        if i in calls:
            getattr(enc, calls[i])()
        t0 = time.perf_counter()
        out.append(encode(*f))
        secs.append(time.perf_counter() - t0)
    return out, secs, encode


def phase_host_encoder(dev, card: str):
    """The host encoder path on 720p content in each of HOST_CONFIGS:
    timed runs whose deblock launches must equal their deblocked frames,
    a profile of 2 more P frames, and CUDA against CPU over 3 frames."""
    import torch
    from openh264_tpu_torch.encoder import deblock_cuda
    from openh264_tpu_torch.processing.scroll import detect_scroll
    content = {"camera": frames_720p(HOST_FRAMES + 2, seed=2024),
               "screen": frames_720p_scroll(HOST_FRAMES + 2, seed=2024)}
    sc = content["screen"]
    hits = [detect_scroll(torch.from_numpy(sc[i + 1][0]).to(dev),
                          torch.from_numpy(sc[i][0]).to(dev))
            for i in range(2)]
    print(f"host encoder: scroll detected on the screen content: {hits}")
    if hits != [(True, SCROLL_ROWS)] * 2:
        fail(f"screen content: scroll of {SCROLL_ROWS} rows not detected")
    # warm-up: first-use costs (host C build, allocator, constants)
    host_encode("api", HOST_CONFIGS["api_cavlc"][1], dev,
                content["camera"][:2], {})
    torch.cuda.synchronize()
    out, launches = {}, 0
    for name, (kind, kw, src, calls) in HOST_CONFIGS.items():
        fr = content[src]
        runs = []
        for _ in range(HOST_REPEATS):
            deblock_cuda.launches = 0
            t0 = time.perf_counter()
            bs, secs, encode = host_encode(kind, kw, dev, fr[:HOST_FRAMES],
                                           calls)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_launch = deblock_cuda.launches
            coded = sum(1 for b in bs if b)
            print(f"host encoder {name}: {HOST_FRAMES} frames 1280x720 in "
                  f"{dt:.3f} s = {HOST_FRAMES / dt:.3f} frames/s ({coded} "
                  f"coded, {sum(map(len, bs))} bytes, slice NALs per frame "
                  f"{[b.count(b'\x00\x00\x00\x01') for b in bs]}) on "
                  f"{card}; deblock kernel launches {n_launch}; seconds per "
                  f"frame {[round(t, 3) for t in secs]}")
            if coded < HOST_FRAMES // 2:
                fail(f"{name}: {coded} of {HOST_FRAMES} frames coded")
            if not all(b.startswith(b"\x00\x00\x00\x01") for b in bs if b):
                fail(f"{name}: output is not Annex-B")
            if n_launch != coded:
                fail(f"{name}: deblock kernel launched {n_launch} times for "
                     f"{coded} deblocked frames")
            launches += n_launch
            runs.append({"fps": HOST_FRAMES / dt, "seconds": dt,
                         "idr_s": secs[0],
                         "p_s_median": statistics.median(secs[1:]),
                         "coded": coded, "bytes": sum(map(len, bs)),
                         "deblock_launches": n_launch})
        prof = profile_frames(lambda: [encode(*f) for f in
                                       fr[HOST_FRAMES:HOST_FRAMES + 2]],
                              2, f"host {name}")
        streams = {}
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            streams[d] = host_encode(kind, kw, d, fr[:3], calls)[0]
            print(f"host cross-check {name}: {d} encoded 3 frames in "
                  f"{time.perf_counter() - t0:.2f} s, sizes "
                  f"{[len(b) for b in streams[d]]}")
        if streams[dev] != streams["cpu"]:
            fail(f"host encoder {name}: CUDA and CPU streams differ")
        print(f"host cross-check {name}: CUDA and CPU Annex-B "
              f"byte-identical")
        fps = [r["fps"] for r in runs]
        out[name] = {"frames": HOST_FRAMES,
                     "fps_median": statistics.median(fps), "fps_runs": fps,
                     "runs": runs, "profile_2p": prof}
    return out, launches


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a GPU")
    sys.path.insert(0, str(ROOT))
    try:
        from openh264_tpu_torch import _build
    except ImportError as e:
        fail(f"the openh264_tpu_torch package is not beside this script "
             f"({e})")
    t_start = time.perf_counter()
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    seconds, log = _build.build("deblock")
    print(f"build deblock: {seconds:.2f} s\n{log.strip()}")
    seconds, log = _build.build("host_native")
    print(f"build host_native (host C, cc): {seconds:.2f} s {log.strip()}")

    t0 = time.perf_counter()
    kern = phase_kernels(dev)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_path, launches = phase_main_path(dev, card)
    print(f"phase main path: {time.perf_counter() - t0:.1f} s")
    if launches == 0:
        fail("the main path never launched the deblock kernel")
    t0 = time.perf_counter()
    phase_cross_check(dev)
    print(f"phase cross-check: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    host_path, host_launches = phase_host_encoder(dev, card)
    print(f"phase host encoder: {time.perf_counter() - t0:.1f} s")
    if host_launches == 0:
        fail("the host encoder path never launched the deblock kernel")
    kern["launches"] = launches + host_launches
    print(f"main path summary: "
          f"{json.dumps({'card': card, 'configs': main_path})}")
    print(f"host encoder summary: "
          f"{json.dumps({'card': card, 'configs': host_path})}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
