#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (openh264_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the deblock kernel from csrc/deblock.cu with nvcc, and the
     host C of the host encoder and the decoder (every library of
     _build.SIGNATURES: csrc/host_native.c, parse_cavlc.c, parse_cabac.c
     and cabac_residual.c) with cc, all at once;
  3. each kernel against its plain PyTorch version on the card, exact
     equality, on many grids and in 50 repeats, and both timed with
     CUDA events; the deblock kernel also with the decoder's inputs
     (per-MB alpha/beta offsets, separate Cb and Cr QPs), timed too,
     and with deblock_host.deblock_inputs of a 720p B FrameSymbols with
     8x8-transform MBs (their interior luma edges zeroed);
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
     size-limited slices), 2 timed runs of 8 frames each (frames/s; one
     of the size-limited config, whose IDR takes ~50 s), the deblock
     kernel's launches against the deblocked frames of each run, the
     first run's first 3 frames against a CPU encode of them, and a
     torch.profiler device-busy share over 2 more P frames;
  7. the rest of the encoder side at 720p: CABAC through the API and
     through H264Encoder with 4 fixed slices and bitrate RC (frames/s,
     IDR and P seconds, deblock launches per deblocked frame); 3-layer
     simulcast, serial and with one thread per layer (threaded equal to
     serial); GOP parallelism on two threads against the serial session;
     the processing functions (denoise, downsampling, background
     detection, rotation), each CUDA equal to CPU and timed with CUDA
     events. Then, all at once and untimed: the h264enc console as a
     subprocess, whose file must equal the API's stream for the
     console's parameters, and the CPU encodes of the first 2 frames of
     the CABAC and simulcast runs in worker processes, which must equal
     the CUDA bytes;
  8. the decoder: H264Decoder(device="cuda") on the Annex-B streams that
     phases 4 and 6 wrote in their first timed runs (constqp and
     rc_4slice_2tid, the four host-encoder configs), each decoded once
     and constqp twice (frames/s, seconds per stage, one deblock launch
     per decoded picture, frame count and cropped size), constqp's and
     api_cavlc's frames equal to the encoder's own reconstruction, and a
     torch.profiler device-busy share over 3 P frames of constqp; then,
     all at once and untimed: the CPU decodes of the first 2 frames of
     each stream in worker processes, which must equal the CUDA frames,
     CWelsDecoder on api_cavlc's stream, and the h264dec console as a
     subprocess, whose YUV file must equal the decoder's frames;
  9. the decoder's parse layer, on streams the script already wrote: the
     CABAC streams of phase 7 (api_cabac, host_cabac_4slice_rc), each
     decoded once on the card (frames/s, seconds per stage, one deblock
     launch per picture), api_cabac's frames equal to its encoder's
     reconstruction and CWelsDecoder's; phase 4's rc_4slice_2tid with
     its PPS rewritten to six sent 4x4 scaling lists and two chroma QP
     offsets and its slice headers to deblocking_filter_idc 2 with
     per-slice alpha/beta offsets (2 frames); and a two-slice-group FMO
     stream at 176x144 built here (an IDR of one-row bands, deblocking
     off, then a P picture of skipped MBs), which the per-MB Python
     parser decodes (its seconds per MB), equal to the per-row
     reconstruction; every one of these equal to a CPU decode in a
     worker process that ran beside the card's decodes;
 10. B pictures and the 8x8 transform: b_t8_cabac (720p: api_cabac's
     IDR and P, then under a transform_8x8_mode PPS with 8x8 scaling
     lists and implicit weights a P, an I and two B pictures of seeded
     random CABAC bins steered by the port's parser on the host) and
     b_t8_cavlc (176x144: B pictures of the tests' hand MB writer with
     explicit weights, through the Python CAVLC parser), each decoded
     once on the card (frames/s, seconds per stage, one deblock launch
     per picture, the MB types reached, which must include B, I8x8 and
     8x8-transform inter MBs, and the recon seconds of pictures with
     I8x8 MBs), equal to a CPU decode in a worker process beside.
 11. slice-parallel encoding: SliceParallelEncoder with 3 bands of 15 MB
     rows, all on cuda:0 (the bands one after the other, the gather and
     the deblock of the merged frame on the card), 8 frames of the 720p
     content at QP 28, one timed run (frames/s, IDR and median P
     seconds, one deblock launch per frame); its bytes must equal
     H264Encoder(num_slices=3) on the card over the same frames (a
     configuration on which the two agree; timed next), its stream must
     decode through H264Decoder(device="cuda") to its DPB planes, frame
     by frame, and its first 2 frames must equal a CPU
     SliceParallelEncoder's in a worker process beside that decode.
It prints a `kernels` JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
W720, H720 = 1280, 720
N_FRAMES = 16          # per main-path run: 1 IDR + 15 P
REPEATS = 2            # timed runs of each main-path config
HOST_FRAMES = 8        # per host-encoder run: 1 IDR + 7 P
HOST_REPEATS = 2       # timed runs of each host-encoder config but
SIZELIMITED_REPEATS = 1  # host_sizelimited's (its IDR alone takes ~50 s)
SCROLL_ROWS = 8        # screen content scrolls this many rows a frame
REST_FRAMES = 4        # phase 7 runs: 1 IDR + 3 P
REST_CROSS = 2         # phase 7 frames encoded on both CUDA and the CPU
REST_SEED = 2024       # phase 7 content
GOP_FRAMES = 8         # phase 7 GOP parallelism: 2 closed GOPs of 4
DEC_CROSS = 2          # phase 8, 9 frames decoded on both CUDA and the CPU
FMO_W, FMO_H = 176, 144  # phase 9 FMO stream (the Python parser's)
B_W, B_H = 176, 144      # phase 10 CAVLC B stream (the Python parser's)
B_SEED = 2027            # phase 10 stream writers
SP_FRAMES = 8          # phase 11 slice-parallel run: 1 IDR + 7 P
SP_SLICES = 3          # phase 11 bands of 15 MB rows, all on cuda:0
SP_CROSS = 2           # phase 11 frames encoded on the CPU too
CPU_THREADS = 2        # torch threads of each CPU cross-check process
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


def deblock_bound_ms(mbw, mbh, BSV, BSH, n_mb_arrays=2):
    """Least time for one frame's deblock on the card: the larger of the
    bytes it must move (planes, bS grids and the per-MB arrays read once
    -- QP and chroma QP, or with the decoder's inputs QP, Cb and Cr QPs
    and two offsets -- planes written once) over HBM bandwidth, and the
    integer operations this bS data asks for over the scalar rate: ~60
    ops for each luma line and ~25 for each chroma line across an edge
    with bS > 0."""
    plane = 16 * mbh * 16 * mbw * 3 // 2
    nbytes = 2 * plane + 2 * BSV.numel() * 4 + n_mb_arrays * mbw * mbh * 4
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


def t8_inputs(dev):
    """The decoder's deblock inputs at 720p (80x45 MBs) for 8x8-transform
    MBs: deblock_host.deblock_inputs of a seeded B FrameSymbols (I16x16,
    I8x8, B16x16, B8x8, B_Skip and B_Direct MBs, motion and refs in both
    lists, the direct interior-bS modes, the 8x8 transform on about half
    the MBs, 5 slices with their own alpha/beta offsets, Cb/Cr QP
    offsets 2 and -3), whose interior luma edges of 8x8-transform MBs it
    zeroes; blocky planes. Returns (planes + [BSV, BSH, qp, cqp],
    (alpha, beta, cqp), the number of 8x8-transform MBs)."""
    import torch
    from openh264_tpu_torch.decoder.framedata import FrameSymbols
    from openh264_tpu_torch.encoder.deblock_host import deblock_inputs as di
    rng = np.random.default_rng(11)
    mbw, mbh = 80, 45
    n = mbw * mbh
    fs = FrameSymbols(mbw, mbh)
    fs.mb_type[:] = rng.choice([1, 3, 9, 12, 13, 14], n)
    intra = fs.mb_type < 4
    fs.slice_id[:] = np.repeat(np.arange(5), n // 5)
    offs = rng.integers(-6, 7, (5, 2)) * 2
    fs.alpha_offset[:] = offs[fs.slice_id, 0]
    fs.beta_offset[:] = offs[fs.slice_id, 1]
    fs.qp[:] = rng.integers(18, 42, n)
    pm = rng.integers(0, 3, (n, 4))
    fs.pred_mode[:] = np.where(intra[:, None], -1, pm)
    for lx in range(2):
        use = ~intra[:, None] & ((pm == lx) | (pm == 2))
        ref = rng.integers(0, 2, (n, 4))
        fs.refidx[:, lx] = np.where(use, ref, -1)
        fs.ref_pic[:, lx] = np.where(use, ref * 4 + 1, -1)
        fs.mv[:, lx] = rng.integers(-7, 8, (n, 16, 2))
    fs.ibs_mode[:] = np.where(fs.mb_type == 13, 2, np.where(
        fs.mb_type == 14, rng.integers(0, 2, n), 0))
    fs.nzc_l[:] = rng.integers(0, 3, fs.nzc_l.shape) * \
        (rng.random(fs.nzc_l.shape) < 0.4)
    fs.transform8[:] = (rng.random(n) < 0.5) | (fs.mb_type == 3)
    fs.chroma_qp_offsets = (2, -3)
    BSV, BSH, qp, cqp, ao, bo = (torch.from_numpy(a).to(dev)
                                 for a in di(fs))
    planes = deblock_inputs(mbw, mbh, 12, dev, blocky=True)[:3]
    return (planes + [BSV, BSH, qp, cqp], (ao, bo, cqp),
            int(fs.transform8.sum()))


def offset_inputs(mbw, mbh, seed, dev):
    """The decoder's extra deblock inputs: per-MB alpha and beta offsets
    (-12..12, even, as slice headers send them) and Cb / Cr QPs
    [2, n_mb] that differ per plane."""
    import torch
    rng = np.random.default_rng(seed)
    n = mbw * mbh
    return [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-6, 7, n).astype(np.int32) * 2,
        rng.integers(-6, 7, n).astype(np.int32) * 2,
        rng.integers(18, 42, (2, n)).astype(np.int32))]


def phase_kernels(dev):
    """Kernel vs plain on the card, exact equality: random bS/QP on the
    (6,5), (4,7), (9,3) and 80x45 MB grids (random and blocky planes);
    the schedule's corner grids (1,1), (1,3), (2,300) (more MB rows than
    SMs, so blocks take several rows by ticket) and 1080p's (120,68);
    one deblock-idc-2 frame (band-top MB rows with zeroed bS); the
    decoder's inputs (random non-zero alpha/beta offsets per MB, unequal
    Cb and Cr QPs) on (6,5) and, in 10 repeats, at 80x45; the decoder's
    inputs for 8x8-transform MBs at 80x45 (t8_inputs); then 50
    repeats at 80x45, where a fault in the progress counters would show
    now and then. The kernel filters its planes in place, so it
    always gets clones."""
    import torch
    from openh264_tpu_torch.encoder import deblock_cuda, deblock_torch
    mbw, mbh = 80, 45
    results = []
    max_err = 0

    def check(args, mbw, mbh, label, offs=None):
        nonlocal max_err
        extra = () if offs is None else (offs[0], offs[1])
        if offs is not None:
            args = args[:6] + [offs[2]]
        want = deblock_torch.deblock_frame_device(*args, mbw, mbh, *extra)
        got = deblock_cuda.deblock_frame_cuda(
            *[t.clone() for t in args[:3]], *args[3:], mbw, mbh, *extra)
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
    check(deblock_inputs(6, 5, 20, dev, True), 6, 5,
          "6x5 MBs offsets, Cb/Cr QPs", offset_inputs(6, 5, 20, dev))
    t8_args, t8_offs, n_t8 = t8_inputs(dev)
    check(t8_args, mbw, mbh, f"80x45 decoder inputs with {n_t8} "
          f"8x8-transform MBs (interior luma edges zeroed)", t8_offs)
    offs = offset_inputs(mbw, mbh, 21, dev)
    for label, a, extra, n in (
            ("blocky", deblock_inputs(mbw, mbh, 6, dev, True), (), 50),
            ("idc2", args, (), 50),
            ("idc2 offsets, Cb/Cr QPs", args[:6] + [offs[2]], offs[:2], 10)):
        want = deblock_torch.deblock_frame_device(*a, mbw, mbh, *extra)
        bad = 0
        for _ in range(n):
            got = deblock_cuda.deblock_frame_cuda(
                *[t.clone() for t in a[:3]], *a[3:], mbw, mbh, *extra)
            torch.cuda.synchronize()
            bad += not all(torch.equal(g, w) for g, w in zip(got, want))
            max_err = max([max_err] + [int((g.int() - w.int()).abs().max())
                                       for g, w in zip(got, want)])
        print(f"deblock kernel {n} repeats 80x45 {label}: {bad} differ")
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
    # the decoder's inputs: per-MB offsets and two chroma QPs, first all
    # zero and equal (the filtering of the run above, plus the reads of
    # the three extra arrays), then random (other edges filter)
    zero = torch.zeros(mbw * mbh, dtype=torch.int32, device=dev)
    z_ms, z_all = cuda_ms(
        lambda *a: deblock_cuda.deblock_frame_cuda(*a, mbw, mbh, zero, zero),
        runs=25, setup=lambda: [p.clone() for p in args[:3]] + args[3:6]
        + [torch.stack([args[6]] * 2)])
    o_ms, o_all = cuda_ms(
        lambda *a: deblock_cuda.deblock_frame_cuda(*a, mbw, mbh, *offs[:2]),
        runs=25, setup=lambda: [p.clone() for p in args[:3]] + args[3:6]
        + [offs[2]])
    o_bound, o_by, o_bytes, _ops = deblock_bound_ms(mbw, mbh, *args[3:5], 5)
    print(f"deblock 80x45 with zero offsets and two equal chroma QP rows: "
          f"kernel {z_ms:.4f} ms (min {min(z_all):.4f}, max "
          f"{max(z_all):.4f}, 25 runs); with random offsets and Cb/Cr QPs: "
          f"kernel {o_ms:.4f} ms (min {min(o_all):.4f}, max "
          f"{max(o_all):.4f}, 25 runs), bound {o_bound:.6f} ms by {o_by} "
          f"({o_bytes} B)")
    return {"name": "deblock_wavefront", "route": "cuda",
            "source": "openh264_tpu_torch/csrc/deblock.cu",
            "wrapper": "openh264_tpu_torch/encoder/deblock_cuda.py",
            "replaces": "openh264_tpu/encoder/deblock_pallas.py:279",
            "match": True, "max_abs_err": max_err,
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "ms_zero_offsets": z_ms, "ms_offsets": o_ms,
            "bound_ms_offsets": o_bound}


def capture_recon(enc, recon: list):
    """Makes the session `enc` keep a device copy of each frame's
    deblocked reconstruction in `recon` (one clone per plane, queued on
    the device beside the frame's work)."""
    launch = enc._launch

    def launch_and_keep(buf):
        rec = launch(buf)
        if rec is not None:
            recon.append([p.clone() for p in enc._pending_ref.planes])
        return rec
    enc._launch = launch_and_keep


def phase_main_path(dev, card: str):
    """The port's session on 720p frames in two configs; the deblock
    wrapper's launch count must grow by one per deblocked frame. Returns
    the summary, the launches, the first timed run's bytes per frame of
    each config and constqp's reconstruction per frame (for phase 8)."""
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
    out, first_runs, recon = {}, {}, []
    launches = 0
    for name, kw in configs.items():
        runs = []
        for rep in range(REPEATS):
            cfg = EncoderConfig(width=W720, height=H720, **kw)
            enc = DeviceSessionEncoder(cfg, device=dev)
            if name == "constqp" and rep == 0:
                capture_recon(enc, recon)
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
            first_runs.setdefault(name, bs)
        fps = [r["fps"] for r in runs]
        out[name] = {"frames": len(fr), "fps_median": statistics.median(fps),
                     "fps_runs": fps, "runs": runs}
        profile_p_frames(enc, fr, name)
    return out, launches, first_runs, {"constqp": recon}


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
            fail(f"InitializeExt refused the API parameters {kw}")
        return api.EncodeFrame, api._enc
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.encoder import H264Encoder
    enc = H264Encoder(EncoderConfig(width=W720, height=H720, **kw),
                      device=dev)
    return enc.encode_frame, enc


def host_encode(kind, kw, dev, frames, calls, recon=None):
    """(Annex-B bytes per frame, host seconds per frame, encode). With a
    `recon` list, a device copy of each frame's deblocked reconstruction
    (the newest DPB entry) is kept there, outside the timed span."""
    encode, enc = host_encoder(kind, kw, dev)
    out, secs = [], []
    for i, f in enumerate(frames):
        if i in calls:
            getattr(enc, calls[i])()
        t0 = time.perf_counter()
        out.append(encode(*f))
        secs.append(time.perf_counter() - t0)
        if recon is not None:
            recon.append([p.clone() for p in enc.dpb[-1].planes])
    return out, secs, encode


def phase_host_encoder(dev, card: str):
    """The host encoder path on 720p content in each of HOST_CONFIGS:
    timed runs whose deblock launches must equal their deblocked frames,
    a profile of 2 more P frames, and the first timed run's first 3
    frames against a CPU encode of the same 3 frames (an encoder's
    frame depends only on the frames before it).
    Returns the summary, the launches, the first timed run's bytes per
    frame of each config and api_cavlc's reconstruction per frame."""
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
    out, launches, first_runs, recon = {}, 0, {}, []
    for name, (kind, kw, src, calls) in HOST_CONFIGS.items():
        fr = content[src]
        runs = []
        for rep in range(SIZELIMITED_REPEATS if name == "host_sizelimited"
                         else HOST_REPEATS):
            deblock_cuda.launches = 0
            t0 = time.perf_counter()
            bs, secs, encode = host_encode(
                kind, kw, dev, fr[:HOST_FRAMES], calls,
                recon if name == "api_cavlc" and rep == 0 else None)
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
            first_runs.setdefault(name, bs)
        prof = profile_frames(lambda: [encode(*f) for f in
                                       fr[HOST_FRAMES:HOST_FRAMES + 2]],
                              2, f"host {name}")
        streams = {dev: first_runs[name][:3]}
        t0 = time.perf_counter()
        streams["cpu"] = host_encode(kind, kw, "cpu", fr[:3], calls)[0]
        print(f"host cross-check {name}: cpu encoded 3 frames in "
              f"{time.perf_counter() - t0:.2f} s, sizes "
              f"{[len(b) for b in streams['cpu']]} (cuda "
              f"{[len(b) for b in streams[dev]]})")
        if streams[dev] != streams["cpu"]:
            fail(f"host encoder {name}: CUDA and CPU streams differ")
        print(f"host cross-check {name}: CUDA and CPU Annex-B "
              f"byte-identical")
        fps = [r["fps"] for r in runs]
        out[name] = {"frames": HOST_FRAMES,
                     "fps_median": statistics.median(fps), "fps_runs": fps,
                     "runs": runs, "profile_2p": prof}
    return out, launches, first_runs, {"api_cavlc": recon}


def _timed_host_run(name, kind, kw, dev, fr, card, recon=None,
                    phase="rest"):
    """One timed run of the host encoder / API: its bytes per frame, and
    frames/s, IDR and median P seconds; the deblock kernel must launch
    once per deblocked frame. With a `recon` list, each frame's
    reconstruction is kept there (host_encode)."""
    import torch
    from openh264_tpu_torch.encoder import deblock_cuda
    deblock_cuda.launches = 0
    t0 = time.perf_counter()
    bs, secs, _encode = host_encode(kind, kw, dev, fr, {}, recon)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_launch = deblock_cuda.launches
    coded = sum(1 for b in bs if b)
    print(f"{phase} {name}: {len(fr)} frames {W720}x{H720} in {dt:.3f} s = "
          f"{len(fr) / dt:.3f} frames/s ({coded} coded, "
          f"{sum(map(len, bs))} bytes) on {card}; IDR {secs[0]:.3f} s, P "
          f"{[round(t, 3) for t in secs[1:]]} s; deblock kernel launches "
          f"{n_launch}")
    if coded < len(fr) // 2 or not all(
            b.startswith(b"\x00\x00\x00\x01") for b in bs if b):
        fail(f"{name}: {coded} of {len(fr)} frames coded as Annex-B")
    if n_launch != coded:
        fail(f"{name}: deblock kernel launched {n_launch} times for {coded} "
             f"deblocked frames")
    return bs, {"fps": len(fr) / dt, "seconds": dt, "idr_s": secs[0],
            "p_s": secs[1:], "p_s_median": statistics.median(secs[1:]),
            "bytes": sum(map(len, bs)), "deblock_launches": n_launch}


REST_CONFIGS = {
    # the API with CABAC: one slice, RC off, QP 28 (no I4x4: CAVLC-only)
    "api_cabac": ("api", dict(iEntropyCodingModeFlag=1, iRCMode=-1,
                              iInitialQp=28)),
    # H264Encoder with CABAC, 4 fixed slices, bitrate RC at 4 Mbit/s
    "host_cabac_4slice_rc": ("host", dict(qp=28, entropy_cabac=True,
                                          num_slices=4, rc_mode=1,
                                          target_bitrate=4_000_000,
                                          max_frame_rate=30.0)),
}


def simulcast_encoder(**kw):
    """3 layers (1280x720, 640x360, 320x180) at QP 28, CAVLC."""
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.parallel import SimulcastEncoder
    return SimulcastEncoder(EncoderConfig(width=W720, height=H720, qp=28), 3,
                            **kw)


def phase_simulcast(dev, fr, card):
    """Simulcast serial on the card, and threaded with every layer on
    cuda:0, which must equal serial. Returns the summary, the serial
    bytes and the deblock launches."""
    import torch
    from openh264_tpu_torch.encoder import deblock_cuda
    runs, streams = {}, {}
    for mode, kw in (("serial", dict(device=dev)),
                     ("threaded", dict(devices=[f"{dev}:0"] * 3))):
        sim = simulcast_encoder(**kw)
        deblock_cuda.launches = 0
        t0 = time.perf_counter()
        out = [sim.encode_frame(*f)[1] for f in fr]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sim.close()
        n_launch = deblock_cuda.launches
        coded = sum(1 for layers in out for b in layers if b)
        print(f"rest simulcast {mode}: {len(fr)} frames x 3 layers "
              f"({[(e.cfg.width, e.cfg.height) for e in sim.encoders]}) in "
              f"{dt:.3f} s = {len(fr) / dt:.3f} frames/s, "
              f"{sum(len(b) for layers in out for b in layers)} bytes on "
              f"{card}; deblock kernel launches {n_launch}")
        if n_launch != coded:
            fail(f"simulcast {mode}: deblock kernel launched {n_launch} "
                 f"times for {coded} deblocked layer frames")
        runs[mode] = {"fps": len(fr) / dt, "seconds": dt,
                      "deblock_launches": n_launch}
        streams[mode] = out
    if streams["threaded"] != streams["serial"]:
        fail("simulcast: threaded layers differ from serial")
    print("rest simulcast: threaded equals serial")
    return runs, streams["serial"], sum(r["deblock_launches"]
                                        for r in runs.values())


def phase_gop(dev, card):
    """GopParallelEncoder (idr_interval 4, two threads on cuda:0) on
    GOP_FRAMES frames against the serial DeviceSessionEncoder."""
    import torch
    from openh264_tpu_torch.encoder import deblock_cuda
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.session_device import \
        DeviceSessionEncoder
    from openh264_tpu_torch.parallel import GopParallelEncoder
    fr = frames_720p(GOP_FRAMES, seed=REST_SEED)
    cfg = lambda: EncoderConfig(width=W720, height=H720, qp=28,  # noqa: E731
                                idr_interval=4)
    out, streams, launches = {}, {}, 0
    for mode, run in (
            ("gop_parallel", lambda: GopParallelEncoder(
                cfg(), devices=[f"{dev}:0"] * 2).encode_stream(iter(fr))),
            ("serial", lambda: DeviceSessionEncoder(
                cfg(), device=dev).encode_stream(iter(fr)))):
        deblock_cuda.launches = 0
        t0 = time.perf_counter()
        bs = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_launch = deblock_cuda.launches
        coded = sum(1 for b in bs if b)
        print(f"rest {mode}: {len(fr)} frames {W720}x{H720} in {dt:.3f} s = "
              f"{len(fr) / dt:.3f} frames/s ({sum(map(len, bs))} bytes) on "
              f"{card}; deblock kernel launches {n_launch}")
        if n_launch != coded:
            fail(f"{mode}: deblock kernel launched {n_launch} times for "
                 f"{coded} deblocked frames")
        launches += n_launch
        out[mode] = {"fps": len(fr) / dt, "seconds": dt,
                     "deblock_launches": n_launch}
        streams[mode] = bs
    if streams["gop_parallel"] != streams["serial"]:
        fail("GOP-parallel stream differs from the serial session's")
    print("rest gop: two-thread GOP-parallel stream equals the serial one")
    return out, launches


def phase_processing(dev, fr, card):
    """The processing functions on the 720p planes: CUDA equal to CPU for
    each, and CUDA-event times (median of 10 runs)."""
    import torch
    from openh264_tpu_torch.processing import (
        background_division, denoise_frame, dyadic_downsample,
        general_bilinear_downsample, rotate_image, vaa_calc)
    cases = {
        "denoise_frame": lambda y, u, v, y1: denoise_frame(y, u, v),
        "dyadic_downsample_1": lambda y, u, v, y1: dyadic_downsample(y, 1),
        "dyadic_downsample_2": lambda y, u, v, y1: dyadic_downsample(y, 2),
        "general_bilinear_960x540": lambda y, u, v, y1:
            general_bilinear_downsample(y, 540, 960),
        "general_bilinear_640x352": lambda y, u, v, y1:
            general_bilinear_downsample(y, 352, 640),
        "background_division": lambda y, u, v, y1:
            background_division(vaa_calc(y1, y)),
        "rotate_90": lambda y, u, v, y1: rotate_image(y, 90).contiguous(),
        "rotate_180": lambda y, u, v, y1: rotate_image(y, 180).contiguous(),
        "rotate_270": lambda y, u, v, y1: rotate_image(y, 270).contiguous(),
    }
    host = [torch.from_numpy(p) for p in fr[0]] + [torch.from_numpy(fr[1][0])]
    card_in = [t.to(dev) for t in host]

    def flat(r):
        if isinstance(r, dict):
            return [r[k] for k in sorted(r)]
        return list(r) if isinstance(r, tuple) else [r]
    out = {}
    for name, fn in cases.items():
        want = flat(fn(*host))
        got = flat(fn(*card_in))
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            fail(f"processing {name}: CUDA and CPU differ")
        ms, _all = cuda_ms(fn, runs=10, setup=lambda: card_in)
        print(f"rest processing {name}: CUDA equals CPU; {ms:.4f} ms on "
              f"{card}")
        out[name] = ms
    return out


def cpu_streams(name, frames):
    """In a worker process: the CPU bytes of `frames` for the phase 7 run
    `name` (a REST_CONFIGS entry or "simulcast"), and their seconds."""
    import torch
    torch.set_num_threads(CPU_THREADS)
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    if name == "simulcast":
        sim = simulcast_encoder(device="cpu")
        bs = [sim.encode_frame(*f)[1] for f in frames]
    else:
        kind, kw = REST_CONFIGS[name]
        bs = host_encode(kind, kw, "cpu", frames, {})[0]
    return bs, time.perf_counter() - t0


def phase_cli(dev, fr, card):
    """The h264enc console as a subprocess on the CUDA device: its file
    must equal the in-process API's stream for the SEncParamExt that the
    console builds from the same arguments, which this process encodes
    while the console runs."""
    from openh264_tpu_torch.api import WelsCreateSVCEncoder
    from openh264_tpu_torch.cli.h264enc import encoder_param, settings
    with tempfile.TemporaryDirectory() as tmp:
        yuv, out = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "out.264")
        with open(yuv, "wb") as f:
            for y, u, v in fr:
                f.write(y.tobytes() + u.tobytes() + v.tobytes())
        argv = ["-org", yuv, "-sw", str(W720), "-sh", str(H720), "-bf", out,
                "-frms", str(len(fr)), "-rc", "-1", "-cabac", "1"]
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m",
                                 "openh264_tpu_torch.cli.h264enc", *argv],
                                cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            api = WelsCreateSVCEncoder(device=dev)
            if api.InitializeExt(encoder_param(settings(argv)[0])) != 0:
                fail("InitializeExt refused the console's parameters")
            want = b"".join(api.EncodeFrame(*f) for f in fr)
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"h264enc exited {proc.returncode}: {stderr[-2000:]}")
        fps = [ln.strip() for ln in stdout.splitlines()
               if ln.startswith("FPS:")] or ["(no FPS line)"]
        print(f"rest cli: h264enc -cabac 1, {len(fr)} frames {W720}x{H720} "
              f"in {dt:.2f} s with start-up, beside the in-process encode "
              f"and the CPU cross-checks; its {fps[0]} on {card}")
        with open(out, "rb") as f:
            got = f.read()
    if got != want:
        fail(f"h264enc file ({len(got)} B) differs from the API's stream "
             f"({len(want)} B)")
    print(f"rest cli: file equals the in-process API stream ({len(got)} B)")
    return {"seconds_with_startup": dt,
            "fps_line": fps[0],
            "bytes": len(got)}


def phase_rest(dev, card):
    """Phase 7: CABAC (API, H264Encoder with 4 slices and RC), simulcast,
    GOP parallelism and the processing functions at 720p, timed one by
    one; then the console and the CPU cross-checks, untimed and at once.
    Returns the summary, the deblock launches of the timed runs, the
    CABAC runs' bytes per frame and api_cabac's reconstruction per
    frame (for phase 9)."""
    fr = frames_720p(REST_FRAMES, seed=REST_SEED)
    out, cuda_bytes, launches, recon = {}, {}, 0, []
    for name, (kind, kw) in REST_CONFIGS.items():
        cuda_bytes[name], out[name] = _timed_host_run(
            name, kind, kw, dev, fr, card,
            recon if name == "api_cabac" else None)
        launches += out[name]["deblock_launches"]
    cabac = {name: cuda_bytes[name] for name in REST_CONFIGS}
    out["simulcast"], cuda_bytes["simulcast"], n = phase_simulcast(dev, fr,
                                                                   card)
    launches += n
    out["gop"], n = phase_gop(dev, card)
    launches += n
    out["processing_ms"] = phase_processing(dev, fr, card)
    # a fresh encoder's first frames equal the timed run's first frames,
    # so the timed runs are the CUDA side of the cross-checks
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(cuda_bytes), mp_context=spawn) as pool:
        jobs = {name: pool.submit(cpu_streams, name, fr[:REST_CROSS])
                for name in cuda_bytes}
        out["cli"] = phase_cli(dev, fr, card)
        for name, job in jobs.items():
            bs, secs = job.result()
            print(f"rest cross-check {name}: cpu encoded {REST_CROSS} "
                  f"frames in {secs:.2f} s ({CPU_THREADS} torch threads, "
                  f"beside the other checks)")
            if bs != cuda_bytes[name][:REST_CROSS]:
                fail(f"{name}: CUDA and CPU streams differ")
            print(f"rest cross-check {name}: CUDA and CPU Annex-B "
                  f"byte-identical")
    return out, launches, cabac, {"api_cabac": recon}


def cpu_decode(data: bytes):
    """In a worker process: the port's CPU decode of `data`, as (y, u, v)
    numpy planes per frame, and its seconds."""
    import torch
    torch.set_num_threads(CPU_THREADS)
    sys.path.insert(0, str(ROOT))
    from openh264_tpu_torch.decoder import H264Decoder
    t0 = time.perf_counter()
    frames = H264Decoder(device="cpu").decode_annexb(data)
    return [f.planes() for f in frames], time.perf_counter() - t0


def same_frames(got, want) -> bool:
    """Whether two lists of frames ((y, u, v) numpy planes, or objects
    with planes()) are equal, plane for plane."""
    def planes(f):
        return f.planes() if hasattr(f, "planes") else f
    return len(got) == len(want) and all(
        all(np.array_equal(a, b) for a, b in zip(planes(g), planes(w)))
        for g, w in zip(got, want))


def timed_decode(name, data, coded, dev, card, size=(W720, H720)):
    """One timed decode of `data` with seconds per stage; the deblock
    kernel must launch once per picture, and `coded` frames of `size`
    (1280x720) must come out. Returns the frames and the run's numbers."""
    import torch
    from openh264_tpu_torch.decoder import H264Decoder
    from openh264_tpu_torch.encoder import deblock_cuda
    dec = H264Decoder(device=dev, stage_times=True)
    deblock_cuda.launches = 0
    t0 = time.perf_counter()
    frames = dec.decode_annexb(data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_launch = deblock_cuda.launches
    stages = {k: round(v, 4) for k, v in dec.stage_seconds.items()}
    w, h = size
    print(f"decoder {name}: {len(frames)} frames {w}x{h} in {dt:.3f} "
          f"s = {len(frames) / dt:.3f} frames/s ({len(data)} bytes) on "
          f"{card}; stage seconds {stages}; deblock kernel launches "
          f"{n_launch}")
    if len(frames) != coded:
        fail(f"decoder {name}: {len(frames)} frames for {coded} coded")
    if any(f.y.shape != (h, w) or f.u.shape != (h // 2, w // 2)
           or f.v.shape != f.u.shape for f in frames):
        fail(f"decoder {name}: cropped frames are not {w}x{h}")
    if n_launch != len(frames):
        fail(f"decoder {name}: deblock kernel launched {n_launch} times for "
             f"{len(frames)} decoded pictures")
    return frames, {"fps": len(frames) / dt, "seconds": dt,
                    "frames": len(frames), "stage_seconds": stages,
                    "deblock_launches": n_launch}


def phase_decoder(dev, card, streams, recons):
    """Phase 8: the decoder on the streams phases 4 and 6 wrote (name ->
    bytes per frame of their first timed run; recons: name -> the
    encoder's reconstruction per frame, device planes). Returns the
    summary and the deblock launches of the timed runs."""
    import torch
    from openh264_tpu_torch.api import WelsCreateDecoder
    from openh264_tpu_torch.decoder import H264Decoder
    from openh264_tpu_torch.decoder.decoder import write_yuv
    # warm-up: first-use costs (allocator, cached constants) stay out of
    # the timed runs
    H264Decoder(device=dev).decode_annexb(b"".join(streams["constqp"][:2]))
    torch.cuda.synchronize()
    out, decoded, launches = {}, {}, 0
    for name, bs in streams.items():
        runs = []
        for _ in range(2 if name == "constqp" else 1):
            frames, run = timed_decode(name, b"".join(bs),
                                       sum(1 for b in bs if b), dev, card)
            runs.append(run)
            launches += run["deblock_launches"]
            decoded.setdefault(name, frames)
        out[name] = {"fps_runs": [r["fps"] for r in runs], "runs": runs}
    # the encoder's own reconstruction: constqp and api_cavlc have
    # deblock idc 0 and chroma QP offset 0 (no reference fault applies)
    for name, recon in recons.items():
        want = [[p.cpu().numpy() for p in r] for r in recon]
        if not same_frames(decoded[name], want):
            fail(f"decoder {name}: frames differ from the encoder's "
                 f"reconstruction")
        print(f"decoder {name}: all {len(want)} frames equal the encoder's "
              f"reconstruction")
    # device busy share over 3 P frames of constqp, after its IDR
    bs = streams["constqp"]
    dec = H264Decoder(device=dev)
    dec.decode_annexb(bs[0])
    out["profile_3p_constqp"] = profile_frames(
        lambda: dec.decode_annexb(b"".join(bs[1:4])), 3, "decoder constqp")
    # then at once, untimed: the CPU decodes, the API, the console
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(streams), mp_context=spawn) as pool:
        jobs = {name: pool.submit(cpu_decode, b"".join(bs[:DEC_CROSS]))
                for name, bs in streams.items()}
        data = b"".join(streams["api_cavlc"])
        with tempfile.TemporaryDirectory() as tmp:
            src, yuv, want_yuv = (os.path.join(tmp, n) for n in (
                "in.264", "out.yuv", "want.yuv"))
            with open(src, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "openh264_tpu_torch.cli.h264dec", src,
                 yuv], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            try:
                api = WelsCreateDecoder(device=dev)
                api.Initialize()
                _state, api_frames = api.DecodeFrameNoDelay(data)
                api_frames += api.FlushFrame()[1]
                if not same_frames(api_frames, decoded["api_cavlc"]):
                    fail("CWelsDecoder's frames differ from H264Decoder's")
                print(f"decoder api: CWelsDecoder gives H264Decoder's "
                      f"{len(api_frames)} frames of api_cavlc")
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            dt = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"h264dec exited {proc.returncode}: {stderr[-2000:]}")
            write_yuv(decoded["api_cavlc"], want_yuv)
            with open(yuv, "rb") as a, open(want_yuv, "rb") as b:
                if a.read() != b.read():
                    fail("h264dec's YUV file differs from the decoder's "
                         "frames")
        fps = [ln.strip() for ln in stdout.splitlines()
               if ln.startswith("FPS:")] or ["(no FPS line)"]
        print(f"decoder cli: h264dec wrote the decoder's frames of api_cavlc "
              f"({dt:.2f} s with start-up, beside the other checks; its "
              f"{fps[0]})")
        out["cli"] = {"seconds_with_startup": dt, "fps_line": fps[0]}
        for name, job in jobs.items():
            frames, secs = job.result()
            if not same_frames(decoded[name][:len(frames)], frames) or \
                    len(frames) < 1:
                fail(f"decoder {name}: CUDA and CPU frames differ")
            print(f"decoder cross-check {name}: CPU decode of {len(frames)} "
                  f"frames ({secs:.2f} s, {CPU_THREADS} torch threads, beside "
                  f"the other checks) equals the CUDA frames")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 9: the decoder's parse layer
# ---------------------------------------------------------------------------
def write_pps_with(p, lists, chroma_offsets) -> bytes:
    """A PPS RBSP with the fields of the parsed PPS `p` (one slice
    group), its chroma QP offsets set to `chroma_offsets` (Cb, Cr) and a
    pic_scaling_matrix that sends the six 4x4 `lists` (zigzag order)."""
    from openh264_tpu_torch.bitstream import BitWriter
    w = BitWriter()
    w.ue(p.pps_id)
    w.ue(p.sps_id)
    w.flag(p.entropy_coding_mode)
    w.flag(p.pic_order_present)
    w.ue(0)                              # num_slice_groups_minus1
    w.ue(p.num_ref_idx_l0_active - 1)
    w.ue(p.num_ref_idx_l1_active - 1)
    w.flag(p.weighted_pred)
    w.u(2, p.weighted_bipred_idc)
    w.se(p.pic_init_qp - 26)
    w.se(p.pic_init_qs - 26)
    w.se(chroma_offsets[0])
    w.flag(p.deblocking_filter_control_present)
    w.flag(p.constrained_intra_pred)
    w.flag(p.redundant_pic_cnt_present)
    w.flag(False)                        # transform_8x8_mode
    w.flag(True)                         # pic_scaling_matrix_present
    for lst in lists:
        w.flag(True)                     # the list is sent
        last = 8
        for v in lst:
            w.se((v - last + 128) % 256 - 128)   # delta_scale
            last = v
    w.se(chroma_offsets[1])
    w.rbsp_trailing_bits()
    return w.get_bytes()


def rewrite_for_parse_layer(data: bytes) -> bytes:
    """`data` (CAVLC, deblock idc 0 with zero offsets, several slices a
    picture) with its PPS rewritten by write_pps_with (seeded lists,
    chroma QP offsets 3 and -2) and each slice header's deblocking
    fields rewritten to idc 2 with alpha/beta offsets that differ from
    slice to slice; the slice data bits follow unchanged. Copied from
    the tests' stream rewrites (tests/test_torch_streams.py), which the
    script does not import."""
    from openh264_tpu_torch.bitstream import (BitReader, BitWriter, NAL_IDR,
                                              NAL_PPS, NAL_SLICE, NAL_SPS,
                                              make_annexb_nal, split_annexb)
    from openh264_tpu_torch.decoder.params import parse_pps, parse_sps
    from openh264_tpu_torch.decoder.slicehdr import parse_slice_header
    rng = np.random.default_rng(REST_SEED)
    lists = [[int(x) for x in rng.integers(4, 65, 16)] for _ in range(6)]
    div2 = [(2, -1), (-3, 3), (6, -6), (-1, 4)]
    sps, pps, out, k = {}, {}, [], 0
    for nal in split_annexb(data):
        rbsp = nal.rbsp
        if nal.nal_unit_type == NAL_SPS:
            sp = parse_sps(rbsp)
            sps[sp.sps_id] = sp
        elif nal.nal_unit_type == NAL_PPS:
            pp = parse_pps(rbsp, sps)
            pps[pp.pps_id] = pp
            rbsp = write_pps_with(pp, lists, (3, -2))
        elif nal.nal_unit_type in (NAL_SLICE, NAL_IDR):
            sh = parse_slice_header(BitReader(rbsp), nal, sps, pps)
            if (sh.disable_deblocking_filter_idc, sh.slice_alpha_c0_offset,
                    sh.slice_beta_offset) != (0, 0, 0):
                fail("parse layer: the stream to rewrite is not deblock "
                     "idc 0 with zero offsets")
            bits = np.unpackbits(np.frombuffer(rbsp, np.uint8))
            bits = bits[:np.flatnonzero(bits)[-1]]   # without the stop bit
            w = BitWriter()
            w.ue(2)                              # disable_deblocking_filter_idc
            for off in div2[k % len(div2)]:      # alpha, beta offset / 2
                w.se(off)
            k += 1
            n_mid = w.nbits
            w.byte_align(0)
            mid = np.unpackbits(np.frombuffer(w.get_bytes(), np.uint8))
            # ue(0) se(0) se(0), the header's last 3 bits, become mid
            pos = sh.header_bits
            new = np.concatenate([bits[:pos - 3], mid[:n_mid], bits[pos:],
                                  [1]]).astype(np.uint8)
            rbsp = np.packbits(new).tobytes()    # zero bits to the byte
        out.append(make_annexb_nal(nal.nal_ref_idc, nal.nal_unit_type, rbsp))
    return b"".join(out)


def fmo_stream(width: int, height: int, seed: int = REST_SEED):
    """A two-slice-group stream built with the port's code, as the tests
    build theirs (tests/test_torch_decoder_pyparse.py): PPS map type 0
    with one MB row a run (groups of alternating rows), an IDR whose
    rows are the port's one-row I16 bands (a band has no top neighbour,
    the availability of interleaved groups) with deblocking off, then a
    P picture whose two group slices are all mb_skip_run. Returns the
    IDR's bytes, the whole stream and the per-row band reconstruction."""
    import torch
    from openh264_tpu_torch.bitstream import (BitWriter, NAL_IDR, NAL_PPS,
                                              NAL_SLICE, NAL_SPS,
                                              make_annexb_nal)
    from openh264_tpu_torch.encoder import core_torch
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.encoder import H264Encoder, _NcTracker
    from openh264_tpu_torch.encoder.headers import (write_slice_header,
                                                    write_sps)
    from openh264_tpu_torch.tables import CHROMA_QP_TABLE
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (height, width), np.uint8)
    u = rng.integers(0, 256, (height // 2, width // 2), np.uint8)
    v = rng.integers(0, 256, (height // 2, width // 2), np.uint8)
    qp = 28
    cfg = EncoderConfig(width=width, height=height, qp=qp)
    enc = H264Encoder(cfg, device="cpu")
    mb_w, mb_h = cfg.mb_width, cfg.mb_height
    w = BitWriter()
    w.ue(0)                     # pps_id
    w.ue(0)                     # sps_id
    w.flag(False)               # entropy_coding_mode (CAVLC)
    w.flag(False)               # pic_order_present
    w.ue(1)                     # num_slice_groups_minus1
    w.ue(0)                     # slice_group_map_type 0
    w.ue(mb_w - 1)              # run_length_minus1, group 0
    w.ue(mb_w - 1)              # run_length_minus1, group 1
    w.ue(0)                     # num_ref_idx_l0_active_minus1
    w.ue(0)
    w.flag(False)               # weighted_pred
    w.u(2, 0)
    w.se(cfg.pic_init_qp - 26)
    w.se(0)
    w.se(0)                     # chroma_qp_index_offset
    w.flag(True)                # deblocking_filter_control_present
    w.flag(False)
    w.flag(False)
    w.rbsp_trailing_bits()
    bs = (make_annexb_nal(3, NAL_SPS, write_sps(cfg)) +
          make_annexb_nal(3, NAL_PPS, w.get_bytes()))
    rows = []
    for r in range(mb_h):
        out = core_torch.encode_i_frame(
            *(torch.from_numpy(p[r * k:(r + 1) * k].copy())
              for p, k in ((y, 16), (u, 8), (v, 8))),
            qp, int(CHROMA_QP_TABLE[qp]), mb_w=mb_w, mb_h=1)
        rows.append({k: a.numpy() for k, a in out.items()})
    for grp in (0, 1):
        w = BitWriter()
        write_slice_header(w, cfg, 2, 0, grp * mb_w, qp, True, 0,
                           disable_deblock=1)
        for r in range(grp, mb_h, 2):
            nc = _NcTracker(mb_w, 1)
            for i in range(mb_w):
                enc._write_i16_mb(w, rows[r], i, nc, p_slice=False)
        w.rbsp_trailing_bits()
        bs += make_annexb_nal(3, NAL_IDR, w.get_bytes())
    idr = bs
    for grp, n in ((0, (mb_h + 1) // 2 * mb_w), (1, mb_h // 2 * mb_w)):
        w = BitWriter()
        write_slice_header(w, cfg, 0, 1, grp * mb_w, qp, False, 0,
                           disable_deblock=1)
        w.ue(n)                 # mb_skip_run over the whole group
        w.rbsp_trailing_bits()
        bs += make_annexb_nal(2, NAL_SLICE, w.get_bytes())
    recon = [np.concatenate([r[k] for r in rows], 0)
             for k in ("recon_y", "recon_u", "recon_v")]
    return idr, bs, recon


def phase_parse_layer(dev, card, cabac, recon, rc_stream):
    """Phase 9: the decoder's parse layer on the card. cabac: phase 7's
    CABAC runs (name -> bytes per frame), recon: api_cabac's
    reconstruction per frame (device planes), rc_stream: phase 4's
    rc_4slice_2tid bytes per frame. The CPU decodes run in worker
    processes while the card decodes. Returns the summary and the
    deblock launches of the card's decodes."""
    from openh264_tpu_torch.api import WelsCreateDecoder
    from openh264_tpu_torch.decoder import H264Decoder
    from openh264_tpu_torch.encoder import deblock_cuda
    t0 = time.perf_counter()
    inputs = {name: b"".join(bs) for name, bs in cabac.items()}
    coded = {name: sum(1 for b in bs if b) for name, bs in cabac.items()}
    inputs["scaling_idc2_offsets"] = rewrite_for_parse_layer(
        b"".join(rc_stream[:DEC_CROSS]))
    coded["scaling_idc2_offsets"] = DEC_CROSS
    fmo_idr, inputs["fmo"], fmo_recon = fmo_stream(FMO_W, FMO_H)
    coded["fmo"] = 2
    print(f"parse layer: streams written in {time.perf_counter() - t0:.2f} "
          f"s: { {k: len(v) for k, v in inputs.items()} } bytes")
    cross = {name: (data if name in ("scaling_idc2_offsets", "fmo") else
                    b"".join(cabac[name][:DEC_CROSS]))
             for name, data in inputs.items()}
    spawn = multiprocessing.get_context("spawn")
    out, decoded, launches = {}, {}, 0
    with ProcessPoolExecutor(len(cross), mp_context=spawn) as pool:
        jobs = {name: pool.submit(cpu_decode, data)
                for name, data in cross.items()}
        for name, data in inputs.items():
            size = (FMO_W, FMO_H) if name == "fmo" else (W720, H720)
            frames, run = timed_decode(name, data, coded[name], dev, card,
                                       size)
            launches += run["deblock_launches"]
            decoded[name] = frames
            out[name] = run
        # the port decodes its own CABAC to its encoder's pictures
        want = [[p.cpu().numpy() for p in r] for r in recon["api_cabac"]]
        if not same_frames(decoded["api_cabac"], want):
            fail("parse layer api_cabac: frames differ from the encoder's "
                 "reconstruction")
        print(f"parse layer api_cabac: all {len(want)} frames equal the "
              f"encoder's reconstruction")
        api = WelsCreateDecoder(device=dev)
        api.Initialize()
        _state, api_frames = api.DecodeFrameNoDelay(inputs["api_cabac"])
        api_frames += api.FlushFrame()[1]
        if not same_frames(api_frames, decoded["api_cabac"]):
            fail("parse layer: CWelsDecoder's frames of api_cabac differ "
                 "from H264Decoder's")
        print(f"parse layer api: CWelsDecoder gives H264Decoder's "
              f"{len(api_frames)} frames of api_cabac")
        if not same_frames(decoded["fmo"][:1], [fmo_recon]) or \
                not same_frames(decoded["fmo"][1:], decoded["fmo"][:1]):
            fail("parse layer fmo: the IDR is not the per-row "
                 "reconstruction, or the skipped P picture not its copy")
        print("parse layer fmo: the IDR equals the per-row reconstruction "
              "and the skipped P picture copies it")
        # the Python parser's seconds per MB, on the IDR alone
        dec = H264Decoder(device=dev, stage_times=True)
        n0 = deblock_cuda.launches
        if len(dec.decode_annexb(fmo_idr)) != 1 or \
                deblock_cuda.launches - n0 != 1:
            fail("parse layer fmo: the IDR alone did not decode to one "
                 "deblocked picture")
        launches += 1
        n_mb = (FMO_W // 16) * (FMO_H // 16)
        out["fmo"]["python_parse_ms_per_mb"] = \
            1e3 * dec.stage_seconds["parse"] / n_mb
        print(f"parse layer fmo: the Python CAVLC parser took "
              f"{out['fmo']['python_parse_ms_per_mb']:.3f} ms per MB over "
              f"the IDR's {n_mb} I16x16 MBs on {card}")
        for name, job in jobs.items():
            frames, secs = job.result()
            if len(frames) < 1 or \
                    not same_frames(decoded[name][:len(frames)], frames):
                fail(f"parse layer {name}: CUDA and CPU frames differ")
            print(f"parse layer cross-check {name}: CPU decode of "
                  f"{len(frames)} frames ({secs:.2f} s, {CPU_THREADS} torch "
                  f"threads, beside the card's decodes) equals the CUDA "
                  f"frames")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 10: B pictures and the 8x8 transform
# ---------------------------------------------------------------------------
MB_NAMES = ("I4x4", "I16x16", "IPCM", "I8x8", "P16x16", "P16x8", "P8x16",
            "P8x8", "P_Skip", "B16x16", "B16x8", "B8x16", "B8x8", "B_Skip",
            "B_Direct")


class DecodeProbe:
    """While active, records per decoded picture its correctly decoded
    MB types and 8x8-transform flags and the seconds of its recon (device
    synchronized), and the seconds and MBs of the per-MB Python CAVLC
    parser; restores the decoder's functions on exit."""

    def __enter__(self):
        import torch
        import openh264_tpu_torch.decoder.decoder as dm
        import openh264_tpu_torch.decoder.slice_dec as sd
        self.pics, self.py_parse_s, self.py_parse_mbs = [], 0.0, 0
        self._saved = ((dm, "recon_frame_batch", dm.recon_frame_batch),
                       (sd, "decode_slice_mbs_cavlc",
                        sd.decode_slice_mbs_cavlc))
        recon, parse = self._saved[0][2], self._saved[1][2]

        def timed_recon(fs, *a, **k):
            t0 = time.perf_counter()
            st = recon(fs, *a, **k)
            torch.cuda.synchronize()
            ok = fs.mb_correct
            self.pics.append((fs.mb_type[ok].copy(), fs.transform8[ok].copy(),
                              time.perf_counter() - t0))
            return st

        def timed_parse(br, ctx):
            t0 = time.perf_counter()
            end = parse(br, ctx)
            self.py_parse_s += time.perf_counter() - t0
            self.py_parse_mbs += end - ctx.sh.first_mb_in_slice
            return end
        dm.recon_frame_batch = timed_recon
        sd.decode_slice_mbs_cavlc = timed_parse
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def histogram(self):
        types = np.concatenate([t for t, _, _ in self.pics])
        return {MB_NAMES[k]: int(c) for k, c in
                zip(*np.unique(types, return_counts=True))}

    def reached(self):
        """(B MBs, I8x8 MBs, 8x8-transform inter MBs) reached."""
        types = np.concatenate([t for t, _, _ in self.pics])
        t8 = np.concatenate([f for _, f, _ in self.pics])
        return (int((types >= 9).sum()), int((types == 3).sum()),
                int((t8 & (types >= 4)).sum()))


def phase_b_t8(dev, card, cabac):
    """Phase 10: B pictures and the 8x8 transform on the card, on two
    streams written with the tests' stream writers
    (tests/test_torch_streams.py, which imports nothing of JAX):
    b_t8_cabac, api_cabac's IDR and first P (phase 7) under a High SPS of
    POC type 0, then under a second PPS (transform_8x8_mode, sent 4x4 and
    8x8 scaling lists, implicit weights) a P, an I and two B pictures
    (spatial, then temporal direct) of seeded random CABAC bins that the
    port's parser steers on the host, 5 slices each, at 720p; and
    b_t8_cavlc, CAVLC IDR/P pictures of the port's encoder and two B
    pictures from the hand MB writer (every B MB kind, I8x8, inter MBs
    with the 8x8 transform, explicit weights, scaling lists) at 176x144,
    which the per-MB Python parser decodes. Each is decoded once on the
    card (frames/s, seconds per stage, one deblock launch per picture,
    the MB types reached, the recon seconds of pictures with I8x8 MBs,
    whose intra MBs run in host Python) and must equal a CPU decode in a
    worker process that runs beside. Returns the summary and the deblock
    launches of the card's decodes."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_streams import b_stream, steered_cabac_stream
    t0 = time.perf_counter()
    inputs = {"b_t8_cavlc": b_stream(idc=1, scaling=True, w=B_W, h=B_H,
                                     seed=B_SEED)[0]}
    t_cavlc = time.perf_counter() - t0
    t0 = time.perf_counter()
    inputs["b_t8_cabac"] = steered_cabac_stream(
        b"".join(cabac["api_cabac"][:2]), idc=2, scaling=True, seed=B_SEED,
        rows_per_slice=9)
    t_cabac = time.perf_counter() - t0
    print(f"b/8x8: streams written, b_t8_cavlc in {t_cavlc:.2f} s, "
          f"b_t8_cabac (4 steered 720p pictures, host CPU) in "
          f"{t_cabac:.2f} s: { {k: len(v) for k, v in inputs.items()} } "
          f"bytes")
    coded = {"b_t8_cavlc": 5, "b_t8_cabac": 6}
    sizes = {"b_t8_cavlc": (B_W, B_H), "b_t8_cabac": (W720, H720)}
    spawn = multiprocessing.get_context("spawn")
    out, launches = {"stream_write_seconds": {"b_t8_cavlc": t_cavlc,
                                              "b_t8_cabac": t_cabac}}, 0
    decoded = {}
    with ProcessPoolExecutor(len(inputs), mp_context=spawn) as pool:
        jobs = {name: pool.submit(cpu_decode, data)
                for name, data in inputs.items()}
        for name, data in inputs.items():
            with DecodeProbe() as probe:
                frames, run = timed_decode(name, data, coded[name], dev,
                                           card, sizes[name])
            launches += run["deblock_launches"]
            if run["deblock_launches"] != len(probe.pics):
                fail(f"b/8x8 {name}: {run['deblock_launches']} deblock "
                     f"launches for {len(probe.pics)} pictures")
            n_b, n_i8, n_t8 = probe.reached()
            run["mb_types"] = probe.histogram()
            run["reached"] = {"B": n_b, "I8x8": n_i8, "t8_inter": n_t8}
            print(f"b/8x8 {name}: correctly decoded MB types "
                  f"{run['mb_types']}; 8x8-transform inter MBs {n_t8}")
            if not (n_b and n_i8 and n_t8):
                fail(f"b/8x8 {name}: no B MB, no I8x8 MB or no inter MB "
                     f"with the 8x8 transform was reached")
            i8 = [s for t, _, s in probe.pics if (t == 3).any()]
            run["recon_ms_per_i8x8_picture"] = 1e3 * float(np.mean(i8))
            print(f"b/8x8 {name}: recon of the {len(i8)} pictures with "
                  f"I8x8 MBs (intra MBs in host Python, inter on the card) "
                  f"{run['recon_ms_per_i8x8_picture']:.1f} ms each on "
                  f"{card}")
            if probe.py_parse_mbs:
                run["python_parse_ms_per_mb"] = \
                    1e3 * probe.py_parse_s / probe.py_parse_mbs
                print(f"b/8x8 {name}: the Python CAVLC parser took "
                      f"{run['python_parse_ms_per_mb']:.3f} ms per MB over "
                      f"{probe.py_parse_mbs} MBs of B slices on {card}")
            decoded[name] = frames
            out[name] = run
        for name, job in jobs.items():
            frames, secs = job.result()
            if not same_frames(decoded[name], frames):
                fail(f"b/8x8 {name}: CUDA and CPU frames differ")
            print(f"b/8x8 cross-check {name}: CPU decode of {len(frames)} "
                  f"frames ({secs:.2f} s, {CPU_THREADS} torch threads, "
                  f"beside the card's decodes) equals the CUDA frames")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 11: slice-parallel encoding
# ---------------------------------------------------------------------------
def sp_config():
    from openh264_tpu_torch.encoder.config import EncoderConfig
    return EncoderConfig(width=W720, height=H720, qp=28, num_slices=SP_SLICES)


def cpu_slice_parallel(frames):
    """In a worker process: the bytes of `frames` from
    SliceParallelEncoder(sp_config(), ["cpu"] * SP_SLICES), and their
    seconds."""
    import torch
    torch.set_num_threads(CPU_THREADS)
    sys.path.insert(0, str(ROOT))
    from openh264_tpu_torch.parallel import SliceParallelEncoder
    t0 = time.perf_counter()
    spe = SliceParallelEncoder(sp_config(), ["cpu"] * SP_SLICES)
    return [spe.encode_frame(*f) for f in frames], time.perf_counter() - t0


def phase_slice_parallel(dev, card):
    """Phase 11: SliceParallelEncoder on SP_SLICES bands, every band on
    cuda:0, over SP_FRAMES frames of 720p content, one timed run whose
    deblock launches must equal its frames; its bytes against
    H264Encoder(num_slices=SP_SLICES) on the card, timed next on the same
    frames. Then, untimed: its stream decoded on the card against its DPB
    planes, beside a CPU SliceParallelEncoder of the first SP_CROSS
    frames in a worker process (started after the timed runs, so that it
    takes no host time from them). Returns the summary and the timed
    run's deblock launches."""
    import torch
    from openh264_tpu_torch.decoder import H264Decoder
    from openh264_tpu_torch.encoder import deblock_cuda
    from openh264_tpu_torch.parallel import SliceParallelEncoder
    fr = frames_720p(SP_FRAMES, seed=REST_SEED)
    devices = [f"{dev}:0"] * SP_SLICES
    spe = SliceParallelEncoder(sp_config(), devices)
    bs, secs, recon = [], [], []
    deblock_cuda.launches = 0
    t0 = time.perf_counter()
    for f in fr:
        t1 = time.perf_counter()
        bs.append(spe.encode_frame(*f))
        secs.append(time.perf_counter() - t1)
        recon.append([p.clone() for p in spe.dpb[-1].planes])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = deblock_cuda.launches
    run = {"fps": SP_FRAMES / dt, "seconds": dt, "idr_s": secs[0],
           "p_s": secs[1:], "p_s_median": statistics.median(secs[1:]),
           "bytes": sum(map(len, bs)), "deblock_launches": launches}
    print(f"slice parallel: {SP_FRAMES} frames {W720}x{H720} in {dt:.3f} s "
          f"= {run['fps']:.3f} frames/s ({run['bytes']} bytes, slice NALs "
          f"per frame {[b.count(b'\x00\x00\x00\x01') for b in bs]}) on "
          f"{SP_SLICES} bands on {devices[0]}, {card}; IDR {secs[0]:.3f} s, "
          f"P {[round(t, 3) for t in secs[1:]]} s (median "
          f"{run['p_s_median']:.3f}); deblock kernel launches {launches}")
    if launches != SP_FRAMES:
        fail(f"slice parallel: deblock kernel launched {launches} times for "
             f"{SP_FRAMES} frames")
    if not all(p.is_cuda for r in recon for p in r):
        fail("slice parallel: the DPB left the card")
    want, ms_run = _timed_host_run(
        f"H264Encoder(num_slices={SP_SLICES})", "host",
        dict(qp=28, num_slices=SP_SLICES), dev, fr, card,
        phase="slice parallel")
    run["multislice"] = ms_run
    print(f"slice parallel: {run['fps']:.3f} frames/s against "
          f"H264Encoder(num_slices={SP_SLICES})'s {ms_run['fps']:.3f} in "
          f"this call ({run['fps'] / ms_run['fps']:.3f}x)")
    if bs != want:
        fail(f"slice parallel: bytes differ from H264Encoder(num_slices="
             f"{SP_SLICES}) on the card")
    print(f"slice parallel: bytes equal H264Encoder(num_slices={SP_SLICES})'s "
          f"on the card")
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=spawn) as pool:
        job = pool.submit(cpu_slice_parallel, fr[:SP_CROSS])
        deblock_cuda.launches = 0
        t0 = time.perf_counter()
        frames = H264Decoder(device=dev).decode_annexb(b"".join(bs))
        torch.cuda.synchronize()
        run["decode_s"] = time.perf_counter() - t0
        got = [f.planes() for f in frames]
        want_planes = [[p.cpu().numpy() for p in r] for r in recon]
        if not same_frames(got, want_planes):
            fail(f"slice parallel: the card's decode ({len(got)} frames) "
                 f"differs from the encoder's DPB planes")
        print(f"slice parallel: H264Decoder(device={dev!r}) decoded "
              f"{len(got)} frames in {run['decode_s']:.3f} s (deblock "
              f"launches {deblock_cuda.launches}), each equal to the "
              f"encoder's DPB planes")
        cpu_bs, cpu_s = job.result()
    if cpu_bs != bs[:SP_CROSS]:
        fail("slice parallel: CUDA and CPU streams differ")
    print(f"slice parallel cross-check: CPU bands encoded {SP_CROSS} frames "
          f"in {cpu_s:.2f} s ({CPU_THREADS} torch threads, beside the "
          f"card's decode), byte-identical to the card's")
    run["cpu_cross_s"] = cpu_s
    return run, launches


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

    # nvcc and cc at once, one thread each
    host_c = tuple(_build.SIGNATURES)
    with ThreadPoolExecutor(1 + len(host_c)) as ex:
        builds = list(ex.map(_build.build, ("deblock",) + host_c))
    print(f"build deblock: {builds[0][0]:.2f} s\n{builds[0][1].strip()}")
    for name, (secs, log) in zip(host_c, builds[1:]):
        print(f"build {name} (host C, cc): {secs:.2f} s {log.strip()}")

    t0 = time.perf_counter()
    kern = phase_kernels(dev)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_path, launches, streams, recons = phase_main_path(dev, card)
    print(f"phase main path: {time.perf_counter() - t0:.1f} s")
    if launches == 0:
        fail("the main path never launched the deblock kernel")
    t0 = time.perf_counter()
    phase_cross_check(dev)
    print(f"phase cross-check: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    host_path, host_launches, host_streams, host_recons = \
        phase_host_encoder(dev, card)
    streams.update(host_streams)
    recons.update(host_recons)
    print(f"phase host encoder: {time.perf_counter() - t0:.1f} s")
    if host_launches == 0:
        fail("the host encoder path never launched the deblock kernel")
    t0 = time.perf_counter()
    rest, rest_launches, cabac, cabac_recon = phase_rest(dev, card)
    print(f"phase rest: {time.perf_counter() - t0:.1f} s")
    if rest_launches == 0:
        fail("the phase 7 paths never launched the deblock kernel")
    t0 = time.perf_counter()
    decoder, dec_launches = phase_decoder(dev, card, streams, recons)
    print(f"phase decoder: {time.perf_counter() - t0:.1f} s")
    if dec_launches == 0:
        fail("the decoder never launched the deblock kernel")
    t0 = time.perf_counter()
    parse_layer, parse_launches = phase_parse_layer(
        dev, card, cabac, cabac_recon, streams["rc_4slice_2tid"])
    parse_layer["seconds"] = time.perf_counter() - t0
    print(f"phase decoder parse layer: {parse_layer['seconds']:.1f} s")
    if parse_launches == 0:
        fail("the decoder's parse layer never launched the deblock kernel")
    t0 = time.perf_counter()
    b_t8, b_launches = phase_b_t8(dev, card, cabac)
    b_t8["seconds"] = time.perf_counter() - t0
    print(f"phase decoder B / 8x8: {b_t8['seconds']:.1f} s")
    if b_launches == 0:
        fail("the decoder's B / 8x8 path never launched the deblock kernel")
    t0 = time.perf_counter()
    sp, sp_launches = phase_slice_parallel(dev, card)
    sp["phase_seconds"] = time.perf_counter() - t0
    print(f"phase slice parallel: {sp['phase_seconds']:.1f} s")
    kern["launches"] = launches + host_launches + rest_launches + \
        dec_launches + parse_launches + b_launches + sp_launches
    kern["launches_by_phase"] = {"main path": launches,
                                 "host encoder": host_launches,
                                 "rest": rest_launches,
                                 "decoder": dec_launches,
                                 "decoder parse layer": parse_launches,
                                 "decoder B / 8x8": b_launches,
                                 "slice parallel": sp_launches}
    print(f"main path summary: "
          f"{json.dumps({'card': card, 'configs': main_path})}")
    print(f"host encoder summary: "
          f"{json.dumps({'card': card, 'configs': host_path})}")
    print(f"rest summary: {json.dumps({'card': card, 'configs': rest})}")
    print(f"decoder summary: "
          f"{json.dumps({'card': card, 'streams': decoder})}")
    print(f"decoder parse layer summary: "
          f"{json.dumps({'card': card, 'streams': parse_layer})}")
    print(f"decoder B / 8x8 summary: "
          f"{json.dumps({'card': card, 'streams': b_t8})}")
    print(f"slice parallel summary: "
          f"{json.dumps({'card': card, 'run': sp})}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
