"""H264Decoder(device="cuda").feed_annexb, one access unit per call, over
a configuration's committed stream.

The GOPs follow one another in laps, each lap a permutation of the
stream's closed GOPs drawn from the seed, with no GOP twice in a row.
The seed varies the order of the GOPs, never the pictures. Set-up
decodes the first GOP's first `warmup_aus` access units (one IDR and one P picture come out: the
decoder returns a picture when the next one's slice arrives).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import compare, profiling, streams
from benchmark.streams import nal_units

SLICE_TYPES = streams.SLICE_NAL_TYPES


def gop_laps(n_gops: int, rng):
    """GOP indices, lap after lap, each lap a permutation of the GOPs,
    no GOP twice in a row."""
    last = -1
    while True:
        lap = rng.permutation(n_gops)
        if n_gops > 1 and lap[0] == last:
            k = int(rng.integers(1, n_gops))
            lap[0], lap[k] = lap[k], lap[0]
        yield from (int(g) for g in lap)
        last = int(lap[-1])


class State:
    pass


def setup(cell):
    from openh264_tpu_torch.decoder import H264Decoder
    s = State()
    s.cell = cell
    s.gops, _ = streams.load(cell.config["stream"])
    first = s.gops[0][0]
    s.param_sets = b"".join(n for t, n in nal_units(first)
                            if t not in SLICE_TYPES)
    order = gop_laps(len(s.gops), np.random.default_rng(cell.seed))
    s.aus = ((g, au) for g_ in order for g, au in
             ((g_, a) for a in s.gops[g_]))
    s.fed = []          # (gop, access unit) of each call, in order
    s.pictures = []     # planes of each picture returned, in order
    s.dec = H264Decoder(device=cell.device)
    for _ in range(cell.mix["warmup_aus"]):
        _feed(s)
    cell.sync()
    s.warm = len(s.pictures)
    return s


def _feed(s):
    """Feeds the next access unit; returns (seconds of the call, number
    of pictures it returned)."""
    g, au = next(s.aus)
    t0 = time.perf_counter()
    out = s.dec.feed_annexb(au)
    dt = time.perf_counter() - t0
    s.fed.append((g, au))
    s.pictures += [f.planes() for f in out]
    return dt, len(out)


def _run(s, seconds, t0, lat):
    while time.perf_counter() - t0 < seconds:
        dt, n = _feed(s)
        lat += [dt] * n


def window(s, seconds: float, trace: bool) -> dict:
    lat: list[float] = []
    rec = {"side": "decode", "latencies": lat}
    t0 = time.perf_counter()
    if not trace:
        _run(s, seconds, t0, lat)
        rec["window_s"] = time.perf_counter() - t0
        return rec
    tr = s.cell.mix["trace"]
    s.dec.stage_times = True
    s.dec.stage_seconds = dict.fromkeys(s.dec.stage_seconds, 0.0)
    _run(s, seconds * tr["staged_share"], t0, lat)
    rec["stage_seconds"] = dict(s.dec.stage_seconds)
    rec["staged_frames"] = len(lat)
    s.dec.stage_times = False
    n0 = len(lat)

    def block():
        t1 = time.perf_counter()
        while (time.perf_counter() - t1 < tr["profile_s"]
               or len(lat) - n0 < tr["profile_min_frames"]):
            dt, n = _feed(s)
            lat.extend([dt] * n)
    _, rec["trace"], launches = profiling.capture(block, "decode_window")
    # each picture is deblocked in the call that returns it
    rec["profiled_frames"] = len(lat) - n0
    rec["diagnostics"] = {"deblock_launches": launches}
    _run(s, seconds, t0, lat)
    rec["window_s"] = time.perf_counter() - t0
    return rec


def jobs(s):
    """The reference's decode jobs (compare.decode_job), drawn from the
    seed: first one chain of `chain_pictures` pictures from an IDR, which
    the reference decodes on its own (an IDR whose chain holds a picture
    of the window), then `sample_pictures` P pictures of the window
    outside it, each decoded from the program's previous picture."""
    rng = np.random.default_rng([s.cell.seed, 1])
    k = s.cell.limits["chain_pictures"]
    n = len(s.pictures)
    idr = [streams.is_idr(au) for _, au in s.fed[:n]]
    starts = [i for i in range(n - k + 1) if idr[i] and i + k > s.warm]
    chain = []
    if starts:
        g = int(rng.choice(starts))
        chain = list(range(g, g + k))
    steps = [i for i in range(s.warm, n) if not idr[i] and i not in chain]
    pick = rng.choice(steps, min(s.cell.limits["sample_pictures"],
                                 len(steps)), replace=False)
    out = [(s.param_sets, [s.fed[i][1] for i in chain], None,
            [s.pictures[i] for i in chain])] if chain else []
    return out + [(s.param_sets, [s.fed[i][1]], s.pictures[i - 1],
                   [s.pictures[i]]) for i in sorted(int(x) for x in pick)]


def close(s):
    """After the window the program's state goes."""
    s.dec = None


def check(s, rec):
    """[(name, value, limit, ok)], the reference's errors and the number
    of pictures found wrong. The control: the reference without its
    deblocking filter takes the program's place."""
    todo = jobs(s)
    res = compare.run_jobs(
        compare.decode_control_job if s.cell.control else compare.decode_job,
        todo)
    worst = max((d for d, _ in res), default=256)
    errors = [e for _, e in res if e]
    lim = s.cell.limits["max_abs_diff"]
    bad = sum(len(j[1]) for j, (d, e) in zip(todo, res) if d > lim or e)
    n = sum(len(j[1]) for j in todo)
    return [("max_abs_diff", worst, lim, worst <= lim),
            ("pictures_checked", n, 1, n >= 1),
            ("reference_errors", len(errors), 0, not errors)], errors, bad
