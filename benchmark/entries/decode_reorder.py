"""H264Decoder(device="cuda").feed_annexb, one access unit per call, over
a configuration's committed stream whose pictures come out in another
order than they go in: B pictures, reference B pictures, several
reference pictures.

The GOPs follow one another in seeded laps, as in decode_feed (gop_laps);
set-up feeds the first `warmup_aus` access units. Every picture the
decoder returns is matched to (lap, GOP, POC): its lap and GOP from the
coded video sequence it belongs to (DecodedFrame.cvs counts the IDRs
decoded, and each GOP fed starts with one), its POC from the picture.
The check decodes, with the plain reference in worker processes,
chains of the first `chain_pictures` access units of a GOP fed, from its
IDR, for each GOP fed whose chain holds access units fed in the window,
and holds every picture of the chain against the program's picture of
the same (lap, GOP, POC). A picture of a chain that the program should
have returned by the window's end and did not, and a (lap, GOP, POC)
returned twice, are reference errors.

The traced run works as decode_feed's: stage times over the first
`staged_share` of the window, with the port's span recorder on there
(rec["spans"], rec["counters"] from its drain), then a profiled
sub-window, then the rest of the window.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import chains, compare, profiling, streams
from benchmark.entries.decode_feed import gop_laps
from benchmark.streams import nal_units


class State:
    pass


def setup(cell):
    from openh264_tpu_torch.decoder import H264Decoder
    s = State()
    s.cell = cell
    s.gops, _ = streams.load(cell.config["stream"])
    s.param_sets = b"".join(n for t, n in nal_units(s.gops[0][0])
                            if t not in streams.SLICE_NAL_TYPES)
    k = cell.limits["chain_pictures"]
    # the POCs a chain of each GOP holds
    s.chain_pocs = [set(chains.stream_pocs(g[:k])) for g in s.gops]
    s.order = gop_laps(len(s.gops), np.random.default_rng(cell.seed))
    s.fed = []          # (GOP instance, index in its GOP) of each call
    s.call_s = []       # the seconds of each call
    s.gop_of = []       # the GOP of each instance, in the order fed
    s.aus = _aus(s)
    s.pictures = {}     # (instance, POC) -> planes, of chain pictures
    s.last_poc = {}     # instance -> the largest POC returned
    s.returned = set()  # (instance, POC) of every picture returned
    s.twice = []        # those returned again
    s.dec = H264Decoder(device=cell.device)
    for _ in range(cell.mix["warmup_aus"]):
        _feed(s)
    cell.sync()
    s.warm = len(s.fed)
    return s


def _aus(s):
    for g in s.order:
        s.gop_of.append(g)
        inst = len(s.gop_of) - 1
        for i, au in enumerate(s.gops[g]):
            yield inst, i, au


def _feed(s):
    """Feeds the next access unit; returns (seconds of the call, number
    of pictures it returned)."""
    inst, i, au = next(s.aus)
    t0 = time.perf_counter()
    out = s.dec.feed_annexb(au)
    dt = time.perf_counter() - t0
    s.fed.append((inst, i))
    s.call_s.append(dt)
    for f in out:
        if (f.cvs, f.poc) in s.returned:
            s.twice.append((f.cvs, f.poc))
        s.returned.add((f.cvs, f.poc))
        s.last_poc[f.cvs] = max(s.last_poc.get(f.cvs, f.poc), f.poc)
        if f.poc in s.chain_pocs[s.gop_of[f.cvs]]:
            s.pictures[(f.cvs, f.poc)] = f.planes()
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
    from openh264_tpu_torch.utils import trace as spans
    tr = s.cell.mix["trace"]
    s.dec.stage_times = True
    s.dec.stage_seconds = dict.fromkeys(s.dec.stage_seconds, 0.0)
    spans.enable()
    try:
        _run(s, seconds * tr["staged_share"], t0, lat)
    finally:
        spans.disable()
    rec["spans"], rec["counters"] = spans.drain()
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
    rec["profiled_frames"] = len(lat) - n0
    rec["diagnostics"] = {"deblock_launches": launches}
    _run(s, seconds, t0, lat)
    rec["window_s"] = time.perf_counter() - t0
    return rec


def jobs(s):
    """The chains to check: (instance, chain_job arguments), for every
    GOP instance fed whose first `chain_pictures` access units include
    one fed in the window, at most compare.MAX_WORKERS of them, drawn
    from the seed."""
    k = s.cell.limits["chain_pictures"]
    insts = sorted({inst for inst, i in s.fed[s.warm:] if i < k})
    if len(insts) > compare.MAX_WORKERS:
        rng = np.random.default_rng([s.cell.seed, 1])
        insts = sorted(int(x) for x in rng.choice(insts, compare.MAX_WORKERS,
                                                  replace=False))
    out = []
    for inst in insts:
        n = sum(1 for j, i in s.fed if j == inst and i < k)
        aus = s.gops[s.gop_of[inst]][:n]
        gots = {poc: p for (j, poc), p in s.pictures.items() if j == inst}
        out.append((inst, ([s.param_sets + aus[0]] + aus[1:], gots)))
    return out


def expected(s, inst: int, pocs) -> set:
    """The POCs among `pocs` that the program should have returned by
    the window's end: those up to the largest it returned of the
    instance, all of them once it returned a later instance's."""
    if any(j > inst for j in s.last_poc):
        return set(pocs)
    last = s.last_poc.get(inst)
    return {p for p in pocs if last is not None and p <= last}


def close(s):
    """After the window the program's state goes."""
    s.dec = None


def check(s, rec):
    """[(name, value, limit, ok)], the reference's errors and the number
    of pictures found wrong. The control: the reference without its
    deblocking filter takes the program's place."""
    todo = jobs(s)
    res = compare.run_jobs(
        chains.chain_control_job if s.cell.control else chains.chain_job,
        [j for _, j in todo])
    lim = s.cell.limits["max_abs_diff"]
    n_gops = len(s.gops)

    def where(inst):
        return f"lap {inst // n_gops} GOP {s.gop_of[inst]}"
    errors = [f"{where(i)}: POC {poc} returned twice" for i, poc in s.twice]
    worst = 256 if not todo else 0
    bad = n = 0
    for (inst, (aus, gots)), (d, m, e) in zip(todo, res):
        missing = sorted(expected(s, inst, chains.stream_pocs(aus))
                         - set(gots))
        if missing and not e:
            e = f"{where(inst)}: POC {missing} never returned"
        if e:
            errors.append(e)
        worst = max(worst, d)
        n += m
        bad += m if (d > lim or e) else 0
    diag = rec.setdefault("diagnostics", {})
    diag["chains"] = [f"{where(inst)}: {len(j[0])} access units"
                      for inst, j in todo]
    # each window call's (GOP, index in it, seconds)
    diag["calls"] = [(s.gop_of[inst], i, round(dt, 3)) for (inst, i), dt
                     in zip(s.fed[s.warm:], s.call_s[s.warm:])]
    return [("max_abs_diff", worst, lim, worst <= lim),
            ("pictures_checked", n, 1, n >= 1),
            ("reference_errors", len(errors), 0, not errors)], errors, bad
