"""The comparisons that decide `correct`, run after the window in worker
processes on the host CPU (the reference never touches the card).

Each job decodes access units with the plain reference decoder
(benchmark/reference) and compares what the program returned or wrote:
- `decode_job`: a run of access units, the first decoded from the
  program's previous picture (a step) or from nothing (an IDR, which
  starts a chain the reference decodes on its own), each later one from
  the reference's picture before it, against the program's pictures:
  the largest sample difference, exact;
- `encode_job`: the program's access units from its last IDR through
  its last picture, decoded in one chain; the last picture against the
  encoder's own reconstruction of it: the largest sample difference,
  exact (a drift anywhere in the chain shows there). Each picture's
  mean squared error against the source frame handed in is kept as a
  diagnostic.
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

MAX_WORKERS = 7


def _planes_diff(a, b) -> int:
    return max(int(np.abs(x.astype(np.int16) - y.astype(np.int16)).max())
               if x.shape == y.shape else 256 for x, y in zip(a, b))


def _decode_run(param_sets, aus, ref, deblock=True):
    """The reference's pictures of `aus`, the first decoded from `ref`
    (None: it is an IDR) and each later one from the one before."""
    from benchmark.reference import PlainDecoder
    dec = PlainDecoder(deblock=deblock)
    return [dec.decode_au(param_sets + au if i == 0 else au,
                          ref=ref if i == 0 else None)
            for i, au in enumerate(aus)]


def decode_job(args):
    """(param_sets, aus, ref, gots) -> (largest sample difference between
    the reference's pictures of `aus` and the program's `gots`, error
    text). param_sets: the SPS/PPS bytes; ref: the program's picture
    before the first (a step), or None when the first is an IDR (a chain
    that the reference decodes on its own)."""
    param_sets, aus, ref, gots = args
    try:
        want = _decode_run(param_sets, aus, ref)
    except Exception as e:                    # a reference that cannot
        return 256, f"{type(e).__name__}: {e}"  # decode it judges it bad
    return max(_planes_diff(w, g) for w, g in zip(want, gots)), ""


def decode_control_job(args):
    """decode_job with the control in the program's place: the reference
    without its deblocking filter, which breaks the configurations'
    deblocking guarantee."""
    param_sets, aus, ref, _gots = args
    try:
        ctl = _decode_run(param_sets, aus, ref, deblock=False)
    except Exception as e:
        return 256, f"{type(e).__name__}: {e}"
    return decode_job((param_sets, aus, ref, ctl))


def encode_job(args):
    """(aus, sources, recon) -> (per-picture MSE against its source,
    largest sample difference between the last picture and `recon`,
    error text). aus: the program's access units from an IDR (b"" for a
    frame that rate control skipped); sources: the frames handed in;
    recon: the encoder's (y, u, v) reconstruction of the last picture,
    MB-aligned."""
    from benchmark.reference import PlainDecoder
    aus, sources, recon = args
    dec = PlainDecoder()
    out = []
    try:
        for au, src in zip(aus, sources):
            if not au:
                continue
            pic = dec.decode_au(au)
            se = sum(float(((p.astype(np.int32) - s.astype(np.int32)) ** 2
                            ).sum()) for p, s in zip(pic, src))
            out.append(se / sum(s.size for s in src))
    except Exception as e:
        return out, 256, f"{type(e).__name__}: {e}"
    if dec.prev is None:
        return out, 256, "no picture to hold against the reconstruction"
    # both MB-aligned: the reference's last picture before its cropping
    return out, _planes_diff(dec.prev, recon), ""


def run_jobs(fn, jobs):
    """fn over jobs in spawned worker processes (as many as the host's
    cores allow), results in the order of jobs; the first job starts
    first, so the longest goes first."""
    if not jobs:
        return []
    n = max(1, min(MAX_WORKERS, (os.cpu_count() or 2) - 1, len(jobs)))
    if n == 1:
        return [fn(j) for j in jobs]
    pool = multiprocessing.get_context("spawn").Pool(n)
    try:
        return pool.map(fn, jobs, chunksize=1)
    finally:
        pool.close()        # every worker has ended before the run goes on
        pool.join()


def last_run(out):
    """(first, last): the indices of the last IDR and of the last
    picture written after it; out: the access units by frame index
    (b"" for a frame that rate control skipped)."""
    from benchmark.streams import is_idr
    last = max((i for i, au in enumerate(out) if au), default=0)
    return max((i for i in range(last + 1) if out[i] and is_idr(out[i])),
               default=0), last


def encode_check(s, rec):
    """An encode cell's check from its state after close(): s.out, the
    access units by frame index; s.pool, the frames handed in (frame i
    is pool[i % len(pool)]); s.recon, the encoder's reconstruction of
    its last picture. Returns [(name, value, limit, ok)], the
    reference's errors and the number of pictures found wrong; the worst
    picture's MSE against its source goes to rec["diagnostics"]."""
    g, last = last_run(s.out)
    job = (s.out[g:last + 1],
           [s.pool[i % len(s.pool)] for i in range(g, last + 1)], s.recon)
    (mses, diff, err), = run_jobs(encode_job, [job])
    rec.setdefault("diagnostics", {})["mse_max"] = max(mses, default=None)
    lim = s.cell.limits["recon_max_abs_diff"]
    return [("recon_max_abs_diff", diff, lim, diff <= lim),
            ("pictures_checked", len(mses), 1, len(mses) >= 1),
            ("reference_errors", int(bool(err)), 0, not err)], \
        [err] if err else [], int(diff > lim or bool(err))
