"""The check of the decode cells whose streams reorder pictures (B
pictures, several references): chains of access units from an IDR,
decoded by the plain reference on their own (reference/decoder_b.py) in
worker processes, and compared picture by picture, matched by POC, with
what the program returned for the same (lap, GOP, POC).

Beside it, `stream_pocs` gives the POC of every access unit of a GOP
from its slice headers, so that an entry can tell before its window
which pictures a chain will hold.
"""

from __future__ import annotations

from benchmark.compare import _planes_diff


def stream_pocs(gop: list[bytes]) -> list[int]:
    """The POC (clause 8.2.1) of each access unit of a closed GOP, in
    decode order."""
    from benchmark.reference.bits import BitReader
    from benchmark.reference.dpb import PocContext
    from benchmark.reference.nal import split_annexb
    from benchmark.reference.params import parse_pps, parse_sps
    from benchmark.reference.slicehdr import parse_slice_header
    sps_map, pps_map, out, poc = {}, {}, [], None
    for au in gop:
        for nal in split_annexb(au):
            t = nal.nal_unit_type
            if t == 7:
                sps = parse_sps(nal.rbsp)
                sps_map[sps.sps_id] = sps
            elif t == 8:
                pps = parse_pps(nal.rbsp, sps_map)
                pps_map[pps.pps_id] = pps
            elif t in (1, 5):
                sh = parse_slice_header(BitReader(nal.rbsp), nal, sps_map,
                                        pps_map)
                if poc is None or sh.is_idr:
                    poc = PocContext(sh.sps)
                out.append(poc.compute(sh, nal.nal_ref_idc != 0))
                break
    return out


def _decode(aus, deblock: bool):
    from benchmark.reference.decoder_b import ChainDecoder
    dec = ChainDecoder(deblock=deblock)
    return [dec.decode_au(au) for au in aus]


def chain_job(args):
    """(aus, gots) -> (largest sample difference, pictures compared,
    error text): aus, a chain's access units from its IDR (parameter
    sets first); gots, {POC: planes} of the program's pictures of that
    chain. The reference decodes the chain on its own; each of its
    pictures is held against the program's of the same POC."""
    aus, gots = args
    try:
        want = _decode(aus, True)
    except Exception as e:                    # a reference that cannot
        return 256, 0, f"{type(e).__name__}: {e}"  # decode it judges it
    diffs = [_planes_diff(w, gots[poc]) for poc, w in want if poc in gots]
    return max(diffs, default=0), len(diffs), ""


def chain_control_job(args):
    """chain_job with the control in the program's place: the reference
    without its deblocking filter."""
    aus, gots = args
    try:
        ctl = dict(_decode(aus, False))
    except Exception as e:
        return 256, 0, f"{type(e).__name__}: {e}"
    return chain_job((aus, {poc: ctl[poc] for poc in gots if poc in ctl}))

