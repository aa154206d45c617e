"""FMO slice-group maps (spec 8.2.2, map types 0-6) and the next-MB
iteration the slice decoders follow when a picture has multiple slice
groups. Parity: decoder fmo.cpp:1-326 (FmoGenerateMbAllocMap* /
FmoNextMb), frame coding only (no MBAFF/fields).

Copied from openh264_tpu/decoder/fmo.py.
"""

from __future__ import annotations

import numpy as np


def build_mb_to_slice_group(pps, sps, change_cycle: int = 0) -> np.ndarray:
    """[n_mb] int32 slice-group id per MB (raster order)."""
    W, H = sps.mb_width, sps.mb_height
    n = W * H
    num = pps.num_slice_groups
    t = pps.slice_group_map_type
    m = pps.slice_group_map
    g = np.zeros(n, np.int32)
    if num <= 1:
        return g
    if t == 0:                               # interleaved run lengths
        runs = m["run_length"]
        i = 0
        while i < n:
            for grp, r in enumerate(runs):
                for _ in range(r):
                    if i >= n:
                        break
                    g[i] = grp
                    i += 1
    elif t == 1:                             # dispersed
        i = np.arange(n)
        g = (((i % W) + (((i // W) * num) // 2)) % num).astype(np.int32)
    elif t == 2:                             # foreground + leftover
        g[:] = num - 1
        for grp in range(num - 2, -1, -1):
            tl, br = m["top_left"][grp], m["bottom_right"][grp]
            x0, y0 = tl % W, tl // W
            x1, y1 = br % W, br // W
            for y in range(y0, min(y1, H - 1) + 1):
                for x in range(x0, min(x1, W - 1) + 1):
                    g[y * W + x] = grp
    elif t in (3, 4, 5):
        rate = m["change_rate"]
        direction = int(m["change_direction"])
        k0 = min(change_cycle * rate, n)     # MapUnitsInSliceGroup0
        if t == 4:                           # raster scan
            g[:] = 1
            if direction:
                g[n - k0:] = 0
            else:
                g[:k0] = 0
        elif t == 5:                         # wipe (column-wise)
            g[:] = 1
            k = 0
            if direction:
                cols = range(W - 1, -1, -1)
                rows = range(H - 1, -1, -1)
            else:
                cols = range(W)
                rows = range(H)
            done = False
            for x in cols:
                for y in rows:
                    if k >= k0:
                        done = True
                        break
                    g[y * W + x] = 0
                    k += 1
                if done:
                    break
        else:                                # 3: box-out spiral
            g[:] = 1
            x = (W - direction) // 2
            y = (H - direction) // 2
            left = right = x
            top = bottom = y
            xdir = direction - 1
            ydir = direction
            k = 0
            while k < k0:
                vacant = g[y * W + x] == 1
                if vacant:
                    g[y * W + x] = 0
                    k += 1
                if xdir == -1 and x == left:
                    left = max(left - 1, 0)
                    x = left
                    xdir, ydir = 0, 2 * direction - 1
                elif xdir == 1 and x == right:
                    right = min(right + 1, W - 1)
                    x = right
                    xdir, ydir = 0, 1 - 2 * direction
                elif ydir == -1 and y == top:
                    top = max(top - 1, 0)
                    y = top
                    xdir, ydir = 1 - 2 * direction, 0
                elif ydir == 1 and y == bottom:
                    bottom = min(bottom + 1, H - 1)
                    y = bottom
                    xdir, ydir = 2 * direction - 1, 0
                else:
                    x += xdir
                    y += ydir
    elif t == 6:                             # explicit
        ex = m["explicit"]
        for i in range(n):
            g[i] = ex[i] if i < len(ex) else 0
    return g


def next_mb_lut(group_map: np.ndarray) -> np.ndarray:
    """next_mb[i] = the next raster MB in i's slice group (n_mb when i
    is its group's last MB) — FmoNextMb semantics."""
    n = len(group_map)
    nxt = np.full(n, n, np.int32)
    last: dict[int, int] = {}
    for i in range(n):
        grp = int(group_map[i])
        if grp in last:
            nxt[last[grp]] = i
        last[grp] = i
    return nxt
