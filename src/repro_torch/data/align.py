"""Read-level accuracy: banded Needleman-Wunsch identity between a
basecalled read and its truth sequence (stand-in for the paper's
minimap2-based accuracy metric — same definition: matches / alignment
columns including indels)."""
from __future__ import annotations

import numpy as np


def identity(a: np.ndarray, b: np.ndarray, band: int = 64) -> float:
    """Global alignment identity of integer sequences a, b (banded DP)."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0
    band = max(band, abs(la - lb) + 2)
    NEG = -10 ** 9
    # dp[j - i + band] style banded matrix
    width = 2 * band + 1
    prev = np.full(width, NEG, np.int64)
    prev_m = np.zeros(width, np.int64)      # matches along best path
    prev_l = np.zeros(width, np.int64)      # alignment length
    # i=0 row: j insertions
    for d in range(width):
        j = d - band
        if 0 <= j <= lb and j <= band:
            prev[d] = -j
            prev_m[d] = 0
            prev_l[d] = j
    for i in range(1, la + 1):
        cur = np.full(width, NEG, np.int64)
        cur_m = np.zeros(width, np.int64)
        cur_l = np.zeros(width, np.int64)
        lo = max(0, i - band)
        hi = min(lb, i + band)
        for j in range(lo, hi + 1):
            d = j - i + band
            best, bm, blen = NEG, 0, 0
            # diag: from (i-1, j-1) -> same offset d
            if j > 0 and prev[d] > NEG // 2:
                m = 1 if a[i - 1] == b[j - 1] else 0
                sc = prev[d] + (1 if m else -1)
                if sc > best:
                    best, bm, blen = sc, prev_m[d] + m, prev_l[d] + 1
            # up: from (i-1, j) -> offset d+1 in prev
            if d + 1 < width and prev[d + 1] > NEG // 2:
                sc = prev[d + 1] - 1
                if sc > best:
                    best, bm, blen = sc, prev_m[d + 1], prev_l[d + 1] + 1
            # left: from (i, j-1) -> offset d-1 in cur
            if j > 0 and d - 1 >= 0 and cur[d - 1] > NEG // 2:
                sc = cur[d - 1] - 1
                if sc > best:
                    best, bm, blen = sc, cur_m[d - 1], cur_l[d - 1] + 1
            cur[d], cur_m[d], cur_l[d] = best, bm, blen
        prev, prev_m, prev_l = cur, cur_m, cur_l
    d = lb - la + band
    if not (0 <= d < width) or prev_l[d] == 0:
        return 0.0
    return float(prev_m[d]) / float(prev_l[d])
