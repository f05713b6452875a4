"""Connectionist Temporal Classification decoders: greedy and
prefix-beam, whole-read and incremental (host-side numpy).

Alphabet: index 0 = CTC blank; 1..4 = A, C, G, T (paper's 5-way head).
"""
from __future__ import annotations

from typing import List

import numpy as np

BLANK = 0


def greedy_decode(log_probs: np.ndarray) -> List[np.ndarray]:
    """argmax -> collapse repeats -> drop blanks. log_probs: (B, T, V)."""
    out = []
    ids = np.argmax(np.asarray(log_probs), axis=-1)
    for row in ids:
        collapsed = row[np.insert(row[1:] != row[:-1], 0, True)]
        out.append(collapsed[collapsed != BLANK])
    return out


def _lse(*xs):
    xs = [x for x in xs if x > -np.inf]
    if not xs:
        return -np.inf
    m = max(xs)
    return m + np.log(sum(np.exp(x - m) for x in xs))


class GreedyCTCMerge:
    """Incremental greedy CTC over a streamed read: feed per-chunk
    argmax frame ids, get newly-emitted bases back. Carrying the last
    frame id across chunk boundaries makes the concatenated emissions
    EXACTLY :func:`greedy_decode` of the whole read's frames — the
    parity contract the serving BasecallerRunner is tested against."""

    def __init__(self):
        self._prev = -1                 # sentinel: nothing seen yet

    def feed(self, ids) -> List[int]:
        """ids: (T,) int frame argmaxes for one chunk (reads left to
        right). Returns the bases this chunk commits."""
        out: List[int] = []
        for v in np.asarray(ids).reshape(-1):
            v = int(v)
            if v != self._prev and v != BLANK:
                out.append(v)
            self._prev = v
        return out

    def finalize(self) -> List[int]:
        return []                       # greedy commits as it goes

    def clone(self) -> "GreedyCTCMerge":
        """Independent snapshot — the serving engine stashes a preempted
        stream's merge and must not share mutable state with this one."""
        c = GreedyCTCMerge()
        c._prev = self._prev
        return c


class BeamCTCMerge:
    """Incremental prefix-beam CTC: feed per-chunk frame log-probs,
    call :meth:`finalize` once the read ends. The beam state (prefix ->
    (logp_blank, logp_nonblank)) carries across chunks, so the result
    equals :func:`beam_decode` over the whole read's frames — prefix
    beam search is frame-sequential, chunking is free."""

    def __init__(self, beam: int = 5):
        self.beam = beam
        self.beams = {(): (0.0, -np.inf)}

    def feed(self, log_probs) -> List[int]:
        """log_probs: (T, V) for one chunk. Emits nothing — the best
        prefix may still change until the read ends."""
        lp = np.asarray(log_probs, np.float64)
        T, V = lp.shape
        for t in range(T):
            new = {}
            for prefix, (pb, pnb) in self.beams.items():
                for v in range(V):
                    p = lp[t, v]
                    if v == BLANK:
                        nb = new.get(prefix, (-np.inf, -np.inf))
                        new[prefix] = (_lse(nb[0], pb + p, pnb + p), nb[1])
                    else:
                        ext = prefix + (v,)
                        nb = new.get(ext, (-np.inf, -np.inf))
                        if prefix and prefix[-1] == v:
                            new[ext] = (nb[0], _lse(nb[1], pb + p))
                            same = new.get(prefix, (-np.inf, -np.inf))
                            new[prefix] = (same[0], _lse(same[1], pnb + p))
                        else:
                            new[ext] = (nb[0], _lse(nb[1], pb + p, pnb + p))
            self.beams = dict(sorted(new.items(),
                                     key=lambda kv: -_lse(*kv[1]))[:self.beam])
        return []

    def finalize(self) -> List[int]:
        """Best prefix so far (non-destructive — feeding may continue,
        and read-until ejection uses this as the partial-bases flush)."""
        best = max(self.beams.items(), key=lambda kv: _lse(*kv[1]))[0]
        return [int(v) for v in best]

    def clone(self) -> "BeamCTCMerge":
        """Independent snapshot for preemption stashes (``feed`` rebinds
        ``beams`` wholesale, but the copy keeps the stash immune to it)."""
        c = BeamCTCMerge(self.beam)
        c.beams = dict(self.beams)
        return c


def beam_decode(log_probs: np.ndarray, beam: int = 5) -> np.ndarray:
    """Prefix beam search for one sequence. log_probs: (T, V)."""
    merge = BeamCTCMerge(beam)
    merge.feed(log_probs)
    return np.asarray(merge.finalize(), np.int32)
