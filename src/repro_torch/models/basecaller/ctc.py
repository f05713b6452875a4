"""Connectionist Temporal Classification: the loss (``F.ctc_loss``,
held against :func:`ctc_loss_ref`, the reference's log-space forward
algorithm step for step) and the greedy / prefix-beam decoders,
whole-read and incremental (host-side numpy).

Alphabet: index 0 = CTC blank; 1..4 = A, C, G, T (paper's 5-way head).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compat import is_fake

NEG = -1e30
BLANK = 0


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the batch, not divided by the
    label lengths (the reference's ``-mean(ll)``).

    log_probs: (B, T, V) log-softmax outputs; labels: (B, L) in [1, V)
    padded with 0; label_lengths: (B,). Every row is scored over all T
    frames. The targets go to the log-probs' device as int64, which
    keeps PyTorch off cuDNN's CTC: the card runs the native CUDA
    implementation, the CPU the native CPU one, both in the log-probs'
    dtype. A row whose alignment cannot exist (T below the label's
    length plus its repeats, where ``F.ctc_loss`` is infinite) takes
    :func:`ctc_loss_ref`'s value and gradient, as in the reference:
    about 1e30, finite, so one such row does not turn every parameter
    to NaN. Finding those rows reads one index list back to the host,
    where the native CUDA CTC reads the lengths back anyway.

    Its gradient with respect to ``log_probs`` is PyTorch's
    ``exp(lp) - gamma``, not ``-gamma``: the two agree only through
    ``log_softmax``'s backward, so gradients match the reference's with
    respect to the logits or the parameters, never ``log_probs``.

    On fake tensors (the dry run's counter) :func:`ctc_loss_ref` stands
    in: ``F.ctc_loss``'s shapes depend on the lengths' values, which a
    fake tensor has not.
    """
    if is_fake(log_probs):
        return ctc_loss_ref(log_probs, labels, label_lengths)
    B, T, _ = log_probs.shape
    dev = log_probs.device
    labels = labels.to(device=dev, dtype=torch.int64)
    lens = label_lengths.to(device=dev, dtype=torch.int64)
    # zero_infinity only touches the rows replaced below
    nll = F.ctc_loss(log_probs.transpose(0, 1), labels,
                     torch.full((B,), T, dtype=torch.int64, device=dev),
                     lens, blank=BLANK, reduction="none", zero_infinity=True)
    # an alignment takes a frame per label and one between repeats
    live = (torch.arange(1, labels.shape[1], device=dev)[None, :]
            < lens[:, None])
    repeats = ((labels[:, 1:] == labels[:, :-1]) & live).sum(dim=1)
    bad = torch.nonzero(lens + repeats > T)[:, 0]
    if bad.numel():
        nll = nll.index_put((bad,), -_log_likelihood_ref(
            log_probs[bad], labels[bad], lens[bad]))
    return nll.mean()


def ctc_loss_ref(log_probs: torch.Tensor, labels: torch.Tensor,
                 label_lengths: torch.Tensor) -> torch.Tensor:
    """:func:`ctc_loss`'s plain twin: the reference's forward algorithm
    over the extended label (blank, l1, blank, ..., blank), one step a
    frame, with its ``NEG = -1e30`` floor and ``+1e-38`` inside the
    logs. Differentiable by autograd."""
    return -_log_likelihood_ref(log_probs, labels, label_lengths).mean()


def _log_likelihood_ref(log_probs: torch.Tensor, labels: torch.Tensor,
                        label_lengths: torch.Tensor) -> torch.Tensor:
    """Per-row log-likelihood (B,) of :func:`ctc_loss_ref`."""
    B, T, _ = log_probs.shape
    dev = log_probs.device
    labels = labels.to(device=dev, dtype=torch.int64)
    label_lengths = label_lengths.to(device=dev, dtype=torch.int64)
    U = 2 * labels.shape[1] + 1
    z = torch.zeros((B, U), dtype=torch.int64, device=dev)
    z[:, 1::2] = labels
    u_len = 2 * label_lengths + 1
    z_shift2 = F.pad(z, (2, 0))[:, :U]
    can_skip = (z != BLANK) & (z != z_shift2)
    u_valid = torch.arange(U, device=dev)[None, :] < u_len[:, None]
    neg = torch.full((B, U), NEG, dtype=log_probs.dtype, device=dev)

    lp0 = log_probs[:, 0]
    first = torch.gather(lp0, 1, z[:, :2])
    alpha = torch.cat([first[:, :1],
                       torch.where(u_len[:, None] > 1, first[:, 1:2],
                                   neg[:, :1]), neg[:, 2:]], dim=1)
    for t in range(1, T):
        stay = alpha
        prev1 = F.pad(alpha, (1, 0), value=NEG)[:, :U]
        prev2 = F.pad(alpha, (2, 0), value=NEG)[:, :U]
        prev2 = torch.where(can_skip, prev2, neg)
        m = torch.maximum(torch.maximum(stay, prev1), prev2)
        tot = m + torch.log(torch.exp(stay - m) + torch.exp(prev1 - m)
                            + torch.exp(prev2 - m) + 1e-38)
        emit = torch.gather(log_probs[:, t], 1, z)
        alpha = torch.where(u_valid, tot + emit, neg)
    idx_last = (u_len - 1)[:, None]
    a_last = torch.gather(alpha, 1, idx_last)[:, 0]
    a_prev = torch.gather(alpha, 1, (idx_last - 1).clamp_min(0))[:, 0]
    m = torch.maximum(a_last, a_prev)
    return m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)
                         + 1e-38)


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
