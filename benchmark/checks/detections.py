"""The numbers that decide `correct` for the episode cells: how far the
port's detections and memory lie from the plain reference's on the same
frames, from the same memory."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# a detection is matched when a detection of the other side has its class,
# overlaps it by IoU 1 - GAP or more and its score lies within GAP of it,
# relatively
GAP = 0.05


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, M] IoU of xyxy boxes."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def unmatched(got: np.ndarray, want: np.ndarray) -> Tuple[int, int]:
    """(unmatched, total) of `got`'s valid detections against `want`'s,
    both [N, 7] rows (box, score, class, valid) of one frame."""
    g = got[got[:, 6] > 0]
    w = want[want[:, 6] > 0]
    if len(g) == 0:
        return 0, 0
    if len(w) == 0:
        return len(g), len(g)
    same = g[:, None, 5] == w[None, :, 5]
    close = iou(g[:, :4], w[:, :4]) >= 1.0 - GAP
    ds = np.abs(g[:, None, 4] - w[None, :, 4]) <= \
        GAP * np.maximum(g[:, None, 4], w[None, :, 4])
    return int((~(same & close & ds).any(1)).sum()), len(g)


def unmatched_share(got: Sequence[np.ndarray],
                    want: Sequence[np.ndarray]) -> float:
    """The share of detections, over the frames and both directions, that
    the other side lacks."""
    miss = total = 0
    for g, w in zip(got, want):
        for a, b in ((g, w), (w, g)):
            m, t = unmatched(a, b)
            miss += m
            total += t
    return miss / total if total else 0.0


def matched_pairs(got: np.ndarray, want: np.ndarray, min_iou: float = 0.9):
    """Greedy one-to-one pairs (got row, want row) of one frame's valid
    detections: in `got`'s score order, each takes the unpaired `want`
    detection of its class with the highest IoU, if that is `min_iou` or
    more."""
    g = np.flatnonzero(got[:, 6] > 0)
    w = np.flatnonzero(want[:, 6] > 0)
    if len(g) == 0 or len(w) == 0:
        return []
    g = g[np.argsort(-got[g, 4], kind="stable")]
    ov = iou(got[g, :4], want[w, :4])
    ov[got[g, None, 5] != want[None, w, 5]] = -1.0
    taken = np.zeros(len(w), bool)
    pairs = []
    for i in range(len(g)):
        row = np.where(taken, -1.0, ov[i])
        j = int(row.argmax())
        if row[j] >= min_iou:
            taken[j] = True
            pairs.append((g[i], w[j], row[j]))
    return pairs


def pair_gaps(got: Sequence[np.ndarray], want: Sequence[np.ndarray],
              q: float = 50.0):
    """(q-th percentile of the relative score gap, of 1 - IoU) over the
    matched pairs of all frames; (1, 1) when no detection pairs up."""
    score, box = [], []
    for a, b in zip(got, want):
        for i, j, o in matched_pairs(a, b):
            score.append(abs(a[i, 4] - b[j, 4]) / max(b[j, 4], 1e-9))
            box.append(1.0 - o)
    if not score:
        return 1.0, 1.0
    return float(np.percentile(score, q)), float(np.percentile(box, q))


def write_gap(got: np.ndarray, want: np.ndarray, start: np.ndarray,
              q: float = 50.0) -> float:
    """The q-th percentile, over the cells the reference's write changed,
    of |got - want| / |want - start| of the cell's written feature sums
    (got and want the memories after the write, start the memory before
    it); 0 when the reference wrote nothing."""
    upd_w = want.astype(np.float64) - start
    norm = np.linalg.norm(upd_w, axis=1)
    written = norm > 0
    if not written.any():
        return 0.0
    diff = np.linalg.norm(got[written].astype(np.float64) - want[written],
                          axis=1)
    return float(np.percentile(diff / norm[written], q))


def held_write_gap(got: np.ndarray, want: np.ndarray,
                   base: np.ndarray) -> float:
    """The largest, over the cells either write changed, of |got - want|
    over the larger of the two writes' norms in the cell (got and want
    the memories after writes from the same inputs, base the memory
    before them); 0 when neither wrote."""
    base = base.astype(np.float64)
    upd_g = np.linalg.norm(got - base, axis=1)
    upd_w = np.linalg.norm(want - base, axis=1)
    written = (upd_g > 0) | (upd_w > 0)
    if not written.any():
        return 0.0
    diff = np.linalg.norm(got[written].astype(np.float64) - want[written],
                          axis=1)
    scale = np.maximum(upd_g[written], upd_w[written])
    return float((diff / scale).max())


def memory_gap(got: np.ndarray, want: np.ndarray) -> float:
    """|got - want| / |want| of two memories' feature sums (Frobenius)."""
    scale = float(np.linalg.norm(want))
    diff = float(np.linalg.norm(got.astype(np.float64) - want))
    return diff / scale if scale else diff


def count_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The share of cells whose observation counts differ."""
    return float(np.mean(got != want))
