"""Stroke-sequence utilities: purify, normalize, pad (the sketch-rnn
conventions of both VectorizedSketchy and QuickDraw, reference
`data_preparation.py:306-336,411-462`).

The port's own copy of ``art_sbir_tpu/data/strokes.py``: host code on
numpy, line for line the same."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def purify(
    sequences: Sequence[np.ndarray], max_seq_len: int, min_len: int = 10,
    clip: float = 1000.0,
) -> Tuple[List[np.ndarray], List[int]]:
    """Drop sequences outside (min_len, max_seq_len]; clip deltas to ±1000.

    Returns (kept sequences, kept original indices) so callers can drop the
    aligned path lists too (reference pops in place,
    `data_preparation.py:311-318`).
    """
    kept, idx = [], []
    for i, seq in enumerate(sequences):
        if min_len < seq.shape[0] <= max_seq_len:
            kept.append(np.clip(seq, -clip, clip).astype(np.float32))
            idx.append(i)
    return kept, idx


def normalizing_scale_factor(sequences: Sequence[np.ndarray]) -> float:
    """Global std over all (dx, dy) values (sketch-rnn appendix;
    reference `data_preparation.py:320-329`)."""
    data = np.concatenate([s[:, 0:2].reshape(-1) for s in sequences])
    return float(np.std(data))


def normalize(sequences: Sequence[np.ndarray]) -> List[np.ndarray]:
    scale = normalizing_scale_factor(sequences)
    out = []
    for s in sequences:
        s = s.copy()
        s[:, 0:2] /= scale
        out.append(s)
    return out


def stroke3_to_padded5(sketch3: np.ndarray, max_len: int) -> np.ndarray:
    """Stroke-3 -> padded stroke-5 (T=max_len) with the end-token tail
    (reference `data_preparation.py:445-452`)."""
    n = len(sketch3)
    out = np.zeros((max_len, 5), np.float32)
    out[:n, :2] = sketch3[:, :2]
    out[:n, 3] = sketch3[:, 2]
    out[:n, 2] = 1.0 - out[:n, 3]
    out[n - 1 :, 4] = 1.0
    out[n - 1 :, 2:4] = 0.0
    return out


def padded5_with_final_end(sketch5_rows: np.ndarray, max_len: int) -> np.ndarray:
    """VectorizedSketchy's padding recipe (`data_preparation.py:281-287`):
    zero-pad to max_len, mark the pad tail as end, drop the first row, append
    an explicit [0,0,0,0,1] end row — result is (max_len, 5)."""
    n = len(sketch5_rows)
    vec = np.zeros((max_len, 5), np.float32)
    vec[:n] = sketch5_rows
    vec[n:, 4] = 1.0
    vec = vec[1:]
    return np.concatenate([vec, [[0, 0, 0, 0, 1]]]).astype(np.float32)
