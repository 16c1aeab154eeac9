"""Zero-shot classifier weights from class embeddings.

Part of the JAX package's `demo/predictor.py`: `build_zs_weight` and
`load_zs_weight_npy`, which the CLI needs. The streaming predictor comes
with the port's serving layer (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import numpy as np


def build_zs_weight(class_embeddings: np.ndarray,
                    normalize: bool = True) -> np.ndarray:
    """[C, D] class embeddings -> the [D, C+1] zs_weight input: a zero
    background column, each column l2-normalised (ref: reset_cls_test,
    detic/modeling/utils.py:32-50; swapping the vocabulary is passing
    another zs_weight)."""
    w = np.asarray(class_embeddings, np.float32).T          # D x C
    w = np.concatenate([w, np.zeros((w.shape[0], 1), np.float32)], axis=1)
    if normalize:
        n = np.linalg.norm(w, axis=0, keepdims=True)
        w = w / np.maximum(n, 1e-12)
    return w


def load_zs_weight_npy(path: str) -> np.ndarray:
    """The zs_weight of a metadata .npy of [C, D] CLIP embeddings (e.g.
    `data/metadata/mp3d_clip.npy`)."""
    return build_zs_weight(np.load(path).astype(np.float32))
