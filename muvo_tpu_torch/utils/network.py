"""Sequence-dim packing helpers ((b, s, ...) <-> (b*s, ...)).

Counterpart of muvo_tpu/utils/network.py; works on tensors, numpy arrays and
dicts of them.
"""

from __future__ import annotations


def pack_sequence_dim(x):
    if isinstance(x, dict):
        return {k: pack_sequence_dim(v) for k, v in x.items()}
    b, s = x.shape[:2]
    return x.reshape((b * s,) + tuple(x.shape[2:]))


def unpack_sequence_dim(x, b, s):
    if isinstance(x, dict):
        return {k: unpack_sequence_dim(v, b, s) for k, v in x.items()}
    return x.reshape((b, s) + tuple(x.shape[1:]))


def remove_past(batch, receptive_field):
    """Keep only the last frame of the receptive field (deployment)."""
    return {k: v[:, receptive_field - 1:receptive_field]
            for k, v in batch.items()}
