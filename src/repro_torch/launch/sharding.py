"""Sharding arithmetic of the port.

Counterpart of ``repro/launch/sharding.py``'s memory model for sharded
RFF-KRLS (:func:`krls_shard_bytes`). The LM sharding rules wait for the LM
stack's port.
"""
from __future__ import annotations

__all__ = ["krls_shard_bytes"]


def krls_shard_bytes(num_features: int, n_shards: int, input_dim: int = 0,
                     itemsize: int = 4) -> dict:
    """Per-shard memory model for sharded RFF-KRLS (``repro``'s, the same
    numbers).

    Dominant term: the ``(D/n, D)`` P row block. Per tick each shard also
    materializes the full ``(2D+1,)`` all_reduce payload (pz ++ scattered z
    ++ partial prediction) plus its local ``(D/n,)`` slices.
    """
    d, n = num_features, n_shards
    if d % n:
        raise ValueError(f"D={d} must divide n_shards={n}")
    p_block = d * (d // n) * itemsize
    features = (input_dim + 1) * (d // n) * itemsize  # omega cols + bias
    theta = (d // n) * itemsize
    tick_payload = (2 * d + 1) * itemsize  # the one all_reduce per tick
    return {
        "p_block_bytes": p_block,
        "feature_bytes": features,
        "theta_bytes": theta,
        "tick_payload_bytes": tick_payload,
        "total_bytes": p_block + features + theta + tick_payload,
        "dense_p_bytes": d * d * itemsize,
    }
