"""Operations and bytes of the stand-in decoder's work, per request:
``prefill(cfg, batch, prompt_len)`` for a batch of prompts and
``decode(cfg, batch, ctx)`` for one token of each sequence at ``ctx``
positions. A token: two operations a weight of every projection and of
the tied head, and ``4 H dh`` a key it attends to (scores and values).
Bytes: every weight read once a call, the new keys and values written,
the cached ones read once a decode step, a token id in and the logits
out."""
from __future__ import annotations

__all__ = ["prefill", "decode"]


def _sizes(cfg):
    d, h, kv, dh, ff = (cfg["d_model"], cfg["num_heads"],
                        cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"])
    layer = d * h * dh * 2 + 2 * d * kv * dh + 3 * d * ff
    weights = cfg["num_layers"] * (layer + 2 * d + (h + 2 * kv) * dh) + \
        (cfg["vocab_size"] + 1) * d
    elt = 2 if cfg["dtype"] in ("bfloat16", "float16") else 4
    return layer, weights, elt


def _token_ops(cfg, ctx):
    layer, _, _ = _sizes(cfg)
    att = 4 * cfg["num_heads"] * cfg["head_dim"] * ctx
    return cfg["num_layers"] * (2 * layer + att) + \
        2 * cfg["d_model"] * cfg["vocab_size"]


def _kv_bytes(cfg, positions, elt):
    return (2 * cfg["num_layers"] * cfg["num_kv_heads"] * cfg["head_dim"]
            * positions * elt)


def prefill(cfg: dict, batch: int, prompt_len: int) -> tuple:
    _, weights, elt = _sizes(cfg)
    ops = batch * sum(_token_ops(cfg, c + 1) for c in range(prompt_len))
    nbytes = (weights * elt + batch * _kv_bytes(cfg, prompt_len, elt)
              + batch * (prompt_len * 8 + cfg["vocab_size"] * elt))
    return float(ops), float(nbytes)


def decode(cfg: dict, batch: int, ctx: int) -> tuple:
    _, weights, elt = _sizes(cfg)
    ops = batch * _token_ops(cfg, ctx)
    nbytes = (weights * elt + batch * _kv_bytes(cfg, ctx, elt)
              + batch * (8 + cfg["vocab_size"] * elt))
    return float(ops), float(nbytes)
