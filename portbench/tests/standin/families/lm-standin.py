"""A stand-in language-model family: a qwen2-style decoder (GQA with QKV
bias, RoPE, SwiGLU, RMSNorm, tied embeddings) served by the port's decode
path. Its seam: the mix's fields, the weights and prompts made from the
seed, and the comparison of the served logits with the plain reference
(``reference/lm-standin.py``).

The weights are the benchmark's, by name (``weight_shapes``), in the
configuration's dtype: matrices ``(in, out)`` at ``N(0, 1 / in)``, biases
at ``N(0, 0.01)``, norm scales at ``1 + N(0, 0.01)``, the embedding at
``N(0, 1 / d)``, drawn in one float32 call from the seed."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["FIELDS", "PREFIXES", "Traffic", "Inputs", "compare", "describe",
           "make_inputs", "make_weights", "traffic", "weight_shapes"]

FIELDS = ("batch", "prompt_len", "decode_steps", "pool_prompts",
          "warmup_rounds", "check_rounds")
PREFIXES = ("model.", "kernel.")
_MASK64 = (1 << 63) - 1


@dataclass(frozen=True)
class Traffic:
    batch: int          # sequences a round
    prompt_len: int     # prompt tokens a sequence
    decode_steps: int   # greedy tokens served a sequence (the first from
                        # the prefill's logits)
    pool_prompts: int   # prompt blocks; round g takes block g mod P
    warmup_rounds: int
    check_rounds: int   # the last rounds compared


def traffic(mix: dict) -> Traffic:
    return Traffic(**{k: int(mix[k]) for k in FIELDS})


@dataclass
class Inputs:
    weights: dict        # name -> tensor, in the configuration's dtype
    prompts: torch.Tensor  # (P, batch, prompt_len) token ids


def weight_shapes(cfg: dict) -> dict:
    """name -> (shape, kind) in draw order; kind is ``matrix``, ``bias``,
    ``norm`` or ``embed``."""
    d, h, kv, dh = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                    cfg["head_dim"])
    out = {"embed": ((cfg["vocab_size"], d), "embed")}
    for layer in range(cfg["num_layers"]):
        for name, shape, kind in [
                ("ln1", (d,), "norm"), ("wq", (d, h * dh), "matrix"),
                ("bq", (h * dh,), "bias"), ("wk", (d, kv * dh), "matrix"),
                ("bk", (kv * dh,), "bias"), ("wv", (d, kv * dh), "matrix"),
                ("bv", (kv * dh,), "bias"), ("wo", (h * dh, d), "matrix"),
                ("ln2", (d,), "norm"), ("wg", (d, cfg["d_ff"]), "matrix"),
                ("wi", (d, cfg["d_ff"]), "matrix"),
                ("wd", (cfg["d_ff"], d), "matrix")]:
            out[f"{layer}.{name}"] = (shape, kind)
    out["norm"] = ((d,), "norm")
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & _MASK64)
    shapes = weight_shapes(cfg)
    total = sum(math.prod(s) for s, _ in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    dtype = getattr(torch, cfg["dtype"])
    out, lo = {}, 0
    for name, (shape, kind) in shapes.items():
        n = math.prod(shape)
        x = flat[lo:lo + n].view(shape)
        lo += n
        if kind == "matrix":
            x = x * shape[0] ** -0.5
        elif kind == "bias":
            x = x * 0.1
        elif kind == "norm":
            x = 1.0 + 0.1 * x
        else:
            x = x * shape[1] ** -0.5
        out[name] = x.to(dtype).contiguous()
    return out


def make_inputs(cfg: dict, traffic: Traffic, seed: int, device) -> Inputs:
    gen = torch.Generator(device=device)
    gen.manual_seed((seed ^ 0x70C5) & _MASK64)
    prompts = torch.randint(
        0, cfg["vocab_size"],
        (traffic.pool_prompts, traffic.batch, traffic.prompt_len),
        generator=gen, device=device)
    return Inputs(make_weights(cfg, seed, device), prompts)


def describe(inputs: Inputs) -> dict:
    return {"weight_bytes": sum(t.numel() * t.element_size()
                                for t in inputs.weights.values()),
            "prompts": list(inputs.prompts.shape)}


def compare(cell, inputs: Inputs, results, g_end: int, leaves: dict,
            seed: int, device) -> dict:
    """``logit_gap``: the widest gap between a served logit and the
    reference's at the same position, over the RMS of the reference's
    logits; ``token_gap``: the widest gap by which a served token's
    reference logit lies below the reference's best, over the same RMS.
    The last ``check_rounds`` rounds, each prompt with its served tokens
    through the reference in float32, on weights rebuilt from the seed
    (the inputs' copy is dropped first)."""
    del leaves
    t, cfg = cell.traffic, cell.cfg
    inputs.weights = None
    weights = {k: v.float() for k, v in
               make_weights(cfg, seed, device).items()}
    lgap = tgap = 0.0
    for g in range(max(0, g_end - t.check_rounds), g_end):
        toks, logits = results(g)
        prompts = inputs.prompts[g % t.pool_prompts]
        seq = torch.cat([prompts, toks[:, :-1].to(prompts.device)], dim=1)
        ref = cell.reference.forward(cfg, weights, seq)[:, t.prompt_len - 1:]
        rms = float(ref.square().mean().sqrt())
        lgap = max(lgap, float((logits.to(ref.device) - ref).abs().max())
                   / rms)
        served = ref.gather(-1, toks.to(ref.device)[..., None])[..., 0]
        tgap = max(tgap, float((ref.max(-1).values - served).max()) / rms)
    return {"logit_gap": lgap, "token_gap": tgap}
