"""The stand-in LM driver: one client, one round at a time. Round g
prefills prompt block g mod P (``batch`` sequences) through the port's
decode cache (``serve.serve_loop.prefill_tokens``), takes the greedy
token of the last prompt position's logits, then decodes ``decode_steps
- 1`` more tokens through ``models.decode_step``, each chosen greedily.
Every step's logits come to the host.

In ``Run``: a prefill is ``batch`` writes, its prompt tokens ``obs``, its
latency from the call to the first token's logits on the host; a decode
step is ``batch`` reads of one token each (``read_rows``), its latency
from the call to its logits on the host."""
from __future__ import annotations

import time

import torch

from portbench.harness import bound_s

__all__ = ["FIELDS", "SPANS", "Client", "ProgramLM"]

FIELDS = ()  # the family's fields alone
SPANS = ("portbench.prefill", "portbench.decode")


class ProgramLM:
    """The port's decoder on the benchmark's weights."""

    def __init__(self, cell, weights: dict):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import transformer
        from repro_torch.serve.serve_loop import prefill_tokens

        c, t = cell.cfg, cell.traffic
        self.mcfg = ModelConfig(
            name=c["name"], family="dense", num_layers=c["num_layers"],
            d_model=c["d_model"], num_heads=c["num_heads"],
            num_kv_heads=c["num_kv_heads"], d_ff=c["d_ff"],
            vocab_size=c["vocab_size"], head_dim=c["head_dim"],
            attention="gqa", qkv_bias=True, tie_embeddings=True,
            rope_theta=c["rope_theta"], norm_eps=c["norm_eps"],
            pad_vocab_to=0, dtype=c["dtype"])
        self.params = _port_params(c, weights)
        self.max_len = t.prompt_len + t.decode_steps
        self._tf, self._prefill = transformer, prefill_tokens

    def prefill(self, prompts):
        """-> (decode state, logits of the last prompt position (B, V))."""
        state = self._tf.decode_state_init(self.mcfg, prompts.shape[0],
                                           self.max_len,
                                           device=prompts.device)
        return self._prefill(self.params, self.mcfg, state, prompts)

    def decode(self, state, token):
        """-> (logits (B, V), the advanced state)."""
        return self._tf.decode_step(self.params, self.mcfg, state, token)


def _port_params(c: dict, w: dict) -> dict:
    """The benchmark's named weights as the port's parameter tree."""
    h, kv, dh = c["num_heads"], c["num_kv_heads"], c["head_dim"]

    def heads(m, b, n):
        return {"w": m.view(-1, n, dh), "b": b.view(n, dh)}

    blocks = []
    for layer in range(c["num_layers"]):
        p = {k.split(".", 1)[1]: v for k, v in w.items()
             if k.startswith(f"{layer}.")}
        blocks.append({
            "ln1": {"scale": p["ln1"]},
            "attn": {"wq": heads(p["wq"], p["bq"], h),
                     "wk": heads(p["wk"], p["bk"], kv),
                     "wv": heads(p["wv"], p["bv"], kv),
                     "wo": {"w": p["wo"].view(h, dh, -1)}},
            "ln2": {"scale": p["ln2"]},
            "ffn": {"wi": {"w": p["wi"]}, "wg": {"w": p["wg"]},
                    "wo": {"w": p["wd"]}}})
    return {"embed": {"table": w["embed"]},
            "final_norm": {"scale": w["norm"]}, "blocks": blocks}


class Client:
    def __init__(self, cell, system, inputs, seed, device):
        del seed  # every input is the family's
        self.system = (system or ProgramLM)(cell, inputs.weights)
        self.cell, self.traffic = cell, cell.traffic
        self.prompts = inputs.prompts
        self.cuda = torch.device(device).type == "cuda"
        self.kept = {}  # round -> (tokens (B, steps), logits (B, steps, V))
        self.g = 0
        self.run = None  # set for the measured window

    def step(self):
        t, clock = self.traffic, time.perf_counter
        g = self.g
        t0 = clock()
        with torch.profiler.record_function("portbench.prefill"):
            state, logits = self.system.prefill(
                self.prompts[g % t.pool_prompts])
            tok = logits.argmax(-1)
            seen = [logits.cpu()]
        first = clock() - t0
        toks, lat = [tok], []
        for _ in range(t.decode_steps - 1):
            t1 = clock()
            with torch.profiler.record_function("portbench.decode"):
                logits, state = self.system.decode(state, tok)
                tok = logits.argmax(-1)
                seen.append(logits.cpu())
            lat.append(clock() - t1)
            toks.append(tok)
        self.kept[g] = (torch.stack(toks, 1).cpu(), torch.stack(seen, 1))
        self.kept.pop(g - t.check_rounds, None)
        self.g += 1
        run = self.run
        if run is None:
            return
        run.writes += t.batch
        run.obs += t.batch * t.prompt_len
        run.write_latency_s.extend([first] * t.batch)
        run.reads += t.batch * len(lat)
        run.read_rows += t.batch * len(lat)
        run.read_latency_s.extend(x for x in lat for _ in range(t.batch))

    def rounds(self, n: int):
        for _ in range(n):
            self.step()

    def drain(self):
        """Nothing is outstanding between rounds."""

    def results(self, g: int):
        return self.kept[g]

    def leaves(self) -> dict:
        return {}

    def release(self):
        self.system = None

    def costs(self, run, first: int, last: int):
        t, cfg, counts = self.traffic, self.cell.cfg, self.cell.counts
        for _ in range(first, last):
            ops, nbytes = counts.prefill(cfg, t.batch, t.prompt_len)
            run.write_ops += ops
            run.write_bound_s += bound_s(run, ops, nbytes)
            for i in range(1, t.decode_steps):
                ops, nbytes = counts.decode(cfg, t.batch, t.prompt_len + i)
                run.read_ops += ops
                run.read_bound_s += bound_s(run, ops, nbytes)
