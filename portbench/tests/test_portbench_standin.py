"""A language model enters the harness as new files and entries only.

A stand-in family (``standin/``: a two-layer, d = 64 qwen2-style decoder
served by the port's prefill and decode cache, compared on logits with a
plain float32 forward) is copied into the tiny bench beside the files
that are there, and its cell added to ``BENCHMARK.json``; no file that
was there changes. Through ``run_cell`` on the CPU it is correct, one
layer's output scaled by 1.01 is not, and a traced run reports its
driver's ranges through ``Run.program``, kept with the family's
prefixes."""
import hashlib
import json
import shutil
from pathlib import Path

import pytest

from portbench import harness, program_trace, spec
from portbench_tiny import tiny_bench

STANDIN = Path(__file__).resolve().parent / "standin"
CELL = "qwen2-standin-serve"
SEED = 2 ** 31 + 53
E2E = ("obs_per_s", "reads_per_s", "write_p95_ms", "read_p95_ms")


def _hashes(folder: Path) -> dict:
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).digest()
            for p in folder.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def add_standin(root: Path) -> list:
    """The stand-in's files under ``root/portbench`` and its entries in
    ``root/BENCHMARK.json``; returns the files added."""
    added = []
    for src in sorted(STANDIN.rglob("*")):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = root / "portbench" / src.relative_to(STANDIN)
            assert not dst.exists(), dst
            shutil.copy(src, dst)
            added.append(dst)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "qwen2-standin", "source": "https://arxiv.org/abs/2407.10671",
        "file": "portbench/configs/qwen2-standin.json",
        "reduced": ["num_layers", "d_model"], "why": "a stand-in decoder"})
    bench["workloads"].append({
        "name": CELL, "config": "qwen2-standin",
        "traffic": "lm-prefill-decode", "chips": 1,
        "why": "prefill through the decode cache, then greedy decode"})
    for m in bench["end_to_end"]:
        if m["name"] in E2E:
            m["workloads"].append(CELL)
    for name, moves in (("prefill_span_ms", "write_p95_ms"),
                        ("decode_span_ms", "read_p95_ms")):
        bench["per_layer"].append({
            "name": name, "unit": "ms", "better": "lower",
            "source": "program_span", "layer": "LM serving", "moves": moves,
            "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return added


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_bench(tmp_path_factory.mktemp("portbench"))
    before = _hashes(root / "portbench")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    added = add_standin(root)
    after = _hashes(root / "portbench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {p.relative_to(root / "portbench")
                                        for p in added}
    # BENCHMARK.json: entries appended, and the new cell appended to the
    # end-to-end metrics' lists; nothing else of an entry changes.
    now = json.loads((root / "BENCHMARK.json").read_text())
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        old = bench[kind]
        assert len(now[kind]) >= len(old)
        for was, entry in zip(old, now[kind]):
            if entry.get("workloads", [None])[-1] == CELL:
                entry = {**entry, "workloads": entry["workloads"][:-1]}
            assert entry == was
    return root


def _run(root, system=None, trace=False):
    return harness.run_cell(root, CELL, SEED, 0, trace, "cpu", system=system,
                            rounds=3)


def test_standin_is_correct(root):
    r = _run(root)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"logit_gap", "token_gap"}
    assert set(r["metrics"]) == {*E2E, "setup_s"}
    # 3 rounds of 2 prompts, each 3 decode steps after its prefill.
    assert r["attempted"] == 3 * 2 + 3 * 2 * 3


def test_scaled_layer_is_not_correct(root):
    driver = spec.load_cell(root, CELL).driver

    class ScaledLayer(driver.ProgramLM):
        """The first layer's output scaled by 1.01."""

        def _scaled(self, call, *args):
            tf = self._tf
            block = tf._block_decode
            first = self.params["blocks"][0]

            def scaled(p, cfg, x, state, kernel_mode):
                x, state = block(p, cfg, x, state, kernel_mode)
                return (x * 1.01 if p is first else x), state

            tf._block_decode = scaled
            try:
                return call(*args)
            finally:
                tf._block_decode = block

        def prefill(self, prompts):
            return self._scaled(super().prefill, prompts)

        def decode(self, state, token):
            return self._scaled(super().decode, state, token)

    r = _run(root, system=ScaledLayer)
    assert not r["correct"], r["checks"]
    assert r["checks"]["logit_gap"]["value"] > 1e-3


def test_traced_standin_reports_its_spans(root, monkeypatch):
    seen = []
    summarize = program_trace.summarize

    def spy(events, spans, prefixes):
        seen.append((tuple(spans), tuple(prefixes)))
        return summarize(events, spans, prefixes)

    monkeypatch.setattr(program_trace, "summarize", spy)
    r = _run(root, trace=True)
    assert r["correct"], r["checks"]
    cell = spec.load_cell(root, CELL)
    assert seen == [(cell.driver.SPANS, cell.family.PREFIXES)]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == {"prefill_span_ms", "decode_span_ms"}
    assert m["prefill_span_ms"] > m["decode_span_ms"] > 0
