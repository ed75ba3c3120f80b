"""A copy of the benchmark at a size the CPU runs in a second, for the
tests: the same files and limits, with the configurations and traffic
mixes cut down, written into a temporary folder."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "klms-d128-D2048": {"input_dim": 8, "num_features": 64, "sigma": 3.0,
                        "bank": 16, "chunk": 4},
    "krls-paper-d5-D300": {"num_features": 24, "bank": 16, "chunk": 4},
}
TINY_TRAFFIC = {"stream_ticks": 32, "reset_every": 2, "warmup_rounds": 4,
                "pool_sessions": 2}
def tiny_bench(tmp: Path) -> Path:
    """A checkout root under ``tmp`` holding ``BENCHMARK.json`` and a cut
    copy of ``portbench``; returns the root."""
    root = Path(tmp) / "bench"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        path = root / conf["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY_CONFIG[conf["name"]])
        path.write_text(json.dumps(cfg))
    for path in (root / "portbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(TINY_TRAFFIC)
        if t["queries"]:
            t.update(queries=8, pool_read_blocks=4)
        if "reads_per_round" in t:
            t.update(reads_per_round=6)
        path.write_text(json.dumps(t))
    return root
