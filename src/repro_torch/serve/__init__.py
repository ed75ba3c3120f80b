"""Serving stack: the KLMS and KRLS tiers (micro-batch queue, snapshot
server, the ``make_server`` facade) and the LM serving loop
(``serve_loop``)."""
from repro_torch.serve.api import (
    LEARNER_FAMILIES,
    Server,
    make_chunk_step,
    make_queue,
    make_server,
    make_tick,
    run_stream,
)
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.queue import MicroBatchQueue
from repro_torch.serve.serve_loop import generate, path_logits, prefill_tokens
from repro_torch.serve.snapshot import SnapshotServer, StateSnapshot
