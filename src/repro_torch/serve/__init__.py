"""Serving stack: the KLMS and KRLS tiers (micro-batch queue, snapshot
server, the slot policy, the ``make_server`` facade, the recovery tier)
and the LM serving loop (``serve_loop``)."""
from repro_torch.serve.api import (
    LEARNER_FAMILIES,
    Server,
    make_chunk_step,
    make_queue,
    make_server,
    make_tick,
    reset_slots,
    run_stream,
)
from repro_torch.serve.metrics import Counter, Histogram, MetricsRegistry
from repro_torch.serve.policy import SCORERS, AdmitDecision, SlotPolicy
from repro_torch.serve.queue import MicroBatchQueue
from repro_torch.serve.recovery import (
    DurableLog,
    RecoveryPolicy,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.serve.serve_loop import generate, path_logits, prefill_tokens
from repro_torch.serve.snapshot import ReplayLog, SnapshotServer, StateSnapshot

__all__ = [
    "generate",
    "prefill_tokens",
    "path_logits",
    "LEARNER_FAMILIES",
    "Server",
    "make_server",
    "make_tick",
    "make_chunk_step",
    "make_queue",
    "run_stream",
    "reset_slots",
    "SlotPolicy",
    "AdmitDecision",
    "SCORERS",
    "MetricsRegistry",
    "Counter",
    "Histogram",
    "MicroBatchQueue",
    "SnapshotServer",
    "StateSnapshot",
    "ReplayLog",
    "RecoveryPolicy",
    "DurableLog",
    "save_checkpoint",
    "restore_checkpoint",
]
