"""Serving stack: the KLMS and KRLS tiers (micro-batch queue, snapshot
server, the slot policy, the ``make_server`` facade, the recovery tier),
the LM serving loop (``serve_loop``) and ``repro``'s deprecated
pre-facade factory names (one ``DeprecationWarning`` each a process)."""
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

# Deprecated pre-facade entry points (DeprecationWarning shims over the
# facade, as in repro).
from repro_torch.serve.bank_loop import (
    make_bank_server,
    make_krls_bank_server,
    reset_krls_tenants,
    reset_tenants,
    serve_bank_stream,
    serve_krls_bank_stream,
)
from repro_torch.serve.queue import (
    klms_micro_batch_queue,
    krls_micro_batch_queue,
    make_chunked_bank_server,
    make_chunked_krls_bank_server,
)
from repro_torch.serve.snapshot import (
    klms_snapshot_server,
    krls_snapshot_server,
)

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
    "make_bank_server",
    "serve_bank_stream",
    "reset_tenants",
    "make_krls_bank_server",
    "serve_krls_bank_stream",
    "reset_krls_tenants",
    "make_chunked_bank_server",
    "make_chunked_krls_bank_server",
    "klms_micro_batch_queue",
    "krls_micro_batch_queue",
    "klms_snapshot_server",
    "krls_snapshot_server",
]
