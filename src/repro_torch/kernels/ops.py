"""Public ops of the port with the ``mode=`` dispatch of ``repro``'s ops.

``mode``:

* ``"auto"`` — the CUDA kernel for CUDA tensors, the plain PyTorch
  version (``kernels/ref.py``) for CPU tensors;
* ``"cuda"`` — force the kernel; a CPU tensor raises;
* ``"ref"`` — force the plain version, on whatever device the tensors are.

``repro``'s own mode names are taken as aliases (:data:`MODE_ALIASES`):
``"xla"`` and ``"twopass"`` are ``"ref"``, ``"pallas"`` and ``"fused"`` are
``"cuda"`` (a CPU tensor raises, as under ``"cuda"``). ``"interpret"``
raises: it runs a Pallas kernel in the TPU interpreter, and a CUDA kernel
has no interpreter.

There is no fallback: a kernel that fails to build or launch raises.

DTensor inputs (a sharded model, ``launch.sharding``): the attention
kernels (9, 10, 11) are local per row of their (batch x heads) leading dim,
so on the kernel route they run on each rank's local shards and the output
is rewrapped with the inputs' placements (:func:`on_local_shards`; the
models call it on their (B, S, H, e) tensors, batch and heads the rows). A
placement that shards what a kernel reduces over (the sequence, the
features), or a pending sum, is redistributed to ``Replicate()`` first;
inputs whose rows are placed unlike raise.
The plain route runs the plain version through DTensor's own ops.

The ops that ``repro``'s dispatch layer wraps (the bank read, the KLMS and
KRLS step and chunk, the two replay elements, the decode block) report to
``obs.telemetry`` and open a ``kernel.<op>`` span (:func:`_dispatch`). The
port has no jit trace, so every call counts as live: ``kernel.launches``
is the number of kernel launches the op makes (one a time block), which
equals the rise of the wrapper's ``.launches`` on the card.

The ops accept ``repro``'s tiling keywords (``block_m``, ``block_n``,
``block_k``, ``block_b``, ``block_q``) and ignore them: the CUDA kernels
tile by their own sizes, and a tile changes no result beyond summation
order.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch.kernels import ref
from repro_torch.kernels.chunking import (
    default_chunk_t,
    default_decode_block_t,
    time_blocks,
    unblock_time,
    valid_time_mask,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rff_attention import (
    rff_attention_cuda,
    rff_attention_decode_block_cuda,
)
from repro_torch.kernels.rff_features import rff_features_cuda
from repro_torch.kernels.rff_klms_step import (
    rff_klms_bank_chunk_cuda,
    rff_klms_bank_step_cuda,
)
from repro_torch.kernels.rff_krls_step import (
    rff_krls_bank_chunk_cuda,
    rff_krls_bank_step_cuda,
)
from repro_torch.kernels.rff_predict import rff_bank_predict_cuda
from repro_torch.kernels.rff_scan import (
    rff_klms_chunk_elements_cuda,
    rff_krls_chunk_elements_cuda,
)
from repro_torch.obs import telemetry as _telemetry
from repro_torch.obs import trace as _trace

__all__ = [
    "MODES",
    "MODE_ALIASES",
    "default_backend",
    "use_kernel",
    "on_local_shards",
    "rff_features",
    "rff_bank_predict",
    "rff_klms_bank_step",
    "rff_klms_bank_chunk",
    "rff_krls_bank_step",
    "rff_krls_bank_chunk",
    "rff_klms_chunk_elements",
    "rff_krls_chunk_elements",
    "rff_attention",
    "rff_attention_decode",
    "rff_attention_decode_block",
    "flash_attention",
]

MODES = ("auto", "cuda", "ref")
MODE_ALIASES = {"xla": "ref", "twopass": "ref", "pallas": "cuda",
                "fused": "cuda"}


def default_backend() -> str:
    """The backend the ``"auto"`` mode launches kernels on: ``"cuda"`` when
    a CUDA device is visible, else ``"cpu"`` (the plain versions).
    ``repro``'s returns JAX's backend name."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def use_kernel(mode: str, lead: torch.Tensor) -> bool:
    """Resolve ``mode`` (or a ``repro`` alias of it) for the op whose
    leading tensor is ``lead``."""
    if mode == "interpret":
        raise ValueError(
            'kernel mode "interpret" runs a Pallas kernel in the TPU '
            'interpreter; the CUDA kernels have none: use "ref" for the '
            'plain version or "cuda" for the kernel')
    mode = MODE_ALIASES.get(mode, mode)
    if mode == "auto":
        return lead.device.type == "cuda"
    if mode == "cuda":
        return True
    if mode == "ref":
        return False
    raise ValueError(f"unknown kernel mode {mode!r}; pick from {MODES} "
                     f"or {tuple(MODE_ALIASES)}")


_SPAN_NAMES: dict[str, str] = {}
_NO_SPAN = contextlib.nullcontext()


def _dispatch(op: str, *, launches: int = 1, remainder: int = 0,
              bytes_moved=None, attrs: Callable[[], dict]):
    """Record one call of ``op`` (``launches`` launches, ``remainder`` of
    them a short last block) and open its ``kernel.<op>`` span (a shared
    null context when nothing records). ``attrs`` returns the span's
    attributes; it is called only when a tracer records them."""
    _telemetry.record_dispatch(op, launches=launches, remainder=remainder,
                               bytes_moved=bytes_moved)
    if not _trace.recording():
        return _NO_SPAN
    name = _SPAN_NAMES.get(op)
    if name is None:
        name = _SPAN_NAMES[op] = f"kernel.{op}"
    if _trace.current_tracer() is None:
        return _trace.span(name)  # a profiler range: it takes no attributes
    return _trace.span(name, launches=launches, **attrs())


def _tracks_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# Kernels 10 and 11 under autograd: (the kernel's wrapper, its plain
# version), each named by the op's module attribute so that a test can
# swap the kernel for its plain version.
_RFF_ATTENTION = ("rff_attention_cuda", "chunked_linear_attention_ref")
_FLASH_ATTENTION = ("flash_attention_cuda", "flash_attention_ref")


class _KernelWithPlainGrad(torch.autograd.Function):
    """An attention kernel's forward with its plain version's gradient.

    The forward launches the CUDA kernel (the serving path's bits) and
    saves the inputs; the backward recomputes the plain version
    (``kernels/ref.py``) under autograd and returns ``torch.autograd.grad``
    of its output against the incoming gradient. ``repro`` has no backward
    Pallas kernel and no ``custom_vjp`` for these kernels. The recompute
    holds one call's plain intermediates at a time (flash's (BH, S, S) f32
    scores)."""

    @staticmethod
    def forward(ctx, names, kw, *inputs):
        kernel, plain = names
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*inputs)
        return globals()[kernel](*inputs, **kw)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, need)]
            out = getattr(ref, ctx.plain)(*xs, **ctx.kw)
            wanted = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad_out))
        return (None, None, *(next(got) if n else None for n in need))


def on_local_shards(fn, tensors, layouts, *, shared=(), outs=(0,), **kw):
    """``fn(*tensors, *shared, **kw)`` on the local shards of DTensor inputs:
    the attention kernels' boundary.

    ``layouts[i]`` is ``(row_dims, reduced_dims)`` of ``tensors[i]``: its
    row dims are independent rows of the kernel (batch, heads), taken as
    they are sharded; a shard of a reduced dim (a sequence the kernel walks,
    a feature dim it contracts) and a pending sum are redistributed to
    ``Replicate()`` first; a shard of any other dim raises. The tensors'
    rows are placed alike: where one input splits its k-th row dim on a
    mesh dim, the others are cut the same way (a local slice for a whole
    input: a GQA key's replicated heads; a reduction for a pending sum);
    two inputs splitting rows differently raise. ``shared`` tensors (feature weights) are read whole by
    every row and must be replicated. Output j (of a tensor or a tuple) has
    the layout of ``tensors[outs[j]]``: it keeps the kernel's row split,
    and where that input had a shard of a reduced dim (a decode state's
    features) it is put back on it (a local cut). With
    plain tensors ``fn`` runs directly."""
    if not any(isinstance(t, DTensor) for t in (*tensors, *shared)
               if t is not None):
        return fn(*tensors, *shared, **kw)
    if not all(isinstance(t, DTensor) for t in (*tensors, *shared)
               if t is not None):
        raise TypeError("a kernel takes all DTensors or all plain tensors")
    mesh = tensors[0].device_mesh
    given = [tuple(t.placements) for t in tensors]
    # Each mesh dim splits the k-th row dim of every input (a row's shard
    # on one input is the same rows' on the others), or nothing.
    signature, owner = [None] * mesh.ndim, [None] * mesh.ndim
    for i, (t, (rows, reduced)) in enumerate(zip(tensors, layouts)):
        if t.device_mesh != mesh:
            raise ValueError("a kernel's inputs must share one mesh")
        for m, p in enumerate(t.placements):
            sharded = isinstance(p, (Shard, _StridedShard))
            if not sharded or p.dim in reduced:
                continue
            if p.dim not in rows:
                raise ValueError(
                    f"a kernel cannot take placement {p} of {t.placements}:"
                    f" it runs on whole rows (dims {rows} may be sharded, "
                    f"dims {reduced} are made whole)")
            sig = (rows.index(p.dim), getattr(p, "split_factor", 1))
            if signature[m] is None:
                signature[m], owner[m] = sig, i
            elif signature[m] != sig:
                raise ValueError(
                    f"kernel inputs on placements {given[owner[m]]} and "
                    f"{given[i]}: the rows must be placed alike")
    local, wants = [], []
    for t, (rows, _) in zip(tensors, layouts):
        want = []
        for m, sig in enumerate(signature):
            if sig is None:
                want.append(Replicate())
                continue
            r, split = sig
            lead = tensors[owner[m]]
            if t.shape[rows[r]] != lead.shape[layouts[owner[m]][0][r]]:
                raise ValueError(
                    f"kernel inputs on placements {given[owner[m]]} and "
                    f"{tuple(t.placements)}: the rows must be placed alike")
            want.append(Shard(rows[r]) if split == 1 else
                        _StridedShard(rows[r], split_factor=split))
        wants.append(tuple(want))
        if tuple(want) != tuple(t.placements):
            t = t.redistribute(mesh, want)
        local.append(t.to_local())
    for t in shared:
        if t is not None and not all(type(p) is Replicate
                                     for p in t.placements):
            raise ValueError(f"a kernel's weights must be replicated, not "
                             f"{t.placements}")
    # A shared weight's gradient on a rank is its rows' part of the sum.
    partial = [Replicate() if s is None else Partial() for s in signature]
    out = fn(*local, *(None if t is None else t.to_local(
        grad_placements=partial) for t in shared), **kw)

    def wrap(o, i):
        rows = layouts[i][0]
        shape = torch.Size(tensors[i].shape[d] if d in rows else n
                           for d, n in enumerate(o.shape))
        places = wants[i]
        o = DTensor.from_local(o.contiguous(), mesh, places, run_check=False,
                               shape=shape, stride=torch.empty(
                                   shape, device="meta").stride())
        back = tuple(g if isinstance(g, (Shard, _StridedShard)) else p
                     for g, p in zip(given[i], places))
        return o if places == back else o.redistribute(mesh, back)

    if not isinstance(out, tuple):
        return wrap(out, outs[0])
    return tuple(wrap(o, i) for o, i in zip(out, outs))


# (BH, S, e) inputs of kernels 10 and 11: rows dim 0, the sequence and the
# features whole.
_BH_LAYOUT = ((0,), (1, 2))


def _blocks(tlen: int, chunk: int) -> tuple[int, int]:
    """Launches and short last blocks of a T-tick call at ``chunk``."""
    if tlen <= chunk:
        return 1, 0
    return -(-tlen // chunk), int(tlen % chunk != 0)


def rff_features(x, w, b, s=None, *, mode: str = "auto", block_m: int = 128,
                 block_n: int = 128, block_k: int = 128, precision=None):
    """Affine-trig feature map ``s * cos(x @ w + b)`` over arbitrary leading
    dims of ``x (..., d)`` -> ``(..., D)``; ``s=None`` is the Monte-Carlo
    ``sqrt(2/D)``. ``precision="bf16"`` follows the contract in
    ``kernels/ref.py`` (bf16 operands, f32 accumulation, bf16 features).
    ``block_m``, ``block_n`` and ``block_k`` are ``repro``'s tiles, accepted
    and ignored (the kernel's tiles are its own)."""
    del block_m, block_n, block_k
    precision = ref.canon_precision(precision)
    if not use_kernel(mode, x):
        return ref.rff_features_ref(x, w, b, s, precision)
    if x.ndim == 2:
        return rff_features_cuda(x.contiguous(), w, b, s, precision)
    lead = x.shape[:-1]
    out = rff_features_cuda(x.reshape(-1, x.shape[-1]).contiguous(), w, b, s,
                            precision)
    return out.reshape(*lead, w.shape[-1])


def rff_bank_predict(theta, xq, w, b, s=None, *, mode: str = "auto",
                     block_b: int = 8, block_q: int = 64, precision=None):
    """Fused predict-only read path: a ``(B, Q, d)`` query block per
    tenant against read-only ``theta (B, D)`` -> ``(B, Q)``.
    ``precision="bf16"`` follows the contract in ``kernels/ref.py``.
    ``block_b`` and ``block_q`` are ``repro``'s tiles, accepted and ignored:
    the kernel's blocks own 128 (tenant, query) rows each."""
    del block_b, block_q
    precision = ref.canon_precision(precision)
    bank, q, d = xq.shape
    bm = _telemetry.predict_read_bytes(bank, d, w.shape[-1], q)
    with _dispatch("bank_predict", bytes_moved=bm["fused_bytes"],
                   attrs=lambda: dict(
                       shape=[bank, q, d], dfeat=w.shape[-1],
                       dtype=str(theta.dtype), mode=mode,
                       precision=precision)):
        if use_kernel(mode, theta):
            return rff_bank_predict_cuda(theta, xq, w, b, s,
                                         precision=precision)
        return ref.rff_bank_predict_ref(theta, xq, w, b, s, precision)


def rff_klms_bank_step(theta, x, y, w, b, mu, s=None, *, mode: str = "auto",
                       block_b: int = 8):
    """Fused featurize + predict + update KLMS tick for a bank of B
    filters: theta (B, D), x (B, d), y (B,), mu scalar or (B,).
    Returns (theta', predictions, prior errors). ``block_b`` is
    ``repro``'s tile, accepted and ignored (one warp holds a tenant)."""
    del block_b
    bank, d = x.shape
    bm = _telemetry.klms_chunk_bytes(bank, d, theta.shape[-1], 1)
    with _dispatch("klms_step", bytes_moved=bm["bytes_per_tick_model"],
                   attrs=lambda: dict(
                       shape=[bank, d], dfeat=theta.shape[-1],
                       dtype=str(theta.dtype), mode=mode)):
        if use_kernel(mode, theta):
            return rff_klms_bank_step_cuda(theta, x, y, w, b, mu, s)
        return ref.rff_klms_bank_step_ref(theta, x, y, w, b, mu, s)


def rff_klms_bank_chunk(theta, xs, ys, w, b, mu, mask=None, s=None, *,
                        mode: str = "auto", block_b: int = 8, chunk=None):
    """T-chunked fused KLMS: advance B filters by T ticks.

    theta (B, D), xs (B, T, d), ys (B, T), mu scalar or (B,), mask
    optional (B, T) validity gate (1 = apply the update). ``chunk`` bounds
    the ticks per launch: ``chunk=k`` runs ceil(T/k) launches with a
    zero-masked final remainder; ``None`` takes
    ``kernels.chunking.default_chunk_t``. ``block_b`` is ``repro``'s tile,
    accepted and ignored (one warp holds a tenant). Returns (theta', preds
    (B, T), errs (B, T)).
    """
    del block_b
    if use_kernel(mode, theta):
        launch = rff_klms_bank_chunk_cuda
    else:
        launch = ref.rff_klms_bank_chunk_ref
    bank, tlen, d = xs.shape
    dfeat = theta.shape[-1]
    if chunk is None:
        chunk = default_chunk_t(bank, dfeat, d)
    launches, remainder = _blocks(tlen, chunk)
    bm = _telemetry.klms_chunk_bytes(bank, d, dfeat, min(chunk, tlen))
    with _dispatch("klms_chunk", launches=launches, remainder=remainder,
                   bytes_moved=bm["launch_bytes"] * launches
                   + bm["stream_bytes_per_tick"] * tlen,
                   attrs=lambda: dict(
                       shape=[bank, tlen, d], dfeat=dfeat,
                       dtype=str(theta.dtype), mode=mode, chunk=chunk)):
        return _time_blocked(
            lambda state, xc, yc, mc: launch(*state, xc, yc, w, b, mu, mc,
                                             s),
            (theta,), xs, ys, mask, chunk,
        )


def _time_blocked(launch, state, xs, ys, mask, chunk):
    """Run ``launch(state, xs, ys, mask) -> (*state', preds, errs)`` over
    ``xs (B, T, d)`` in launches of at most ``chunk`` ticks, the last one
    zero-masked past T, as ``repro``'s ops do. Returns (*state', preds
    (B, T), errs (B, T))."""
    tlen = xs.shape[1]
    if tlen <= chunk:
        return launch(state, xs, ys, mask)
    if mask is None:
        mask = torch.ones_like(ys)
    blocks = zip(
        time_blocks(xs, chunk, axis=1),
        time_blocks(ys, chunk, axis=1),
        time_blocks(mask.to(ys.dtype), chunk, axis=1),
    )
    preds, errs = [], []
    for xc, yc, mc in blocks:
        *state, p, e = launch(
            state, xc.contiguous(), yc.contiguous(), mc.contiguous()
        )
        preds.append(p)
        errs.append(e)
    return (
        *state,
        unblock_time(torch.stack(preds), tlen, axis=1),
        unblock_time(torch.stack(errs), tlen, axis=1),
    )


def rff_krls_bank_step(theta, pmat, x, y, w, b, beta, s=None, *,
                       mode: str = "auto"):
    """Fused featurize + predict + EW-RLS update for a bank of B tenants:
    theta (B, D), pmat (B, D, D), x (B, d), y (B,), beta scalar or (B,).
    Returns (theta', P', predictions, prior errors)."""
    bank, d = x.shape
    bm = _telemetry.krls_chunk_bytes(bank, d, theta.shape[-1], 1)
    with _dispatch("krls_step", bytes_moved=bm["bytes_per_tick_model"],
                   attrs=lambda: dict(
                       shape=[bank, d], dfeat=theta.shape[-1],
                       dtype=str(theta.dtype), mode=mode)):
        if use_kernel(mode, theta):
            return rff_krls_bank_step_cuda(theta, pmat, x, y, w, b, beta, s)
        return ref.rff_krls_bank_step_ref(theta, pmat, x, y, w, b, beta, s)


def rff_krls_bank_chunk(theta, pmat, xs, ys, w, b, beta, mask=None, s=None,
                        *, mode: str = "auto", chunk=None):
    """T-chunked fused EW-RLS: advance B tenants by T ticks.

    theta (B, D), pmat (B, D, D), xs (B, T, d), ys (B, T), beta scalar or
    (B,), mask optional (B, T) validity gate. ``chunk`` bounds the ticks
    per launch as in :func:`rff_klms_bank_chunk`. Returns (theta', P',
    preds (B, T), errs (B, T)).
    """
    if use_kernel(mode, theta):
        launch = rff_krls_bank_chunk_cuda
    else:
        launch = ref.rff_krls_bank_chunk_ref
    bank, tlen, d = xs.shape
    dfeat = theta.shape[-1]
    if chunk is None:
        chunk = default_chunk_t(bank, dfeat, d, pmat=True)
    launches, remainder = _blocks(tlen, chunk)
    bm = _telemetry.krls_chunk_bytes(bank, d, dfeat, min(chunk, tlen))
    with _dispatch("krls_chunk", launches=launches, remainder=remainder,
                   bytes_moved=bm["launch_bytes"] * launches
                   + bm["stream_bytes_per_tick"] * tlen,
                   attrs=lambda: dict(
                       shape=[bank, tlen, d], dfeat=dfeat,
                       dtype=str(theta.dtype), mode=mode, chunk=chunk)):
        return _time_blocked(
            lambda state, xc, yc, mc: launch(*state, xc, yc, w, b, beta, mc,
                                             s),
            (theta, pmat), xs, ys, mask, chunk,
        )


def _element_blocks(xs, ys, dfeat, chunk):
    """Time-block one stream ``xs (T, d)``, ``ys (T,)`` into ``(nc, Tc, d)``,
    ``(nc, Tc)`` and the ``(nc, Tc)`` validity mask (the padded remainder
    masked); ``chunk=None`` takes ``default_chunk_t(..., elements=True)``.
    When Tc divides T no tick is padded: the blocks are views and the mask
    is None (every tick live), which gives the same elements."""
    tlen, d = xs.shape
    if chunk is None:
        chunk = default_chunk_t(1, dfeat, d, elements=True)
    chunk = min(chunk, tlen)
    if tlen % chunk == 0 and xs.is_contiguous() and ys.is_contiguous():
        nc = tlen // chunk
        return xs.view(nc, chunk, d), ys.view(nc, chunk), None
    return (
        time_blocks(xs, chunk).contiguous(),
        time_blocks(ys, chunk).contiguous(),
        valid_time_mask(tlen, chunk, xs.dtype, xs.device),
    )


def rff_klms_chunk_elements(xs, ys, w, b, mu, s=None, *, mode: str = "auto",
                            chunk=None, normalized: bool = False,
                            eps: float = 1e-6):
    """Per-chunk composed KLMS affine elements for the replay scan.

    xs (T, d), ys (T,): ONE replayed stream (a tenant's log); shared w
    (d, D), b (D,), s optional (D,); mu a scalar. The stream is cut into
    ceil(T / chunk) chunks, the last one zero-masked past T (its padding
    composes the identity), and each chunk folds into one ``theta -> a
    theta + v`` element. Returns ``(a (nc, D, D), v (nc, D))``.
    """
    xs_c, ys_c, mask_c = _element_blocks(xs, ys, w.shape[-1], chunk)
    with _dispatch("klms_elements",
                   attrs=lambda: dict(
                       shape=list(xs.shape), dfeat=w.shape[-1],
                       chunks=xs_c.shape[0], dtype=str(xs.dtype), mode=mode,
                       chunk=xs_c.shape[1])):
        if use_kernel(mode, xs):
            return rff_klms_chunk_elements_cuda(
                xs_c, ys_c, w, b, mu, mask_c, s, normalized=normalized,
                eps=eps)
        return ref.klms_chunk_elements_ref(
            xs_c, ys_c, w, b, mu, mask_c, s, normalized=normalized, eps=eps
        )


def rff_krls_chunk_elements(xs, ys, w, b, beta, s=None, *,
                            mode: str = "auto", chunk=None):
    """Per-chunk composed KRLS decay elements for the replay scan: layout
    as :func:`rff_klms_chunk_elements`, ``beta`` the scalar forgetting
    factor; masked remainder ticks compose ``(1, 0, 0)``. Returns ``(g
    (nc,), phi (nc, D, D), r (nc, D))``."""
    xs_c, ys_c, mask_c = _element_blocks(xs, ys, w.shape[-1], chunk)
    with _dispatch("krls_elements",
                   attrs=lambda: dict(
                       shape=list(xs.shape), dfeat=w.shape[-1],
                       chunks=xs_c.shape[0], dtype=str(xs.dtype), mode=mode,
                       chunk=xs_c.shape[1])):
        if use_kernel(mode, xs):
            return rff_krls_chunk_elements_cuda(xs_c, ys_c, w, b, beta,
                                                mask_c, s)
        return ref.krls_chunk_elements_ref(xs_c, ys_c, w, b, beta, mask_c,
                                           s)


def rff_attention(phi_q, phi_k, v, *, mode: str = "auto", chunk: int = 256,
                  normalize: bool = True, eps: float = 1e-6):
    """Causal linear attention over feature-mapped q/k: phi_q, phi_k (BH, S,
    D), v (BH, S, dv) -> (BH, S, dv). ``S`` must be a multiple of
    ``min(chunk, S)``. The plain version is the chunked form
    (``ref.chunked_linear_attention_ref``, O(S C D)), as ``repro``'s XLA
    path."""
    kw = dict(chunk=chunk, normalize=normalize, eps=eps)
    if not use_kernel(mode, phi_q):
        return ref.chunked_linear_attention_ref(phi_q, phi_k, v, **kw)
    return on_local_shards(_rff_attention_kernel, (phi_q, phi_k, v),
                           (_BH_LAYOUT,) * 3, **kw)


def _rff_attention_kernel(phi_q, phi_k, v, **kw):
    if _tracks_grad(phi_q, phi_k, v):
        return _KernelWithPlainGrad.apply(_RFF_ATTENTION, kw, phi_q, phi_k,
                                          v)
    return rff_attention_cuda(phi_q, phi_k, v, **kw)


def rff_attention_decode(s_state, z_state, phi_q, phi_k, v, *,
                         eps: float = 1e-6):
    """One decode step from the fixed-size state over given features:
    s_state (BH, D, dv), z_state (BH, D), phi_q, phi_k (BH, D), v (BH, dv).
    Returns (output (BH, dv), S', z'). Plain PyTorch only: ``repro``'s op
    is an XLA function with no kernel."""
    s_new = s_state + torch.einsum("bd,bv->bdv", phi_k, v)
    z_new = z_state + phi_k
    num = torch.einsum("bd,bdv->bv", phi_q, s_new)
    den = torch.einsum("bd,bd->b", phi_q, z_new) + eps
    return num / den[:, None], s_new, z_new


def rff_attention_decode_block(s_state, z_state, q, k, v, w, b, s=None, *,
                               feature_kind: str = "prf", mode: str = "auto",
                               block_t=None, normalize: bool = True,
                               eps: float = 1e-6, precision=None):
    """Advance the fixed-size attention state by T pre-projected tokens in
    ceil(T / block_t) launches: q, k (BH, T, dh), v (BH, T, dv), w (dh, D),
    b (D,), s (D,) or None (``ref.default_decode_scale``); the feature map
    (``feature_kind`` "prf" or "trig") runs in the kernel under the
    precision contract of ``kernels/ref.py``.

    ``block_t=None`` takes ``kernels.chunking.default_decode_block_t``.
    Full blocks run in turn, then one unpadded launch for the remainder: a
    PRF feature of a zero token is not 0, so padded ticks would corrupt
    the state. Returns (outputs (BH, T, dv) f32, S', z')."""
    bh, tlen, dh = q.shape
    dv = v.shape[-1]
    dfeat = w.shape[-1]
    if block_t is None:
        block_t = default_decode_block_t(dfeat, dv, dh)
    if use_kernel(mode, q):
        def launch(sm, zv, qb, kb, vb, w, b, s, **kw):
            return on_local_shards(rff_attention_decode_block_cuda,
                                   (sm, zv, qb, kb, vb),
                                   (_BH_LAYOUT, ((0,), (1,)),
                                    *(_BH_LAYOUT,) * 3),
                                   shared=(w, b, s), outs=(2, 0, 1), **kw)
    else:
        launch = ref.rff_attention_decode_block_ref

    def run(sm, zv, lo, hi):
        return launch(sm, zv, q[:, lo:hi].contiguous(),
                      k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(),
                      w, b, s, feature_kind=feature_kind,
                      normalize=normalize, eps=eps, precision=precision)

    s_state, z_state = s_state.float(), z_state.float()
    launches, remainder = _blocks(tlen, block_t)
    with _dispatch("decode_block", launches=launches, remainder=remainder,
                   attrs=lambda: dict(
                       shape=[bh, tlen, dh], dfeat=dfeat, dtype=str(q.dtype),
                       mode=mode, block_t=block_t, feature_kind=feature_kind,
                       precision=precision)):
        if tlen <= block_t:
            return run(s_state, z_state, 0, tlen)
        outs = []
        for lo in range(0, tlen, block_t):
            out, s_state, z_state = run(s_state, z_state, lo,
                                        min(lo + block_t, tlen))
            outs.append(out)
        return torch.cat(outs, dim=1), s_state, z_state


def flash_attention(q, k, v, *, mode: str = "auto", block_q: int = 256,
                    block_k: int = 256, causal: bool = True):
    """Exact softmax attention: q, k (BH, S, dh), v (BH, S, dv), f32 or
    bf16 -> (BH, S, dv) in q's type (dh, dv <= 256). ``block_q`` and
    ``block_k`` are ``repro``'s tiles, accepted and ignored: the CUDA
    kernels tile by their own sizes (``kernels.flash_attention.flash_plan``),
    and tiles only order the online softmax's sums."""
    del block_q, block_k
    if not use_kernel(mode, q):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return on_local_shards(_flash_attention_kernel, (q, k, v),
                           (_BH_LAYOUT,) * 3, causal=causal)


def _flash_attention_kernel(q, k, v, *, causal):
    if _tracks_grad(q, k, v):
        return _KernelWithPlainGrad.apply(_FLASH_ATTENTION,
                                          dict(causal=causal), q, k, v)
    return flash_attention_cuda(q, k, v, causal=causal)
