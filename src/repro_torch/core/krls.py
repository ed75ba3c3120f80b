"""RFF-KRLS — the paper's §6: exponentially weighted RLS on RFF-mapped data.

Counterpart of ``repro/core/krls.py``: the dense filter (init, step, run
and the chunked run) and, in the second half, the filter with P
row-sharded over a ``torch.distributed`` device mesh. The state is a fixed
``theta (D,)`` plus a fixed ``(D, D)`` inverse-correlation matrix:

    P_0 = I / lam,   z = z(x_n),   e = y_n - theta . z,
    g = P z / (beta + z . P z),   theta <- theta + g e,
    P <- (P - g (P z)^T) / beta,  then symmetrized.

``jax.lax.scan`` becomes a Python loop over the stream; the bank tier
(``core/bank.py``) runs many tenants through the CUDA kernels.

Sharded variant: a JAX mesh axis becomes a 1-D ``DeviceMesh`` dim (named
``"shard"``, ``launch/mesh.py`` builds it on the initialized process
group), ``shard_map`` becomes SPMD (every rank calls the same function)
and ``psum`` one explicit ``dist.all_reduce(SUM)`` on the dim's group.
State leaves at the API boundary are ``DTensor``s of the global shape
with ``Shard(0)`` rows (:func:`krls_state_specs` gives the placements
where ``repro`` gives ``PartitionSpec``s); a tick works on their
``.to_local()`` tensors and issues no collective but its own. Layout (n
ranks, Dn = D / n; rank r owns features ``r Dn .. (r+1) Dn``):

    omega (d, D) -> columns (d, Dn),  bias, scale (D,) -> (Dn,),
    theta (D,)   -> rows (Dn,),       P (D, D) -> rows (Dn, D).

A tick featurizes its slice ``z_l`` (kernel 6), forms ``z_l @ P_l`` (P
is symmetric, so these sum to ``P z``) and ``theta_l . z_l``, and one
all_reduce of the packed ``(2D + 1,)`` vector ``[pz_part, z scattered,
yhat_part]`` gives every rank ``P z``, ``z`` and the prediction. The
gain, the theta update and the ``(Dn, D)`` downdate are local. The
downdate forms ``(pz_i pz_j) * (1 / denom)`` (commutative products round
alike on both sides of the diagonal), so P stays bitwise symmetric with
no re-symmetrization, which is what licenses ``z_l @ P_l``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import resolve_device
from repro_torch.core.klms import StepOut
from repro_torch.features.base import (
    FeatureLike,
    TrigFeatures,
    as_trig,
    feature_dtype,
    featurize,
)
from repro_torch.kernels import ops

__all__ = [
    "RLSState",
    "rff_krls_init",
    "rls_step",
    "rff_krls_step",
    "rff_krls_run",
    "KRLS_SHARD_AXIS",
    "krls_state_specs",
    "krls_feature_specs",
    "shard_krls_rff",
    "sharded_krls_init",
    "make_sharded_krls_step",
    "make_sharded_krls_block_step",
    "make_sharded_krls_predict",
    "sharded_krls_run",
]


class RLSState(NamedTuple):
    theta: torch.Tensor  # (D,), or (B, D) for a bank
    pmat: torch.Tensor  # (D, D) inverse-correlation estimate, or (B, D, D)
    step: torch.Tensor  # () int32 iteration counter, or (B,)


def rff_krls_init(num_features: int, lam: float = 1e-4, dtype=torch.float32,
                  device="cuda") -> RLSState:
    """theta = 0, P_0 = I / lam."""
    dev = resolve_device(device)
    return RLSState(
        theta=torch.zeros(num_features, dtype=dtype, device=dev),
        pmat=torch.eye(num_features, dtype=dtype, device=dev) / lam,
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def rls_step(theta, pmat, z, y, beta):
    """One EW-RLS update in feature space; returns (theta, P, StepOut)."""
    y_hat = theta @ z
    err = y - y_hat
    pz = pmat @ z
    denom = beta + z @ pz
    gain = pz / denom
    theta = theta + gain * err
    pmat = (pmat - torch.outer(gain, pz)) / beta
    # Symmetrize to fight drift over long streams (numerical hygiene).
    pmat = 0.5 * (pmat + pmat.T)
    return theta, pmat, StepOut(prediction=y_hat, error=err)


def rff_krls_step(state: RLSState, sample, rff: FeatureLike,
                  beta: float = 0.9995):
    """Paper §6 on one ``(x_n, y_n)`` pair."""
    x, y = sample
    theta, pmat, out = rls_step(state.theta, state.pmat, featurize(rff, x),
                                y, beta)
    return RLSState(theta=theta, pmat=pmat, step=state.step + 1), out


def _stack(outs, like):
    if not outs:
        empty = like.new_zeros((0,))
        return StepOut(prediction=empty, error=empty)
    return StepOut(prediction=torch.stack([o.prediction for o in outs]),
                   error=torch.stack([o.error for o in outs]))


def rff_krls_run(rff: FeatureLike, xs: torch.Tensor, ys: torch.Tensor,
                 lam: float = 1e-4, beta: float = 0.9995,
                 state: Optional[RLSState] = None,
                 chunk: Optional[int] = None):
    """Drive the filter over ``xs (n, d)``, ``ys (n,)`` (paper §6 settings:
    lam = 1e-4, beta = 0.9995, D = 300). Returns the final state and
    per-step ``StepOut`` tensors ``(n,)``.

    ``chunk=T`` featurizes T samples at a time in one ``(T, d) @ (d, D)``
    product and replays the recursion over the precomputed rows (``repro``
    pads the last block and masks its padding; here the last block is
    short, which leaves the same state).
    """
    if state is None:
        state = rff_krls_init(rff.num_features, lam, feature_dtype(rff),
                              device=xs.device)
    outs = []
    if chunk is None:
        for x, y in zip(xs, ys):
            state, out = rff_krls_step(state, (x, y), rff, beta)
            outs.append(out)
        return state, _stack(outs, ys)
    for start in range(0, xs.shape[0], chunk):
        zc = featurize(rff, xs[start:start + chunk])
        for z, y in zip(zc, ys[start:start + chunk]):
            theta, pmat, out = rls_step(state.theta, state.pmat, z, y, beta)
            state = RLSState(theta=theta, pmat=pmat, step=state.step + 1)
            outs.append(out)
    return state, _stack(outs, ys)


# ---------------------------------------------------------------------------
# Sharded RFF-KRLS: P (and the feature columns) row-partitioned over a mesh.
# ---------------------------------------------------------------------------

KRLS_SHARD_AXIS = "shard"


def mesh_axis(mesh, axis: str) -> tuple:
    """``(process group, size, this rank's index)`` of the mesh dim named
    ``axis``."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no dim {axis!r} (its dims: {names})")
    dim = names.index(axis)
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


def krls_state_specs(axis: str = KRLS_SHARD_AXIS) -> RLSState:
    """Placements of an :class:`RLSState` on the 1-D mesh (``repro``'s
    PartitionSpecs): theta and P row-sharded, step replicated. ``axis`` is
    kept for ``repro``'s signature: a 1-D mesh has one dim to place on."""
    del axis
    return RLSState(theta=(Shard(0),), pmat=(Shard(0),), step=(Replicate(),))


def krls_feature_specs(axis: str = KRLS_SHARD_AXIS) -> TrigFeatures:
    """Placements of the canonical trig map: omega's columns, bias and
    scale sharded, so each rank featurizes exactly its P rows' slice."""
    del axis
    return TrigFeatures(omega=(Shard(1),), bias=(Shard(0),),
                        scale=(Shard(0),))


def _place(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """``local`` as this rank's shard of a ``shape`` DTensor (no
    collective: the shards are known to fit)."""
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def _local(a) -> torch.Tensor:
    if not isinstance(a, DTensor):
        raise TypeError(
            "sharded KRLS takes DTensor leaves (sharded_krls_init, "
            f"shard_krls_rff, convert.sharded_rls_state); got {type(a).__name__}"
        )
    return a.to_local()


def _rows(mesh, axis: str, dfull: int) -> tuple[int, int]:
    """``(first row, rows)`` of this rank's block; D must divide."""
    _, n, rank = mesh_axis(mesh, axis)
    if dfull % n:
        raise ValueError(
            f"num_features={dfull} must divide the {axis!r} axis ({n})")
    return rank * (dfull // n), dfull // n


def shard_krls_rff(mesh, rff: FeatureLike,
                   axis: str = KRLS_SHARD_AXIS) -> TrigFeatures:
    """Canonicalize to the affine-trig form (any trig family: rff, orf,
    qmc, gq) and keep this rank's feature columns, as DTensors on the
    mesh's device. Taylor has no column decomposition and raises
    (``as_trig``); a map already sharded is returned as it is."""
    tf = as_trig(rff)
    if isinstance(tf.omega, DTensor):
        return tf
    lo, dn = _rows(mesh, axis, tf.num_features)
    dev = resolve_device(mesh.device_type)
    specs = krls_feature_specs(axis)
    omega = tf.omega[:, lo:lo + dn].to(dev).contiguous()
    bias = tf.bias[lo:lo + dn].to(dev).contiguous()
    scale = tf.scale[lo:lo + dn].to(dev).contiguous()
    return TrigFeatures(
        omega=_place(omega, mesh, specs.omega, tf.omega.shape),
        bias=_place(bias, mesh, specs.bias, tf.bias.shape),
        scale=_place(scale, mesh, specs.scale, tf.scale.shape),
    )


def _placed_state(mesh, theta_l, pmat_l, step, dfull: int) -> RLSState:
    specs = krls_state_specs()
    return RLSState(
        theta=_place(theta_l, mesh, specs.theta, (dfull,)),
        pmat=_place(pmat_l, mesh, specs.pmat, (dfull, dfull)),
        step=_place(step, mesh, specs.step, ()),
    )


def sharded_krls_init(mesh, num_features: int, lam: float = 1e-4,
                      dtype=torch.float32,
                      axis: str = KRLS_SHARD_AXIS) -> RLSState:
    """``rff_krls_init`` row-sharded over ``axis`` (D must divide): each
    rank holds theta's and P = I / lam's rows of its features."""
    lo, dn = _rows(mesh, axis, num_features)
    dev = resolve_device(mesh.device_type)
    pmat_l = torch.zeros((dn, num_features), dtype=dtype, device=dev)
    idx = torch.arange(dn, device=dev)
    pmat_l[idx, lo + idx] = torch.ones(dn, dtype=dtype, device=dev) / lam
    return _placed_state(
        mesh, torch.zeros(dn, dtype=dtype, device=dev), pmat_l,
        torch.zeros((), dtype=torch.int32, device=dev), num_features)


def _downdate(src, dst, pz_l, pz, inv_denom, beta, scratch) -> torch.Tensor:
    """``dst <- (src - (pz_l pz^T) inv_denom) / beta`` through one
    P_l-sized ``scratch`` (``dst`` may be ``src``: in place). The outer
    product comes first, as in ``repro``, so elements (i, j) and (j, i)
    see the same operands and round alike: P stays bitwise symmetric
    (scaling pz_l first would break that). Three passes over P_l: the
    product, ``src + scratch * (-inv_denom)`` in one, the division."""
    torch.outer(pz_l, pz, out=scratch)
    return torch.addcmul(src, scratch, -inv_denom, out=dst).div_(beta)


class _Shard(NamedTuple):
    """What a tick needs of the mesh and the map: the dim's group, this
    rank's first feature, D, and the local trig columns."""

    group: object
    offset: int
    dfull: int
    tf: TrigFeatures


def _shard(mesh, tf: TrigFeatures, axis: str) -> _Shard:
    group, _, _ = mesh_axis(mesh, axis)
    local = TrigFeatures(*(_local(a) for a in tf))
    lo, _ = _rows(mesh, axis, tf.num_features)
    return _Shard(group, lo, tf.num_features, local)


def _sharded_rls_block_tick(theta_l, pmat_l, xs, ys, beta, sh: _Shard,
                            scratch, dst):
    """k = len(xs) sharded EW-RLS ticks with ONE all_reduce (the
    ``combine_every`` block; k = 1 is one tick). The downdated P_l is
    written to ``dst`` (``pmat_l`` itself: in place). Returns (theta_l,
    P_l, StepOut (k,)).

    Each rank contributes the block-start partials ``P_0^T z_j`` and
    ``theta_0 . z_j`` for all k samples; one packed ``(k, 2D + 1)``
    all_reduce replicates them, and the k-tick recursion is replayed
    exactly from those (an O(k^2 D) local replay):

        P_{i+1} z = (P_i z - (pz_i . z / denom_i) pz_i) / beta,
        theta_{i+1} . z = theta_i . z + (e_i / denom_i)(pz_i . z).

    Once tick j's ``pz_j`` is final it corrects every later row at once
    (one matrix-vector product and a rank-1 update of the rows after j),
    the same per-element arithmetic as ``repro``'s unrolled loop. A short
    block (the stream's tail) is simply a smaller k: ``repro`` pads it and
    masks the padding, which leaves the same state and outputs.
    """
    k = xs.shape[0]
    dfull, lo = sh.dfull, sh.offset
    dloc = theta_l.shape[0]
    z_l = ops.rff_features(xs, sh.tf.omega, sh.tf.bias, sh.tf.scale)
    packed = z_l.new_zeros((k, 2 * dfull + 1))
    packed[:, :dfull] = z_l @ pmat_l
    packed[:, dfull + lo:dfull + lo + dloc] = z_l
    packed[:, 2 * dfull] = z_l @ theta_l
    dist.all_reduce(packed, group=sh.group)  # the block's one collective
    pzs = packed[:, :dfull]  # rows become pz_j = P_j z_j as the replay goes
    z = packed[:, dfull:2 * dfull]
    preds = packed[:, 2 * dfull].clone()
    errs, inv_dens = [], []
    for j in range(k):
        inv_den = 1.0 / (beta + z[j] @ pzs[j])
        e = ys[j] - preds[j]
        if j + 1 < k:
            corr = (z[j + 1:] @ pzs[j]) * inv_den
            pzs[j + 1:] = (pzs[j + 1:] - corr[:, None] * pzs[j]) / beta
            preds[j + 1:] = preds[j + 1:] + e * corr
        errs.append(e)
        inv_dens.append(inv_den)
    errs = torch.stack(errs)
    inv_dens = torch.stack(inv_dens)
    pz_loc = pzs[:, lo:lo + dloc]
    theta_l = theta_l + (errs * inv_dens) @ pz_loc
    for j in range(k):
        pmat_l = _downdate(pmat_l, dst, pz_loc[j], pzs[j], inv_dens[j], beta,
                           scratch)
    return theta_l, pmat_l, StepOut(prediction=preds, error=errs)


def _block_fn(mesh, sh: _Shard, beta: float):
    """``(state, xs (k, d), ys (k,)) -> (state, StepOut (k,))`` on a state
    the caller keeps: each call writes a new P_l (one P_l-sized allocation
    a call; the caller's state is left as it was) through one scratch kept
    across calls."""
    scratch = []

    def block_fn(state: RLSState, xs: torch.Tensor, ys: torch.Tensor):
        pmat_l = _local(state.pmat)
        if not scratch:
            scratch.append(torch.empty_like(pmat_l))
        theta_l, pmat_l, out = _sharded_rls_block_tick(
            _local(state.theta), pmat_l, xs, ys, beta, sh, scratch[0],
            torch.empty_like(pmat_l))
        return (_placed_state(mesh, theta_l, pmat_l,
                              _local(state.step) + xs.shape[0], sh.dfull),
                out)

    return block_fn


def make_sharded_krls_step(mesh, rff: FeatureLike, beta: float = 0.9995,
                           axis: str = KRLS_SHARD_AXIS):
    """One-tick function ``(state, x (d,), y) -> (state, StepOut)`` with one
    all_reduce: the block of :func:`make_sharded_krls_block_step` at k = 1.
    ``rff`` is any trig map, given whole on every rank; it is placed by
    :func:`shard_krls_rff` once. The state carries :func:`krls_state_specs`
    (use :func:`sharded_krls_init`). Each call returns a new P_l (one
    P_l-sized allocation a tick, beside one scratch kept across calls);
    :func:`sharded_krls_run` updates its own state in place instead."""
    sh = _shard(mesh, shard_krls_rff(mesh, rff, axis), axis)
    block_fn = _block_fn(mesh, sh, beta)

    def step_fn(state: RLSState, x: torch.Tensor, y: torch.Tensor):
        y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
        state, out = block_fn(state, x[None], y.reshape(1))
        return state, StepOut(out.prediction[0], out.error[0])

    return step_fn


def make_sharded_krls_block_step(mesh, rff: FeatureLike,
                                 beta: float = 0.9995,
                                 combine_every: int = 8,
                                 axis: str = KRLS_SHARD_AXIS):
    """k-tick function ``(state, xs (k, d), ys (k,)) -> (state, StepOut
    (k,))`` with ONE all_reduce per k = ``combine_every`` ticks, exact
    modulo summation order (:func:`_sharded_rls_block_tick`); memory as
    :func:`make_sharded_krls_step`'s."""
    sh = _shard(mesh, shard_krls_rff(mesh, rff, axis), axis)
    k = combine_every
    block_fn = _block_fn(mesh, sh, beta)

    def block_step_fn(state: RLSState, xs: torch.Tensor, ys: torch.Tensor):
        if xs.shape[0] != k:
            raise ValueError(f"a block is combine_every={k} ticks; got "
                             f"{xs.shape[0]}")
        return block_fn(state, xs, ys)

    return block_step_fn


def make_sharded_krls_predict(mesh, rff: FeatureLike,
                              axis: str = KRLS_SHARD_AXIS):
    """``(state, x (..., d)) -> y_hat (...)`` on the sharded layout: each
    rank's partial ``theta_l . z_l(x)`` through the read kernel (kernel 3
    at B = 1 on its columns), then one all_reduce."""
    sh = _shard(mesh, shard_krls_rff(mesh, rff, axis), axis)

    def predict_fn(state: RLSState, x: torch.Tensor) -> torch.Tensor:
        theta_l = _local(state.theta)
        xq = x.reshape(1, -1, x.shape[-1]).contiguous()
        part = ops.rff_bank_predict(theta_l[None], xq, sh.tf.omega,
                                    sh.tf.bias, sh.tf.scale)
        dist.all_reduce(part, group=sh.group)
        return part.reshape(x.shape[:-1])

    return predict_fn


def sharded_krls_run(mesh, rff: FeatureLike, xs: torch.Tensor,
                     ys: torch.Tensor, lam: float = 1e-4,
                     beta: float = 0.9995, state: Optional[RLSState] = None,
                     axis: str = KRLS_SHARD_AXIS, combine_every: int = 1):
    """Run the filter over a stream on the sharded layout: ``xs (n, d)``,
    ``ys (n,)`` are the same on every rank (one global stream).
    ``combine_every=1`` runs one all_reduce a tick; ``combine_every=k`` one
    a k-tick block, the last block short when k does not divide n. Within
    ~1e-5 of :func:`rff_krls_run` in f32.

    Memory a rank: the state's P_l, updated in place when the run made the
    state (``state=None``; else the first block writes a new P_l and the
    caller's is left as it was), plus one P_l-sized scratch. Returns the
    state and per-tick ``StepOut`` tensors ``(n,)``, replicated."""
    tf = shard_krls_rff(mesh, rff, axis)
    sh = _shard(mesh, tf, axis)
    dev = resolve_device(mesh.device_type)
    xs, ys = xs.to(dev), ys.to(dev)
    if state is None:
        state = sharded_krls_init(mesh, sh.dfull, lam, feature_dtype(tf),
                                  axis)
        dst = _local(state.pmat)
    else:
        dst = torch.empty_like(_local(state.pmat))
    theta_l, pmat_l = _local(state.theta), _local(state.pmat)
    scratch = torch.empty_like(pmat_l)
    n = xs.shape[0]
    preds, errs = [], []
    for start in range(0, n, combine_every):
        stop = min(start + combine_every, n)
        theta_l, pmat_l, out = _sharded_rls_block_tick(
            theta_l, pmat_l, xs[start:stop], ys[start:stop], beta, sh,
            scratch, dst)
        preds.append(out.prediction)
        errs.append(out.error)
    outs = (StepOut(torch.cat(preds), torch.cat(errs)) if preds
            else StepOut(ys.new_zeros((0,)), ys.new_zeros((0,))))
    return (_placed_state(mesh, theta_l, pmat_l, _local(state.step) + n,
                          sh.dfull), outs)
