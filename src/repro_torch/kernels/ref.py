"""Plain PyTorch versions of the port's kernels (the oracles).

Counterparts of ``repro/kernels/ref.py``: deliberately naive, clarity over
speed. The CPU tests hold these against ``repro``; on the card the CUDA
kernels are held against these.

Read-path precision contract (one definition, shared by the oracles and
the CUDA kernels):

* ``precision=None`` / ``"f32"``: the featurize GEMM runs in f32.
* ``precision="bf16"``: the GEMM operands are rounded to bf16 and the
  products accumulate in f32; bias, cos and scale run in f32 on the f32
  accumulator; the feature block is then rounded to bf16. Every reduction
  against theta accumulates in f32. State (theta) stays f32.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.obs import trace as _trace

_NO_WAIT = contextlib.nullcontext()

__all__ = [
    "canon_precision",
    "mc_scale",
    "default_scale",
    "mp_project",
    "mp_trig",
    "rff_features_ref",
    "klms_tick_math",
    "krls_tick_math",
    "blocking",
    "to_device",
    "mu_column",
    "beta_column",
    "rff_klms_bank_step_ref",
    "rff_klms_bank_chunk_ref",
    "rff_bank_predict_ref",
    "rff_krls_bank_step_ref",
    "rff_krls_bank_chunk_ref",
    "krls_chunk_compact_ref",
    "klms_chunk_elements_ref",
    "klms_chunk_elements_wy_ref",
    "krls_chunk_elements_ref",
    "krls_chunk_elements_gram_ref",
    "prf_root",
    "default_decode_scale",
    "decode_features_ref",
    "rff_attention_ref",
    "rff_attention_state_ref",
    "chunked_linear_attention_ref",
    "rff_attention_decode_block_ref",
    "flash_attention_ref",
    "NEG_INF",
]

_BF16 = ("bf16", "bfloat16")
_F32 = (None, "f32", "float32")


def canon_precision(precision):
    """Validate + canonicalize the knob: ``"bf16"`` or ``None`` (f32)."""
    if precision in _BF16:
        return "bf16"
    if precision in _F32:
        return None
    raise ValueError(f"unknown precision {precision!r}; use None/'f32'/'bf16'")


def mc_scale(num_features: int) -> float:
    """The Monte-Carlo scale ``sqrt(2/D)`` as ``repro`` computes it: ``2/D``
    rounded to f32, then the correctly rounded f32 square root.

    For about 13% of D this is 1 ulp away from rounding the f64 root, so
    the order matters. The root is taken in f64 and rounded once to f32
    (exact for a square root): PyTorch's CPU ``sqrt`` on f32 is not
    correctly rounded for some D (33, 132, 218, ...).
    """
    x = torch.tensor(2.0 / num_features, dtype=torch.float32).item()
    return torch.tensor(math.sqrt(x), dtype=torch.float32).item()


def default_scale(num_features: int, dtype=torch.float32, device=None):
    """:func:`mc_scale` as a ``(D,)`` tensor."""
    return torch.full((num_features,), mc_scale(num_features), dtype=dtype,
                      device=device)


def mp_project(x, w, precision=None):
    """``x @ w`` under the precision contract (f32 accumulation).

    bf16 operands are widened back to f32 before the product: a product of
    two bf16 values is exact in f32, so this is "bf16 in, f32 accumulate".
    """
    if canon_precision(precision) == "bf16":
        return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    return x @ w


def mp_trig(proj, b, s, precision=None):
    """bias-add + cos + per-feature scale; bf16 storage when asked."""
    z = s * torch.cos(proj + b)
    if canon_precision(precision) == "bf16":
        return z.to(torch.bfloat16)
    return z


def rff_features_ref(x, w, b, s=None, precision=None):
    """``s * cos(x @ w + b)``; ``s=None`` is the Monte-Carlo ``sqrt(2/D)``."""
    if s is None:
        s = default_scale(w.shape[1], x.dtype, x.device)
    else:
        s = s.to(x.dtype)
    return mp_trig(mp_project(x, w, precision), b, s, precision)


def klms_tick_math(theta, z, y, mu_b, gate=None):
    """ONE KLMS bank tick given the feature block ``z (B, D)``.

    ``gate`` masks the state update (masked ticks still emit their prior
    prediction and error). With gate == 1 the update multiplies by exactly
    1.0, so a chunk equals T per-tick steps bit for bit.
    """
    pred = torch.sum(theta * z, dim=-1)
    err = y - pred
    upd = err if gate is None else gate * err
    return theta + (mu_b * upd)[:, None] * z, pred, err


def krls_tick_math(theta, pmat, z, y, beta_b):
    """ONE EW-RLS bank tick (with the symmetrization pass) given the
    feature block ``z (B, D)``: theta (B, D), pmat (B, D, D), y (B,),
    beta_b (B,). Returns (theta', P', predictions, prior errors).

    The arithmetic order is the reference's and the CUDA kernel's: the
    gain and the downdate divide (no reciprocal multiply), and
    ``P' = 0.5 (P'' + P''^T)`` with ``P'' = (P - gain pz^T) / beta``.
    """
    pred = torch.sum(theta * z, dim=-1)
    err = y - pred
    pz = torch.einsum("bij,bj->bi", pmat, z)
    denom = beta_b + torch.sum(z * pz, dim=-1)
    gain = pz / denom[:, None]
    theta_new = theta + gain * err[:, None]
    pmat_new = (pmat - gain[:, :, None] * pz[:, None, :]) / beta_b[:, None, None]
    pmat_new = 0.5 * (pmat_new + pmat_new.transpose(-1, -2))
    return theta_new, pmat_new, pred, err


def blocking(device, site: str):
    """``obs.trace.host_wait(site)`` around an op that takes a value from
    the host to ``device`` (a blocking copy there), a null context on the
    host."""
    if device.type == "cpu":
        return _NO_WAIT
    return _trace.host_wait(site)


def to_device(value, dtype, device, site: str):
    """``torch.as_tensor(value, dtype=dtype, device=device)``. A Python
    number or a host tensor bound for a device is a blocking copy: it runs
    inside :func:`blocking`."""
    if isinstance(value, torch.Tensor) and value.device == device:
        return torch.as_tensor(value, dtype=dtype, device=device)
    with blocking(device, site):
        return torch.as_tensor(value, dtype=dtype, device=device)


def _column(value, like, n, site):
    if (isinstance(value, torch.Tensor) and value.shape == (n,)
            and value.dtype == like.dtype and value.device == like.device):
        return value
    return to_device(value, like.dtype, like.device, site).expand(n)


def mu_column(mu, like, n):
    """Step size ``mu`` (scalar or ``(B,)``) broadcast to ``(n,)`` in the
    dtype and on the device of ``like``. A ``(n,)`` tensor of that dtype
    and device is returned as it is."""
    return _column(mu, like, n, "mu_column")


def beta_column(beta, like, n):
    """Forgetting factor ``beta`` (scalar or ``(B,)``) as a ``(n,)``
    column, like :func:`mu_column`."""
    return _column(beta, like, n, "beta_column")


def rff_klms_bank_step_ref(theta, x, y, w, b, mu, s=None):
    """Two-pass KLMS step: theta (B, D), x (B, d), y (B,), mu scalar or
    (B,). Materializes the feature block z."""
    z = rff_features_ref(x, w, b, s)
    return klms_tick_math(theta, z, y, mu_column(mu, theta, y.shape[0]))


def rff_klms_bank_chunk_ref(theta, xs, ys, w, b, mu, mask=None, s=None):
    """T masked KLMS ticks: theta (B, D), xs (B, T, d), ys (B, T), mask
    (B, T) validity gate. Returns (theta', preds (B, T), errs (B, T))."""
    bsz, tlen = ys.shape
    if mask is None:
        mask = torch.ones_like(ys)
    mask = mask.to(theta.dtype)
    mu_b = mu_column(mu, theta, bsz)
    preds, errs = [], []
    for t in range(tlen):
        z = rff_features_ref(xs[:, t], w, b, s)
        theta, pred, err = klms_tick_math(
            theta, z, ys[:, t], mu_b, gate=mask[:, t]
        )
        preds.append(pred)
        errs.append(err)
    if not preds:
        empty = ys.new_zeros((bsz, 0))
        return theta, empty, empty
    return theta, torch.stack(preds, 1), torch.stack(errs, 1)


def rff_bank_predict_ref(theta, xq, w, b, s=None, precision=None):
    """Read-only bank predict: theta (B, D), xq (B, Q, d) -> (B, Q).

    One featurize GEMM plus one f32 reduction against each tenant's theta.
    """
    z = rff_features_ref(xq, w, b, s, precision)
    pred = torch.sum(theta[:, None, :].float() * z.float(), dim=-1)
    return pred.to(theta.dtype)



def rff_krls_bank_step_ref(theta, pmat, x, y, w, b, beta, s=None):
    """Two-pass EW-RLS step: theta (B, D), pmat (B, D, D), x (B, d), y (B,),
    beta scalar or (B,). Materializes z and pz. Returns (theta', P',
    predictions (B,), prior errors (B,))."""
    z = rff_features_ref(x, w, b, s)
    return krls_tick_math(theta, pmat, z, y, beta_column(beta, theta, y.shape[0]))


def rff_krls_bank_chunk_ref(theta, pmat, xs, ys, w, b, beta, mask=None,
                            s=None):
    """T masked EW-RLS ticks: xs (B, T, d), ys (B, T), mask (B, T) validity
    gate. A masked tick still emits its prior prediction and error but
    keeps the old theta and P (a select, so they stay bit for bit).
    Returns (theta', P', preds (B, T), errs (B, T))."""
    bsz, tlen = ys.shape
    if mask is None:
        mask = torch.ones_like(ys)
    live = mask.to(theta.dtype) > 0
    beta_b = beta_column(beta, theta, bsz)
    preds, errs = [], []
    for t in range(tlen):
        z = rff_features_ref(xs[:, t], w, b, s)
        th2, pm2, pred, err = krls_tick_math(theta, pmat, z, ys[:, t], beta_b)
        keep = live[:, t]
        theta = torch.where(keep[:, None], th2, theta)
        pmat = torch.where(keep[:, None, None], pm2, pmat)
        preds.append(pred)
        errs.append(err)
    if not preds:
        empty = ys.new_zeros((bsz, 0))
        return theta, pmat, empty, empty
    return theta, pmat, torch.stack(preds, 1), torch.stack(errs, 1)


def krls_chunk_compact_ref(theta, pmat, xs, ys, w, b, beta, mask=None,
                           s=None, *, tc=None):
    """T masked EW-RLS ticks in the compact (blocked) form of the KRLS
    compact route (``csrc/krls_compact.cu``): the same arguments and
    outputs as :func:`rff_krls_bank_chunk_ref`, whose recursion it equals
    in exact arithmetic. The ticks go in blocks of ``tc`` (None =
    ``chunking.KRLS_COMPACT_TC``), each from the state the one before left.

    In a block, with P_0 its first P, S_0 = (P_0 + P_0^T) / 2, n_k the live
    ticks before tick k and L the block's live ticks:
    ``P_k = (S_0 - sum_{live j<k} c_j pz_j pz_j^T) / beta^n_k`` with
    ``c_j = beta^n_j / delta_j``; so ``pz_k = (S_0 z_k - sum c_j pz_j
    (pz_j . z_k)) / beta^n_k``, except at the block's first live tick,
    which reads P_0's rows (``pz = P_0 z``) as the tick does, and
    ``P_out = (S_0 - sum_live c_j pz_j pz_j^T) / beta^L``, upper triangle
    mirrored (bitwise symmetric), or P_0 itself when L = 0. S_0 z_k is P_0
    z_k for a symmetric P_0. Masked ticks emit the prior prediction and
    change nothing. The plain version of the compact kernel, for the tests
    and chip_smoke.py; no serving path runs it."""
    if tc is None:
        from repro_torch.kernels.chunking import KRLS_COMPACT_TC as tc
    bsz, tlen = ys.shape
    if mask is None:
        mask = torch.ones_like(ys)
    live = mask.to(theta.dtype) > 0
    beta_b = beta_column(beta, theta, bsz)
    preds, errs = [], []
    for t0 in range(0, tlen, tc):
        z = rff_features_ref(xs[:, t0:t0 + tc], w, b, s)
        theta, pmat, pred, err = _krls_compact_block(
            theta, pmat, z, ys[:, t0:t0 + tc], live[:, t0:t0 + tc], beta_b)
        preds.append(pred)
        errs.append(err)
    if not preds:
        empty = ys.new_zeros((bsz, 0))
        return theta, pmat, empty, empty
    return theta, pmat, torch.cat(preds, 1), torch.cat(errs, 1)


def _krls_compact_block(theta, p0, z, y, live, beta_b):
    """One compact block: z (B, K, D), y and live (B, K). P_0 z_k and the
    recursion run in float64 (the kernel sums P_0 z_k 16 columns at a time
    in f32, then in float64), the rank-L update of P in P's dtype. Each pz_k is kept as its coefficients over the block's
    vectors v_j (P_0 z_j at the first live tick, S_0 z_j after it), so the
    ticks need only the (K, K) products v_j . z_q and theta_0 . z_q."""
    dt, f64 = theta.dtype, torch.float64
    kk = z.shape[1]
    zd, pd = z.to(f64), p0.to(f64)
    a = torch.einsum("bij,bkj->bki", pd, zd)  # P_0 z_k, rows of P_0
    sym = (p0 == p0.transpose(1, 2)).flatten(1).all(1)
    first = live & (live.cumsum(1) == 1)
    v = torch.where((first | sym[:, None])[..., None], a,
                    0.5 * (a + torch.einsum("bji,bkj->bki", pd, zd)))
    gram = torch.einsum("bji,bqi->bjq", v, zd)  # v_j . z_q
    h = torch.einsum("bi,bqi->bq", theta.to(f64), zd)  # theta_0 . z_q
    beta = beta_b.to(f64)
    zero = torch.zeros_like(h)
    coef = torch.zeros_like(gram)  # pz_s = sum_j coef[:, s, j] v_j
    m = torch.zeros_like(gram)  # m[:, s, q] = pz_s . z_q
    c, q = zero.clone(), zero.clone()  # beta^n_s / delta_s, e_s / delta_s
    scale = torch.ones_like(beta)  # beta^n_k
    eye = torch.eye(kk, dtype=f64, device=z.device)
    preds, errs = [], []
    for k in range(kk):
        pred = (h[:, k] + torch.sum(q * m[:, :, k], dim=1)).to(dt)
        err = y[:, k] - pred
        lk = live[:, k]
        rk = (eye[k] - torch.einsum("bs,bsj->bj", c * m[:, :, k], coef)) \
            / scale[:, None]
        mk = torch.einsum("bj,bjq->bq", rk, gram)
        delta = beta + mk[:, k]
        coef[:, k] = torch.where(lk[:, None], rk, zero)
        m[:, k] = torch.where(lk[:, None], mk, zero)
        c[:, k] = torch.where(lk, scale / delta, zero[:, 0])
        q[:, k] = torch.where(lk, err.to(f64) / delta, zero[:, 0])
        scale = torch.where(lk, scale * beta, scale)
        preds.append(pred)
        errs.append(err)
    pz = torch.einsum("bsj,bji->bsi", coef, v)
    moved = live.any(1)
    theta = torch.where(moved[:, None], (theta.to(f64) + torch.einsum(
        "bs,bsi->bi", q, pz)).to(dt), theta)
    corr = torch.einsum("bsi,bsj->bij", (c[..., None] * pz).to(dt), pz.to(dt))
    upd = (0.5 * (p0 + p0.transpose(1, 2)) - corr) \
        / scale.to(dt)[:, None, None]
    upd = torch.triu(upd) + torch.triu(upd, 1).transpose(1, 2)
    pmat = torch.where(moved[:, None, None], upd, p0)
    return theta, pmat, torch.stack(preds, 1), torch.stack(errs, 1)


def klms_chunk_elements_ref(xs, ys, w, b, mu, mask=None, s=None,
                            normalized=False, eps=1e-6):
    """Per-chunk composed KLMS affine elements: xs (nc, Tc, d), ys (nc, Tc),
    mask optional (nc, Tc), mu scalar. Each chunk's Tc ticks fold into ONE
    ``theta -> a theta + v`` map by the rank-1 recursion, tick by tick:

        row = z A;  A <- A - mu_eff outer(z, row);
        v <- v - mu_eff ((z . v) - y) z,

    with ``mu_eff = m mu`` (NKLMS: ``m mu / (eps + z . z)``), so a masked
    tick (m = 0) composes the identity. Returns ``(a (nc, D, D), v (nc,
    D))``."""
    nc, tc, _ = xs.shape
    dfeat = w.shape[-1]
    if mask is None:
        mask = torch.ones_like(ys)
    mask = mask.to(xs.dtype)
    a_out, v_out = [], []
    for c in range(nc):
        zc = rff_features_ref(xs[c], w, b, s)  # (Tc, D)
        a = torch.eye(dfeat, dtype=xs.dtype, device=xs.device)
        v = torch.zeros(dfeat, dtype=xs.dtype, device=xs.device)
        for t in range(tc):
            z, y, m = zc[t], ys[c, t], mask[c, t]
            mu_t = mu / (eps + z @ z) if normalized else mu
            mu_eff = m * mu_t
            row = z @ a
            a = a - mu_eff * torch.outer(z, row)
            v = v - mu_eff * ((z @ v) - y) * z
        a_out.append(a)
        v_out.append(v)
    return torch.stack(a_out), torch.stack(v_out)


def klms_chunk_elements_wy_ref(xs, ys, w, b, mu, mask=None, s=None,
                               normalized=False, eps=1e-6, block=64):
    """The algebra of the CUDA KLMS element kernel (csrc/rff_scan.cu), for
    the tests only: kernel 7's plain version stays the fold,
    :func:`klms_chunk_elements_ref`. Same arguments and outputs.

    The Tc rank-1 maps of a chunk compose in closed form (compact WY).
    With Z (Tc, D) the chunk's features, G = Z Z^T, L its strictly lower
    part and D_mu = diag(mu_eff) (NKLMS's mu from G's diagonal, 0 on a
    masked tick):

        T = (I + D_mu L)^-1 D_mu,  A = I - Z^T (T Z),  v = Z^T (T y).

    T and c = T y are formed as the kernel forms them: each ``block`` x
    ``block`` diagonal block T_rr by forward substitution, then a row block
    at a time X_r = T_rr (B_r - sum_{q<r} G_rq X_q) for B = [I, y]."""
    nc, tc, _ = xs.shape
    dfeat = w.shape[-1]
    dtype, device = xs.dtype, xs.device
    if mask is None:
        mask = torch.ones_like(ys)
    mask = mask.to(dtype)
    eye_t = torch.eye(tc, dtype=dtype, device=device)
    a_out, v_out = [], []
    for c in range(nc):
        z = rff_features_ref(xs[c], w, b, s)  # (Tc, D)
        g = z @ z.T
        mu_t = mu / (eps + torch.diagonal(g)) if normalized else \
            torch.full((tc,), float(mu), dtype=dtype, device=device)
        mu_eff = torch.where(mask[c] == 0, torch.zeros_like(mu_t),
                             mask[c] * mu_t)
        rhs = torch.cat([eye_t, ys[c][:, None].to(dtype)], 1)  # B = [I, y]
        x = torch.zeros_like(rhs)
        for r0 in range(0, tc, block):
            r1 = min(r0 + block, tc)
            t_rr = torch.zeros(r1 - r0, r1 - r0, dtype=dtype, device=device)
            for i in range(r1 - r0):  # row i: mu_i (e_i - sum_{l<i} G_il T_l)
                t_rr[i] = mu_eff[r0 + i] * (
                    eye_t[i, :r1 - r0] - g[r0 + i, r0:r0 + i] @ t_rr[:i])
            x[r0:r1] = t_rr @ (rhs[r0:r1] - g[r0:r1, :r0] @ x[:r0])
        t_mat, cvec = x[:, :tc], x[:, tc]
        a_out.append(torch.eye(dfeat, dtype=dtype, device=device)
                     - z.T @ (t_mat @ z))
        v_out.append(z.T @ cvec)
    return torch.stack(a_out), torch.stack(v_out)


def krls_chunk_elements_ref(xs, ys, w, b, beta, mask=None, s=None):
    """Per-chunk composed KRLS decay elements: xs (nc, Tc, d), ys (nc, Tc),
    mask optional (nc, Tc), beta scalar. Each chunk folds its ticks into
    the information-form accumulator, tick by tick:

        g <- beta_eff g;  Phi <- beta_eff Phi + m outer(z, z);
        r <- beta_eff r + (m y) z,

    with ``beta_eff = beta`` on a live tick and 1 on a masked one, which
    then composes the identity ``(1, 0, 0)``. Returns ``(g (nc,), phi (nc,
    D, D), r (nc, D))``."""
    nc, tc, _ = xs.shape
    dfeat = w.shape[-1]
    if mask is None:
        mask = torch.ones_like(ys)
    mask = mask.to(xs.dtype)
    one = torch.ones((), dtype=xs.dtype, device=xs.device)
    beta_t = torch.as_tensor(beta, dtype=xs.dtype, device=xs.device)
    g_out, phi_out, r_out = [], [], []
    for c in range(nc):
        zc = rff_features_ref(xs[c], w, b, s)  # (Tc, D)
        g = one
        phi = torch.zeros(dfeat, dfeat, dtype=xs.dtype, device=xs.device)
        r = torch.zeros(dfeat, dtype=xs.dtype, device=xs.device)
        for t in range(tc):
            z, y, m = zc[t], ys[c, t], mask[c, t]
            beta_eff = torch.where(m > 0, beta_t, one)
            g = g * beta_eff
            phi = beta_eff * phi + m * torch.outer(z, z)
            r = beta_eff * r + (m * y) * z
        g_out.append(g)
        phi_out.append(phi)
        r_out.append(r)
    return torch.stack(g_out), torch.stack(phi_out), torch.stack(r_out)


def krls_chunk_elements_gram_ref(xs, ys, w, b, beta, mask=None, s=None):
    """The algebra of the CUDA KRLS element kernel (csrc/rff_scan.cu), for
    the tests only: kernel 8's plain version stays the fold,
    :func:`krls_chunk_elements_ref`. Same arguments and outputs.

    With n_t the live ticks (m > 0) after t, the fold from ``(1, 0, 0)``
    is ``Phi = Z^T diag(w) Z``, ``r = Z^T (w y)``, ``g = beta^(live
    ticks)``, ``w_t = m_t beta^(n_t)``. w comes from the kernel's suffix
    chain, ``p = beta^(n_t)`` as repeated products from 1 in the input's
    dtype (so g is the fold's g bit for bit); ``Y = w Z``; Phi is the
    lower triangle of ``Z^T Y``, diagonal included, mirrored (``Phi ==
    Phi^T`` bit for bit)."""
    nc, tc, _ = xs.shape
    dtype, device = xs.dtype, xs.device
    if mask is None:
        mask = torch.ones_like(ys)
    mask = mask.to(dtype)
    beta_t = torch.as_tensor(beta, dtype=dtype)
    g_out, phi_out, r_out = [], [], []
    for c in range(nc):
        z = rff_features_ref(xs[c], w, b, s)  # (Tc, D)
        m = mask[c].cpu()
        wts = torch.zeros(tc, dtype=dtype)
        p = torch.ones((), dtype=dtype)
        for t in range(tc - 1, -1, -1):
            wts[t] = m[t] * p
            if m[t] > 0:
                p = p * beta_t
        wts = wts.to(device)
        lower = torch.tril(z.T @ (wts[:, None] * z))
        g_out.append(p.to(device))
        phi_out.append(lower + torch.tril(lower, -1).T)
        r_out.append(z.T @ (wts * ys[c].to(dtype)))
    return torch.stack(g_out), torch.stack(phi_out), torch.stack(r_out)


# ---------------------------------------------------------------------------
# Attention (the LM path): decode features, linear attention, softmax.
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # the mask value of repro's attention kernels


def prf_root(num_features: int, device=None) -> torch.Tensor:
    """``sqrt(D)`` as the correctly rounded f32 (the f64 root rounded once,
    as :func:`mc_scale` takes it), a 0-dim tensor."""
    return torch.tensor(math.sqrt(num_features), dtype=torch.float32,
                        device=device)


def default_decode_scale(dfeat: int, feature_kind: str = "trig",
                         device=None) -> torch.Tensor:
    """Default per-feature scale row of the decode path: trig takes the
    Monte-Carlo ``sqrt(2/D)``; prf an all-ones column mask (PRF carries its
    ``1/sqrt(D)`` inside)."""
    if feature_kind == "prf":
        return torch.ones(dfeat, dtype=torch.float32, device=device)
    return default_scale(dfeat, device=device)


def decode_features_ref(x, w, b, s, feature_kind="trig", precision=None,
                        prf_eps=1e-6):
    """The decode kernel's feature map of pre-projected tokens ``x (...,
    dh)`` against ``w (dh, D)``, under the precision contract above.

    * ``"trig"``: ``s * cos(x @ w + b)``.
    * ``"prf"``: ``s * (exp(x @ w - ||x||^2 / 2) / sqrt(D) + prf_eps)``,
      ``b`` unused; ``s`` is a 0/1 column mask. ``||x||^2`` is taken on the
      f32 ``x`` also under bf16 (only the GEMM operands are rounded).
    """
    x32 = x.float()
    proj = mp_project(x32, w.float(), precision)
    if feature_kind == "trig":
        return mp_trig(proj, b.float(), s.float(), precision)
    if feature_kind != "prf":
        raise ValueError(f"unknown feature_kind {feature_kind!r}")
    stab = proj - torch.sum(torch.square(x32), dim=-1, keepdim=True) / 2.0
    phi = s.float() * (torch.exp(stab) / prf_root(w.shape[-1], x.device)
                       + prf_eps)
    if canon_precision(precision) == "bf16":
        return phi.to(torch.bfloat16)
    return phi


def rff_attention_ref(phi_q, phi_k, v, normalize=True, eps=1e-6):
    """Quadratic-form causal kernel attention: ``o_t = sum_{s<=t} (phi_q_t .
    phi_k_s) v_s`` [/ its row sum + eps]. (BH, S, D), (BH, S, D), (BH, S,
    dv) -> (BH, S, dv). O(S^2): for tests at small S."""
    a = torch.einsum("btd,bsd->bts", phi_q, phi_k)
    a = torch.tril(a)
    out = torch.einsum("bts,bsv->btv", a, v)
    if normalize:
        out = out / (torch.sum(a, dim=-1, keepdim=True) + eps)
    return out


def rff_attention_state_ref(phi_q, phi_k, v, normalize=True, eps=1e-6):
    """The same through the fixed-size running state, one token at a time:
    returns (outputs, final S (BH, D, dv), final z (BH, D)), f32 state."""
    q, k, vv = phi_q.float(), phi_k.float(), v.float()
    bh, slen, dfeat = q.shape
    s_state = q.new_zeros(bh, dfeat, vv.shape[-1])
    z_state = q.new_zeros(bh, dfeat)
    outs = []
    for t in range(slen):
        s_state = s_state + k[:, t, :, None] * vv[:, t, None, :]
        z_state = z_state + k[:, t]
        num = torch.einsum("bd,bdv->bv", q[:, t], s_state)
        if normalize:
            num = num / (torch.sum(q[:, t] * z_state, dim=-1) + eps)[:, None]
        outs.append(num)
    return torch.stack(outs, dim=1).to(phi_q.dtype), s_state, z_state


def chunked_linear_attention_ref(phi_q, phi_k, v, *, chunk=256,
                                 normalize=True, eps=1e-6):
    """Causal linear attention in chunks of ``C = min(chunk, S)`` (``S %
    C == 0``): per chunk ``(Q K^T * tril) V + Q S_prev``, normalized by the
    row sum plus ``Q z_prev``; S and z are updated after the chunk. The
    plain form ``ops.rff_attention`` runs (O(S C D), where the quadratic
    form is O(S^2))."""
    bh, slen, dfeat = phi_q.shape
    dv = v.shape[-1]
    c = min(chunk, slen)
    if slen % c:
        raise ValueError(f"sequence length {slen} is not a multiple of the "
                         f"chunk {c}")
    q, k, vv = phi_q.float(), phi_k.float(), v.float()
    s_state = q.new_zeros(bh, dfeat, dv)
    z_state = q.new_zeros(bh, dfeat)
    mask = torch.tril(q.new_ones(c, c))
    outs = []
    for c0 in range(0, slen, c):
        qc, kc, vc = q[:, c0:c0 + c], k[:, c0:c0 + c], vv[:, c0:c0 + c]
        a = torch.einsum("btd,bsd->bts", qc, kc) * mask
        out = (torch.einsum("bts,bsv->btv", a, vc)
               + torch.einsum("btd,bdv->btv", qc, s_state))
        if normalize:
            denom = torch.sum(a, -1) + torch.einsum("btd,bd->bt", qc, z_state)
            out = out / (denom + eps)[..., None]
        s_state = s_state + torch.einsum("bsd,bsv->bdv", kc, vc)
        z_state = z_state + torch.sum(kc, dim=1)
        outs.append(out)
    return torch.cat(outs, dim=1).to(phi_q.dtype)


def rff_attention_decode_block_ref(s_state, z_state, q, k, v, w, b, s=None, *,
                                   feature_kind="prf", normalize=True,
                                   eps=1e-6, precision=None):
    """T decode ticks from the fixed-size state: the block featurizes in
    one GEMM (:func:`decode_features_ref`), then each token applies the
    update-then-emit tick

        S += phi_k v^T;  z += phi_k;  o = phi_q S [/ (phi_q . z + eps)]

    in f32 whatever the feature storage. s_state (BH, D, dv), z_state (BH,
    D), q, k (BH, T, dh), v (BH, T, dv), w (dh, D), b (D,), s (D,) or None
    (:func:`default_decode_scale`). Returns (outputs (BH, T, dv) f32, S',
    z')."""
    if s is None:
        s = default_decode_scale(w.shape[-1], feature_kind, q.device)
    phi_q = decode_features_ref(q, w, b, s, feature_kind, precision).float()
    phi_k = decode_features_ref(k, w, b, s, feature_kind, precision).float()
    v32 = v.float()
    s_st, z_st = s_state.float(), z_state.float()
    outs = []
    for t in range(q.shape[1]):
        qt, kt = phi_q[:, t], phi_k[:, t]
        s_st = s_st + kt[:, :, None] * v32[:, t, None, :]
        z_st = z_st + kt
        num = torch.einsum("bd,bdv->bv", qt, s_st)
        if normalize:
            num = num / (torch.sum(qt * z_st, dim=-1) + eps)[:, None]
        outs.append(num)
    if outs:
        out = torch.stack(outs, dim=1)
    else:
        out = v32.new_zeros(v.shape)
    return out, s_st, z_st


def flash_attention_ref(q, k, v, causal=True):
    """Exact softmax attention, scores in f32 with ``dh ** -0.5``, masked
    scores ``NEG_INF``; q, k (BH, S, dh), v (BH, S, dv) -> q's dtype."""
    dh = q.shape[-1]
    sc = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * dh ** -0.5
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bqk,bkv->bqv", p, v.float()).to(q.dtype)
