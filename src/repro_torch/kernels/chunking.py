"""Time-axis chunking utilities, and the shared-memory sizing of the KLMS,
KRLS, replay element and attention kernels.

Counterpart of ``repro/kernels/chunking.py``: the pad / block / masked
remainder bookkeeping of the chunked run-loops, in one place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = [
    "SMEM_BUDGET",
    "TILE_ROWS",
    "TILE_COLS",
    "TILE_K",
    "TILE_K_BF16",
    "KLMS_REG_COLUMNS",
    "num_chunks",
    "time_blocks",
    "valid_time_mask",
    "unblock_time",
    "feature_tile_grid",
    "feature_tile_pack_floats",
    "predict_workspace_bytes",
    "PREDICT_ROUTES",
    "PREDICT_FEW_BLOCKS",
    "PREDICT_FEW_Z_BUDGET",
    "predict_route",
    "klms_tick_plan",
    "klms_fits",
    "KRLS_THREADS",
    "krls_smem_bytes",
    "krls_fits",
    "krls_resident_smem_bytes",
    "krls_resident_fits",
    "krls_compact_pays",
    "KRLS_COMPACT_TC",
    "KRLS_COMPACT_WORKSPACE_BUDGET",
    "krls_compact_workspace_bytes",
    "krls_compact_slab",
    "default_chunk_t",
    "ATTENTION_THREADS",
    "DECODE_TILE_COLS",
    "decode_smem_bytes",
    "decode_fits",
    "default_decode_block_t",
    "LINEAR_ROWS",
    "LINEAR_TILE_COLS",
    "linear_attention_smem_bytes",
    "LinearAttentionPlan",
    "linear_attention_plan",
]

# Shared memory one thread block may use on an H100 (227 KB of the SM's
# 256 KB; NVIDIA's Hopper tuning guide). Unlike a TPU core's ~16 MiB of
# VMEM it cannot hold a (d, D) W tile: the kernels stream W through it.
SMEM_BUDGET = 232_448

# The f32 feature tile of csrc/feature_tile.cuh (phase A of the KLMS
# kernels, the f32 read kernel): 256 threads form a 128 x 128 tile of x W
# from packed, zero-padded operands (x transposed to (dp, Rp), W to (dp,
# Dp)), k-tiles of 16 streaming through a three-stage ring in 49.5 KB of
# shared memory. The bf16 read kernel packs x to (Rp, dp) and W^T to
# (Dp, dp) in bf16, with dp a multiple of 32.
TILE_ROWS = TILE_COLS = 128
TILE_K, TILE_K_BF16 = 16, 32
_MAX_GRID_Y = 65_535
_MAX_ROWS = 2 ** 31 - 1

# Phase B of the KLMS kernels (csrc/klms_bank.cu): one warp per tenant,
# theta in registers at NPL columns a lane (lane + 32 i) up to D = 32 * 64,
# in shared memory beyond.
KLMS_REG_COLUMNS = (4, 16, 64)


def feature_tile_grid(rows: int, dfeat: int) -> tuple[int, int]:
    """Blocks of the feature tile over ``rows`` rows of x and ``D`` columns
    of W: ``(row tiles, column tiles)``. Raises where the launch cannot
    take the shape (rows past 2^31 - 1, or more than 65535 column tiles:
    D above 8,388,480). Any d works: the k loop streams it."""
    if rows < 1 or dfeat < 1:
        raise ValueError(f"rows={rows}, D={dfeat}: both must be >= 1")
    if rows > _MAX_ROWS:
        raise ValueError(f"{rows} rows exceed the feature tile's 2^31 - 1")
    cols = -(-dfeat // TILE_COLS)
    if cols > _MAX_GRID_Y:
        raise ValueError(f"D={dfeat}: {cols} column tiles exceed the grid's "
                         f"{_MAX_GRID_Y}")
    return -(-rows // TILE_ROWS), cols


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def feature_tile_pack_floats(rows: int, input_dim: int, dfeat: int) -> int:
    """Floats of the f32 feature tile's packed operands for ``rows`` rows
    (``Wp (dp + 2, Dp)``, W with the bias and scale as its last two rows,
    then ``xT (dp, Rp)``; the layout in csrc/feature_tile.cuh): 2.36 M at
    the KLMS flush (16384 rows, d = 128, D = 2048), 8.65 M at the read
    block (65536 rows)."""
    dp = _round_up(input_dim, TILE_K)
    return (dp + 2) * _round_up(dfeat, TILE_COLS) + dp * _round_up(
        rows, TILE_ROWS)


def predict_workspace_bytes(rows: int, input_dim: int, dfeat: int,
                            bf16: bool = False, route: str = "bank") -> int:
    """Bytes of the read kernel's workspace (csrc/bank_predict.cu): the
    packed operands, f32 as :func:`feature_tile_pack_floats`, bf16 the bias
    and scale ``(2, Dp)`` in f32, then ``W^T (Dp, dp)`` and ``x (Rp, dp)``
    in bf16, with dp a multiple of 32; on the "few" route then z ``(R,
    Dp)`` in f32 (512 KiB at one tenant's 64 queries, D = 2048)."""
    dp_cols = _round_up(dfeat, TILE_COLS)
    if not bf16:
        packed = 4 * feature_tile_pack_floats(rows, input_dim, dfeat)
    else:
        dp = _round_up(input_dim, TILE_K_BF16)
        packed = 8 * dp_cols + 2 * dp * (_round_up(rows, TILE_ROWS) + dp_cols)
    return packed + (4 * rows * dp_cols if route == "few" else 0)


# The read kernel's routes (csrc/bank_predict.cu): "bank", a block a 128
# rows walking all of D, and "few", (row tile x column tile) blocks that
# form z in an (R, Dp) workspace and a reduce launch that runs the bank
# route's chain for each row, so no bit depends on the route. A read takes
# "few" where the bank route gives fewer than PREDICT_FEW_BLOCKS blocks
# (a wave of the H100's 132 SMs) and z fits PREDICT_FEW_Z_BUDGET (256
# MiB, the KLMS kernels' workspace budget). The threshold is the card's
# (krls_breakdown.py --predict-few, both C entries at B tenants of 64
# queries; NVIDIA H100 80GB HBM3, 700 W): at d = 128, D = 2048 the few-row
# route was faster up to B = 256, 128 bank blocks (f32 0.344 ms against
# 0.385, bf16 0.198 against 0.219), split at B = 384 (f32 0.49 against
# 0.59, bf16 0.27 against 0.26) and slower at B = 512 (f32 0.637 against
# 0.587); at d = 5, D = 300 faster up to B = 128, within 0.005 ms at 256,
# slower from 384.
PREDICT_ROUTES = ("bank", "few")
PREDICT_FEW_BLOCKS = 132
PREDICT_FEW_Z_BUDGET = 256 << 20


def predict_route(rows: int, dfeat: int) -> str:
    """The read kernel's route for ``rows`` (B Q) rows of width D =
    ``dfeat``: "few" where the bank route's blocks of 128 rows number
    fewer than :data:`PREDICT_FEW_BLOCKS` and the ``(R, Dp)`` f32 z fits
    :data:`PREDICT_FEW_Z_BUDGET` (and its column tiles the grid's 65535),
    else "bank"."""
    cols = -(-dfeat // TILE_COLS)
    if (-(-rows // TILE_ROWS) < PREDICT_FEW_BLOCKS and cols <= _MAX_GRID_Y
            and 4 * rows * cols * TILE_COLS <= PREDICT_FEW_Z_BUDGET):
        return "few"
    return "bank"


def klms_tick_plan(dfeat: int) -> tuple[int, int]:
    """How phase B of the KLMS kernels holds a tenant's theta: ``(columns
    a lane keeps in registers, dynamic shared memory bytes)``. The
    smallest of :data:`KLMS_REG_COLUMNS` that covers D on 32 lanes, with no
    shared memory; past D = 2048, ``(0, 4 D)``: theta in shared memory, one
    warp a block. Raises when theta does not fit :data:`SMEM_BUDGET` (D
    above 58,112; the first design's limit was about 29k at d = 128)."""
    if dfeat < 1:
        raise ValueError(f"D={dfeat} must be >= 1")
    for npl in KLMS_REG_COLUMNS:
        if 32 * npl >= dfeat:
            return npl, 0
    smem = 4 * dfeat
    if smem > SMEM_BUDGET:
        raise ValueError(
            f"D={dfeat}: one tenant's theta ({smem} bytes) exceeds the "
            f"shared memory of a block ({SMEM_BUDGET})"
        )
    return 0, smem


def klms_fits(dfeat: int) -> bool:
    """Whether the KLMS kernels take width D (:func:`klms_tick_plan`)."""
    try:
        klms_tick_plan(dfeat)
    except ValueError:
        return False
    return True


# Threads per block of csrc/krls_bank.cu (kThreads there): one block per
# tenant, and each warp owns one pair of 32 x 33 transpose tiles.
KRLS_THREADS = 256
_KRLS_TILE_FLOATS = 2 * 32 * 33


def krls_smem_bytes(dfeat: int, input_dim: int) -> int:
    """Dynamic shared memory of one KRLS block (the layout in
    csrc/krls_bank.cu): the tenant's theta, z, pz and gain rows ``(D,)``,
    its x row ``(d,)``, the per-warp reduction slots, three scalars and
    each warp's pair of transpose tiles, all f32. The ``(D, D)`` P stays in
    device memory: one tenant's P (360 KB at D = 300) exceeds a block's
    shared memory."""
    warps = KRLS_THREADS // 32
    floats = 4 * dfeat + input_dim + warps + 3 + warps * _KRLS_TILE_FLOATS
    return 4 * floats


def krls_fits(dfeat: int, input_dim: int) -> bool:
    """Whether the KRLS kernels' shared tiles fit :data:`SMEM_BUDGET` (D up
    to about 10k features at d = 5)."""
    return krls_smem_bytes(dfeat, input_dim) <= SMEM_BUDGET


def krls_resident_smem_bytes(dfeat: int, input_dim: int) -> int:
    """Dynamic shared memory of one resident KRLS chunk block (the layout in
    csrc/krls_bank.cu, ``Resident``), all f32: P's upper triangle packed
    two rows to a rectangle row of even pitch (``D (D + 2) / 2`` floats at
    even D, ``D (D + 1) / 2`` at odd), the tenant's (gain, pz) pairs, theta
    and z rows, two x rows ``(d,)``, two sets of the 256-lane partition's
    eight warp sums and two (y, mask) pairs (186,120 bytes at D = 300, d =
    5)."""
    tri = dfeat * (dfeat + (2 if dfeat % 2 == 0 else 1)) // 2
    floats = tri + 4 * dfeat + 2 * input_dim + 2 * (KRLS_THREADS // 32) + 4
    return 4 * floats


def krls_resident_fits(dfeat: int, input_dim: int) -> bool:
    """Whether the resident KRLS chunk kernel's triangle and rows fit
    :data:`SMEM_BUDGET` (D up to 335 at d = 5). Wider D take the compact
    route (``krls_bank_chunk_compact``, blocks of :data:`KRLS_COMPACT_TC`
    ticks); where it fits, :func:`krls_compact_pays` picks between the
    two."""
    return krls_resident_smem_bytes(dfeat, input_dim) <= SMEM_BUDGET


# Kernel 4's two routes where P's triangle fits a block, as costs in µs
# fitted to the route crossover table (krls_compact_pays). The resident
# route runs a block a tenant, one an SM, for every tick: a tick costs
# KRLS_RESIDENT_TICK_US (the tick's barriers and features) plus
# KRLS_RESIDENT_TICK_US_D2 D^2 (the triangle's downdate) for each wave of
# KRLS_RESIDENT_WAVE tenants (the H100's SMs). The compact route pays per
# block of KRLS_COMPACT_TC ticks, whatever their number:
# KRLS_COMPACT_BLOCK_US (its launches and host work) plus
# KRLS_COMPACT_BLOCK_US_BD2 B Dp^2 (P's reads and writes beyond the
# resident route's one pass, Dp = D rounded up to its 64-wide tiles).
KRLS_RESIDENT_WAVE = 132
KRLS_RESIDENT_TICK_US = 3.0
KRLS_RESIDENT_TICK_US_D2 = 1.4e-4
KRLS_COMPACT_BLOCK_US = 60.0
KRLS_COMPACT_BLOCK_US_BD2 = 2e-6


def krls_compact_pays(bank: int, tlen: int, dfeat: int) -> bool:
    """Whether a KRLS chunk of B = ``bank`` tenants and T = ``tlen`` ticks
    at a width D = ``dfeat`` that both chunk routes take (D <= 335 at d =
    5, :func:`krls_resident_fits`) goes to the compact route: T >= 2 and
    ceil(T / Tc) compact blocks cost less than T resident ticks, by the
    costs above. A step (T = 1) stays resident.

    The table behind it (``krls_breakdown.py --route-crossover``: both
    routes forced through the wrapper in turns, every tick live; NVIDIA
    H100 80GB HBM3, 700 W): per width and B, the route that measured
    faster at T = 1, 2, 4, 8, 16, 64, 512, then the route this rule picks
    (R resident, C compact).

    ====== ======= ======= ======= ======= ======= =======
    d, D   B = 1   8       64      132     256     1024
    ====== ======= ======= ======= ======= ======= =======
    5, 31  RRRRRRR RRRRRRR RRRRRRR RRRRRRR RRRRCCC RRRCCCC
    rule   RRRRRRR RRRRRRR RRRRRRR RRRRRRR RRRRCCC RRCCCCC
    5, 100 RRRRCCC RRRRCCC RRRRRCC RRRRCCC RRRCCCC RRCCCCC
    rule   RRRRCCC RRRRCCC RRRRCCC RRRRCCC RRRCCCC RRCCCCC
    5, 200 RRRCCCC RRRCCCC RRRCCCC RRRRCCC RRRCCCC RRCCCCC
    rule   RRRCCCC RRRCCCC RRRCCCC RRRRCCC RRRCCCC RRCCCCC
    5, 300 RRCCCCC RCCCCCC RRRCCCC RRRCCCC RRRCCCC RRCCCCC
    rule   RRCCCCC RRCCCCC RRRCCCC RRRCCCC RRCCCCC RRCCCCC
    5, 335 RRCCCCC RRCCCCC RRRCCCC RRRCCCC RRRCCCC RRCCCCC
    rule   RRCCCCC RRCCCCC RRRCCCC RRRCCCC RRCCCCC RRCCCCC
    128,   RRCCCCC RRRCCCC RRRCCCC RRRCCCC RRCCCCC RCCCCCC
    256    RRRCCCC RRRCCCC RRRCCCC RRRCCCC RRCCCCC RCCCCCC
    ====== ======= ======= ======= ======= ======= =======

    The rule picks the slower route at 6 of these 252 shapes, and at 7 of
    252 in a second run on another card: each a call under 0.43 ms, near
    the crossover, within 36% (the compact route where the resident was
    up to 1.15x faster, except (1024, 4, 5, 31) at 1.35x in the first run
    alone, whose resident readings spread 39%). Constants that avoid those
    picks miss compact-faster shapes by up to 1.40x. At the serving flush
    (1024, 16, 5, 300) the resident route took 2.44-2.55 ms and the compact
    0.79-0.84. A T threshold with B and D classes (compact from T = 16, 8
    or 4 by three classes of each) missed 7 shapes of the first run by more
    than 10%, one of them picking the compact route where the resident was
    faster.
    """
    if tlen < 2:
        return False
    waves = -(-bank // KRLS_RESIDENT_WAVE)
    resident = tlen * waves * (KRLS_RESIDENT_TICK_US
                               + KRLS_RESIDENT_TICK_US_D2 * dfeat * dfeat)
    dpad = _round_up(dfeat, 64)
    blocks = -(-tlen // KRLS_COMPACT_TC)
    compact = blocks * (KRLS_COMPACT_BLOCK_US
                        + KRLS_COMPACT_BLOCK_US_BD2 * bank * dpad * dpad)
    return compact < resident


# The KRLS compact route (csrc/krls_compact.cu, kTc there): ticks of one
# block, and the largest workspace one call allocates (256 MiB, as the KLMS
# kernels' KLMS_WORKSPACE_BUDGET). The rule for Tc: the largest power of
# two at which the route meets every KRLS bound (F32_TOL and P_TOL against
# the tick plain version, the float64 budget at lam = 1e-4, repro's 1e-5);
# Tc = 1 is the tick recursion, so one always does. With the recursion in
# float64 none failed up to 128 (krls_breakdown.py --compact's Tc study:
# within 0.11-0.45 of the tick form's own f32 distance from float64), so
# the cost sets it: a serving flush is 16 ticks, the (Tc, Tc) recursion and
# the rank-Tc update grow with Tc, and at 16 P's bytes still bound a block.
KRLS_COMPACT_TC = 16
KRLS_COMPACT_WORKSPACE_BUDGET = 256 << 20


def krls_compact_workspace_bytes(tenants: int, ticks: int, input_dim: int,
                                 dfeat: int) -> int:
    """Bytes of the compact route's workspace for a slab of ``tenants`` and
    a block of ``ticks`` (the layout ``Work`` in csrc/krls_compact.cu, each
    part from a 256-byte boundary): per tenant and tick, the features z
    (f32), P_0 z and P_0^T z (f64), c pz and pz for the rank-L update (f32);
    per tenant L, beta^L and a flag; the feature tile's packed operands.
    28 B Tc D a tenant: 458,752 bytes at Tc = 16, D = 1024."""
    def aligned(nbytes):
        return _round_up(nbytes, 256)

    n = tenants * ticks * dfeat
    return (aligned(4 * n) + 3 * aligned(8 * n) + 3 * aligned(4 * tenants)
            + aligned(4 * feature_tile_pack_floats(tenants * ticks, input_dim,
                                                   dfeat)))


def krls_compact_slab(bank: int, tlen: int, input_dim: int,
                      dfeat: int) -> int:
    """Tenants one slab of a compact call takes: all B while the workspace
    of a block of min(Tc, T) ticks fits
    :data:`KRLS_COMPACT_WORKSPACE_BUDGET`, else the most that do (at least
    one; 583 of the serving bank's 1024 at D = 1024). The bits do not
    depend on it."""
    ticks = min(KRLS_COMPACT_TC, tlen)
    budget = KRLS_COMPACT_WORKSPACE_BUDGET
    if krls_compact_workspace_bytes(bank, ticks, input_dim, dfeat) <= budget:
        return bank
    lo, hi = 1, bank
    while lo < hi:  # the largest slab whose workspace fits
        mid = (lo + hi + 1) // 2
        if krls_compact_workspace_bytes(mid, ticks, input_dim, dfeat) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def default_chunk_t(bank: int, dfeat: int, input_dim: int = 128,
                    pmat: bool = False, elements: bool = False) -> int:
    """Default tick count T for one chunked launch.

    The CUDA chunk kernels keep a tenant's state on chip for the whole
    launch (the KLMS kernel's theta in a warp's registers or shared memory,
    with the call's features in a ``(B, T, D)`` workspace in device memory;
    theta, z, pz and gain for the KRLS kernel's one tenant, ``pmat=True``),
    so T costs no shared memory: when the state fits :data:`SMEM_BUDGET`
    the default is the cap of 512 ticks that ``repro`` also clamps to. When
    it does not fit, the kernel cannot run at all (its wrapper raises) and
    the floor of 8 is returned for the plain path. ``bank`` is accepted for
    signature parity with ``repro`` and does not change the answer: a
    block's state does not grow with B.

    ``elements=True`` sizes Tc, the ticks per chunk of the replay element
    kernels (``csrc/rff_scan.cu``). There no tile grows with Tc either:
    z is featurized into device memory first, the KLMS element is a Gram,
    a triangular solve and products over a workspace in device memory,
    and a KRLS block owns a tile of one chunk's ``(D, D)`` element, so Tc
    trades per-chunk work against the work after the kernel. One tick
    costs the KLMS element 2 D^2 operations in its last product (4 D^2 in
    the TPU kernel's fold), while composing two chunk elements is a ``(D,
    D)`` product of 2 D^3; Tc >= D/2 keeps the nc - 1 cross-chunk products
    within twice the elements' work. The same Tc keeps the ``(nc, D, D)``
    stack of written elements (KLMS and KRLS) at most 2 T D floats, twice
    the featurized log. So Tc is the smallest power of two >= D/2, clamped to [8, 512]
    (Tc = 1024 at D = 2048 clamps to 512; Tc = 256 at D = 300).
    """
    del bank
    if elements:
        half = max(1, -(-dfeat // 2))
        return int(min(512, max(8, 1 << (half - 1).bit_length())))
    fits = krls_fits(dfeat, input_dim) if pmat else klms_fits(dfeat)
    return 512 if fits else 8


# Threads per block of csrc/rff_attention.cu and csrc/flash_attention.cu
# (kThreads there).
ATTENTION_THREADS = 256
# The decode block's dv columns a block (kDecCols in csrc/rff_attention.cu).
DECODE_TILE_COLS = 32
# The linear-attention kernels' chunk rows, dv tile and feature slab
# (kRows, kCols and kSlab there).
LINEAR_ROWS, LINEAR_TILE_COLS, LINEAR_SLAB = 64, 64, 32
# Shared memory of the linear-attention blocks: a state block's two chunks
# of K (64, 64) and V (64, 64), 65,536 bytes; an output block's two stages
# of (64, 36) Q and K slabs, a (32, 64) S_prev slab and 32 of z_prev (the
# last slab's stages then hold the scores and the V tile) and two (64,)
# rows (Q z_prev, normalizer), 54,016 bytes.
_LINEAR_STATE_SMEM = 4 * 2 * LINEAR_ROWS * (64 + LINEAR_TILE_COLS)
_LINEAR_OUT_STAGE = 2 * LINEAR_ROWS * 36 + LINEAR_SLAB * LINEAR_TILE_COLS \
    + LINEAR_SLAB
_LINEAR_SMEM = max(_LINEAR_STATE_SMEM,
                   4 * (2 * _LINEAR_OUT_STAGE + 2 * LINEAR_ROWS))


def _decode_base_floats(dfeat: int, head_dim: int) -> int:
    threads = ATTENTION_THREADS
    return (dfeat * DECODE_TILE_COLS + 2 * DECODE_TILE_COLS
            + threads // 32 * DECODE_TILE_COLS + 3 * dfeat + 4 * head_dim
            + threads // 32 + 4)


def decode_smem_bytes(dfeat: int, dv: int, head_dim: int) -> int:
    """Dynamic shared memory of one decode block of a launch of more than
    one token (the layout in csrc/rff_attention.cu): the block's ``(D,
    32)`` tile of S, two v rows, the ``(8, 32)`` partial numerators, z and
    the tick's two feature rows ``(D,)``, two (q, k) token pairs ``(dh,)``,
    the per-warp normalizer sums and two ``|x|^2`` pairs, all f32; and W
    ``(dh, D)`` when it fits beside them (else it is read from L2, as at
    every one-token launch). ``dv`` does not change it: a block owns 32
    columns (103,728 bytes at D = 256, dh = 64)."""
    del dv
    base = _decode_base_floats(dfeat, head_dim)
    with_w = 4 * (base + head_dim * dfeat)
    return with_w if with_w <= SMEM_BUDGET else 4 * base


def decode_fits(dfeat: int, dv: int, head_dim: int) -> bool:
    """Whether a head's decode state, S ``(D, dv)`` and z ``(D,)`` in f32,
    fits :data:`SMEM_BUDGET`, as ``repro`` asks the head's state to fit
    its VMEM (D = 256 at dv <= 128 fits, as at qwen2-0.5b and llama3-8b).
    The kernel's blocks hold a 32-column tile of it; the rule stays the
    head's, as pinned by ``default_decode_block_t``."""
    del head_dim
    return 4 * (dfeat * dv + dfeat) <= SMEM_BUDGET


def default_decode_block_t(dfeat: int, dv: int, head_dim: int) -> int:
    """Default tokens T per fused decode-block launch.

    ``repro`` budgets T against VMEM, charging the resident S and W tiles
    and two feature rows per streamed token. The CUDA kernel keeps its S
    tile, z and (where it fits) W in shared memory for the whole launch
    and featurizes one token per tick into the same two rows, so T costs
    no shared memory: when the head's state fits :data:`SMEM_BUDGET`
    (:func:`decode_fits`) the default is the cap of 512 tokens that
    ``repro`` also clamps to (and reaches at D = 256, dv = dh = 64). When
    it does not fit, the wrapper refuses the kernel and the floor of 8 is
    returned for the plain path. ``repro``'s stream ``dtype`` argument is
    not taken: it does not change the answer here.
    """
    return 512 if decode_fits(dfeat, dv, head_dim) else 8


def linear_attention_smem_bytes(dfeat: int) -> int:
    """Dynamic shared memory of the largest chunked linear-attention block
    (layout in csrc/rff_attention.cu): a state block's two chunks of K and
    V, ``(64, 64)`` each, in f32, 65,536 bytes (an output block takes
    54,016). D does not change it: the state walks 64 features a block,
    and the outputs stream Q, K and S_prev through in slabs."""
    del dfeat
    return _LINEAR_SMEM


@dataclass(frozen=True)
class LinearAttentionPlan:
    """The two launches of one linear-attention call: chunks of 64 rows
    (``nc``), dv tiles of 64 (``tiles``), D rounded up to 32 (``dp``),
    each launch's block count and the f32 workspace's bytes."""

    nc: int
    tiles: int
    dp: int
    state_blocks: int
    output_blocks: int
    workspace_bytes: int


def linear_attention_plan(bh: int, slen: int, dfeat: int,
                          dv: int) -> LinearAttentionPlan:
    """The plan ``csrc/rff_attention.cu`` launches for phi_q, phi_k ``(BH,
    S, D)`` and v ``(BH, S, dv)``: (1) the state, one block per (head, 64
    features, dv tile) walking the chunks in order and writing each
    chunk's S_prev and z_prev; (2) the outputs, one block per (head, chunk,
    dv tile). The workspace holds every chunk's record, ``tiles dp 64 +
    dp`` floats: ``4 BH nc (tiles dp 64 + dp)`` bytes (119.3 MB at the LM
    prefill, 56 heads, S = 2048, D = 256, dv = 64, with 224 state blocks
    and 1792 output blocks)."""
    nc = -(-slen // LINEAR_ROWS)
    tiles = -(-dv // LINEAR_TILE_COLS)
    dp = _round_up(dfeat, LINEAR_SLAB)
    record = tiles * dp * LINEAR_TILE_COLS + dp
    return LinearAttentionPlan(
        nc=nc, tiles=tiles, dp=dp, state_blocks=bh * -(-dp // 64) * tiles,
        output_blocks=bh * nc * tiles, workspace_bytes=4 * bh * nc * record)


def num_chunks(n: int, chunk: int) -> int:
    """ceil(n / chunk) — the loop length after chunking."""
    return -(-n // chunk)


def time_blocks(a: torch.Tensor, chunk: int, axis: int = 0) -> torch.Tensor:
    """Zero-pad ``axis`` to a multiple of ``chunk`` and split it into a
    leading axis: ``(..., n, ...) -> (nc, ..., chunk, ...)``."""
    n = a.shape[axis]
    nc = num_chunks(n, chunk)
    pad = [0, 0] * a.ndim
    # F.pad lists (left, right) pairs from the last axis backwards.
    pad[2 * (a.ndim - 1 - axis) + 1] = nc * chunk - n
    ap = F.pad(a, pad)
    ap = ap.reshape(a.shape[:axis] + (nc, chunk) + a.shape[axis + 1:])
    return torch.movedim(ap, axis, 0)


def valid_time_mask(n: int, chunk: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """``(nc, chunk)`` gate: 1 for real ticks, 0 for the padded tail."""
    nc = num_chunks(n, chunk)
    m = torch.zeros(nc * chunk, dtype=dtype, device=device)
    m[:n] = 1
    return m.reshape(nc, chunk)


def unblock_time(a: torch.Tensor, n: int, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`time_blocks` on stacked outputs:
    ``(nc, ..., chunk, ...) -> (..., n, ...)`` with the padding sliced off."""
    a = torch.movedim(a, 0, axis)
    a = a.reshape(a.shape[:axis] + (-1,) + a.shape[axis + 2:])
    return a.narrow(axis, 0, n)
