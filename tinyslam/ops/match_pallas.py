"""Fused Hamming matcher: the whole all-pairs reduction in one Pallas kernel.

The XLA matcher (ops/hamming.py) materializes the (N, M) int32 distance
matrix in device memory and reads it back for every reduction (mask,
argmin, second best, column argmin): at N = 2048 features x M = 8192 map
points that is a 64 MiB matrix written once and read about six times per
call, and guided matching runs once or twice per tracked frame.

This kernel (Pallas through Triton) never writes the matrix:

  - each program owns ``block_n`` rows of A and one ``chunk_m``-column
    chunk of B, and loops over the chunk ``block_m`` columns at a time;
    the chunk is sized for about two programs per SM (programs run in
    parallel, in no order, so nothing carries over between them);
  - each (block_n, block_m) tile comes from one tensor-core product of the
    +-1 signs (dot = 256 - 2 * hamming; bf16 operands with f32 accumulation
    are exact for +-1 sums of 256 terms);
  - invalid slots and failed guided gates add an integer penalty (PEN > 256)
    instead of masking, so the tile needs no extra passes;
  - the guided gate is integer arithmetic on a 1/16-px grid (gate_coords),
    exact in any order, so it cannot round differently from the XLA path
    (a float sum of squares may be contracted into an FMA by one compiler
    and not by the other);
  - min and argmin come out of one reduction over packed codes
    ``dist << shift | index``: the minimum code is the minimum distance with
    ties broken toward the lowest index, as ``jnp.argmin`` does;
  - the row side keeps a running (best code, second best) per row; the
    chunks of one row block are merged after the kernel (a few KB);
  - the column side (cross-check argmin over rows) is an ``atomic_min`` of
    packed codes into an output that aliases a pre-filled input.  The min of
    packed codes does not depend on the order of the atomics, so the result
    is deterministic and equal to the XLA path's.

Semantics match the XLA path on every valid row: idx_b, dist and valid are
equal bit for bit (tests/test_match_pallas.py; on the card, chip_smoke.py).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Additive integer penalty for an invalid slot or a failed gate: anything
# > 256 (the largest true Hamming distance) keeps the pair out of any
# max_distance < PEN while keeping packed codes small.
PEN = 300
# Distances after penalties (row, column and gate) stay below this.
_MAXD = 256 + 3 * PEN + 1
_INT32_MAX = 2**31 - 1
# Guided gate grid: pixel coordinates become int32 multiples of 1/16 px.
# Offsets are clamped to +-GATE_CLIP (1024 px, beyond any gate radius), so
# a squared distance stays below 2**29.
GATE_SCALE = 16
GATE_CLIP = 1 << 14
# Programs to aim for: about two per SM of an H100 (132 SMs).  Measured on
# the card (bf16 dot, 4 warps): block_n=128 x block_m=64 tiles with ~256
# programs beat 64- and 32-row blocks and larger chunks at both 2048x8192
# and 2048x2048 (CHANGES.md).
_TARGET_PROGRAMS = 256


def _bits_for(n: int) -> int:
    """Bits needed to hold an index in [0, n)."""
    return max(1, (n - 1).bit_length())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_at_least(x: int) -> int:
    return 1 << max(4, (x - 1).bit_length())       # >= 16: pl.dot's minimum


def gate_coords(xy: jax.Array) -> jax.Array:
    """Float pixel coordinates -> int32 on the gate grid (far-away
    sentinels, e.g. behind-camera projections, are clipped first)."""
    xy = jnp.clip(xy.astype(jnp.float32), -2.0**20, 2.0**20)
    return jnp.round(xy * GATE_SCALE).astype(jnp.int32)


def gate_radius2(radius_px: float) -> int:
    """Squared gate radius on the gate grid: an offset (du, dv) of
    gate_coords passes when du * du + dv * dv < gate_radius2(radius_px)."""
    r = float(radius_px) * GATE_SCALE
    if not 0.0 <= r < GATE_CLIP:
        raise ValueError(f"gate radius {radius_px} px is out of range")
    return math.ceil(r * r)


def blocking(n: int, m: int, block_n: int = 128, block_m: int = 64,
             chunk_m: int | None = None) -> tuple[int, int, int]:
    """(block_n, block_m, chunk_m) for an n x m match.  Triton blocks are
    powers of two; by default the chunk (columns per program) is the power
    of two that brings the grid closest to _TARGET_PROGRAMS from above."""
    block_n = min(block_n, _pow2_at_least(n))
    block_m = min(block_m, _pow2_at_least(m))
    if chunk_m is None:
        chunk_m = max(block_m, (m * -(-n // block_n)) // _TARGET_PROGRAMS)
        chunk_m = 1 << (chunk_m.bit_length() - 1)
    return block_n, block_m, max(block_m, min(chunk_m, _pow2_at_least(m)))


def _clamp(x):
    return jnp.minimum(jnp.maximum(x, -GATE_CLIP), GATE_CLIP)


def _kernel(sa_ref, pa_ref, uva_ref, sbT_ref, pb_ref, uvb_ref, _colinit_ref,
            code_ref, sec_ref, col_ref, *, radius2, guided, block_m,
            mshift, nshift):
    i = pl.program_id(0)
    j = pl.program_id(1)
    block_n = sa_ref.shape[0]
    chunk_m = sbT_ref.shape[1]

    a = sa_ref[...].astype(jnp.bfloat16)                 # (block_n, 256)
    pen_a = pa_ref[...]                                  # (block_n,)
    if guided:
        ua = uva_ref[0, :]
        va = uva_ref[1, :]
    rowg = i * block_n + jnp.arange(block_n, dtype=jnp.int32)

    def body(k, carry):
        rcode, rsec = carry
        cols = pl.ds(k * block_m, block_m)
        b = sbT_ref[:, cols].astype(jnp.bfloat16)        # (256, block_m)
        dot = pl.dot(a, b, precision=jax.lax.Precision.DEFAULT)
        d = ((256.0 - dot) * 0.5).astype(jnp.int32)
        d = d + pen_a[:, None] + pb_ref[cols][None, :]
        if guided:
            du = _clamp(ua[:, None] - uvb_ref[0, cols][None, :])
            dv = _clamp(va[:, None] - uvb_ref[1, cols][None, :])
            d = d + jnp.where(du * du + dv * dv < radius2, 0, PEN)
        colg = (j * chunk_m + k * block_m
                + jnp.arange(block_m, dtype=jnp.int32))

        # Row side: best and argmin in one packed min, then the second best
        # with exactly the argmin column excluded.
        cmin = jnp.min((d << mshift) | colg[None, :], axis=1)
        jmin = cmin & ((1 << mshift) - 1)
        m1 = cmin >> mshift
        m2 = jnp.min(jnp.where(colg[None, :] == jmin[:, None], _MAXD, d),
                     axis=1)
        rsec = jnp.minimum(jnp.minimum(rsec, m2),
                           jnp.maximum(rcode >> mshift, m1))
        rcode = jnp.minimum(rcode, cmin)

        # Column side: packed argmin over this block's rows, merged across
        # row blocks by atomics.
        ccode = jnp.min((d << nshift) | rowg[:, None], axis=0)
        plgpu.atomic_min(col_ref, cols, ccode)
        return rcode, rsec

    init = (jnp.full((block_n,), _MAXD << mshift, jnp.int32),
            jnp.full((block_n,), _MAXD, jnp.int32))
    rcode, rsec = jax.lax.fori_loop(0, chunk_m // block_m, body, init)
    code_ref[...] = rcode
    sec_ref[...] = rsec


@functools.partial(jax.jit, static_argnames=(
    "radius_px", "guided", "block_n", "block_m", "chunk_m", "num_warps",
    "interpret"))
def match_reduce_fused(
    sa: jax.Array,        # (N, 256) int8 signs
    pen_a: jax.Array,     # (N,) int32 penalty: 0 or PEN
    uv_a: jax.Array,      # (2, N) int32 feature pixels (gate_coords)
    sb: jax.Array,        # (M, 256) int8 signs
    pen_b: jax.Array,     # (M,) int32
    uv_b: jax.Array,      # (2, M) int32 predicted projections
    radius_px: float = 0.0,
    guided: bool = False,
    block_n: int = 128,
    block_m: int = 64,
    chunk_m: int | None = None,
    num_warps: int = 4,
    interpret: bool = False,
):
    """All-pairs penalized Hamming reduction without the (N, M) matrix.

    Returns (best, second, idx_b, col_idx): per-row best and second-best
    penalized distances (int32), the per-row argmin over B and the
    per-column argmin over A (cross-check).  Any N, M: rows and columns are
    padded to the blocking with penalized slots.
    """
    n, m = sa.shape[0], sb.shape[0]
    block_n, block_m, chunk_m = blocking(n, m, block_n, block_m, chunk_m)
    n_pad = _round_up(n, block_n)
    m_pad = _round_up(m, chunk_m)
    mshift, nshift = _bits_for(m_pad), _bits_for(n_pad)
    if (_MAXD << max(mshift, nshift)) > _INT32_MAX:
        raise ValueError(f"match of {n} x {m} is too large for int32 codes")

    sa = jnp.pad(sa, ((0, n_pad - n), (0, 0)))
    pen_a = jnp.pad(pen_a, (0, n_pad - n), constant_values=PEN)
    uv_a = jnp.pad(uv_a, ((0, 0), (0, n_pad - n)))
    sbT = jnp.pad(sb, ((0, m_pad - m), (0, 0))).T
    pen_b = jnp.pad(pen_b, (0, m_pad - m), constant_values=PEN)
    uv_b = jnp.pad(uv_b, ((0, 0), (0, m_pad - m)))
    colinit = jnp.full((m_pad,), _INT32_MAX, jnp.int32)
    n_split = m_pad // chunk_m

    kernel = functools.partial(
        _kernel, radius2=gate_radius2(radius_px), guided=guided,
        block_m=block_m, mshift=mshift, nshift=nshift)
    code, sec, colcode = pl.pallas_call(
        kernel,
        grid=(n_pad // block_n, n_split),
        in_specs=[
            pl.BlockSpec((block_n, 256), lambda i, j: (i, 0)),
            pl.BlockSpec((block_n,), lambda i, j: (i,)),
            pl.BlockSpec((2, block_n), lambda i, j: (0, i)),
            pl.BlockSpec((256, chunk_m), lambda i, j: (0, j)),
            pl.BlockSpec((chunk_m,), lambda i, j: (j,)),
            pl.BlockSpec((2, chunk_m), lambda i, j: (0, j)),
            pl.BlockSpec((chunk_m,), lambda i, j: (j,)),
        ],
        out_specs=[
            pl.BlockSpec((None, block_n), lambda i, j: (j, i)),
            pl.BlockSpec((None, block_n), lambda i, j: (j, i)),
            pl.BlockSpec((chunk_m,), lambda i, j: (j,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_split, n_pad), jnp.int32),
            jax.ShapeDtypeStruct((n_split, n_pad), jnp.int32),
            jax.ShapeDtypeStruct((m_pad,), jnp.int32),
        ],
        input_output_aliases={6: 2},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=2),
        interpret=interpret,
        name="hamming_match_fused",
    )(sa, pen_a, uv_a, sbT, pen_b, uv_b, colinit)

    # Merge the column chunks of each row.  The winning chunk's second best
    # excludes the argmin column; every other chunk offers its best.
    win = jnp.argmin(code, axis=0)
    best_code = jnp.min(code, axis=0)
    dist_s = code >> mshift
    second = jnp.min(
        jnp.where(jnp.arange(n_split)[:, None] == win[None, :], sec, dist_s),
        axis=0)
    best = best_code >> mshift
    idx_b = jnp.minimum(best_code & ((1 << mshift) - 1), m - 1)
    col_idx = colcode & ((1 << nshift) - 1)
    return best[:n], second[:n], idx_b[:n], col_idx[:m]
