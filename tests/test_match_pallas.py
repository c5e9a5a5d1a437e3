"""Fused Triton-route matcher vs the XLA reference matcher.

The kernel runs in Pallas interpret mode on the CPU (the GPU compiles the
same kernel; chip_smoke.py checks it there at real widths).  The two paths
must agree on the valid mask everywhere, and on idx_b/dist on every valid
row — including tie-breaking (argmin keeps the lowest index) and the second
best used by the ratio test.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest

from tinyslam.ops.hamming import match_descriptors, matcher_path
from tinyslam.ops.match_pallas import match_reduce_fused


def _rand_desc(rng, n, dup_frac=0.2):
    """Random descriptors with deliberate duplicates (tie-break coverage)."""
    d = rng.integers(0, 2**32 - 1, (n, 8), np.uint32)
    ndup = int(n * dup_frac)
    if ndup:
        src = rng.integers(0, n, ndup)
        dst = rng.integers(0, n, ndup)
        d[dst] = d[src]
    return d


def _perturb(rng, d, flips=8):
    """Flip a few bits of each descriptor (Hamming ~flips: matchable)."""
    out = d.copy()
    for _ in range(flips):
        word = rng.integers(0, 8, len(out))
        bit = rng.integers(0, 32, len(out))
        out[np.arange(len(out)), word] ^= (np.uint32(1) << bit).astype(
            np.uint32)
    return out


def _problem(seed, n, m, *, invalid_frac=0.1, dup_frac=0.2, at=0):
    rng = np.random.default_rng(seed)
    da = _rand_desc(rng, n, dup_frac)
    db = _rand_desc(rng, m, dup_frac)
    k = min(n, m - at)
    db[at:at + k] = _perturb(rng, da[:k])          # planted matches
    va = rng.random(n) >= invalid_frac
    vb = rng.random(m) >= invalid_frac
    xy = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    proj = rng.uniform(0, 400, (m, 2)).astype(np.float32)
    proj[at:at + k] = xy[:k] + rng.normal(0, 5, (k, 2)).astype(np.float32)
    return tuple(map(jnp.asarray, (da, va, db, vb, xy, proj)))


def _assert_same(ref, out, min_valid=5):
    ref_valid = np.asarray(ref["valid"])
    np.testing.assert_array_equal(np.asarray(out["valid"]), ref_valid)
    assert ref_valid.sum() >= min_valid, "test has no power"
    v = ref_valid
    for key in ("idx_b", "dist"):
        np.testing.assert_array_equal(
            np.asarray(out[key])[v], np.asarray(ref[key])[v])


# (seed, N, M, guided, invalid_frac, dup_frac, max_distance, ratio):
# single block; rows/columns padded to the blocking (N, M not multiples of
# 64/128); several column chunks (M > 1024) and row blocks; many invalid
# slots; heavy ties; a loose ratio test.
CASES = [
    pytest.param(7, 64, 256, False, 0.1, 0.2, 80, 0.9, id="unguided"),
    pytest.param(7, 64, 256, True, 0.1, 0.2, 80, 0.9, id="guided"),
    pytest.param(3, 100, 300, True, 0.1, 0.2, 64, 0.9, id="padded_rows_cols"),
    pytest.param(11, 150, 2200, False, 0.05, 0.3, 128, 0.95,
                 id="multi_chunk"),
    pytest.param(5, 96, 640, True, 0.5, 0.2, 64, 0.9, id="half_invalid"),
    pytest.param(9, 64, 384, False, 0.0, 0.9, 64, 0.9, id="ties"),
]


@pytest.mark.parametrize(
    "seed,n,m,guided,invalid_frac,dup_frac,max_distance,ratio", CASES)
def test_fused_matches_xla(seed, n, m, guided, invalid_frac, dup_frac,
                           max_distance, ratio):
    da, va, db, vb, xy, proj = _problem(
        seed, n, m, invalid_frac=invalid_frac, dup_frac=dup_frac,
        at=m // 3)
    kw = dict(max_distance=max_distance, ratio=ratio, cross_check=True)
    if guided:
        kw.update(xy_a=xy, proj_b=proj, radius_px=30.0)
    ref = match_descriptors(da, va, db, vb, kernel=False, **kw)
    out = match_descriptors(da, va, db, vb, interpret=True, **kw)
    _assert_same(ref, out)


def test_fused_without_cross_check():
    da, va, db, vb, _, _ = _problem(13, 64, 256)
    kw = dict(max_distance=64, ratio=0.9, cross_check=False)
    _assert_same(match_descriptors(da, va, db, vb, kernel=False, **kw),
                 match_descriptors(da, va, db, vb, interpret=True, **kw))


def test_fused_reduction_second_best_and_column_argmin():
    """The raw reduction against a numpy brute force, over every row (not
    only valid ones): best, second best, row argmin and column argmin."""
    rng = np.random.default_rng(21)
    n, m = 40, 200
    sa = rng.choice(np.array([-1, 1], np.int8), (n, 256))
    sb = rng.choice(np.array([-1, 1], np.int8), (m, 256))
    sb[50:90] = sa                                    # exact copies: d = 0
    sb[150:160] = sa[:10]                             # ties at d = 0
    d = (256 - sa.astype(np.int32) @ sb.T.astype(np.int32)) // 2
    best, second, idx_b, col_idx = match_reduce_fused(
        jnp.asarray(sa), jnp.zeros((n,), jnp.int32),
        jnp.zeros((2, n), jnp.int32), jnp.asarray(sb),
        jnp.zeros((m,), jnp.int32), jnp.zeros((2, m), jnp.int32),
        interpret=True)
    np.testing.assert_array_equal(np.asarray(idx_b), np.argmin(d, axis=1))
    np.testing.assert_array_equal(np.asarray(best), d.min(axis=1))
    d2 = d.copy()
    d2[np.arange(n), np.argmin(d, axis=1)] = 1 << 14
    np.testing.assert_array_equal(np.asarray(second), d2.min(axis=1))
    np.testing.assert_array_equal(np.asarray(col_idx), np.argmin(d, axis=0))


@pytest.mark.parametrize("max_distance,ratio,backend,expected", [
    (64, 0.9, "gpu", "triton"),
    (64, 0.9, "cpu", "xla"),
    (64, 0.7, "gpu", "xla"),             # ratio * PEN < 256
    (300, 0.9, "gpu", "xla"),            # max_distance >= PEN
    (299, 256 / 300, "gpu", "triton"),   # both on the envelope's edge
])
def test_matcher_path_choice(max_distance, ratio, backend, expected):
    assert matcher_path(max_distance, ratio, backend=backend) == expected


def _gate_boundary_problem(seed, n, m, radius):
    """Every planted projection sits on the gate circle, one float32 ulp
    inside, on it or one ulp outside, along an axis or a diagonal: the
    cases where a float sum of squares rounds one way or the other."""
    da, va, db, vb, xy, proj = map(np.array, _problem(
        seed, n, m, invalid_frac=0.0, dup_frac=0.0))
    k = min(n, m)
    ang = np.pi / 4 * (np.arange(k) % 4)
    r = np.array([np.nextafter(np.float32(radius), np.float32(0)),
                  np.float32(radius),
                  np.nextafter(np.float32(radius), np.float32(1e9))])
    r = r[(np.arange(k) // 4) % 3]
    off = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    proj[:k] = xy[:k] + off
    return tuple(map(jnp.asarray, (da, va, db, vb, xy, proj)))


@pytest.mark.parametrize("radius", [20.0, 8.0, 19.97])
def test_fused_matches_xla_on_the_gate_boundary(radius):
    """Projections on the gate's edge: the integer gate decides them alike
    on both paths."""
    da, va, db, vb, xy, proj = _gate_boundary_problem(31, 96, 400, radius)
    kw = dict(max_distance=64, ratio=0.9, xy_a=xy, proj_b=proj,
              radius_px=radius)
    _assert_same(match_descriptors(da, va, db, vb, kernel=False, **kw),
                 match_descriptors(da, va, db, vb, interpret=True, **kw))


def test_gate_is_integer_on_a_sixteenth_pixel_grid():
    from tinyslam.ops.match_pallas import gate_coords, gate_radius2

    q = np.asarray(gate_coords(jnp.asarray(
        [[0.0, 1.0], [1e7, -1e7], [20.03, 0.0]], jnp.float32)))
    np.testing.assert_array_equal(q, [[0, 16], [2**24, -2**24], [320, 0]])
    r2 = gate_radius2(20.0)
    assert r2 == 320 * 320
    assert 319 * 319 < r2 and not 320 * 320 < r2      # strictly inside
    with pytest.raises(ValueError, match="out of range"):
        gate_radius2(2000.0)


def test_config_outside_envelope_uses_xla_on_cpu():
    """A legal config outside the penalty envelope is matched by the XLA
    path; forcing the kernel on it is an error, not a silent fallback."""
    da, va, db, vb, _, _ = _problem(17, 32, 128)
    m = match_descriptors(da, va, db, vb, ratio=0.7)
    assert np.asarray(m["valid"]).sum() > 0
    with pytest.raises(ValueError, match="penalty envelope"):
        match_descriptors(da, va, db, vb, ratio=0.7, interpret=True)


@pytest.mark.gpu
def test_fused_matcher_compiled_on_gpu(gpu_backend):
    """The compiled Triton kernel at the tracker's width (the card only)."""
    import jax

    da, va, db, vb, xy, proj = _problem(1, 2048, 8192)
    kw = dict(max_distance=64, ratio=0.9, xy_a=xy, proj_b=proj,
              radius_px=20.0)
    with jax.default_matmul_precision("highest"):
        ref = match_descriptors(da, va, db, vb, kernel=False, **kw)
    _assert_same(ref, match_descriptors(da, va, db, vb, **kw), min_valid=100)


@pytest.mark.parametrize("n,m", [(2048, 8192), (2048, 2048), (7, 100),
                                 (100, 300), (150, 2200), (2048, 12288)])
def test_blocking_is_powers_of_two_near_the_program_target(n, m):
    """Triton blocks must be powers of two; the chunking aims at about
    _TARGET_PROGRAMS programs and never below it when the work allows."""
    from tinyslam.ops.match_pallas import _TARGET_PROGRAMS, blocking

    block_n, block_m, chunk = blocking(n, m)
    for b in (block_n, block_m, chunk):
        assert b >= 16 and b & (b - 1) == 0
    assert chunk % block_m == 0
    programs = -(-n // block_n) * -(-m // chunk)
    if chunk > block_m:
        assert _TARGET_PROGRAMS <= programs < 2 * _TARGET_PROGRAMS + block_n
