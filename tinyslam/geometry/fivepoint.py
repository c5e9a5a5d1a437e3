"""Nister 5-point minimal essential-matrix solver, jit-friendly.

The classic solver needs two tools XLA lacks: symbolic polynomial
expansion and a nonsymmetric eigensolver for polynomial roots.  Both are
rebuilt jit-friendly here:

- The ten cubic constraints (det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0) in
  the null-space coordinates (x, y, z) are expanded with *static monomial
  multiplication tables* (built once in numpy): a polynomial is a coefficient
  vector over a fixed monomial order and products are einsums against 0/1
  tensors — fully batched over RANSAC hypotheses.
- Gauss-Jordan reduction of the 10x20 system is a batched LU solve.
- Nister's 3x3 polynomial determinant gives a degree-10 univariate
  polynomial whose roots are found with batched Durand-Kerner (Weierstrass)
  iteration in explicit complex arithmetic — no eig, fixed iteration count.

Each 5-point sample yields up to 10 essential matrices; non-real or
degenerate candidates become garbage matrices that RANSAC scoring discards.

Derivation of the 3x3 matrix B(z) (self-contained): after reduction, each
leading monomial m in {x^2, x^2 z, xy, xyz, y^2, y^2 z} is expressed over
the trailing monomials {x,y,1} x {z^2,z,1} u {z^3}.  For m in
{x^2, xy, y^2}: z * red(m) - red(m z) = a(z) x + b(z) y + c(z) = 0 with
deg a,b <= 3, deg c <= 4.  A nontrivial (x, y, 1) solution requires
det B(z) = 0 — a degree-10 polynomial in z (Nister 2004).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# ----------------------------------------------------------------- tables --
# Monomial orders.  deg<=1 (entries of E): [x, y, z, 1]
_E1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# deg<=2 (10)
_E2 = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (1, 0, 0), (0, 2, 0),
    (0, 1, 1), (0, 1, 0), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
# deg<=3 (20): leading 10 then trailing 10 (Nister ordering)
_LEAD = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (2, 0, 0), (1, 2, 0),
    (1, 1, 1), (1, 1, 0), (0, 3, 0), (0, 2, 1), (0, 2, 0),
]
_TRAIL = [
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_E3 = _LEAD + _TRAIL

# Indices of reduced rows we need (positions in _LEAD).
_I_X2Z, _I_X2 = 2, 3
_I_XYZ, _I_XY = 5, 6
_I_Y2Z, _I_Y2 = 8, 9


def _mul_table(a_order, b_order, out_order) -> np.ndarray:
    out_index = {m: i for i, m in enumerate(out_order)}
    T = np.zeros((len(a_order), len(b_order), len(out_order)), np.float32)
    for i, ma in enumerate(a_order):
        for j, mb in enumerate(b_order):
            m = tuple(x + y for x, y in zip(ma, mb))
            if m in out_index:
                T[i, j, out_index[m]] = 1.0
    return T


_T11 = _mul_table(_E1, _E1, _E2)   # (4, 4, 10)
_T21 = _mul_table(_E2, _E1, _E3)   # (10, 4, 20)


def _p11(a, b):
    """deg1 x deg1 -> deg2 coefficients.  a, b: (..., 4) -> (..., 10)."""
    return jnp.einsum("...i,...j,ijk->...k", a, b, jnp.asarray(_T11))


def _p21(a, b):
    """deg2 x deg1 -> deg3.  a: (..., 10), b: (..., 4) -> (..., 20)."""
    return jnp.einsum("...i,...j,ijk->...k", a, b, jnp.asarray(_T21))


def five_point_constraint_matrix(basis: jax.Array) -> jax.Array:
    """basis: (..., 4, 3, 3) null-space matrices [E1, E2, E3, E4] with
    E = x E1 + y E2 + z E3 + E4.  Returns M (..., 10, 20) over _E3 order."""
    # E entries as deg-1 polynomials: coeffs (..., 3, 3, 4) ordered [x,y,z,1].
    Ec = jnp.moveaxis(basis, -3, -1)                   # (..., 3, 3, 4)

    # EEt_ab = sum_c E_ac * E_bc : (..., 3, 3, 10)
    EEt = jnp.einsum(
        "...ack,...bcl,klm->...abm", Ec, Ec, jnp.asarray(_T11)
    )
    trace = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]

    # C_ab = 2 * sum_c EEt_ac E_cb - trace * E_ab : (..., 3, 3, 20)
    C = 2.0 * jnp.einsum(
        "...ack,...cbl,klm->...abm", EEt, Ec, jnp.asarray(_T21)
    ) - jnp.einsum("...k,...abl,klm->...abm", trace, Ec, jnp.asarray(_T21))

    # det(E): cofactor expansion along row 0.
    def minor(r1, r2, c1, c2):
        return _p11(Ec[..., r1, c1, :], Ec[..., r2, c2, :]) - _p11(
            Ec[..., r1, c2, :], Ec[..., r2, c1, :]
        )

    det = (
        _p21(minor(1, 2, 1, 2), Ec[..., 0, 0, :])
        - _p21(minor(1, 2, 0, 2), Ec[..., 0, 1, :])
        + _p21(minor(1, 2, 0, 1), Ec[..., 0, 2, :])
    )

    rows = [det] + [C[..., a, b, :] for a in range(3) for b in range(3)]
    return jnp.stack(rows, axis=-2)                    # (..., 10, 20)


def _poly_mul(p, q):
    """Batched univariate multiply; p (..., m), q (..., n) coeff arrays in
    DESCENDING degree -> (..., m+n-1)."""
    m = p.shape[-1]
    n = q.shape[-1]
    out = []
    for k in range(m + n - 1):
        terms = [
            p[..., i] * q[..., k - i]
            for i in range(max(0, k - n + 1), min(m, k + 1))
        ]
        out.append(sum(terms))
    return jnp.stack(out, axis=-1)


def _poly_sub(p, q):
    """p - q, aligning trailing (low-degree) coefficients."""
    m = max(p.shape[-1], q.shape[-1])
    pad_p = [(0, 0)] * (p.ndim - 1) + [(m - p.shape[-1], 0)]
    pad_q = [(0, 0)] * (q.ndim - 1) + [(m - q.shape[-1], 0)]
    return jnp.pad(p, pad_p) - jnp.pad(q, pad_q)


def nister_degree10(M: jax.Array):
    """M (..., 10, 20) -> (poly10 (..., 11) descending z-coeffs,
    Bz rows (a (...,3,4), b (...,3,4), c (...,3,5)) for x,y recovery)."""
    M1 = M[..., :10]
    M2 = M[..., 10:]
    # red: lead_i = -(M1^-1 M2)[i] . trail
    B = -jnp.linalg.solve(M1, M2)                      # (..., 10, 10)

    def split(row):
        # trail = [xz2, xz, x, yz2, yz, y, z3, z2, z, 1]
        a = row[..., 0:3]      # x coeffs, degrees z2, z, 1 (descending)
        b = row[..., 3:6]
        c = row[..., 6:10]     # z3, z2, z, 1
        return a, b, c

    def z_shift(p):
        """z * p: append a zero constant coefficient."""
        return jnp.concatenate([p, jnp.zeros_like(p[..., :1])], axis=-1)

    rows_abc = []
    for i_m, i_mz in ((_I_X2, _I_X2Z), (_I_XY, _I_XYZ), (_I_Y2, _I_Y2Z)):
        am, bm, cm = split(B[..., i_m, :])
        az, bz, cz = split(B[..., i_mz, :])
        rows_abc.append((
            _poly_sub(z_shift(am), az),     # deg 3 -> 4 coeffs
            _poly_sub(z_shift(bm), bz),
            _poly_sub(z_shift(cm), cz),     # deg 4 -> 5 coeffs
        ))

    (a1, b1, c1), (a2, b2, c2), (a3, b3, c3) = rows_abc
    det = (
        _poly_mul(a1, _poly_sub(_poly_mul(b2, c3), _poly_mul(b3, c2)))
    )
    det = _poly_sub(det, _poly_mul(b1, _poly_sub(_poly_mul(a2, c3), _poly_mul(a3, c2))))
    det = _poly_sub(
        det,
        -_poly_mul(c1, _poly_sub(_poly_mul(a2, b3), _poly_mul(a3, b2))),
    )
    # det has 12 coeffs (deg 11 allocation) but true degree 10: drop lead.
    poly10 = det[..., -11:]
    A = jnp.stack([a1, a2], axis=-2)                   # (..., 2, 4)
    Bc = jnp.stack([b1, b2], axis=-2)
    Cc = jnp.stack([c1, c2], axis=-2)                  # (..., 2, 5)
    return poly10, (A, Bc, Cc)


def _horner(coeffs, zr, zi):
    """Evaluate batched real-coefficient poly at complex z (descending
    coeffs; coeffs (..., n), z (..., k)) -> (re, im) each (..., k)."""
    n = coeffs.shape[-1]
    pr = jnp.broadcast_to(coeffs[..., 0:1], zr.shape)
    pi = jnp.zeros_like(zr)
    for i in range(1, n):
        pr, pi = (
            pr * zr - pi * zi + coeffs[..., i : i + 1],
            pr * zi + pi * zr,
        )
    return pr, pi


def durand_kerner_roots(poly: jax.Array, iters: int = 100):
    """Simultaneous root iteration for batched degree-d real polynomials.

    poly: (..., d+1) descending coefficients.  Returns (re, im) (..., d).

    The variable is rescaled first (z = s*w with s = max_k |a_k|^(1/k) for
    the monic coefficients a) so every root of the iterated polynomial lies
    within ~2 of the unit circle — plain Durand-Kerner from a radius-1.5
    start diverges on the badly-scaled polynomials Nister's determinant
    produces (leading coefficients can be 1e4 x smaller than the tail).
    """
    d = poly.shape[-1] - 1
    lead = poly[..., 0:1]
    lead = jnp.where(jnp.abs(lead) > 1e-12, lead, 1e-12)
    p = poly / lead
    # Balance: s = max_k |a_k|^(1/k); substitute z = s w -> b_k = a_k / s^k.
    ks = jnp.arange(1, d + 1, dtype=poly.dtype)
    mags = jnp.abs(p[..., 1:]) ** (1.0 / ks)
    s = jnp.clip(jnp.max(mags, axis=-1, keepdims=True), 1e-6, 1e6)  # (..., 1)
    p = p / s ** jnp.arange(0, d + 1, dtype=poly.dtype)
    # Initial guesses: scaled roots of unity (Aberth's standard start).
    angles = 2.0 * np.pi * (np.arange(d) + 0.25) / d
    r0 = jnp.asarray(np.cos(angles), poly.dtype)
    i0 = jnp.asarray(np.sin(angles), poly.dtype)
    shape = (*poly.shape[:-1], d)
    zr = jnp.broadcast_to(r0, shape) * 1.5
    zi = jnp.broadcast_to(i0, shape) * 1.5

    def step(carry, _):
        zr, zi = carry
        pr, pi = _horner(p, zr, zi)
        # denom_i = prod_{j != i} (z_i - z_j)
        dr = zr[..., :, None] - zr[..., None, :]
        di = zi[..., :, None] - zi[..., None, :]
        eye = jnp.eye(d, dtype=poly.dtype)
        dr = dr + eye                                  # diagonal -> 1 + 0i
        # complex product over j: accumulate
        qr = jnp.ones_like(zr)
        qi = jnp.zeros_like(zr)
        for j in range(d):
            ar = dr[..., :, j]
            # zero the diagonal's imaginary part so entry (j, j) is 1 + 0i
            ai = jnp.where(jnp.arange(d) == j, 0.0, di[..., :, j])
            qr, qi = qr * ar - qi * ai, qr * ai + qi * ar
        # delta = p / denom
        den = qr * qr + qi * qi
        den = jnp.where(den > 1e-30, den, 1e-30)
        delr = (pr * qr + pi * qi) / den
        deli = (pi * qr - pr * qi) / den
        zr2 = zr - delr
        zi2 = zi - deli
        ok = jnp.isfinite(zr2) & jnp.isfinite(zi2)
        return (jnp.where(ok, zr2, zr), jnp.where(ok, zi2, zi)), None

    (zr, zi), _ = jax.lax.scan(step, (zr, zi), None, length=iters)
    return zr * s, zi * s


def five_point_essential(x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Minimal 5-point solve.  x1, x2: (..., 5, 2) normalized.

    Returns (..., 10, 3, 3): candidate essential matrices (complex/degenerate
    roots produce junk candidates — score and discard downstream)."""
    h1 = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    h2 = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*h1.shape[:-2], 5, 9)
    # Exact 4-dim null space of the minimal 5x9 constraint matrix via
    # complete QR of A^T (linalg.py: full f32 accuracy, no SVD, no
    # condition-number squaring — the Nister resultant construction needs
    # the basis at f32 precision, which the normal-matrix route cannot give).
    from tinyslam.geometry.linalg import exact_null_space

    vecs = exact_null_space(A, 4)                       # (..., 9, 4)
    basis = jnp.swapaxes(vecs, -1, -2).reshape(*A.shape[:-2], 4, 3, 3)

    M = five_point_constraint_matrix(basis)
    poly10, (Ar, Br, Cr) = nister_degree10(M)
    zr, zi = durand_kerner_roots(poly10)               # (..., 10)

    real = jnp.abs(zi) < 1e-4 * (1.0 + jnp.abs(zr))

    # x, y from the 2x2 system [a1 b1; a2 b2] [x y]^T = -[c1 c2] at z=root.
    def eval_poly(c, z):
        # c (..., 2, n), z (..., 10) -> (..., 10, 2)
        n = c.shape[-1]
        out = jnp.broadcast_to(
            c[..., None, :, 0], (*z.shape, 2)
        )
        for i in range(1, n):
            out = out * z[..., None] + c[..., None, :, i]
        return out

    av = eval_poly(Ar, zr)                             # (..., 10, 2)
    bv = eval_poly(Br, zr)
    cv = eval_poly(Cr, zr)
    det = av[..., 0] * bv[..., 1] - av[..., 1] * bv[..., 0]
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    xs = (-cv[..., 0] * bv[..., 1] + cv[..., 1] * bv[..., 0]) / det
    ys = (-av[..., 0] * cv[..., 1] + av[..., 1] * cv[..., 0]) / det

    E = (
        xs[..., None, None] * basis[..., None, 0, :, :]
        + ys[..., None, None] * basis[..., None, 1, :, :]
        + zr[..., None, None] * basis[..., None, 2, :, :]
        + basis[..., None, 3, :, :]
    )
    # Invalidate non-real roots (scored out downstream).
    E = jnp.where(real[..., None, None], E, 1e6)
    norm = jnp.linalg.norm(E, axis=(-2, -1), keepdims=True)
    return E / jnp.maximum(norm, 1e-12)


@functools.partial(
    jax.jit, static_argnames=("num_hypotheses", "refine_iters", "lo_candidates")
)
def ransac_essential_5pt(
    key: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    valid: jax.Array,
    inlier_threshold: float = 2e-3,
    num_hypotheses: int = 256,
    refine_iters: int = 2,
    lo_candidates: int = 16,
) -> dict[str, jax.Array]:
    """LO-RANSAC with the 5-point minimal solver (each sample contributes
    its 10 polynomial roots as hypotheses).  Mirrors ransac_essential."""
    from tinyslam.geometry.epipolar import eight_point_essential, sampson_error

    thresh2 = inlier_threshold * inlier_threshold
    wide2 = 16.0 * thresh2

    order = jnp.argsort(~valid)
    x1c = x1[order]
    x2c = x2[order]
    count = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)

    u = jax.random.uniform(key, (num_hypotheses, 5))
    idx = jnp.minimum((u * count).astype(jnp.int32), count - 1)
    E = five_point_essential(x1c[idx], x2c[idx])       # (S, 10, 3, 3)
    E = E.reshape(-1, 3, 3)
    errs = sampson_error(E, x1[None], x2[None])        # (S*10, N)
    errs = jnp.where(jnp.isfinite(errs), errs, 1e9)
    wide_scores = jnp.sum(((errs < wide2) & valid[None]).astype(jnp.int32), axis=1)

    k = lo_candidates
    topk = jnp.argsort(-wide_scores)[:k]
    x1b = jnp.broadcast_to(x1, (k, *x1.shape))
    x2b = jnp.broadcast_to(x2, (k, *x2.shape))
    pool = [E[topk]]
    err_k = errs[topk]
    for _ in range(refine_iters):
        w = ((err_k < wide2) & valid[None]).astype(jnp.float32)
        E_r = eight_point_essential(x1b, x2b, w)
        err_k = sampson_error(E_r, x1[None], x2[None])
        pool.append(E_r)

    E_pool = jnp.concatenate(pool, axis=0)
    err_pool = sampson_error(E_pool, x1[None], x2[None])
    err_pool = jnp.where(jnp.isfinite(err_pool), err_pool, 1e9)
    tight = jnp.sum(((err_pool < thresh2) & valid[None]).astype(jnp.int32), axis=1)
    E_best = E_pool[jnp.argmax(tight)]
    err = sampson_error(E_best, x1, x2)
    inliers = (err < thresh2) & valid
    return {
        "E": E_best,
        "inliers": inliers,
        "num_inliers": jnp.sum(inliers.astype(jnp.int32)),
    }
