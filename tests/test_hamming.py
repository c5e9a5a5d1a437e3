import numpy as np
import jax.numpy as jnp

from tinyslam.ops.hamming import hamming_distance_matrix, match_descriptors
from tinyslam.types import pack_descriptor_bits, unpack_descriptor_bits
from tests.golden import hamming_naive


def _rand_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(5)
    d = _rand_desc(rng, 16)
    bits = unpack_descriptor_bits(jnp.asarray(d))
    back = pack_descriptor_bits(bits)
    np.testing.assert_array_equal(np.asarray(back), d)


def test_distance_matrix_matches_popcount():
    rng = np.random.default_rng(6)
    da, db = _rand_desc(rng, 13), _rand_desc(rng, 17)
    got = np.asarray(hamming_distance_matrix(jnp.asarray(da), jnp.asarray(db)))
    np.testing.assert_array_equal(got, hamming_naive(da, db))


def test_match_identity():
    rng = np.random.default_rng(7)
    d = _rand_desc(rng, 32)
    valid = jnp.ones(32, bool)
    m = match_descriptors(jnp.asarray(d), valid, jnp.asarray(d), valid,
                          max_distance=64, ratio=0.9, cross_check=True)
    np.testing.assert_array_equal(np.asarray(m["idx_b"]), np.arange(32))
    assert np.asarray(m["dist"]).max() == 0
    assert np.asarray(m["valid"]).all()


def test_match_respects_validity_and_distance():
    rng = np.random.default_rng(8)
    da = _rand_desc(rng, 8)
    db = _rand_desc(rng, 8)  # random: expected distance ~128 >> 64
    valid = jnp.ones(8, bool)
    m = match_descriptors(jnp.asarray(da), valid, jnp.asarray(db), valid)
    assert not np.asarray(m["valid"]).any()

    # Invalid B slots must never be selected even if identical.
    db2 = da.copy()
    valid_b = jnp.zeros(8, bool)
    m2 = match_descriptors(jnp.asarray(da), valid, jnp.asarray(db2), valid_b)
    assert not np.asarray(m2["valid"]).any()


def test_streaming_eligibility_matches_kernel_blocking():
    """Eligibility for the fused matcher no longer depends on shape: the
    kernel pads rows and columns to its blocking, so shapes that are not
    block multiples (and tiny ones) must match the XLA path exactly."""
    from tinyslam.ops.hamming import matcher_path

    assert matcher_path(64, 0.9, backend="gpu") == "triton"
    rng = np.random.default_rng(4)
    for n, m in ((7, 100), (70, 1100)):
        da = rng.integers(0, 2**32 - 1, (n, 8), np.uint32)
        db = rng.integers(0, 2**32 - 1, (m, 8), np.uint32)
        db[:n] = da
        va, vb = jnp.ones(n, bool), jnp.ones(m, bool)
        ref = match_descriptors(jnp.asarray(da), va, jnp.asarray(db), vb,
                                kernel=False)
        out = match_descriptors(jnp.asarray(da), va, jnp.asarray(db), vb,
                                interpret=True)
        v = np.asarray(ref["valid"])
        assert v.sum() == n
        np.testing.assert_array_equal(np.asarray(out["valid"]), v)
        np.testing.assert_array_equal(np.asarray(out["idx_b"]),
                                      np.asarray(ref["idx_b"]))
