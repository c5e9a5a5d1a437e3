"""Exhaustive property test of the bitwise streak detector (SURVEY §4.2):
all 65,536 16-bit masks vs a naive circular run-length check, for every
supported run length."""

import numpy as np
import jax.numpy as jnp
import pytest

from tinyslam.ops.fast import detect_streak, detect_streak_16
from tests.golden import streak16_naive


@pytest.mark.parametrize("n", [1, 2, 3, 7, 9, 11, 12, 13, 15, 16])
def test_streak_exhaustive(n):
    masks = jnp.arange(65536, dtype=jnp.int32)
    got = np.asarray(detect_streak(masks, n)) != 0
    want = np.array([streak16_naive(i, n) for i in range(65536)])
    np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


def test_streak16_is_n12():
    masks = jnp.arange(65536, dtype=jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(detect_streak_16(masks)), np.asarray(detect_streak(masks, 12))
    )


def test_streak_rotation_invariant():
    # An n-run anywhere on the circle is detected; an (n-1)-run is not.
    for n in (9, 12):
        run = (1 << n) - 1
        short = (1 << (n - 1)) - 1
        for r in range(16):
            rot = ((run << r) | (run >> (16 - r))) & 0xFFFF
            srot = ((short << r) | (short >> (16 - r))) & 0xFFFF
            assert bool(detect_streak(jnp.int32(rot), n) != 0)
            assert not bool(detect_streak(jnp.int32(srot), n) != 0)
