"""chip_smoke.py refuses to run anywhere but on a GPU."""

import pytest

import chip_smoke


def test_require_gpu_raises_on_the_cpu_backend():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu()
