"""Profiling helpers on CPU: block_until_ready timing, the peak table,
and the trace-to-stage reduction's op-name map."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinyslam.utils.profiling import (
    PEAKS, device_peaks, hlo_op_names, time_call,
)


def test_time_call_measures_work():
    f = jax.jit(lambda x: jnp.sum(x @ x))
    xs = [(jnp.asarray(np.random.default_rng(i).random((256, 256),
                                                      np.float32)),)
          for i in range(4)]
    t = time_call(f, xs, reps=5)
    assert 0.0 < t < 1.0  # positive, sub-second


def test_device_peaks_known_and_unknown():
    h100 = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    assert device_peaks(h100)["hbm_bytes_s"] == 3.35e12
    assert set(PEAKS[h100.device_kind]) >= {"bf16_flops", "hbm_bytes_s"}
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(SimpleNamespace(device_kind="cpu"))


def test_hlo_op_names_carry_named_scopes():
    def f(x):
        with jax.named_scope("stage_a"):
            y = jnp.sin(x) * 2.0
        with jax.named_scope("stage_b"):
            return jnp.sum(y * y)

    text = jax.jit(f).lower(jnp.ones((64,))).compile().as_text()
    scopes = set(hlo_op_names(text).values())
    assert any("/stage_a/" in s for s in scopes)
    assert any("/stage_b/" in s for s in scopes)


@pytest.mark.parametrize("op_name,stage", [
    ("jit(f)/orb_level0/fast/moments/add", "moments"),
    ("jit(f)/orb_level1/fast/gt", "fast"),
    ("jit(f)/orb_level0/nms/select_n", "nms"),
    ("jit(f)/orb_level2/topk/top_k", "topk"),
    ("jit(f)/orb_level0/brief/jit(brief_descriptors_binned)/dot_general",
     "brief"),
    ("jit(f)/blur/mul", "blur"),
    ("jit(f)/downsample/reduce_sum", "downsample"),
    ("jit(run)/while/body/jit(_match_to_map)/match/dot_general", "match"),
    ("jit(f)/concatenate", "other"),
])
def test_profile_stages_classifies_scopes(op_name, stage):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from profile_stages import stage_of

    assert stage_of(op_name) == stage


@pytest.mark.parametrize("kernel,expected", [
    ("loop_add_fusion_3", "jit(f)/fast/add"),
    ("sort_7_1__2", "jit(f)/topk/sort"),
    ("sort_7", "jit(f)/topk/sort"),
    ("memcpy32_post", None),
])
def test_profile_stages_maps_kernels_to_ops(kernel, expected):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from profile_stages import op_name_of

    text = ('  %loop_add_fusion.3 = f32[4]{0} fusion(%p), kind=kLoop, '
            'metadata={op_name="jit(f)/fast/add"}\n'
            '  %sort.7 = (f32[9]{0}) sort(%x), dimensions={0}, '
            'metadata={op_name="jit(f)/topk/sort"}\n')
    assert op_name_of(kernel, hlo_op_names(text)) == expected


@pytest.mark.parametrize("op_name,level", [
    ("jit(f)/orb_level0/fast/moments/add", 0),
    ("jit(f)/blur/orb_level3/mul", 3),
    ("jit(f)/downsample/orb_level12/reduce_sum", 12),
    ("jit(f)/orb_level2x/fast", None),
    ("jit(f)/concatenate", None),
])
def test_profile_stages_reads_pyramid_levels(op_name, level):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from profile_stages import level_of

    assert level_of(op_name) == level


def test_profile_stages_compiles_each_matcher_choice():
    """compile_on retraces under its own matcher choice even after the
    default choice was traced and cached: "triton" reaches the kernel
    (which the CPU cannot compile), "xla" the reference."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from profile_stages import compile_on

    from tinyslam.ops.hamming import match_descriptors

    desc = jnp.asarray(np.arange(64 * 8, dtype=np.uint32).reshape(64, 8))
    valid = jnp.ones(64, bool)

    def match(d):
        return match_descriptors(d, valid, d, valid)

    assert bool(jax.jit(match)(desc)["valid"].all())
    with pytest.raises(Exception, match="(?i)interpret"):
        compile_on(match, (desc,), "triton")
    assert bool(compile_on(match, (desc,), "xla")(desc)["valid"].all())
