"""Profiling helpers (SURVEY §5).

- ``trace`` / ``named_scope`` — jax.profiler device traces viewable in
  Perfetto/TensorBoard; pipeline stages are annotated with jax.named_scope
  (see frontend.orb) so kernels group by stage in the trace.
- ``time_call`` — wall time of a jitted call, ended by
  ``jax.block_until_ready`` (JAX returns before the device finishes).
- ``device_peaks`` — published peak rates of the device, keyed by
  ``device_kind``; an unknown device is an error, not a default.
- ``device_seconds_per_call`` / ``device_op_seconds`` / ``hlo_op_names`` —
  device time per kernel from a trace, and the named-scope path of each
  op, to split a jitted function's device time by stage.
"""

from __future__ import annotations

import re
import statistics
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import jax

# Published dense peaks (NVIDIA H100 SXM data sheet): memory bandwidth in
# bytes/s and tensor-core / CUDA-core rates in FLOP/s.  They assume the full
# 700 W power limit; report nvidia-smi's power.limit beside any share of them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_s": 3.35e12,
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
    },
}


def device_peaks(device=None) -> dict:
    """Peak rates of ``device`` (default: the first JAX device)."""
    kind = (device or jax.devices()[0]).device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


@contextmanager
def trace(log_dir: str):
    """Capture a device trace of the enclosed block:

        with profiling.trace("traces/extract"):
            feats = frontend.extract(frame)
            jax.block_until_ready(feats)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


named_scope = jax.named_scope


def time_call(fn, inputs, reps: int = 20) -> float:
    """Median seconds per call of ``fn`` over ``inputs`` (a list of argument
    tuples, cycled), after one warm-up call; each call is timed to
    ``jax.block_until_ready`` of its result."""
    inputs = [x if isinstance(x, tuple) else (x,) for x in inputs]
    jax.block_until_ready(fn(*inputs[0]))
    times = []
    for i in range(reps):
        args = inputs[i % len(inputs)]
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


_HLO_OP_RE = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = [^\n]*?op_name="([^"]*)"', re.M)


def hlo_op_names(hlo_text: str) -> dict[str, str]:
    """Instruction name -> ``op_name`` metadata (the jax.named_scope path)
    of an optimized HLO module, e.g. from ``jitted.lower(x).compile()
    .as_text()``.  Fusions carry their root's op_name.  Each name appears
    as written in HLO and as the GPU trace names its kernel ('.' -> '_')."""
    out = {}
    for m in _HLO_OP_RE.finditer(hlo_text):
        out[m.group(1)] = out[m.group(1).replace(".", "_")] = m.group(2)
    return out


def device_op_seconds(trace_dir: str) -> dict[str, float]:
    """Device seconds per kernel name, summed over the events of the newest
    ``jax.profiler`` trace under ``trace_dir``.

    Only device planes (``/device:GPU:*``) count, and on them only the
    stream lines (derived "XLA Ops"/"XLA Modules" lines would repeat the
    same time).  XLA names a fusion's kernel after the HLO instruction
    ('.' -> '_'); a Pallas kernel by its ``name``."""
    paths = sorted(Path(trace_dir).rglob("*.xplane.pb"),
                   key=lambda p: p.stat().st_mtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(str(paths[-1]))
    out: dict[str, float] = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("XLA"):
                continue
            for ev in line.events:
                out[ev.name] = out.get(ev.name, 0.0) + ev.duration_ns * 1e-9
    return out


def device_seconds_per_call(fn, args: tuple, calls: int = 10) -> dict:
    """Trace ``calls`` calls of ``fn(*args)`` (after a warm-up call) and
    return device seconds per call for each kernel name, plus ``"total"``.
    Unlike ``time_call`` this leaves out host dispatch, which dominates the
    wall time of sub-millisecond calls."""
    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            for _ in range(calls):
                jax.block_until_ready(fn(*args))
        ops = device_op_seconds(d)
    out = {k: v / calls for k, v in ops.items()}
    out["total"] = sum(ops.values()) / calls
    return out
