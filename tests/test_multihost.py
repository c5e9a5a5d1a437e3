"""Multi-host runtime bringup: 2 real processes over jax.distributed.

The reference is single-process, single-device (SURVEY §2d: absence of any
distributed layer verified over the whole repo).  Our collectives backend
is jax.distributed + shard_map/psum; this test proves the *bringup path*
(parallel/mesh.initialize_multihost) actually executes: two OS processes
rendezvous at a coordinator, form one global device space, and a psum over
a global mesh reduces across the process boundary.

Runs on CPU (2 local virtual devices per process -> 4 global) — the same
code path that brings up two hosts, minus the interconnect.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tinyslam.parallel.mesh import initialize_multihost

coordinator, pid = sys.argv[1], int(sys.argv[2])
initialize_multihost(coordinator, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
devs = jax.devices()
assert len(devs) == 4, devs  # 2 local x 2 processes

mesh = Mesh(np.asarray(devs), ("landmark",))

@jax.jit
def reduce(x):
    return shard_map(
        lambda s: jax.lax.psum(s, "landmark"),
        mesh=mesh, in_specs=P("landmark"), out_specs=P(),
    )(x)

# Each global device contributes its global index; psum must see all four.
x = jnp.arange(4, dtype=jnp.float32)
out = np.asarray(jax.device_get(reduce(x)))
assert out.shape == (1,) and float(out[0]) == 6.0, out
print(f"proc {pid}: process_count=2 devices=4 psum={float(out[0])}")
"""


def test_two_process_bringup(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    # Two CPU processes with 2 virtual devices each.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = str(REPO)

    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, cwd=str(REPO), text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "process_count=2 devices=4 psum=6.0" in out, out
