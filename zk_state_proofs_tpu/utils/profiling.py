"""Profiling + throughput instrumentation.

The reference's only instrumentation is ad-hoc Instant::now prints in its
prover tests (reference: prover/src/bin/main.rs:39,54-55). Here: a timing
context that forces device sync, a throughput meter (hashes/sec,
proofs/sec), and a hook into jax.profiler for device traces.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field

import jax


@dataclass
class Meter:
    """Accumulates per-step stats for a verification run."""

    proofs: int = 0
    nodes_hashed: int = 0
    bytes_hashed: int = 0
    seconds: float = 0.0
    steps: int = 0

    def record(self, batch: int, nodes: int, nbytes: int, dt: float) -> None:
        self.proofs += batch
        self.nodes_hashed += nodes
        self.bytes_hashed += nbytes
        self.seconds += dt
        self.steps += 1

    def summary(self) -> dict:
        s = max(self.seconds, 1e-9)
        return {
            "proofs_per_sec": self.proofs / s,
            "hashes_per_sec": self.nodes_hashed / s,
            "bytes_hashed_per_sec": self.bytes_hashed / s,
            "steps": self.steps,
            "seconds": self.seconds,
        }

    def dump(self, file=sys.stderr) -> None:
        print(json.dumps(self.summary()), file=file, flush=True)


@contextlib.contextmanager
def timed(result_holder: dict, key: str = "seconds", sync=None):
    """Time a block, blocking on `sync` (a jax value/tree) before stopping
    the clock so device work is included."""
    t0 = time.time()
    yield
    if sync is not None:
        jax.block_until_ready(sync)
    result_holder[key] = time.time() - t0


@contextlib.contextmanager
def tpu_trace(logdir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
