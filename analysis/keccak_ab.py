"""A/B of the GPU Keccak sponge kernel against the XLA sponge, on a card.

    python analysis/keccak_ab.py

Both sponges run in one process, in turns (kernel, XLA, XLA, kernel), at:
  - the unique-node pool of a 4096-distinct-account batch (~5.6k
    length-sorted rows of 576 B), unsegmented and with pool_segments;
  - 4096 rows of 2,176 B with random lengths;
  - verify_proofs_pooled end to end at BucketConfig.account() (hash +
    scatter + walk + value extraction).
Each figure is device time per call: K calls chained in one jitted
fori_loop (a counter perturbs a padding or leading byte so no call is
loop-invariant), best of R repetitions. The implementation is switched
through ops.backend.keccak_impl, with JAX's caches cleared in between.
Prints one JSON line per measurement and the card beside them.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

K, REPS = 16, 5


def _device_ms(step, *args):
    """Best-of-REPS mean ms per inner call of `step` (K calls per run)."""
    import jax

    jax.block_until_ready(step(*args))
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(step(*args))
        best = min(best, (time.perf_counter() - t0) / K)
    return best * 1e3


def _hash_step(data, lens, segments=None, perturb_col=0):
    import jax
    import jax.numpy as jnp

    from zk_state_proofs_tpu.ops import mpt

    @jax.jit
    def step(d, l):
        def body(i, acc):
            x = d.at[:, perturb_col].set(i.astype(jnp.uint8))
            return acc ^ mpt._hash_pool_rows(x, l, segments)[:, 0]
        return jax.lax.fori_loop(0, K, body,
                                 jnp.zeros((d.shape[0],), jnp.uint8))

    return _device_ms(step, data, lens)


def _verify_step(packed):
    import jax
    import jax.numpy as jnp

    from zk_state_proofs_tpu.ops import mpt

    args = [jnp.asarray(a) for a in packed.astuple()]
    pool = [jnp.asarray(a) for a in packed.pool()]

    @jax.jit
    def step(nodes, pool_nodes):
        def body(i, acc):
            c = i.astype(jnp.uint8)
            s, v, l = mpt.verify_proofs_pooled(
                nodes.at[:, :, -1].set(c), *args[1:],
                pool_nodes.at[:, -1].set(c), *pool[1:])
            return acc + s + jnp.sum(v.astype(jnp.int32), axis=1) + l
        return jax.lax.fori_loop(0, K, body,
                                 jnp.zeros((nodes.shape[0],), jnp.int32))

    return _device_ms(step, args[0], pool[0])


def main():
    import jax

    from bench import build_witness_batch
    from zk_state_proofs_tpu.ops import backend, keccak_gpu
    from zk_state_proofs_tpu.ops import keccak as xla
    from zk_state_proofs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit("keccak_ab: no GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    # 4096 distinct accounts, depth-sorted, packed at the served bucket
    # (BucketConfig.account(): max_nodes 12, 576 B nodes)
    batch = build_witness_batch(4096, 4096, max_nodes=12)
    pool_nodes, pool_lens, _ = batch.pool()
    segs = batch.pool_block_segments()
    rng = np.random.default_rng(0)
    wide = rng.integers(0, 256, (4096, 2176), dtype=np.uint8)
    wide_lens = rng.integers(0, 2177, 4096).astype(np.int32)
    print(json.dumps({"pool_rows": int(pool_nodes.shape[0]),
                      "pool_real_rows": int((pool_lens > 0).sum()),
                      "pool_segments": segs}), flush=True)

    impls = {"kernel": keccak_gpu.keccak256_gpu, "xla": xla.keccak256}
    for name in ("kernel", "xla", "xla", "kernel"):
        backend.keccak_impl = lambda f=impls[name]: f
        jax.clear_caches()
        row = {"impl": name, "card": card}
        row["pool_ms"] = _hash_step(pool_nodes, pool_lens)
        row["pool_segmented_ms"] = _hash_step(pool_nodes, pool_lens, segs)
        row["wide_2176_ms"] = _hash_step(wide, wide_lens)
        row["verify_pooled_account_ms"] = _verify_step(batch)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
