"""2-process jax.distributed test of the multi-host path.

Spawns two coordinated CPU processes (2 virtual devices each -> a 4-device
global mesh) and drives, across the process boundary:
  - parallel.multihost.initialize (coordinator wiring + topology)
  - verify_proofs_sharded on the global mesh (global-array placement,
    psum'ed stats, output allgather back to both hosts)
  - dist_trie.compute_root_sharded (sharded leaf hashing + all_gather)

The reference has no distributed layer at all (SURVEY.md §2.3); this is the
net-new scale-out capability's integration test.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")   # CPU even where a GPU is visible

    coordinator, pid = sys.argv[1], int(sys.argv[2])

    from zk_state_proofs_tpu.parallel import multihost

    topo = multihost.initialize(coordinator_address=coordinator,
                                num_processes=2, process_id=pid)
    assert topo["process_count"] == 2, topo
    assert topo["local_devices"] == 2, topo
    assert topo["global_devices"] == 4, topo

    from zk_state_proofs_tpu.oracle import EthTrie, keccak256
    from zk_state_proofs_tpu.oracle import rlp as orlp
    from zk_state_proofs_tpu.ops import mpt
    from zk_state_proofs_tpu.parallel import (
        compute_root_sharded, make_mesh, verify_proofs_sharded)
    from zk_state_proofs_tpu.witness import pack_proofs
    from zk_state_proofs_tpu.witness.trie_plan import plan_index_trie

    # every process builds the SAME witness batch (deterministic), then the
    # global mesh shards it across both processes' devices
    t = EthTrie()
    kvs = {}
    for i in range(40):
        k = keccak256(b"mh-%d" % i)
        v = bytes([i % 199 + 1]) * (1 + i % 25)
        kvs[k] = v
        t.insert(k, v)
    root = t.root_hash()
    keys = list(kvs)
    entries = [(root, t.get_proof(k), k) for k in keys[:31]]
    entries.append((root, t.get_proof(keccak256(b"none")), keccak256(b"none")))
    packed = pack_proofs(entries)

    mesh = make_mesh()                    # all 4 global devices
    assert mesh.devices.size == 4
    status, values, vlens, counts = verify_proofs_sharded(mesh, packed)
    assert counts.tolist() == [31, 1, 0], counts.tolist()
    assert (status[:31] == mpt.FOUND).all()
    assert status[31] == mpt.EXCLUDED
    for i, k in enumerate(keys[:31]):
        assert bytes(values[i][:vlens[i]]) == kvs[k], i

    # sharded trie-root reduction across both processes
    vals = [bytes([i % 251 + 1]) * (40 + i % 60) for i in range(96)]
    ot = EthTrie()
    for i, v in enumerate(vals):
        ot.insert(orlp.encode_int(i), v)
    want = ot.root_hash()
    plan = plan_index_trie(vals)
    got, _ = compute_root_sharded(mesh, plan)
    assert bytes(got) == want, "sharded root mismatch across processes"

    print(f"proc {pid} OK", flush=True)
""")


@pytest.mark.slow
def test_two_process_distributed_verify(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coordinator, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(tmp_path),
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out
