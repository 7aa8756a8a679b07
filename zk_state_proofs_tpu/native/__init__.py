"""ctypes bindings for the native host runtime (native/zkp_host.cpp).

The shared library is built from the committed source at first use (g++)
and is never committed: a build is written to a temporary file beside its
target and renamed into place, so processes that import this package at
once (test workers) never load a half-written library. Every caller has a
pure-Python fallback, so the framework works without the native library
(just slower on host-side packing/hashing).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SO = _HERE / "libzkp_host.so"
_SRC = _HERE.parent.parent / "native" / "zkp_host.cpp"

_lib = None
_load_failed = False
built_from_source = False  # this process compiled the library


def _build(target: Path = _SO) -> bool:
    """Compile _SRC into `target` atomically; True on success."""
    if not _SRC.exists():
        return False
    fd, tmp = tempfile.mkstemp(dir=target.parent, prefix=target.name + ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp,
             str(_SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _load_failed, built_from_source
    if _lib is not None or _load_failed:
        return _lib
    stale = (_SO.exists() and _SRC.exists()
             and _SRC.stat().st_mtime > _SO.stat().st_mtime)
    if not _SO.exists() or stale:
        if _build():
            built_from_source = True
        elif not _SO.exists():
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        _load_failed = True
        return None
    lib.zkp_keccak256.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p
    ]
    lib.zkp_keccak256_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
    ]
    lib.zkp_pack_proofs.restype = ctypes.c_int
    if hasattr(lib, "zkp_build_node_pool"):
        lib.zkp_build_node_pool.restype = ctypes.c_int
        lib.zkp_build_node_pool.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def keccak256(data: bytes) -> bytes:
    """Native legacy Keccak-256; falls back to the Python oracle."""
    lib = get_lib()
    if lib is None:
        from ..oracle.keccak import keccak256 as py_keccak

        return py_keccak(data)
    out = ctypes.create_string_buffer(32)
    lib.zkp_keccak256(data, len(data), out)
    return out.raw


def keccak256_batch(messages) -> list:
    """Digest a list of byte strings natively (single ctypes call)."""
    lib = get_lib()
    if lib is None:
        from ..oracle.keccak import keccak256 as py_keccak

        return [py_keccak(m) for m in messages]
    blob = b"".join(messages)
    offsets = np.zeros(len(messages) + 1, dtype=np.int64)
    np.cumsum([len(m) for m in messages], out=offsets[1:])
    out = np.empty((len(messages), 32), dtype=np.uint8)
    lib.zkp_keccak256_batch(
        ctypes.c_char_p(blob),
        offsets.ctypes.data_as(ctypes.c_void_p),
        len(messages),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return [bytes(out[i]) for i in range(len(messages))]


def build_node_pool_native(nodes, node_lens, num_nodes,
                           pad_multiple: int = 128, min_rows: int = 0):
    """Native unique-node pool construction (zkp_build_node_pool),
    byte-identical to witness.pack.build_node_pool. Returns
    (pool_nodes, pool_lens, pool_idx) or None when the native library
    (or the symbol, for a stale build) is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "zkp_build_node_pool"):
        return None
    nodes = np.ascontiguousarray(nodes, dtype=np.uint8)
    node_lens = np.ascontiguousarray(node_lens, dtype=np.int32)
    num_nodes = np.ascontiguousarray(num_nodes, dtype=np.int32)
    b, d, n = nodes.shape
    cap = int(num_nodes.sum()) + 1
    cap = max(-(-cap // pad_multiple) * pad_multiple, min_rows)
    pool_nodes = np.zeros((cap, n), dtype=np.uint8)
    pool_lens = np.zeros(cap, dtype=np.int32)
    pool_idx = np.zeros((b, d), dtype=np.int32)
    used = lib.zkp_build_node_pool(
        nodes.ctypes.data_as(ctypes.c_void_p),
        node_lens.ctypes.data_as(ctypes.c_void_p),
        num_nodes.ctypes.data_as(ctypes.c_void_p),
        b, d, n,
        pool_nodes.ctypes.data_as(ctypes.c_void_p),
        pool_lens.ctypes.data_as(ctypes.c_void_p),
        pool_idx.ctypes.data_as(ctypes.c_void_p),
        cap,
    )
    if used < 0:
        from ..witness.pack import PackingError

        raise PackingError("node pool exceeded its capacity bound")
    u = max(-(-used // pad_multiple) * pad_multiple, min_rows)
    return pool_nodes[:u], pool_lens[:u], pool_idx


def pack_proofs_native(entries, max_nodes: int, node_len: int, key_nibbles: int):
    """Native packing path for witness.pack_proofs. Returns the packed
    numpy arrays, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    b = len(entries)
    node_blob_parts, counts, roots, key_parts = [], [], [], []
    for root, proof, key in entries:
        counts.append(len(proof))
        node_blob_parts.extend(proof)
        roots.append(root)
        key_parts.append(key)
    node_blob = b"".join(node_blob_parts)
    node_offsets = np.zeros(len(node_blob_parts) + 1, dtype=np.int64)
    np.cumsum([len(n) for n in node_blob_parts], out=node_offsets[1:])
    key_blob = b"".join(key_parts)
    key_offsets = np.zeros(b + 1, dtype=np.int64)
    np.cumsum([len(k) for k in key_parts], out=key_offsets[1:])
    counts_arr = np.asarray(counts, dtype=np.int32)
    roots_blob = b"".join(roots)

    nodes = np.empty((b, max_nodes, node_len), dtype=np.uint8)
    node_lens = np.empty((b, max_nodes), dtype=np.int32)
    num_nodes = np.empty(b, dtype=np.int32)
    out_roots = np.empty((b, 32), dtype=np.uint8)
    knib = np.empty((b, key_nibbles), dtype=np.uint8)
    key_lens = np.empty(b, dtype=np.int32)

    rc = lib.zkp_pack_proofs(
        ctypes.c_char_p(node_blob),
        node_offsets.ctypes.data_as(ctypes.c_void_p),
        counts_arr.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_char_p(roots_blob),
        ctypes.c_char_p(key_blob),
        key_offsets.ctypes.data_as(ctypes.c_void_p),
        b, max_nodes, node_len, key_nibbles,
        nodes.ctypes.data_as(ctypes.c_void_p),
        node_lens.ctypes.data_as(ctypes.c_void_p),
        num_nodes.ctypes.data_as(ctypes.c_void_p),
        out_roots.ctypes.data_as(ctypes.c_void_p),
        knib.ctypes.data_as(ctypes.c_void_p),
        key_lens.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        from ..witness.pack import PackingError

        raise PackingError(f"proof {rc - 1} exceeds bucket (max_nodes={max_nodes}, node_len={node_len}, key_nibbles={key_nibbles})")
    return nodes, node_lens, num_nodes, out_roots, knib, key_lens
