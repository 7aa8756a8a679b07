"""Circuit entrypoints — the reference's zkVM guests as device functions.

The reference runs verification inside RISC-V zkVM guests that read a
borsh-encoded input, verify, and commit the result as public values:

  - SP1/Risc0 merkle guest (reference: circuits/sp1-merkle-proof/src/
    main.rs:4-14, risc0-merkle-proof/.../circuit/src/main.rs:5-15):
    read MerkleProofInput -> verify_merkle_proof -> commit(value)
  - Risc0 storage guest (reference: circuits/risc0-storage-proof/.../
    storage-circuit/src/main.rs:6-31): verify account proof at
    address_keccak, decode the account, verify each storage proof at
    keccak(slot) against account.storage_root -> commit(stored_values)

Here the same semantics run batched on device; the "public values" are the
returned bytes (and `models.batch_commitment` digests them for
attestation). STARK proving itself is out of scope (SURVEY.md §7.5) — the
role these functions preserve is the *verifiable re-execution contract*:
same input bytes, same committed output bytes.
"""

from __future__ import annotations

import numpy as np

from ..oracle.trie import MissingKeyError, TrieError
from ..ops import mpt
from ..witness.pack import pack_proofs
from ..witness.types import MerkleProofInput, StorageProofInput
from .verifier import verify_merkle_batch, verify_storage_grouped


def run_merkle_circuit(input_bytes: bytes) -> bytes:
    """The merkle guest on one borsh input: returns the committed value
    (the verified leaf bytes). Raises like the reference panics."""
    inp = MerkleProofInput.from_borsh(input_bytes)
    from .verifier import verify_merkle_proof

    return verify_merkle_proof(inp.root_hash, inp.proof, inp.key)


def run_merkle_circuit_batch(inputs) -> list:
    """Batched merkle guest: many MerkleProofInput -> committed values.
    Entries that fail verification raise if `strict`, as one batch on
    device otherwise a list with None for non-FOUND entries."""
    inputs = [
        MerkleProofInput.from_borsh(i) if isinstance(i, (bytes, bytearray)) else i
        for i in inputs
    ]
    packed = pack_proofs([i.as_entry() for i in inputs])
    res = verify_merkle_batch(
        packed, max_value_len=int(packed.nodes.shape[2])
    )
    out = []
    for i in range(packed.batch):
        out.append(res.value(i) if res.status[i] == mpt.FOUND else None)
    return out


def run_storage_circuit(input_bytes: bytes) -> list:
    """The storage guest on one borsh input: verify the account proof at
    `address_keccak`, decode the account, verify every storage proof at
    keccak(slot) against the decoded storage_root; return the committed
    stored values (reference storage-circuit/src/main.rs:6-31)."""
    inp = (
        StorageProofInput.from_borsh(input_bytes)
        if isinstance(input_bytes, (bytes, bytearray))
        else input_bytes
    )
    n = len(inp.storage_proofs)
    if n != len(inp.storage_keys):
        raise ValueError("storage_proofs and storage_keys length mismatch")
    if n == 0:
        return []
    # ONE account row + n slot rows with a slot->account index — the
    # reference's exact input shape (one account proof, a vector of storage
    # proofs, crypto-ops/src/types.rs:12-19): the account is verified once,
    # not duplicated per slot.
    a_packed = pack_proofs(
        [(inp.root_hash, inp.account_proof, inp.address_keccak)]
    )
    s_packed = pack_proofs(
        [(b"\x00" * 32, p, k) for p, k in zip(inp.storage_proofs, inp.storage_keys)]
    )
    slots = np.stack(
        [np.frombuffer(k.rjust(32, b"\x00"), np.uint8) for k in inp.storage_keys]
    )
    res = verify_storage_grouped(a_packed, s_packed, slots,
                                 np.zeros(n, np.int32))
    if (res.account_status != mpt.FOUND).any():
        raise TrieError("invalid account proof")
    values = []
    for i in range(n):
        if res.slot_status[i] == mpt.EXCLUDED:
            raise MissingKeyError("Key does not exist!")
        if res.slot_status[i] != mpt.FOUND:
            raise TrieError("invalid storage proof")
        values.append(res.slot_value(i))
    return values
