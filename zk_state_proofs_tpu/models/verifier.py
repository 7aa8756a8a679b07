"""Top-level verification workloads — the framework's flagship "models".

Mirrors the reference's circuit semantics with batched device execution:

- `verify_merkle_batch`: the SP1/Risc0 merkle circuit
  (reference: circuits/sp1-merkle-proof/src/main.rs:4-14) — verify a batch
  of MerkleProofInput-style witnesses, return values + status mask.
- `verify_storage_batch`: the two-level Risc0 storage circuit
  (reference: circuits/risc0-storage-proof/.../storage-circuit/src/main.rs:6-31)
  — level 1 verifies the account proof against state_root at key
  keccak(address) (pre-hashed at witness time, reference storage.rs:58-64),
  decodes the account's storage_root on device, then level 2 verifies each
  storage proof at key keccak(slot) (hashed in-circuit, reference
  storage-circuit/src/main.rs:26).
- `verify_merkle_proof`: single-proof convenience with the reference's
  exact raise semantics (crypto-ops/src/lib.rs:8-23).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..oracle.trie import MissingKeyError, TrieError
from ..ops import mpt
from ..ops.backend import keccak256
from ..ops.account import decode_account
from ..ops.rlp import bytes_to_nibbles_device
from ..witness.pack import PackedProofs, pack_proofs


@dataclass
class VerifyResult:
    """Per-proof outcome of a batched verification (numpy)."""

    status: np.ndarray      # i32 [B]: mpt.FOUND / EXCLUDED / INVALID
    values: np.ndarray      # u8  [B, V]
    value_lens: np.ndarray  # i32 [B]
    reasons: np.ndarray | None = None  # i32 [B] (diagnose_batch only)

    def value(self, i: int) -> bytes:
        return bytes(self.values[i][: self.value_lens[i]])

    @property
    def all_found(self) -> bool:
        return bool((self.status == mpt.FOUND).all())

    def counts(self) -> dict:
        s = self.status
        out = {
            "found": int((s == mpt.FOUND).sum()),
            "excluded": int((s == mpt.EXCLUDED).sum()),
            "invalid": int((s == mpt.INVALID).sum()),
        }
        if self.reasons is not None:
            # diagnosable INVALID breakdown (the reference's distinct
            # panic messages, crypto-ops/src/lib.rs:14,22)
            for code, name in mpt.REASON_NAMES.items():
                if code == mpt.R_NONE:
                    continue
                n = int((self.reasons == code).sum())
                if n:
                    out[f"invalid_{name}"] = n
        return out


def verify_merkle_batch(packed: PackedProofs, max_value_len: int = 128,
                        dedup: bool = True) -> VerifyResult:
    """Verify a batch of packed MPT proofs on device.

    dedup=True hashes each unique node once (proofs in a batch share trie
    nodes; see PackedProofs.pool) — identical results, much less keccak."""
    if dedup:
        status, values, vlens = mpt.verify_proofs_pooled(
            *packed.astuple(), *packed.pool(), max_value_len=max_value_len
        )
    else:
        status, values, vlens = mpt.verify_proofs(
            *packed.astuple(), max_value_len=max_value_len
        )
    return VerifyResult(np.asarray(status), np.asarray(values), np.asarray(vlens))


def diagnose_batch(packed: PackedProofs, max_value_len: int = 128) -> VerifyResult:
    """verify_merkle_batch plus per-proof INVALID reason codes
    (mpt.REASON_NAMES) — the debugging surface for witness triage: one
    run of the walker with its reason channel."""
    status, values, vlens, reasons = mpt.verify_proofs_diagnose(
        *packed.astuple(), max_value_len=max_value_len
    )
    return VerifyResult(np.asarray(status), np.asarray(values),
                        np.asarray(vlens), reasons=np.asarray(reasons))


def verify_merkle_proof(root: bytes, proof: list, key: bytes) -> bytes:
    """Single-proof API with the reference's semantics
    (crypto-ops/src/lib.rs:8-23): returns the value; raises MissingKeyError
    for a proven-absent key, TrieError for an invalid proof."""
    packed = pack_proofs([(root, proof, key)])
    res = verify_merkle_batch(packed, max_value_len=max(packed.nodes.shape[2], 128))
    if res.status[0] == mpt.FOUND:
        return res.value(0)
    if res.status[0] == mpt.EXCLUDED:
        raise MissingKeyError("Key does not exist!")
    raise TrieError("invalid merkle proof")


def verify_account_batch(packed: PackedProofs, dedup: bool = True):
    """Account-flavor convenience: verify + device-decode the account leaf.
    Returns (VerifyResult, dict of decoded numpy account fields) — the
    batched analog of the reference's account tests (trie-utils/
    tests/account.rs:33-129: verify then decode_exact::<Account>).
    dedup=True hashes the batch's unique-node pool once, like
    verify_merkle_batch."""
    if dedup:
        status, values, vlens = mpt.verify_proofs_pooled(
            *packed.astuple(), *packed.pool(), max_value_len=128
        )
    else:
        status, values, vlens = mpt.verify_proofs(
            *packed.astuple(), max_value_len=128
        )
    acct = decode_account(values, vlens)
    res = VerifyResult(np.asarray(status), np.asarray(values), np.asarray(vlens))
    return res, {k: np.asarray(v) for k, v in acct.items()}


def batch_commitment(result: VerifyResult) -> bytes:
    """Attestation digest over the verified public outputs — the role of the
    zkVM's committed public values (reference: sp1 guest commit_slice,
    circuits/sp1-merkle-proof/src/main.rs:13). keccak over the
    (status || len || value) stream, so two runs agree iff every per-proof
    outcome and extracted value agree bit-exactly."""
    from ..oracle import keccak256 as _keccak  # oracle for trust; small input

    stream = bytearray()
    for i in range(len(result.status)):
        stream += bytes([int(result.status[i])])
        v = result.value(i)
        stream += len(v).to_bytes(4, "little") + v
    from .. import native

    return native.keccak256(bytes(stream)) if native.available() else _keccak(bytes(stream))


def _slot_key_nibbles(slots):
    """Level-2 keys on device: keccak(slot) nibble-expanded (the reference
    hashes slots in-circuit, storage-circuit/src/main.rs:26).

    slots wider than 32 bytes hash only their first 32 (length-masked
    sponge): benchmark loops carry an iteration counter in the padding
    bytes so every iteration is distinct work while keys — and results —
    stay exact."""
    slot_hashes = keccak256(
        slots, jnp.full((slots.shape[0],), 32, jnp.int32))
    s_knib = jax.vmap(bytes_to_nibbles_device)(slot_hashes)
    s_klen = jnp.full((slots.shape[0],), 64, jnp.int32)
    return s_knib, s_klen


@jax.jit
def _storage_core(a_nodes, a_lens, a_num, a_roots, a_knib, a_klen,
                  s_nodes, s_lens, s_num, slots):
    """Fused two-level verification under one jit (unpooled 1:1 form —
    the parity reference for the pooled/grouped core below)."""
    a_status, a_values, a_vlens = mpt.verify_proofs(
        a_nodes, a_lens, a_num, a_roots, a_knib, a_klen, max_value_len=128
    )
    acct = decode_account(a_values, a_vlens)
    s_knib, s_klen = _slot_key_nibbles(slots)
    s_status, s_values, s_vlens = mpt.verify_proofs(
        s_nodes, s_lens, s_num, acct["storage_root"], s_knib, s_klen,
        max_value_len=64,
    )
    # an invalid/absent account or undecodable leaf invalidates its slots
    account_ok = (a_status == mpt.FOUND) & acct["ok"]
    s_status = jnp.where(account_ok, s_status, mpt.INVALID)
    return a_status, acct, s_status, s_values, s_vlens


@jax.jit
def _storage_core_grouped(a_nodes, a_lens, a_num, a_roots, a_knib, a_klen,
                          a_pn, a_pl, a_pi,
                          s_nodes, s_lens, s_num, s_pn, s_pl, s_pi,
                          slots, slot_accounts):
    """Grouped + pooled two-level verification under one jit.

    The reference's StorageProofInput carries ONE account with a VECTOR of
    storage proofs (crypto-ops/src/types.rs:12-19; loop
    storage-circuit/src/main.rs:18-29). Here that shape generalizes to A
    unique accounts and B slots with a slot->account index: each account
    proof is verified ONCE, each slot's trusted root is the storage_root
    decoded from its owning account (`jnp.take` by index — A is small, so
    the [A, 32] row gather is negligible next to the walks). Hashing is
    deduplicated on BOTH levels via the packed unique-node pools."""
    a_status, a_values, a_vlens = mpt.verify_proofs_pooled(
        a_nodes, a_lens, a_num, a_roots, a_knib, a_klen, a_pn, a_pl, a_pi,
        max_value_len=128,
    )
    acct = decode_account(a_values, a_vlens)
    s_knib, s_klen = _slot_key_nibbles(slots)
    s_roots = jnp.take(acct["storage_root"], slot_accounts, axis=0)
    s_status, s_values, s_vlens = mpt.verify_proofs_pooled(
        s_nodes, s_lens, s_num, s_roots, s_knib, s_klen, s_pn, s_pl, s_pi,
        max_value_len=64,
    )
    # an invalid/absent account or undecodable leaf invalidates its slots
    account_ok = (a_status == mpt.FOUND) & acct["ok"]
    s_status = jnp.where(jnp.take(account_ok, slot_accounts), s_status,
                         mpt.INVALID)
    return a_status, acct, s_status, s_values, s_vlens


@dataclass
class StorageVerifyResult:
    account_status: np.ndarray   # i32 [B]
    storage_root: np.ndarray     # u8  [B, 32]
    nonce: np.ndarray            # u8  [B, 8] big-endian
    balance: np.ndarray          # u8  [B, 32] big-endian
    code_hash: np.ndarray        # u8  [B, 32]
    slot_status: np.ndarray      # i32 [B]
    slot_values: np.ndarray      # u8  [B, V]
    slot_value_lens: np.ndarray  # i32 [B]

    def slot_value(self, i: int) -> bytes:
        return bytes(self.slot_values[i][: self.slot_value_lens[i]])


@dataclass
class GroupedStorageVerifyResult:
    """N-slots-per-account verification outcome: account arrays are [A]
    (one row per UNIQUE account), slot arrays are [B], and
    `slot_accounts[j]` names the account row that owns slot j — the batch
    analog of the reference's one-account/many-slots StorageProofInput
    (crypto-ops/src/types.rs:12-19)."""

    account_status: np.ndarray   # i32 [A]
    storage_root: np.ndarray     # u8  [A, 32]
    nonce: np.ndarray            # u8  [A, 8] big-endian
    balance: np.ndarray          # u8  [A, 32] big-endian
    code_hash: np.ndarray        # u8  [A, 32]
    slot_accounts: np.ndarray    # i32 [B]
    slot_status: np.ndarray      # i32 [B]
    slot_values: np.ndarray      # u8  [B, V]
    slot_value_lens: np.ndarray  # i32 [B]

    def slot_value(self, i: int) -> bytes:
        return bytes(self.slot_values[i][: self.slot_value_lens[i]])


def verify_storage_grouped(
    account_packed: PackedProofs,
    storage_packed: PackedProofs,
    slots: np.ndarray,
    slot_accounts: np.ndarray,
) -> GroupedStorageVerifyResult:
    """N-slots-per-account two-level verification (input-shape parity with
    the reference's StorageProofInput, crypto-ops/src/types.rs:12-19).

    account_packed: A UNIQUE account proofs (key = keccak(address))
    storage_packed: B storage proofs (key_nibbles ignored — derived from
                    `slots` on device)
    slots:          u8 [B, 32] RAW slot keys (hashed in-kernel)
    slot_accounts:  i32 [B] index of each slot's owning account row

    Each account proof is verified once (vs the duplicated 1:1 form, which
    re-verifies it per slot); each slot's trusted root is gathered from its
    account's decoded storage_root. Hashing is pooled on both levels.
    """
    a = account_packed
    s = storage_packed
    slots = np.asarray(slots, dtype=np.uint8)
    if slots.shape != (s.batch, 32):
        raise ValueError(f"slots must be [B, 32], got {slots.shape}")
    sa = np.asarray(slot_accounts, dtype=np.int32)
    if sa.shape != (s.batch,):
        raise ValueError(f"slot_accounts must be [B], got {sa.shape}")
    if sa.size and ((sa < 0).any() or (sa >= a.batch).any()):
        raise ValueError(
            f"slot_accounts out of range [0, {a.batch})")
    a_status, acct, s_status, s_values, s_vlens = _storage_core_grouped(
        a.nodes, a.node_lens, a.num_nodes, a.roots, a.key_nibbles, a.key_lens,
        *a.pool(),
        s.nodes, s.node_lens, s.num_nodes, *s.pool(),
        jnp.asarray(slots), jnp.asarray(sa),
    )
    return GroupedStorageVerifyResult(
        account_status=np.asarray(a_status),
        storage_root=np.asarray(acct["storage_root"]),
        nonce=np.asarray(acct["nonce"]),
        balance=np.asarray(acct["balance"]),
        code_hash=np.asarray(acct["code_hash"]),
        slot_accounts=sa,
        slot_status=np.asarray(s_status),
        slot_values=np.asarray(s_values),
        slot_value_lens=np.asarray(s_vlens),
    )


def verify_storage_batch(
    account_packed: PackedProofs,
    storage_packed: PackedProofs,
    slots: np.ndarray,
    dedup: bool = True,
) -> StorageVerifyResult:
    """Two-level account->storage verification (1:1 account-row/slot-row).

    account_packed: B account proofs (key = keccak(address), pre-hashed)
    storage_packed: B storage proofs (key_nibbles field ignored — keys are
                    derived on device from `slots`)
    slots: u8 [B, 32] RAW storage slot keys (hashed in-kernel).

    dedup=True (default) routes through the grouped/pooled core with an
    identity slot->account map: both levels hash their unique-node pools
    once (account batches repeating one trie's prefix re-hashed every row
    before). dedup=False keeps the unpooled core (the parity reference).
    """
    a = account_packed
    s = storage_packed
    slots = np.asarray(slots, dtype=np.uint8)
    if slots.shape != (s.batch, 32):
        raise ValueError(f"slots must be [B, 32], got {slots.shape}")
    if dedup:
        a_status, acct, s_status, s_values, s_vlens = _storage_core_grouped(
            a.nodes, a.node_lens, a.num_nodes, a.roots, a.key_nibbles,
            a.key_lens, *a.pool(),
            s.nodes, s.node_lens, s.num_nodes, *s.pool(),
            jnp.asarray(slots),
            jnp.arange(s.batch, dtype=jnp.int32),
        )
    else:
        a_status, acct, s_status, s_values, s_vlens = _storage_core(
            a.nodes, a.node_lens, a.num_nodes, a.roots, a.key_nibbles,
            a.key_lens,
            s.nodes, s.node_lens, s.num_nodes, jnp.asarray(slots),
        )
    return StorageVerifyResult(
        account_status=np.asarray(a_status),
        storage_root=np.asarray(acct["storage_root"]),
        nonce=np.asarray(acct["nonce"]),
        balance=np.asarray(acct["balance"]),
        code_hash=np.asarray(acct["code_hash"]),
        slot_status=np.asarray(s_status),
        slot_values=np.asarray(s_values),
        slot_value_lens=np.asarray(s_vlens),
    )
