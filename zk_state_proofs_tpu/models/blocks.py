"""Block-level verification flows: transaction and receipt tries.

The device counterpart of the reference's tx/receipt test flows
(reference: trie-utils/tests/transaction.rs:12-40, tests/receipt.rs:9-23):
rebuild the block trie from witness data, extract proofs, verify the batch
on device against the header root, and (for receipts) decode verified
receipts and extract ERC20 Transfer logs (BASELINE config #3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..oracle import rlp
from ..ops import mpt
from ..utils.config import BucketConfig
from ..witness.builders import (
    get_all_receipt_proof_inputs,
    get_all_transaction_proof_inputs,
    get_receipt_proof_input,
    get_transaction_proof_input,
)
from ..witness.fixtures import ERC20_TRANSFER_TOPIC
from ..witness.pack import pack_proofs
from .verifier import VerifyResult, verify_merkle_batch


def _bucket_for(entries, key_nibbles: int) -> BucketConfig:
    node_len = max(len(n) for _, p, _ in entries for n in p)
    depth = max(len(p) for _, p, _ in entries)
    vmax = node_len  # leaf value is bounded by its node
    return BucketConfig(
        max_nodes=depth, node_len=node_len, key_nibbles=key_nibbles,
        max_value_len=vmax,
    )


def verify_block_transactions(block: dict, indices=None) -> VerifyResult:
    """Verify transactions of a block against its transactionsRoot on
    device. Returns the batch result; values are the canonical EIP-2718
    encoded transactions."""
    txs = block["transactions"]
    if indices is None:
        indices = range(len(txs))
    indices = list(indices)
    all_inputs = get_all_transaction_proof_inputs(block)  # one trie build
    entries = [all_inputs[i].as_entry() for i in indices]
    bucket = _bucket_for(entries, key_nibbles=8)
    packed = pack_proofs(
        entries, max_nodes=bucket.max_nodes, node_len=bucket.node_len,
        key_nibbles=bucket.key_nibbles,
    )
    return verify_merkle_batch(packed, max_value_len=bucket.max_value_len)


@dataclass
class Erc20Transfer:
    token: bytes     # contract address (20 bytes)
    sender: bytes    # 20 bytes
    receiver: bytes  # 20 bytes
    amount: int
    tx_index: int


def decode_receipt_value(value: bytes) -> dict:
    """Decode a verified receipt leaf (optional type byte ++ RLP
    [status, cumulative_gas, bloom, logs])."""
    type_byte = 0
    if value and value[0] < 0xC0:  # typed envelope prefix
        type_byte = value[0]
        value = value[1:]
    status, gas, bloom, logs = rlp.decode(value)
    return {
        "type": type_byte,
        "status": rlp.decode_int(status),
        "cumulative_gas_used": rlp.decode_int(gas),
        "bloom": bloom,
        "logs": [
            {"address": l[0], "topics": l[1], "data": l[2]} for l in logs
        ],
    }


def _rows_containing(values, value_lens, needle: bytes) -> np.ndarray:
    """Vectorized sliding-window scan: bool [B] — does row i contain
    `needle` within its first value_lens[i] bytes? A PREFILTER (substring
    presence is a superset of a topics[0] match): rows without the bytes
    anywhere cannot carry the event and skip host RLP decoding entirely."""
    v = np.asarray(values)
    b, l = v.shape
    n = len(needle)
    if l < n:
        return np.zeros(b, bool)
    t = np.frombuffer(needle, np.uint8)
    match = v[:, : l - n + 1] == t[0]
    for j in range(1, n):
        match &= v[:, j: l - n + 1 + j] == t[j]
    # window must sit fully inside the real value bytes
    match &= (np.arange(l - n + 1)[None, :] + n
              <= np.asarray(value_lens)[:, None])
    return match.any(axis=1)


def _parse_transfers_vectorized(v, lens, rows, topic: bytes):
    """EXACT breadth-first receipt-log parse over `rows`, vectorized in
    numpy: every step advances ONE log across ALL rows simultaneously
    (the host twin of the device walker's batched-step formulation), so
    a 100%-Transfer block costs max-logs-per-receipt numpy passes, not a
    per-receipt Python RLP decode. This is a real parser — headers are
    decoded, spans checked — not a byte-pattern heuristic: bytes inside
    log data cannot fake a transfer, and any structurally malformed row
    is returned for the caller's exact host fallback instead of being
    guessed at.

    Returns (records, bad_rows): records = list of (row, log_index,
    addr_pos, t1_pos, t2_pos, data_pos, data_len), positions into v."""
    b_all = len(rows)
    if b_all == 0:
        return [], np.zeros(0, bool)
    r = np.asarray(rows)
    L = np.asarray(lens)[r].astype(np.int64)
    bad = np.zeros(b_all, bool)
    live = np.ones(b_all, bool)

    def byte_at(pos):
        # clipped gather; callers bound-check via `bad`
        return v[r, np.clip(pos, 0, v.shape[1] - 1)].astype(np.int64)

    def skip_string(pos):
        """Generic RLP string item at pos -> (payload_pos, payload_len,
        next_pos); flags list headers / truncation as bad."""
        b0 = byte_at(pos)
        single = b0 < 0x80
        short = (b0 >= 0x80) & (b0 <= 0xB7)
        long1 = b0 == 0xB8
        long2 = b0 == 0xB9
        nonlocal bad
        bad |= live & ~(single | short | long1 | long2)
        plen = np.where(single, 1,
               np.where(short, b0 - 0x80,
               np.where(long1, byte_at(pos + 1),
                        (byte_at(pos + 1) << 8) | byte_at(pos + 2))))
        poff = np.where(single, 0, np.where(short, 1, np.where(long1, 2, 3)))
        ppos = pos + poff
        return ppos, plen, ppos + plen

    def list_header(pos):
        """Generic RLP list header -> (payload_pos, payload_len)."""
        b0 = byte_at(pos)
        short = (b0 >= 0xC0) & (b0 <= 0xF7)
        long1 = b0 == 0xF8
        long2 = b0 == 0xF9
        nonlocal bad
        bad |= live & ~(short | long1 | long2)
        plen = np.where(short, b0 - 0xC0,
               np.where(long1, byte_at(pos + 1),
                        (byte_at(pos + 1) << 8) | byte_at(pos + 2)))
        poff = np.where(short, 1, np.where(long1, 2, 3))
        return pos + poff, plen

    # skeleton: [type?] rlp([status, cumulative_gas, bloom(256), logs])
    start = np.where(byte_at(np.zeros(b_all, np.int64)) < 0xC0, 1, 0)
    begin, outer_len = list_header(start)
    bad |= live & (begin + outer_len != L)
    _, _, p = skip_string(begin)          # status
    _, _, p = skip_string(p)              # cumulative_gas
    bp, blen, p = skip_string(p)          # bloom
    bad |= live & (blen != 256)
    logs_begin, logs_len = list_header(p)
    logs_end = logs_begin + logs_len
    bad |= live & (logs_end != begin + outer_len)

    t = np.frombuffer(topic, np.uint8).astype(np.int64)
    j32 = np.arange(32)
    records = []
    pos = logs_begin
    live = ~bad
    log_i = 0
    # max logs per receipt bounded by payload: every log is >= 3 bytes
    max_logs = int(min(logs_len[~bad].max() if (~bad).any() else 0, 4096))
    while live.any() and log_i * 3 <= max_logs:
        live &= pos < logs_end
        if not live.any():
            break
        # log = [address(20), topics(list of N x 32), data]
        lb, llen = list_header(pos)
        log_end = lb + llen
        a0 = byte_at(lb)
        bad |= live & (a0 != 0x94)        # address must be 20-byte string
        addr_pos = lb + 1
        tp, tlen = list_header(addr_pos + 20)
        ok_topics = (tlen % 33) == 0
        ntopics = np.where(ok_topics, tlen // 33, 0)
        bad |= live & ~ok_topics
        # every topic item must be 0xa0 ++ 32 bytes
        for k in range(4):
            has = live & (ntopics > k)
            bad |= has & (byte_at(tp + 33 * k) != 0xA0)
        dp, dlen, dnext = skip_string(tp + tlen)
        bad |= live & (dnext != log_end)  # exactly 3 items
        bad |= live & (log_end > logs_end)
        good = live & ~bad
        # Transfer: exactly 3 topics, topics[0] == the Transfer topic0
        cand = good & (ntopics == 3)
        if cand.any():
            ci = np.nonzero(cand)[0]
            t0 = v[r[ci][:, None], tp[ci][:, None] + 1 + j32[None, :]]
            hit = (t0.astype(np.int64) == t[None, :]).all(axis=1)
            for i, h in zip(ci, hit):
                if h:
                    records.append((int(i), log_i, int(addr_pos[i]),
                                    int(tp[i] + 34), int(tp[i] + 67),
                                    int(dp[i]), int(dlen[i])))
        pos = np.where(live, log_end, pos)
        live &= ~bad
        log_i += 1
    return records, bad


def extract_erc20_transfers(values, value_lens, status, indices=None,
                            engine: str = "host") -> list:
    """Pull ERC20 Transfer events out of verified receipt values.

    Stage 1 is always the vectorized 32-byte topic scan: candidate rows
    (substring presence is a superset of a topics[0] match) — blocks
    where most receipts carry no Transfer pay one numpy pass and stop.
    Stage 2 decodes the candidates, with two exact, parity-tested
    engines:

      engine="host" (default): per-candidate Python RLP decode.
        At a 100%-candidate 4096-row sweep with 1-3 Transfer logs each
        the two engines measure WITHIN HOST VARIANCE of each other
        (bench_configs config 3 reports both every run: 67k-vs-50k and
        50k-vs-56k receipts/s in back-to-back r5 runs) — numpy per-op
        dispatch roughly cancels the Python-loop cost at these log
        counts; host stays the default for simplicity.
      engine="vectorized": the breadth-first structural parser above
        (one numpy pass per log position across all rows; malformed rows
        fall back to the host decode). Kept for its scaling shape (cost
        tracks max logs/receipt, not total receipts) and as the
        structural cross-check the anti-spoofing test runs against.

    Results are identical on every input (both reject byte patterns
    embedded in log data — the host engine parses real structure too)."""
    topic = bytes.fromhex(ERC20_TRANSFER_TOPIC[2:])
    out = []
    values = np.asarray(values)
    value_lens = np.asarray(value_lens)
    status = np.asarray(status)
    idx_list = list(indices) if indices is not None else list(range(len(value_lens)))
    candidates = _rows_containing(values, value_lens, topic)
    rows = [row for row in range(len(idx_list))
            if status[row] == mpt.FOUND and candidates[row]]
    if engine == "host":
        for row in rows:
            tx_index = idx_list[row]
            receipt = decode_receipt_value(
                bytes(values[row][: value_lens[row]]))
            for log in receipt["logs"]:
                if (log["topics"] and log["topics"][0] == topic
                        and len(log["topics"]) == 3):
                    out.append(Erc20Transfer(
                        token=log["address"],
                        sender=log["topics"][1][-20:],
                        receiver=log["topics"][2][-20:],
                        amount=int.from_bytes(log["data"][:32], "big"),
                        tx_index=tx_index,
                    ))
        return out
    records, bad = _parse_transfers_vectorized(values, value_lens, rows,
                                               topic)
    # field extraction stays vectorized too: one fancy gather per field
    # over all records (per-record numpy slicing costs ~10 us/record in
    # Python — it dominated the sweep-scale wall time before this)
    good_recs = [r for r in records if not bad[r[0]]]
    if good_recs:
        good_recs.sort(key=lambda rec: (rec[0], rec[1]))
        ra = np.asarray(good_recs, dtype=np.int64)
        rrows = np.asarray(rows)[ra[:, 0]]
        j20 = np.arange(20)
        tok = values[rrows[:, None], ra[:, 2][:, None] + j20[None, :]]
        snd = values[rrows[:, None], ra[:, 3][:, None] + 12 + j20[None, :]]
        rcv = values[rrows[:, None], ra[:, 4][:, None] + 12 + j20[None, :]]
        j32 = np.arange(32)
        # clip: short data items near the row end may push unmasked
        # window columns past the buffer (the masked columns don't count)
        acol = np.minimum(ra[:, 5][:, None] + j32[None, :],
                          values.shape[1] - 1)
        amt = values[rrows[:, None], acol]
        amt = np.where(j32[None, :] < np.minimum(ra[:, 6], 32)[:, None],
                       amt, 0)
        # big-endian int per record, width = min(dlen, 32)
        tokb, sndb, rcvb = tok.tobytes(), snd.tobytes(), rcv.tobytes()
        amtb = amt.astype(np.uint8).tobytes()
        by_row = {}
        for k in range(len(good_recs)):
            w = min(int(ra[k, 6]), 32)
            by_row.setdefault(int(ra[k, 0]), []).append(Erc20Transfer(
                token=tokb[20 * k:20 * k + 20],
                sender=sndb[20 * k:20 * k + 20],
                receiver=rcvb[20 * k:20 * k + 20],
                amount=int.from_bytes(amtb[32 * k:32 * k + w], "big"),
                tx_index=idx_list[rows[int(ra[k, 0])]],
            ))
    else:
        by_row = {}
    for i, row in enumerate(rows):
        tx_index = idx_list[row]
        if bad[i]:
            # exact host fallback for malformed/non-canonical structure
            receipt = decode_receipt_value(
                bytes(values[row][: value_lens[row]]))
            for log in receipt["logs"]:
                if (log["topics"] and log["topics"][0] == topic
                        and len(log["topics"]) == 3):
                    out.append(Erc20Transfer(
                        token=log["address"],
                        sender=log["topics"][1][-20:],
                        receiver=log["topics"][2][-20:],
                        amount=int.from_bytes(log["data"][:32], "big"),
                        tx_index=tx_index,
                    ))
            continue
        out.extend(by_row.get(i, ()))
    return out


def verify_block_receipts(block: dict, receipts: list, indices=None):
    """Verify a block's receipts on device against receiptsRoot; returns
    (VerifyResult, [Erc20Transfer])."""
    if indices is None:
        indices = range(len(receipts))
    indices = list(indices)
    all_inputs = get_all_receipt_proof_inputs(block, receipts)  # one build
    entries = [all_inputs[i].as_entry() for i in indices]
    bucket = _bucket_for(entries, key_nibbles=8)
    packed = pack_proofs(
        entries, max_nodes=bucket.max_nodes, node_len=bucket.node_len,
        key_nibbles=bucket.key_nibbles,
    )
    res = verify_merkle_batch(packed, max_value_len=bucket.max_value_len)
    transfers = extract_erc20_transfers(res.values, res.value_lens, res.status, indices)
    return res, transfers
