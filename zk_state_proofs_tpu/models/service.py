"""Serving layer: a warm, bucket-pinned batch verifier.

The production counterpart of the reference's one-shot prover binary
(reference: prover/src/bin/main.rs — build input, run guest, exit): a
long-lived verifier that pins one padding bucket (stable jit shapes →
one compiled executable reused forever), optionally shards over a mesh,
and accumulates serving metrics. Used for request-driven verification
where witnesses arrive as raw (root, proof, key) entries.

Why bucket pinning matters: every distinct (max_nodes, node_len,
pool_rows, batch) shape is a separate XLA compilation, which takes
seconds to minutes. A service that packs every batch into one pinned
bucket compiles once at warmup and never again.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..ops import mpt
from ..utils.config import BucketConfig
from ..utils.profiling import Meter
from ..witness.pack import PackedProofs, PackingError, pack_proofs
from .verifier import VerifyResult


@dataclass
class ServiceStats:
    """Cumulative serving counters."""

    batches: int = 0
    proofs: int = 0
    found: int = 0
    excluded: int = 0
    invalid: int = 0
    seconds: float = 0.0
    meter: Meter = field(default_factory=Meter)

    @property
    def proofs_per_sec(self) -> float:
        return self.proofs / max(self.seconds, 1e-9)


class BatchVerifier:
    """Warm batched MPT verification service with a pinned bucket.

    bucket:    padding geometry every batch is packed into (request
               batches smaller than `batch_size` are padded with empty
               proofs, which verify INVALID and are sliced off).
    batch_size: the pinned batch dimension (jit shape).
    pool_rows: fixed unique-node-pool bucket for dedup hashing (0 =
               derive from the warmup batch with 25% headroom).
    dedup:     hash each batch's unique-node pool once (default).
    mesh:      optional 1-D device mesh — batches are dp-sharded with
               psum'ed stats (parallel.mesh.make_sharded_verifier).
    depth_segments: optional PINNED depth-bucketed walk schedule
               ((count, d), ...; see PackedProofs.depth_segments) for
               the dedup single-device path. Requests are depth-sorted
               at pack time (results restored to request order) and a
               host check routes each batch through the segmented
               executable only when every segment's proofs fit its d —
               incompatible batches use the unsegmented executable, so a
               schedule miss costs speed, never correctness.
    pool_segments: optional PINNED segmented-pool-hash schedule
               ((row_count, width), ...; see
               PackedProofs.pool_block_segments) for the dedup
               single-device path — one keccak call per contiguous
               block-count run of the (length-sorted) pool at its
               trimmed width. A host check routes each batch through
               it only when every pool row's length fits its segment
               width; misses fall back to the unsegmented pool hash
               (warmed too — a miss costs speed, never a serving-path
               compile).
    """

    def __init__(self, bucket: BucketConfig, batch_size: int = 4096,
                 dedup: bool = True, pool_rows: int = 0, mesh=None,
                 depth_segments: tuple | None = None,
                 pool_segments: tuple | None = None):
        self.bucket = bucket
        self.batch_size = int(batch_size)
        self.dedup = dedup
        self.pool_rows = int(pool_rows)
        self.mesh = mesh
        self.depth_segments = depth_segments
        self.pool_segments = pool_segments
        self.stats = ServiceStats()
        self._warm = False

    # -- packing ---------------------------------------------------------
    def pack(self, entries) -> PackedProofs:
        """Pack raw (root, proof, key) entries into the pinned bucket,
        padding the batch dimension to `batch_size`. Raises PackingError
        if any proof exceeds the bucket."""
        entries = list(entries)
        if len(entries) > self.batch_size:
            raise PackingError(
                f"batch of {len(entries)} exceeds pinned batch_size="
                f"{self.batch_size}")
        n_pad = self.batch_size - len(entries)
        if n_pad:
            # empty proof + non-empty root rows verify INVALID (root
            # unfindable) and are sliced off in verify()
            entries = entries + [(b"\x00" * 31 + b"\x01", [], b"\x00")] * n_pad
        packed = pack_proofs(
            entries, max_nodes=self.bucket.max_nodes,
            node_len=self.bucket.node_len,
            key_nibbles=self.bucket.key_nibbles,
        )
        if self.dedup:
            packed.pool(min_rows=self.pool_rows)
        return packed

    # -- lifecycle -------------------------------------------------------
    def warmup(self, example_entries=None) -> float:
        """Compile the pinned executable(s) once (synthetic single-leaf
        trie batch when no example is given); derives pool_rows if
        unset. Returns the compile+first-run seconds.

        With a pinned depth_segments schedule BOTH executables compile
        here — the segmented hot path AND the unsegmented fallback that
        serves schedule-miss batches (_compatible_segments -> None). A
        cold compile takes seconds to minutes; it must never happen
        inside the serving path."""
        if example_entries is None:
            from ..oracle import EthTrie, keccak256

            t = EthTrie()
            n = min(64, self.batch_size)
            keys = [keccak256(b"warmup-%d" % i) for i in range(n)]
            for i, k in enumerate(keys):
                t.insert(k, b"\x01" + bytes([i % 251]) * 40)
            root = t.root_hash()
            example_entries = [(root, t.get_proof(k), k) for k in keys]
        if self.dedup and not self.pool_rows:
            probe = self.pack(example_entries)
            rows = int(probe.pool()[0].shape[0])
            self.pool_rows = -(-int(rows * 1.25) // 128) * 128
        t0 = time.time()
        packed = self.pack(example_entries)
        if (self.pool_segments is not None and self.dedup
                and self.mesh is None):
            rows = int(packed.pool()[0].shape[0])
            want = sum(c for c, _ in self.pool_segments)
            if want != rows:
                raise ValueError(
                    f"pinned pool_segments cover {want} rows but the "
                    f"pinned pool bucket is {rows} — derive the schedule "
                    f"from a batch packed into THIS service's bucket "
                    f"(PackedProofs.pool_block_segments on svc.pack(...))")
        self._verify_packed(packed)
        if self.dedup and self.mesh is None:
            # compile every (depth_segments, pool_segments) combination a
            # request could route to: each pinned schedule has a miss
            # fallback, and a schedule miss must never compile in the
            # serving path
            seg_opts = ({None} if self.depth_segments is None
                        else {None, self.depth_segments})
            ps_opts = ({None} if self.pool_segments is None
                       else {None, self.pool_segments})
            done = {(self._compatible_segments(packed),
                     self._compatible_pool_segments(packed))}
            for so in seg_opts:
                for po in ps_opts:
                    if (so, po) not in done:
                        self._verify_packed(packed, force_segments=so,
                                            force_pool_segments=po)
                        done.add((so, po))
        self._warm = True
        return time.time() - t0

    # -- serving ---------------------------------------------------------
    _UNSET = object()

    def _verify_packed(self, packed: PackedProofs, force_segments=_UNSET,
                       force_pool_segments=_UNSET):
        mvl = self.bucket.max_value_len
        if self.mesh is not None:
            from ..parallel.mesh import make_sharded_verifier

            fn = make_sharded_verifier(self.mesh, max_value_len=mvl,
                                       pooled=self.dedup)
            active = np.ones(packed.batch, dtype=np.int32)
            pool = packed.pool() if self.dedup else ()
            out = fn(*(packed.astuple() + (active,) + pool))
            return out[0], out[1], out[2]
        if self.dedup:
            if force_segments is not BatchVerifier._UNSET:
                segs = force_segments  # warmup: compile a specific variant
            else:
                segs = self._compatible_segments(packed)
            if force_pool_segments is not BatchVerifier._UNSET:
                psegs = force_pool_segments
            else:
                psegs = self._compatible_pool_segments(packed)
            return mpt.verify_proofs_pooled(
                *packed.astuple(), *packed.pool(), max_value_len=mvl,
                depth_segments=segs, pool_segments=psegs)
        return mpt.verify_proofs(*packed.astuple(), max_value_len=mvl)

    def _compatible_segments(self, packed: PackedProofs):
        """The pinned segment schedule iff this (depth-sorted) batch fits
        it — every segment's max num_nodes <= its d; else None (the
        unsegmented executable)."""
        if self.depth_segments is None:
            return None
        if sum(c for c, _ in self.depth_segments) != packed.batch:
            return None
        off = 0
        for cnt, dseg in self.depth_segments:
            seg = packed.num_nodes[off:off + cnt]
            if len(seg) and int(seg.max()) > dseg:
                return None
            off += cnt
        return self.depth_segments

    def _compatible_pool_segments(self, packed: PackedProofs):
        """The pinned pool-hash schedule iff this batch's (length-sorted)
        pool fits it — counts sum to the pool rows and every row's length
        fits its segment width; else None (unsegmented pool hash)."""
        if self.pool_segments is None:
            return None
        lens = packed.pool()[1]
        if sum(c for c, _ in self.pool_segments) != len(lens):
            return None
        off = 0
        for cnt, w in self.pool_segments:
            seg = lens[off:off + cnt]
            if len(seg) and int(seg.max()) > w:
                return None
            off += cnt
        return self.pool_segments

    def verify(self, entries) -> VerifyResult:
        """Pack + verify one request batch; returns per-proof results
        (padding rows sliced off) and updates serving stats."""
        entries = list(entries)
        if not entries:
            raise ValueError("empty request batch")
        if not self._warm:
            self.warmup()
        t0 = time.time()
        n = len(entries)
        order = None
        if self.depth_segments is not None and self.dedup and self.mesh is None:
            # depth-sort for the pinned segment schedule; results are
            # restored to request order below (padding rows, appended by
            # pack(), carry zero nodes and land after every real entry)
            order = sorted(range(n), key=lambda i: -len(entries[i][1]))
            entries = [entries[i] for i in order]
        packed = self.pack(entries)
        status, values, vlens = self._verify_packed(packed)
        status, values, vlens = (np.asarray(status)[:n],
                                 np.asarray(values)[:n],
                                 np.asarray(vlens)[:n])
        if order is not None:
            inv = np.empty(n, dtype=np.int64)
            inv[np.asarray(order)] = np.arange(n)
            status, values, vlens = status[inv], values[inv], vlens[inv]
        res = VerifyResult(status, values, vlens)
        dt = time.time() - t0
        c = res.counts()
        s = self.stats
        s.batches += 1
        s.proofs += n
        s.found += c["found"]
        s.excluded += c["excluded"]
        s.invalid += c["invalid"]
        s.seconds += dt
        s.meter.record(n, 0, 0, dt)
        return res
