"""JSON-RPC witness-fetch clients (Ethereum / Optimism / Arbitrum).

Host-side I/O is not device work: these are plain-Python equivalents of the
reference's alloy provider usage and its two hand-rolled reqwest clients
(reference: trie-utils/src/proofs/optimism/client.rs:5-63,
arbitrum/client.rs:6-93). Arbitrum mirrors the reference's limitation:
transaction proofs are not supported (reference arbitrum/types.rs:20-26).

Transport is injectable so tests (and the zero-egress CI) can run against
recorded fixtures; the default transport uses urllib.
"""

from __future__ import annotations

import json
import os
import urllib.request

# RPC endpoints (reference: trie-utils/src/constants.rs:1-5)
ETHEREUM_RPC_URL = "https://mainnet.infura.io/v3/"
OPTIMISM_RPC_URL = "https://mainnet.optimism.io/"
ARBITRUM_ONE_RPC_URL = "https://arb1.arbitrum.io/rpc"


def load_infura_key_from_env() -> str:
    """INFURA key from env (reference: trie-utils/src/lib.rs:5-8; the
    reference loads .env via dotenv — we read the environment directly)."""
    key = os.environ.get("INFURA")
    if not key:
        raise RuntimeError("INFURA environment variable not set")
    return key


class RpcError(RuntimeError):
    pass


def _urllib_transport(url: str, payload: dict, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class JsonRpcClient:
    """Minimal JSON-RPC 2.0 client with pluggable transport."""

    def __init__(self, url: str, transport=None):
        self.url = url
        self._transport = transport or _urllib_transport
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        payload = {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        resp = self._transport(self.url, payload)
        if "error" in resp and resp["error"]:
            raise RpcError(f"{method}: {resp['error']}")
        if "result" not in resp:
            raise RpcError(f"{method}: malformed response {resp!r}")
        return resp["result"]

    # -- shared eth namespace ---------------------------------------------
    def get_block_by_hash(self, block_hash: str, full_txs: bool = True) -> dict:
        return self.call("eth_getBlockByHash", [block_hash, full_txs])

    def get_block_by_number(self, tag: str = "latest", full_txs: bool = True) -> dict:
        return self.call("eth_getBlockByNumber", [tag, full_txs])

    def get_block_receipts(self, tag_or_hash: str) -> list:
        return self.call("eth_getBlockReceipts", [tag_or_hash])

    def get_proof(self, address: str, storage_keys: list, tag: str = "latest") -> dict:
        return self.call("eth_getProof", [address, storage_keys, tag])


class EthereumClient(JsonRpcClient):
    """Mainnet client (reference: alloy ProviderBuilder on Infura,
    account.rs:32-41). Pass `url` or set INFURA in the env."""

    def __init__(self, url: str | None = None, transport=None):
        super().__init__(url or ETHEREUM_RPC_URL + load_infura_key_from_env(), transport)


class OptimismClient(JsonRpcClient):
    """OP mainnet client (reference: OPClient, optimism/client.rs:5-63)."""

    def __init__(self, url: str = OPTIMISM_RPC_URL, transport=None):
        super().__init__(url, transport)


class ArbitrumClient(JsonRpcClient):
    """Arbitrum One client (reference: ArbitrumClient,
    arbitrum/client.rs:6-93). Transaction proofs are NOT supported, matching
    the reference (arbitrum/types.rs:20-26 omits tx bodies)."""

    def __init__(self, url: str = ARBITRUM_ONE_RPC_URL, transport=None):
        super().__init__(url, transport)

    def get_block_by_hash(self, block_hash: str, full_txs: bool = False) -> dict:
        if full_txs:
            raise NotImplementedError(
                "Arbitrum transaction proofs are not supported (reference parity)"
            )
        return super().get_block_by_hash(block_hash, False)
