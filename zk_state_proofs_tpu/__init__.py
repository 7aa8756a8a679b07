"""zk_state_proofs_tpu — batched EVM state-proof verification on NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ChainSafe/zk-state-proofs (Keccak-256, RLP, hexary MPT proof verification for
accounts / storage slots / transactions / receipts, batched witness
generation): a batched Keccak-f[1600] sponge (a Pallas kernel on the GPU), a
vectorized fixed-shape MPT path walker, and mesh-sharded batch verification.

Layers (SURVEY.md §7.2):
  oracle/   L0 pure-Python bit-exact reference (keccak, RLP, MPT)
  ops/      L1-L3 device compute path (keccak, RLP decode, MPT walk;
            ops.backend picks the implementation for the platform)
  witness/  L4 host pipeline (packing, fixtures, RPC clients, encoders)
  parallel/ L5 mesh/sharding layer
  models/   top-level verifier workloads (the four trie flavors)
  utils/    config, errors, profiling
"""

__version__ = "0.1.0"
