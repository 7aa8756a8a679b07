"""The one place that reads the platform and picks implementations.

- ``"gpu"`` (an NVIDIA card through JAX's CUDA plugin) selects the GPU
  implementations: the Pallas Keccak sponge (ops.keccak_gpu).
- ``"cpu"`` selects the plain references (ops.keccak). It serves tests and
  runs only when the CPU was asked for, e.g. with ``JAX_PLATFORMS=cpu``.
- Any other platform raises.

The MPT walk (ops.mpt.walk_batch) is the same XLA program on both.
"""

from __future__ import annotations

import functools

import jax

SUPPORTED = ("gpu", "cpu")


@functools.cache
def platform() -> str:
    """The default JAX platform, read once per process."""
    p = jax.default_backend()
    if p not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: this program runs on an NVIDIA "
            f"GPU, or on the CPU when JAX_PLATFORMS=cpu asks for it")
    return p


def keccak_impl():
    """The batched Keccak-256 for this platform: (data u8 [..., L],
    lengths i32 [...] | None) -> u8 [..., 32]."""
    if platform() == "gpu":
        from .keccak_gpu import keccak256_gpu

        return keccak256_gpu
    from .keccak import keccak256

    return keccak256


def keccak256(data, lengths=None):
    """Batched Ethereum Keccak-256 on this platform's implementation."""
    return keccak_impl()(data, lengths)
