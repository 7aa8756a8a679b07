"""The backend choice point (ops.backend) and the compile-cache helper."""

import jax
import numpy as np
import pytest

from zk_state_proofs_tpu.ops import backend


@pytest.fixture
def platform_is(monkeypatch):
    """Pretend JAX's default platform is `name` for one test."""

    def set_platform(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
        backend.platform.cache_clear()

    yield set_platform
    backend.platform.cache_clear()


def test_gpu_selects_the_gpu_sponge(platform_is):
    from zk_state_proofs_tpu.ops.keccak_gpu import keccak256_gpu

    platform_is("gpu")
    assert backend.platform() == "gpu"
    assert backend.keccak_impl() is keccak256_gpu


def test_cpu_selects_the_reference_sponge(platform_is):
    from zk_state_proofs_tpu.ops.keccak import keccak256

    platform_is("cpu")
    assert backend.platform() == "cpu"
    assert backend.keccak_impl() is keccak256


@pytest.mark.parametrize("name", ["tpu", "rocm", "METAL"])
def test_other_platforms_raise(platform_is, name):
    platform_is(name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()


def test_platform_is_read_once(platform_is, monkeypatch):
    platform_is("cpu")
    assert backend.platform() == "cpu"
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert backend.platform() == "cpu"  # cached: no second read


def test_hash_nodes_routes_through_choice_point(monkeypatch):
    """mpt.hash_nodes hashes through backend.keccak256: with the GPU
    sponge (interpreted) swapped in, digests are unchanged."""
    from zk_state_proofs_tpu.ops import mpt
    from zk_state_proofs_tpu.ops.keccak_gpu import keccak256_gpu

    rng = np.random.default_rng(0)
    nodes = rng.integers(0, 256, (4, 3, 300), dtype=np.uint8)
    lens = np.asarray([[300, 136, 0], [1, 135, 299], [0, 0, 0],
                       [272, 271, 2]], np.int32)
    want = np.asarray(mpt.hash_nodes(nodes, lens))
    calls = []

    def kernel(data, lengths=None):
        calls.append(data.shape)
        return keccak256_gpu(data, lengths, block=8, interpret=True)

    monkeypatch.setattr(backend, "keccak_impl", lambda: kernel)
    got = np.asarray(mpt.hash_nodes(nodes, lens))
    assert calls == [(12, 300)]
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    from zk_state_proofs_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    from zk_state_proofs_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(compile_cache.CHECKOUT / ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert (compile_cache.CHECKOUT / "zk_state_proofs_tpu").is_dir()
