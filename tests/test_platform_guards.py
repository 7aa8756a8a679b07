"""Guards that keep a measurement or a default from hiding the device:
the benchmark and chip_smoke.py refuse to run off a GPU, and the resident
sweep's materialize default reads the device's memory limit."""

from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def repo_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))


def test_bench_refuses_cpu(repo_on_path):
    import bench

    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        bench.require_gpu()


def test_chip_smoke_refuses_cpu(repo_on_path):
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code != 0


class _Device:
    platform = "gpu"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_materialize_default_reads_device_limit():
    from zk_state_proofs_tpu.models.sweep import (MATERIALIZE_SHARE,
                                                  fits_device_memory)

    dev = _Device({"bytes_limit": 64 << 30, "bytes_in_use": 0})
    assert fits_device_memory(int(MATERIALIZE_SHARE * (64 << 30)), dev)
    assert not fits_device_memory(int(MATERIALIZE_SHARE * (64 << 30)) + 1,
                                  dev)


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_materialize_default_raises_without_limit(stats):
    from zk_state_proofs_tpu.models.sweep import fits_device_memory

    with pytest.raises(RuntimeError, match="no memory limit"):
        fits_device_memory(1, _Device(stats))


def test_materialize_default_raises_on_cpu():
    """The CPU backend reports no memory limit: callers there must say
    materialize= explicitly."""
    from zk_state_proofs_tpu.models.sweep import fits_device_memory

    with pytest.raises(RuntimeError, match="no memory limit"):
        fits_device_memory(1)
