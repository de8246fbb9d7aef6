"""The device-decision module (pinc_tpu/backend.py) and the compile-cache
location (utils/jaxconfig.py).  Platforms other than the CPU are faked by
monkeypatching jax.devices inside each test."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from pinc_tpu import backend
from pinc_tpu.config import PincConfig
from pinc_tpu.utils import jaxconfig

REPO = Path(__file__).resolve().parent.parent


class _FakeDevice:
    def __init__(self, platform, limit=None):
        self.platform = platform
        self._limit = limit

    def memory_stats(self):
        return None if self._limit is None else {"bytes_limit": self._limit}


def _fake(monkeypatch, platform, limit=None):
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice(platform, limit)])


def test_cpu_runs_kernels_in_interpret_mode():
    assert backend.platform() == "cpu"
    assert backend.interpret() is True
    assert backend.tiles_backend(3) == "xla"


def test_gpu_runs_compiled_triton_kernels(monkeypatch):
    _fake(monkeypatch, "gpu", limit=60 * 2 ** 30)
    assert backend.platform() == "gpu"
    assert backend.interpret() is False
    assert backend.tiles_backend(3) == "pallas"
    assert backend.tiles_backend(2) == "xla"      # the kernel is 3-D only
    assert backend.memory_bytes() == 60 * 2 ** 30


@pytest.mark.parametrize("platform", ["rocm", "metal", "interpreter"])
def test_other_platforms_raise(monkeypatch, platform):
    _fake(monkeypatch, platform)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()
    with pytest.raises(RuntimeError):
        backend.interpret()


def test_memory_bytes_on_cpu_is_host_memory():
    assert backend.memory_bytes() == (os.sysconf("SC_PAGE_SIZE")
                                      * os.sysconf("SC_PHYS_PAGES"))


def test_auto_tiled_threshold_follows_device_memory(monkeypatch):
    from pinc_tpu.parallel import pic
    _fake(monkeypatch, "gpu", limit=80 * 10 ** 9)
    assert pic.auto_tiled_slots() == int(0.75 * 80 * 10 ** 9) \
        // pic.FLAT_BYTES_PER_SLOT
    _fake(monkeypatch, "gpu", limit=16 * 10 ** 9)
    assert pic.auto_tiled_slots() < int(0.75 * 80 * 10 ** 9) \
        // pic.FLAT_BYTES_PER_SLOT


@pytest.mark.parametrize("value,error", [("mosaic", "pallas or xla"),
                                         ("pallas", "nDims=3")])
def test_tiled_backend_option_validated(value, error):
    from pinc_tpu.tiled_sim import TiledSimulation
    deck = """
[time]
nTimeSteps = 1
timeStep = 0.2
[grid]
nDims = 2
nSubdomains = 1,1
trueSize = 16,16
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 1
nParticles = 2 pc
nAlloc = 2 pc
charge = -1
mass = 1
multiplicity = auto
thermalVelocity = 0.05
[methods]
layout = tiled
poisson = sSolve
acc = puAccND1KE
distr = puDistrND1
[tiles]
tileSize = 4
backend = """ + value + "\n"
    with pytest.raises(ValueError, match=error):
        TiledSimulation(PincConfig.from_string(deck), seed=1)


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory, and nothing is set
    in code (JAX reads the variable itself)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert jaxconfig.compilation_cache_dir() == str(tmp_path / "c")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; from pinc_tpu.utils.jaxconfig import "
         "enable_compilation_cache as e; print(e()); "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path / "c")] * 2


def test_compile_cache_env_unset(monkeypatch):
    """Unset: a fixed directory inside the checkout, listed in
    .gitignore."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(jaxconfig.compilation_cache_dir())
    assert path == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
