"""CPU rehearsal of chip_smoke.py's phase functions at tiny sizes (the
kernels in interpret mode), and its refusal to run without a GPU or
without the repository."""

import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY = ["grid:trueSize=32,32,32", "population:nParticles=4 pc",
        "population:nAlloc=4 pc", "tiles:backend=pallas"]


@pytest.fixture(scope="module")
def tiny_sim():
    return cs.bench_sim(TINY)


def test_smoke_refuses_cpu(capsys, monkeypatch, tmp_path):
    # set after JAX read it: enable_compilation_cache() then changes
    # nothing in this process (no cache writes from the test run)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(AssertionError, match="expected 'gpu'"):
        cs.phase_platform("gpu")
    with pytest.raises(AssertionError):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it exits nonzero and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smoke_kernel_phase(tiny_sim):
    times = cs.phase_kernels(tiny_sim, interpret=True, reps=1)
    assert set(times) == {"step", "deposit_ngp", "kick_boris_eext"}


def test_smoke_exchange_phase(tiny_sim):
    times = cs.phase_exchange(tiny_sim, reps=1)
    assert set(times) == {0, 1}


def test_smoke_main_phase():
    sim = cs.bench_sim(TINY)
    ms = cs.phase_main(sim, steps=8)
    assert ms > 0 and sim.state is not None


def test_smoke_layouts_phase():
    dke, dpe = cs.phase_layouts(grid_n=16, ppc=4, steps=3)
    assert dke < 1e-3


def test_smoke_cli_phase(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    energies = cs.phase_cli(steps=10)
    assert len(energies) == 1


def test_smoke_solvers_phase():
    cs.phase_solvers(grid_n=32, mg_n=32, reps=1)


def test_smoke_sharded_flat_phase(cpu_devices):
    cs.phase_sharded_flat(jax.devices()[:4], steps=2)


def test_smoke_sharded_tiled_phase(cpu_devices):
    cs.phase_sharded_tiled(jax.devices()[:4], local=16, ppc=2, steps=12)
