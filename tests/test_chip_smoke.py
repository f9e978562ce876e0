"""chip_smoke.py's phases and guards, called in this process on the CPU.

The phases run at tiny sizes in f64 through their size arguments; the
script's entry point itself has no CPU path.
"""

import json

import jax
import numpy as np
import pytest

import chip_smoke
import gpflow_slim_tpu as gfs
from gpflow_slim_tpu.utils import misc


def _lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


def test_entry_point_refuses_a_cpu_backend(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert gfs.utils.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = gfs.utils.enable_compile_cache()
    assert path == str(misc._REPO_ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert (misc._REPO_ROOT / "chip_smoke.py").exists()


def _passed(line, phase):
    assert line["phase"] == phase and "failed" not in line
    assert line["dtype"] == "float64" and line["checks"]


def test_gpr_phase_tiny_f64(capsys):
    chip_smoke.gpr_phase(n=96, n_test=16, steps=3, dtype=np.float64)
    (line,) = _lines(capsys)
    _passed(line, "gpr")
    assert "d8/grad.kern.lengthscales.unconstrained" in line["checks"]


def test_sgpr_phase_tiny_f64(capsys):
    chip_smoke.sgpr_phase(n=128, m=12, dtype=np.float64)
    _passed(*_lines(capsys), "sgpr")


def test_svgp_phase_tiny_f64(capsys):
    chip_smoke.svgp_phase(n=600, m=12, batch=64, steps=5, dtype=np.float64)
    (line,) = _lines(capsys)
    _passed(line, "svgp")
    assert line["checks"]["elbo_improves"]["ok"]


def test_nuts_phase_tiny_f64(capsys):
    chip_smoke.nuts_phase(n=24, chains=2, warmup=8, samples=8,
                          dtype=np.float64)
    (line,) = _lines(capsys)
    _passed(line, "nuts")
    assert line["checks"]["draws_finite"]["shape"] == [2, 8, 3]


def test_checkpoint_template_mismatch_is_a_clear_error(tmp_path):
    X, Y = np.zeros((5, 1)), np.zeros((5, 1))
    m = gfs.models.GPR(X, Y, kern=gfs.kernels.RBF(1))
    p = gfs.utils.save_checkpoint(str(tmp_path / "m"), m)
    with pytest.raises(ValueError, match="leaves"):
        gfs.utils.load_checkpoint(p, m.kern)
    m2 = gfs.models.GPR(np.zeros((6, 1)), np.zeros((6, 1)),
                        kern=gfs.kernels.RBF(1))
    with pytest.raises(ValueError, match="shape"):
        gfs.utils.load_checkpoint(p, m2)


@pytest.mark.gpu
def test_gpr_phase_on_gpu_f32(gpu, capsys):
    chip_smoke.gpr_phase(n=2048, n_test=256, steps=5, dtype=np.float32)
    (line,) = _lines(capsys)
    assert line["phase"] == "gpr" and "failed" not in line
