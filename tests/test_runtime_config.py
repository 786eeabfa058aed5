"""Run-time configuration: where the compile cache lives, running without
PyYAML, the GPU smoke script's refusal to run elsewhere, and the absence of
code paths for other accelerators."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _python(code, cwd=REPO, timeout=300, **env):
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=cwd, env=full_env)


# ------------------------------------------------------------ compile cache


def test_compile_cache_defers_to_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, no path is chosen in code."""
    from gorder_tpu.analysis import compile_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache_dir("gpu") is None
    assert compile_cache_dir("cpu") is None


def test_compile_cache_inside_checkout(monkeypatch):
    from gorder_tpu.analysis import compile_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir("gpu") == str(REPO / ".jax_cache" / "gpu")
    cpu = pathlib.Path(compile_cache_dir("cpu"))
    assert cpu.parent == REPO / ".jax_cache"
    assert re.fullmatch(r"cpu-[0-9a-f]{10}|cpu-unknown", cpu.name)


def test_compile_cache_path_is_stable():
    """The path is part of the cache key: the same in every process, with
    no pid, time or temporary name in it."""
    code = ("import os; os.environ.pop('JAX_COMPILATION_CACHE_DIR', None)\n"
            "from gorder_tpu.analysis import compile_cache_dir\n"
            "print(compile_cache_dir('cpu')); print(compile_cache_dir('gpu'))")
    first = _python(code)
    second = _python(code)
    assert first.returncode == 0, first.stderr
    assert first.stdout == second.stdout
    assert str(os.getpid()) not in first.stdout


def test_configured_cache_is_used(monkeypatch):
    """The running process's JAX cache is the one the rule names."""
    import jax

    from gorder_tpu.analysis import compile_cache_dir

    want = compile_cache_dir(jax.default_backend()) \
        or os.environ["JAX_COMPILATION_CACHE_DIR"]
    assert jax.config.jax_compilation_cache_dir == want


# ------------------------------------------------------------------ PyYAML

_NO_YAML = "import sys\nsys.modules['yaml'] = None\n"


def test_import_without_pyyaml():
    out = _python(_NO_YAML + "import gorder_tpu\n"
                  "assert gorder_tpu.Analysis is not None\nprint('ok')")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_python_api_runs_without_pyyaml(tmp_path):
    code = _NO_YAML + f"""
sys.path.insert(0, {str(REPO)!r})
import pathlib
from tests import synthetic
import gorder_tpu as gorder
gro, bnd, xtc = synthetic.make_flat_bilayer(pathlib.Path({str(tmp_path)!r}))
results = gorder.Analysis(
    structure=gro, bonds=bnd, trajectory=xtc,
    analysis_type=gorder.AnalysisType.cgorder("resname POPC"),
    output_yaml={str(tmp_path / "order.yaml")!r}, silent=True).run()
results.write()
assert 'yaml' not in sys.modules or sys.modules['yaml'] is None
print(results.n_analyzed_frames)
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "10"
    assert (tmp_path / "order.yaml").read_text().count("total:") > 3


def test_yaml_input_without_pyyaml_names_the_package(tmp_path, monkeypatch):
    from gorder_tpu.errors import ConfigError
    from gorder_tpu.input import Analysis
    from gorder_tpu.input import config

    cfg = tmp_path / "analyze.yaml"
    cfg.write_text("structure: s.gro\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    config._config_loader.cache_clear()
    try:
        with pytest.raises(ConfigError, match="PyYAML"):
            Analysis.from_file(str(cfg))
    finally:
        config._config_loader.cache_clear()


# --------------------------------------------------------- chip smoke test


def test_chip_smoke_refuses_the_cpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_needs_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(env, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# -------------------------------------------- no other accelerator's paths


def test_no_code_for_another_accelerator():
    """No module imports the TPU Pallas backend or branches on a TPU
    backend, and no interpret-mode kernel fallback remains."""
    banned = re.compile(r"pallas\.tpu|pltpu|default_backend\(\)\s*==\s*"
                        r"[\"']tpu[\"']|GORDER_TPU_PALLAS|_pallas_fallback|"
                        r"_replay_artifact|interpret\s*=\s*jax\.default")
    sources = [p for p in REPO.rglob("*.py")
               if not any(part.startswith(".") for part in
                          p.relative_to(REPO).parts)
               and p.name != pathlib.Path(__file__).name]
    assert len(sources) > 50
    hits = [f"{p.relative_to(REPO)}:{n}"
            for p in sources
            for n, line in enumerate(p.read_text().splitlines(), 1)
            if banned.search(line)]
    assert hits == []
    assert not list(REPO.glob("BENCH_*.json"))
