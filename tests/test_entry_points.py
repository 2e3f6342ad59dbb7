"""Repository entry points: the compile-cache location rule and the GPU
smoke script's refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = ("import jax; from triflow_jax.utils.compile_cache import "
         "enable_compile_cache; print(enable_compile_cache()); "
         "print(jax.config.jax_compilation_cache_dir)")


def _run(code_or_args, env_update, cwd=REPO):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update)
    env["PYTHONPATH"] = str(REPO)
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is used and no
    code sets another."""
    target = str(tmp_path / "cache")
    out = _run(PROBE, {"JAX_COMPILATION_CACHE_DIR": target,
                       "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [target, target]


def test_compile_cache_defaults_into_checkout():
    out = _run(PROBE, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    expected = str(REPO / ".jax_cache")
    assert out.stdout.split() == [expected, expected]


def test_chip_smoke_refuses_cpu():
    """On a machine without a GPU the smoke script exits non-zero and
    prints no result line."""
    out = _run([sys.executable, str(REPO / "chip_smoke.py")],
               {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_needs_the_package(tmp_path):
    """Alone in a directory, without the package, the script fails."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         env={**{k: v for k, v in os.environ.items()
                                 if k != "PYTHONPATH"}, **env},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
