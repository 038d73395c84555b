"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, the compile-cache helper, the native library's key, and
bench.py's device check.

The phases are the GPU smoke run's own code, called here with small
genomes and short reads (the replica engine's XLA:CPU compile grows
steeply with k, so the shared index uses k=15)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


@pytest.fixture(scope="module")
def main_phase(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("smoke"))
    out = chip_smoke.phase_main(wd, 0, "cpu", genome_len=30_000, n_reads=300,
                                n_oracle=40, k=15, read_len=64)
    return wd, out


def test_phase_main_matches_oracles(main_phase):
    wd, out = main_phase
    u, _p = chip_smoke.parse_pairs(out["out"], 300, 64 - 15 + 1)
    assert (u >= 0).mean() > 0.5  # the reads come from the genome
    with open(out["out"], "rb") as f1, open(os.path.join(wd, "minimizer_again.txt"), "rb") as f2:
        assert f1.read() == f2.read()


def test_phase_engines(main_phase):
    wd, out = main_phase
    chip_smoke.phase_engines(wd, out, "cpu", n_reads=64)


def test_phase_kmer_mapper(main_phase):
    wd, out = main_phase
    chip_smoke.phase_kmer_mapper(wd, out, "cpu", n_reads=64)


def test_phase_k63(tmp_path):
    chip_smoke.phase_k63(str(tmp_path), 0, "cpu", genome_len=20_000,
                         n_reads=100, n_oracle=20)


def test_require_equal_catches_one_changed_pair(main_phase):
    """The byte comparisons are not vacuous: one altered pair fails them."""
    wd, out = main_phase
    bad = os.path.join(wd, "altered.txt")
    with open(out["out"], "rb") as f:
        lines = f.read().split(b"\n")
    first = lines[0].split(b" ")
    first[3] = b"(-1,-1)" if first[3] != b"(-1,-1)" else b"(0,0)"
    lines[0] = b" ".join(first)
    with open(bad, "wb") as f:
        f.write(b"\n".join(lines))
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.require_equal(open(bad, "rb").read(), open(out["out"], "rb").read(), "x")


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU" in captured.err


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_four_gpus_rehearsal_on_four_cpu_devices(tmp_path):
    """The --four-gpus phase on 4 virtual CPU devices, dry run included."""
    code = (
        "import sys, chip_smoke;"
        f"chip_smoke.phase_mesh({str(tmp_path)!r}, 0, 'cpu', genome_len=30_000,"
        " n_reads=300, unitig_genome_len=20_000, coverage=3)"
    )
    env = _cpu_env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "--mesh 2,2 and 1,4 byte-equal to --mesh 1,1" in r.stdout
    assert "unitigs --mesh 4" in r.stdout
    assert "dryrun_multichip(4) ok" in r.stdout


# ------------------------------------------------------- compile cache


def test_compile_cache_leaves_env_dir_alone(monkeypatch, tmp_path):
    import jax

    from finito_tpu.utils import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    import jax

    from finito_tpu.utils import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = enable_compile_cache()
        assert first == enable_compile_cache() == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ------------------------------------------------------- native library


def test_native_key_covers_sources_and_cpu(tmp_path):
    from finito_tpu import native

    key = native.library_key()
    assert key == native.library_key()
    assert native.library_key(cpu="another cpu") != key
    srcs = []
    for s in native._SRCS:
        dst = tmp_path / os.path.basename(s)
        shutil.copy(s, dst)
        srcs.append(str(dst))
    assert native.library_key(srcs) == key
    with open(srcs[0], "a") as f:
        f.write("// changed\n")
    assert native.library_key(srcs) != key
    if native.get_lib() is not None:
        assert native.loaded_path() == native.library_path(key)


def test_native_loader_ignores_foreign_library(monkeypatch, tmp_path):
    """A library under another key (built on another host or from other
    sources) or under the old unkeyed name is never loaded: the loader
    builds its own keyed file instead."""
    from finito_tpu import native

    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_path", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("FINITO_NO_NATIVE", raising=False)
    foreign = native.library_path(native.library_key(cpu="another cpu"))
    for path in (foreign, str(tmp_path / "libfinito_native.so")):
        with open(path, "wb") as f:
            f.write(b"not a library")
    built = []
    monkeypatch.setattr(native, "_compile", lambda out: built.append(out) or False)
    assert native.get_lib() is None
    assert built == [native.library_path(native.library_key())]
    assert native.loaded_path() is None


# ------------------------------------------------------- bench device check


def test_bench_refuses_non_gpu_without_explicit_cpu():
    env = _cpu_env()
    env.pop("JAX_PLATFORMS")
    r = subprocess.run(
        [sys.executable, "bench.py", "--ladder", "off", "--extra-rows", "off",
         "--genome", "20000"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]


def test_bench_cpu_run_names_its_device(tmp_path):
    r = subprocess.run(
        [sys.executable, "bench.py", "--ladder", "off", "--extra-rows", "off",
         "--genome", "20000", "--batch", "64", "--reps", "2", "--trials", "1",
         "--verify", "2", "--cache-dir", str(tmp_path)],
        cwd=ROOT, env=_cpu_env(), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] >= 1
    assert "vs_baseline" not in out and out["ladder"][0]["qps"] > 0
