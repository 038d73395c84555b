"""CI-scale twins of the two big mesh verification scripts: the 1 Gbp
k=63 shard-local build (scripts/genome_scale_verify)
and the pangenome pipeline (scripts/pangenome_verify) run here at
reduced size as subprocesses on the virtual CPU mesh, so the genome-
scale claims carry pytest regression coverage instead of script-run
provenance. Full-size runs stay script-driven (README genome-scale
rows)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, args: list[str]) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", script), *args],
        capture_output=True, timeout=1200, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    return json.loads(out.stdout.decode().strip().splitlines()[-1])


def test_genome_scale_shard_local_build_small():
    res = _run("genome_scale_verify.py", [
        "--genome", "2000000", "--k", "63", "--tp", "8",
        "--reads", "48", "--read-len", "191",
    ])
    assert res["ok"] is True
    assert res["verified_windows"] > 0


def test_pangenome_pipeline_small():
    res = _run("pangenome_verify.py", [
        "--base", "200000", "--variants", "5", "--k", "31",
        "--reads", "48", "--tp", "8",
    ])
    assert res["ok"] is True
    assert res["verified_windows"] > 0
