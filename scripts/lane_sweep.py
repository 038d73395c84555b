"""Scan-engine lane-saturation sweep on the GPU.

Measures steady-state qps of the stream and replica engines over
batch size B x chunk policy, to set ops.streaming.AUTO_CHUNK_LANES
(provisional, ROADMAP Queue 1 #7) from a recorded measurement. Writes
one JSON artifact (default SWEEP_lanes.json at the repo root) with a
row per (engine, B, chunk).

Usage: python scripts/lane_sweep.py [--genome 400000]
       [--batches 8192,16384,32768] [--chunks 0,auto] [--reps 10]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--genome", type=int, default=400_000)
    p.add_argument("--k", type=int, default=31)
    p.add_argument("--read-len", type=int, default=128)
    p.add_argument("--batches", default="8192,16384,32768")
    p.add_argument("--chunks", default="0,auto")
    p.add_argument("--engines", default="stream,replica")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--mutate", type=float, default=0.005)
    p.add_argument("--out", default=os.path.join(ROOT, "SWEEP_lanes.json"))
    p.add_argument("--cache-dir", default=os.path.join(ROOT, ".bench_cache"))
    args = p.parse_args()

    from finito_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    import bench
    from finito_tpu.query.engine import DeviceQueryEngine

    rng = np.random.default_rng(0)
    genome, index, _, _ = bench.load_or_build_index(
        args.genome, args.k, args.cache_dir, rng
    )
    L = args.read_len
    W = L - args.k + 1
    rows = []
    for eng_mode in args.engines.split(","):
        for B in (int(x) for x in args.batches.split(",")):
            starts = rng.integers(0, args.genome - L, size=B)
            reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
            n_mut = int(args.mutate * reads.size)
            mi = rng.integers(0, B, size=n_mut)
            mj = rng.integers(0, L, size=n_mut)
            reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4
            for ch in args.chunks.split(","):
                chunk = None if ch == "auto" else int(ch)
                engine = DeviceQueryEngine(index, mode=eng_mode, chunk=chunk)
                pipe = engine.make_device_pipeline(B, L, unknown_frac=0.02)
                reads_dev = jax.device_put(jnp.asarray(reads))
                out = pipe(reads_dev)
                jax.block_until_ready(out)
                n_unknown = int(np.asarray(out[2]))
                if not (pipe.K // 2 <= n_unknown <= pipe.K):
                    frac = max(0.002, 1.3 * n_unknown / (B * W))
                    pipe = engine.make_device_pipeline(B, L, unknown_frac=frac)
                    out = pipe(reads_dev)
                    jax.block_until_ready(out)
                csum = jax.jit(lambda u, o, s: s + jnp.sum(u, dtype=jnp.int32)
                               + jnp.sum(o, dtype=jnp.int32))
                dt = float("inf")
                for _ in range(args.trials):
                    t0 = time.perf_counter()
                    s = jnp.int32(0)
                    for _ in range(args.reps):
                        out = pipe(reads_dev)
                        s = csum(out[0], out[1], s)
                    int(np.asarray(s))
                    dt = min(dt, time.perf_counter() - t0)
                qps = args.reps * B * W / dt
                row = {"engine": eng_mode, "B": B, "chunk": ch,
                       "qps": round(qps, 1), "total_lanes": B if chunk == 0
                       else None}
                rows.append(row)
                print(f"[sweep] {row}", file=sys.stderr)
    artifact = {
        "date": time.strftime("%Y-%m-%d"),
        "genome": args.genome, "k": args.k, "read_len": L,
        "reps": args.reps, "trials": args.trials, "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    sys.exit(main())
