"""Sweep the minimizer slot-table size (h) on the GPU.

The slot table costs 8 bytes/slot as (start, exact_len) rows; h =
ceil(log2(slot_factor * n_occ)) puts a 16 Mbp index at h=26 -> 536 MB.
Smaller h raises the slot load factor (more multi-occupant slots ->
more slow-path windows) but shrinks the table the descriptor gathers
hit. This script measures the steady-state qps tradeoff so the
engine's h policy (provisional, ROADMAP Queue 1 #7) comes from a
measurement on the device at hand. Reads the cached index and midx
that scripts/build_cache.py writes.

Usage: python scripts/h_sweep.py [--genome 16000000] [--hs 22,23,24,25,26]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--genome", type=int, default=16_000_000)
    p.add_argument("--k", type=int, default=31)
    p.add_argument("--hs", default="22,23,24,25")
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--read-len", type=int, default=128)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--slow-frac", type=float, default=0.08,
                   help="initial slow-path capacity as a fraction of B*W "
                   "(generous start: every capacity growth recompiles)")
    p.add_argument("--engines", default="v2",
                   help="comma list of v1,v2 to measure at each h")
    p.add_argument("--cache-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_cache"))
    args = p.parse_args()

    from finito_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    from finito_tpu.index.minimizer import MinimizerIndex
    from finito_tpu.query.minimizer_engine import (
        DeviceMinimizerIndex,
        initial_capacities,
        grow_capacities,
        make_minimizer_locate,
        make_minimizer_locate_v2,
    )
    import jax.numpy as jnp

    tag = f"g{args.genome}_k{args.k}"
    midx_path = os.path.join(args.cache_dir, f"midx_{tag}.ftmidx")
    genome = np.load(os.path.join(args.cache_dir, f"genome_{tag}.npy"))
    t0 = time.perf_counter()
    mindex = MinimizerIndex.load(midx_path)
    print(f"[sweep] midx loaded in {time.perf_counter()-t0:.1f}s; "
          f"n_occ={mindex.occ_key.size} h={mindex.h}", file=sys.stderr)

    B, L, k = args.batch, args.read_len, args.k
    W = L - k + 1
    rng = np.random.default_rng(0)
    starts = rng.integers(0, args.genome - L, size=B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(0.005 * reads.size)
    mi = rng.integers(0, B, size=n_mut)
    mj = rng.integers(0, L, size=n_mut)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4

    results = []
    for h in sorted(int(x) for x in args.hs.split(",")):
        t0 = time.perf_counter()
        mindex.rebucket(h)
        print(f"[sweep] rebucket h={h} in {time.perf_counter()-t0:.1f}s",
              file=sys.stderr)
        t0 = time.perf_counter()
        dmi = DeviceMinimizerIndex(mindex)
        jax.block_until_ready(dmi.desc)
        init_s = time.perf_counter() - t0
        desc_mb = int(np.asarray(dmi.desc).nbytes) >> 20
        slot_mb = (int(np.asarray(dmi.slot_rows).nbytes) >> 20) if dmi.slot_rows is not None else 0
        for eng in args.engines.split(","):
            use_v2 = eng == "v2"
            K, KH = initial_capacities(B * W, use_v2)
            K = max(K, int(args.slow_frac * B * W))
            reads_dev = jax.device_put(jnp.asarray(reads))
            while True:
                f = (make_minimizer_locate_v2(dmi, K, KH) if use_v2
                     else make_minimizer_locate(dmi, K))
                out = f(reads_dev)
                n_slow = int(out[2]); n_heads = int(out[3]) if use_v2 else 0
                grown = grow_capacities(K, KH, n_slow, n_heads, B * W)
                if grown is None:
                    break
                K, KH = grown
            csum = jax.jit(lambda u, o, s: s + jnp.sum(u, dtype=jnp.int32) + jnp.sum(o, dtype=jnp.int32))
            dt = float("inf")
            for _ in range(args.trials):
                t0 = time.perf_counter()
                s = jnp.int32(0)
                for _ in range(args.reps):
                    out = f(reads_dev)
                    s = csum(out[0], out[1], s)
                int(np.asarray(s))
                dt = min(dt, time.perf_counter() - t0)
            qps = args.reps * B * W / dt
            row = {"h": h, "engine": eng, "qps": round(qps, 1),
                   "slow_frac": round(n_slow / (B * W), 4), "K": K, "KH": KH,
                   "desc_mb": desc_mb, "slot_rows_mb": slot_mb,
                   "device_init_s": round(init_s, 1)}
            print(f"[sweep] {row}", file=sys.stderr)
            results.append(row)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
