"""Microbenchmarks of the primitives under every engine (SURVEY.md
section 7): batched gather rates (scalar and row), SBWT interval
extension, chain-scan step time, and the minimizer engine's gather-free
front end (`minimizer_scan` + `pack_query_windows`) with its share of a
full `make_minimizer_locate` batch.

Prints one JSON line per metric, each naming the device it ran on.
Times are medians over repeated calls that end in block_until_ready.
Usage: python bench_micro.py
"""

from __future__ import annotations

import json
import time

import numpy as np

ECOLI_BP = 4_641_652


def main() -> int:
    from bench import device_info
    from finito_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    device = device_info()
    rng = np.random.default_rng(0)
    results = []

    def timed(f, args_list, reps=20):
        """Median seconds per call, compile excluded."""
        jax.block_until_ready(f(*args_list[0]))
        ts = []
        for i in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*args_list[i % len(args_list)]))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    n = 1 << 22
    B = 1 << 21
    tab = jnp.asarray(rng.integers(0, 2**31, size=n, dtype=np.int32))
    tab4 = jnp.asarray(rng.integers(0, 2**31, size=(n, 4), dtype=np.int32))
    idxs = [jnp.asarray(rng.integers(0, n, size=B, dtype=np.int32)) for _ in range(5)]

    g1 = jax.jit(lambda t, i: jnp.take(t, i))
    dt = timed(lambda i: g1(tab, i), [(i,) for i in idxs])
    results.append(("gather_scalar", B / dt / 1e6, "Mlookups/s"))

    g4 = jax.jit(lambda t, i: jnp.sum(jnp.take(t, i, axis=0), axis=1))
    dt = timed(lambda i: g4(tab4, i), [(i,) for i in idxs])
    results.append(("gather_row4", B / dt / 1e6, "Mlookups/s"))

    # SBWT rank / extension on a synthetic 4M-node index
    from finito_tpu.ops.rank24 import build_rank24_tables, update_interval24

    bits = (rng.random((4, 1 << 22)) < 0.25).astype(np.uint8)
    rtab = jnp.asarray(build_rank24_tables(bits))
    n8 = rtab.shape[0] // 4
    C = jnp.asarray(np.cumsum([1, *bits.sum(axis=1)[:3]]), dtype=jnp.int32)
    nn = bits.shape[1]
    los = [jnp.asarray(rng.integers(0, nn - 1, size=B, dtype=np.int32)) for _ in range(5)]
    cs = jnp.asarray(rng.integers(0, 4, size=B, dtype=np.int32))

    upd = jax.jit(lambda lo: update_interval24(rtab, n8, C, cs, lo, lo)[0])
    dt = timed(lambda lo: upd(lo), [(lo,) for lo in los])
    results.append(("sbwt_interval_extension", B / dt / 1e6, "Mext/s"))

    # chain-scan step time at several lane counts: the floor under the
    # stream/replica engines' phase A (lanes scale ~1/chunk, steps ~chunk)
    from finito_tpu.ops.streaming import make_chain_scan

    ck_tab = jnp.asarray(
        np.stack([np.zeros(nn, np.int32), np.full(nn, nn - 1, np.int32)], axis=1)
    )
    # synthetic dense edge table (every transition present): the same
    # gather pattern as a real mature chain
    edge_tab = jnp.asarray(rng.integers(0, nn, size=4 * nn, dtype=np.int32))
    S = 64
    chain = make_chain_scan(n8, 31, nn)
    cf = jax.jit(lambda codes: chain(rtab, C, ck_tab, edge_tab, codes))
    for lanes_pow in (13, 15, 17):
        lanes = 1 << lanes_pow
        codes_l = [
            jnp.asarray(rng.integers(0, 4, size=(lanes, S), dtype=np.uint8))
            for _ in range(3)
        ]
        dt = timed(lambda c: cf(c), [(c,) for c in codes_l], reps=5)
        results.append((f"chain_scan_us_per_step_{lanes >> 10}k_lanes", dt / S * 1e6, "us/step"))

    results += front_end_share(rng, timed)
    for name, v, unit in results:
        print(json.dumps({"metric": name, "value": v, "unit": unit, "device": device}))
    return 0


def front_end_share(rng, timed, B: int = 8192, L: int = 150, k: int = 31,
                    genome_len: int = ECOLI_BP):
    """Time of the jitted gather-free front end against one full
    make_minimizer_locate batch on an E. coli-scale index, same reads."""
    import jax
    import jax.numpy as jnp

    from bench import gen_dspss
    from finito_tpu.index.minimizer import MinimizerIndex
    from finito_tpu.io.seqdb import encode_seq
    from finito_tpu.query.minimizer_engine import (
        DeviceMinimizerIndex,
        grow_capacities,
        initial_capacities,
        make_minimizer_locate,
        minimizer_scan,
        pack_query_windows,
    )

    genome, unitigs = gen_dspss(np.random.default_rng(0), genome_len, k)
    seqs = [encode_seq(u) for u in unitigs]
    dmi = DeviceMinimizerIndex(
        MinimizerIndex.build(np.concatenate(seqs), np.cumsum([s.size for s in seqs]), k)
    )
    starts = rng.integers(0, genome_len - L + 1, size=B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(0.005 * reads.size)
    mi, mj = rng.integers(0, B, size=n_mut), rng.integers(0, L, size=n_mut)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4
    codes = jax.device_put(jnp.asarray(reads))

    m = dmi.m

    @jax.jit
    def front(c):
        c = c.astype(jnp.uint32)
        return minimizer_scan(c, k, m), pack_query_windows(c, k)

    W = L - k + 1
    K, KH = initial_capacities(B * W, False)
    while True:
        locate = make_minimizer_locate(dmi, K)
        n_slow = int(locate(codes)[2])
        grown = grow_capacities(K, KH, n_slow, 0, B * W)
        if grown is None:
            break
        K, KH = grown
    t_front = timed(front, [(codes,)])
    t_full = timed(locate, [(codes,)])
    return [
        (f"minimizer_front_end_us_B{B}_L{L}_k{k}", t_front * 1e6, "us/batch"),
        (f"minimizer_locate_us_B{B}_L{L}_k{k}", t_full * 1e6, "us/batch"),
        ("minimizer_front_end_share", t_front / t_full, "fraction"),
    ]


if __name__ == "__main__":
    raise SystemExit(main())
