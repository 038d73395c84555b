"""Headline benchmark: k-mer localization throughput (queries/sec/device).

Builds synthetic DSPSS indexes (random genome decomposed into k-1
overlapping unitigs), then measures steady-state throughput of the
device engine on batched reads (98%-present k-mers, 2% mutations).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "kmer_queries/sec",
   "device": {...}, "ladder": [...]}

"device" names the platform, device kind and count JAX reports, and on
a GPU the card's name and power limit from nvidia-smi. The benchmark
refuses to run on anything but a GPU unless JAX_PLATFORMS=cpu is set
explicitly (a correctness run; its times are not device numbers).

The headline value is the 400 kbp rung; the "ladder" array carries one
row per genome size actually measured this run, each with its own
throughput and the count of reads differentially verified against the
exact host oracle (index.search). By default the ladder includes every
LARGER genome size whose index is already cached under --cache-dir
(default .bench_cache). `--ladder 400000,16000000` pins an explicit
list; `--ladder off` measures only --genome. The run exits non-zero if
any rung or extra row failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")

# The repeat rung must actually stress the multi-occurrence slow path:
# exact repeats collapse in the DSPSS, so pressure comes from
# near-duplication (see utils.synth.gen_repeat_genome). Defaults (1%
# divergence, 0.1% SNPs) gave slow_frac ~= the uniform rung's; these
# raise surviving shared-minimizer k-mers
# until the rung is adversarial. Changing them invalidates the repg
# cache tag contents -- rebuild via scripts/build_cache.py.
REPEAT_PARAMS = dict(seg_frac=0.35, snp_rate=0.004, div_rate=0.04)


def draw_cuts(rng, genome_len: int, k: int, mean_unitig: int = 2000) -> np.ndarray:
    """Unitig cut points; unitig i = genome[cuts[i] : cuts[i+1] + k - 1].
    Deterministic in the rng state, so a cached genome's cuts can be
    regenerated by replaying the same rng (see load_or_build_index)."""
    cuts = [0]
    while cuts[-1] < genome_len - k:
        cuts.append(min(genome_len - k + 1, cuts[-1] + int(rng.integers(mean_unitig // 2, mean_unitig * 2))))
    return np.asarray(cuts, np.int64)


def gen_dspss(rng, genome_len: int, k: int, mean_unitig: int = 2000, return_cuts: bool = False):
    """Random genome cut into unitigs overlapping by k-1 (k-mer set preserved,
    each k-mer occurs exactly once)."""
    from finito_tpu.sbwt import keys as kw

    while True:
        genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
        # verify k-mer distinctness (astronomically likely for k=31);
        # native rolling pack + radix sort, one pass each
        wk = kw.sort_keys(kw.pack_windows(genome, k))
        if np.any(kw.eq_adjacent(wk)):
            continue
        del wk
        break
    cuts = draw_cuts(rng, genome_len, k, mean_unitig)
    unitigs = []
    from finito_tpu.io.seqdb import decode_seq

    for a, b in zip(cuts[:-1], cuts[1:]):
        unitigs.append(decode_seq(genome[a : b + k - 1]))
    if return_cuts:
        return genome, unitigs, cuts
    return genome, unitigs


def _log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def device_info() -> dict:
    """The device JAX runs on; on a GPU also the card's name and power
    limit as nvidia-smi reports them."""
    import jax

    from finito_tpu.utils import gpu_cards

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] == "gpu":
        info["card"] = (gpu_cards() or [None])[0]
    return info


def _emit(ladder, device: dict) -> None:
    """Print the one-line result JSON. The headline value is ALWAYS the
    first (smallest) rung, never a later rung standing in for it."""
    head = ladder[0] if ladder and "qps" in ladder[0] else None
    print(json.dumps({
        "metric": "kmer_localization_throughput",
        "value": head["qps"] if head else 0.0,
        "unit": "kmer_queries/sec",
        "device": device,
        "ladder": ladder,
    }), flush=True)


def load_or_build_index(genome_len: int, k: int, cache_dir: str | None, rng,
                        workload: str = "uniform"):
    """(genome, FinimizerIndex, build_seconds, cuts). Caches the
    serialized index AND the genome per (genome_len, k, workload) under
    cache_dir.

    workload 'uniform' is the classic DSPSS (random genome, k-1
    overlapping cuts, analytic oracle via `cuts`); 'repeat' draws a
    repeat-dense genome (tandem + segmental + SNP bubbles,
    utils.synth.gen_repeat_genome) and decomposes it with the NATIVE dBG
    constructor -- repeated k-mers collapse, so `cuts` is None and
    verification uses the index-free merge-join oracle instead."""
    from finito_tpu.index.builder import FinimizerIndexBuilder
    from finito_tpu.index.index import FinimizerIndex
    from finito_tpu.io.seqdb import SeqDB, decode_seq
    from finito_tpu.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu.sbwt.lcs import lcs_array

    cache_prefix = genome_cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        tag = f"g{genome_len}_k{k}" if workload == "uniform" else f"repg{genome_len}_k{k}"
        cache_prefix = os.path.join(cache_dir, f"idx_{tag}")
        genome_cache = os.path.join(cache_dir, f"genome_{tag}.npy")

    if cache_prefix and os.path.exists(cache_prefix + ".sbwt") and os.path.exists(genome_cache):
        genome = np.load(genome_cache)
        t0 = time.perf_counter()
        index = FinimizerIndex.load(cache_prefix)
        build_s = time.perf_counter() - t0
        # Regenerate the DSPSS cuts (needed by the analytic oracle) by
        # replaying the rng: the genome draw advances the state, then the
        # cut draws are deterministic. Equality of the replayed genome
        # proves the replay tracked the original build's rng stream (a
        # foreign/hand-made cache just skips analytic verification).
        cuts = None
        if workload == "uniform":
            replay = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
            cuts = draw_cuts(rng, genome_len, k) if np.array_equal(replay, genome) else None
            del replay
        _log(f"index loaded from cache in {build_s:.1f}s"
             + ("" if cuts is not None or workload != "uniform"
                else "; rng replay mismatch -> no analytic oracle"))
    else:
        if workload == "uniform":
            genome, unitigs, cuts = gen_dspss(rng, genome_len, k, return_cuts=True)
        else:
            from finito_tpu.dbg import build_unitigs
            from finito_tpu.utils.synth import gen_repeat_genome

            genome = gen_repeat_genome(rng, genome_len, **REPEAT_PARAMS)
            cuts = None
            unitigs = [decode_seq(u) for u in build_unitigs([genome], k, canonical=False)]
        t0 = time.perf_counter()
        sbwt, node_keys = build_plain_matrix_sbwt(unitigs, k, return_keys=True)
        lcs = lcs_array(sbwt)
        index = FinimizerIndexBuilder(
            sbwt, lcs, SeqDB.from_sequences(unitigs), node_keys=node_keys
        ).get_index()
        build_s = time.perf_counter() - t0
        if cache_prefix:
            index.serialize(cache_prefix)
            np.save(genome_cache, genome)
    sbwt = index.sbwt
    _log(
        f"index ready in {build_s:.1f}s: {sbwt.number_of_subsets()} nodes, "
        f"{sbwt.number_of_kmers()} kmers, "
        f"{int(np.asarray(index.unitigs.ends).size)} unitigs"
    )
    return genome, index, build_s, cuts


def run_rung(genome_len: int, args, rng, workload: str = "uniform",
             engine_mode: str | None = None) -> dict:
    """Build/load one index size, measure steady-state throughput on the
    device, differentially verify --verify reads against the exact host
    oracle, and return the result row."""
    import jax
    import jax.numpy as jnp

    from finito_tpu.io.seqdb import decode_seq
    from finito_tpu.query.engine import DeviceQueryEngine

    engine_mode = engine_mode or args.engine
    t_start = time.perf_counter()
    genome, index, build_s, cuts = load_or_build_index(
        genome_len, args.k, args.cache_dir, rng, workload=workload
    )

    t0 = time.perf_counter()
    mcache = None
    if args.cache_dir and engine_mode == "minimizer":
        wtag = "g" if workload == "uniform" else "repg"
        mcache = os.path.join(args.cache_dir, f"midx_{wtag}{genome_len}_k{args.k}.ftmidx")
    engine = DeviceQueryEngine(index, mode=engine_mode, mindex_cache=mcache,
                               chunk=args.chunk)
    _log(f"engine init (incl. position table) {time.perf_counter()-t0:.1f}s")

    # Query batch: reads sampled from the genome with point mutations.
    B, L = args.batch, args.read_len
    starts = rng.integers(0, genome_len - L, size=B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(args.mutate * reads.size)
    mi = rng.integers(0, B, size=n_mut)
    mj = rng.integers(0, L, size=n_mut)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4

    # Device-resident steady-state measurement of the engine alone: the
    # batch stays on the device, so host parse/transfer/format are not in
    # this number (ROADMAP Queue 1 #2 adds the served-path metric).
    # stream/replica count repaired SEGMENTS (untrusted runs), not
    # windows: start small, the resize below right-sizes from n_unknown
    frac0 = 0.02 if engine_mode in ("stream", "replica") else 0.10
    pipe = engine.make_device_pipeline(B, L, unknown_frac=frac0)
    reads_dev = jax.device_put(jnp.asarray(reads))
    out = pipe(reads_dev)
    jax.block_until_ready(out)
    n_unknown = int(np.asarray(out[2]))
    # Right-size the repair/slow-path capacity to the workload (steady
    # state keeps one compiled program; its cost is proportional to K).
    if engine_mode in ("stream", "minimizer", "replica") and not (pipe.K // 2 <= n_unknown <= pipe.K):
        frac = max(0.005, 1.3 * n_unknown / (B * (L - args.k + 1)))
        _log(f"resizing slow path: {n_unknown} -> frac {frac:.4f}")
        pipe = engine.make_device_pipeline(B, L, unknown_frac=frac)
        out = pipe(reads_dev)
        jax.block_until_ready(out)
        n_unknown = int(np.asarray(out[2]))
    if n_unknown > pipe.K:
        raise AssertionError("pipeline slow-path overflow after resize")
    if len(out) > 3 and getattr(pipe, "K_heads", None):
        n_heads = int(np.asarray(out[3]))
        if n_heads > pipe.K_heads:
            raise AssertionError(
                f"run-head capacity overflow: {n_heads} > {pipe.K_heads}"
            )
    uid = np.asarray(out[0])
    n_win = uid.shape[1]
    found_frac = float(np.mean(uid >= 0))

    # Differential verification vs the exact host oracle (index.search):
    # every window of --verify reads, spread across the batch.
    off_h = np.asarray(out[1])
    n_verify = max(1, min(args.verify, B))
    t0 = time.perf_counter()
    for b in range(0, B, max(1, B // n_verify))[:n_verify]:
        res = index.search(decode_seq(reads[b])).local_offsets
        got = [(int(uid[b, w]), int(off_h[b, w])) for w in range(n_win)]
        assert got == res, f"mismatch vs oracle at read {b}"
    _log(f"verified {n_verify} reads x {n_win} windows vs host oracle "
         f"in {time.perf_counter()-t0:.1f}s")

    # Analytic verification of the ENTIRE batch: a DSPSS k-mer occurs
    # exactly once, at the unitig whose cut range contains its genome
    # start, so expected (uid, off) is closed-form -- an oracle with no
    # index at all. The builder's unitig permutation is recovered exactly
    # by matching first k-mers (distinct by DSPSS construction). Mutated
    # windows are absent (P(random k-mer collides) ~ n/4^k ~ 1e-11).
    n_analytic = 0
    if cuts is not None and args.k <= 32:
        t0 = time.perf_counter()
        ends_u = np.asarray(index.unitigs.ends)
        concat_u = np.asarray(index.unitigs.concat)
        ustart = np.concatenate([[0], ends_u[:-1]])
        pw = np.uint64(1) << (np.uint64(2) * np.arange(args.k, dtype=np.uint64))
        first_perm = (concat_u[ustart[:, None] + np.arange(args.k)].astype(np.uint64) @ pw)
        first_orig = (genome[cuts[:-1, None] + np.arange(args.k)].astype(np.uint64) @ pw)
        o1, o2 = np.argsort(first_orig), np.argsort(first_perm)
        assert np.array_equal(first_orig[o1], first_perm[o2]), "unitig sets differ"
        perm = np.empty(cuts.size - 1, np.int64)
        perm[o1] = o2
        g = starts[:, None] + np.arange(n_win)
        io = np.searchsorted(cuts, g.reshape(-1), side="right").reshape(g.shape) - 1
        io = np.minimum(io, cuts.size - 2)
        uid_exp = perm[io]
        off_exp = g - cuts[io]
        absent = np.zeros((B, n_win), bool)
        rel = mj[:, None] - np.arange(n_win)[None, :]
        hit = (rel >= 0) & (rel < args.k)  # windows covering each mutation
        np.logical_or.at(absent, mi, hit)
        uid_exp = np.where(absent, -1, uid_exp)
        off_exp = np.where(absent, -1, off_exp)
        assert np.array_equal(uid, uid_exp) and np.array_equal(off_h, off_exp), (
            "device engine disagrees with the analytic DSPSS oracle"
        )
        n_analytic = B * n_win
        _log(f"verified ALL {B} reads x {n_win} windows vs the analytic "
             f"DSPSS oracle in {time.perf_counter()-t0:.1f}s")
    elif workload == "repeat" and args.k <= 32:
        # index-free sort/merge-join oracle over ALL windows (repeated
        # genome k-mers collapse in the DSPSS, so the cut-based
        # closed form does not apply; utils.synth recomputes exact
        # (uid, off) from the unitig text alone)
        from finito_tpu.utils.synth import kmer_location_oracle

        t0 = time.perf_counter()
        uid_exp, off_exp = kmer_location_oracle(
            np.asarray(index.unitigs.concat), np.asarray(index.unitigs.ends),
            reads, args.k,
        )
        assert np.array_equal(uid, uid_exp) and np.array_equal(off_h, off_exp), (
            "device engine disagrees with the merge-join oracle on the "
            "repeat workload"
        )
        n_analytic = B * n_win
        _log(f"verified ALL {B} reads x {n_win} windows vs the merge-join "
             f"oracle in {time.perf_counter()-t0:.1f}s")

    # Every rep feeds an on-device checksum that is read back at the
    # end, so the timed loop covers the completion of every rep.
    csum = jax.jit(
        lambda u, o, s: s + jnp.sum(u, dtype=jnp.int32) + jnp.sum(o, dtype=jnp.int32)
    )
    if args.profile:
        with jax.profiler.trace(args.profile):
            s = jnp.int32(0)
            for _ in range(args.reps):
                out = pipe(reads_dev)
                s = csum(out[0], out[1], s)
            int(np.asarray(s))
        _log(f"jax profiler trace written to {args.profile}")
    dt = float("inf")
    for _ in range(args.trials):
        t0 = time.perf_counter()
        s = jnp.int32(0)
        for _ in range(args.reps):
            out = pipe(reads_dev)
            s = csum(out[0], out[1], s)
        int(np.asarray(s))
        dt = min(dt, time.perf_counter() - t0)
    qps = args.reps * B * n_win / dt

    _log(
        f"genome {genome_len}: {B} reads x {n_win} windows x {args.reps} reps "
        f"in {dt:.3f}s; found fraction {found_frac:.3f}; "
        f"rung wall {time.perf_counter()-t_start:.1f}s"
    )
    return {
        "genome": genome_len,
        "k": args.k,
        "qps": round(qps, 1),
        "found_frac": round(found_frac, 4),
        "oracle_verified_reads": n_verify,
        "analytic_verified_windows": n_analytic,
        "verified_windows": n_analytic + n_verify * n_win,
        "n_nodes": int(index.sbwt.number_of_subsets()),
        "build_or_load_s": round(build_s, 1),
        "engine": engine_mode,
        "workload": workload,
        "slow_frac": round(n_unknown / (B * n_win), 4),
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--genome", type=int, default=400_000, help="synthetic genome length")
    p.add_argument("--k", type=int, default=31)
    p.add_argument("--batch", type=int, default=8192, help="reads per device batch")
    p.add_argument("--read-len", type=int, default=128)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--trials", type=int, default=3, help="take the fastest trial")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of one timed trial into DIR")
    p.add_argument("--mutate", type=float, default=0.005)
    p.add_argument("--engine", default="minimizer",
                   choices=["minimizer", "stream", "dense", "replica"])
    p.add_argument("--chunk", type=int, default=None,
                   help="stream/replica scan-chunk length (None = auto ~2k, 0 = off)")
    p.add_argument("--cache-dir", default=DEFAULT_CACHE,
                   help="cache the generated genome + built index per (genome,k) "
                   "here; genome-scale host builds are worth reusing "
                   "(default: .bench_cache)")
    p.add_argument("--ladder", default="auto",
                   help="'auto': --genome plus any LARGER cached sizes; "
                   "'off': only --genome; or an explicit comma list of sizes")
    p.add_argument("--verify", type=int, default=8,
                   help="reads per rung differentially verified against the "
                   "exact host oracle (each ~n_windows k-mer queries)")
    p.add_argument("--extra-rows", default="replica,stream,repeat,k63",
                   help="comma list from {replica, stream, repeat, k63}: extra "
                   "ladder rows (compact replica / SBWT-only stream engines on "
                   "the head index; repeat-dense workload with merge-join "
                   "all-window verification; k=63 whole-genome-config rung on "
                   "the largest cached k63 index); '' or 'off' disables")
    p.add_argument("--repeat-genome", type=int, default=4_000_000,
                   help="repeat-workload genome length (native dBG decomposes "
                   "it; k-mer set is smaller than the genome)")
    args = p.parse_args()

    from finito_tpu.utils import enable_compile_cache, tune_host_allocator

    enable_compile_cache()
    tune_host_allocator()
    device = device_info()
    if device["platform"] != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        _log(f"no GPU: JAX found platform {device['platform']!r}; set "
             "JAX_PLATFORMS=cpu for a correctness-only run")
        return 1

    sizes = [args.genome]
    if args.ladder == "auto":
        if args.cache_dir and os.path.isdir(args.cache_dir):
            import re

            for f in os.listdir(args.cache_dir):
                mm = re.match(rf"idx_g(\d+)_k{args.k}\.sbwt$", f)
                if mm and int(mm.group(1)) > args.genome:
                    sizes.append(int(mm.group(1)))
        sizes = sorted(set(sizes))
    elif args.ladder != "off":
        sizes = sorted({int(x) for x in args.ladder.split(",")})

    t_all = time.perf_counter()
    ladder = []
    for g in sizes:
        rng = np.random.default_rng(0)  # per-rung determinism (cache match)
        try:
            ladder.append(run_rung(g, args, rng))
        except Exception as e:  # a failing big rung must not lose the
            if g == sizes[0]:   # rungs already measured; the exit code says it
                raise
            _log(f"rung {g} failed ({type(e).__name__}: {e})")
            ladder.append({"genome": g, "error": f"{type(e).__name__}: {e}"})

    # Extra rows (rung-isolated): the compact replica and SBWT-only
    # stream engines on the head index (the two serialized-index-only
    # deployment profiles), the repeat-dense workload (slow-path
    # stress), and a k=63 rung (the reference's whole-genome
    # MAX_KMER_LENGTH config, ref Makefile:3) on the largest cached k63
    # index.
    import copy

    wanted = args.extra_rows.split(",")
    extra = [
        ("replica", args.genome, args.k, "uniform", "replica"),
        ("stream", args.genome, args.k, "uniform", "stream"),
        ("repeat", args.repeat_genome, args.k, "repeat", args.engine),
    ]
    if "k63" in wanted and args.k != 63:
        k63_sizes = []
        if args.cache_dir and os.path.isdir(args.cache_dir):
            import re

            for f in os.listdir(args.cache_dir):
                mm = re.match(r"idx_g(\d+)_k63\.sbwt$", f)
                if mm:
                    k63_sizes.append(int(mm.group(1)))
        if k63_sizes:
            extra.append(("k63", max(k63_sizes), 63, "uniform", args.engine))
        else:
            _log("no cached k63 index; skipping the k63 extra row")
    for label, g, kk, wl, eng in extra:
        if label not in wanted:
            continue
        rng = np.random.default_rng(0)
        a = copy.copy(args)
        a.k = kk
        try:
            ladder.append(run_rung(g, a, rng, workload=wl, engine_mode=eng))
        except Exception as e:
            _log(f"extra row {label} failed ({type(e).__name__}: {e})")
            ladder.append({"genome": g, "k": kk, "engine": eng, "workload": wl,
                           "error": f"{type(e).__name__}: {e}"})
    _log(f"ladder of {len(ladder)} rungs; total wall {time.perf_counter()-t_all:.1f}s")
    _emit(ladder, device)
    failed = [row for row in ladder if "error" in row]
    if failed:
        _log(f"{len(failed)} of {len(ladder)} rows failed")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
