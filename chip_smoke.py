"""Smoke run of finito_tpu's main path on an NVIDIA GPU.

Everything runs in this one process, through the CLI entry point a
user calls (`finito_tpu.cli.main`), on synthetic data made from --seed:

  1. device check: JAX must find a GPU (no CPU fallback); prints the
     card, its power limit, the JAX version, the compile cache and the
     native library in use;
  2. main path at E. coli scale: a uniform DSPSS of a 4,641,652 bp
     genome at k=31 (`sbwt-build`, `build-fmin`), 100,000 FASTQ reads of
     150 bp (half reverse-complemented, 0.5% of bases substituted)
     through `search-fmin --engine minimizer`; every window is checked
     against the index-free merge-join oracle on both strands, and the
     first 1,000 lines against `search-fmin --engine oracle`;
  3. determinism: the same `search-fmin` again, byte-identical;
  4. the stream, replica and dense engines on the first 4,096 reads,
     byte-equal to the minimizer engine;
  5. k=63: a 1,000,000 bp genome, 20,000 reads, the first 2,000 lines
     checked against `--engine oracle`;
  6. kmer-mapper: `build` on the phase-2 unitigs, `query -r` on 4,096
     reads, byte-equal to `query -r --host-exact`.

With --four-gpus it runs only the path across devices and what it is
compared with: the phase-2 index and reads through `search-fmin --mesh
2,2` and `--mesh 1,4` against `--mesh 1,1`, `unitigs --mesh 4` against
the host `unitigs` build, and `__graft_entry__.dryrun_multichip(4)`.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failed phase raises and the script exits non-zero without it.

Usage: python chip_smoke.py [--seed N] [--four-gpus]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ECOLI_BP = 4_641_652  # E. coli K-12 MG1655 (BASELINE.json configs[1])
READ_LEN = 150
CLI_CHUNK = 4096  # reads per search-fmin device batch (cli.py)
_ACGT = np.frombuffer(b"ACGT", np.uint8)


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def cli(*args) -> None:
    from finito_tpu.cli import main as cli_main

    argv = [str(a) for a in args]
    rc = cli_main(argv)
    if rc != 0:
        raise SmokeError(f"finito {' '.join(argv)} exited {rc}")


class CompileTimer:
    """Sums JAX's own tracing, lowering and backend-compile durations."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0

    def _listen(self, event: str, duration: float, **_kw) -> None:
        if event in self.EVENTS:
            self.seconds += duration

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._listen)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._listen)


# ------------------------------------------------------------- data


def make_dspss(seed: int, genome_len: int, k: int):
    """(genome codes, unitig strings): a random genome cut into unitigs
    overlapping by k-1, so every k-mer occurs exactly once."""
    from bench import gen_dspss

    return gen_dspss(np.random.default_rng(seed), genome_len, k)


def draw_reads(seed: int, genome: np.ndarray, n: int, read_len: int = READ_LEN,
               sub_rate: float = 0.005) -> np.ndarray:
    """(n, read_len) codes sampled from the genome; half are reverse
    complemented, then sub_rate of all bases are substituted."""
    rng = np.random.default_rng(seed + 1)
    starts = rng.integers(0, genome.size - read_len + 1, size=n)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
    rc = rng.random(n) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    flat = reads.reshape(-1)
    n_sub = int(round(sub_rate * flat.size))
    pos = rng.choice(flat.size, size=n_sub, replace=False)
    flat[pos] = (flat[pos] + rng.integers(1, 4, size=n_sub)) % 4
    return reads


def write_fasta(path: str, seqs) -> None:
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">%d\n%s\n" % (i, bytes(s)))


def write_fastq(path: str, reads: np.ndarray) -> None:
    seqs = _ACGT[reads]
    qual = b"I" * reads.shape[1]
    with open(path, "wb") as f:
        for i in range(reads.shape[0]):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual))


def head_lines(path: str, n: int) -> bytes:
    with open(path, "rb") as f:
        return b"".join(f.readline() for _ in range(n))


def parse_pairs(path: str, n: int, w: int):
    """search-fmin output of n reads with w windows each -> (u, p),
    each (n, w) int64; raises unless every line holds w pairs."""
    with open(path, "rb") as f:
        data = f.read()
    buf = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(buf == ord("\n"))
    if nl.size != n or (buf.size and buf[-1] != ord("\n")):
        raise SmokeError(f"{path}: {nl.size} lines, expected {n}")
    opens = np.cumsum(buf == ord("("))[nl]
    per_line = np.diff(np.concatenate([[0], opens]))
    if np.any(per_line != w):
        bad = int(np.flatnonzero(per_line != w)[0])
        raise SmokeError(f"{path}: line {bad} has {per_line[bad]} pairs, expected {w}")
    vals = np.array(data.translate(bytes.maketrans(b"(),", b"   ")).split(), np.int64)
    vals = vals.reshape(n, w, 2)
    return vals[..., 0], vals[..., 1]


def oracle_pairs(unitigs, reads: np.ndarray, k: int):
    """Expected merged (u, p) of every window, without any index: the
    merge-join oracle on both strands, merged as search-fmin merges
    (forward hit, else the reverse strand's mirrored window). Unitig
    ids follow the index's order, the colex order of first k-mers."""
    from finito_tpu.io.seqdb import encode_seq
    from finito_tpu.utils.synth import kmer_location_oracle

    order = sorted(range(len(unitigs)), key=lambda i: bytes(unitigs[i][:k])[::-1])
    seqs = [encode_seq(bytes(unitigs[i])) for i in order]
    concat = np.concatenate(seqs)
    ends = np.cumsum([s.size for s in seqs]).astype(np.int64)
    uf, of = kmer_location_oracle(concat, ends, reads, k)
    ur, orr = kmer_location_oracle(concat, ends, np.ascontiguousarray(3 - reads[:, ::-1]), k)
    take_rc = uf < 0
    return np.where(take_rc, ur[:, ::-1], uf), np.where(take_rc, orr[:, ::-1], of)


def build_index(workdir: str, unitigs, k: int, tag: str):
    """unitigs.fna -> sbwt-build -> build-fmin; (fasta, prefix, seconds)."""
    fna = os.path.join(workdir, f"{tag}_unitigs.fna")
    write_fasta(fna, unitigs)
    sbwt = os.path.join(workdir, f"{tag}.sbwt")
    prefix = os.path.join(workdir, f"{tag}_idx")
    t0 = time.perf_counter()
    cli("sbwt-build", "-k", k, "-i", fna, "-o", sbwt)
    cli("build-fmin", "-o", prefix, "-i", sbwt, "-u", fna)
    return fna, prefix, time.perf_counter() - t0


def search(prefix: str, query: str, out: str, engine: str = "minimizer",
           mesh: str | None = None) -> float:
    args = ["search-fmin", "-o", out, "-i", prefix, "-q", query, "--engine", engine]
    if mesh:
        args += ["--mesh", mesh]
    t0 = time.perf_counter()
    cli(*args)
    return time.perf_counter() - t0


def require_equal(a: bytes, b: bytes, what: str) -> None:
    if a != b:
        n = next((i for i, (x, y) in enumerate(zip(a.split(b"\n"), b.split(b"\n"))) if x != y), None)
        raise SmokeError(f"{what}: outputs differ (first differing line {n})")


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


# ------------------------------------------------------------- phases


def phase_main(workdir: str, seed: int, card: str, genome_len: int = ECOLI_BP,
               n_reads: int = 100_000, n_oracle: int = 1_000, k: int = 31,
               read_len: int = READ_LEN) -> dict:
    """Phase 2 and, on its output, phase 3. Returns the paths later
    phases reuse."""
    genome, unitigs = make_dspss(seed, genome_len, k)
    fna, prefix, build_s = build_index(workdir, unitigs, k, "main")
    reads = draw_reads(seed, genome, n_reads, read_len)
    query = os.path.join(workdir, "reads.fq")
    write_fastq(query, reads)
    out = os.path.join(workdir, "minimizer.txt")
    with CompileTimer() as ct:
        wall = search(prefix, query, out)
    w = read_len - k + 1
    u, p = parse_pairs(out, n_reads, w)
    ue, pe = oracle_pairs(unitigs, reads, k)
    if not (np.array_equal(u, ue) and np.array_equal(p, pe)):
        bad = np.argwhere((u != ue) | (p != pe))
        raise SmokeError(f"minimizer engine disagrees with the merge-join oracle at "
                         f"{len(bad)} windows, first (read, window) {tuple(bad[0])}")
    found = float(np.mean(u >= 0))

    q_oracle = os.path.join(workdir, "reads_oracle.fq")
    write_fastq(q_oracle, reads[:n_oracle])
    out_oracle = os.path.join(workdir, "oracle.txt")
    search(prefix, q_oracle, out_oracle, engine="oracle")
    with open(out_oracle, "rb") as f:
        require_equal(head_lines(out, n_oracle), f.read(), "minimizer vs --engine oracle")
    log(f"phase main [{card}]: genome {genome_len} bp, k={k}, {len(unitigs)} unitigs, "
        f"build_s={build_s}, {n_reads} reads x {w} windows all equal to the "
        f"merge-join oracle (found {found}), first {n_oracle} lines equal to "
        f"--engine oracle")
    log(f"phase main [{card}]: search-fmin wall_s={wall} compile_s={ct.seconds} "
        f"windows_per_s={n_reads * w / wall} peak_bytes_in_use={peak_bytes()}")

    out2 = os.path.join(workdir, "minimizer_again.txt")
    wall2 = search(prefix, query, out2)
    with open(out, "rb") as f1, open(out2, "rb") as f2:
        require_equal(f1.read(), f2.read(), "second search-fmin run")
    log(f"phase determinism [{card}]: second search-fmin byte-identical, wall_s={wall2}")
    return {"fna": fna, "prefix": prefix, "reads": reads, "out": out, "k": k}


def phase_engines(workdir: str, main: dict, card: str, n_reads: int = CLI_CHUNK) -> None:
    """Stream, replica and dense engines on one CLI chunk of reads."""
    query = os.path.join(workdir, "reads_chunk.fq")
    write_fastq(query, main["reads"][:n_reads])
    want = head_lines(main["out"], n_reads)
    for engine in ("stream", "replica", "dense"):
        out = os.path.join(workdir, f"{engine}.txt")
        wall = search(main["prefix"], query, out, engine=engine)
        with open(out, "rb") as f:
            require_equal(f.read(), want, f"--engine {engine} vs minimizer")
        log(f"phase engines [{card}]: {engine} on {n_reads} reads byte-equal to "
            f"minimizer, wall_s={wall}")


def phase_k63(workdir: str, seed: int, card: str, genome_len: int = 1_000_000,
              n_reads: int = 20_000, n_oracle: int = 2_000,
              read_len: int = READ_LEN) -> None:
    k = 63
    genome, unitigs = make_dspss(seed + 63, genome_len, k)
    _fna, prefix, build_s = build_index(workdir, unitigs, k, "k63")
    reads = draw_reads(seed + 63, genome, n_reads, read_len)
    query = os.path.join(workdir, "reads_k63.fq")
    write_fastq(query, reads)
    out = os.path.join(workdir, "k63.txt")
    wall = search(prefix, query, out)
    parse_pairs(out, n_reads, read_len - k + 1)
    q_oracle = os.path.join(workdir, "reads_k63_oracle.fq")
    write_fastq(q_oracle, reads[:n_oracle])
    out_oracle = os.path.join(workdir, "k63_oracle.txt")
    search(prefix, q_oracle, out_oracle, engine="oracle")
    with open(out_oracle, "rb") as f:
        require_equal(head_lines(out, n_oracle), f.read(), "k=63 minimizer vs --engine oracle")
    log(f"phase k63 [{card}]: genome {genome_len} bp, build_s={build_s}, "
        f"search-fmin on {n_reads} reads wall_s={wall}, first {n_oracle} lines "
        f"equal to --engine oracle")


def phase_kmer_mapper(workdir: str, main: dict, card: str, n_reads: int = CLI_CHUNK) -> None:
    idx = os.path.join(workdir, "km.idx")
    t0 = time.perf_counter()
    cli("kmer-mapper", "build", "-u", main["fna"], "-k", main["k"], "-o", idx)
    build_s = time.perf_counter() - t0
    query = os.path.join(workdir, "reads_km.fq")
    write_fastq(query, main["reads"][:n_reads])
    dev, host = os.path.join(workdir, "km_dev.txt"), os.path.join(workdir, "km_host.txt")
    t0 = time.perf_counter()
    cli("kmer-mapper", "query", "-i", idx, "-q", query, "-r", "-o", dev)
    wall = time.perf_counter() - t0
    cli("kmer-mapper", "query", "-i", idx, "-q", query, "-r", "--host-exact", "-o", host)
    with open(dev, "rb") as f1, open(host, "rb") as f2:
        require_equal(f1.read(), f2.read(), "kmer-mapper query -r vs --host-exact")
    log(f"phase kmer-mapper [{card}]: build_s={build_s}, query -r on {n_reads} "
        f"reads wall_s={wall}, byte-equal to --host-exact")


def phase_mesh(workdir: str, seed: int, card: str, genome_len: int = ECOLI_BP,
               n_reads: int = 100_000, unitig_genome_len: int = 1_000_000,
               coverage: int = 5, k: int = 31) -> None:
    """The four-device path and the runs it is compared with."""
    genome, unitigs = make_dspss(seed, genome_len, k)
    _fna, prefix, _build_s = build_index(workdir, unitigs, k, "main")
    reads = draw_reads(seed, genome, n_reads)
    query = os.path.join(workdir, "reads.fq")
    write_fastq(query, reads)
    outs = {}
    for mesh in ("1,1", "2,2", "1,4"):
        out = os.path.join(workdir, f"mesh_{mesh.replace(',', 'x')}.txt")
        wall = search(prefix, query, out, mesh=mesh)
        with open(out, "rb") as f:
            outs[mesh] = f.read()
        log(f"phase mesh [{card}]: search-fmin --mesh {mesh} on {n_reads} reads "
            f"wall_s={wall}")
    for mesh in ("2,2", "1,4"):
        require_equal(outs[mesh], outs["1,1"], f"search-fmin --mesh {mesh} vs 1,1")
    log(f"phase mesh [{card}]: --mesh 2,2 and 1,4 byte-equal to --mesh 1,1")

    rng = np.random.default_rng(seed + 4)
    g2 = rng.integers(0, 4, size=unitig_genome_len, dtype=np.uint8)
    n_sample = coverage * unitig_genome_len // READ_LEN
    starts = rng.integers(0, unitig_genome_len - READ_LEN + 1, size=n_sample)
    sample = _ACGT[g2[starts[:, None] + np.arange(READ_LEN)[None, :]]]
    reads_fa = os.path.join(workdir, "sample.fa")
    write_fasta(reads_fa, (r.tobytes() for r in sample))
    host_u, mesh_u = os.path.join(workdir, "u_host.fna"), os.path.join(workdir, "u_mesh.fna")
    t0 = time.perf_counter()
    cli("unitigs", "-k", k, "-i", reads_fa, "-o", host_u)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli("unitigs", "-k", k, "-i", reads_fa, "-o", mesh_u, "--mesh", 4)
    mesh_s = time.perf_counter() - t0
    with open(host_u, "rb") as f1, open(mesh_u, "rb") as f2:
        require_equal(f2.read(), f1.read(), "unitigs --mesh 4 vs host build")
    log(f"phase mesh [{card}]: unitigs --mesh 4 on {n_sample} reads of a "
        f"{unitig_genome_len} bp genome byte-equal to the host build "
        f"(host_s={host_s}, mesh_s={mesh_s})")

    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    log(f"phase mesh [{card}]: dryrun_multichip(4) ok")


# ------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-device path and its comparisons")
    args = p.parse_args(argv)

    import finito_tpu

    if not os.path.abspath(finito_tpu.__file__).startswith(os.path.join(ROOT, "finito_tpu")):
        print(f"finito_tpu is not beside {__file__}", file=sys.stderr)
        return 2
    from finito_tpu import native
    from finito_tpu.utils import enable_compile_cache, gpu_cards

    cache_dir = enable_compile_cache()
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"no GPU: JAX found platform {platform!r}", file=sys.stderr)
        return 1
    need = 4 if args.four_gpus else 1
    if len(devices) < need:
        print(f"need {need} GPUs, JAX found {len(devices)}", file=sys.stderr)
        return 1
    lib = native.loaded_path()
    if lib is None:
        print("native library did not build or load", file=sys.stderr)
        return 1
    cards = gpu_cards()
    if not cards:
        print("nvidia-smi did not report the card", file=sys.stderr)
        return 1
    card = cards[0]
    log(f"device: {devices[0].device_kind} x {len(devices)} ({platform})")
    for line in cards:
        log(f"nvidia-smi: {line}")
    log(f"jax {jax.__version__}; compile cache {cache_dir}")
    log(f"native library {lib}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="finito_smoke_") as workdir:
        if args.four_gpus:
            phase_mesh(workdir, args.seed, card)
        else:
            main_out = phase_main(workdir, args.seed, card)
            phase_engines(workdir, main_out, card)
            phase_k63(workdir, args.seed, card)
            phase_kmer_mapper(workdir, main_out, card)
    log(f"all phases passed in {time.perf_counter() - t0} s")
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind, "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
