"""kmer-mapper: the framework's second CLI vertical.

Equivalent of the reference's independent Rust implementation
(ref_implementation/src/main.rs:133-305): a minimizer-index k-mer to
(unitig, position) mapper with subcommands

    build                  -u unitigs.fna -k K [-m M] [-t N] -o index
    query                  -i index -q reads.fna [-r] [--host-exact]
    extract-index-unitigs  -i index -o out.fna

Semantics match the Rust binary:
  * unitigs are permuted by the colexicographic order of their first
    k-mer before indexing (main.rs:42-61), so unitig ids line up with
    Finito's;
  * query prints one line per read: "(u,p) (u,p) ..." with (-1,-1) for
    absent k-mers (main.rs:74-105);
  * with -r, reverse-complement occurrences are merged per window,
    skipping self-RC k-mers, and a k-mer occurring in more than one
    place is an error (main.rs:82-92);
  * extract-index-unitigs reproduces the stored records.

Deviations (documented): the index file format written is finito's own
(FTMIDX02, index/minimizer.py) rather than Rust bincode, but query and
extract-index-unitigs AUTO-IMPORT a Rust KMIDXv01 file one-way
(io/kmidx.py: the hash-slot table rebuilds from the stored unitigs and
the occurrence set is cross-validated against the stored locations);
-m above 16 is clamped (our hash-slot bucket table replaces boomphf's
MPHF -- query answers are independent of m, it is purely a performance
knob); -t is accepted for compatibility (the device path needs no
host threads).

The default query path runs on the accelerator in batches; --host-exact
forces the per-window host scan with full multi-occurrence detection.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from finito_tpu.index.minimizer import MinimizerIndex, default_m


def _colex_key(kmer: bytes) -> bytes:
    return kmer[::-1]


def permute_by_first_kmer(records: List[tuple], k: int) -> List[tuple]:
    """Sort records by colex order of their first k-mer (main.rs:42-61)."""
    return sorted(records, key=lambda rec: _colex_key(bytes(rec[1][:k])))


def build(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="kmer-mapper build", description="Mapping k-mers to unitigs")
    p.add_argument("-u", "--unitigs", required=True, help="Input FASTA or FASTQ file, possibly gzipped")
    p.add_argument("-t", "--nthreads", type=int, default=1, help="Number of host build threads (native sort kernels)")
    p.add_argument("-o", "--outfile", required=True, help="Output index file")
    p.add_argument("-k", type=int, required=True, help="k-mer length")
    p.add_argument("-m", type=int, default=None, help="minimizer length (default: auto; values above 16 are clamped)")
    args = p.parse_args(argv)
    if args.nthreads > 1:
        os.environ.setdefault("FINITO_THREADS", str(args.nthreads))

    from finito_tpu.io.fastx import read_all_records
    from finito_tpu.io.seqdb import encode_seq

    records = read_all_records(args.unitigs)
    sys.stderr.write(f"Read {len(records)} unitigs\n")
    sys.stderr.write("Sorting unitigs by first k-mer\n")
    records = permute_by_first_kmer(records, args.k)

    seqs = [encode_seq(bytes(s)) for _h, s in records]
    concat = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    ends = np.cumsum([s.size for s in seqs]).astype(np.int64)

    m = args.m
    if m is not None and m > 16:
        sys.stderr.write(f"m={m} clamped to 16 (query answers are independent of m)\n")
        m = 16
    if m is None:
        m = default_m(args.k)
    sys.stderr.write(f"k = {args.k}, m = {m}\n")

    index = MinimizerIndex.build(concat, ends, args.k, m=m)
    index.headers = [bytes(h) for h, _s in records]
    sys.stderr.write(f"Saving index to {args.outfile}\n")
    index.serialize(args.outfile)
    return 0


def _device_locate(index: MinimizerIndex, reads: List[bytes], rc: bool):
    """Batched accelerator lookups. Returns per-read lists of (u, p) with
    the fwd/RC merge; exits with the reference's 'occurs in N unitigs'
    error whenever a k-mer's TOTAL occurrence count exceeds 1 -- including
    forward-only duplicates and regardless of -r (main.rs:89-92) -- using
    the engine's exact per-window occurrence counter."""
    from finito_tpu.utils import enable_compile_cache, tune_host_allocator

    enable_compile_cache()
    tune_host_allocator()
    import jax

    from finito_tpu.io.seqdb import encode_seq
    from finito_tpu.query.minimizer_engine import (
        DeviceMinimizerIndex,
        make_minimizer_locate,
        make_minimizer_locate_v2,
    )

    k = index.k
    dmi = DeviceMinimizerIndex(index)
    # run-dedup form for big descriptor tables (same provisional policy
    # as the engine; FINITO_MINIMIZER_V2=0/1 forces either form for tests)
    import os as _os

    _ov = _os.environ.get("FINITO_MINIMIZER_V2")
    use_v2 = (
        _ov == "1"
        if _ov in ("0", "1")
        else int(np.asarray(dmi.desc).nbytes) >= (64 << 20)
    )
    cache = {}

    from finito_tpu.query.minimizer_engine import grow_capacities, initial_capacities

    def locate_batch(codes: np.ndarray):
        B, L = codes.shape
        W = L - k + 1
        # 2x the engine's slow headroom: counting scans slots to the end
        K, KH = initial_capacities(B * W, use_v2, slow_divisor=128 if use_v2 else 16)
        while True:
            key = (K, KH, B, L)
            if key not in cache:
                cache[key] = (
                    make_minimizer_locate_v2(dmi, K, KH, count_occurrences=True)
                    if use_v2
                    else make_minimizer_locate(dmi, K, count_occurrences=True)
                )
            out = cache[key](codes)
            if use_v2:
                uid, off, n_slow, n_heads, cnt = out
            else:
                uid, off, n_slow, cnt = out
                n_heads = 0
            grown = grow_capacities(K, KH, int(n_slow), int(n_heads), B * W)
            if grown is None:
                return np.asarray(uid), np.asarray(off), np.asarray(cnt)
            K, KH = grown

    answers = []
    batch_idx, batch_codes = [], []
    for i, read in enumerate(reads):
        codes = encode_seq(read)
        answers.append(None)
        if codes.size < k:
            answers[i] = []
        else:
            batch_idx.append(i)
            batch_codes.append(codes)
    if batch_idx:
        L = max(c.size for c in batch_codes)
        L = max(L, k)
        B = len(batch_codes)
        fwd = np.full((B, L), 255, dtype=np.uint8)
        rcm = np.full((B, L), 255, dtype=np.uint8)
        for j, c in enumerate(batch_codes):
            fwd[j, : c.size] = c
            rcm[j, : c.size] = (3 - c)[::-1]
        uid_f, off_f, cnt_f = locate_batch(fwd)
        if rc:
            uid_r, off_r, cnt_r = locate_batch(rcm)
        for j, i in enumerate(batch_idx):
            n = batch_codes[j].size - k + 1
            u = uid_f[j, :n].astype(np.int64)
            o = off_f[j, :n].astype(np.int64)
            total = cnt_f[j, :n].astype(np.int64)
            if rc:
                ur = uid_r[j, :n][::-1].astype(np.int64)
                orr = off_r[j, :n][::-1].astype(np.int64)
                w_mat = np.lib.stride_tricks.sliding_window_view(batch_codes[j], k)
                self_rc = np.all(w_mat == (3 - w_mat)[:, ::-1], axis=1)
                total = total + np.where(self_rc, 0, cnt_r[j, :n][::-1].astype(np.int64))
                rc_hit = (ur != -1) & ~self_rc
                u = np.where(rc_hit & (u == -1), ur, u)
                o = np.where(rc_hit & (o == -1), orr, o)
            if np.any(total > 1):
                from finito_tpu.io.seqdb import decode_seq

                w = int(np.flatnonzero(total > 1)[0])
                kmer = decode_seq(batch_codes[j][w : w + k]).decode()
                sys.stderr.write(
                    f"Error: k-mer {kmer} occurs in {int(total[w])} unitigs\n"
                )
                raise SystemExit(1)
            answers[i] = list(zip(u.tolist(), o.tolist()))
    return answers


def query(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="kmer-mapper query", description="Mapping k-mers to unitigs")
    p.add_argument("-i", "--index", required=True, help="Index file")
    p.add_argument("-q", "--query", required=True, help="Input FASTA or FASTQ file, possibly gzipped")
    p.add_argument("-r", "--reverse-complements", action="store_true",
                   help="Whether to also report reverse complement matches")
    p.add_argument("--host-exact", action="store_true",
                   help="Per-window host lookup with full multi-occurrence detection")
    p.add_argument("-o", "--outfile", default=None, help="Output file (default stdout)")
    args = p.parse_args(argv)

    from finito_tpu.io.fastx import SequenceReader, reverse_complement
    from finito_tpu.io.seqdb import encode_seq

    index = _load_index(args.index)
    k = index.k
    out = open(args.outfile, "w") if args.outfile else sys.stdout

    def emit(line):
        out.write(" ".join(f"({u},{p})" for u, p in line) + "\n")

    if args.host_exact:
        with SequenceReader(args.query) as reader:
            for _h, read in reader:
                read = bytes(read)
                line = []
                for w in range(max(0, len(read) - k + 1)):
                    kmer = read[w : w + k]
                    occs = index.lookup_kmer_host_all(encode_seq(kmer))
                    if args.reverse_complements:
                        rck = reverse_complement(kmer)
                        if rck != kmer:
                            occs = occs + index.lookup_kmer_host_all(encode_seq(rck))
                    if len(occs) > 1:
                        sys.stderr.write(
                            f"Error: k-mer {kmer.decode()} occurs in {len(occs)} unitigs\n"
                        )
                        raise SystemExit(1)
                    line.append(occs[0] if occs else (-1, -1))
                emit(line)
    else:
        with SequenceReader(args.query) as reader:
            reads = [bytes(s) for _h, s in reader]
        for line in _device_locate(index, reads, args.reverse_complements):
            emit(line)
    if args.outfile:
        out.close()
    return 0


def extract_index_unitigs(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="kmer-mapper extract-index-unitigs")
    p.add_argument("-i", "--index", required=True, help="Index file")
    p.add_argument("-o", "--outfile", required=True, help="Output fasta file")
    args = p.parse_args(argv)

    from finito_tpu.io.fastx import SequenceWriter
    from finito_tpu.io.seqdb import decode_seq

    index = _load_index(args.index)
    with SequenceWriter(args.outfile) as w:
        start = 0
        for uid, e in enumerate(index.ends):
            seq = decode_seq(index.concat[start : int(e)])
            header = (
                index.headers[uid]
                if index.headers is not None and uid < len(index.headers)
                else f"unitig_{uid}".encode()
            )
            w.write_record(header, seq)
            start = int(e)
    return 0




def _load_index(path: str):
    """Load a finito FTMIDX index, or import a Rust KMIDXv01 file
    (one-way; see finito_tpu/io/kmidx.py for the verification status)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic == b"KMIDXv01":
        from finito_tpu.io.kmidx import import_kmidx

        sys.stderr.write("Importing Rust KMIDXv01 index (rebuilding hash-slot table)\n")
        return import_kmidx(path)
    return MinimizerIndex.load(path)


COMMANDS = {
    "build": build,
    "query": query,
    "extract-index-unitigs": extract_index_unitigs,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write("kmer-mapper: Mapping k-mers to unitigs\n\nCommands:\n")
        for c in COMMANDS:
            sys.stderr.write(f"   kmer-mapper {c}\n")
        return 1
    fn = COMMANDS.get(argv[0])
    if fn is None:
        sys.stderr.write(f"Invalid command: {argv[0]}\n")
        return 1
    return fn(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
