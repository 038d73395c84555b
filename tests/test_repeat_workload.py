"""Repeat-heavy workloads: engines + dBG construction under real repeat
structure.

Uniform-random DSPSS text exercises the slow paths at ~3-0.5% of
windows; tandem repeats, segmental duplications, and SNP bubbles
push shared minimizers, dBG branching, and the cross-unitig overwrite
rule far harder. Ground truth is the index-free sort/merge-join oracle
(utils.synth.kmer_location_oracle) over ALL windows, plus the exact
host oracle (index.search) on sampled reads.
"""

from __future__ import annotations

import numpy as np
import pytest

from finito_tpu.dbg import build_unitigs
from finito_tpu.index.builder import FinimizerIndexBuilder
from finito_tpu.io.seqdb import SeqDB, decode_seq
from finito_tpu.sbwt.construct import build_plain_matrix_sbwt
from finito_tpu.sbwt.lcs import lcs_array
from finito_tpu.utils.synth import gen_repeat_genome, kmer_location_oracle

K = 21


def _build_repeat_index(length=120_000, k=K, seed=5, canonical=False):
    """genome -> native dBG unitigs -> FinimizerIndex (+ genome). The
    non-canonical dBG keeps forward-strand coordinates, matching how
    reads are drawn below; canonical construction is covered by
    test_dbg and the dedup test at the bottom."""
    rng = np.random.default_rng(seed)
    genome = gen_repeat_genome(rng, length)
    unitigs = build_unitigs([genome], k, canonical=canonical)
    seqs = [decode_seq(u) for u in unitigs]
    sbwt, node_keys = build_plain_matrix_sbwt(seqs, k, return_keys=True)
    index = FinimizerIndexBuilder(
        sbwt, lcs_array(sbwt), SeqDB.from_sequences(seqs), node_keys=node_keys
    ).get_index()
    return genome, index, rng


@pytest.fixture(scope="module")
def repeat_index():
    return _build_repeat_index()


def _sample_reads(genome, rng, B=64, L=96, mutate=0.01):
    starts = rng.integers(0, genome.size - L, size=B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(mutate * reads.size)
    mi = rng.integers(0, B, size=n_mut)
    mj = rng.integers(0, L, size=n_mut)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=n_mut)) % 4
    return reads


def test_repeat_genome_is_repeat_dense():
    rng = np.random.default_rng(0)
    g = gen_repeat_genome(rng, 100_000)
    from finito_tpu.utils.synth import _pack_all_windows

    keys = _pack_all_windows(g, K)
    n_dup = keys.size - np.unique(keys).size
    # uniform random text of this size has ~0 duplicate 21-mers;
    # the generator must produce a substantial duplicated fraction
    assert n_dup > 0.05 * keys.size


def test_oracle_agrees_with_host_search(repeat_index):
    genome, index, rng = repeat_index
    reads = _sample_reads(genome, rng, B=8, L=64)
    uid_o, off_o = kmer_location_oracle(
        np.asarray(index.unitigs.concat), np.asarray(index.unitigs.ends), reads, K
    )
    for b in range(reads.shape[0]):
        res = index.search(decode_seq(reads[b])).local_offsets
        got = [(int(uid_o[b, w]), int(off_o[b, w])) for w in range(uid_o.shape[1])]
        assert got == res, f"read {b}: merge-join oracle != host search"


@pytest.mark.parametrize("mode", ["dense", "stream", "minimizer", "replica"])
def test_engines_on_repeat_workload(repeat_index, mode):
    from finito_tpu.query.engine import DeviceQueryEngine

    genome, index, rng = repeat_index
    reads = _sample_reads(genome, rng, B=48, L=96)
    uid_e, off_e = kmer_location_oracle(
        np.asarray(index.unitigs.concat), np.asarray(index.unitigs.ends), reads, K
    )
    engine = DeviceQueryEngine(index, mode=mode)
    uid, off = engine.locate_batch(reads)
    assert np.array_equal(np.asarray(uid), uid_e), mode
    assert np.array_equal(np.asarray(off), off_e), mode


def test_minimizer_slow_fraction_rises(repeat_index):
    """Repeat text must actually stress the multi-occurrence slow path:
    the run-dedup form's slow-run count on repeat reads should be well
    above the uniform-random baseline at the same table size."""
    from finito_tpu.query.minimizer_engine import (
        DeviceMinimizerIndex,
        make_minimizer_locate_v2,
    )
    from finito_tpu.index.minimizer import MinimizerIndex

    genome, index, rng = repeat_index
    reads = _sample_reads(genome, rng, B=64, L=96)
    mindex = MinimizerIndex.from_finimizer_index(index)
    dmi = DeviceMinimizerIndex(mindex)
    B, L = reads.shape
    W = L - K + 1
    f = make_minimizer_locate_v2(dmi, B * W, B * W)
    out = f(np.asarray(reads))
    n_slow = int(out[2])
    assert n_slow > 0, "repeat workload produced no slow-path runs"


def test_dbg_dedup_on_repeat_dense_input():
    """Mirror/cycle dedup at scale on repeat-dense input: the unitig
    set must be a DSPSS of the input's canonical k-mer set (each
    canonical k-mer exactly once -- duplicates would surface here)."""
    from finito_tpu.sbwt import keys as kw

    rng = np.random.default_rng(11)
    genome = gen_repeat_genome(rng, 1_200_000)
    k = 21
    unitigs = build_unitigs([genome], k, canonical=True)
    # canonical k-mer multiset of the unitig set
    all_keys = []
    for u in unitigs:
        # canonical identity = min(fwd key, rc key): a deterministic
        # per-pair choice is all dedup needs; single-word keys at k=21
        a = kw.pack_windows(u, k)[0]
        b = kw.pack_windows((3 - u)[::-1].copy(), k)[0][::-1]
        all_keys.append(np.minimum(a, b))
    cat = np.concatenate(all_keys)
    cat.sort(kind="stable")
    assert not np.any(cat[1:] == cat[:-1]), "duplicate canonical k-mer in DSPSS"
    # and it covers the input's canonical set exactly
    gf = kw.pack_windows(genome, k)[0]
    gr = kw.pack_windows((3 - genome)[::-1].copy(), k)[0][::-1]
    gset = np.unique(np.minimum(gf, gr))
    assert np.array_equal(np.unique(cat), gset)
