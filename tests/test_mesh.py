"""(dp, tp) sharded locate paths vs single-chip engines on the virtual
8-device CPU mesh (tests/conftest.py)."""

import os

import numpy as np
import pytest

import jax

from finito_tpu.index.minimizer import MinimizerIndex
from finito_tpu.parallel.mesh import (
    ShardedIndex,
    ShardedMinimizerIndex,
    make_mesh,
    sharded_locate_fn,
    sharded_minimizer_locate_fn,
)
from finito_tpu.query.engine import DeviceQueryEngine

from tests.test_device_engine import build_index, gen_dspss

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the virtual 8-device mesh"
)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(123)
    k = 6
    unitigs = gen_dspss(rng, 10, 10, 50, k)
    index = build_index(unitigs, k)
    engine = DeviceQueryEngine(index, mode="dense")
    B, L = 16, 40
    reads = np.full((B, L), 255, dtype=np.uint8)
    from finito_tpu.io.seqdb import encode_seq

    for b in range(B):
        if b % 3 == 0:
            u = unitigs[int(rng.integers(len(unitigs)))]
            codes = encode_seq(u.encode())[:L]
        else:
            codes = rng.integers(0, 4, size=int(rng.integers(k, L))).astype(np.uint8)
        reads[b, : codes.size] = codes
    uid1, off1 = engine.locate_batch(reads)
    return index, engine, reads, uid1, off1


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_sbwt_locate(setup, tp):
    index, engine, reads, uid1, off1 = setup
    mesh = make_mesh(8, tp=tp)
    sh = ShardedIndex.from_index(index, np.asarray(engine.pos_table), tp=tp)
    locate = sharded_locate_fn(mesh, sh)
    uid, off = locate(reads)
    W = uid1.shape[1]
    np.testing.assert_array_equal(np.asarray(uid)[:, :W], uid1)
    np.testing.assert_array_equal(np.asarray(off)[:, :W], off1)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_minimizer_locate(setup, tp):
    index, engine, reads, uid1, off1 = setup
    mesh = make_mesh(8, tp=tp)
    mindex = MinimizerIndex.from_finimizer_index(index)
    shm = ShardedMinimizerIndex.from_minimizer_index(mindex, tp=tp)
    locate = sharded_minimizer_locate_fn(mesh, shm, K_slow=512)
    uid, off, n_slow = locate(reads)
    assert int(np.asarray(n_slow)) <= 512
    W = uid1.shape[1]
    np.testing.assert_array_equal(np.asarray(uid)[:, :W], uid1)
    np.testing.assert_array_equal(np.asarray(off)[:, :W], off1)


def test_all_kmers_cover_shard_boundaries(setup):
    """Deliberate seam coverage: query EVERY k-mer of the indexed set as
    its own read, so every colex rank -- including the word-aligned
    shard-boundary ranks of each tp split -- flows through the sharded
    rank/psum path. Any clip/rebase bug at a shard seam fails here."""
    index, engine, _reads, _u, _o = setup
    k = index.sbwt.get_k()
    concat = np.asarray(index.unitigs.concat)
    ends = np.asarray(index.unitigs.ends)
    wins = []
    s = 0
    for e in ends:
        e = int(e)
        for p in range(s, e - k + 1):
            wins.append(concat[p : p + k])
        s = e
    reads = np.stack(wins).astype(np.uint8)  # (n_kmers_with_dups, k)
    pad = (-reads.shape[0]) % 8  # batch divisible by every dp tested
    reads = np.vstack([reads, np.full((pad, k), 255, np.uint8)])
    uid1, off1 = engine.locate_batch(reads)
    assert np.all(uid1[: reads.shape[0] - pad] >= 0)  # every indexed k-mer found
    for tp in (2, 4, 8):
        mesh = make_mesh(8, tp=tp)
        sh = ShardedIndex.from_index(index, np.asarray(engine.pos_table), tp=tp)
        uid, off = sharded_locate_fn(mesh, sh)(reads)
        np.testing.assert_array_equal(np.asarray(uid)[:, :1], uid1)
        np.testing.assert_array_equal(np.asarray(off)[:, :1], off1)
        mindex = MinimizerIndex.from_finimizer_index(index)
        shm = ShardedMinimizerIndex.from_minimizer_index(mindex, tp=tp)
        um, om, ns = sharded_minimizer_locate_fn(mesh, shm, K_slow=2048)(reads)
        assert int(np.asarray(ns)) <= 2048
        np.testing.assert_array_equal(np.asarray(um)[:, :1], uid1)
        np.testing.assert_array_equal(np.asarray(om)[:, :1], off1)


def test_minimizer_sharded_collision_pressure(setup):
    """Adversarial table pressure: a slot_factor=1 table is saturated
    with collisions (multi-occurrence slots in EVERY shard -- asserted,
    not assumed), so the shard-local slow path and the cross-shard psum
    combine both carry real weight; answers must still equal the
    single-device engine on the all-k-mers query set. Seam analog of
    the text-sharded design: the boundary unitigs of every tp split are
    queried (the all-k-mers set includes each unitig's k-mers)."""
    index, engine, _r, _u, _o = setup

    k = index.sbwt.get_k()
    concat = np.asarray(index.unitigs.concat)
    ends = np.asarray(index.unitigs.ends)
    wins, s = [], 0
    for e in ends:
        e = int(e)
        wins.extend(concat[p : p + k] for p in range(s, e - k + 1))
        s = e
    reads = np.stack(wins).astype(np.uint8)
    pad = (-reads.shape[0]) % 8
    reads = np.vstack([reads, np.full((pad, k), 255, np.uint8)])
    uid1, off1 = engine.locate_batch(reads)

    for tp in (2, 4, 8):
        shm = ShardedMinimizerIndex.build(concat, ends, k, tp, slot_factor=1)
        # every shard's saturated table really has multi-occurrence slots
        assert all(
            int(shm.desc[s_, : shm.V, 1].max()) >= 2
            for s_ in range(tp)
            if int(shm.n_occ[s_]) >= 4
        ), tp
        # the partition covers every occurrence exactly once
        mi_full = MinimizerIndex.build(concat, ends, k, slot_factor=1)
        assert int(np.asarray(shm.n_occ).sum()) == int(mi_full.occ_key.size)
        mesh = make_mesh(8, tp=tp)
        um, om, ns = sharded_minimizer_locate_fn(mesh, shm, K_slow=4096)(reads)
        assert int(np.asarray(ns)) <= 4096
        np.testing.assert_array_equal(np.asarray(um)[:, :1], uid1)
        np.testing.assert_array_equal(np.asarray(om)[:, :1], off1)


def test_sharded_text_memory_scales_down():
    """The text-sharded design's reason to exist: per-shard device
    bytes (text + occurrences + table) shrink as tp grows, because
    NOTHING is replicated -- each shard holds only its own unitig
    range. This is what makes > single-chip-HBM indexes reachable."""
    rng = np.random.default_rng(3)
    k = 21
    from finito_tpu.io.seqdb import encode_seq

    unitigs = gen_dspss(rng, 60, 120, 400, k)
    concat = np.concatenate([encode_seq(u.encode()) for u in unitigs])
    ends = np.cumsum([len(u) for u in unitigs])

    def shard_bytes(shm):
        per = shm.text_arr.nbytes + shm.occ_rows.nbytes + shm.desc.nbytes
        return per // shm.text_arr.shape[0]  # per-shard share

    b1 = shard_bytes(ShardedMinimizerIndex.build(concat, ends, k, 1))
    b4 = shard_bytes(ShardedMinimizerIndex.build(concat, ends, k, 4))
    assert b4 * 2 < b1, (b1, b4)  # at least 2x down at tp=4 (padding slack)


@pytest.mark.parametrize("k", [65, 129])
def test_sharded_minimizer_large_k(k):
    """64 < k <= 255: the sharded locate uses the rolling packed-word
    matcher on shard-local text (the reference supports k <= 250,
    Makefile:3 MAX_KMER_LENGTH); answers equal the single-chip engine."""
    rng = np.random.default_rng(k)
    from finito_tpu.io.seqdb import encode_seq

    unitigs = gen_dspss(rng, 20, k + 80, k + 200, k)
    concat = np.concatenate([encode_seq(u.encode()) for u in unitigs])
    ends = np.cumsum([len(u) for u in unitigs])
    mindex = MinimizerIndex.build(concat, ends, k)
    from finito_tpu.query.minimizer_engine import (
        DeviceMinimizerIndex,
        make_minimizer_locate,
    )

    dmi = DeviceMinimizerIndex(mindex)
    L = k + 40
    B = 16
    reads = np.full((B, L), 255, np.uint8)
    s = 0
    for b, u in enumerate(unitigs[:B]):
        codes = encode_seq(u.encode())
        reads[b, : min(L, codes.size)] = codes[:L]
    mut = rng.integers(0, L, size=B)
    reads[np.arange(B) % B, mut] = (reads[np.arange(B) % B, mut] + 1) % 4
    uid1, off1, _ = make_minimizer_locate(dmi, K_slow=512)(reads)
    uid1, off1 = np.asarray(uid1), np.asarray(off1)
    assert np.any(uid1 >= 0)

    for tp in (2, 8):
        mesh = make_mesh(8, tp=tp)
        shm = ShardedMinimizerIndex.build(concat, ends, k, tp)
        um, om, ns = sharded_minimizer_locate_fn(mesh, shm, K_slow=512)(reads)
        np.testing.assert_array_equal(np.asarray(um), uid1)
        np.testing.assert_array_equal(np.asarray(om), off1)


def test_sharded_minimizer_million_nodes():
    """~10^6-node sharded index: build from a 1 Mbp synthetic DSPSS and
    verify the (dp, tp) sharded minimizer locate against the single-
    device engine on mutated reads."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import gen_dspss as gen_big

    rng = np.random.default_rng(5)
    k = 21
    genome, unitigs = gen_big(rng, 1_000_000, k)
    from finito_tpu.index.builder import FinimizerIndexBuilder
    from finito_tpu.io.seqdb import SeqDB
    from finito_tpu.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu.sbwt.lcs import lcs_array

    sbwt, node_keys = build_plain_matrix_sbwt(unitigs, k, return_keys=True)
    assert sbwt.number_of_subsets() >= 1_000_000
    index = FinimizerIndexBuilder(
        sbwt, lcs_array(sbwt), SeqDB.from_sequences(unitigs), node_keys=node_keys
    ).get_index()

    engine = DeviceQueryEngine(index, mode="minimizer")
    B, L = 32, 100
    starts = rng.integers(0, 1_000_000 - L, size=B)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    mut = rng.integers(0, L, size=B)
    reads[np.arange(B), mut] = (reads[np.arange(B), mut] + 1) % 4
    uid1, off1 = engine.locate_batch(reads)
    assert np.any(uid1 >= 0) and np.any(uid1 == -1)

    mindex = MinimizerIndex.from_finimizer_index(index)
    for tp in (2, 8):
        mesh = make_mesh(8, tp=tp)
        shm = ShardedMinimizerIndex.from_minimizer_index(mindex, tp=tp)
        uid, off, ns = sharded_minimizer_locate_fn(mesh, shm, K_slow=1024)(reads)
        W = uid1.shape[1]
        np.testing.assert_array_equal(np.asarray(uid)[:, :W], uid1)
        np.testing.assert_array_equal(np.asarray(off)[:, :W], off1)


def test_cli_search_fmin_mesh_matches_single(tmp_path):
    """Product-surface scale-out: `search-fmin --engine minimizer
    --mesh 4,2` on the 8-device CPU mesh produces a byte-identical
    output file to the single-device run."""
    from finito_tpu.cli import main

    rng = np.random.default_rng(31)
    k = 6
    unitigs = gen_dspss(rng, 12, 12, 60, k)
    fna = str(tmp_path / "u.fna")
    with open(fna, "w") as f:
        for i, u in enumerate(unitigs):
            f.write(f">u{i}\n{u}\n")
    reads = str(tmp_path / "q.fna")
    with open(reads, "w") as f:
        for i in range(17):
            if i % 3 == 0:
                f.write(f">q{i}\n{unitigs[int(rng.integers(len(unitigs)))]}\n")
            else:
                s = "".join(rng.choice(list("ACGT"), int(rng.integers(k, 40))))
                f.write(f">q{i}\n{s}\n")

    sbwt_f = str(tmp_path / "x.sbwt")
    prefix = str(tmp_path / "p")
    assert main(["sbwt-build", "-k", str(k), "-i", fna, "-o", sbwt_f]) == 0
    assert main(["build-fmin", "-o", prefix, "-i", sbwt_f, "-u", fna]) == 0
    o1 = str(tmp_path / "single.txt")
    assert main(["search-fmin", "-o", o1, "-i", prefix, "-q", reads,
                 "--engine", "minimizer"]) == 0
    o2 = str(tmp_path / "mesh.txt")
    assert main(["search-fmin", "-o", o2, "-i", prefix, "-q", reads,
                 "--engine", "minimizer", "--mesh", "4,2"]) == 0
    assert open(o2).read() == open(o1).read()
    assert open(o1).read().count("\n") == 17


def test_sharded_lcs_build_matches_host(setup):
    """The dp-sharded LCS construction (halo diff + all_gather
    propagation) must equal the host LCS array."""
    from finito_tpu.parallel.mesh import make_mesh, sharded_lcs_fn
    from finito_tpu.sbwt.lcs import lcs_array

    index, _e, _r, _u, _o = setup
    want = np.asarray(lcs_array(index.sbwt))
    for tp in (1, 2):
        mesh = make_mesh(8, tp=tp)
        got = sharded_lcs_fn(mesh, index.sbwt)
        np.testing.assert_array_equal(got, want)
