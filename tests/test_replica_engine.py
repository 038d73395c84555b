"""Replica engine stress: mutation-heavy reads exercise the drop-based
recovery loop, the SU closed form, and the branch-vs-finimizer dictionary
selection; the host oracle (exact reference algorithm) is the arbiter."""

import numpy as np
import pytest

from finito_tpu.query.engine import DeviceQueryEngine

from tests.test_device_engine import build_index, gen_dspss


@pytest.mark.parametrize("k", [4, 6, 11])
def test_replica_mutation_heavy(k):
    rng = np.random.default_rng(100 + k)
    unitigs = gen_dspss(rng, 10, max(8, k + 2), 50, k)
    index = build_index(unitigs, k)
    engine = DeviceQueryEngine(index, mode="replica")

    queries = []
    # clean substrings
    for _ in range(15):
        u = unitigs[int(rng.integers(len(unitigs)))]
        if len(u) <= k:
            continue
        a = int(rng.integers(0, len(u) - k))
        b = int(rng.integers(a + k, len(u) + 1))
        queries.append(u[a:b])
    # mutated substrings (recovery-heavy): flip several positions
    for _ in range(25):
        u = unitigs[int(rng.integers(len(unitigs)))]
        if len(u) < k + 3:
            continue
        s = list(u)
        for _m in range(1 + int(rng.integers(0, 3))):
            p = int(rng.integers(0, len(s)))
            s[p] = "ACGT"[int(rng.integers(0, 4))]
        queries.append("".join(s))
    # chimeric junctions
    for _ in range(10):
        u1 = unitigs[int(rng.integers(len(unitigs)))]
        u2 = unitigs[int(rng.integers(len(unitigs)))]
        queries.append(u1[-(k + 2) :] + u2[: k + 2])

    for q in queries:
        got = engine.search_fwd_rc(q.encode())[0]
        want = index.search(q.encode())
        assert got.local_offsets == want.local_offsets, q
        assert got.n_found == want.n_found, q


def test_replica_batched_mixed_lengths():
    rng = np.random.default_rng(77)
    k = 6
    unitigs = gen_dspss(rng, 8, 10, 40, k)
    index = build_index(unitigs, k)
    engine = DeviceQueryEngine(index, mode="replica")
    reads = []
    for _ in range(20):
        L = int(rng.integers(k, 35))
        reads.append("".join(rng.choice(list("ACGT"), L)).encode())
    out = engine.process_reads(reads)
    for read, (f, _r) in zip(reads, out):
        want = index.search(read)
        assert f.local_offsets == want.local_offsets, read


def test_replica_v2_matches_v1_and_oracle():
    """The two-phase replica (optimistic chain + segment repair) must
    equal the in-scan reference twin and the host oracle, including
    heavy mutations (segment-dense), invalid chars, and pad tails."""
    import numpy as np

    from finito_tpu.query.replica import make_replica_locate, make_replica_locate_v2
    from tests.test_device_engine import build_index, gen_dspss

    rng = np.random.default_rng(41)
    k = 6
    unitigs = gen_dspss(rng, 12, 12, 60, k)
    index = build_index(unitigs, k)
    B, L = 12, 40
    reads = np.full((B, L), 255, np.uint8)
    from finito_tpu.io.seqdb import decode_seq, encode_seq

    concat = np.asarray(index.unitigs.concat)
    for b in range(B):
        u = encode_seq(unitigs[int(rng.integers(len(unitigs)))].encode())
        n = min(u.size, L)
        reads[b, :n] = u[:n]
        for _ in range(int(rng.integers(0, 4))):  # mutations incl. dense
            p = int(rng.integers(0, n))
            reads[b, p] = (reads[b, p] + int(rng.integers(1, 4))) % 4
        if b % 3 == 0:
            reads[b, int(rng.integers(0, n))] = 255
    v1 = make_replica_locate(index)
    v2 = make_replica_locate_v2(index, K_seg=B * L)
    u1, o1 = v1(reads)
    u2, o2, n_seg = v2(reads)
    assert int(n_seg) <= B * L
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    for b in range(0, B, 5):
        if np.any(reads[b] > 3):
            continue
        res = index.search(decode_seq(reads[b]))
        got = [(int(np.asarray(u2)[b, w]), int(np.asarray(o2)[b, w]))
               for w in range(L - k + 1)]
        assert got == res.local_offsets, b


@pytest.mark.parametrize("chunk", [6, 8, 11, 40])
def test_replica_v2_chunked_matches_v1(chunk):
    """Chunked phase A (k-1-overlapped chunks as extra lanes) must be
    bit-equal to the in-scan twin for every chunk length, including the
    minimal payload (chunk == k) and chunk == L (no-op)."""
    from finito_tpu.io.seqdb import encode_seq
    from finito_tpu.query.replica import make_replica_locate, make_replica_locate_v2

    rng = np.random.default_rng(52)
    k = 6
    unitigs = gen_dspss(rng, 12, 12, 60, k)
    index = build_index(unitigs, k)
    B, L = 16, 40
    reads = np.full((B, L), 255, np.uint8)
    for b in range(B):
        u = encode_seq(unitigs[int(rng.integers(len(unitigs)))].encode())
        n = min(u.size, L)
        reads[b, :n] = u[:n]
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, n))
            reads[b, p] = (reads[b, p] + int(rng.integers(1, 4))) % 4
        if b % 4 == 0:  # invalid chars straddling chunk seams
            reads[b, int(rng.integers(0, L))] = 255
    v1 = make_replica_locate(index)
    v2 = make_replica_locate_v2(index, K_seg=B * L, chunk=chunk)
    u1, o1 = v1(reads)
    u2, o2, n_seg = v2(reads)
    assert int(n_seg) <= B * L
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))


@pytest.mark.parametrize("chunk", [6, 9, 39])
def test_stream_chunked_matches_unchunked(chunk):
    """Chunked chain scan + verification equals the unchunked stream
    pipeline (and both equal definitive statuses on every window)."""
    import jax.numpy as jnp

    from finito_tpu.io.seqdb import encode_seq
    from finito_tpu.ops.rank24 import (
        build_contract_k_table,
        build_edge_table,
        build_lcs_jump_tables,
        build_rank24_tables,
    )
    from finito_tpu.ops.streaming import make_chain_stream_ranks

    rng = np.random.default_rng(53)
    k = 6
    unitigs = gen_dspss(rng, 12, 12, 60, k)
    index = build_index(unitigs, k)
    tab = jnp.asarray(build_rank24_tables(index.sbwt.bit_rows()))
    n8 = tab.shape[0] // 4
    C = jnp.asarray(index.sbwt.get_C_array(), dtype=jnp.int32)
    ck_np = build_contract_k_table(index.LCS, k)
    ck = jnp.asarray(ck_np)
    jl_np, jr_np = build_lcs_jump_tables(index.LCS)
    jl, jr = jnp.asarray(jl_np), jnp.asarray(jr_np)
    edge = jnp.asarray(
        build_edge_table(index.sbwt.bit_rows(), index.sbwt.get_C_array(), ck_np)
    )
    B, L = 16, 40
    reads = np.full((B, L), 255, np.uint8)
    for b in range(B):
        u = encode_seq(unitigs[int(rng.integers(len(unitigs)))].encode())
        n = min(u.size, L)
        reads[b, :n] = u[:n]
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, n))
            reads[b, p] = (reads[b, p] + int(rng.integers(1, 4))) % 4
    K = B * (L - k + 1)
    base = make_chain_stream_ranks(n8, k, index.sbwt.number_of_subsets(), K)
    ch = make_chain_stream_ranks(n8, k, index.sbwt.number_of_subsets(), K, chunk=chunk)
    r0, n0 = base(tab, C, ck, jl, jr, edge, jnp.asarray(reads))
    r1, n1 = ch(tab, C, ck, jl, jr, edge, jnp.asarray(reads))
    assert int(n0) <= K and int(n1) <= K
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))


@pytest.mark.parametrize("mode", ["stream", "replica"])
def test_engine_long_reads_trigger_auto_chunk(mode):
    """An explicit chunk shorter than the reads exercises the chunked
    chain inside DeviceQueryEngine (auto_chunk always scans whole
    reads); the oracle is the arbiter."""
    rng = np.random.default_rng(54)
    k = 10
    unitigs = gen_dspss(rng, 10, 70, 120, k)
    index = build_index(unitigs, k)
    engine = DeviceQueryEngine(index, mode=mode, chunk=24)
    reads = []
    for _ in range(6):
        u = unitigs[int(rng.integers(len(unitigs)))]
        s = list(u)
        for _m in range(int(rng.integers(0, 4))):
            s[int(rng.integers(0, len(s)))] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(s).encode())
    reads.append(("".join(rng.choice(list("ACGT"), 130))).encode())
    out = engine.process_reads(reads)
    for read, (f, _r) in zip(reads, out):
        want = index.search(read)
        assert f.local_offsets == want.local_offsets, read


@pytest.mark.parametrize("mode", ["stream", "replica"])
def test_one_hop_round_output_equal(monkeypatch, mode):
    """FINITO_HOP_ROUNDS=1 (one jl/jr gather pair per repair iteration;
    multi-hop widens stall an extra iteration) must be output-identical
    to the 2-round form on mutation-heavy reads."""
    monkeypatch.setenv("FINITO_HOP_ROUNDS", "1")
    rng = np.random.default_rng(4242)
    k = 11
    unitigs = gen_dspss(rng, 12, 40, 80, k)
    index = build_index(unitigs, k)
    engine = DeviceQueryEngine(index, mode=mode)
    genome = "".join(unitigs)
    B, L = 24, 64
    reads = []
    for _ in range(B):
        a = int(rng.integers(0, len(genome) - L))
        s = list(genome[a : a + L])
        for _m in range(int(rng.integers(0, 5))):  # clustered mutations
            p = int(rng.integers(0, L))
            s[p] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(s))
    for q in reads:
        got = engine.search_fwd_rc(q.encode())[0]
        want = index.search(q.encode())
        assert got.local_offsets == want.local_offsets, q


@pytest.mark.parametrize("mode", ["stream", "replica"])
def test_two_class_repair_output_equal(monkeypatch, mode):
    """FINITO_REPAIR_SPLIT=1 (separate fast/preamble segment loops)
    must be output-identical to the default single mixed loop."""
    monkeypatch.setenv("FINITO_REPAIR_SPLIT", "1")
    rng = np.random.default_rng(777)
    k = 11
    unitigs = gen_dspss(rng, 12, 40, 80, k)
    index = build_index(unitigs, k)
    engine = DeviceQueryEngine(index, mode=mode)
    genome = "".join(unitigs)
    L = 64
    for _ in range(16):
        a = int(rng.integers(0, len(genome) - L))
        s = list(genome[a : a + L])
        for _m in range(int(rng.integers(0, 6))):
            s[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
        q = "".join(s).encode()
        got = engine.search_fwd_rc(q)[0]
        want = index.search(q)
        assert got.local_offsets == want.local_offsets, q
