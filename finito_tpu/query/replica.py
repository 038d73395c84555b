"""The "replica" device engine: the reference's exact streaming query on
TPU, resolving positions through the index's own dictionaries -- no dense
per-node position table.

This is FinimizerIndex::search (FinimizerIndex.hh:119-185) +
rarest_fmin_streaming_search (common.hh:78-186) re-shaped for the TPU.
Two forms live here:

  * make_replica_locate_v2 (the production form): two-phase -- the
    shared optimistic chain scan (ops.streaming.make_chain_opt) with no
    inner loops, plus ONE post-scan while_loop repairing compacted,
    split untrusted segments with the exact recovery state machine
    (ops.streaming.make_segment_repair); dictionary resolution fused to
    one row gather per window (build_resolution_table).
  * make_replica_locate (the in-scan reference twin, kept as the
    differential arbiter; 0.86 M q/s): one exact chain scan whose k-mer
    interval evolves exactly like the reference's: extension, and on
    failure LCS-guided left-contraction (drop_first_char,
    common.hh:38-48) until the extension succeeds -- a bounded in-step
    recovery loop over packed LCS jump tables (amortized O(1)
    drops/char, same as the reference), with no restart and no repair
    phase.
  * Finimizer candidates collapse to a closed form: when the interval of
    the scanned suffix is a singleton {x}, the SHORTEST unique suffix
    ending there has length SU[x] = max(LCS[x], LCS[x+1]) + 1 and colex
    exactly x (widening [x,x] past both LCS bounds moves neither side).
    The reference discovers the same value with a shrink-from-the-left
    loop (common.hh:145-154); the closed form is one gather. Candidates
    the reference's greedy interval would not emit are always strictly
    dominated by an emitted in-window candidate (the earlier candidate
    has start >= theirs and strictly smaller length), so the per-window
    (len, colex, end)-minimum -- the reference's monotone deque
    (common.hh:155-163) -- is identical.
  * Rightmost Ustart singleton tracking (common.hh:167) is a running
    carry; per window the branch dictionary is used iff that position is
    at/after the window finimizer's end (FinimizerIndex.hh:158-164),
    else the finimizer dictionary -- NOT an optimization: the finimizer
    dictionary stores one canonical occurrence (last-larger-local-end,
    FinimizerIndex.hh:370-378) and the Ustart rule is what makes the
    arithmetic land on the right occurrence.

Memory = serialized index + derived lookup tables (rank24 of the SBWT
and the fmin/Ustart bitvectors, LCS jump/contract/SU arrays) -- the
compact counterpart of the dense/minimizer engines' position tables.
Output equals FinimizerIndex.search bit-exactly (tested vs the oracle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from finito_tpu.ops.rank24 import (
    _NO_CAND,
    build_contract_k_table,
    build_edge_table,
    build_lcs_jump_tables,
    build_rank24_tables,
    build_su_table,
    build_su_ustart_table,
    update_interval24,
    widen_interval,
)
from finito_tpu.ops.streaming import compact_mask


def rank1(tab, i):
    """Batched rank over a single-bitvector rank24 table (both forms)."""
    mask = (jnp.uint32(1) << (i & 7).astype(jnp.uint32)) - jnp.uint32(1)
    if tab.ndim == 2:  # wide form past 2^24 bits
        e = jnp.take(tab, i >> 3, axis=0)
        return (e[..., 0] + lax.population_count(e[..., 1] & mask)).astype(jnp.int32)
    e = jnp.take(tab, i >> 3)
    return ((e >> jnp.uint32(8)) + lax.population_count(e & mask)).astype(jnp.int32)


def build_uend_table(ends) -> np.ndarray:
    """rank24 table over the unitig-END positions of the concatenated
    text: uid(g_start) == #{ends <= g_start} == rank(g_start + 1) --
    ONE gather, replacing jnp.searchsorted over the ends array whose
    XLA lowering is a ~log2(n_unitigs)-round binary search of gathers
    per window. +0.5 byte per text position (still the compact engine:
    the SBWT rank24 rows alone are 4x that)."""
    e = np.asarray(ends, dtype=np.int64)
    bits = np.zeros(int(e[-1]) + 2 if e.size else 2, dtype=np.uint8)
    bits[e] = 1
    return build_rank24_tables(bits[None, :])


def build_resolution_table(fmin, global_offsets, Ustart, ends) -> "np.ndarray":
    """(n, 2) int32 rows [ustart_gstart, fin_gend]: the branch- and
    finimizer-dictionary lookups (ref common.hh:61-72) with their rank
    indirections precomputed per node, so the query tail resolves a
    window with ONE row gather (plus the uid rank) instead of four
    scalar gathers (rank over Ustart + ends, rank over fmin + offsets).

      ustart_gstart[x] = ends[rank_Ustart(x) - 1] (0 for the first
          unitig): start of the unitig whose first k-mer has colex x;
          meaningful only at Ustart nodes, gather-safe elsewhere.
      fin_gend[x] = global_offsets[rank_fmin(x)]: global end of the
          canonical occurrence of the finimizer with colex x; meaningful
          only at fmin nodes.

    +8 bytes/node of derived tables; replaces the fmin/Ustart rank24
    structures (-1 byte/node) in the query tail."""
    fm = np.asarray(fmin, np.int64)
    us = np.asarray(Ustart, np.int64)
    e = np.asarray(ends, np.int64)
    go = np.asarray(global_offsets, np.int64)
    n = fm.size
    ur = np.cumsum(us) - us  # exclusive rank
    g = np.where(ur > 0, e[np.maximum(ur - 1, 0)] if e.size else 0, 0)
    fr = np.cumsum(fm) - fm
    fe = go[np.clip(fr, 0, max(go.size - 1, 0))] if go.size else np.zeros(n, np.int64)
    return np.stack([g, fe], axis=1).astype(np.int32)


def make_replica_locate_v2(index, K_seg: int = 4096, chunk: int | None = None):
    """Two-phase exact replica: optimistic chain + segment repair.

    Instead of running the reference's drop-recovery `while_loop` inside
    every scan step, the two phases are structured for gather
    throughput:

      * phase A is the shared ops.streaming.make_chain_opt hybrid: 1
        edge gather per mature step, with (SU, Ustart) of the target
        node packed INTO the edge entry (rank24.build_edge_aug_table)
        when the index allows (n < 2^24, k <= 63) -- the candidate grid
        then unpacks with zero additional gathers instead of a full
        (B, L) suu gather;
      * phase B is the shared ops.streaming.make_segment_repair:
        untrusted runs split at 2k payload positions, per-step values in
        (K_seg, 2k) lane-local buffers scattered once, widen hops
        cond-skipped;
      * the dictionary tail resolves both dictionaries with ONE (n, 2)
        row gather (build_resolution_table) instead of four scalar
        gathers, keeping only the uid rank (build_uend_table) and the
        unitig-start gather.

    Output contract: locate(codes) -> (uid, off, n_seg); results are
    valid only when n_seg <= K_seg (caller resizes). Exactness is pinned
    by differential tests vs make_replica_locate (the in-scan reference
    twin) and the host oracle.

    chunk (None = auto, 0/>=L = off) splits each read into
    k-1-overlapped chunks scanned as extra lanes (ops.streaming
    chunk_reads): trusted chunk values are self-certifying and untrusted
    ones hit the same exact repair, so output is unchanged
    (differentially tested)."""
    from finito_tpu.ops.rank24 import (
        EDGE_AUG_MIN,
        EDGE_NODE_MASK,
        build_edge_aug_table,
        can_augment_edges,
    )
    from finito_tpu.ops.streaming import (
        auto_chunk,
        chunk_reads,
        make_chain_opt,
        make_segment_repair,
        n_chunks,
        unchunk_grid,
    )

    k = index.sbwt.get_k()
    n_nodes = index.sbwt.number_of_subsets()
    tab = jnp.asarray(build_rank24_tables(index.sbwt.bit_rows()))
    n8 = tab.shape[0] // 4
    C = jnp.asarray(index.sbwt.get_C_array(), dtype=jnp.int32)
    ck_np = build_contract_k_table(index.LCS, k)
    ck = jnp.asarray(ck_np)
    jl_np, jr_np = build_lcs_jump_tables(index.LCS)
    jl, jr = jnp.asarray(jl_np), jnp.asarray(jr_np)
    suu = jnp.asarray(build_su_ustart_table(index.LCS, index.Ustart))
    ends = jnp.asarray(index.unitigs.ends, dtype=jnp.int32)
    uend_tab = jnp.asarray(build_uend_table(index.unitigs.ends))
    res_tab = jnp.asarray(
        build_resolution_table(
            np.asarray(index.fmin, np.uint8), index.global_offsets,
            np.asarray(index.Ustart, np.uint8), index.unitigs.ends,
        )
    )
    aug = can_augment_edges(n_nodes, k)
    if aug:
        edge = jnp.asarray(
            build_edge_aug_table(
                index.sbwt.bit_rows(), index.sbwt.get_C_array(), ck_np,
                index.LCS, np.asarray(index.Ustart, np.uint8),
            )
        )
    else:
        edge = jnp.asarray(
            build_edge_table(index.sbwt.bit_rows(), index.sbwt.get_C_array(), ck_np)
        )
    params = (tab, C, ck, jl, jr, suu, ends, uend_tab, res_tab, edge)
    NEG = jnp.int32(-1)
    chain = make_chain_opt(n8, k, n_nodes, aug=aug)
    repair = make_segment_repair(n8, k, n_nodes, K_seg, aug=aug)

    def run(P, codes):
        (tab, C, ck, jl, jr, suu, ends, uend_tab, res_tab, edge) = P
        B, L = codes.shape
        W = L - k + 1
        cc_len = auto_chunk(k, B, L) if chunk is None else chunk
        chunked = k <= cc_len < L
        if chunked:
            emit, cand, untrusted = (
                unchunk_grid(g, B, L, k, cc_len)
                for g in chain(tab, C, edge, chunk_reads(codes, k, cc_len))
            )
        else:
            emit, cand, untrusted = chain(tab, C, edge, codes)
        emit, cand, n_seg = repair(
            tab, C, ck, jl, jr, suu, codes, emit, cand, untrusted
        )

        ranks = emit[:, k - 1 :]  # (B, W)
        found = ranks >= 0

        # candidate grids: length, colex, Ustart flag per position
        if aug:
            # augmented cands carry (su, ustart) inline; raw (< 2^25)
            # cands occur only at immature singleton positions, which
            # after the repair are confined to statically known columns:
            # the read head j < k, and, when chunked, each chunk's
            # seeding close at column s*(cc_len-k+1) + k-1 (the chain
            # re-derives context per chunk). Those columns take a small
            # sliced suu gather; everywhere else zero gathers.
            augm = cand >= EDGE_AUG_MIN
            x = jnp.where(augm, cand & EDGE_NODE_MASK, cand)
            cl = jnp.where(augm, cand >> 25, _NO_CAND)
            uf = augm & (((cand >> 24) & 1) == 1)
            cols = list(range(min(k, L)))
            if chunked:
                S = cc_len - k + 1
                cols += [
                    s * S + k - 1
                    for s in range(1, n_chunks(L, k, cc_len))
                    if s * S + k - 1 < L
                ]
            cidx = np.asarray(sorted(set(cols)), np.int32)
            sl = cand[:, cidx]
            raw = (sl >= 0) & (sl < EDGE_AUG_MIN)
            sw = jnp.take(suu, jnp.where(raw, sl, 0)).astype(jnp.int32)
            cl = cl.at[:, cidx].set(
                jnp.where(raw, sw & 0xFF, cl[:, cidx])
            )
            uf = uf.at[:, cidx].set(uf[:, cidx] | (raw & ((sw >> 8) & 1 == 1)))
        else:
            x = cand
            sw = jnp.take(suu, jnp.where(cand >= 0, cand, 0)).astype(jnp.int32)
            cl = jnp.where(cand >= 0, sw & 0xFF, _NO_CAND)
            uf = (cand >= 0) & ((sw >> 8) & 1 == 1)
        cl = jnp.where(cand >= 0, cl, _NO_CAND)

        # rightmost Ustart singleton carry: "last non-null" associative scan
        jpos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
        up0 = jnp.where(uf, jpos, NEG)
        ux0 = jnp.where(uf, x, 0)

        def comb(a, b):
            aj, ax = a
            bj, bx = b
            pick_b = bj >= 0
            return jnp.where(pick_b, bj, aj), jnp.where(pick_b, bx, ax)

        up, ux = lax.associative_scan(comb, (up0, ux0), axis=1)

        cc = jnp.where(cand >= 0, x, 0)
        fin_len = jnp.full((B, W), _NO_CAND, jnp.int32)
        fin_colex = jnp.zeros((B, W), jnp.int32)
        fin_r = jnp.zeros((B, W), jnp.int32)
        for r in range(k):
            cl_r = lax.dynamic_slice_in_dim(cl, r, W, axis=1)
            cc_r = lax.dynamic_slice_in_dim(cc, r, W, axis=1)
            okc = cl_r <= r + 1
            better = okc & ((cl_r < fin_len) | ((cl_r == fin_len) & (cc_r < fin_colex)))
            fin_len = jnp.where(better, cl_r, fin_len)
            fin_colex = jnp.where(better, cc_r, fin_colex)
            fin_r = jnp.where(better, r, fin_r)

        up_w = up[:, k - 1 :]
        ux_w = ux[:, k - 1 :]
        ws = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
        use_branch = found & (up_w >= ws + fin_r)

        # both dictionaries resolve through one precomputed row gather
        ridx = jnp.where(use_branch, ux_w, jnp.where(found, fin_colex, 0))
        rows = jnp.take(res_tab, ridx, axis=0)
        g_end_branch = rows[..., 0] + (k - 1) + ((ws + k - 1) - up_w)
        g_end_fin = rows[..., 1] + ((k - 1) - fin_r)
        g_end = jnp.where(use_branch, g_end_branch, g_end_fin)
        g_start = g_end - k + 1
        # uid via one rank gather on the unitig-end bitvector (see
        # build_uend_table) instead of a log-round searchsorted
        uid = rank1(uend_tab, jnp.where(found, g_start, 0) + 1)
        u_start2 = jnp.where(uid > 0, jnp.take(ends, jnp.maximum(uid - 1, 0)), 0)
        off = g_start - u_start2
        return (
            jnp.where(found, uid, NEG),
            jnp.where(found, off, NEG),
            n_seg,
        )

    jitted = jax.jit(run)

    def locate(codes):
        return jitted(params, jnp.asarray(codes))

    return locate


def make_replica_locate(index):
    """(B, L) codes (np/jnp uint8, pad 255) -> ((B, W) uid, (B, W) off).

    Self-contained: derives its device tables from the loaded index
    (no DeviceSBWT upload; rank runs on the rank24 tables below).
    """
    k = index.sbwt.get_k()
    n_nodes = index.sbwt.number_of_subsets()
    tab = jnp.asarray(build_rank24_tables(index.sbwt.bit_rows()))
    n8 = tab.shape[0] // 4
    C = jnp.asarray(index.sbwt.get_C_array(), dtype=jnp.int32)
    ck = jnp.asarray(build_contract_k_table(index.LCS, k))
    jl_np, jr_np = build_lcs_jump_tables(index.LCS)
    jl, jr = jnp.asarray(jl_np), jnp.asarray(jr_np)
    su = jnp.asarray(build_su_table(index.LCS))
    fmin_tab = jnp.asarray(build_rank24_tables(np.asarray(index.fmin, np.uint8)[None, :]))
    ustart_tab = jnp.asarray(build_rank24_tables(np.asarray(index.Ustart, np.uint8)[None, :]))
    ustart_bits = jnp.asarray(np.asarray(index.Ustart, np.uint8))
    goffs = jnp.asarray(index.global_offsets.astype(np.int64), dtype=jnp.int32)
    ends = jnp.asarray(index.unitigs.ends, dtype=jnp.int32)

    # arrays ride as one jit argument pytree (closure constants would be
    # baked into the HLO, breaking remote compiles for big indexes)
    uend_tab = jnp.asarray(build_uend_table(index.unitigs.ends))
    params = (tab, C, ck, jl, jr, su, fmin_tab, ustart_tab, ustart_bits, goffs, ends, uend_tab)

    # -------- exact chain scan with drop-based recovery ------------------
    def chain(P, codes):
        (tab, C, ck, jl, jr, su, fmin_tab, ustart_tab, ustart_bits, goffs, ends, uend_tab) = P

        def upd(c, lo, hi):
            return update_interval24(tab, n8, C, c, lo, hi)

        B, L = codes.shape

        def step(carry, c):
            lo, hi, ks, up, ux, j = carry
            invalid = c > 3
            nlo, nhi = upd(c, lo, hi)

            # recovery: advance ks + widen until the extension succeeds or
            # the suffix empties (oracle common.hh:116-127). Pads (invalid
            # chars) reset immediately instead of looping.
            def cond(st):
                nlo, nhi, lo, hi, ks, need = st
                return jnp.any(need)

            def body(st):
                nlo, nhi, lo, hi, ks, need = st
                ks2 = jnp.where(need, ks + 1, ks)
                emptied = need & (ks2 > j)
                widen_len = jnp.where(need, j - ks2, jnp.int32(k + 1))
                wlo, whi = widen_interval(jl, jr, lo, hi, widen_len, n_nodes)
                lo2 = jnp.where(need & ~emptied, wlo, lo)
                hi2 = jnp.where(need & ~emptied, whi, hi)
                rlo, rhi = upd(c, lo2, hi2)
                nlo2 = jnp.where(need, rlo, nlo)
                nhi2 = jnp.where(need, rhi, nhi)
                # emptied lanes: interval of the empty string, c unconsumed
                nlo2 = jnp.where(emptied, 0, nlo2)
                nhi2 = jnp.where(emptied, n_nodes - 1, nhi2)
                need2 = need & ~emptied & (rlo < 0)
                return nlo2, nhi2, lo2, hi2, ks2, need2

            failed = nlo < 0
            ks = jnp.where(invalid, j + 1, ks)
            need0 = failed & ~invalid
            nlo, nhi, _, _, ks, _ = lax.while_loop(
                cond, body, (nlo, nhi, lo, hi, ks, need0)
            )
            nlo = jnp.where(invalid, 0, nlo)
            nhi = jnp.where(invalid, n_nodes - 1, nhi)

            # candidate: singleton suffix => shortest unique suffix ends here
            single = (nlo == nhi) & (ks <= j) & ~invalid
            cand_len = jnp.where(
                single, jnp.take(su, jnp.where(single, nlo, 0)).astype(jnp.int32), _NO_CAND
            )
            cand_colex = jnp.where(single, nlo, 0)

            # rightmost Ustart singleton so far (carry over the whole read)
            u_here = single & (jnp.take(ustart_bits, jnp.where(single, nlo, 0)) == 1)
            up2 = jnp.where(u_here, j, up)
            ux2 = jnp.where(u_here, nlo, ux)

            close = (j - ks + 1 == k) & ~invalid
            emit = jnp.where(close, nlo, -1)

            # window slide on close (oracle line 124-125): ks++ and contract
            pair = jnp.take(ck, jnp.where(close, nlo, 0), axis=0)
            lo2 = jnp.where(close, pair[:, 0], nlo)
            hi2 = jnp.where(close, pair[:, 1], nhi)
            ks2 = jnp.where(close, ks + 1, ks)
            return (lo2, hi2, ks2, up2, ux2, j + 1), (emit, cand_len, cand_colex, up2, ux2)

        init = (
            jnp.zeros(B, jnp.int32),
            jnp.full(B, n_nodes - 1, jnp.int32),
            jnp.zeros(B, jnp.int32),
            jnp.full(B, -1, jnp.int32),
            jnp.zeros(B, jnp.int32),
            jnp.int32(0),
        )
        _, outs = lax.scan(step, init, codes.astype(jnp.int32).T)
        return tuple(o.T for o in outs)  # each (B, L)

    # ---------------------------- full locate ----------------------------
    def run(P, codes):
        (tab, C, ck, jl, jr, su, fmin_tab, ustart_tab, ustart_bits, goffs, ends, uend_tab) = P
        B, L = codes.shape
        W = L - k + 1
        emit, cl, cc, up, ux = chain(P, codes)
        ranks = emit[:, k - 1 :]  # (B, W)
        found = ranks >= 0

        # per-window finimizer: (len, colex, end)-min over in-window
        # candidates whose start is inside the window (len <= r + 1)
        fin_len = jnp.full((B, W), _NO_CAND, jnp.int32)
        fin_colex = jnp.zeros((B, W), jnp.int32)
        fin_r = jnp.zeros((B, W), jnp.int32)
        for r in range(k):
            cl_r = lax.dynamic_slice_in_dim(cl, r, W, axis=1)
            cc_r = lax.dynamic_slice_in_dim(cc, r, W, axis=1)
            ok = cl_r <= r + 1  # excludes _NO_CAND (255 > k)
            better = ok & ((cl_r < fin_len) | ((cl_r == fin_len) & (cc_r < fin_colex)))
            fin_len = jnp.where(better, cl_r, fin_len)
            fin_colex = jnp.where(better, cc_r, fin_colex)
            fin_r = jnp.where(better, r, fin_r)

        # rightmost Ustart singleton at the window close, used iff it sits
        # at/after the finimizer end (FinimizerIndex.hh:158-164)
        up_w = up[:, k - 1 :]
        ux_w = ux[:, k - 1 :]
        ws = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
        use_branch = found & (up_w >= ws + fin_r)

        # branch dictionary (common.hh:61-67)
        safe_ux = jnp.where(use_branch, ux_w, 0)
        urank = rank1(ustart_tab, safe_ux)
        u_gstart = jnp.where(urank > 0, jnp.take(ends, jnp.maximum(urank - 1, 0)), 0)
        g_end_branch = u_gstart + (k - 1) + ((ws + k - 1) - up_w)

        # finimizer dictionary (common.hh:69-72)
        safe_fx = jnp.where(found, fin_colex, 0)
        frank = rank1(fmin_tab, safe_fx)
        g_end_fin = jnp.take(goffs, jnp.clip(frank, 0, goffs.shape[0] - 1)) + (
            (k - 1) - fin_r
        )

        g_end = jnp.where(use_branch, g_end_branch, g_end_fin)
        g_start = g_end - k + 1
        uid = rank1(uend_tab, jnp.where(found, g_start, 0) + 1)
        u_start2 = jnp.where(uid > 0, jnp.take(ends, jnp.maximum(uid - 1, 0)), 0)
        off = g_start - u_start2
        neg = jnp.int32(-1)
        return jnp.where(found, uid, neg), jnp.where(found, off, neg)

    jitted = jax.jit(run)

    def locate(codes):
        return jitted(params, jnp.asarray(codes))

    return locate
