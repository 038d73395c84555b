"""Two-phase streaming k-mer rank engine: optimistic chain + repair.

A data-dependent while_loop inside every lax.scan step serializes the
batch on its slowest lane, so the reference's streaming recovery loop
(common.hh:116-126) is not transplanted per-step. Instead:

Phase A -- "chain" scan (make_chain_opt, no inner loops): a hybrid
automaton per lane. Immature lanes track the SBWT interval of
seq[ks..j] (2 rank gathers/step); at the first window close the lane
follows the precomputed forward-edge table (1 gather/step,
critical-path depth 1). Any failure marks a k-wide shadow of positions
UNTRUSTED and resets the lane.

Phase B -- segment repair (make_segment_repair): untrusted RUNS are
compacted to one lane each (split every Q payload positions), seeded
from the trusted predecessor's post-close slide state where possible,
and walked ONCE with the reference's exact recovery state machine
(plateau-jump drops + LCS-widening hops) in a fixed-trip scan plus a
rare straggler while_loop.

Both phases are dominated by table gathers, so the design minimizes
GATHERED ELEMENTS per decided window, not op count (a premise still to
be profiled on the H100, ROADMAP Queue 1 #5).

Output equals ops.bitvec.kmer_ranks_fixed exactly (tested).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from finito_tpu.ops.rank24 import update_interval24

UNKNOWN = -2


def blocked_cumsum_i32(x):
    """Inclusive cumsum of a flat int32 array via a 2-level blocked scan.

    Reshapes to (rows, 128), scans rows in parallel, then runs a short
    scan over row totals. Kept from the previous target, where a long
    1-D cumsum lowered to a serial chain; whether it still beats a
    plain jnp.cumsum on the GPU is open (ROADMAP Queue 3 #5). Pads
    internally; returns the same length as x."""
    n = x.size
    C = 128
    rows = -(-n // C)
    xp = jnp.zeros(rows * C, jnp.int32).at[:n].set(x.astype(jnp.int32))
    m = xp.reshape(rows, C)
    within = jnp.cumsum(m, axis=1)  # parallel across rows
    row_tot = within[:, -1]
    row_off = jnp.cumsum(row_tot) - row_tot  # short 1-D scan (rows elems)
    return (within + row_off[:, None]).reshape(-1)[:n]


def _nth_set_bit32(x, r):
    """Position of the r-th (0-based) set bit of uint32 x, elementwise.
    Binary descend over 16/8/4/2/1-bit halves: 5 VPU rounds, no gathers.
    Undefined (but in [0,32)) when r >= popcount(x)."""
    x = x.astype(jnp.uint32)
    r = r.astype(jnp.int32)
    pos = jnp.zeros_like(r)
    for half in (16, 8, 4, 2, 1):
        lo_mask = jnp.uint32((1 << half) - 1)
        c = lax.population_count(x & lo_mask).astype(jnp.int32)
        go_hi = r >= c
        r = r - jnp.where(go_hi, c, 0)
        pos = pos + jnp.where(go_hi, half, 0)
        x = jnp.where(go_hi, x >> jnp.uint32(half), x & lo_mask)
    return pos


def compact_mask(mask, K: int):
    """Indices of the first K set positions of a flat bool mask, padded
    with -1, plus the true count.

    Select-based: instead of scattering every mask element, this form
    scatters one element per 32-position BLOCK (mask.size/32 elements),
    forward-fills block ownership over the K output slots with a
    cummax, and converts each slot's within-block rank to a position
    with an in-register nth-set-bit descend: ~mask.size/32 scattered +
    2K gathered elements total. The sink indices are unique (one per
    non-empty block below K; the rest land in the dropped slot K), so
    the scatter has a defined result on every backend. Chosen on the
    previous target; an H100 A/B against jnp.nonzero(size=K) is open
    (ROADMAP Queue 3 #5)."""
    n_el = mask.size
    if n_el == 0:
        return jnp.full(K, -1, jnp.int32), jnp.int32(0)
    nb = -(-n_el // 32)
    mp = jnp.zeros(nb * 32, jnp.bool_).at[:n_el].set(mask.reshape(-1))
    w = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    bits = jnp.sum(jnp.where(mp.reshape(nb, 32), w, jnp.uint32(0)),
                   axis=1, dtype=jnp.uint32)
    cnt = lax.population_count(bits).astype(jnp.int32)
    inc = blocked_cumsum_i32(cnt)
    n = inc[-1]
    pos = inc - cnt  # exclusive: first output ordinal of each block
    sink = jnp.where((cnt > 0) & (pos < K), pos, K)
    blk = jnp.full(K, -1, jnp.int32).at[sink].set(
        jnp.arange(nb, dtype=jnp.int32), mode="drop"
    )
    blk = lax.cummax(blk)  # owner of slot j: last block with pos <= j
    safe = jnp.maximum(blk, 0)
    r = jnp.arange(K, dtype=jnp.int32) - jnp.take(pos, safe)
    bit = _nth_set_bit32(jnp.take(bits, safe), r)
    out = safe * 32 + bit
    valid = (blk >= 0) & (jnp.arange(K, dtype=jnp.int32) < n)
    return jnp.where(valid, out, -1), n


AUTO_CHUNK_LANES = 8192  # provisional: re-derive by an H100 sweep (ROADMAP Queue 1 #7)


def auto_chunk(k: int, B: int, L: int) -> int:
    """Default chain-scan chunk length: 0 = scan whole reads, always.

    Provisional policy from the previous target, where the scan was
    gather-throughput-bound and chunking (which multiplies gathered
    elements by the k-1-overlap factor, ~2x at chunk ~2k) lost at every
    batch size; the H100 sweep is ROADMAP Queue 1 #7. Chunking stays
    available via an explicit chunk= for latency-over-throughput cases
    (exactness is unaffected; chunked == unchunked is tested)."""
    del k, B, L
    return 0


def n_chunks(L: int, k: int, C: int) -> int:
    """Chunks of length C with k-1 overlap covering a length-L read."""
    S = C - k + 1
    return -(-(L - (k - 1)) // S)


def chunk_reads(codes, k: int, C: int):
    """(B, L) codes -> (B * n_ch, C) overlapping chunks, stride C-k+1,
    positions past L padded with 255 (invalid).

    The chain state at any MATURE position is a function of the last k
    characters only (each close contracts to the (k-1)-suffix), so a
    chunk seeded k-1 characters early reproduces the full-read chain at
    every payload position; chunk-local immaturity lands entirely in the
    discarded overlap. Trusted chunk values are self-certifying: a
    mature close IS the k-mer's interval computed from the empty string,
    and a mature failure IS an empty k-mer interval, regardless of what
    the full-read chain tracked there. Chunking shortens the sequential
    scan ~L/C times at the cost of (C/(C-k+1))x gather elements -- a
    win only when the scan is latency- not throughput-bound (see
    auto_chunk)."""
    B, L = codes.shape
    if not (k <= C <= L):
        raise ValueError(f"need k <= chunk <= L (k={k}, chunk={C}, L={L})")
    S = C - k + 1
    idx = jnp.arange(n_chunks(L, k, C), dtype=jnp.int32)[:, None] * S + jnp.arange(
        C, dtype=jnp.int32
    )[None, :]
    ch = jnp.take(codes, jnp.minimum(idx, L - 1), axis=1)  # (B, n_ch, C)
    ch = jnp.where(idx[None, :, :] < L, ch, jnp.uint8(255).astype(codes.dtype))
    return ch.reshape(B * idx.shape[0], C)


def unchunk_grid(grid_ch, B: int, L: int, k: int, C: int):
    """(B * n_ch, C) per-position grid -> (B, L): chunk 0 contributes
    its first k-1 positions, every chunk its payload [k-1, C)."""
    S = C - k + 1
    g = grid_ch.reshape(B, -1, C)
    head = g[:, 0, : k - 1]
    payload = g[:, :, k - 1 :].reshape(B, -1)
    return jnp.concatenate([head, payload], axis=1)[:, :L]


def make_chain_scan(n8: int, k: int, n_nodes: int):
    """Phase A. run(tab, C, contract_k, edge, codes): (B, L) codes ->
    (B, L) per-position status: rank >= 0 found, -1 definitively absent,
    -2 unknown (positions < k-1 are meaningless and set to -1 by the
    caller's slice). Index arrays are call ARGUMENTS so jitted callers
    don't embed them as HLO constants (breaks remote compiles at scale).

    Hybrid automaton: an IMMATURE lane tracks the SBWT interval of
    seq[ks..j] (2 rank gathers/step) exactly like the reference's
    streaming scan; at the first window close it hands the singleton to
    the MATURE mode, which follows the precomputed forward-edge table
    (ops.rank24.build_edge_table, 1 gather/step, critical-path depth 1).
    The two modes emit bit-identical values (a mature close IS the edge
    transition: contract-to-(k-1)-suffix + extend == edge[4x+c]); on any
    failure the lane resets to immature with ks = j+1."""

    def step(tab, C, contract_k, edge, carry, c):
        def upd(c, lo, hi):
            return update_interval24(tab, n8, C, c, lo, hi)

        lo, hi, ks, x, j = carry  # interval of seq[ks..j-1]; x >= 0 <=> mature
        invalid = c > 3
        em = x >= 0
        # mature path: one gather, depth-1 sequential dependency
        xe = jnp.take(edge, jnp.where(em, x * 4 + jnp.where(invalid, 0, c), 0))
        e_found = em & ~invalid & (xe >= 0)
        # immature path (also runs for mature lanes on safe indices)
        nlo, nhi = upd(c, lo, hi)
        failed = invalid | (nlo < 0)
        had_full_context = ks == j - k + 1  # chain length entering was k-1
        close = ~em & ~failed & (j - ks + 1 == k)

        emit_i = jnp.where(
            close,
            nlo,
            jnp.where(failed & had_full_context & ~invalid, -1, UNKNOWN),
        )
        emit_i = jnp.where(invalid, -1, emit_i)
        # mature lanes always have full context: found or definitive absent
        emit = jnp.where(em, jnp.where(e_found, xe, -1), emit_i)

        # next mature node: edge transition, or immature close's singleton
        x2 = jnp.where(e_found, xe, jnp.where(close, nlo, -1))
        # immature carry: extend on success, reset on failure; parked at
        # the full interval while mature (never consulted, kept safe)
        any_fail = jnp.where(em, ~e_found, failed)
        lo2 = jnp.where(failed | em, 0, nlo)
        hi2 = jnp.where(failed | em, n_nodes - 1, nhi)
        ks2 = jnp.where(any_fail, j + 1, jnp.where(em | close, j - k + 2, ks))
        return (lo2, hi2, ks2, x2, j + 1), emit

    def run(tab, C, contract_k, edge, codes):
        B, L = codes.shape
        init = (
            jnp.zeros(B, jnp.int32),
            jnp.full(B, n_nodes - 1, jnp.int32),
            jnp.zeros(B, jnp.int32),
            jnp.full(B, -1, jnp.int32),
            jnp.int32(0),
        )
        _, emitted = lax.scan(
            lambda carry, c: step(tab, C, contract_k, edge, carry, c),
            init,
            codes.astype(jnp.int32).T,
        )
        return emitted.T  # (B, L); window ending at j -> start j-k+1

    return run


def make_chain_opt(n8: int, k: int, n_nodes: int, aug: bool = False):
    """Optimistic hybrid chain producing repairable untrusted RUNS.

    run(tab, C, edge, codes) -> (emit, cand, untrusted), each (B, L):
      emit:  >= 0 trusted node rank of the k-mer ending at j; -1 trusted
             definitive absent; -2 meaningless (covered by untrusted or
             by the pre-window prefix j < k-1).
      cand:  -1 none; else the singleton node of the longest tracked
             suffix ending at j -- raw (< 2^24) at immature positions,
             or, when `aug` (edge built by rank24.build_edge_aug_table),
             the augmented (su << 25 | ustart << 24 | node) entry at
             mature positions.
      untrusted: position needs exact repair (make_segment_repair). The
             bound is j - k <= lastfail: one position PAST the k-1
             post-failure shadow, so the re-maturing immature close is
             repaired too and every trusted position >= k is either
             mature (augmented) or -1 -- the invariant the replica tail's
             gather-free candidate unpack relies on.

    Same hybrid automaton as the reference's streaming scan collapsed to
    a forward-edge table (ref common.hh:78-186, see build_edge_table):
    immature lanes track the SBWT interval (2 rank gathers/step); at the
    first window close the lane follows edge[4x + c] (1 gather/step).
    """
    NEG = jnp.int32(-1)

    def run(tab, C, edge, codes):
        def upd(c, lo, hi):
            return update_interval24(tab, n8, C, c, lo, hi)

        B, L = codes.shape

        def step(carry, c):
            lo, hi, ks, x, lastfail, j = carry
            invalid = c > 3
            em = x >= 0  # mature: x = node of the k-mer ending at j-1
            xe_raw = jnp.take(edge, jnp.where(em, x * 4 + jnp.where(invalid, 0, c), 0))
            e_found = em & ~invalid & (xe_raw >= 0)
            xe = (xe_raw & ((1 << 24) - 1)) if aug else xe_raw
            nlo, nhi = upd(c, lo, hi)
            failed = invalid | (nlo < 0)
            mature = ks == j - k + 1
            close = ~em & ~failed & (j - ks + 1 == k)
            emit_i = jnp.where(
                close, nlo, jnp.where(failed & mature & ~invalid, NEG, jnp.int32(UNKNOWN))
            )
            emit_i = jnp.where(invalid, NEG, emit_i)
            emit = jnp.where(em, jnp.where(e_found, xe, NEG), emit_i)
            single_i = ~failed & (nlo == nhi)
            cand = jnp.where(
                em,
                jnp.where(e_found, xe_raw, NEG),
                jnp.where(single_i, nlo, NEG),
            )
            any_fail = jnp.where(em, ~e_found, failed)
            lastfail2 = jnp.where(any_fail, j, lastfail)
            untrusted = j - k <= lastfail2

            x2 = jnp.where(e_found, xe, jnp.where(close, nlo, jnp.int32(-1)))
            lo2 = jnp.where(failed | em, 0, nlo)
            hi2 = jnp.where(failed | em, n_nodes - 1, nhi)
            ks2 = jnp.where(any_fail, j + 1, jnp.where(em | close, j - k + 2, ks))
            return (lo2, hi2, ks2, x2, lastfail2, j + 1), (emit, cand, untrusted)

        init = (
            jnp.zeros(B, jnp.int32),
            jnp.full(B, n_nodes - 1, jnp.int32),
            jnp.zeros(B, jnp.int32),
            jnp.full(B, -1, jnp.int32),
            jnp.full(B, -(k + 2), jnp.int32),
            jnp.int32(0),
        )
        _, outs = lax.scan(step, init, codes.astype(jnp.int32).T)
        return tuple(o.T for o in outs)  # each (B, L)

    return run


def make_segment_repair(
    n8: int, k: int, n_nodes: int, K_seg: int, Q: int | None = None,
    aug: bool = False,
):
    """Exact repair of untrusted runs with the reference's recovery
    state machine (drop_first_char widening, ref common.hh:116-127),
    restructured from the round-4 form for gather throughput and
    while-loop trip count:

      * a RUN-START segment at p_start >= k needs no warm-up: its
        predecessor position is always a trusted FOUND window (a trusted
        -1 is impossible -- a failure marks its own position untrusted),
        so the exact chain state entering p_start is the post-close
        slide (ks = p_start-k+1, interval = contract_k[emit[p_start-1]])
        -- one row gather replaces the k-1-step from-scratch preamble
        that dominated the round-4 repair's trip count;
      * an optional two-class form (FINITO_REPAIR_SPLIT=1) classifies
        segments before compaction and runs the fast-seeded class for
        only Q + stall trips at full width and the preamble class
        (read-head runs, continuation splits) at quarter width; the
        default is the single mixed loop, which won on the previous
        target. Both are kept output-identical for retuning;
      * runs are SPLIT every Q payload positions (the state at any
        position is a function of the last k-1 characters, so a split
        re-derives context from a k-1 preamble exactly like
        chunk_reads); trip count is bounded by ~k-1+Q regardless of how
        long a run a clustered-failure read produces;
      * per-step values land in (K_seg, Q) lane-local buffers scattered
        into the (B, L) grids ONCE after the loop instead of scattering
        the full B*L arrays every iteration;
      * the untrusted flag rides bit 8 of the character gather (one
        packed gather per iteration instead of separate code and
        trust-boundary gathers), and the LCS-widening hops only run on
        iterations where some lane is mid-recovery (lax.cond skip).

    run(tab, C, ck, jl, jr, suu, codes, emit, cand, untrusted) ->
    (emit2, cand2, n_seg); results valid only when n_seg <= K_seg.
    With `aug`, repaired cand values are written in the augmented
    (su << 25 | ustart << 24 | node) form (one K_seg-sized suu gather
    per iteration) so the caller's candidate unpack stays gather-free.
    """
    if Q is None:
        Q = k + 1  # an isolated failure's run is exactly k+1 positions
    NEG = jnp.int32(-1)
    import os as _os

    # Tuning knobs with provisional defaults from the previous target's
    # A/B (single mixed loop, 2 hop rounds); the H100 sweep is ROADMAP
    # Queue 1 #7. Both forms are output-identical (tested).
    HOP_ROUNDS = int(_os.environ.get("FINITO_HOP_ROUNDS", "2"))
    REPAIR_SPLIT = _os.environ.get("FINITO_REPAIR_SPLIT", "0") == "1"

    def run(tab, C, ck, jl, jr, suu, codes, emit, cand, untrusted):
        def upd(c, lo, hi):
            return update_interval24(tab, n8, C, c, lo, hi)

        B, L = codes.shape
        u = untrusted
        # bit 8 of the packed stream = untrusted flag at that position
        pk = codes.reshape(-1).astype(jnp.int32) | (
            u.reshape(-1).astype(jnp.int32) << 8
        )
        prev = jnp.concatenate([jnp.zeros((B, 1), jnp.bool_), u[:, :-1]], axis=1)
        is_start = u & ~prev
        jpos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
        # run starts are increasing within a read, so a cummax propagates
        # each run's start over the run; split every Q positions
        rs = lax.cummax(jnp.where(is_start, jpos, -1), axis=1)
        split = u & ((jpos - rs) % Q == 0)

        # Segment compaction: default is ONE mixed loop (per-lane fast
        # seeding); FINITO_REPAIR_SPLIT=1 compacts the fast-seeded and
        # preamble classes separately (see the knob comment above for
        # the A/B that picked the default).
        if REPAIR_SPLIT:
            prev_ok = jnp.concatenate(
                [jnp.zeros((B, 1), jnp.bool_), emit[:, :-1] >= 0], axis=1
            )
            fastable = is_start & (jpos >= k) & prev_ok
            K_slow = max(512, K_seg // 4)
            idx_fast, n_fast = compact_mask((split & fastable).reshape(-1), K_seg)
            idx_slow, n_slow = compact_mask((split & ~fastable).reshape(-1), K_slow)
        else:  # single mixed loop (round-5 pre-split form, kept for A/B)
            idx_all, n_all = compact_mask(split.reshape(-1), K_seg)

        def run_class(seg_idx, K_c, T_c, fast_seed):
            sv = seg_idx >= 0
            f_start = jnp.where(sv, seg_idx, 0)
            b_of = f_start // L
            p_start = f_start - b_of * L
            p_end = jnp.minimum(p_start + Q, L)
            if fast_seed:  # True or "mixed" (per-lane select)
                x_prev = jnp.take(emit.reshape(-1), jnp.maximum(f_start - 1, 0))
                run_start = jnp.take(is_start.reshape(-1), f_start)
                fastl = sv & run_start & (p_start >= k) & (x_prev >= 0)
                pair0 = jnp.take(ck, jnp.where(fastl, x_prev, 0), axis=0)
                j0 = jnp.where(fastl, p_start, jnp.maximum(p_start - (k - 1), 0))
                lo0 = jnp.where(fastl, pair0[:, 0], 0)
                hi0 = jnp.where(fastl, pair0[:, 1], n_nodes - 1)
                ks0 = jnp.where(fastl, p_start - k + 1, j0)
            else:
                j0 = jnp.maximum(p_start - (k - 1), 0)
                lo0 = jnp.zeros(K_c, jnp.int32)
                hi0 = jnp.full(K_c, n_nodes - 1, jnp.int32)
                ks0 = j0
            arangeK = jnp.arange(K_c, dtype=jnp.int32)
            return _run_segments(
                sv, f_start, b_of, p_start, p_end, j0, ks0, lo0, hi0,
                arangeK, K_c, T_c,
            )

        def _run_segments(sv, f_start, b_of, p_start, p_end, j0, ks0, lo0,
                          hi0, arangeK, K_c, T_c):
            def body(st):
                j, ks, lo, hi, rec, wx, wy, active, buf_e, buf_c = st
                fj = b_of * L + jnp.minimum(j, L - 1)
                pc = jnp.where(active, jnp.take(pk, fj), 0)
                c = pc & 0xFF
                # retire lanes that walked past their payload or onto a
                # trusted position (recovering lanes sit on untrusted ones)
                active = active & (j < p_end) & ((j <= p_start) | (pc >= 256))
                invalid = active & (c > 3)
                mid = active & (rec > 0)  # rec: 0 none, 1 fresh drop, 2 hopping

                # --- recovery: plateau-jump drops + LCS-widening hops ------
                # Suffix lengths inside one LCS plateau share the interval,
                # so the one-at-a-time drop loop (ref common.hh:116-127)
                # re-fails the identical extension until the next plateau;
                # jumping straight to max(LCS[lo], LCS[hi+1]) -- the largest
                # length that changes the interval -- is output-equivalent
                # and visits only distinct intervals (~3-5 per failure vs up
                # to k). The jump length comes free from the first hop
                # gathers. Two hop rounds per iteration; a deeper widen
                # stalls its lane one more iteration instead of running
                # widen_interval's two inner while_loops here.
                def hop_branch(ops):
                    x, y, ks_in = ops
                    el0 = jnp.take(jl, jnp.where(mid, x, 0))
                    er0 = jnp.take(jr, jnp.where(mid, y, 0))
                    lcsL = (el0 & jnp.uint32(0xFF)).astype(jnp.int32)
                    lcsR = (er0 & jnp.uint32(0xFF)).astype(jnp.int32)
                    fresh = mid & (rec == 1)
                    nlen = jnp.where(fresh, jnp.maximum(lcsL, lcsR), j - ks_in)
                    ks2 = jnp.where(fresh, j - nlen, ks_in)
                    hl = mid & (x > 0) & (lcsL >= nlen)
                    x = jnp.where(hl, x - (el0 >> jnp.uint32(8)).astype(jnp.int32), x)
                    hr = mid & (y < n_nodes) & (lcsR >= nlen)
                    y = jnp.where(hr, y + (er0 >> jnp.uint32(8)).astype(jnp.int32), y)
                    if HOP_ROUNDS < 2:
                        # one jl/jr gather pair per iteration: a lane whose
                        # widen needs 2+ hops stalls one more iteration
                        # (rare); halves the hop branch's gather elements
                        return x, y, hl, hr, ks2, nlen
                    el = jnp.take(jl, jnp.where(mid, x, 0))
                    er = jnp.take(jr, jnp.where(mid, y, 0))
                    hl2 = mid & (x > 0) & ((el & jnp.uint32(0xFF)).astype(jnp.int32) >= nlen)
                    x = jnp.where(hl2, x - (el >> jnp.uint32(8)).astype(jnp.int32), x)
                    hr2 = mid & (y < n_nodes) & ((er & jnp.uint32(0xFF)).astype(jnp.int32) >= nlen)
                    y = jnp.where(hr2, y + (er >> jnp.uint32(8)).astype(jnp.int32), y)
                    return x, y, hl2, hr2, ks2, nlen

                def hop_skip(ops):
                    x, y, ks_in = ops
                    f = jnp.zeros_like(mid)
                    return x, y, f, f, ks_in, j - ks_in

                x2, y2, hl, hr, ks_h, nlen = lax.cond(
                    jnp.any(mid), hop_branch, hop_skip, (wx, wy, ks)
                )
                zero_len = mid & (nlen <= 0)  # widen to the empty suffix: full
                done = (mid & ~hl & ~hr) | zero_len
                still = mid & ~done
                lo_c = jnp.where(done, jnp.where(zero_len, 0, x2), lo)
                hi_c = jnp.where(done, jnp.where(zero_len, n_nodes - 1, y2 - 1), hi)

                # --- extension (stalled lanes excluded; completed widens
                # retry with the same character this iteration) ---
                can_ext = active & ~still
                nlo, nhi = upd(jnp.where(invalid, 0, c), lo_c, hi_c)
                ok = can_ext & ~invalid & (nlo >= 0)
                fail = can_ext & ~invalid & (nlo < 0)
                emptied = fail & (ks_h >= j)   # empty suffix failed: consume c
                start_w = fail & ~emptied      # fresh drop: jump next round

                single = ok & (nlo == nhi)
                close = ok & (j - ks_h + 1 == k)
                advance = active & (ok | invalid | emptied)
                write = advance & (j >= p_start)
                rank_j = jnp.where(close, nlo, NEG)
                if aug:
                    sw = jnp.take(suu, jnp.where(single, nlo, 0)).astype(jnp.int32)
                    cand_j = jnp.where(
                        single,
                        ((sw & 0xFF) << 25) | ((sw >> 8) << 24) | nlo,
                        NEG,
                    )
                else:
                    cand_j = jnp.where(single, nlo, NEG)
                loc = jnp.where(write, j - p_start, Q)
                # lane-local buffers: row arangeK is unique per lane, so
                # every (row, loc) target is unique (loc == Q is dropped)
                buf_e = buf_e.at[arangeK, loc].set(rank_j, mode="drop")
                buf_c = buf_c.at[arangeK, loc].set(cand_j, mode="drop")

                pair = jnp.take(ck, jnp.where(close, nlo, 0), axis=0)
                lo2 = jnp.where(close, pair[:, 0], jnp.where(ok, nlo, lo_c))
                hi2 = jnp.where(close, pair[:, 1], jnp.where(ok, nhi, hi_c))
                lo3 = jnp.where(invalid | emptied, 0, lo2)
                hi3 = jnp.where(invalid | emptied, n_nodes - 1, hi2)
                ks2 = jnp.where(close, ks_h + 1, ks_h)
                ks3 = jnp.where(invalid | emptied, j + 1, ks2)

                wx2 = jnp.where(start_w, lo_c, jnp.where(still, x2, wx))
                wy2 = jnp.where(start_w, hi_c + 1, jnp.where(still, y2, wy))
                rec2 = jnp.where(start_w, 1, jnp.where(still, 2, 0)).astype(jnp.int32)
                j2 = jnp.where(advance, j + 1, j)
                return j2, ks3, lo3, hi3, rec2, wx2, wy2, active, buf_e, buf_c

            st = (
                j0,
                ks0,
                lo0,
                hi0,
                jnp.zeros(K_c, jnp.int32),
                jnp.zeros(K_c, jnp.int32),
                jnp.zeros(K_c, jnp.int32),
                sv,
                jnp.full((K_c, Q + 1), NEG, jnp.int32),
                jnp.full((K_c, Q + 1), NEG, jnp.int32),
            )
            # Fixed-trip scan covers the class's bounded walk (payload,
            # plus the k-1 preamble for the slow class, plus a stall
            # allowance for recovery retries), so the common case never
            # evaluates a dynamic cond. The rare stall-heavy
            # lanes (clustered drops, deep widens) finish in a straggler
            # while_loop that usually sees zero active lanes.
            st = lax.scan(lambda s, _: (body(s), None), st, None, length=T_c)[0]
            st = lax.while_loop(lambda s: jnp.any(s[7]), body, st)
            jf, buf_e, buf_c = st[0], st[8], st[9]
            cols = jnp.arange(Q, dtype=jnp.int32)[None, :]
            wrote = sv[:, None] & (cols < (jf - p_start)[:, None])
            idx = jnp.where(wrote, f_start[:, None] + cols, B * L)
            return idx, buf_e[:, :Q], buf_c[:, :Q]

        stall = int(_os.environ.get("FINITO_REPAIR_STALL", "8"))
        if REPAIR_SPLIT:
            i1, be1, bc1 = run_class(idx_fast, K_seg, Q + stall, True)
            i2, be2, bc2 = run_class(idx_slow, K_slow, (k - 1) + Q + stall, False)
            emit2 = (
                emit.reshape(-1)
                .at[i1].set(be1, mode="drop")
                .at[i2].set(be2, mode="drop")
                .reshape(B, L)
            )
            cand2 = (
                cand.reshape(-1)
                .at[i1].set(bc1, mode="drop")
                .at[i2].set(bc2, mode="drop")
                .reshape(B, L)
            )
            # single capacity contract: valid iff n_fast <= K_seg AND
            # n_slow <= K_slow; fold both into one reported count so the
            # caller's "n_seg <= K" check and frac-resize keep working
            n_rep = jnp.maximum(
                n_fast, (n_slow * K_seg + K_slow - 1) // K_slow
            )
            return emit2, cand2, n_rep
        i1, be1, bc1 = run_class(idx_all, K_seg, (k - 1) + Q + stall, "mixed")
        emit2 = emit.reshape(-1).at[i1].set(be1, mode="drop").reshape(B, L)
        cand2 = cand.reshape(-1).at[i1].set(bc1, mode="drop").reshape(B, L)
        return emit2, cand2, n_all


    return run


def make_chain_stream_ranks(n8: int, k: int, n_nodes: int, K: int, chunk: int | None = None):
    """Fully device-resident two-phase rank pipeline (single dispatch).

    Returns run(tab, C, contract_k, jl, jr, edge, codes) -> ((B, W)
    ranks, n_seg). K bounds the number of repaired SEGMENTS (untrusted
    runs split at 2k payload positions, see make_segment_repair); if
    n_seg > K the caller MUST re-run with a larger K (unrepaired windows
    must never be reported). n_seg also lets callers right-size K for
    steady-state workloads.

    Round-4 form verified each UNKNOWN window independently (2k gathers
    per window); since every absent window is unknown to the optimistic
    chain, an absent-heavy batch (14% at the bench's 0.5% mutation rate)
    cost ~60 ms/batch in verification alone. The segment repair walks
    each untrusted RUN once with the exact recovery automaton instead:
    ~2 gathers per repaired position, and a k-1-window of absent k-mers
    is one ~2k-step segment, not 30 independent 62-gather verifies.

    chunk (None = auto: auto_chunk at trace time from the batch shape;
    0 = whole reads) splits each read into k-1-overlapped chunks scanned
    as extra lanes (see chunk_reads); exactness is unaffected, untrusted
    runs can only grow (chunk-local failures), and every untrusted
    position is re-derived exactly by the repair."""
    chain = make_chain_opt(n8, k, n_nodes, aug=False)
    repair = make_segment_repair(n8, k, n_nodes, K, aug=False)

    def run(tab, C, contract_k, jl, jr, edge, codes):
        B, L = codes.shape
        W = L - k + 1
        eff = auto_chunk(k, B, L) if chunk is None else chunk
        if k <= eff < L:
            emit, cand, untrusted = (
                unchunk_grid(g, B, L, k, eff)
                for g in chain(tab, C, edge, chunk_reads(codes, k, eff))
            )
        else:
            emit, cand, untrusted = chain(tab, C, edge, codes)
        emit, _, n_seg = repair(
            tab, C, contract_k, jl, jr, None, codes, emit, cand, untrusted
        )
        return emit[:, k - 1 :], n_seg

    return run
