"""Device (JAX) query path for the minimizer seed-and-verify index.

Two locate forms, selected by the engine on the descriptor table's size
(a provisional switch from the previous target, ROADMAP Queue 1 #6-#7):

make_minimizer_locate (v1, small indexes) -- per (B, W) window batch,
entirely divergence-free on the fast path:

  1. minimizer value+offset per window   -- rolling VPU ops, 0 gathers
  2. FUSED slot row (descriptor + the single-occurrence candidate
     payload in one (n, 4) row)          -- 1 row gather
  3. packed-text verification            -- 1 overlapped-row gather
                                            (k <= 32; rolling words above)

  (= 2 dependent big-table gathers per window; with slot_rows absent --
  forced v1 on a genome-scale index -- the narrow-desc fallback splits
  step 2 into descriptor + payload gathers, the round-2 form.)

make_minimizer_locate_v2 (genome-scale indexes) -- the same pipeline
with steps 2-3 RUN-DEDUPLICATED (once per minimizer run, ~(k-m+2)/2
windows) and a run-level slow path; see its docstring.

Multi-occurrence slots (hash collisions or repeated minimizers, ~1/load
factor of windows) are compacted and resolved by an exact candidate-scan
while_loop bounded by the slot's stored length -- no key compares: a
wrong-value candidate simply fails the text compare, and the true
occurrence always lives in its own value's slot. Output is identical to
FinimizerIndex.search / the SBWT engines: (uid, off) or (-1, -1).

Design notes: batched device-memory gathers are the scarce resource;
everything else here (rolling packs, sliding min, funnel shifts,
compares) is elementwise work that XLA fuses between the gathers.
The reference resolves the same query through rank/select on succinct
bitvectors (FinimizerIndex.hh:119-185) -- the array-gather form is the
device re-design, not a translation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from finito_tpu.index.minimizer import MinimizerIndex, _MIX2
from finito_tpu.ops.streaming import compact_mask


MIX32 = 0x9E3779B1  # must match index.minimizer.mix32 (selection order)


def mix32_device(v):
    """Device twin of index.minimizer.mix32 (hashed minimizer order)."""
    return (v * jnp.uint32(MIX32)) ^ (v >> jnp.uint32(16))


def slot32_device(v):
    """Device twin of index.minimizer.slot32 (slot addressing)."""
    return (v * jnp.uint32(int(_MIX2))) ^ (v >> jnp.uint32(13))


def minimizer_scan(c, k: int, m: int):
    """Shared leftmost-lowest minimizer selection over all windows of a
    batch: (B, L) uint32 codes -> (best_v, best_o, bad), each (B, W):
    the window's minimizer VALUE (2-bit packed, first char most
    significant), its offset within the window, and whether ANY char of
    the window is non-ACGT (pad/invalid chars have code > 3; their
    masked 2-bit residue may participate in mv, so a bad window's value
    is meaningless and the caller must mask downstream use -- the one
    place this rule lives, shared by the v1/v2 engines and the mesh
    locate so their bad-masking cannot drift).

    Selection order is mix32(value) ("random minimizers"), strict < so
    ties keep the leftmost -- identical to the host build
    (index.minimizer.build). Zero gathers: rolling packs + R-1
    vectorized compare passes, all VPU work."""
    B, L = c.shape
    W = L - k + 1
    R = k - m + 1
    nm = L - m + 1
    mv = jnp.zeros((B, nm), jnp.uint32)
    bad_m = jnp.zeros((B, nm), jnp.bool_)
    for i in range(m):
        ci = lax.dynamic_slice_in_dim(c, i, nm, axis=1)
        mv = (mv << jnp.uint32(2)) | (ci & jnp.uint32(3))
        bad_m = bad_m | (ci > 3)
    hv = mix32_device(mv)
    best_v = lax.dynamic_slice_in_dim(mv, 0, W, axis=1)
    best_h = lax.dynamic_slice_in_dim(hv, 0, W, axis=1)
    best_o = jnp.zeros((B, W), jnp.int32)
    bad = lax.dynamic_slice_in_dim(bad_m, 0, W, axis=1)
    for r in range(1, R):
        cand_v = lax.dynamic_slice_in_dim(mv, r, W, axis=1)
        cand_h = lax.dynamic_slice_in_dim(hv, r, W, axis=1)
        upd = cand_h < best_h  # strict: keeps the leftmost minimum
        best_v = jnp.where(upd, cand_v, best_v)
        best_h = jnp.where(upd, cand_h, best_h)
        best_o = jnp.where(upd, r, best_o)
        bad = bad | lax.dynamic_slice_in_dim(bad_m, r, W, axis=1)
    return best_v, best_o, bad


def pack_query_windows(c, k: int):
    """(B, L) uint32 codes -> list of ceil(2k/32) (B, W) uint32 words:
    every k-window 2-bit packed in TEXT bit order (base i at bits
    [2i, 2i+2) of word i//16) for XOR comparison against the packed
    unitig text. Shared by the single-chip engines and the mesh locate."""
    B, L = c.shape
    W = L - k + 1
    q_words = []
    for w in range((2 * k + 31) // 32):
        qw = jnp.zeros((B, W), jnp.uint32)
        for i in range(16 * w, min(16 * (w + 1), k)):
            ci = lax.dynamic_slice_in_dim(c, i, W, axis=1) & jnp.uint32(3)
            qw = qw | (ci << jnp.uint32(2 * (i - 16 * w)))
        q_words.append(qw)
    return q_words


def initial_capacities(BW: int, use_v2: bool, slow_divisor: int | None = None):
    """Starting (K_slow, K_heads) for a (B*W)-window dispatch. v2's K
    bounds slow RUNS (~windows / run-length fewer than slow windows), so
    its divisor is larger. Callers needing more slow headroom (e.g. the
    occurrence-counting kmer-mapper path, which scans slots to the end)
    pass a smaller slow_divisor."""
    if slow_divisor is None:
        slow_divisor = 256 if use_v2 else 32
    return max(256, BW // slow_divisor), max(1024, BW // 6)


def grow_capacities(K: int, KH: int, n_slow: int, n_heads: int, BW: int):
    """Shared resize policy after a dispatch: None if (K, KH) was
    sufficient, else the next (K, KH) to retry with (K x4, KH doubled or
    jumped straight to the observed head count). Raises once capacities
    are already at the B*W ceiling -- overflow there means the counters
    are wrong, not the sizing. One place, used by the engine's verify
    loop and kmer_mapper's, so the growth rule cannot drift."""
    if n_slow <= K and n_heads <= KH:
        return None
    if K >= BW and KH >= BW:
        raise AssertionError("slow-path overflow at K == B*W")
    if n_slow > K:
        K = min(BW, K * 4)
    if n_heads > KH:
        KH = min(BW, max(KH * 2, n_heads))
    return K, KH


def build_occ_rows(mindex: MinimizerIndex) -> np.ndarray:
    """(n_occ, 4) int32 candidate payload rows (gstart, uid, off, uend):
    one row gather per candidate check."""
    n_occ = int(mindex.occ_key.size)
    if not n_occ:
        return np.zeros((0, 4), np.int32)
    ends32 = np.asarray(mindex.ends, dtype=np.int32)
    uend = ends32[np.asarray(mindex.occ_uid)]
    return np.stack(
        [
            np.asarray(mindex.occ_gstart, np.int32),
            np.asarray(mindex.occ_uid, np.int32),
            np.asarray(mindex.occ_off, np.int32),
            uend,
        ],
        axis=1,
    )


def build_text_rows(words: np.ndarray) -> np.ndarray:
    """Overlapped stride-2 rows of 4 words over the packed text (k <= 32):
    any <= 3-word window is one row gather (2x text memory)."""
    n2 = (words.size - 2) // 2
    rows = np.lib.stride_tricks.sliding_window_view(words, 4)[: 2 * n2 : 2]
    return np.ascontiguousarray(rows)


def build_text_rows8(words: np.ndarray) -> np.ndarray:
    """Overlapped stride-4 rows of 8 words (32 < k <= 64): any <= 5-word
    window is one row gather (2x text memory)."""
    n4 = (words.size - 4) // 4
    rows = np.lib.stride_tricks.sliding_window_view(words, 8)[: 4 * n4 : 4]
    return np.ascontiguousarray(rows)


def pack_text_words(concat: np.ndarray, pad_words: int = 2) -> np.ndarray:
    """2-bit pack host codes into uint32 words, base j at bits [2j, 2j+2)
    of the word stream (sdsl/PackedStrings bit order); pad_words extra
    zero words so rolling window loads at the last base stay in bounds."""
    n = concat.size
    n_words = (2 * n + 31) // 32 + pad_words
    bits = np.zeros(n_words * 16, dtype=np.uint32)  # 16 bases per word
    bits[:n] = concat
    by = bits.reshape(n_words, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (by << shifts).sum(axis=1, dtype=np.uint32)


def build_slot_rows(mindex: MinimizerIndex) -> np.ndarray:
    """(2^h + 1, 4) int32 FUSED slot rows: descriptor and single-
    occurrence payload in one row, so the v1 fast path costs ONE
    big-table gather instead of two dependent ones (desc -> payload).

    Row encoding, discriminated by column 1:
      * single-occurrence slot (col1 = uid >= 0): the payload row
        [gstart, uid, off, uend] embedded directly -- no second gather;
      * empty slot: col1 = -1;
      * multi-occurrence slot (col1 = -len <= -2): col0 = start index
        into occ_rows; the compacted slow path scans [start, start+len).

    2x the descriptor-table memory (16 vs 8 bytes/slot); built only for
    indexes under the v1 size threshold."""
    starts = (np.asarray(mindex.desc) >> np.uint64(_DESC_LEN_BITS)).astype(np.int64)
    lens = np.diff(starts)  # exact per-slot occupancy (2^h,)
    rows = np.zeros((lens.size + 1, 4), np.int32)
    rows[:, 1] = -1  # empty
    single = np.nonzero(lens == 1)[0]
    idx = starts[single]
    uid = np.asarray(mindex.occ_uid, np.int32)[idx]
    rows[single, 0] = np.asarray(mindex.occ_gstart, np.int32)[idx]
    rows[single, 1] = uid
    rows[single, 2] = np.asarray(mindex.occ_off, np.int32)[idx]
    rows[single, 3] = np.asarray(mindex.ends, np.int32)[uid]
    multi = np.nonzero(lens >= 2)[0]
    rows[multi, 0] = starts[multi]
    rows[multi, 1] = -lens[multi]
    return rows


_DESC_LEN_BITS = 6  # must match index.minimizer._LEN_BITS
_SLOT_ROWS_MAX_DESC_BYTES = 64 << 20  # the engine's v1/v2 switch point


def desc_to_rows(desc: np.ndarray) -> np.ndarray:
    """Host packed slot descriptors -> (2^h + 1, 2) int32 rows
    [start, exact_len].

    The host-packed scalar desc widens to uint64 past 2^26 occurrences,
    and jnp.asarray would silently truncate uint64 -> uint32 with x64
    disabled; explicit 32-bit planes are always exact (starts < n_occ <
    2^31). A real 2-column row layout also makes the descriptor ONE row
    gather (XLA splits a slice_sizes=(2,) gather on a scalar table into
    two), and the exact length column (successive-start difference, not
    the 6-bit saturated stored length) kills the slow-path
    next-slot-start gather."""
    from finito_tpu import native

    rows = native.desc_to_rows_native(np.asarray(desc), _DESC_LEN_BITS)
    if rows is not None:
        return rows
    starts = (np.asarray(desc) >> np.uint64(6)).astype(np.int64)
    rows = np.empty((starts.size, 2), dtype=np.int32)
    rows[:, 0] = starts
    rows[:-1, 1] = np.diff(starts)
    rows[-1, 1] = 0
    return rows


@jax.tree_util.register_pytree_node_class
class DeviceMinimizerIndex:
    """Device-resident arrays of a MinimizerIndex (a pytree, so jitted
    locate functions take it as an ARGUMENT -- closure-captured arrays
    would be serialized into the HLO as literal constants, which breaks
    remote compilation for big indexes).

    Row packing (chosen on the previous target, where a (n, 4) row
    gather cost ~1.45x a scalar one; H100 A/B open, ROADMAP Queue 3 #5):
    the candidate payload (gstart, uid, off, uend) is one row, and for
    k <= 32 the packed text
    is stored as OVERLAPPED stride-2 rows of 4 words (2x text memory,
    2 bits -> 4 bits/base) so any <= 3-word window is one row gather."""

    def tree_flatten(self):
        leaves = (self.desc, self.occ_rows, self.ends, self.text, self.text_rows,
                  self.slot_rows)
        return leaves, (self.k, self.m, self.n_occ, self.h)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = cls.__new__(cls)
        (obj.desc, obj.occ_rows, obj.ends, obj.text, obj.text_rows,
         obj.slot_rows) = leaves
        obj.k, obj.m, obj.n_occ, obj.h = aux
        return obj

    def __init__(self, mindex: MinimizerIndex):
        if int(mindex.concat.size) >= (1 << 31):
            raise ValueError(
                "unitig text exceeds int32 single-chip addressing (2^31 "
                "bases); use the tp-sharded form "
                "(parallel.mesh.ShardedMinimizerIndex.build) whose "
                "per-shard texts stay int32-addressable"
            )
        self.k = mindex.k
        self.m = mindex.m
        self.h = mindex.h
        self.n_occ = int(mindex.occ_key.size)
        desc_rows = desc_to_rows(mindex.desc)
        self.desc = jnp.asarray(desc_rows)
        # fused slot rows only in the v1 size regime (2x desc memory;
        # v2's per-head gathers keep the narrow desc at genome scale)
        self.slot_rows = (
            jnp.asarray(build_slot_rows(mindex))
            if desc_rows.nbytes < _SLOT_ROWS_MAX_DESC_BYTES
            else None
        )
        self.occ_rows = jnp.asarray(build_occ_rows(mindex))
        self.ends = jnp.asarray(np.asarray(mindex.ends, dtype=np.int32))
        words = pack_text_words(mindex.concat, _n_words(mindex.k) + 5)
        self.text = jnp.asarray(words)
        if mindex.k <= 32:
            self.text_rows = jnp.asarray(build_text_rows(words))
        elif mindex.k <= 64:
            self.text_rows = jnp.asarray(build_text_rows8(words))
        else:
            self.text_rows = None


def _n_words(k: int) -> int:
    return (2 * k + 31) // 32


def _word_masks(k: int) -> list:
    """Per-word masks of the valid 2k bits across ceil(2k/32) words."""
    nw = _n_words(k)
    masks = [np.uint32(0xFFFFFFFF)] * nw
    rem = 2 * k - 32 * (nw - 1)
    if rem < 32:
        masks[-1] = np.uint32((1 << rem) - 1)
    return masks


def _match_text_kmer(text, g, q_words, masks, k):
    """Compare the k-mer at text base position g with the packed query
    window q_words (list of (B, W) uint32). Rolling funnel-shifted word
    loads: ceil(2k/32) + 1 gathers total, any k."""
    bit = g.astype(jnp.uint32) << jnp.uint32(1)
    w0 = (bit >> jnp.uint32(5)).astype(jnp.int32)
    sh = bit & jnp.uint32(31)
    nz = sh > 0
    inv = jnp.where(nz, jnp.uint32(32) - sh, jnp.uint32(0))
    prev = jnp.take(text, w0)
    match = None
    for w, mask in enumerate(masks):
        cur = jnp.take(text, w0 + w + 1)
        assembled = (prev >> sh) | jnp.where(nz, cur << inv, jnp.uint32(0))
        ok_w = ((assembled ^ q_words[w]) & mask) == 0
        match = ok_w if match is None else (match & ok_w)
        prev = cur
    return match


def _match_text_kmer_rows(text_rows, g, q_words, masks):
    """k <= 32 fast form: ONE overlapped-row gather supplies the (up to)
    three words any 64-bit window can span."""
    bit = g.astype(jnp.uint32) << jnp.uint32(1)
    w0 = (bit >> jnp.uint32(5)).astype(jnp.int32)
    sh = bit & jnp.uint32(31)
    row = jnp.take(text_rows, w0 >> 1, axis=0)  # (..., 4): words [2r, 2r+4)
    odd = (w0 & 1) == 1
    t0 = jnp.where(odd, row[..., 1], row[..., 0])
    t1 = jnp.where(odd, row[..., 2], row[..., 1])
    t2 = jnp.where(odd, row[..., 3], row[..., 2])
    nz = sh > 0
    inv = jnp.where(nz, jnp.uint32(32) - sh, jnp.uint32(0))
    lo = (t0 >> sh) | jnp.where(nz, t1 << inv, jnp.uint32(0))
    match = ((lo ^ q_words[0]) & masks[0]) == 0
    if len(masks) > 1:
        hi = (t1 >> sh) | jnp.where(nz, t2 << inv, jnp.uint32(0))
        match = match & (((hi ^ q_words[1]) & masks[1]) == 0)
    return match


def _match_text_kmer_rows8(text_rows8, g, q_words, masks):
    """32 < k <= 64 form: ONE overlapped (n,8)-row gather supplies the
    (up to) five words any <= 128-bit window can span; the in-row word
    offset (0..3) resolves with select chains."""
    bit = g.astype(jnp.uint32) << jnp.uint32(1)
    w0 = (bit >> jnp.uint32(5)).astype(jnp.int32)
    sh = bit & jnp.uint32(31)
    row = jnp.take(text_rows8, w0 >> 2, axis=0)  # (..., 8): words [4r, 4r+8)
    o = w0 & 3

    def pick(i):
        v = row[..., i]
        for d in (1, 2, 3):
            v = jnp.where(o == d, row[..., i + d], v)
        return v

    nz = sh > 0
    inv = jnp.where(nz, jnp.uint32(32) - sh, jnp.uint32(0))
    match = None
    prev = pick(0)
    for w, mask in enumerate(masks):
        cur = pick(w + 1)
        assembled = (prev >> sh) | jnp.where(nz, cur << inv, jnp.uint32(0))
        ok_w = ((assembled ^ q_words[w]) & mask) == 0
        match = ok_w if match is None else (match & ok_w)
        prev = cur
    return match


def _check_candidate(dmi: "DeviceMinimizerIndex", idx, o, q_words, masks, k):
    """Verify occurrence `idx` against the query window whose minimizer
    offset is `o`. One (n,4) payload row gather + one text gather (row
    form for k <= 64). Returns (match, uid, off)."""
    row = jnp.take(dmi.occ_rows, idx, axis=0)  # (..., 4)
    g_m, uid, off_m, uend = row[..., 0], row[..., 1], row[..., 2], row[..., 3]
    g_w = g_m - o
    off_w = off_m - o
    ok = (off_w >= 0) & (g_w + k <= uend)
    g_safe = jnp.maximum(g_w, 0)
    if dmi.text_rows is not None and k <= 32:
        match = ok & _match_text_kmer_rows(dmi.text_rows, g_safe, q_words, masks)
    elif dmi.text_rows is not None:
        match = ok & _match_text_kmer_rows8(dmi.text_rows, g_safe, q_words, masks)
    else:
        match = ok & _match_text_kmer(dmi.text, g_safe, q_words, masks, k)
    return match, uid, off_w


def make_minimizer_locate_v2(
    dmi: DeviceMinimizerIndex, K_slow: int, K_heads: int, count_occurrences: bool = False
):
    """Run-deduplicated locate: big-table gathers once per minimizer RUN,
    including the TEXT VERIFICATION.

    The minimizer position of sliding windows is NON-DECREASING within a
    read (leftmost-lowest sliding minimum), so consecutive windows
    sharing a minimizer occurrence form contiguous runs of ~(k-m+2)/2
    windows. The slot descriptor and candidate payload depend only on the
    run's minimizer value, so v2 compacts run HEADS (one cumsum gives
    both the head ordinals and the compaction targets) and performs the
    desc + payload gathers per head (~6-8x fewer touches of the
    index-sized tables).

    Text verification ALSO runs per head (round 3): the run's candidate
    text span of k + R - 1 bases is gathered once (ceil span words + 1
    word gathers from the UN-duplicated packed text) and compared against
    the read span; each window's verdict falls out of the mismatch bitmap
    under a STATIC per-(t, word) mask -- the same machinery the
    multi-occurrence slow path uses per candidate. Windows then receive
    (uid, off0, match-bitmap) through one small-table row gather and
    decode their own bit: ZERO big-table touches per window. Exactness is
    untouched (every window's full k-mer is still compared to the text).

    Returns (uid, off, n_slow, n_heads); results are valid only when
    n_slow <= K_slow AND n_heads <= K_heads (caller resizes otherwise).
    Meant for big descriptor tables; for small ones the v1 per-window
    form has less overhead (engine picks per size).
    """
    k, m = dmi.k, dmi.m
    R = k - m + 1
    masks = _word_masks(k)
    NW = len(masks)
    n_occ = dmi.n_occ

    def run(dmi, codes):
        B, L = codes.shape
        W = L - k + 1
        c = codes.astype(jnp.uint32)

        best_v, best_o, bad = minimizer_scan(c, k, m)

        # ---- run heads: pm = in-read m-mer position of the minimizer;
        # non-decreasing, so one cumsum yields head ordinals AND the
        # head -> flat-window compaction
        from finito_tpu.ops.streaming import blocked_cumsum_i32

        pm = best_o + jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
        head = jnp.concatenate(
            [jnp.ones((B, 1), jnp.bool_), pm[:, 1:] != pm[:, :-1]], axis=1
        ).reshape(-1)
        ord_flat = blocked_cumsum_i32(head.astype(jnp.int32)) - 1  # head ordinal per window
        n_heads = ord_flat[-1] + 1
        BW = B * W
        head_pos = jnp.full((K_heads,), 0, jnp.int32)
        head_pos = head_pos.at[jnp.where(head, ord_flat, K_heads)].set(
            jnp.arange(BW, dtype=jnp.int32), mode="drop"
        )

        R_run = k - dmi.m + 1  # max windows sharing one minimizer
        NW_SPAN = (2 * (k + R_run - 1) + 31) // 32 + 1
        NB = (R_run + 31) // 32  # match-bitmap words per run

        # ---- per-head gathers (the only touches of the big tables)
        # NOTE: no bad-masking here -- badness is PER WINDOW and can
        # differ inside a run (a pad char in the head window only); the
        # slot hash is always in range, a good window sharing the head's
        # pm shares its true minimizer value, and per-window `ln` is
        # zeroed by `bad` after redistribution.
        h_v = jnp.take(best_v.reshape(-1), head_pos)
        slot = (slot32_device(h_v) >> jnp.uint32(32 - dmi.h)).astype(jnp.int32)
        d = jnp.take(dmi.desc, slot, axis=0)  # (K_heads, 2) row gather
        h_start = d[:, 0]
        h_ln = d[:, 1]  # exact slot length (not saturated)
        row = jnp.take(dmi.occ_rows, jnp.where(h_ln == 1, h_start, 0), axis=0)

        # ---- packed read words (16 chars/word, LSB-first) + per-HEAD
        # read span words: the k + R - 1 chars starting at the head
        # window's first char, shared by the run-level fast verify and
        # the multi-occurrence slow path
        NL = (L + 15) // 16 + NW_SPAN + 1
        cp = jnp.pad(c & jnp.uint32(3), ((0, 0), (0, NL * 16 - L)))
        rw = (
            cp.reshape(B, NL, 16)
            << (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
        ).sum(axis=2, dtype=jnp.uint32).reshape(-1)
        hb_of = head_pos // W
        hw0c = head_pos - hb_of * W  # span starts at the run's first window char
        hrbase = hb_of * NL + (hw0c >> 4)
        hrsh = (2 * (hw0c & 15)).astype(jnp.uint32)
        hrnz = hrsh > 0
        hrinv = jnp.where(hrnz, jnp.uint32(32) - hrsh, jnp.uint32(0))
        span_read_h = []
        prev_r = jnp.take(rw, hrbase)
        for iw in range(NW_SPAN):
            cur_r = jnp.take(rw, hrbase + iw + 1)
            span_read_h.append(
                (prev_r >> hrsh) | jnp.where(hrnz, cur_r << hrinv, jnp.uint32(0))
            )
            prev_r = cur_r
        o_h_all = jnp.take(best_o.reshape(-1), head_pos)

        # static masks: chars [t, t+k) of the span, mismatch bits at even
        # positions (char j -> bit 2j of word (2j)>>5)
        masks_np = np.zeros((R_run, NW_SPAN), np.uint32)
        for t in range(R_run):
            for j in range(t, t + k):
                masks_np[t, (2 * j) >> 5] |= np.uint32(1 << ((2 * j) & 31))
        MASKS = jnp.asarray(masks_np)  # (R_run, NW_SPAN), tiny constant
        t_idx = jnp.arange(R_run, dtype=jnp.int32)[None, :]

        # ---- run-level FAST verify (single-occurrence heads): compare
        # the candidate text span against the read span once per head;
        # window t's verdict = zero mismatch bits under MASKS[t]
        g_m_h, uid_h, off_m_h, uend_h = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
        g0_h = g_m_h - o_h_all
        off0_h = off_m_h - o_h_all
        g2h = g0_h * 2
        htw0 = g2h >> 5  # arithmetic shift = floor (g0 may be negative)
        htsh = (g2h & 31).astype(jnp.uint32)
        htnz = htsh > 0
        htinv = jnp.where(htnz, jnp.uint32(32) - htsh, jnp.uint32(0))
        cnt_h = jnp.zeros((K_heads, R_run), jnp.int32)
        prev_t = jnp.take(dmi.text, jnp.maximum(htw0, 0))
        for iw in range(NW_SPAN):
            cur_t = jnp.take(dmi.text, jnp.maximum(htw0 + iw + 1, 0))
            tw = (prev_t >> htsh) | jnp.where(htnz, cur_t << htinv, jnp.uint32(0))
            x = tw ^ span_read_h[iw]
            mm = (x | (x >> jnp.uint32(1))) & jnp.uint32(0x55555555)
            cnt_h = cnt_h + lax.population_count(
                mm[:, None] & MASKS[None, :, iw]
            ).astype(jnp.int32)
            prev_t = cur_t
        vt_h = (off0_h[:, None] + t_idx >= 0) & (
            g0_h[:, None] + t_idx + k <= uend_h[:, None]
        )
        match_h = (h_ln == 1)[:, None] & vt_h & (cnt_h == 0)  # (K_heads, R_run)
        mb = []  # bitmap words: bit t of word t>>5
        for wdi in range(NB):
            ts = slice(32 * wdi, min(32 * (wdi + 1), R_run))
            bitw = (
                match_h[:, ts].astype(jnp.uint32)
                << jnp.arange(ts.stop - ts.start, dtype=jnp.uint32)[None, :]
            ).sum(axis=1, dtype=jnp.uint32).astype(jnp.int32)
            mb.append(bitw)
        head_table = jnp.stack(
            [h_ln, uid_h, off0_h, head_pos, *mb], axis=1
        )  # (K_heads, 4 + NB) int32, a few MB -- fast to gather from

        # ---- redistribute to windows: one small-table row gather; each
        # window decodes its own bit -- no big-table touch per window
        wrow = jnp.take(head_table, jnp.minimum(ord_flat, K_heads - 1), axis=0)
        ln = jnp.where(bad, 0, wrow[:, 0].reshape(B, W))
        uid_w = wrow[:, 1].reshape(B, W)
        off0_w = wrow[:, 2].reshape(B, W)
        t_w = jnp.clip(
            jnp.arange(BW, dtype=jnp.int32) - wrow[:, 3], 0, R_run - 1
        ).reshape(B, W)
        mbits = wrow[:, 4]
        for wdi in range(1, NB):
            mbits = jnp.where((t_w.reshape(-1) >> 5) == wdi, wrow[:, 4 + wdi], mbits)
        bit = (
            mbits.astype(jnp.uint32) >> (t_w.reshape(-1) & 31).astype(jnp.uint32)
        ).astype(jnp.int32).reshape(B, W)
        found_f = (ln == 1) & ((bit & 1) == 1)
        neg = jnp.int32(-1)
        uid = jnp.where(found_f, uid_w, neg)
        off = jnp.where(found_f, off0_w + t_w, neg)

        # ---- slow path, RUN-LEVEL: slow-ness is a property of the RUN
        # (its minimizer's slot), so slow runs are compacted on the HEAD
        # domain (~R fewer lanes than windows, and no second full-domain
        # compaction), and each candidate occurrence is verified against
        # the run's whole text span at once -- per-window matches fall
        # out of a mismatch bitmap with STATIC per-(t, word) masks.
        valid_h = jnp.arange(K_heads, dtype=jnp.int32) < n_heads
        sh_idx, n_slow = compact_mask(valid_h & (h_ln >= 2), K_slow)
        sh_valid = sh_idx >= 0
        sj = jnp.where(sh_valid, sh_idx, 0)
        s_start = jnp.take(h_start, sj)
        # exact slot end from the length column (no next-slot gather)
        s_end = jnp.minimum(s_start + jnp.take(h_ln, sj), jnp.int32(n_occ))
        f0 = jnp.take(head_pos, sj)  # first window of the run (flat)
        nxt = jnp.take(head_pos, jnp.minimum(sj + 1, K_heads - 1))
        r_len = jnp.clip(
            jnp.where(sj + 1 < n_heads, nxt, jnp.int32(BW)) - f0, 0, R_run
        )
        o_h = jnp.take(o_h_all, sj)  # head window's minimizer offset
        span_read = [jnp.take(srw, sj) for srw in span_read_h]

        base_live = sh_valid[:, None] & (t_idx < r_len[:, None])

        def cond(st):
            i, uid_s, off_s, cnt_s, done_s = st
            scanning = sh_valid & (i < s_end)
            if not count_occurrences:
                scanning = scanning & jnp.any(base_live & ~done_s, axis=1)
            return jnp.any(scanning)

        def body(st):
            i, uid_s, off_s, cnt_s, done_s = st
            active = sh_valid & (i < s_end)
            ci = jnp.where(active, i, 0)
            row = jnp.take(dmi.occ_rows, ci, axis=0)  # (K_slow, 4)
            g_m, uid_m, off_m, uend = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
            g0 = g_m - o_h
            off0 = off_m - o_h
            # g0 can be NEGATIVE (candidate offset below the head's
            # minimizer offset); signed floor word/base keeps the span
            # ALIGNED, and each word fetch clamps individually -- the
            # garbage words land only on span chars before text start,
            # which belong to t values the validity check rejects.
            g2 = g0 * 2
            tw0 = g2 >> 5  # arithmetic shift = floor
            tsh = (g2 & 31).astype(jnp.uint32)
            tnz = tsh > 0
            tinv = jnp.where(tnz, jnp.uint32(32) - tsh, jnp.uint32(0))
            cntm = jnp.zeros((K_slow, R_run), jnp.int32)
            prev_t = jnp.take(dmi.text, jnp.maximum(tw0, 0))
            for iw in range(NW_SPAN):
                cur_t = jnp.take(dmi.text, jnp.maximum(tw0 + iw + 1, 0))
                tw = (prev_t >> tsh) | jnp.where(tnz, cur_t << tinv, jnp.uint32(0))
                x = tw ^ span_read[iw]
                mm = (x | (x >> jnp.uint32(1))) & jnp.uint32(0x55555555)
                cntm = cntm + lax.population_count(
                    mm[:, None] & MASKS[None, :, iw]
                ).astype(jnp.int32)
                prev_t = cur_t
            vt = (off0[:, None] + t_idx >= 0) & (
                g0[:, None] + t_idx + k <= uend[:, None]
            )
            match = active[:, None] & base_live & vt & (cntm == 0)
            newhit = match & (cnt_s == 0)
            uid_s = jnp.where(newhit, uid_m[:, None], uid_s)
            off_s = jnp.where(newhit, off0[:, None] + t_idx, off_s)
            cnt_s = cnt_s + match.astype(jnp.int32)
            if not count_occurrences:
                done_s = done_s | match
            return i + 1, uid_s, off_s, cnt_s, done_s

        uid_s = jnp.full((K_slow, R_run), -1, jnp.int32)
        off_s = jnp.full((K_slow, R_run), -1, jnp.int32)
        cnt_s = jnp.zeros((K_slow, R_run), jnp.int32)
        _, uid_s, off_s, cnt_s, _ = lax.while_loop(
            cond, body, (s_start, uid_s, off_s, cnt_s, ~base_live)
        )

        # scatter run results to their windows (bad windows keep -1/0)
        f_t = f0[:, None] + t_idx
        bad_t = jnp.take(
            bad.reshape(-1), jnp.minimum(f_t, BW - 1).reshape(-1)
        ).reshape(K_slow, R_run)
        sink = jnp.where(base_live & ~bad_t, f_t, BW).reshape(-1)
        uid = uid.reshape(-1).at[sink].set(uid_s.reshape(-1), mode="drop")
        off = off.reshape(-1).at[sink].set(off_s.reshape(-1), mode="drop")
        if not count_occurrences:
            return uid.reshape(best_v.shape), off.reshape(best_v.shape), n_slow, n_heads
        cnt = found_f.astype(jnp.int32)
        cnt = cnt.reshape(-1).at[sink].set(cnt_s.reshape(-1), mode="drop")
        return (
            uid.reshape(best_v.shape),
            off.reshape(best_v.shape),
            n_slow,
            n_heads,
            cnt.reshape(best_v.shape),
        )

    jrun = jax.jit(run)

    def locate(codes):
        return jrun(dmi, codes)

    return locate


def make_minimizer_locate(dmi: DeviceMinimizerIndex, K_slow: int, count_occurrences: bool = False):
    """Returns a JITTED locate: (B, L) codes -> ((B, W) uid, off, n_slow).

    The index pytree rides as a jit ARGUMENT (constants embedded in the
    HLO would blow up remote compilation for big indexes). K_slow bounds
    the compacted multi-occurrence windows resolved on device; results
    are valid only when n_slow <= K_slow (caller re-runs with a larger
    bound otherwise -- same contract as the stream engine).

    With count_occurrences=True a fourth output gives the EXACT number of
    text occurrences of each window's k-mer (all occurrences of one k-mer
    share its minimizer value and therefore its slot, so the slot scan
    sees every one): the device twin of the Rust reference's
    multi-occurrence error check (main.rs:89-92). The slow-path scan then
    always runs to the slot end instead of early-exiting on first hit.
    """
    k, m = dmi.k, dmi.m
    R = k - m + 1
    masks = _word_masks(k)
    NW = len(masks)
    n_occ = dmi.n_occ

    def run(dmi, codes):
        B, L = codes.shape
        W = L - k + 1
        c = codes.astype(jnp.uint32)

        # --- minimizer selection + window validity, zero gathers
        best_v, best_o, bad = minimizer_scan(c, k, m)

        # --- packed query windows (text bit order), any k
        q_words = pack_query_windows(c, k)

        # --- slot lookup: slot = slot32(v) >> (32-h); hash collisions
        # are harmless (the text compare is the arbiter)
        slot = (slot32_device(best_v) >> jnp.uint32(32 - dmi.h)).astype(jnp.int32)
        neg = jnp.int32(-1)
        if dmi.slot_rows is not None:
            # --- FUSED slot row (1 gather): the single-occurrence
            # payload is embedded in the row, so the fast path is just
            # this gather + the text verification -- 2 dependent big-
            # table gathers per window instead of 3
            srow = jnp.take(dmi.slot_rows, jnp.where(bad, 0, slot), axis=0)  # (B, W, 4)
            code = srow[..., 1]
            single = (code >= 0) & ~bad
            ln = jnp.where(bad | (code == neg), 0, jnp.where(single, 1, -code))
            start = srow[..., 0]  # slow path: occ_rows start of multi slots
            g_w = srow[..., 0] - best_o
            off_w = srow[..., 2] - best_o
            ok = single & (off_w >= 0) & (g_w + k <= srow[..., 3])
            g_safe = jnp.maximum(g_w, 0)
            if dmi.text_rows is not None and k <= 32:
                match = ok & _match_text_kmer_rows(dmi.text_rows, g_safe, q_words, masks)
            elif dmi.text_rows is not None:
                match = ok & _match_text_kmer_rows8(dmi.text_rows, g_safe, q_words, masks)
            else:
                match = ok & _match_text_kmer(dmi.text, g_safe, q_words, masks, k)
            found_f = match
            uid = jnp.where(found_f, code, neg)
            off = jnp.where(found_f, off_w, neg)
        else:
            # --- narrow descriptor (big indexes / forced v1): desc row
            # gather, then the payload row gather inside _check_candidate
            d = jnp.take(dmi.desc, jnp.where(bad, 0, slot), axis=0)  # (B, W, 2)
            start = d[..., 0]
            ln = jnp.where(bad, 0, d[..., 1])  # exact slot length
            fast = ln == 1
            idx = jnp.where(fast, start, 0)
            match, uid_f, off_f = _check_candidate(dmi, idx, best_o, q_words, masks, k)
            found_f = fast & match
            uid = jnp.where(found_f, uid_f, neg)
            off = jnp.where(found_f, off_f, neg)

        # --- slow path: multi-occurrence slots, compacted; exact slot
        # lengths bound the scan (no key gathers -- a wrong-value
        # candidate simply fails the text compare)
        slow_mask = (ln >= 2).reshape(-1)
        flat_idx, n_slow = compact_mask(slow_mask, K_slow)
        valid = flat_idx >= 0
        safe = jnp.where(valid, flat_idx, 0)
        s_start = jnp.take(start.reshape(-1), safe)
        # exact slot end from the length column (no next-slot gather)
        s_end = s_start + jnp.take(ln.reshape(-1), safe)
        s_o = jnp.take(best_o.reshape(-1), safe)
        s_qw = [jnp.take(q.reshape(-1), safe) for q in q_words]

        def cond(st):
            i, uid, off, cnt, done = st
            return jnp.any(~done)

        def body(st):
            i, uid, off, cnt, done = st
            in_range = ~done & (i < s_end) & (i < n_occ)
            ci = jnp.where(in_range, i, 0)
            match, uid_c, off_c = _check_candidate(dmi, ci, s_o, s_qw, masks, k)
            hit = in_range & match
            first = hit & (cnt == 0)
            uid = jnp.where(first, uid_c, uid)
            off = jnp.where(first, off_c, off)
            cnt = cnt + hit.astype(jnp.int32)
            if not count_occurrences:
                done = done | hit
            done = done | (i + 1 >= s_end) | (i + 1 >= n_occ)
            return i + 1, uid, off, cnt, done

        i0 = s_start
        uid_s = jnp.full((K_slow,), -1, jnp.int32)
        off_s = jnp.full((K_slow,), -1, jnp.int32)
        cnt_s = jnp.zeros((K_slow,), jnp.int32)
        _, uid_s, off_s, cnt_s, _ = lax.while_loop(
            cond, body, (i0, uid_s, off_s, cnt_s, ~valid)
        )

        BW = uid.size
        scat = jnp.where(valid, flat_idx, BW)
        uid = uid.reshape(-1).at[scat].set(uid_s, mode="drop")
        off = off.reshape(-1).at[scat].set(off_s, mode="drop")
        if not count_occurrences:
            return uid.reshape(best_v.shape), off.reshape(best_v.shape), n_slow
        cnt = found_f.astype(jnp.int32)  # exact: an ln==1 slot holds the
        # k-mer's only possible occurrence (equal values share a slot)
        cnt = cnt.reshape(-1).at[scat].set(cnt_s, mode="drop")
        return (
            uid.reshape(best_v.shape),
            off.reshape(best_v.shape),
            n_slow,
            cnt.reshape(best_v.shape),
        )

    jrun = jax.jit(run)

    def locate(codes):
        return jrun(dmi, codes)

    return locate
