"""Multi-device scale-out: (dp, tp) sharding of the query pipeline.

The reference is a single-process CPU program (SURVEY.md section 2.5);
all multi-chip structure here is TPU-native design:

  * dp ("data parallel"): query reads are sharded along the batch axis --
    embarrassingly parallel, rides ICI only for the final gather.
  * tp ("table parallel"): the index's colex axis -- the four bitvectors,
    their rank blocks, and the position table -- is sharded into
    contiguous word-aligned colex ranges, one per tp device. Because
    rank is a prefix sum, a global rank query decomposes into a sum of
    clamped shard-local ranks:

        rank_c(i) = sum_shards rank_c^local(clip(i - start_s, 0, n_s))

    so each extension step is a shard-local gather + one psum over tp --
    no index routing, no host round-trips. The same clamp+psum trick
    gathers from the sharded position table. This is what lets
    pangenome-scale indexes exceed single-chip HBM (BASELINE.json
    configs[4]).

pp/sp/ep axes from the transformer world have no analog here (no
pipeline stages, no attention context, no experts); dp x tp is the
complete parallelism structure of this workload.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from finito_tpu.ops.bitvec import DeviceSBWT


def make_mesh(n_devices: int, tp: int = 2) -> Mesh:
    devices = np.array(jax.devices()[:n_devices])
    if n_devices % tp != 0:
        tp = 1
    dp = n_devices // tp
    return Mesh(devices.reshape(dp, tp), ("dp", "tp"))


@dataclass
class ShardedIndex:
    """Host-side container of per-shard arrays, stacked on a leading tp axis."""

    words: np.ndarray  # (tp, 4, words_per_shard) uint32
    blocks: np.ndarray  # (tp, 4, words_per_shard) int32  (shard-local cumsum)
    loc_table: np.ndarray  # (tp, nodes_per_shard, 2) int32 (unitig id, offset), -1 dummy
    node_start: np.ndarray  # (tp,) int32 first colex rank of each shard
    C: np.ndarray  # (4,) int32
    ends: np.ndarray  # (n_unitigs,) int32 (replicated; small)
    k: int
    n_nodes: int
    words_per_shard: int
    nodes_per_shard: int

    @staticmethod
    def from_index(index, pos_table: np.ndarray, tp: int) -> "ShardedIndex":
        sbwt = index.sbwt
        n = sbwt.number_of_subsets()
        bit_rows = sbwt.bit_rows()
        nodes_per_shard = -(-n // (32 * tp)) * 32  # word-aligned shard width
        words_per_shard = nodes_per_shard // 32
        words = np.zeros((tp, 4, words_per_shard), dtype=np.uint32)
        blocks = np.zeros((tp, 4, words_per_shard), dtype=np.int32)
        loc_sh = np.full((tp, nodes_per_shard, 2), -1, dtype=np.int32)
        node_start = np.zeros(tp, dtype=np.int32)
        from finito_tpu.utils.bits import pack_bits

        # per-colex (uid, offset), resolved once host-side (same tradeoff as
        # engine.build_locate_tables: 2 gathers/k-mer instead of searchsorted)
        k = sbwt.get_k()
        ends64 = np.asarray(index.unitigs.ends, dtype=np.int64)
        g_end = np.asarray(pos_table, dtype=np.int64)
        found = g_end >= 0
        g_start = g_end - k + 1
        uid_all = np.searchsorted(ends64, g_start, side="right").astype(np.int32)
        u_start = np.where(uid_all > 0, ends64[np.maximum(uid_all - 1, 0)], 0)
        off_all = (g_start - u_start).astype(np.int32)
        uid_all = np.where(found, uid_all, -1)
        off_all = np.where(found, off_all, -1)

        for s in range(tp):
            lo = s * nodes_per_shard
            hi = min(n, lo + nodes_per_shard)
            node_start[s] = lo
            if lo >= n:
                continue
            for c in range(4):
                w64 = pack_bits(bit_rows[c, lo:hi])
                w32 = w64.view(np.uint32)[:words_per_shard]
                words[s, c, : w32.size] = w32
                pc = np.bitwise_count(words[s, c]).astype(np.int64)
                blocks[s, c, 1:] = np.cumsum(pc[:-1])
            loc_sh[s, : hi - lo, 0] = uid_all[lo:hi]
            loc_sh[s, : hi - lo, 1] = off_all[lo:hi]
        return ShardedIndex(
            words=words,
            blocks=blocks,
            loc_table=loc_sh,
            node_start=node_start,
            C=np.asarray(sbwt.get_C_array(), dtype=np.int32),
            ends=np.asarray(index.unitigs.ends, dtype=np.int32),
            k=sbwt.get_k(),
            n_nodes=n,
            words_per_shard=words_per_shard,
            nodes_per_shard=nodes_per_shard,
        )

    @staticmethod
    def build(index, tp: int) -> "ShardedIndex":
        """Shard-local construction from a MESH-BUILT index
        (parallel.shard_build.sharded_index_build): the per-colex dense
        position slices were produced as a by-product of the mesh
        finimizer routing (index.mesh_pos), so -- unlike from_index --
        no single-host device build_position_table pass ever runs on
        this path. Host work is slicing + packing
        one target shard at a time."""
        if getattr(index, "mesh_pos", None) is None:
            raise ValueError(
                "ShardedIndex.build needs a mesh-built index "
                "(sharded_index_build attaches index.mesh_pos); for a "
                "loaded index use from_index with a dense pos_table"
            )
        pos_shards, Mn = index.mesh_pos
        sbwt = index.sbwt
        n = sbwt.number_of_subsets()
        k = sbwt.get_k()
        ends64 = np.asarray(index.unitigs.ends, dtype=np.int64)
        bit_rows = sbwt.bit_rows()
        nodes_per_shard = -(-n // (32 * tp)) * 32
        words_per_shard = nodes_per_shard // 32
        words = np.zeros((tp, 4, words_per_shard), dtype=np.uint32)
        blocks = np.zeros((tp, 4, words_per_shard), dtype=np.int32)
        loc_sh = np.full((tp, nodes_per_shard, 2), -1, dtype=np.int32)
        node_start = np.zeros(tp, dtype=np.int32)
        from finito_tpu.utils.bits import pack_bits

        def pos_range(lo: int, hi: int) -> np.ndarray:
            """g_end for colex range [lo, hi) out of the ragged
            width-Mn mesh blocks (no full-length concatenation)."""
            out = np.full(hi - lo, -1, np.int64)
            i = lo
            while i < hi:
                s = i // Mn
                a = i - s * Mn
                b = min(Mn, a + (hi - i))
                out[i - lo : i - lo + (b - a)] = pos_shards[s][a:b]
                i += b - a
            return out

        for s in range(tp):
            lo = s * nodes_per_shard
            hi = min(n, lo + nodes_per_shard)
            node_start[s] = lo
            if lo >= n:
                continue
            for c in range(4):
                w64 = pack_bits(bit_rows[c, lo:hi])
                w32 = w64.view(np.uint32)[:words_per_shard]
                words[s, c, : w32.size] = w32
                pc = np.bitwise_count(words[s, c]).astype(np.int64)
                blocks[s, c, 1:] = np.cumsum(pc[:-1])
            g_end = pos_range(lo, hi)
            found = g_end >= 0
            g_start = g_end - k + 1
            uid = np.searchsorted(ends64, g_start, side="right").astype(np.int32)
            u_start = np.where(uid > 0, ends64[np.maximum(uid - 1, 0)], 0)
            off = (g_start - u_start).astype(np.int32)
            loc_sh[s, : hi - lo, 0] = np.where(found, uid, -1)
            loc_sh[s, : hi - lo, 1] = np.where(found, off, -1)
        return ShardedIndex(
            words=words,
            blocks=blocks,
            loc_table=loc_sh,
            node_start=node_start,
            C=np.asarray(sbwt.get_C_array(), dtype=np.int32),
            ends=np.asarray(index.unitigs.ends, dtype=np.int32),
            k=k,
            n_nodes=n,
            words_per_shard=words_per_shard,
            nodes_per_shard=nodes_per_shard,
        )


def _local_rank(words, blocks, c, local_i):
    """rank within one shard; local_i already clipped to [0, nodes_per_shard]."""
    w = local_i >> 5
    b = (local_i & 31).astype(jnp.uint32)
    n_words = words.shape[-1]
    flat = c * n_words + w
    # one pad word: clamp w to n_words-1 and zero the mask when local_i is at the end
    at_end = w >= n_words
    w_safe = jnp.minimum(w, n_words - 1)
    flat = c * n_words + w_safe
    word = jnp.take(words.reshape(-1), flat)
    blk = jnp.take(blocks.reshape(-1), flat)
    mask = (jnp.uint32(1) << b) - jnp.uint32(1)
    partial_pc = lax.population_count(word & mask).astype(jnp.int32)
    full_pc = lax.population_count(word).astype(jnp.int32)
    return jnp.where(at_end, blk + full_pc, blk + partial_pc)


def sharded_locate_fn(mesh: Mesh, sh: ShardedIndex):
    """Build a pjit-ed locate: (B, L) codes sharded over dp -> (uid, off).

    Index arrays are sharded over tp on their leading axis; inside
    shard_map each tp device sees its own colex slice and contributes to
    every rank via psum.
    """
    k = sh.k
    n_nodes = sh.n_nodes
    nodes_per_shard = sh.nodes_per_shard

    def locate(words, blocks, loc_table, node_start, C, codes):
        # shapes inside shard_map: words (1, 4, wps), codes (B/dp, L)
        words = words[0]
        blocks = blocks[0]
        loc_table = loc_table[0]
        start = node_start[0]

        def rank_g(c, i):
            local_i = jnp.clip(i - start, 0, nodes_per_shard)
            r = _local_rank(words, blocks, c, local_i)
            return lax.psum(r, "tp")

        def upd(c, lo, hi):
            c = c.astype(jnp.int32)
            valid = (lo >= 0) & (c >= 0) & (c <= 3)
            cs = jnp.where(valid, c, 0)
            los = jnp.where(valid, lo, 0)
            his = jnp.where(valid, hi, 0)
            nlo = C[cs] + rank_g(cs, los)
            nhi = C[cs] + rank_g(cs, his + 1) - 1
            ok = valid & (nlo <= nhi)
            neg = jnp.int32(-1)
            return jnp.where(ok, nlo, neg), jnp.where(ok, nhi, neg)

        L = codes.shape[-1]
        W = L - k + 1
        c = codes.astype(jnp.int32)
        lo = jnp.zeros(codes.shape[:-1] + (W,), jnp.int32)
        hi = jnp.full(codes.shape[:-1] + (W,), n_nodes - 1, jnp.int32)

        def body(j, carry):
            lo, hi = carry
            cj = lax.dynamic_slice_in_dim(c, j, W, axis=-1)
            return upd(cj, lo, hi)

        lo, hi = lax.fori_loop(0, k, body, (lo, hi))
        found = lo >= 0

        # sharded gather from the (uid, off) table: owner shard contributes.
        local_idx = jnp.where(found, lo, 0) - start
        in_shard = (local_idx >= 0) & (local_idx < nodes_per_shard)
        safe = jnp.clip(local_idx, 0, nodes_per_shard - 1)
        uid_c = jnp.where(in_shard, jnp.take(loc_table[:, 0], safe), 0)
        off_c = jnp.where(in_shard, jnp.take(loc_table[:, 1], safe), 0)
        uid = lax.psum(uid_c, "tp")
        off = lax.psum(off_c, "tp")
        # non-owner shards contribute 0; the owner contributes -1 for
        # dummies, so a found-but-dummy rank sums to -1 exactly.
        found = found & (uid >= 0)
        neg = jnp.int32(-1)
        return jnp.where(found, uid, neg), jnp.where(found, off, neg)

    shmapped = shard_map(
        locate,
        mesh=mesh,
        in_specs=(
            P("tp", None, None),  # words
            P("tp", None, None),  # blocks
            P("tp", None, None),  # loc_table
            P("tp"),  # node_start
            P(),  # C
            P("dp", None),  # codes
        ),
        out_specs=(P("dp", None), P("dp", None)),
        check_vma=False,
    )

    @jax.jit
    def run(words, blocks, loc_table, node_start, C, codes):
        return shmapped(words, blocks, loc_table, node_start, C, codes)

    def call(codes):
        args = [
            jax.device_put(x, NamedSharding(mesh, spec))
            for x, spec in (
                (sh.words, P("tp", None, None)),
                (sh.blocks, P("tp", None, None)),
                (sh.loc_table, P("tp", None, None)),
                (sh.node_start, P("tp")),
                (sh.C, P()),
            )
        ]
        codes = jax.device_put(jnp.asarray(codes), NamedSharding(mesh, P("dp", None)))
        return run(*args, codes)

    return call


@dataclass
class ShardedMinimizerIndex:
    """The throughput (minimizer) engine's index sharded for (dp, tp).

    TEXT-sharded design (round 3): unitigs split into tp contiguous
    ranges balanced by text size, and each shard is a complete
    shard-LOCAL minimizer index over its own slice -- its own packed
    text, occurrence rows, and hash-slot table (uniform h across shards
    so the tables stack on a leading tp axis). Nothing is replicated;
    per-shard memory is ~1/tp of everything, so total capacity scales
    linearly with tp and per-shard texts stay int32-addressable at any
    total size (pangenome scale, BASELINE configs[3-4]).

    Queries broadcast over tp: every shard runs the same single-chip
    locate against its local tables (the minimizer computation is cheap
    VPU work; the big-table gathers -- the actual cost -- are all
    shard-local and tp-times smaller). A present k-mer's
    text occurrence lives in exactly one shard, so the combine is one
    psum of owner contributions over tp; absent k-mers fail the text
    verify everywhere. Construction never materializes a global index:
    each shard builds independently from its text slice
    (ShardedMinimizerIndex.build), which is also what lifts the old
    2^31-base global cap.
    """

    desc: np.ndarray  # (tp, V + 1, 2) int32 rows [start, exact_len]
    occ_rows: np.ndarray  # (tp, occ_per_shard, 4) int32 (shard-local g/uend, GLOBAL uid)
    n_occ: np.ndarray  # (tp,) int32 true occurrence count per shard
    text_arr: np.ndarray  # (tp, ...) shard-local text: overlapped rows
    # (k <= 32: (rows,4); k <= 64: (rows,8)) or packed words (k > 64)
    k: int
    m: int
    h: int  # uniform shard-local slot bits
    V: int  # slots per shard table (2^h)
    uid_base: np.ndarray  # (tp,) int32 first global unitig id of each shard
    text_base: np.ndarray  # (tp,) int64 first global base of each shard

    @staticmethod
    def build(
        concat: np.ndarray,
        ends: np.ndarray,
        k: int,
        tp: int,
        m: int | None = None,
        slot_factor: int = 32,
    ) -> "ShardedMinimizerIndex":
        """Construct directly from the unitig text, one shard at a time
        -- no single-host full index is ever built, and peak host memory
        is one shard's working set. Each shard's text must stay below
        2^31 bases (raise tp for larger inputs)."""
        from finito_tpu.index.minimizer import MinimizerIndex

        concat = np.asarray(concat, dtype=np.uint8)
        ends64 = np.asarray(ends, dtype=np.int64)
        total = int(concat.size)
        # contiguous unitig ranges with balanced text sizes
        targets = (np.arange(1, tp + 1) * total) // tp
        cut = np.unique(np.searchsorted(ends64, targets, side="left"))
        cut = np.concatenate([[0], np.minimum(cut + 1, ends64.size)])
        if cut.size < tp + 1:  # degenerate: fewer unitigs than shards
            cut = np.concatenate([cut, np.full(tp + 1 - cut.size, ends64.size)])
        shards = []
        for s in range(tp):
            a, b = int(cut[s]), int(cut[s + 1])
            t0 = int(ends64[a - 1]) if a > 0 else 0
            t1 = int(ends64[b - 1]) if b > a else t0
            if t1 - t0 >= (1 << 31):
                raise ValueError(
                    f"shard {s} holds {t1 - t0} bases >= 2^31; increase tp"
                )
            mi = MinimizerIndex.build(
                concat[t0:t1], ends64[a:b] - t0, k, m, slot_factor
            )
            shards.append((mi, a, t0))
        h_u = max(mi.h for mi, _, _ in shards)
        for mi, _, _ in shards:
            mi.rebucket(h_u)
        return ShardedMinimizerIndex._stack(shards, k, tp, h_u)

    @staticmethod
    def from_minimizer_index(mindex, tp: int) -> "ShardedMinimizerIndex":
        """Shard an existing single-host index (compatibility path: the
        per-shard tables are REBUILT from its text; prefer build() to
        skip constructing the single-host index at all)."""
        return ShardedMinimizerIndex.build(
            np.asarray(mindex.concat, np.uint8),
            np.asarray(mindex.ends, np.int64),
            mindex.k,
            tp,
            m=mindex.m,
        )

    @staticmethod
    def _stack(shards, k: int, tp: int, h_u: int) -> "ShardedMinimizerIndex":
        from finito_tpu.query.minimizer_engine import (
            _n_words,
            build_occ_rows,
            build_text_rows,
            build_text_rows8,
            desc_to_rows,
            pack_text_words,
        )

        V = 1 << h_u
        m = shards[0][0].m
        per = int(max(1, max(mi.occ_key.size for mi, _, _ in shards)))
        desc = np.zeros((tp, V + 1, 2), dtype=np.int32)
        occ_rows = np.zeros((tp, per, 4), dtype=np.int32)
        n_occ = np.zeros(tp, dtype=np.int32)
        uid_base = np.zeros(tp, dtype=np.int32)
        text_base = np.zeros(tp, dtype=np.int64)
        texts = []
        for s, (mi, a, t0) in enumerate(shards):
            desc[s] = desc_to_rows(mi.desc)
            rows = build_occ_rows(mi)  # shard-local g/off/uend, local uid
            occ_rows[s, : rows.shape[0]] = rows
            n_occ[s] = rows.shape[0]
            uid_base[s] = a
            text_base[s] = t0
            words = pack_text_words(
                np.asarray(mi.concat, np.uint8), _n_words(k) + 5
            )
            if k <= 32:
                texts.append(build_text_rows(words))
            elif k <= 64:
                texts.append(build_text_rows8(words))
            else:
                texts.append(words)
        shape1 = max(t.shape[0] for t in texts)
        text_arr = np.zeros((tp, shape1) + texts[0].shape[1:], texts[0].dtype)
        for s, t in enumerate(texts):
            text_arr[s, : t.shape[0]] = t
        return ShardedMinimizerIndex(
            desc=desc, occ_rows=occ_rows, n_occ=n_occ, text_arr=text_arr,
            k=k, m=m, h=h_u, V=V, uid_base=uid_base, text_base=text_base,
        )


def sharded_minimizer_locate_fn(mesh: Mesh, sh: ShardedMinimizerIndex, K_slow: int = 4096):
    """pjit-ed minimizer locate over (dp, tp): batch sharded over dp,
    TEXT (unitig ranges) over tp. Every shard runs the single-chip
    locate against its shard-local tables; a present k-mer verifies in
    exactly one shard's text, so one psum combines the answers. Any
    k <= 255 (k > 64 uses the rolling packed-word matcher on the
    shard-local text, like the single-chip engine)."""
    from finito_tpu.query.minimizer_engine import (
        _match_text_kmer,
        _match_text_kmer_rows,
        _match_text_kmer_rows8,
        _word_masks,
        minimizer_scan,
        pack_query_windows,
        slot32_device,
    )

    k, m, hbits = sh.k, sh.m, sh.h
    masks = _word_masks(k)

    def locate(desc, occ_rows, n_occ, text_arr, uid_base, codes):
        desc = desc[0]
        occ_rows = occ_rows[0]
        n_occ = n_occ[0]
        text_arr = text_arr[0]
        uid_b = uid_base[0]

        B, L = codes.shape
        W = L - k + 1
        c = codes.astype(jnp.uint32)
        best_v, best_o, bad = minimizer_scan(c, k, m)
        q_words = pack_query_windows(c, k)

        # shard-local slot lookup: no ownership test -- a window whose
        # k-mer lives elsewhere simply fails this shard's text verify
        slot = (slot32_device(best_v) >> jnp.uint32(32 - hbits)).astype(jnp.int32)
        d = jnp.take(desc, jnp.where(bad, 0, slot), axis=0)  # (B, W, 2)
        start = d[..., 0]
        ln = jnp.where(bad, 0, d[..., 1])

        def check(idx, o, qws):
            # same candidate check as the 1-chip engine, on shard-local rows
            row = jnp.take(occ_rows, idx, axis=0)
            g_m, uid, off_m, uend = row[..., 0], row[..., 1], row[..., 2], row[..., 3]
            g_w = g_m - o
            off_w = off_m - o
            ok = (off_w >= 0) & (g_w + k <= uend)
            g_safe = jnp.maximum(g_w, 0)
            if k <= 32:
                mt = _match_text_kmer_rows(text_arr, g_safe, qws, masks)
            elif k <= 64:
                mt = _match_text_kmer_rows8(text_arr, g_safe, qws, masks)
            else:
                mt = _match_text_kmer(text_arr, g_safe, qws, masks, k)
            return ok & mt, uid, off_w

        fast = ln == 1
        match, uid_f, off_f = check(jnp.where(fast, start, 0), best_o, q_words)
        found = fast & match
        uid = jnp.where(found, uid_f, -1)
        off = jnp.where(found, off_f, -1)

        # shard-local slow path
        from finito_tpu.ops.streaming import compact_mask

        slow_mask = (ln >= 2).reshape(-1)
        flat_idx, n_slow = compact_mask(slow_mask, K_slow)
        valid = flat_idx >= 0
        safe = jnp.where(valid, flat_idx, 0)
        s_start = jnp.take(start.reshape(-1), safe)
        # exact slot end from the length column
        s_end = s_start + jnp.take(ln.reshape(-1), safe)
        s_o = jnp.take(best_o.reshape(-1), safe)
        s_qw = [jnp.take(q.reshape(-1), safe) for q in q_words]

        def cond(st):
            i, u, o2, done = st
            return jnp.any(~done)

        def body(st):
            i, u, o2, done = st
            in_range = (i < s_end) & (i < n_occ)
            ci = jnp.where(in_range, i, 0)
            mt, uc, oc = check(ci, s_o, s_qw)
            hit = ~done & in_range & mt
            u = jnp.where(hit, uc, u)
            o2 = jnp.where(hit, oc, o2)
            done = done | hit | (i + 1 >= s_end)
            return i + 1, u, o2, done

        uid_s = jnp.full((K_slow,), -1, jnp.int32)
        off_s = jnp.full((K_slow,), -1, jnp.int32)
        _, uid_s, off_s, _ = lax.while_loop(cond, body, (s_start, uid_s, off_s, ~valid))
        BW = B * W
        sink = jnp.where(valid, flat_idx, BW)
        uid = uid.reshape(-1).at[sink].set(uid_s, mode="drop").reshape(B, W)
        off = off.reshape(-1).at[sink].set(off_s, mode="drop").reshape(B, W)

        # owner-shard psum combine (not-found shards contribute 0);
        # local unitig ids globalize with the shard's uid base
        uid = lax.psum(jnp.where(uid >= 0, uid + uid_b + 1, 0), "tp") - 1
        off = lax.psum(jnp.where(off >= 0, off + 1, 0), "tp") - 1
        # worst per-shard slow count anywhere on the mesh (capacity check)
        n_slow = lax.pmax(lax.pmax(n_slow, "tp"), "dp")
        return uid, off, n_slow

    shmapped = shard_map(
        locate,
        mesh=mesh,
        in_specs=(
            P("tp", None, None),  # desc rows
            P("tp", None, None),  # occ_rows
            P("tp"),  # n_occ
            P("tp", *([None] * (sh.text_arr.ndim - 1))),  # shard-local text
            P("tp"),  # uid_base
            P("dp", None),  # codes
        ),
        out_specs=(P("dp", None), P("dp", None), P()),
        check_vma=False,
    )

    @jax.jit
    def run(desc, occ_rows, n_occ, text_arr, uid_base, codes):
        return shmapped(desc, occ_rows, n_occ, text_arr, uid_base, codes)

    def call(codes):
        args = [
            jax.device_put(x, NamedSharding(mesh, spec))
            for x, spec in (
                (sh.desc, P("tp", None, None)),
                (sh.occ_rows, P("tp", None, None)),
                (sh.n_occ, P("tp")),
                (sh.text_arr, P("tp", *([None] * (sh.text_arr.ndim - 1)))),
                (sh.uid_base, P("tp")),
            )
        ]
        codes = jax.device_put(jnp.asarray(codes), NamedSharding(mesh, P("dp", None)))
        return run(*args, codes)

    return call


def sharded_lcs_fn(mesh: Mesh, sbwt):
    """Device-mesh LCS construction: the k label-propagation rounds of
    ops.lcs_jax with the NODE AXIS sharded over every mesh device.

    Per round, per shard: the first-difference mark needs one halo
    element (the previous shard's last label, a ppermute); the de-Bruijn
    propagation is a global permutation, run as an all_gather of the
    label column + a shard-local scatter of the edges whose DESTINATION
    falls in the shard (edge lists are bucketed by destination shard
    host-side and padded to equal length). Returns the LCS as host
    int64, equal to sbwt.lcs_array / ops.lcs_jax (tested on the virtual
    mesh). This is the multi-chip BUILD step: each round's collective is
    one all_gather over ICI; everything else is shard-local.
    """
    from finito_tpu.ops.lcs_jax import lcs_scatter_indices

    k = sbwt.get_k()
    n = sbwt.number_of_subsets()
    C = np.asarray(sbwt.get_C_array(), dtype=np.int64)
    src, dst = lcs_scatter_indices(sbwt)

    devs = mesh.devices.reshape(-1)
    S = devs.size
    per = -(-n // S)
    npad = S * per

    # bucket edges by destination shard, pad buckets to a common width
    shard_of = dst // per
    order = np.argsort(shard_of, kind="stable")
    src_o, dst_o = src[order], dst[order]
    counts = np.bincount(shard_of[order], minlength=S)
    M = int(counts.max()) if counts.size else 1
    src_sh = np.zeros((S, M), np.int32)
    dstl_sh = np.full((S, M), per, np.int32)  # per = out-of-range, dropped
    pos = 0
    for s in range(S):
        c = int(counts[s])
        src_sh[s, :c] = src_o[pos : pos + c]
        dstl_sh[s, :c] = dst_o[pos : pos + c] - s * per
        pos += c

    cur0 = np.zeros(npad, dtype=np.int32)
    for c in range(4):
        hi = int(C[c + 1]) if c < 3 else n
        cur0[int(C[c]) : hi] = c + 1

    flat_mesh = Mesh(devs.reshape(S), ("D",))

    def rounds(cur_s, src_s, dstl_s):
        src_s, dstl_s = src_s[0], dstl_s[0]
        lcs_s = jnp.full(per, k, jnp.int32)
        sid = lax.axis_index("D")

        def body(r, st):
            cur, lcs = st
            # halo: previous shard's last label (shard 0's halo is unused
            # -- its first node is always a global first-difference)
            prev_last = lax.ppermute(
                cur[-1], "D", [(i, (i + 1) % S) for i in range(S)]
            )
            left = jnp.concatenate([prev_last[None], cur[:-1]])
            diff = cur != left
            diff = jnp.where(
                (sid == 0) & (jnp.arange(per) == 0), True, diff
            )
            lcs2 = jnp.where((lcs == k) & diff, r, lcs)
            full = lax.all_gather(cur, "D", tiled=True)  # (npad,)
            nxt = jnp.zeros_like(cur).at[dstl_s].set(
                jnp.take(full, src_s), mode="drop"
            )
            return nxt, lcs2

        _, lcs_s = lax.fori_loop(0, k, body, (cur_s, lcs_s))
        return lcs_s

    shmapped = shard_map(
        rounds,
        mesh=flat_mesh,
        in_specs=(P("D"), P("D", None), P("D", None)),
        out_specs=P("D"),
        check_vma=False,
    )
    run = jax.jit(shmapped)
    from finito_tpu.parallel.shard_build import _host, _put

    args = [
        _put(flat_mesh, x, spec)
        for x, spec in (
            (cur0, P("D")),
            (src_sh, P("D", None)),
            (dstl_sh, P("D", None)),
        )
    ]
    return _host(run(*args))[:n].astype(np.int64)
