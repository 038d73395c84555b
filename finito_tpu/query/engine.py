"""Batched device query engines producing `search-fmin`-identical output.

Engines (selected by --engine on the CLI):

  * "dense": the throughput engine. At init it materializes the k-mer
    position table pos[colex] = global end offset of that k-mer's (unique,
    t=1) occurrence in the packed unitig concatenation, by batch-searching
    every unitig window on device -- a generalization of the index's own
    anchor structures (with t=1, every finimizer's singleton interval
    start IS the colex rank of the k-mer ending at the finimizer's end,
    so global_offsets/Ustart are sparse anchors of this same table;
    ref: FinimizerIndex.hh:119-185 resolves positions through those
    anchors sequentially, we resolve through the dense table in one
    gather). Queries are then: fixed-k interval extension over all
    windows (divergence-free) + one gather + searchsorted over unitig
    ends. Extra memory: 4 bytes/node.

  * "replica": the compact engine (no dense table): streaming two-interval
    scan like the reference, vectorized across reads; same output, index
    memory identical to the serialized form. (Implemented in
    finito_tpu.query.replica.)

Both match FinimizerIndex.search (the host oracle) bit-exactly on valid
t=1 DSPSS indexes; the oracle remains the arbiter in tests. For inputs
that are NOT k-mer-disjoint the reference's answer for a repeated k-mer
depends on its dictionary contents (SURVEY.md Appendix A item 7); the
dense engine then reports the last window scattered at build -- such
inputs are outside the reference's own contract (its Rust oracle errors
on them, main.rs:89-92).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from finito_tpu.index.index import FinimizerIndex, QueryResult
from finito_tpu.ops.bitvec import DeviceSBWT, kmer_ranks_fixed, search_batch_device


def build_position_table(
    dsbwt: DeviceSBWT, concat: np.ndarray, ends: np.ndarray, chunk: int = 1 << 20
) -> jnp.ndarray:
    """pos[colex] = global end offset of the k-mer with that colex rank,
    -1 for dummy nodes. Built by batch-searching every valid unitig
    window (windows never cross unitig boundaries)."""
    k = dsbwt.k
    total = int(concat.size)
    table = jnp.full(dsbwt.n_nodes, -1, dtype=jnp.int32)
    if total < k:
        return table
    ends64 = np.asarray(ends, dtype=np.int64)

    @jax.jit
    def step(dsbwt, table, kmers, g_end):
        ranks = search_batch_device(dsbwt, kmers)
        # invalid rows carry rank -1, which .at[] would WRAP to the last
        # entry -- remap to n_nodes so mode="drop" actually drops them.
        # In a DSPSS each rank is hit once; max keeps a repeated k-mer's
        # answer defined on every backend (the last window, as a serial
        # scatter over ascending g_end would leave it)
        ranks = jnp.where(ranks < 0, dsbwt.n_nodes, ranks)
        return table.at[ranks].max(g_end, mode="drop")

    n_pos = total - k + 1
    for s in range(0, n_pos, chunk):
        m = min(chunk, n_pos - s)
        starts = np.arange(s, s + m, dtype=np.int64)
        # valid iff window fits inside the unitig containing its start
        uid = np.searchsorted(ends64, starts, side="right")
        valid = starts + k <= ends64[uid]
        win = np.lib.stride_tricks.sliding_window_view(concat[s : s + m + k - 1], k).copy()
        win[~valid] = 255  # force absent -> rank -1 -> dropped scatter
        g_end = jnp.asarray((starts + k - 1).astype(np.int32))
        table = step(dsbwt, table, jnp.asarray(win), g_end)
    return table


def build_locate_tables(pos_table, ends_dev, k: int):
    """Resolve the per-colex global end offsets into a per-colex
    (unitig id, local offset) ROW table once at init, so each query
    k-mer costs ONE (n, 2) row gather instead of gather +
    log(n_unitigs)-step searchsorted + gather (bench_micro.py measures
    row against scalar gather rates on the device at hand). +8
    bytes/node on top of pos_table's 4 (the compact 'replica' engine
    exists for memory-bound deployments)."""
    g_end = pos_table
    found = g_end >= 0
    g_start = g_end - k + 1
    uid = jnp.searchsorted(ends_dev, g_start, side="right").astype(jnp.int32)
    u_start = jnp.where(uid > 0, jnp.take(ends_dev, jnp.maximum(uid - 1, 0)), 0)
    off = g_start - u_start
    neg = jnp.int32(-1)
    return jnp.stack(
        [jnp.where(found, uid, neg), jnp.where(found, off, neg)], axis=1
    )


def _ranks_to_locations(loc_table, ranks):
    """colex ranks (B, W) -> ((B, W) unitig ids, (B, W) offsets);
    one (n, 2) row gather."""
    found = ranks >= 0
    safe = jnp.where(found, ranks, 0)
    rows = jnp.take(loc_table, safe, axis=0)
    uid, off = rows[..., 0], rows[..., 1]
    found = found & (uid >= 0)
    neg = jnp.int32(-1)
    return jnp.where(found, uid, neg), jnp.where(found, off, neg)


def _locate_dense(dsbwt: DeviceSBWT, loc_table, codes, k: int):
    """(B, L) codes -> ((B, W) unitig ids, (B, W) offsets); -1 for absent."""
    ranks = kmer_ranks_fixed(dsbwt, codes, k)
    return _ranks_to_locations(loc_table, ranks)


class DeviceQueryEngine:
    """Batched (unitig, offset) localization over a loaded FinimizerIndex."""

    def __init__(
        self, index: FinimizerIndex, mode: str = "dense", mesh=None,
        mindex_cache: str | None = None, chunk: int | None = None,
    ):
        """mesh: optional (dp, tp) ints. With dp*tp > 1 (minimizer mode
        only) the locate runs as the shard_map'd multi-chip pipeline of
        parallel.mesh -- the batch sharded over dp, the unitig text over
        tp -- instead of the single-device program. This is the
        product CLI's scale-out path (`search-fmin --mesh dp,tp`);
        output is identical to the single-device engine (tested on the
        virtual CPU mesh).

        mindex_cache: optional path; the minimizer engine's derived
        MinimizerIndex is loaded from it when present and serialized to
        it after a build (the host-side derivation is minutes at
        genome scale).

        chunk: scan-chunk length for the stream/replica chain scans
        (ops.streaming.chunk_reads); None = auto (lane-saturation rule,
        ops.streaming.auto_chunk), 0 disables."""
        self.index = index
        self.chunk = chunk
        self._mindex_cache = mindex_cache
        self._locate_async_deferred = None  # set by modes that support it
        self.k = index.sbwt.get_k()
        self.mode = mode
        self.mesh_shape = tuple(mesh) if mesh else None
        if self.mesh_shape and int(np.prod(self.mesh_shape)) <= 1:
            self.mesh_shape = None
        if self.mesh_shape and mode != "minimizer":
            raise ValueError("--mesh requires the minimizer engine")
        # SBWT device upload only for the modes that use it: the replica
        # and minimizer engines build their own device structures, and
        # holding a dead SBWT in HBM defeats the compact replica mode.
        self.dsbwt = (
            DeviceSBWT.from_host(index.sbwt) if mode in ("dense", "stream") else None
        )
        self.ends_dev = jnp.asarray(index.unitigs.ends, dtype=jnp.int32)
        if mode == "dense":
            self.pos_table = build_position_table(
                self.dsbwt, index.unitigs.concat, index.unitigs.ends
            )
            self.loc_table = jax.jit(build_locate_tables, static_argnums=2)(
                self.pos_table, self.ends_dev, self.k
            )
            _jld = jax.jit(_locate_dense, static_argnums=(3,))
            self._locate = lambda codes: _jld(
                self.dsbwt, self.loc_table, codes, self.k
            )
        elif mode == "stream":
            from finito_tpu.ops.rank24 import (
                build_contract_k_table,
                build_edge_table,
                build_lcs_jump_tables,
                build_rank24_tables,
            )
            from finito_tpu.ops.streaming import make_chain_stream_ranks

            self.pos_table = build_position_table(
                self.dsbwt, index.unitigs.concat, index.unitigs.ends
            )
            self.loc_table = jax.jit(build_locate_tables, static_argnums=2)(
                self.pos_table, self.ends_dev, self.k
            )
            tab = jnp.asarray(build_rank24_tables(index.sbwt.bit_rows()))
            n8 = tab.shape[0] // 4
            C = jnp.asarray(index.sbwt.get_C_array(), dtype=jnp.int32)
            ck_np = build_contract_k_table(index.LCS, self.k)
            ck = jnp.asarray(ck_np)
            jl_np, jr_np = build_lcs_jump_tables(index.LCS)
            jl, jr = jnp.asarray(jl_np), jnp.asarray(jr_np)
            edge = jnp.asarray(
                build_edge_table(index.sbwt.bit_rows(), index.sbwt.get_C_array(), ck_np)
            )
            n_nodes = index.sbwt.number_of_subsets()
            self._tab, self._n8, self._C, self._ck, self._n_nodes = tab, n8, C, ck, n_nodes
            self._edge, self._jl, self._jr = edge, jl, jr
            loc_table = self.loc_table
            k = self.k
            stream_cache = {}

            # chunk None = auto (decided at trace time from the batch shape)
            eff_chunk = self.chunk

            def make_stream(K):
                ranks_fn = make_chain_stream_ranks(n8, k, n_nodes, K, chunk=eff_chunk)

                def f(tab, C, ck, jl, jr, edge, loc_table, codes):
                    ranks, n_seg = ranks_fn(tab, C, ck, jl, jr, edge, codes)
                    uid, off = _ranks_to_locations(loc_table, ranks)
                    return uid, off, n_seg > K

                jf = jax.jit(f)
                return lambda codes: jf(tab, C, ck, jl, jr, edge, loc_table, codes)

            stream_sizes = {}  # (B, W) -> last sufficient K

            def locate_stream_async(codes):
                """Dispatch + deferred overflow check (same contract as
                locate_minimizer_async): returns (uid_dev, off_dev,
                verify); verify() blocks on the overflow flag and
                re-runs at larger K on the rare overflow, returning the
                corrected pair (else None). Lets the CLI's begin/end
                split double-buffer scan-engine chunks sync-free."""
                B, L = codes.shape
                W = L - k + 1
                # K bounds repaired SEGMENTS (untrusted runs split at 2k
                # payload positions), not windows: far fewer than W per read
                K = stream_sizes.get((B, W)) or max(1024, (B * W) // 64)
                if K not in stream_cache:
                    stream_cache[K] = make_stream(K)
                first = stream_cache[K](codes)

                def verify(K=K):
                    out = first
                    while True:
                        if not bool(out[2]):
                            stream_sizes[(B, W)] = K
                            return None if out is first else (out[0], out[1])
                        if K >= B * W:
                            raise AssertionError("segment overflow at K == B*W")
                        K = min(B * W, K * 4)
                        if K not in stream_cache:
                            stream_cache[K] = make_stream(K)
                        out = stream_cache[K](codes)

                return first[0], first[1], verify

            def locate_stream(codes):
                uid, off, verify = locate_stream_async(codes)
                fixed = verify()
                return fixed if fixed is not None else (uid, off)

            self._locate = locate_stream
            self._locate_async_deferred = locate_stream_async
        elif mode == "minimizer" and self.mesh_shape:
            import jax as _jax

            from finito_tpu.parallel.mesh import (
                ShardedMinimizerIndex,
                make_mesh,
                sharded_minimizer_locate_fn,
            )

            dp, tp = self.mesh_shape
            if len(_jax.devices()) < dp * tp:
                raise RuntimeError(
                    f"--mesh {dp},{tp} needs {dp * tp} devices, "
                    f"found {len(_jax.devices())}"
                )
            self.mesh = make_mesh(dp * tp, tp=tp)
            # shard-local builds straight from the unitig text: no
            # single-host full index is ever constructed on this path
            sh = ShardedMinimizerIndex.build(
                np.asarray(index.unitigs.concat, np.uint8),
                np.asarray(index.unitigs.ends, np.int64),
                self.k,
                tp=tp,
            )
            k = self.k
            mesh_cache = {}

            def locate_mesh(codes):
                B, L = codes.shape
                if B % dp:
                    raise ValueError(f"batch {B} not divisible by dp={dp}")
                W = L - k + 1
                K = max(256, (B * W) // 32)
                while True:
                    if K not in mesh_cache:
                        mesh_cache[K] = sharded_minimizer_locate_fn(self.mesh, sh, K)
                    uid, off, n_slow = mesh_cache[K](codes)
                    if int(n_slow) <= K:
                        return uid, off
                    if K >= B * W:
                        raise AssertionError("slow-path overflow at K == B*W")
                    K = min(B * W, K * 4)

            self._locate = locate_mesh
        elif mode == "minimizer":
            from finito_tpu.index.minimizer import MinimizerIndex
            from finito_tpu.query.minimizer_engine import (
                DeviceMinimizerIndex,
                make_minimizer_locate,
                make_minimizer_locate_v2,
            )

            import os as _os2

            mindex = None
            if self._mindex_cache and _os2.path.exists(self._mindex_cache):
                mindex = MinimizerIndex.load(self._mindex_cache)
                # a stale cache (different index) would silently return
                # wrong (uid, off): check the invariants that tie the
                # cache to THIS index and rebuild on mismatch
                if (
                    mindex.k != self.k
                    or mindex.concat.size != np.asarray(index.unitigs.concat).size
                    or not np.array_equal(
                        np.asarray(mindex.ends), np.asarray(index.unitigs.ends)
                    )
                ):
                    import warnings

                    warnings.warn(
                        f"minimizer cache {self._mindex_cache} does not match "
                        "this index (k/text/ends differ); rebuilding"
                    )
                    mindex = None
            if mindex is None:
                mindex = MinimizerIndex.from_finimizer_index(index)
                if self._mindex_cache:
                    mindex.serialize(self._mindex_cache)
            self._dmi = DeviceMinimizerIndex(mindex)
            dmi = self._dmi
            # Provisional switch from the previous target: the
            # run-deduplicated v2 form for descriptor tables >= 64 MB,
            # v1's lower overhead below. The H100 crossover is ROADMAP
            # Queue 1 #6-#7.
            import os as _os

            _ov = _os.environ.get("FINITO_MINIMIZER_V2")  # tests force either form
            use_v2 = (
                _ov == "1"
                if _ov in ("0", "1")
                else int(np.asarray(dmi.desc).nbytes) >= (64 << 20)
            )
            mini_cache = {}
            mini_sizes = {}  # (B, W) -> last sufficient (K, KH)

            def _mini_dispatch(codes, K, KH):
                key = (K, KH, use_v2)
                if key not in mini_cache:
                    mini_cache[key] = (
                        make_minimizer_locate_v2(dmi, K, KH)
                        if use_v2
                        else make_minimizer_locate(dmi, K)
                    )
                return mini_cache[key](codes)

            def locate_minimizer_async(codes):
                """Dispatch with the last-known-sufficient capacities and
                DEFER the overflow readback: returns (uid_dev, off_dev,
                verify) where verify() blocks on the counters and, on the
                rare overflow, re-runs at larger capacity and returns the
                corrected (uid_dev, off_dev) (else None). Lets the
                serving path double-buffer without a device sync inside
                the dispatch half."""
                from finito_tpu.query.minimizer_engine import (
                    grow_capacities,
                    initial_capacities,
                )

                B, L = codes.shape
                W = L - self.k + 1
                K, KH = mini_sizes.get((B, W)) or initial_capacities(B * W, use_v2)
                k0 = int(_os.environ.get("FINITO_MIN_K0", "0"))
                if k0 > 0:  # tests: force the overflow/verify path
                    K, KH = k0, max(k0, 4)
                    mini_sizes.pop((B, W), None)
                first = _mini_dispatch(codes, K, KH)

                def verify(K=K, KH=KH):
                    out = first
                    while True:
                        n_slow = int(out[2])
                        n_heads = int(out[3]) if use_v2 else 0
                        grown = grow_capacities(K, KH, n_slow, n_heads, B * W)
                        if grown is None:
                            mini_sizes[(B, W)] = (K, KH)
                            return None if out is first else (out[0], out[1])
                        K, KH = grown
                        out = _mini_dispatch(codes, K, KH)

                return first[0], first[1], verify

            def locate_minimizer(codes):
                uid, off, verify = locate_minimizer_async(codes)
                fixed = verify()
                return fixed if fixed is not None else (uid, off)

            self._locate = locate_minimizer
            self._locate_async_deferred = locate_minimizer_async
        elif mode == "replica":
            from finito_tpu.query.replica import make_replica_locate_v2

            rep_cache = {}
            rep_sizes = {}  # (B, L) -> last sufficient K
            k = self.k

            def locate_replica_async(codes):
                """Deferred-overflow dispatch (see locate_stream_async)."""
                B, L = codes.shape
                K = rep_sizes.get((B, L)) or max(1024, (B * (L - k + 1)) // 16)
                if K not in rep_cache:
                    rep_cache[K] = make_replica_locate_v2(index, K, chunk=self.chunk)
                first = rep_cache[K](codes)

                def verify(K=K):
                    out = first
                    while True:
                        if int(out[2]) <= K:
                            rep_sizes[(B, L)] = K
                            return None if out is first else (out[0], out[1])
                        if K >= B * L:
                            raise AssertionError("segment overflow at K == B*L")
                        K = min(B * L, K * 4)
                        if K not in rep_cache:
                            rep_cache[K] = make_replica_locate_v2(
                                index, K, chunk=self.chunk
                            )
                        out = rep_cache[K](codes)

                return first[0], first[1], verify

            def locate_replica(codes):
                uid, off, verify = locate_replica_async(codes)
                fixed = verify()
                return fixed if fixed is not None else (uid, off)

            self._locate = locate_replica
            self._locate_async_deferred = locate_replica_async
        else:
            raise ValueError(f"unknown engine mode {mode}")

    # ---------------- batched core ----------------

    def make_device_pipeline(self, batch: int, read_len: int, unknown_frac: float = 0.5):
        """Jitted device-resident query step: (B, L) codes (device) ->
        (uid, off, n_unknown) device arrays. The serving hot path: keep
        inputs on device (or pipeline transfers). For stream mode the
        results are only valid when n_unknown <= pipe.K; n_unknown also
        lets callers right-size K (phase-B cost is proportional to K)."""
        k = self.k
        W = read_len - k + 1
        if self.mode == "minimizer":
            from finito_tpu.query.minimizer_engine import (
                make_minimizer_locate,
                make_minimizer_locate_v2,
            )

            K = max(256, int(batch * W * unknown_frac))
            if int(np.asarray(self._dmi.desc).nbytes) >= (64 << 20):
                # run-dedup form for big descriptor tables (the
                # provisional switch in __init__); heads are ~2/(k-m+2)
                # of windows, sized with 40% headroom
                KH = max(1024, int(batch * W * (2.8 / (self.k - self._dmi.m + 2))))
                jitted = make_minimizer_locate_v2(self._dmi, K, KH)
                pipe = lambda codes: jitted(codes)  # noqa: E731
                pipe.K_heads = KH
            else:
                jitted = make_minimizer_locate(self._dmi, K)
                pipe = lambda codes: jitted(codes)  # noqa: E731
                pipe.K_heads = None
            pipe.K = K
            return pipe
        if self.mode == "replica":
            from finito_tpu.query.replica import make_replica_locate_v2

            K = max(1024, int(batch * W * unknown_frac))
            jitted = make_replica_locate_v2(self.index, K, chunk=self.chunk)
            pipe = lambda codes: jitted(codes)  # noqa: E731
            pipe.K = K
            return pipe
        if self.mode not in ("dense", "stream"):
            raise ValueError(f"no device pipeline for mode {self.mode}")
        loc_table = self.loc_table
        if self.mode == "dense":
            dsbwt = self.dsbwt
            _jld = jax.jit(
                lambda d, lt, codes: _locate_dense(d, lt, codes, k)
                + (jnp.int32(0),)
            )

            def pipe(codes):
                return _jld(dsbwt, loc_table, codes)

            pipe.K = batch * W
            return pipe
        if self.mode == "stream":
            from finito_tpu.ops.streaming import make_chain_stream_ranks

            K = max(1024, int(batch * W * unknown_frac))
            ranks_fn = make_chain_stream_ranks(self._n8, k, self._n_nodes, K, chunk=self.chunk)

            def _pipe(tab, C, ck, jl, jr, edge, lt, codes):
                ranks, n_seg = ranks_fn(tab, C, ck, jl, jr, edge, codes)
                uid, off = _ranks_to_locations(lt, ranks)
                return uid, off, n_seg

            jitted = jax.jit(_pipe)
            tab, C, ck, edge = self._tab, self._C, self._ck, self._edge
            jl, jr = self._jl, self._jr

            def pipe(codes):
                return jitted(tab, C, ck, jl, jr, edge, loc_table, codes)

            pipe.K = K
            return pipe
        raise ValueError(f"no device pipeline for mode {self.mode}")

    def locate_batch_async(self, codes: np.ndarray):
        """locate_batch without the device->host readback: returns
        (uid_dev, off_dev, B, W) where the device arrays are padded and
        the (B, W) slice applies at readback. Lets callers chain further
        device work (the run-merge serving path) or overlap readback
        with the next chunk's dispatch."""
        B, L = codes.shape
        L_pad = max(128, -(-L // 128) * 128)
        B_pad = 1 << max(0, (B - 1).bit_length())
        if (B_pad, L_pad) != (B, L):
            padded = np.full((B_pad, L_pad), 255, dtype=np.uint8)
            padded[:B, :L] = codes
            codes = padded
        uid, off = self._locate(jnp.asarray(codes))
        return uid, off, B, L - self.k + 1

    def _locate_batch_deferred(self, codes: np.ndarray):
        """locate_batch_async with the capacity check DEFERRED: returns
        (uid_dev, off_dev, B, W, verify). verify is None (nothing to
        check) or a callable that blocks on the overflow counters and
        returns corrected (uid_dev, off_dev) on the rare overflow
        re-run, else None. The serving begin/end split calls verify at
        READBACK time so the dispatch half never syncs the device."""
        B, L = codes.shape
        L_pad = max(128, -(-L // 128) * 128)
        B_pad = 1 << max(0, (B - 1).bit_length())
        if (B_pad, L_pad) != (B, L):
            padded = np.full((B_pad, L_pad), 255, dtype=np.uint8)
            padded[:B, :L] = codes
            codes = padded
        if self._locate_async_deferred is None:
            uid, off = self._locate(jnp.asarray(codes))
            return uid, off, B, L - self.k + 1, None
        uid, off, verify = self._locate_async_deferred(jnp.asarray(codes))
        return uid, off, B, L - self.k + 1, verify

    def locate_batch(self, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """codes: (B, L) uint8 (pad with 255), L >= k. Returns (B, W) unitig
        ids and offsets, -1 where the k-mer is absent/invalid.

        Shapes are bucketed (L to a multiple of 128, B to a power of two)
        so arbitrary read sets hit a handful of compiled programs instead
        of one XLA compile per shape.
        """
        uid, off, B, W = self.locate_batch_async(codes)
        return np.asarray(uid)[:B, :W], np.asarray(off)[:B, :W]

    # ------------- device fwd/RC merge + run-length readback -------------

    def _merge_rle_fn(self, B2: int, Wp: int, K: int):
        """Jitted device kernel: strand-interleaved (B2, Wp) locate
        results -> reference-merged (u, p) per window, run-length
        encoded ON DEVICE so the host readback is O(runs) instead of
        O(windows); DSPSS-style reads compress to a handful of affine
        runs per read.

        A run is a maximal window stretch with one unitig id and offsets
        in arithmetic progression with step +1 (forward hits), -1 (the
        RC-filled stretches count DOWN because the merge mirrors the RC
        window index) or 0 (absent (-1,-1) stretches); encoded as
        (u0, p0, p_last, len). The merge rule is the reference's output
        rule (search_fmin.hh:62-71): take the forward hit, else the RC
        hit of the mirrored window n-1-w."""
        cache = getattr(self, "_merge_rle_cache", None)
        if cache is None:
            cache = self._merge_rle_cache = {}
        fn = cache.get((B2, Wp, K))
        if fn is not None:
            return fn

        @jax.jit
        def merge_rle(uid, off, lens):
            # uid, off: (B2, Wp) int32, rows 2j/2j+1 = read j fwd/RC;
            # lens: (B2//2,) int32 window counts (0 for padding rows)
            uf, of = uid[0::2], off[0::2]
            ur, orr = uid[1::2], off[1::2]
            w = jnp.arange(Wp, dtype=jnp.int32)[None, :]
            n = lens[:, None]
            valid = w < n
            ridx = jnp.clip(n - 1 - w, 0, Wp - 1)
            ur_al = jnp.take_along_axis(ur, ridx, axis=1)
            orr_al = jnp.take_along_axis(orr, ridx, axis=1)
            take_rc = uf < 0
            neg = jnp.int32(-1)
            u = jnp.where(valid & take_rc, ur_al, jnp.where(valid, uf, neg))
            p = jnp.where(valid & take_rc, orr_al, jnp.where(valid, of, neg))
            kf = jnp.sum(valid & (uf >= 0))
            kr = jnp.sum(valid & (ur >= 0))
            # -- run heads: a window continues the previous run iff same
            # unitig and the offset step is the run's step (+-1; the
            # first step after a head is free), or both are absent
            prev_u = jnp.pad(u[:, :-1], ((0, 0), (1, 0)), constant_values=-2)
            prev_p = jnp.pad(p[:, :-1], ((0, 0), (1, 0)), constant_values=-2)
            d = p - prev_p
            step_ok = (u == prev_u) & (u >= 0) & ((d == 1) | (d == -1))
            prev_step_ok = jnp.pad(
                step_ok[:, :-1], ((0, 0), (1, 0)), constant_values=False
            )
            prev_d = jnp.pad(d[:, :-1], ((0, 0), (1, 0)), constant_values=0)
            cont = (step_ok & ((~prev_step_ok) | (d == prev_d))) | (
                (u == prev_u) & (u < 0)
            )
            head = valid & ((w == 0) | ~cont)
            # -- compact the runs into K-capacity buffers (overflow runs
            # land in the sacrificial slot K; caller falls back)
            flat_head = head.reshape(-1)
            flat_valid = valid.reshape(-1)
            flat_u = u.reshape(-1)
            flat_p = p.reshape(-1)
            rid = jnp.cumsum(flat_head.astype(jnp.int32)) - 1
            n_runs = rid[-1] + 1
            tgt_h = jnp.where(flat_head & (rid < K), rid, K)
            u0 = jnp.zeros(K + 1, jnp.int32).at[tgt_h].set(flat_u)
            p0 = jnp.zeros(K + 1, jnp.int32).at[tgt_h].set(flat_p)
            tgt_v = jnp.where(flat_valid & (rid >= 0) & (rid < K), rid, K)
            rl = jnp.zeros(K + 1, jnp.int32).at[tgt_v].add(1)
            nxt_head = jnp.concatenate(
                [flat_head[1:], jnp.ones(1, dtype=flat_head.dtype)]
            )
            nxt_valid = jnp.concatenate(
                [flat_valid[1:], jnp.zeros(1, dtype=flat_valid.dtype)]
            )
            last = flat_valid & (nxt_head | ~nxt_valid)
            tgt_l = jnp.where(last & (rid >= 0) & (rid < K), rid, K)
            p1 = jnp.zeros(K + 1, jnp.int32).at[tgt_l].set(flat_p)
            stats = jnp.stack([n_runs, kf, kr])
            return u0[:K], p0[:K], p1[:K], rl[:K], stats

        cache[(B2, Wp, K)] = merge_rle
        return merge_rle

    # ---------------- per-read CLI-parity API ----------------

    def search_fwd_rc(self, read: bytes) -> Tuple[QueryResult, QueryResult]:
        """Forward and reverse-complement QueryResults for one read,
        matching FinimizerIndex.search semantics (incl. empty result for
        non-ACGT reads and reads shorter than k)."""
        lines = self.process_reads([read])
        return lines[0]

    def _encode_both_strands(self, reads: Sequence[bytes]):
        """Encode, filter short/invalid reads, pad, and stack forward +
        reverse-complement strands in ONE (2B, L) host batch, strand-
        interleaved (row 2j = read j forward, row 2j+1 = its RC). The
        interleave makes the fwd/RC pairing a STATIC stride-2 slice on
        device, independent of the dynamic read count, so the device
        merge kernel compiles once per padded shape. Returns (batch_idx,
        batch_codes, both) with both None when every read was
        filtered."""
        from finito_tpu.io.seqdb import encode_seq

        k = self.k
        batch_idx: List[int] = []
        batch_codes: List[np.ndarray] = []
        for i, read in enumerate(reads):
            codes = encode_seq(read if isinstance(read, bytes) else read.encode())
            if codes.size >= k and not np.any(codes == 255):
                batch_idx.append(i)
                batch_codes.append(codes)
        if not batch_idx:
            return batch_idx, batch_codes, None
        L = max(c.size for c in batch_codes)
        B = len(batch_codes)
        both = np.full((2 * B, L), 255, dtype=np.uint8)
        for j, c in enumerate(batch_codes):
            both[2 * j, : c.size] = c
            both[2 * j + 1, : c.size] = (3 - c)[::-1]
        return batch_idx, batch_codes, both

    def _batch_both_strands(self, reads: Sequence[bytes]):
        """_encode_both_strands + locate: returns (batch_idx,
        batch_codes, uid_b, off_b) with uid_b/off_b None when every read
        was filtered."""
        batch_idx, batch_codes, both = self._encode_both_strands(reads)
        if both is None:
            return batch_idx, batch_codes, None, None
        uid_b, off_b = self.locate_batch(both)
        return batch_idx, batch_codes, uid_b, off_b

    def locate_reads_arrays(self, reads: Sequence[bytes]):
        """Array-native batched fwd+RC localization: returns per read i
        either None (short/invalid read: empty result) or
        (uid_f, off_f, uid_r, off_r, n_found_f, n_found_r) with (W,)
        int arrays -- the zero-tuple-materialization path for bulk CLI
        output."""
        k = self.k
        out = [None] * len(reads)
        batch_idx, batch_codes, uid_b, off_b = self._batch_both_strands(reads)
        if uid_b is not None:
            for j, i in enumerate(batch_idx):
                n = batch_codes[j].size - k + 1
                uf, of = uid_b[2 * j, :n], off_b[2 * j, :n]
                ur, orr = uid_b[2 * j + 1, :n], off_b[2 * j + 1, :n]
                out[i] = (
                    uf, of, ur, orr,
                    int(np.count_nonzero(uf >= 0)),
                    int(np.count_nonzero(ur >= 0)),
                )
        return out

    def merged_pairs_flat(self, reads: Sequence[bytes]):
        """Bulk-output form of the fwd+RC merge: returns
        (line_lens, u_flat, p_flat, kmers_fwd, kmers_rc) where
        line_lens[i] is the pair count of read i (0 for short/invalid
        reads, which emit an empty line) and the flat int32 streams hold
        the merged (u, p) pairs in read order.

        Fast path: the merge and a run-length encoding run ON DEVICE
        (`_merge_rle_fn`), so only O(runs) is read back; the flat
        streams are re-expanded host-side with np.repeat. Falls back to
        a full-window readback + host merge when the input doesn't
        compress (n_runs > capacity)."""
        return self.merged_pairs_flat_end(self.merged_pairs_flat_begin(reads))

    def merged_pairs_flat_begin(self, reads: Sequence[bytes]):
        """Dispatch half of merged_pairs_flat: encode + locate + device
        merge/RLE, all async -- the capacity check that used to block
        here is deferred to _end via _locate_batch_deferred, so this
        half really is sync-free for the minimizer engine. Returns an
        opaque handle for merged_pairs_flat_end. The split lets the CLI
        double-buffer chunks (dispatch chunk n+1 before reading back
        chunk n) so device compute runs under the host's line formatting
        and file writes."""
        k = self.k
        line_lens = np.zeros(len(reads), np.int64)
        batch_idx, batch_codes, both = self._encode_both_strands(reads)
        if both is None:
            return (line_lens, None)
        lens = np.array([c.size - k + 1 for c in batch_codes], dtype=np.int64)
        line_lens[np.asarray(batch_idx, dtype=np.int64)] = lens
        uid_d, off_d, _, _, verify = self._locate_batch_deferred(both)
        B2, Wp = int(uid_d.shape[0]), int(uid_d.shape[1])
        lens_pad = np.zeros(B2 // 2, np.int32)
        lens_pad[: len(batch_codes)] = lens
        K = int(min((B2 // 2) * Wp, max(4096, 16 * (B2 // 2))))
        out = self._merge_rle_fn(B2, Wp, K)(uid_d, off_d, jnp.asarray(lens_pad))
        return (line_lens, (batch_codes, lens, uid_d, off_d, K, out,
                            verify, lens_pad))

    def merged_pairs_flat_end(self, handle):
        """Readback half of merged_pairs_flat_begin: O(runs) transfer +
        host re-expansion (or the full-window fallback on overflow)."""
        line_lens, rest = handle
        if rest is None:
            z = np.zeros(0, np.int32)
            return line_lens, z, z, 0, 0
        (batch_codes, lens, uid_d, off_d, K, out, verify, lens_pad) = rest
        if verify is not None:
            fixed = verify()
            if fixed is not None:
                # rare slow-path overflow: the optimistic locate (and the
                # merge chained on it) were invalid; redo both exactly
                uid_d, off_d = fixed
                B2, Wp = int(uid_d.shape[0]), int(uid_d.shape[1])
                out = self._merge_rle_fn(B2, Wp, K)(
                    uid_d, off_d, jnp.asarray(lens_pad)
                )
        (u0d, p0d, p1d, rld, stats) = out
        n_runs, kf, kr = (int(x) for x in np.asarray(stats))
        if n_runs > K:
            return self._merged_pairs_host(
                line_lens, batch_codes, lens, np.asarray(uid_d), np.asarray(off_d)
            )
        R = n_runs
        u0 = np.asarray(u0d[:R])
        p0 = np.asarray(p0d[:R])
        p1 = np.asarray(p1d[:R])
        rl = np.asarray(rld[:R]).astype(np.int64)
        total = int(rl.sum())
        starts = np.cumsum(rl) - rl
        u = np.repeat(u0, rl)
        step = np.sign(p1 - p0)
        off_in = np.arange(total, dtype=np.int64) - np.repeat(starts, rl)
        p = np.repeat(p0.astype(np.int64), rl) + np.repeat(step, rl) * off_in
        return line_lens, u.astype(np.int32), p.astype(np.int32), kf, kr

    def _merged_pairs_host(self, line_lens, batch_codes, lens, uid_b, off_b):
        """Full-window host merge (the pre-RLE path); also the fallback
        arbiter the RLE path is differentially tested against."""
        B = len(batch_codes)
        total = int(lens.sum())
        j_of = np.repeat(np.arange(B), lens)
        w_of = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
        )
        uf = uid_b[2 * j_of, w_of]
        of_ = off_b[2 * j_of, w_of]
        w_rc = lens[j_of] - 1 - w_of
        ur = uid_b[2 * j_of + 1, w_rc]
        orr = off_b[2 * j_of + 1, w_rc]
        absent = uf == -1
        u = np.where(absent, ur, uf).astype(np.int32)
        p = np.where(absent, orr, of_).astype(np.int32)
        # ur gathered at the mirrored windows is a permutation of the RC
        # row's valid windows, so counting it counts the RC strand
        kf = int(np.count_nonzero(uf >= 0))
        kr = int(np.count_nonzero(ur >= 0))
        return line_lens, u, p, kf, kr

    def process_reads(self, reads: Sequence[bytes]) -> List[Tuple[QueryResult, QueryResult]]:
        k = self.k
        # reference: short reads emit nothing; invalid reads return {}
        results: List[Tuple[QueryResult, QueryResult]] = [
            (QueryResult([], 0), QueryResult([], 0)) for _ in reads
        ]
        batch_idx, batch_codes, uid_b, off_b = self._batch_both_strands(reads)
        if uid_b is not None:
            for j, i in enumerate(batch_idx):
                n = batch_codes[j].size - k + 1
                f = QueryResult(
                    [(int(uid_b[2 * j, w]), int(off_b[2 * j, w])) for w in range(n)],
                    int(np.count_nonzero(uid_b[2 * j, :n] >= 0)),
                )
                r = QueryResult(
                    [(int(uid_b[2 * j + 1, w]), int(off_b[2 * j + 1, w])) for w in range(n)],
                    int(np.count_nonzero(uid_b[2 * j + 1, :n] >= 0)),
                )
                results[i] = (f, r)
        return results
