"""Mesh-sharded SBWT construction: distributed sample-sort on the device mesh.

The multi-chip BUILD path for the plain-matrix SBWT (SURVEY.md section 7
phase 2 "multi-host sample-sort", phase 7 "sharded-SBWT variant"): the
single-host constructor (sbwt/construct.py:107, itself the TPU-native
replacement for the reference's NodeBOSSInMemoryConstructor, see
/root/reference/src/tests.cpp:44-46) needs the whole k-mer set in one
address space; at genome scale that host sort is the binding constraint.
Here every set operation of the construction runs sharded over all mesh
devices with XLA collectives:

  * k-mer windows are packed shard-locally, then SAMPLE-SORTED over the
    mesh: each shard radix-sorts its windows (LSD over uint32 planes,
    ops.keys_jax), routes them to the shard owning their splitter bucket
    with one padded `all_to_all`, and dedups locally -- equal keys land
    on one shard by construction, so local dedup is global dedup.
  * source detection ((k-1)-prefix not among (k-1)-suffixes) is a
    distributed hash-join: both sides re-route by a common (k-1)-space
    splitter set, membership resolves shard-locally by combined sort,
    and answers ride the inverse `all_to_all` back to the querying slot.
  * $-padded dummies are generated shard-locally from the compacted
    sources and merged with the k-mers by a second sample-sort round,
    yielding the node set colex-sharded in contiguous ranges.
  * in-edges: suffix-group firsts are found with a halo `ppermute`
    (groups may straddle shard seams), the (group suffix -> global first
    index) map and the per-node prefix queries meet by the same
    (k-1)-space routing, and the resulting (target, char) edge bits are
    routed once more by node-range ownership and scattered into the
    shard-local bit rows.

All exchanges use static-capacity blocks (all_to_all needs equal block
shapes under jit); capacities come from exact counts where a prior pass
provides them (the window exchange) and from slack + overflow-retry
elsewhere (each phase psums an overflow count; the host doubles the
capacity and re-runs on overflow -- exactness is never traded away).

Output equals build_plain_matrix_sbwt bit-for-bit (tests/test_shard_build).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from finito_tpu.ops import keys_jax as kj
from finito_tpu.sbwt import keys as kw
from finito_tpu.sbwt.sbwt import PlainMatrixSBWT

SENT32 = jnp.uint32(0xFFFFFFFF)


def _host(x) -> np.ndarray:
    """Host copy of a (possibly cross-process) mesh-sharded array. With
    one process this is np.asarray; under multi-process SPMD the shards
    on other hosts are not addressable, so gather them with a tiled
    process_allgather (the control plane is small -- overflow counters,
    per-shard counts -- except the final bit-rows/node assembly, whose
    fully-distributed form is the sharded query path's job)."""
    import jax as _jax

    if _jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _resent(keys, mask):
    """Force rows where mask is True back to the sentinel (key algebra
    ops on sentinel rows produce valid-looking garbage otherwise)."""
    return jnp.where(mask[:, None], SENT32, keys)


def _exchange(keys, splitters, S, M, payloads=()):
    """Sample-sort exchange inside shard_map: route every non-sentinel
    row to the shard owning its splitter bucket, as one padded
    all_to_all of (S, M)-blocked rows (+ aligned int32 payloads).

    Returns (recv_keys (S*M, P), recv_payloads, overflow_count, order,
    slot, ok): `order`/`slot`/`ok` let the caller scatter per-slot
    ANSWERS (from the inverse all_to_all) back onto its local rows."""
    n, Pp = keys.shape
    order = kj.argsort_rows(keys)
    skeys = jnp.take(keys, order, axis=0)
    spay = [jnp.take(p, order) for p in payloads]
    b = kj.bucket_of(skeys, splitters)  # monotone over the sorted keys
    start = jnp.searchsorted(b, jnp.arange(S, dtype=b.dtype), side="left")
    off = jnp.arange(n, dtype=jnp.int32) - jnp.take(start, jnp.minimum(b, S - 1))
    sent = kj.is_sentinel(skeys)
    ok = (~sent) & (off < M)
    overflow = jnp.sum(((~sent) & (off >= M)).astype(jnp.int32))
    slot = jnp.where(ok, b * M + off, S * M)
    send = kj.sentinel_rows(S * M + 1, Pp).at[slot].set(skeys)[: S * M]
    recv = lax.all_to_all(send, "D", 0, 0, tiled=True)
    rpay = []
    for p in spay:
        ps = jnp.full(S * M + 1, -1, jnp.int32).at[slot].set(p)[: S * M]
        rpay.append(lax.all_to_all(ps, "D", 0, 0, tiled=True))
    return recv, rpay, overflow, order, slot, ok


def _answers_back(ans, order, slot, ok, n, S, M):
    """Inverse all_to_all of per-slot answers -> per-local-row answers
    (-1 where the row wasn't sent)."""
    back = lax.all_to_all(ans, "D", 0, 0, tiled=True)
    got = jnp.where(ok, jnp.take(back, jnp.minimum(slot, S * M - 1)), -1)
    return jnp.full(n, -1, jnp.int32).at[order].set(got)


def _sort_dedup_compact(recv, cap):
    """Sort received rows, drop duplicates and sentinels, compact to the
    front (scatter at cumsum positions preserves order); returns
    (keys (cap, P) sentinel-padded, count)."""
    Pp = recv.shape[1]
    r = jnp.take(recv, kj.argsort_rows(recv), axis=0)
    keep = (~kj.eq_adjacent_rows(r)) & (~kj.is_sentinel(r))
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    m = jnp.sum(keep.astype(jnp.int32))
    out = kj.sentinel_rows(cap + 1, Pp).at[
        jnp.where(keep, jnp.minimum(pos, cap), cap)
    ].set(r)[:cap]
    return out, m


def _flat_mesh(mesh_or_n) -> Mesh:
    if isinstance(mesh_or_n, Mesh):
        devs = mesh_or_n.devices.reshape(-1)
    else:
        devs = np.array(jax.devices()[:mesh_or_n])
    return Mesh(devs.reshape(-1), ("D",))


def _put(mesh, x, spec):
    """device_put onto a mesh sharding; under multi-process SPMD the
    target sharding spans non-addressable devices, so build the global
    array from the (host-replicated) value via make_array_from_callback
    (the callback is only invoked for this process's shards)."""
    sh = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(x, sh)
    xa = np.asarray(x)
    return jax.make_array_from_callback(xa.shape, sh, lambda idx: xa[idx])


def _put_shard_blocks(mesh, block_fn, spec):
    """Assemble a mesh-sharded (S, ...) global array by materializing
    ONLY the shards owned by this process: block_fn(s) -> host block for
    shard s, called once per ADDRESSABLE device and freed right after
    its device_put. Host working set peaks at one shard's block (the
    round-3 builds staged the whole (S, ...) stack through one host
    array), and under multi-process SPMD remote shards are never even
    computed -- each host packs 1/n_processes of the problem."""
    devs = list(mesh.devices.reshape(-1))
    me = jax.process_index()
    parts = []
    for s, d in enumerate(devs):
        if d.process_index != me:
            continue
        b = block_fn(s)
        parts.append(jax.device_put(b[None], d))
        del b
    shape = (len(devs),) + tuple(parts[0].shape[1:])
    return jax.make_array_from_single_device_arrays(
        shape, NamedSharding(mesh, spec), parts
    )


def _host_splitters(samples: List[np.ndarray], S: int, Pp: int) -> np.ndarray:
    """S-1 quantile splitters from a small host sample (the control
    plane: a few KB; the data plane stays on device)."""
    planes = kj.from_host(kw.sort_keys(samples))
    n = planes.shape[0]
    if n == 0:
        return np.full((S - 1, Pp), 0xFFFFFFFF, np.uint32)
    idx = ((np.arange(1, S) * n) // S).clip(0, n - 1)
    return planes[idx]


def _pack_shards(segs: Sequence[np.ndarray], k: int, S: int, key_fn, mesh):
    """Host prep shared by the mesh builders: greedy contiguous split of
    the segments over S shards by window count, per-shard packing via
    key_fn(seg) -> key word list, and a strided per-shard splitter
    sample (a few KB -- the full key sets are never concatenated on the
    host). Shards are packed ONE AT A TIME and streamed to their
    devices (_put_shard_blocks), so the host working set peaks at a
    single shard's padded block, not the (S, N0, P) stack.

    Returns (keys0 global (S, N0, P) device array, shard_sample,
    total_windows)."""
    Pp = kj.n_planes(k)
    wins = np.array([c.size - k + 1 for c in segs], np.int64)
    total = int(wins.sum())
    if total == 0:
        raise ValueError("no k-mers in input")
    bounds = np.searchsorted(np.cumsum(wins), np.arange(1, S) * (total / S))
    groups = np.split(np.arange(len(segs)), bounds)
    W = (3 * k + 63) // 64
    # one window per position of each segment, so the padded block size
    # is known without packing (key_fn preserves window count)
    N0 = max(1, max((int(wins[g].sum()) for g in groups), default=1))

    def block(s):
        g = groups[s]
        ks = kw.concat([key_fn(segs[i]) for i in g]) if len(g) else kw.empty(W)
        blk = np.full((N0, Pp), 0xFFFFFFFF, np.uint32)
        if ks[0].size:
            blk[: ks[0].size] = kj.from_host(ks)
        return blk

    keys0 = _put_shard_blocks(mesh, block, P("D", None, None))
    # splitter sample: strided single windows packed straight from the
    # segments -- rank-independent (every process sees the SAME sample
    # regardless of which shards it owns) and O(64*S) windows of work
    stride = max(1, total // (64 * S))
    samples = []
    g0 = 0
    nxt = 0
    for seg in segs:
        w = seg.size - k + 1
        while nxt < g0 + w:
            i = nxt - g0
            samples.append(key_fn(seg[i : i + k]))
            nxt += stride
        g0 += w
    sample = kw.concat(samples) if samples else kw.empty(W)
    return keys0, sample, total


def sharded_sbwt_build(
    seqs: Sequence,
    k: int,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    slack: float = 1.5,
    return_keys: bool = False,
):
    """Build the plain-matrix SBWT of `seqs` with the node set sharded
    over the mesh (see module docstring). Returns PlainMatrixSBWT
    (+ the colex-sorted node keys if return_keys), bit-identical to
    build_plain_matrix_sbwt."""
    from finito_tpu.io.seqdb import encode_seq

    if k < 2:
        raise ValueError("k must be >= 2")
    mesh = _flat_mesh(mesh if mesh is not None else (n_devices or len(jax.devices())))
    S = mesh.devices.size
    Pp = kj.n_planes(k)

    # ---- host prep: encode, split contiguously by window count, pack
    codes_all = []
    for s in seqs:
        codes = s if isinstance(s, np.ndarray) else encode_seq(
            s if isinstance(s, bytes) else s.encode()
        )
        if np.any(codes == 255):
            raise ValueError("Invalid character in input sequence (only ACGT allowed)")
        if codes.size >= k:
            codes_all.append(codes)
    # greedy contiguous split (per-shard host packing mirrors per-host IO)
    keys0, sample, total = _pack_shards(
        codes_all, k, S, lambda seg: kw.pack_windows(seg, k), mesh
    )

    # splitters: node-key space (1) and (k-1)-suffix space (2)
    spl1 = _host_splitters(sample, S, Pp)
    spl2 = _host_splitters(kw.shift_right3(sample), S, Pp)

    dspec, rep = P("D"), P(*([None] * 2))

    # ---- phase A: local sort + exact per-bucket counts
    def _sortA(keys, spl):
        ks = keys[0]
        sk = jnp.take(ks, kj.argsort_rows(ks), axis=0)
        b = kj.bucket_of(sk, spl)
        cnt = jnp.zeros(S, jnp.int32).at[b].add(
            (~kj.is_sentinel(sk)).astype(jnp.int32)
        )
        return sk[None], cnt[None]

    skeys, counts = jax.jit(
        shard_map(_sortA, mesh=mesh, in_specs=(P("D", None, None), rep),
                  out_specs=(P("D", None, None), P("D", None)))
    )(keys0, _put(mesh, spl1, rep))
    M1 = max(1, int(_host(counts).max()))  # exact: no overflow possible
    R1 = S * M1

    # ---- phase B: window exchange + dedup -> distinct k-mers, sharded
    def _phaseB(sk, spl):
        recv, _, ovf, _, _, _ = _exchange(sk[0], spl, S, M1)
        kmers, m = _sort_dedup_compact(recv, R1)
        return kmers[None], m[None], ovf[None]

    kmers, m_s, ovfB = jax.jit(
        shard_map(_phaseB, mesh=mesh, in_specs=(P("D", None, None), rep),
                  out_specs=(P("D", None, None), P("D"), P("D")))
    )(skeys, _put(mesh, spl1, rep))
    assert int(_host(ovfB).sum()) == 0
    m_host = _host(m_s).astype(np.int64)
    n_kmers = int(m_host.sum())

    # ---- phase C: sources ((k-1)-prefix not among (k-1)-suffixes)
    M2 = max(1, int(np.ceil(slack * R1 / S)))
    while True:
        def _phaseC(km_in, spl):
            km = km_in[0]
            sent = kj.is_sentinel(km)
            suf = _resent(kj.shift_right3_rows(km), sent)
            pre = _resent(kj.mask_low_rows(km, k - 1), sent)
            recvR, _, ovf1, _, _, _ = _exchange(suf, spl, S, M2)
            qidx = jnp.arange(km.shape[0], dtype=jnp.int32)
            recvQ, _, ovf2, order, slot, ok = _exchange(
                pre, spl, S, M2, payloads=(qidx,)
            )
            vals = jnp.where(kj.is_sentinel(recvR), -1, 1).astype(jnp.int32)
            ans = kj.match_rows(recvQ, recvR, vals)
            got = _answers_back(ans, order, slot, ok, km.shape[0], S, M2)
            is_src = (~sent) & (got < 0)
            return is_src[None], jnp.sum(is_src.astype(jnp.int32))[None], (ovf1 + ovf2)[None]

        is_source, n_src, ovfC = jax.jit(
            shard_map(_phaseC, mesh=mesh, in_specs=(P("D", None, None), rep),
                      out_specs=(P("D", None), P("D"), P("D")))
        )(kmers, _put(mesh, spl2, rep))
        if int(_host(ovfC).sum()) == 0:
            break
        M2 *= 2
    cap_src = max(1, int(_host(n_src).max()))

    # ---- phase D: dummies + node sample-sort
    send_max = R1 + (k - 1) * cap_src + 1
    M3 = max(1, int(np.ceil(slack * send_max / S)))
    while True:
        capN = S * M3

        def _phaseD(km_in, src_in, spl):
            km, src_mask = km_in[0], src_in[0]
            pos = jnp.cumsum(src_mask.astype(jnp.int32)) - 1
            srcbuf = kj.sentinel_rows(cap_src + 1, Pp).at[
                jnp.where(src_mask, jnp.minimum(pos, cap_src), cap_src)
            ].set(km)[:cap_src]
            ssent = kj.is_sentinel(srcbuf)
            blocks = [km]
            for j in range(1, k):
                blocks.append(
                    _resent(
                        kj.shift_left_rows(kj.mask_low_rows(srcbuf, j), k - j),
                        ssent,
                    )
                )
            sid = lax.axis_index("D")
            root = jnp.where(
                sid == 0, jnp.zeros((1, Pp), jnp.uint32), kj.sentinel_rows(1, Pp)
            )
            allk = jnp.concatenate(blocks + [root], axis=0)
            recv, _, ovf, _, _, _ = _exchange(allk, spl, S, M3)
            nodes, mn = _sort_dedup_compact(recv, capN)
            return nodes[None], mn[None], ovf[None]

        nodes, mn_s, ovfD = jax.jit(
            shard_map(_phaseD, mesh=mesh,
                      in_specs=(P("D", None, None), P("D", None), rep),
                      out_specs=(P("D", None, None), P("D"), P("D")))
        )(kmers, is_source, _put(mesh, spl1, rep))
        if int(_host(ovfD).sum()) == 0:
            break
        M3 *= 2
    mn_host = _host(mn_s).astype(np.int64)
    n_nodes = int(mn_host.sum())
    node_start = np.zeros(S, np.int32)
    node_start[1:] = np.cumsum(mn_host)[:-1].astype(np.int32)
    capN = S * M3

    # ---- phase E: suffix-group firsts + in-edges -> sharded bit rows
    M4 = max(1, int(np.ceil(slack * capN / S)))
    M5 = max(1, int(np.ceil(slack * capN / S)))
    while True:
        def _phaseE(nd_in, mn_in, nstart, spl):
            nd, m = nd_in[0], mn_in[0]
            cN = nd.shape[0]
            idx = jnp.arange(cN, dtype=jnp.int32)
            valid = idx < m
            nsuf = _resent(kj.shift_right3_rows(nd), ~valid)
            sid = lax.axis_index("D")
            # halo: last valid suffix of the nearest non-empty shard left
            last = jnp.take(nsuf, jnp.maximum(m - 1, 0), axis=0)
            lasts = lax.all_gather(last, "D")
            ms = lax.all_gather(m, "D")
            carry = jnp.full(Pp, SENT32)
            my_halo = carry
            for j in range(S):
                my_halo = jnp.where(sid == j, carry, my_halo)
                carry = jnp.where(ms[j] > 0, lasts[j], carry)
            prev_row = jnp.concatenate([my_halo[None], nsuf[:-1]], axis=0)
            diff = jnp.any(nsuf != prev_row, axis=1)
            gidx = jnp.take(nstart, sid) + idx
            first = valid & (diff | (gidx == 0))
            # (group suffix -> global first index) map, routed by spl2
            gkeys = _resent(nsuf, ~first)
            gvals = jnp.where(first, gidx, -1)
            recvR, rpay, ovfA, _, _, _ = _exchange(
                gkeys, spl, S, M4, payloads=(gvals,)
            )
            # per-node prefix queries
            ch = kj.top_char_rows(nd, k)
            nonroot = valid & (ch != 0)
            qk = _resent(kj.mask_low_rows(nd, k - 1), ~nonroot)
            recvQ, _, ovfB2, order, slot, ok = _exchange(
                qk, spl, S, M4, payloads=(idx,)
            )
            ans = kj.match_rows(recvQ, recvR, rpay[0])
            tf = _answers_back(ans, order, slot, ok, cN, S, M4)
            miss = jnp.sum((nonroot & (tf < 0)).astype(jnp.int32))
            # route (target_first, char) to the owning node-range shard
            eligible = nonroot & (tf >= 0)
            owner = jnp.searchsorted(nstart, jnp.maximum(tf, 0), side="right") - 1
            ownv = jnp.where(eligible, owner.astype(jnp.int32), S)
            ordE = jnp.argsort(ownv, stable=True)
            own_s = jnp.take(ownv, ordE)
            tf_s = jnp.take(tf, ordE)
            ch_s = jnp.take(ch, ordE)
            startE = jnp.searchsorted(own_s, jnp.arange(S, dtype=own_s.dtype))
            offE = idx - jnp.take(startE, jnp.minimum(own_s, S - 1))
            okE = (own_s < S) & (offE < M5)
            ovfC2 = jnp.sum(((own_s < S) & (offE >= M5)).astype(jnp.int32))
            slotE = jnp.where(okE, own_s * M5 + offE, S * M5)
            tf_send = jnp.full(S * M5 + 1, -1, jnp.int32).at[slotE].set(tf_s)[: S * M5]
            ch_send = jnp.zeros(S * M5 + 1, jnp.int32).at[slotE].set(ch_s)[: S * M5]
            tf_r = lax.all_to_all(tf_send, "D", 0, 0, tiled=True)
            ch_r = lax.all_to_all(ch_send, "D", 0, 0, tiled=True)
            okR = tf_r >= 0
            locp = tf_r - jnp.take(nstart, sid)
            bits = jnp.zeros((4, cN), jnp.uint8).at[
                jnp.where(okR, ch_r - 1, 0), jnp.where(okR, locp, cN)
            ].set(1, mode="drop")
            return bits[None], miss[None], (ovfA + ovfB2 + ovfC2)[None]

        bits_sh, miss, ovfE = jax.jit(
            shard_map(_phaseE, mesh=mesh,
                      in_specs=(P("D", None, None), P("D"), P(None), rep),
                      out_specs=(P("D", None, None), P("D"), P("D")))
        )(nodes, mn_s, _put(mesh, node_start, P(None)), _put(mesh, spl2, rep))
        if int(_host(ovfE).sum()) == 0:
            break
        M4 *= 2
        M5 *= 2
    if int(_host(miss).sum()) != 0:
        raise AssertionError("sharded SBWT construction: missing predecessor group")

    bits = _host(bits_sh)  # (S, 4, capN)
    bit_rows = np.concatenate(
        [bits[s][:, : mn_host[s]] for s in range(S)], axis=1
    )
    sbwt = PlainMatrixSBWT.from_bit_rows(bit_rows, k=k, n_kmers=n_kmers)
    if return_keys:
        planes = _host(nodes)
        segs = [planes[s, : mn_host[s]] for s in range(S)]
        node_keys = kj.to_host(np.concatenate(segs, axis=0))
        return sbwt, node_keys
    return sbwt


def _route_by_owner(own, payloads, S, M):
    """Route int32 payload rows to the shard named by `own` (entries == S
    are dropped), as one padded all_to_all per payload. Returns
    (received payloads each (S*M,), overflow count). Received fill is -1
    for payload 0 (the validity channel) and 0 elsewhere."""
    n = own.shape[0]
    order = jnp.argsort(own, stable=True)
    own_s = jnp.take(own, order)
    start = jnp.searchsorted(own_s, jnp.arange(S, dtype=own_s.dtype))
    off = jnp.arange(n, dtype=jnp.int32) - jnp.take(start, jnp.minimum(own_s, S - 1))
    ok = (own_s < S) & (off < M)
    overflow = jnp.sum(((own_s < S) & (off >= M)).astype(jnp.int32))
    slot = jnp.where(ok, own_s * M + off, S * M)
    out = []
    for i, p in enumerate(payloads):
        ps = jnp.take(p, order)
        fill = -1 if i == 0 else 0
        send = jnp.full(S * M + 1, fill, jnp.int32).at[slot].set(ps)[: S * M]
        out.append(lax.all_to_all(send, "D", 0, 0, tiled=True))
    return out, overflow


def sharded_finimizer_select(sbwt, LCS, packed, node_keys, mesh,
                             slack: float = 1.3, return_pos: bool = False):
    """Mesh finimizer selection: the O(text) stages of FinimizerIndexBuilder
    run sharded over the device mesh (the mesh twin of the host
    `_build_fast`, finito_tpu/index/builder.py; the algorithm itself is
    the three exact reductions documented there of the reference's
    streaming scan, /root/reference/include/FinimizerIndex.hh:321-389).

    Layout: the NODE axis is sharded in S contiguous colex blocks (the
    sharded-SBWT output order), the TEXT axis in S contiguous position
    blocks. Stages:

      * window colex ranks: every text shard routes its packed window
        keys to the node shard owning them (one all_to_all; capacities
        are EXACT -- in a DSPSS each real node is hit by exactly one
        window), the owner matches them into its sorted node block and
        answers (colex, SU[colex]) back along the inverse all_to_all.
      * candidate realignment start->end positions: one k-1-element halo
        ppermute from the left neighbor; host-computed prefix candidates
        (the O(n_unitigs * k) control plane, `prefix_candidates`) are
        merged in.
      * per-window (len, colex, r) minimum: a k-step masked minimum
        chain over (hi, lo) uint32 key pairs, with a k-1 right halo
        ppermute (windows never straddle more than one seam).
      * the cross-unitig overwrite rule: (colex, local_end, order,
        global_end) rows route to the owning node shard (ownership is a
        division -- uniform blocks), where the scatter-max key
        (local_end << 33 | ~order, or order when local_end == 0) is
        resolved by one multiword sort + last-of-run pick, exactly the
        host scatter-max outcome.

    Returns (fmin_bv, global_offsets, stats) as full-length host arrays
    + a FinimizerStatsSet, all equal to the host builder's.
    """
    from finito_tpu.index.builder import FinimizerStatsSet, prefix_candidates

    mesh = _flat_mesh(mesh)
    S = mesh.devices.size
    k = sbwt.get_k()
    n_nodes = sbwt.number_of_subsets()
    Pp = kj.n_planes(k)
    concat = np.asarray(packed.concat, dtype=np.uint8)
    ends = np.asarray(packed.ends, dtype=np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    N = concat.size
    n_u = ends.size

    if n_nodes >= (1 << 31) or N + S >= (1 << 31):
        raise ValueError("sharded_finimizer_select: int32 plane encoding "
                         "requires < 2^31 nodes and text positions")
    if k > 255:
        raise ValueError("k > 255 exceeds the packed window-min encoding")
    if node_keys[0].size != n_nodes:
        raise ValueError("node_keys must cover every SBWT node (colex-sorted)")

    LCS = np.asarray(LCS, dtype=np.int64)
    su = (np.maximum(LCS, np.concatenate([LCS[1:], [0]])) + 1).astype(np.int32)

    # ---- node sharding: S uniform colex blocks (ownership = division);
    # blocks are packed lazily per ADDRESSABLE shard (_put_shard_blocks:
    # host peak = one block, remote shards never computed)
    Mn = -(-n_nodes // S)
    realmask = (node_keys[0] & np.uint64(7)) != 0  # no $ at label start
    real_counts = np.zeros(S, np.int64)
    for s in range(S):
        a, b = s * Mn, min((s + 1) * Mn, n_nodes)
        if b > a:
            real_counts[s] = int(realmask[a:b].sum())

    def node_block(s):
        a, b = s * Mn, min((s + 1) * Mn, n_nodes)
        blk = np.full((Mn, Pp), 0xFFFFFFFF, np.uint32)
        if b > a:
            blk[: b - a] = kj.from_host(kw.take(node_keys, np.arange(a, b)))
        return blk

    def su_block(s):
        a, b = s * Mn, min((s + 1) * Mn, n_nodes)
        blk = np.zeros(Mn, np.int32)
        if b > a:
            blk[: b - a] = su[a:b]
        return blk

    nodes_d = _put_shard_blocks(mesh, node_block, P("D", None, None))
    su_d = _put_shard_blocks(mesh, su_block, P("D", None))
    bidx = (np.arange(1, S) * Mn).clip(0, max(n_nodes - 1, 0))
    spl = np.where(
        (np.arange(1, S) * Mn < n_nodes)[:, None],
        kj.from_host(kw.take(node_keys, bidx)),
        np.uint32(0xFFFFFFFF),
    ).astype(np.uint32)
    M1 = max(1, int(real_counts.max()))  # exact: one window per real node

    # ---- text sharding: S contiguous position blocks, B >= k; window
    # keys are packed PER SHARD from the text slice (the whole-text
    # pack_windows staged ~24 B/window on one host before round 4)
    B = max(-(-N // S), k)
    n_pos = N - k + 1
    if n_pos <= 0:
        raise ValueError("no k-mer windows in input")
    # host control plane: prefix candidates, scattered to end-position owners
    pc_pos, pc_len, pc_colex = prefix_candidates(sbwt, su, starts, ends, concat)

    def shard_valid(s):
        a = s * B
        b = min(a + B, n_pos)
        v = np.zeros(B, np.bool_)
        if a < n_pos:
            pos_s = np.arange(a, b, dtype=np.int64)
            uid_s = np.searchsorted(ends, pos_s, side="right")
            v[: b - a] = pos_s + k <= ends[uid_s]
        return v

    # global control plane (cheap closed form, no key packing): per-shard
    # valid counts -> rank-independent order bases
    vcounts = np.array([int(shard_valid(s).sum()) for s in range(S)], np.int64)
    n_valid = int(vcounts.sum())
    base_ord = np.zeros(S, np.int32)
    base_ord[1:] = np.cumsum(vcounts)[:-1].astype(np.int32)

    def wk_block(s):
        a = s * B
        b = min(a + B, n_pos)
        blk = np.full((B, Pp), 0xFFFFFFFF, np.uint32)
        if a < n_pos:
            v = shard_valid(s)[: b - a]
            seg = kj.from_host(kw.pack_windows(concat[a : b - 1 + k], k))
            blk[: b - a][v] = seg[v]
        return blk

    def pc_block(vals, fill):
        def f(s):
            a = s * B
            blk = np.full(B, fill, np.int32)
            sel = (pc_pos >= a) & (pc_pos < a + B)
            blk[pc_pos[sel] - a] = vals[sel].astype(np.int32)
            return blk

        return f

    wk_d = _put_shard_blocks(mesh, wk_block, P("D", None, None))
    val_d = _put_shard_blocks(mesh, shard_valid, P("D", None))
    pcl_d = _put_shard_blocks(mesh, pc_block(pc_len, k + 2), P("D", None))
    pcc_d = _put_shard_blocks(mesh, pc_block(pc_colex, 0), P("D", None))

    ends32 = ends.astype(np.int32)
    starts32 = starts.astype(np.int32)
    rep = P(*([None] * 2))
    BIGHI = jnp.uint32((k + 2) << 16)

    # ---- phase A: ranks + realignment + window-min (one shard_map)
    def _phaseA(wk_in, pcl_in, pcc_in, val_in, nodes_in, su_in, spl_, base_, e32, s32):
        wk, pcl, pcc, valid = wk_in[0], pcl_in[0], pcc_in[0], val_in[0]
        nodes_l, su_l = nodes_in[0], su_in[0]
        sid = lax.axis_index("D")
        ws_pay = sid * B + jnp.arange(B, dtype=jnp.int32)
        recv, rpay, ovf, orderx, slot, ok = _exchange(
            wk, spl_, S, M1, payloads=(ws_pay,)
        )
        idx = kj.match_rows(recv, nodes_l, jnp.arange(Mn, dtype=jnp.int32))
        # per-shard dense position table: the routed window's global END
        # lands at its node's local slot (exactly one window per real
        # node in a DSPSS; dummies stay -1) -- the single-host
        # build_position_table device pass becomes a free by-product of
        # the routing this phase already does (ShardedIndex.build)
        pos_loc = jnp.full(Mn, -1, jnp.int32).at[
            jnp.where(idx >= 0, idx, Mn)
        ].set(rpay[0] + (k - 1), mode="drop")
        colex_a = jnp.where(idx >= 0, sid * Mn + idx, -1)
        su_a = jnp.where(idx >= 0, jnp.take(su_l, jnp.maximum(idx, 0)), -1)
        colex_b = _answers_back(colex_a, orderx, slot, ok, B, S, M1)
        su_b = _answers_back(su_a, orderx, slot, ok, B, S, M1)
        miss = jnp.sum((valid & (colex_b < 0)).astype(jnp.int32))
        # per-START candidate -> per-END candidate: shift right k-1 across shards
        wlen = jnp.where(valid, su_b, k + 2).astype(jnp.int32)
        wcol = jnp.where(valid, colex_b, 0).astype(jnp.int32)
        right = [(i, i + 1) for i in range(S - 1)]
        halo_l = lax.ppermute(wlen[B - (k - 1):], "D", right) if k > 1 else wlen[:0]
        halo_c = lax.ppermute(wcol[B - (k - 1):], "D", right) if k > 1 else wcol[:0]
        halo_l = jnp.where(sid == 0, k + 2, halo_l)
        halo_c = jnp.where(sid == 0, 0, halo_c)
        e_len = jnp.concatenate([halo_l, wlen[: B - (k - 1)]]) if k > 1 else wlen
        e_col = jnp.concatenate([halo_c, wcol[: B - (k - 1)]]) if k > 1 else wcol
        has_pc = pcl <= k + 1
        e_len = jnp.where(has_pc, pcl, e_len)
        e_col = jnp.where(has_pc, pcc, e_col)
        e_hi = (e_len.astype(jnp.uint32) << 16) | (e_col >> 15).astype(jnp.uint32)
        e_lo = ((e_col & 0x7FFF) << 8).astype(jnp.uint32)
        # right halo for the window minimum (ends t1 .. t1+k-2)
        left = [(i + 1, i) for i in range(S - 1)]
        rh_hi = lax.ppermute(e_hi[: k - 1], "D", left) if k > 1 else e_hi[:0]
        rh_lo = lax.ppermute(e_lo[: k - 1], "D", left) if k > 1 else e_lo[:0]
        rh_hi = jnp.where(sid == S - 1, BIGHI, rh_hi)
        rh_lo = jnp.where(sid == S - 1, jnp.uint32(0), rh_lo)
        ext_hi = jnp.concatenate([e_hi, rh_hi])
        ext_lo = jnp.concatenate([e_lo, rh_lo])

        def body(r, st):
            fh, fl = st
            ch = lax.dynamic_slice_in_dim(ext_hi, r, B)
            cl = lax.dynamic_slice_in_dim(ext_lo, r, B) | r.astype(jnp.uint32)
            bad = (ch >> 16) > (r + 1).astype(jnp.uint32)
            ch = jnp.where(bad, BIGHI, ch)
            cl = jnp.where(bad, jnp.uint32(0), cl)
            take = (ch < fh) | ((ch == fh) & (cl < fl))
            return jnp.where(take, ch, fh), jnp.where(take, cl, fl)

        fin_hi, fin_lo = lax.fori_loop(
            0, k, body, (jnp.full(B, BIGHI), jnp.zeros(B, jnp.uint32))
        )
        none_cnt = jnp.sum((valid & (fin_hi >= BIGHI)).astype(jnp.int32))
        fin_col = (((fin_hi & 0xFFFF) << 15) | (fin_lo >> 8)).astype(jnp.int32)
        fin_r = (fin_lo & 0xFF).astype(jnp.int32)
        ws_g = sid * B + jnp.arange(B, dtype=jnp.int32)
        uid = jnp.searchsorted(e32, ws_g, side="right")
        st_u = jnp.take(s32, jnp.minimum(uid, n_u - 1))
        local_end = ws_g - st_u + fin_r
        g_end = ws_g + fin_r
        order_g = jnp.take(base_, sid) + jnp.cumsum(valid.astype(jnp.int32)) - 1
        return (
            fin_col[None], local_end[None], order_g[None], g_end[None],
            valid[None], pos_loc[None], miss[None], ovf[None], none_cnt[None],
        )

    outs = jax.jit(
        shard_map(
            _phaseA, mesh=mesh,
            in_specs=(P("D", None, None), P("D", None), P("D", None), P("D", None),
                      P("D", None, None), P("D", None), rep, P(None), P(None), P(None)),
            out_specs=(P("D", None),) * 6 + (P("D"),) * 3,
            check_vma=False,
        )
    )(
        wk_d,
        pcl_d,
        pcc_d,
        val_d,
        nodes_d,
        su_d,
        _put(mesh, spl, rep),
        _put(mesh, base_ord, P(None)),
        _put(mesh, ends32, P(None)),
        _put(mesh, starts32, P(None)),
    )
    (fin_col, local_end, order_g, g_end, valid_d, pos_sh, miss, ovfA,
     none_cnt) = outs
    if int(_host(miss).sum()) != 0:
        raise AssertionError("sharded finimizer build: window k-mer missing "
                             "from the node set (input not a DSPSS?)")
    assert int(_host(ovfA).sum()) == 0  # capacities are exact
    if int(_host(none_cnt).sum()) != 0:
        raise AssertionError("sharded finimizer build: window without a "
                             "candidate (impossible for a valid t=1 DSPSS)")
    if int(_host(local_end).max(initial=0)) >= (1 << 30):
        raise ValueError("unitig longer than 2^30: scatter key overflow")

    # ---- phase B: route rows to node owners, resolve the overwrite rule
    M2 = max(1, int(np.ceil(slack * n_valid / S)))
    while True:
        def _phaseB(col_in, le_in, od_in, ge_in, val_in):
            col, le, od, ge = col_in[0], le_in[0], od_in[0], ge_in[0]
            valid = val_in[0]
            sid = lax.axis_index("D")
            own = jnp.where(valid, col // Mn, S)
            (col_r, le_r, od_r, ge_r), ovf = _route_by_owner(
                own, (col, le, od, ge), S, M2
            )
            got = col_r >= 0
            coll = jnp.where(got, col_r - sid * Mn, 0)
            # scatter-max key (local_end << 33 | (2^33-1 - order), or order
            # when local_end == 0), split into uint32 (hi, lo) planes:
            # order < 2^31 makes bit 32 of (2^33-1 - order) always 1.
            key_hi = jnp.where(
                le_r > 0, ((le_r << 1) | 1).astype(jnp.uint32), jnp.uint32(0)
            )
            key_lo = jnp.where(
                le_r > 0,
                jnp.uint32(0xFFFFFFFF) - od_r.astype(jnp.uint32),
                od_r.astype(jnp.uint32),
            )
            planes = jnp.stack(
                [key_lo, key_hi,
                 jnp.where(got, coll.astype(jnp.uint32), jnp.uint32(0xFFFFFFFF))],
                axis=1,
            )
            order2 = kj.argsort_rows(planes)
            s_col = jnp.take(coll, order2)
            s_ge = jnp.take(ge_r, order2)
            s_got = jnp.take(got, order2)
            nxt_col = jnp.concatenate([s_col[1:], jnp.full(1, -1, jnp.int32)])
            nxt_got = jnp.concatenate([s_got[1:], jnp.zeros(1, bool)])
            winner = s_got & ((s_col != nxt_col) | (~nxt_got))
            fmin_loc = jnp.zeros(Mn, jnp.uint8).at[
                jnp.where(s_got, s_col, Mn)
            ].set(1, mode="drop")
            glob_loc = jnp.zeros(Mn, jnp.int32).at[
                jnp.where(winner, s_col, Mn)
            ].set(s_ge, mode="drop")
            return fmin_loc[None], glob_loc[None], ovf[None]

        fmin_sh, glob_sh, ovfB = jax.jit(
            shard_map(_phaseB, mesh=mesh,
                      in_specs=(P("D", None),) * 5,
                      out_specs=(P("D", None), P("D", None), P("D")),
                      check_vma=False)
        )(fin_col, local_end, order_g, g_end, valid_d)
        if int(_host(ovfB).sum()) == 0:
            break
        M2 *= 2

    fmin_bv = _host(fmin_sh).reshape(-1)[:n_nodes].astype(np.uint8)
    global_offsets = (
        _host(glob_sh).reshape(-1)[:n_nodes].astype(np.int64).clip(0)
        .astype(np.uint64)
    )
    marked = np.flatnonzero(fmin_bv).astype(np.int64)
    stats_packed = np.sort((su[marked].astype(np.int64) << 41) | (marked << 1))
    stats = FinimizerStatsSet(stats_packed, n_nodes)
    if return_pos:
        # per-shard dense position slices (colex blocks of width Mn),
        # pulled shard by shard from the device array -- the input to
        # ShardedIndex.build (parallel.mesh): no single-host device
        # build_position_table pass is ever run on this path
        pos_shards = [
            np.asarray(sd.data).reshape(-1) for sd in sorted(
                pos_sh.addressable_shards, key=lambda sd: sd.index[0].start or 0
            )
        ]
        return fmin_bv, global_offsets, stats, (pos_shards, Mn)
    return fmin_bv, global_offsets, stats


def sharded_index_build(seqs, k: int, mesh=None, n_devices: Optional[int] = None):
    """End-to-end mesh-sharded finimizer index construction: sharded
    sample-sort SBWT (sharded_sbwt_build) -> node-sharded LCS rounds
    (parallel.mesh.sharded_lcs_fn) -> mesh finimizer selection
    (sharded_finimizer_select). Every O(text)/O(nodes) stage runs on the
    device mesh; the host keeps only the O(n_unitigs * k) control plane
    (unitig permutation + prefix candidates). Output equals
    FinimizerIndexBuilder's index (tests/test_shard_build.py)."""
    from finito_tpu.index.index import FinimizerIndex
    from finito_tpu.index.packed_strings import permute_unitigs
    from finito_tpu.io.seqdb import SeqDB
    from finito_tpu.parallel.mesh import sharded_lcs_fn
    from finito_tpu.utils.bits import bit_width_for_max

    mesh = _flat_mesh(mesh if mesh is not None else (n_devices or len(jax.devices())))
    if not isinstance(seqs, SeqDB):
        seqs_b = [s if isinstance(s, bytes) else s.encode() for s in seqs]
        unitigs = SeqDB.from_sequences(seqs_b)
    else:
        unitigs = seqs
    sbwt, node_keys = sharded_sbwt_build(
        [unitigs.get_codes(i) for i in range(len(unitigs))], k, mesh=mesh,
        return_keys=True,
    )
    LCS = sharded_lcs_fn(mesh, sbwt)
    packed, ustart, _perm = permute_unitigs(sbwt, unitigs)
    fmin_bv, global_offsets, stats, mesh_pos = sharded_finimizer_select(
        sbwt, LCS, packed, node_keys, mesh, return_pos=True
    )
    index = FinimizerIndex()
    # per-shard dense position slices: lets ShardedIndex.build construct
    # the tp-sharded SBWT-engine locate without a single-host
    # build_position_table pass
    index.mesh_pos = mesh_pos
    index.sbwt = sbwt
    index.LCS = np.asarray(LCS, dtype=np.int64)
    index.lcs_width = bit_width_for_max(k - 1)
    index.unitigs = packed
    index.fmin = fmin_bv
    index.global_offsets = global_offsets[fmin_bv == 1].astype(np.uint64)
    index.offsets_width = bit_width_for_max(
        int(global_offsets.max()) if fmin_bv.size else 0
    )
    index.Ustart = ustart
    index.rebuild_rank_supports()
    index.finimizer_stats = stats
    return index
