"""Single-gather rank and LCS-jump structures for the streaming engine.

The streaming engines' per-base loop is a chain of dependent table
gathers, so these layouts minimize *gathers per k-mer* (whether that is
still the binding cost on the H100 is ROADMAP Queue 1 #5; the packing
itself awaits an H100 A/B, Queue 3 #5):

  * rank24: one uint32 entry per 8 SBWT positions per char:
        entry = (rank_before_byte << 8) | bits_byte
    so rank_c(i) = (e >> 8) + popcount(e & ((1 << (i&7)) - 1)) is ONE
    gather (vs word + block = 2 in ops.bitvec). Requires n_nodes < 2^24
    per shard (16M; larger indexes use ops.bitvec or tp-sharding).

  * packed LCS-jump arrays for drop_first_char (ref common.hh:38-48):
        jl[i] = ((i - prev_smaller(i)) << 8) | LCS[i]
        jr[i] = ((next_smaller(i) - i) << 8) | LCS[i]
    One gather per widening hop, and hops skip whole >=LCS plateaus
    instead of single steps.

  * contract_k: per node x, the precomputed (k-1)-widening of the
    singleton [x, x] -- the interval of x's k-mer's (k-1)-suffix. The
    streaming scan performs this exact widening once per found k-mer
    (window slide), so it becomes one row gather.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

RANK24_MAX_NODES = 1 << 24


def build_rank24_tables(bit_rows: np.ndarray) -> np.ndarray:
    """(R, n) 0/1 -> rank entries, one per 8 positions per row
    (R = 4 for the SBWT out-edge matrix; R = 1 for a plain bitvector).

    Two forms, chosen by size and told apart by ndim (static at trace
    time in rank24/rank1):
      * n <  2^24: flat (R * n8,) uint32, entry = rank << 8 | byte
        (ONE scalar gather per rank);
      * n >= 2^24: "wide" (R * n8, 2) uint32 rows [rank, byte]
        (one (n,2) row gather, ~1.3x a scalar gather) -- lifts the
        round-1 2^24-node cap for the stream/replica engines at
        genome scale."""
    n = bit_rows.shape[1]
    wide = n >= RANK24_MAX_NODES
    n8 = (n + 7) // 8 + 1  # pad entry so i == n is addressable
    R = bit_rows.shape[0]
    out = np.zeros((R, n8, 2), dtype=np.uint32) if wide else np.zeros(
        (R, n8), dtype=np.uint32
    )
    weights = (1 << np.arange(8)).astype(np.uint32)
    for c in range(R):
        padded = np.zeros(n8 * 8, dtype=np.uint8)
        padded[:n] = bit_rows[c]
        by = padded.reshape(n8, 8)
        byte_vals = (by * weights).sum(axis=1, dtype=np.uint32)
        counts = by.sum(axis=1, dtype=np.int64)
        csum = np.zeros(n8, dtype=np.int64)
        np.cumsum(counts[:-1], out=csum[1:])
        if wide:
            out[c, :, 0] = csum.astype(np.uint32)
            out[c, :, 1] = byte_vals
        else:
            out[c] = (csum.astype(np.uint32) << np.uint32(8)) | byte_vals
    return out.reshape(-1, 2) if wide else out.reshape(-1)


def rank24(tab: jnp.ndarray, n8: int, c, i):
    """Batched rank_c(i) in one gather. c int32 in [0,4), i in [0, n].
    Accepts both table forms (ndim is static under jit)."""
    mask = (jnp.uint32(1) << (i & 7).astype(jnp.uint32)) - jnp.uint32(1)
    if tab.ndim == 2:  # wide form: [rank, byte] rows
        e = jnp.take(tab, c * n8 + (i >> 3), axis=0)
        return (e[..., 0] + lax.population_count(e[..., 1] & mask)).astype(jnp.int32)
    e = jnp.take(tab, c * n8 + (i >> 3))
    return ((e >> jnp.uint32(8)) + lax.population_count(e & mask)).astype(jnp.int32)


def select_C(C, cs):
    """C[cs] for cs in [0,4) as a 4-way select instead of a dynamic
    gather of B elements: three vector selects replace one gather in the
    per-base loop."""
    c01 = jnp.where(cs == 0, C[0], C[1])
    c23 = jnp.where(cs == 2, C[2], C[3])
    return jnp.where(cs < 2, c01, c23)


def update_interval24(tab, n8: int, C, c, lo, hi):
    """Batched SBWT right-extension using rank24 (2 gathers total)."""
    c = c.astype(jnp.int32)
    valid = (lo >= 0) & (c >= 0) & (c <= 3)
    cs = jnp.where(valid, c, 0)
    los = jnp.where(valid, lo, 0)
    his = jnp.where(valid, hi, 0)
    Cc = select_C(C, cs)
    nlo = Cc + rank24(tab, n8, cs, los)
    nhi = Cc + rank24(tab, n8, cs, his + 1) - 1
    ok = valid & (nlo <= nhi)
    neg = jnp.int32(-1)
    return jnp.where(ok, nlo, neg), jnp.where(ok, nhi, neg)


def _prev_smaller(a: np.ndarray) -> np.ndarray:
    """out[i] = max j < i with a[j] < a[i]; 0 where none (a[0]=0 in LCS)."""
    n = a.size
    out = np.zeros(n, dtype=np.int64)
    stack_pos = np.empty(n + 1, dtype=np.int64)
    stack_val = np.empty(n + 1, dtype=np.int64)
    top = -1
    for i in range(n):
        v = a[i]
        while top >= 0 and stack_val[top] >= v:
            top -= 1
        out[i] = stack_pos[top] if top >= 0 else 0
        top += 1
        stack_pos[top] = i
        stack_val[top] = v
    return out


def _next_smaller(a: np.ndarray) -> np.ndarray:
    """out[i] = min j > i with a[j] < a[i]; n where none."""
    n = a.size
    out = np.full(n, n, dtype=np.int64)
    stack_pos = np.empty(n + 1, dtype=np.int64)
    stack_val = np.empty(n + 1, dtype=np.int64)
    top = -1
    for i in range(n - 1, -1, -1):
        v = a[i]
        while top >= 0 and stack_val[top] >= v:
            top -= 1
        out[i] = stack_pos[top] if top >= 0 else n
        top += 1
        stack_pos[top] = i
        stack_val[top] = v
    return out


def build_lcs_jump_tables(LCS: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Packed (delta << 8 | lcs) jump arrays jl, jr (uint32, length n+1).

    jr has one pad entry at index n (delta 0, lcs 0) so `hi+1 == n` probes
    are safe and immediately inactive.
    """
    a = np.asarray(LCS, dtype=np.int64)
    n = a.size
    if np.any(a > 255):
        raise ValueError("LCS values must fit in 8 bits (k <= 256)")
    prev = _prev_smaller(a)
    nxt = _next_smaller(a)
    jl = ((np.arange(n) - prev).astype(np.uint32) << np.uint32(8)) | a.astype(np.uint32)
    jr = np.zeros(n + 1, dtype=np.uint32)
    jr[:n] = ((nxt - np.arange(n)).astype(np.uint32) << np.uint32(8)) | a.astype(np.uint32)
    return jl, jr


def build_contract_k_table(LCS: np.ndarray, k: int) -> np.ndarray:
    """(n, 2) int32: for each node x, the (k-1)-widened interval of [x, x].

    lo[x] = max j <= x with (j == 0 or LCS[j] < k-1)
    hi[x] = min j >= x with (j == n-1 or LCS[j+1] < k-1)
    """
    a = np.asarray(LCS, dtype=np.int64)
    n = a.size
    idx = np.arange(n, dtype=np.int64)
    small = a < (k - 1)
    small[0] = True
    lo = np.maximum.accumulate(np.where(small, idx, 0))
    # first j >= x with LCS[j+1] < k-1 (or n-1)
    small_next = np.empty(n, dtype=bool)
    small_next[: n - 1] = a[1:] < (k - 1)
    small_next[n - 1] = True
    hi = np.minimum.accumulate(np.where(small_next, idx, n - 1)[::-1])[::-1]
    return np.stack([lo, hi], axis=1).astype(np.int32)


_NO_CAND = 255  # candidate-length sentinel shared by the scan engines


def build_su_table(LCS: np.ndarray) -> np.ndarray:
    """SU[x] = max(LCS[x], LCS[x+1]) + 1: length of the shortest unique
    suffix whose singleton interval is {x} (pad LCS[n] = 0). Closed form
    of the reference's shrink-from-the-left loop (common.hh:145-154)."""
    a = np.asarray(LCS, dtype=np.int64)
    nxt = np.concatenate([a[1:], [0]])
    su = np.maximum(a, nxt) + 1
    if np.any(su >= _NO_CAND):
        raise ValueError("SU table requires k <= 254")
    return su.astype(np.uint8)


def build_su_ustart_table(LCS: np.ndarray, Ustart: np.ndarray) -> np.ndarray:
    """uint16 per node: SU length (low 8 bits) | Ustart bit << 8 -- one
    gather serves both the candidate closed form and the branch carry."""
    su = build_su_table(LCS).astype(np.uint16)
    return su | (np.asarray(Ustart, np.uint16) << np.uint16(8))


EDGE_AUG_MIN = 1 << 25  # cand values >= this carry inline (su, ustart)
EDGE_NODE_MASK = (1 << 24) - 1


def can_augment_edges(n_nodes: int, k: int) -> bool:
    """Augmented edge entries pack su (6 bits, su <= k <= 63) | ustart
    (1 bit) | node (24 bits) into a positive int32 -- possible exactly
    when the flat rank24 form applies and k <= 63."""
    return n_nodes < RANK24_MAX_NODES and k <= 63


def build_edge_aug_table(
    bit_rows: np.ndarray, C, contract_k: np.ndarray,
    LCS: np.ndarray, Ustart: np.ndarray,
) -> np.ndarray:
    """Forward-edge table with the TARGET node's (SU, Ustart) packed into
    bits [25:31] and [24]: the chain scan gathers the edge entry anyway,
    so the per-position suu lookup that fed the replica tail's candidate
    grid (a full (B, L) gather) becomes free. Entries stay -1 when the
    slid k-mer is absent; requires can_augment_edges (the target node id
    fits 24 bits and SU <= 63 fits 6, keeping entries positive int32)."""
    base = build_edge_table(bit_rows, C, contract_k)
    n = bit_rows.shape[1]
    su = build_su_table(LCS).astype(np.int32)
    if n >= RANK24_MAX_NODES or (su.size and int(su.max()) > 63):
        raise ValueError("index too large or k too big for augmented edges")
    us = np.asarray(Ustart, np.int32)
    tgt = np.where(base >= 0, base, 0)
    aug = base | (su[tgt] << 25) | (us[tgt] << 24)
    return np.where(base >= 0, aug, base).astype(np.int32)


def build_edge_table(bit_rows: np.ndarray, C, contract_k: np.ndarray) -> np.ndarray:
    """(4n,) int32 forward-edge automaton: edge[4x + c] = colex rank of
    the k-mer obtained by sliding the window of k-mer x one base (drop
    first char, append c), or -1 when that k-mer is absent.

    This is the mature steady state of the streaming chain (ref
    common.hh:114-143) collapsed to ONE gather: after a window close the
    reference widens the singleton {x} to its (k-1)-suffix interval
    (contract_k row gather) and right-extends it with c (2 rank
    gathers); all three collapse into this precomputed table, cutting
    the scan step's sequential-dependency depth from 2 gathers to 1 --
    the scan is latency-bound (see ops.streaming), so this is ~the
    chain's critical path halved. Entries at dummy ($-padded) nodes are
    never consulted: a mature close always lands on a real k-mer node.

    Cost: 16 bytes/node of device memory (the compact engines' other
    tables total ~20 B/node)."""
    n = bit_rows.shape[1]
    Ca = np.asarray(C, dtype=np.int64)
    cl = contract_k[:, 0].astype(np.int64)
    ch = contract_k[:, 1].astype(np.int64)
    edge = np.empty((n, 4), dtype=np.int32)
    r = np.zeros(n + 1, dtype=np.int64)
    for c in range(4):
        np.cumsum(bit_rows[c], out=r[1:])
        lo = Ca[c] + r[cl]
        hi = Ca[c] + r[ch + 1] - 1
        edge[:, c] = np.where(lo <= hi, lo, -1).astype(np.int32)
    return edge.reshape(-1)


def widen_interval(jl, jr, lo, hi, new_len, n_nodes: int):
    """Batched drop_first_char via packed jump hops (1 gather per hop/side).

    Follows ref common.hh:38-48: empty intervals (lo == -1) pass through;
    new_len <= 0 yields the full interval.
    """
    empty = lo < 0
    full = (new_len <= 0) & ~empty
    nl = new_len.astype(jnp.uint32)

    def cond_l(st):
        x, act = st
        return jnp.any(act)

    def body_l(st):
        x, act = st
        e = jnp.take(jl, jnp.where(act, x, 0))
        hop = act & (x > 0) & ((e & jnp.uint32(0xFF)).astype(jnp.int32) >= new_len)
        x2 = jnp.where(hop, x - (e >> jnp.uint32(8)).astype(jnp.int32), x)
        return x2, hop

    x0 = jnp.where(empty | full, 0, lo)
    act0 = ~(empty | full)
    new_lo, _ = lax.while_loop(cond_l, body_l, (x0, act0))

    def body_r(st):
        x, act = st
        e = jnp.take(jr, jnp.where(act, x, 0))
        hop = act & (x < n_nodes) & ((e & jnp.uint32(0xFF)).astype(jnp.int32) >= new_len)
        x2 = jnp.where(hop, x + (e >> jnp.uint32(8)).astype(jnp.int32), x)
        return x2, hop

    y0 = jnp.where(empty | full, 0, hi + 1)
    new_hi, _ = lax.while_loop(cond_l, body_r, (y0, act0))
    new_hi = new_hi - 1

    out_lo = jnp.where(empty, lo, jnp.where(full, 0, new_lo))
    out_hi = jnp.where(empty, hi, jnp.where(full, n_nodes - 1, new_hi))
    return out_lo, out_hi
