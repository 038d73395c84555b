"""Multi-host orchestration: jax.distributed init, per-host input
splits, and rank-ordered output merging.

The reference is single-process; the contract a distributed run must
keep is exact OUTPUT parity: search-fmin emits one line per read in
input order (search_fmin.hh:54-65), so a multi-host run splits the reads
into contiguous per-process slices (process 0 gets the first slice, ...)
and concatenates per-process outputs in process-id order -- byte-equal
to the single-process run.

Within a host, batches ride the (dp, tp) mesh of parallel.mesh; across
hosts, dp spans processes (each host feeds its addressable devices via
jax.make_array_from_process_local_data) and the index's tp shards live
once per dp replica. There is no cross-host traffic on the query path
except the collectives inside the sharded locate (psum over tp stays
on the host's NVLink when tp is mapped within hosts).

On a GPU host that runs several processes, each process must be given
its own card (`jax.distributed.initialize(..., local_device_ids=[i])`,
or CUDA_VISIBLE_DEVICES per process): a JAX process reserves most of
every card it opens. The CLI does not reach this module; one process
drives all of a host's cards through parallel.mesh.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns (process_id, num_processes); (0, 1) when single-process."""
    import jax

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address and num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id or 0,
        )
        return jax.process_index(), jax.process_count()
    return 0, 1


def distributed_barrier(name: str) -> None:
    """Block until every process reaches this point (a real cross-process
    collective over the global device set). No-op in a 1-process run."""
    import jax

    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def process_slice(n_items: int, process_id: int, num_processes: int) -> Tuple[int, int]:
    """Contiguous [start, end) of items owned by a process. Contiguous
    (not strided) so per-process outputs concatenate in process order
    into the exact single-process ordering."""
    base, rem = divmod(n_items, num_processes)
    start = process_id * base + min(process_id, rem)
    return start, start + base + (1 if process_id < rem else 0)


def split_for_process(items: Sequence, process_id: int, num_processes: int):
    a, b = process_slice(len(items), process_id, num_processes)
    return items[a:b]


def part_path(out_path: str, process_id: int) -> str:
    return f"{out_path}.part{process_id:05d}"


def write_part(out_path: str, process_id: int, lines: Sequence[str]) -> str:
    p = part_path(out_path, process_id)
    with open(p, "w") as f:
        for line in lines:
            f.write(line if line.endswith("\n") else line + "\n")
    return p


def merge_parts(out_path: str, num_processes: int, remove: bool = True) -> None:
    """Concatenate part files in process order -> byte-equal to the
    single-process output (run on process 0 after a barrier)."""
    with open(out_path, "w") as out:
        for pid in range(num_processes):
            p = part_path(out_path, pid)
            with open(p) as f:
                out.write(f.read())
            if remove:
                os.remove(p)


def run_distributed_queries(engine, reads: List[bytes], out_path: str,
                            process_id: int, num_processes: int,
                            barrier: bool = False) -> None:
    """Per-host slice -> batched engine -> part file -> merge.

    With barrier=True (a real jax.distributed run) the merge is fully
    owned here: every process syncs after writing its part, process 0
    concatenates, and a second sync holds everyone until the merged file
    exists. barrier=False is for single-process or simulated runs where
    the caller sequences the parts itself."""
    mine = split_for_process(reads, process_id, num_processes)
    lines = []
    for f, r in engine.process_reads(mine):
        parts = []
        n = len(f.local_offsets)
        for i in range(n):
            u, p = f.local_offsets[i]
            if u == -1:
                u, p = r.local_offsets[n - 1 - i]
            parts.append(f"({u},{p})")
        lines.append(" ".join(parts))
    write_part(out_path, process_id, lines)
    if num_processes == 1:
        merge_parts(out_path, 1)
    elif barrier:
        distributed_barrier(f"finito:parts:{out_path}")
        if process_id == 0:
            merge_parts(out_path, num_processes)
        distributed_barrier(f"finito:merged:{out_path}")
