import os

from finito_tpu.utils.logging import write_log, set_log_level, LogLevel, cur_time_micros

_allocator_tuned = False


def tune_host_allocator() -> None:
    """Keep large allocations on the glibc heap instead of mmap/munmap.

    This host (a microVM) services first-touch page faults at ~10-160
    ms/MB -- orders of magnitude slower than bare metal. glibc returns
    mmap'd blocks (any numpy temporary > ~32MB) to the OS on free, so
    every big temporary re-faults its pages; raising M_MMAP_THRESHOLD /
    M_TRIM_THRESHOLD makes the heap grow once and recycle warm pages
    (measured: 512MB temporaries 9.4s -> 0.13s per round). Safe no-op
    where glibc is absent."""
    global _allocator_tuned
    if _allocator_tuned:
        return
    _allocator_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass


CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing is changed here. Otherwise the cache lives at the fixed
    `<checkout>/.jax_cache`: the directory is part of the cache key, so
    a path that moved between runs would never hit."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT_DIR, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_cards() -> list:
    """`name, power.limit` of each card, one string per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them; [] where nvidia-smi is missing or fails."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    return r.stdout.strip().splitlines() if r.returncode == 0 else []


def relax_cpu_collective_timeouts(warn_s: int = 600, terminate_s: int = 3600) -> None:
    """Raise XLA:CPU's collective rendezvous timeouts (default 20s warn /
    40s TERMINATE-THE-PROCESS). On an oversubscribed host -- N virtual
    devices sharing few cores -- any shard doing > 40s of local work
    before an all_to_all/all_gather kills the whole process with
    "Termination timeout ... exceeded". Must run BEFORE the CPU backend
    initializes (XLA_FLAGS is read at backend init)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "collective_call_terminate_timeout" in flags:
        return
    os.environ["XLA_FLAGS"] = (
        flags
        + f" --xla_cpu_collective_call_warn_stuck_timeout_seconds={warn_s}"
        + f" --xla_cpu_collective_call_terminate_timeout_seconds={terminate_s}"
    ).strip()
