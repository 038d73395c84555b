"""Pre-build bench cache rungs (index + genome + midx) host-side.

The bench measures cached rungs beyond its head index (genome-scale host
builds take minutes); this script builds and serializes one rung end to
end on the host so `bench.py --ladder auto` picks it up. Usage:

  JAX_PLATFORMS=cpu python scripts/build_cache.py --genome 100000000
  JAX_PLATFORMS=cpu python scripts/build_cache.py --genome 4000000 --workload repeat
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--genome", type=int, required=True)
    p.add_argument("--k", type=int, default=31)
    p.add_argument("--workload", default="uniform", choices=["uniform", "repeat"])
    p.add_argument("--cache-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_cache"))
    args = p.parse_args()

    import bench

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    genome, index, build_s, cuts = bench.load_or_build_index(
        args.genome, args.k, args.cache_dir, rng, workload=args.workload
    )
    print(f"[cache] index ready in {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    wtag = "g" if args.workload == "uniform" else "repg"
    mcache = os.path.join(args.cache_dir, f"midx_{wtag}{args.genome}_k{args.k}.ftmidx")
    if not os.path.exists(mcache):
        from finito_tpu.index.minimizer import MinimizerIndex

        t0 = time.perf_counter()
        mindex = MinimizerIndex.from_finimizer_index(index)
        mindex.serialize(mcache)
        print(f"[cache] midx built+serialized in {time.perf_counter()-t0:.1f}s "
              f"(n_occ={mindex.occ_key.size}, h={mindex.h})", file=sys.stderr)
    print("[cache] done", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
