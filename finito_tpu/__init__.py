"""finito_tpu: a finimizer engine in JAX.

A from-scratch JAX/XLA implementation of the capabilities of
ElenaBiagi/Finito (reference: /root/reference): shortest-unique-finimizer
(t=1 "rarest") k-mer localization indexes over spectrum-preserving string
sets, built on a plain-matrix SBWT + LCS array, answering streaming
(unitig id, offset) queries bit-exactly compatible with the reference's
`search-fmin`, plus the reference's secondary minimizer-index stack
(`kmer-mapper`).

Layer map (mirrors SURVEY.md section 1, re-designed for the device):
  L0  ops/      packed bitvectors + rank superblocks as dense arrays
  L1  sbwt/     plain-matrix SBWT: construction, interval ops, LCS
  L2  index/    PackedStrings, finimizer selection, FinimizerIndex
  L3  query/    streaming search oracle + batched device query engines
  L4  cli       build-fmin / search-fmin / kmer-mapper commands
  px  parallel/ device-mesh sharding for multi-chip scale-out
"""

from finito_tpu.version import __version__

__all__ = ["__version__"]

# Applied at import so EVERY consumer (CLI, tests, library users) gets
# the warm-heap allocator behavior, not just callers that remember to
# opt in: on this project's microVM hosts, first-touch page faults run
# at ~10-160 ms/MB and glibc's default mmap threshold re-faults every
# large numpy temporary (measured 75 s -> 2.7 s for a 16 Mbp index
# load). Safe no-op where glibc is absent.
from finito_tpu.utils import tune_host_allocator as _tune_host_allocator

_tune_host_allocator()
