"""Device operations and their oracles: the kernels' wrappers and plain
versions (``kernel``: the fused sweeps and the per-bucket ops; ``streamprobe``:
the stream floor) and their build (``_build``), the query codecs
(``quantized_query``, ``fixedpoint``), and the NumPy oracles (``gold``,
``xla_ref``)."""

from . import gold, fixedpoint, xla_ref
from .kernel import finalize_topk
