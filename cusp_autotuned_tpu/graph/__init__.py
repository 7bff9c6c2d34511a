"""Graph algorithms (parity: cusp/graph/).

Stance: traversals (BFS, connected components, MIS, coloring) are
iterated masked semiring SpMV sweeps in jitted while-loops — replacing the
reference's vendored b40c CUDA BFS (cusp/system/cuda/detail/graph/b40c/**)
wholesale, as planned in SURVEY.md §2.3.  Orderings (RCM, pseudo-peripheral,
Hilbert) are host-side setup ops producing permutations.
"""

from cusp_autotuned_tpu.graph.traversal import (
    breadth_first_search, connected_components,
)
from cusp_autotuned_tpu.graph.mis import maximal_independent_set
from cusp_autotuned_tpu.graph.coloring import vertex_coloring
from cusp_autotuned_tpu.graph.ordering import (
    pseudo_peripheral_vertex, symmetric_rcm,
)
from cusp_autotuned_tpu.graph.hilbert import hilbert_curve
