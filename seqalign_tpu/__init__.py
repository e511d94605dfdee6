"""seqalign_tpu — a pairwise sequence-alignment library for accelerators.

A from-scratch JAX/XLA/Pallas reimplementation of the capability surface of
the C library noporpoise/seq-align (global Needleman-Wunsch and local
multi-hit Smith-Waterman with affine gaps, substitution matrices, wildcards,
constrained modes, full traceback, CLI tools): batched anti-diagonal
wavefront DP fills in int32, a GPU scores kernel, packed direction codes
for traceback, and shard_map data-parallel scale-out over device meshes.
"""

__version__ = "1.0.0"  # tracks reference SEQ_ALIGN_VERSION_STR (seq_align.h:12)

from .aligners import NeedlemanWunsch, SmithWaterman, lcs_hits
from .ops.host_dp import Alignment
from .scoring.config import GAP_A, GAP_B, MATCH, ScoringConfig, encode
from .scoring.loader import load_matrix, load_pairwise
from .scoring.presets import (
    PRESETS,
    scoring_system_BLOSUM62,
    scoring_system_BLOSUM80,
    scoring_system_default,
    scoring_system_DNA_hybridization,
    scoring_system_PAM30,
    scoring_system_PAM70,
    scoring_system_sw_default,
)

__all__ = [
    "Alignment",
    "NeedlemanWunsch",
    "SmithWaterman",
    "lcs_hits",
    "load_matrix",
    "load_pairwise",
    "GAP_A",
    "GAP_B",
    "MATCH",
    "ScoringConfig",
    "encode",
    "PRESETS",
    "scoring_system_BLOSUM62",
    "scoring_system_BLOSUM80",
    "scoring_system_default",
    "scoring_system_DNA_hybridization",
    "scoring_system_PAM30",
    "scoring_system_PAM70",
    "scoring_system_sw_default",
    "__version__",
]
