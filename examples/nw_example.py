#!/usr/bin/env python3
"""Library embedding example — equivalent of the reference's
examples/nw_example.c: custom scoring incl. asymmetric substitution costs
(scoring_add_mutation, nw_example.c:44-51)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from seqalign_tpu import NeedlemanWunsch, ScoringConfig

# match/mismatch/gap_open/gap_extend + flags
sc = ScoringConfig(1, -2, -4, -1, case_sensitive=True)
# asymmetric substitution costs: T->C cheap, C->T expensive
sc.add_mutation("t", "c", -1)
sc.add_mutation("c", "t", -3)

nw = NeedlemanWunsch(sc)
result = nw.align("atcgtagc", "ctcgtaac")
print(result.result_a)
print(result.result_b)
print("score:", result.score)

# batched alignment — one device program for many pairs
pairs_a = ["acgtacgt", "tttgggcc", "gattaca"]
pairs_b = ["acgaacgt", "ttgggcct", "gtcgacga"]
for aln in nw.align_batch(pairs_a, pairs_b):
    print(aln.result_a, aln.result_b, aln.score)
