"""Image-pair generation: the exhaustive strategy.

Port of colmap_tpu/features/pairing.py (ExhaustivePairingOptions and
exhaustive_pairs; the other strategies are queued). Pair generation is host
logic that feeds fixed-size pair blocks to the batched matcher.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple


@dataclasses.dataclass
class ExhaustivePairingOptions:
    block_size: int = 50  # reference default (feature/pairing.h:42)


def exhaustive_pairs(image_ids: Sequence[int],
                     options: ExhaustivePairingOptions = ExhaustivePairingOptions()
                     ) -> Iterator[List[Tuple[int, int]]]:
    """Yield lower-triangle pair blocks (reference: ExhaustivePairGenerator)."""
    ids = list(image_ids)
    n = len(ids)
    bs = options.block_size
    for start1 in range(0, n, bs):
        end1 = min(start1 + bs, n)
        for start2 in range(0, end1, bs):
            end2 = min(start2 + bs, n)
            block = []
            for i in range(start1, end1):
                for j in range(start2, min(end2, i)):
                    block.append((ids[j], ids[i]))
            if block:
                yield block
