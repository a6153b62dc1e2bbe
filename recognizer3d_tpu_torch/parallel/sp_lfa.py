"""One point-sharded Local Feature Aggregation block (counterpart of
``recognizer3d_tpu/parallel/sp_lfa.py``).

The block's self-KNN and first neighbour gather are one ring pass
(``ring_knn_gather``), its second gather one more (``ring_gather``), and
the rest of it is pointwise or a reduction over a point's K neighbours, so
it runs on each rank's block. The JAX function restates the block's math
over its flax variables; here the block's own backend branch
(``LocalFeatureAggregation.forward(..., backend=...)``) runs with its
weights, so the two cannot drift apart. Eval only, as in JAX.
"""

import torch

from recognizer3d_tpu_torch.parallel.sp_model import SPBackend


def sp_lfa_eval(block, xyz: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """One eval LFA block over point-sharded inputs.

    :param block: a ``LocalFeatureAggregation`` in eval mode (its weights
        replicated on every rank).
    :param xyz: (B, n_loc, 3), this rank's block of the coordinates.
    :param features: (B, n_loc, C_in), this rank's block of the features.
    :return: (B, n_loc, 2·n_out), this rank's block of the output.
    """
    if block.training:
        raise NotImplementedError("point-sharded training is ROADMAP A9b; put the block in eval()")
    return block(xyz, features, backend=SPBackend())
