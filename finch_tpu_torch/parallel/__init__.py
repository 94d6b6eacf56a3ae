"""Distance engines on the card: the Gram all-vs-all (mxu_dist) and the
query-vs-DB tiles (sharded_dist).

The counterpart of ``finch_tpu/parallel/`` on one card. The mesh programs
of the JAX package (sharded sketching, `sharded_common`, the ref-sharded
tiles, the multi-process mode) wait for the multi-GPU slice.
"""

from finch_tpu_torch.parallel.sharded_dist import all_vs_all_arrays

__all__ = ["all_vs_all_arrays"]
