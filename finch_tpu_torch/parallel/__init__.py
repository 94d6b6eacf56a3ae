"""Sharded sketching and distance, on one card or a mesh of them.

The counterpart of ``finch_tpu/parallel/``. On one card: the Gram
all-vs-all (mxu_dist) and the query-vs-DB tiles (sharded_dist). Over a
mesh (mesh.py; several cards, logical shards, or processes joined by
torch.distributed, distributed.py): data-parallel k-mer streams with an
exact bottom-k merge (sharded_sketch.py), the run-partitioned Gram
(mxu_dist.sharded_common) and ref-sharded tiles
(sharded_dist.all_vs_all_arrays(mesh=)).
"""

from finch_tpu_torch.parallel.mesh import Mesh, make_mesh
from finch_tpu_torch.parallel.sharded_sketch import ShardedSketchEngine
from finch_tpu_torch.parallel.sharded_dist import all_vs_all_arrays
from finch_tpu_torch.parallel import distributed

__all__ = ["Mesh", "make_mesh", "ShardedSketchEngine", "all_vs_all_arrays",
           "distributed"]
