"""Multi-device parallelism (port of hdrf_tpu/parallel/): the ('data',
'seq') mesh of torch devices, the sequence-parallel CDC scan with its halo
exchange, data-parallel SHA lanes, the fixed-segment reduction step, the
variable-chunk sharded pipeline (reduce_sharded), the mesh plane
(MeshReducer) and the multi-process launcher (launch.py)."""

from hdrf_tpu_torch.parallel.sharded import (  # noqa: F401
    candidate_words_sharded,
    gear_candidates_sharded,
    make_mesh,
    reduce_sharded,
    reduction_step,
    sha256_lanes_sharded,
)
