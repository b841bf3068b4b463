"""hdrf_tpu_torch — the PyTorch/CUDA port of hdrf_tpu's reduction path.

The JAX package ``hdrf_tpu`` is the reference; this package re-expresses
it for one NVIDIA H100 and imports nothing of it (nor of JAX).  It carries
the reduction worker's ``reduce``, ``compress`` and ``compress_batch`` ops
end to end, the multi-device reduction, and the DataNode's in-process
``dedup_lz4`` scheme, write and read:

- ``ops/cdc_cuda.py``, ``ops/gather_cuda.py``, ``ops/sha256_cuda.py``,
  ``ops/sort_cuda.py`` — hand-written CUDA kernels (``csrc/*.cu``, built
  with ``nvcc`` for ``sm_90a`` at first use) beside their plain PyTorch
  versions;
- ``ops/resident.py`` — ``ResidentReducer``, the block funnel;
  ``ops/lz4_device.py`` — ``DeviceLz4``, the container seal;
- ``ops/dispatch.py`` — the write path's ``chunk_and_fingerprint`` and
  the seal's ``block_compress[_batch]``;
- ``parallel/sharded.py`` — the ('data', 'seq') mesh of torch devices,
  ``reduce_sharded`` and the mesh plane (``MeshReducer``);
  ``parallel/launch.py`` — the multi-process launcher;
- ``server/reduction_worker.py`` — the framed-protocol worker process;
- ``reduction/{scheme,dedup,accounting}.py`` — the scheme registry and
  ``DedupScheme`` over ``index/chunk_index.py`` (WAL, snapshot, group
  commit), ``storage/container_store.py`` (seal on roll) and
  ``server/read_plane.py``; ``ops/reconstruct.py`` —
  ``DeviceReconstructor``, device-resident container images and the raw
  lane-gather kernel; ``utils/{wal,profiler,qos,retry,rollwin,tenants}``
  — their host leaves.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``, which runs each kernel's plain version (the tests
do).  Without a card, a CUDA entry point raises.
"""
