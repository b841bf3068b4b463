#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (hdrf_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--requests 8] [--block-mib 128]

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. Probe: torch/CUDA versions, the card (nvidia-smi name and power
   limit), the nvcc path, whether triton imports.  Without a CUDA device
   the script exits 2 before printing any result.
2. Build the kernels from ``hdrf_tpu_torch/csrc`` (nvcc, sm_90a).
3. Kernel phases: the CDC, gather and SHA-256 kernels against their plain
   PyTorch versions on the card, on the seven corpora of
   tests/test_cdc_pallas.py (rebuilt from their seed), a seeded random
   block and an all-zeros block of ``--block-mib``, and the CDC pair on a
   low-entropy text block (bytes 97..122) and two periodic adversaries of
   the same size (a random pattern of 1,531 and of 3 bytes repeated,
   holding one candidate per period: under min_chunk and dividing no
   segment width, so the select's speculative chains need not meet; at 3
   bytes they never do and the select walks serially).  SHA-256 runs both
   lane tables of a block in one grouped launch and each through the
   one-table call.  ``be_image`` (the scan's words-only mode) is held
   against the plain word image on every block.  Outputs are integers:
   tolerance zero.  Times at the random block: kernel median of 20 runs
   after warm-up (CUDA events), plain version once, and ``library_ms`` —
   one PyTorch call computing the same function — for the gather (an
   advanced-indexing gather of the same bytes) and ``be_image`` (a
   ``flip`` of the block's 4-byte rows); the hashing scans, the select
   and SHA-256 have none.  The scan and the select are timed on each of
   the five big blocks (``TIMING cdc_scan`` / ``TIMING cdc_select``
   lines), ``be_image`` on the random block and a 32 MiB container
   (``TIMING be_image``); SHA-256 on the random,
   text and zeros blocks, each lane table alone and both grouped, wrapper
   and device time (``TIMING sha256`` lines), beside its chain bound from
   a probe of the card's dependent SHF -> LOP3 -> IADD3 latency (``SHA
   chain probe``).  Every timed kernel call is preceded by a write of 128
   MiB, so its inputs come from HBM, not from the 50 MB L2.
4. Main path: the port's ReductionWorker on 127.0.0.1:0 on the card answers
   ``--requests`` ``reduce`` requests of ``--block-mib`` each, sent by the
   port's WorkerClient in 64 KiB packets with CdcConfig() defaults.  Each
   block is a run of 1 MiB segments — fresh random bytes (p=0.75) or a copy
   of an earlier segment (p=0.25) — and the last block is low-entropy text
   (bytes 97..122).  Every reply's cuts must equal the plain CDC on the card
   and every digest hashlib.sha256 of its chunk; every kernel's launch
   count over the requests must be > 0.
5. Profile: two more requests under ``torch.profiler``; the device's busy
   share of that window (the union of kernel and copy intervals) and each
   kernel's device time per request.  The trace is kept in
   ``chiprun_out/smoke_trace_reduce.json``.  Every profiler session
   makes ``PROFILE_WARMUP_LAUNCHES`` small launches before its window
   (a session's first device records carry timestamps hundreds of ms
   early, the more the older the process, and are dropped or out of
   place), and a window in which a launch or copy call has no device
   record, or has it out of place, is not measured; ``PROFILE warmup``
   lines, after the build and after SCHEME, count what a window without
   the warm-up loses.
6. Seal kernels: ``match_deltas`` (stride 2 and 4) and ``sort_rows``
   against their plain versions on the card, on eight 32 MiB containers
   (the generators of tests/test_lz4_tpu.py scaled up, the reference
   package's source text, the unique chunks of phase 4's corpus, and
   random bytes with sparse copies, whose match density runs the
   grey-zone race), and ``be_image`` against the plain word image on each.
   ``sort_rows`` runs on the inputs of every call site of the match scan,
   captured from a real scan, plus unique i32 keys, u32 keys across the
   sign bit and a padded row that is not a power of two; both sorts are
   stable, so every slot must be exact.  ``match_deltas`` is timed at
   both strides on the random, zeros, text, source and sparse containers
   (``TIMING match_deltas`` lines: wrapper and device ms).  Times on the
   ``source`` container at stride 2: kernel median of 20 runs, plain once,
   ``library_ms`` for ``sort_rows`` (``torch.sort`` and a
   ``torch.gather`` per value; ``match_deltas`` has none); ``sort_rows``
   per call site (L1, L2, L3 and the escape lanes E1, E2: ``TIMING
   sort_rows`` lines) and summed.
7. Seal main path: the port's worker on the card answers 8 ``compress``
   requests of one 32 MiB container and 2 ``compress_batch`` requests of
   4, sent by the port's WorkerClient.  Every reply must decode to its
   payload and equal, byte for byte, a CPU ``DeviceLz4`` fed the same
   sequence (that CPU engine runs in a spawned process while MESH and
   SCHEME run on the card, ``seal_twin``; ``SEAL twin`` line); both seal
   kernels' and ``be_image``'s launch counts over the requests must be >
   0; the sparse container must emit from its device records.  Per request: latency, MiB/s, compressed size, ratio against
   the serial ``native.lz4_compress``, kept match records, and the branch
   taken (``lz4_device`` counters).  Two more ``compress`` requests are
   profiled as in phase 5 (``chiprun_out/smoke_trace_seal.json``).
8. MESH, the sharded reduction (hdrf_tpu_torch/parallel/sharded.py) on
   meshes of ``cuda:0`` repeated (a mesh may repeat a device: each shard
   has its own tensors, and halos, all-gathers and psums really run):
   (a) the shard-scan kernel against its plain version, tolerance zero,
   words and count, for n_seq 1, 4 and 8 on the seven corpora, the
   ``--block-mib`` random block and the zeros block, each shard with the
   previous shard's tail as its halo; the shards' words together, cut at
   n, must give ``native.gear_candidates`` of the whole block.  Timed on
   the random block at n_seq 4 and 8 (shard 1; ``TIMING shard_scan``
   lines): median of 20 launches and device time, plain once.  (b)
   ``reduce_sharded`` on ('data'=1, 'seq'=4) and (2, 2) meshes and on
   ``launch.global_mesh()`` (1 x 1 on one card), over the ``reduce``
   corpus plus one 40 KB block that takes the all-gather SHA route: cuts
   and digests equal ``native.cdc_select`` / ``native.sha256_batch`` and
   the serial ``ResidentReducer``; per request its SHA route and latency
   (the word images are ``be_image``'s, and no hashing block scan runs:
   ``MESH launches`` line); two more 1 x 4 requests profiled as in phase
   5 (``chiprun_out/smoke_trace_mesh.json``).  (c)
   ``MeshReducer.reduce_many`` with n_data 2 on the same corpus equals the
   serial ``ResidentReducer``; after ``table.note_new`` of the first
   group's digests a second pass votes hits equal to ``host_probe``.  (d)
   ``lz4_compress_many_sharded`` of one 4 x 32 MiB group equals
   ``DeviceLz4.compress_many`` fed the same sequence.
9. SCHEME, the in-process ``dedup_lz4`` scheme as the DataNode runs it
   (hdrf_tpu/server/datanode.py:139-262 wired on the port at
   ``ReductionConfig()`` defaults: 32 MiB lz4 containers sealed by the
   device LZ4, the chunk index with its group-commit window, a
   ``DeviceReconstructor`` with a 256 MiB budget, the read plane and its
   admission controller; data under a ``tempfile`` directory).  (a) The
   raw lane-gather kernel against its plain version on every lane, at
   every bucket from 16 to 2048, in both orders (the big-endian words
   and the bytes the reconstructor takes), on a random and a zeros image
   of a staged 32 MiB container, all four byte alignments and lanes
   whose window ends at the image's edge; tolerance zero.  (b) Write: the
   first ``SCHEME_BLOCKS`` (4) blocks of the ``reduce`` corpus (its last
   block text) through ``scheme.get("dedup_lz4").reduce`` on
   ``cuda``, then ``flush_open``; every block's chunk lengths and hashes
   in the index equal ``native.cdc_select`` + ``sha256_batch``, every
   sealed container decodes (``native.lz4_decompress`` for lz4 frames) to
   the payload its roll saw; the write kernels' launch counts (zeroed
   before) are > 0 (``SCHEME write``: ms per block, MiB/s, dedup ratio,
   containers sealed).  (c) Read: every block whole through
   ``reconstruct`` (the reconstructor), bit-identical, and blocks 0-1
   again (image hits within a block); then
   ranged reads at odd offsets above and below ``DEVICE_RECON_MIN`` (the
   reconstructor and the read plane) against the slices, and one ranged
   read repeated, whose second run must stage no image and hit the first
   run's (``SCHEME read``: ms per block, MiB/s, ``image_hits``,
   ``images_staged``, launches).  (d) The index closed and reopened from its directory: its
   refcounts equal a plain model of the blocks written; two blocks read
   again.  (e) ``TIMING gather_raw``: every (container, bucket) group of
   a block's read, for block 0 and for the block whose read makes the
   most groups: card ms and device ms in byte order (what the read
   runs) and in words, plain once, the library call (advanced indexing
   + shift) and the byte bound (the union of the lanes' image windows
   read once).  (f) ``PROFILE scheme_write`` /
   ``scheme_read``: one more block written and read under
   ``torch.profiler`` (traces ``smoke_trace_scheme_*.json``).
10. EC, the cold tier (hdrf_tpu/server/ec_tier.py as the DataNode
   installs it, datanode.py:269, 276) on SCHEME's store, index and data
   directory, before the directory goes: an owner (SCHEME's context) and
   two peers, stand-in DataNodes carrying the attributes ``EcTier`` and
   ``CodedExchange`` read, peer ops served over socket pairs in the
   port's wire codec; RS(6,3), stripe slot i on holder i mod 3,
   ``ReductionConfig()`` defaults (hedge delta 1, coded repair, exchange
   compression through the device LZ4) and the DataNode's 100 MiB/s
   background throttle.  (a) The GF(2^8) kernel against its plain
   version, tolerance zero: RS(6,3), (10,4), (1,1) and (24,8) at lengths
   1, 3, 15, 16, 17, 4097 and a 32 MiB container's stripe, rows aligned
   and at odd byte offsets; every shard count 1-24 (one instantiation of
   the kernel each) at every row count 1-8; partial sums on column
   slices holding zeros,
   ones and 0xFF; all 129 erasure patterns of RS(6,3) through
   ``rs_decode``; two sealed 32 MiB containers' parity against
   ``encode_ref`` on the host.  (b) ``EcTier.demote`` of every block:
   every sealed container striped, its manifest in the index and its
   sealed file gone, the stripes' bytes 1.5x the logical up to padding,
   one report per container, ``rs`` launches > 0 (``EC demote``).  (c)
   Holder p1 loses every stripe (data 1 and 4, parity 7); the caches
   dropped, block 0 (random) and the last block (text) read whole and
   at odd ranged offsets, bit-identical, with ``degraded_reads``,
   ``be_image`` and ``gather_raw`` launches > 0 and an lz4 container
   among the sealed files the stripes rebuilt (``EC read p1_lost``).
   (d) Every lost stripe repaired by the coded exchange (partial sums
   chained through the peers); then the owner's stripes 0, 3 and 6
   lost, the same two blocks read, and repaired by the classic full
   gather (``ec_coded_repair=False``):
   each rebuilt file equals the original and its CRC the manifest's
   (``EC repair coded`` / ``classic``).  (e) The index closed and
   reopened: manifests equal.  (f) ``TIMING rs`` for an encode of a 32
   MiB container, a decode of three data stripes and a two-survivor
   partial sum: card ms, device ms, plain once, the library call (the
   reference's bit-plane product through ``torch.matmul`` in f32) and
   the byte bound, each with its launches over (b) to (d); ``PROFILE
   ec_demote`` / ``ec_read``: SCHEME's profiled block demoted and read
   back degraded under the profiler.  ``rs``'s launch count is that of
   (b) to (d).
11. DATANODE, the port's DataNode (hdrf_tpu_torch/server/datanode.py) on
   ``cuda:0`` through its wire entry points: a stand-in NameNode over the
   port's RPC frames (``register_datanode`` without block keys,
   ``block_report``, ``heartbeat`` without commands, ``block_received``
   recorded) and a wire client on the port's datatransfer (64 KiB
   packets, its acks read as they come), at ``DataNodeConfig()`` /
   ``ReductionConfig()`` defaults (dedup_lz4, 32 MiB lz4 containers,
   ``pipeline_depth`` 4, a 2 ms group commit, 4 write slots).  (a) Three
   DataNodes, replication 3 (DN1 with targets DN2 and DN3: reduced
   mirroring, the chunk delta down the chain): the first two blocks of
   a three-block ``reduce`` corpus (random 1 MiB segments with copies),
   one on each of 2 concurrent streams (the reference harness's ``dfs
   --pipeline-ab --streams 4``, cut to two blocks: at four, with
   RESILIENCE, the smoke took 1,083.5 s against its 1,050 s target on
   the H100, PERF.md PR 16).  The write kernels' launches (zeroed
   before) are > 0, the coalescer ran groups, no seal fell back to the host codec
   (``worker_fallbacks`` 0); every block is read back from all three
   with ``READ_BLOCK`` and equals the bytes written, ``BLOCK_CHECKSUM``
   equals ``native.crc32c_chunks`` of them, and each DataNode's IBRs
   equal the blocks and lengths (``DATANODE write``: ms a block on the
   client clock, aggregate MiB/s, the phase ms a block from the
   BlockTimelines of the primary and of each mirror's ingest, the dedup
   ratio, each mirror leg's chunk-delta bytes against the logical, the
   coalescer's groups and mean size, launches a block).  One more block
   under the profiler (``PROFILE datanode_write``; two until PR 16, cut
   for the smoke's time), then its IBRs on all three and a read from
   DN3.  A failed mirror leg still acks the
   client (pipeline recovery), so every pass also holds the DataNodes'
   failure counters (``DN_FAULTS``: failed legs, worker fallbacks, op
   and IBR errors, blocks lost at start, coded fallbacks, segment and
   assemble failures) to no change, and (b) to its one refused leg.
   DN1 restarted on its directory with
   ``device_recon``: the index reopens, no block is dropped, every block
   reads back through ``gather_raw`` (``DATANODE read``).  (b) Four fresh
   DataNodes at ``mirror_parity`` 1 (DN1 with targets DN2-DN4: k 2, m 1):
   two blocks, the second with its leg to DN3 refused so that the parity
   leg is hedged in; the mirrors hold their segments (partial IBRs), DN2
   assembles the second block through the RS decode, and it reads back
   equal (``DATANODE mirror``).  Each pass's directories are deleted
   when it ends.  The ``pipeline_depth`` 4 beside 1 pass that was (c),
   information only, is left out to keep the smoke inside its time.
12. NAMENODE, the port's NameNode (hdrf_tpu_torch/server/namenode.py) at
   ``NameNodeConfig()`` defaults (replication 3, 128 MiB blocks, 1 s
   heartbeats, 6 s dead-node detection; its meta dir under a
   ``tempfile`` root, on a fixed port so that it restarts there) and
   four port DataNodes on ``cuda:0`` at ``DataNodeConfig()`` /
   ``ReductionConfig()`` defaults registered with it (its block size
   ``--block-mib``, 128 MiB at the defaults); the port's ``HdrfClient``
   writes each file (``create(scheme="dedup_lz4")``, ``add_block`` and
   the block streamed down the pipeline it chose, ``complete`` polled
   until the IBRs are in; ms a block from ``_write_block``).
   (a) Two one-block files (blocks 0 and 2 of the ``reduce`` corpus) by
   two concurrent writers: every replica listed reads back equal with
   ``READ_BLOCK``, ``BLOCK_CHECKSUM`` equals ``native.crc32c_chunks``,
   ``stat`` lengths are right, the CDC, SHA-256 and seal kernels
   launched (``NAMENODE write``).  (b) The NameNode stopped and
   restarted on its meta dir: the same namespace and counters after the
   replay, startup safemode cleared by the DataNodes' reports, the same
   locations (``NAMENODE restart``).  (c) A replica holder stopped: it
   is declared dead, ``replicate`` commands copy its blocks to the
   fourth DataNode, whose new replicas read back equal; the holder
   restarted: its excess replicas are pruned through ``invalidate``
   until every block's listed holders are exactly the DataNodes that
   hold it (``NAMENODE rereplicate``).  (d) ``ec_demote_after_s`` set to
   1 s: ``stripe_demote`` of every block (``rs`` launches > 0),
   ``stripe_complete`` counted by ``ec_status``, the other replicas
   invalidated, every block read back from its owner, and no DataNode
   holding more than m (3) stripes of a group, so that any one loss
   leaves k (``NAMENODE stripes after demotion``: each group's stripes
   a DataNode; a demotion the health report's vetoes defer fails the
   wait with ``ec_demotions_deferred`` and the vetoed DataNodes); a
   stripe holder that owns no block stopped: ``stripe_repair``
   re-decodes its stripes (``rs`` launches > 0) until no manifest names
   it, every group again at most m a DataNode unless the NameNode
   counted a repair with no room for that (``stripe_repairs_over_m``),
   no group unrecoverable, and every block reads back equal again
   (``NAMENODE stripes after repair``, ``NAMENODE ec``).  (e) 1,000 empty-file
   ``create`` + ``complete`` pairs over 8 threads, as Hadoop's
   ``NNThroughputBenchmark`` does: ops/s, client p50/p99 and the
   ``rpc.namenode`` p99 (``NAMENODE meta``, information only).  Every
   step holds ``DN_FAULTS``; ``NAMENODE launches`` sums the kernels'
   launches over the steps.  ``NAMENODE log`` lines (``DnCommandLog``)
   give each ``replicate`` command's outcome (the source's meta missing,
   returned, or the exception), every command that raises and every
   OSError an xceiver op swallows.  The ``restart``, ``rereplicate``
   and ``ec`` lines carry the step's change in the command counters
   (``NN_COMMAND_COUNTERS``), and ``NAMENODE containers`` lines each
   block's owner-side container states before and after the demotion
   (a demotion that times out prints them too).
13. CLIENT, the port's ``MiniCluster`` (hdrf_tpu_torch/testing/
   minicluster.py) on ``cuda:0``: ``NameNodeConfig`` defaults where they
   matter (replication 3, ``--block-mib`` blocks, 1 s heartbeats, 6 s
   dead-node verdict), 32 MiB containers, nine DataNodes (RS-6-3-1024k,
   HDFS's default EC policy, needs k + m = 9) at the reference's
   ``native`` in-process backend, and ``tpu_worker=True``: one port
   reduction worker PROCESS owns the card (its ``ping`` must say
   ``cuda``), and the DataNodes send it ``reduce`` and the seals (its
   ``traces`` ledger must hold ``resident.cdc``, ``resident.sha`` and
   ``lz4.scan`` dispatches).  The port's ``HdrfClient`` in this process
   (``mc.client()``, device ``cuda``).  (a) The ``reduce`` corpus's
   blocks 0-1 as ``/c/a`` (dedup_lz4) and block 0 again as ``/c/dup``:
   read whole and at odd ranges across the block boundary over TCP
   (reduced replicas pass no fd: ``metadata_only`` rises,
   ``short_circuit_reads`` does not), ``get_file_checksum`` equal to
   ``native.crc32c`` (``CLIENT write``: client ms a block, MiB/s, the
   duplicate's ms and dedup).  (b) Block 2 as ``/c/d`` (direct): read
   through the short-circuit fd (twice: the second read through the
   cached fd) and once with ``ClientConfig(short_circuit=False)``, equal
   (``wire_ms`` is one cold read); deleted, its replicas
   invalidated, the cached fd revoked (a read of the old block through
   the cache returns nothing), re-created with one MiB of other bytes
   and read back (``CLIENT read``).  (c) ``/c/a``'s bytes as ``/c/ec`` with
   ``ec="rs-6-3-1024k"``: the client's ``rs`` launches > 0, the three
   parity blocks the DataNodes store equal to the plain version of the
   encode of the bytes' cell layout, read back equal,
   ``get_file_checksum`` equal to ``/c/a``'s; a data-shard holder
   stopped, the whole and a ranged read decode on the card (``rs``
   launches rise), equal the bytes, and each decode equals the plain
   version on the same shards (``CLIENT ec``).  Every step holds ``DN_FAULTS``
   (``worker_fallbacks`` among them) to no change.
14. PLANES, the DataNode's planes that are off by default and the
   operator surface.  (a) One ``--block-mib`` block of the ``reduce``
   corpus through ``ResidentReducer`` on the card at each of the nine
   geometries ``AdaptiveChunkController`` can emit (mask bits 8-16):
   cuts and digests equal ``native.cdc_select`` + ``sha256_batch``, the
   select's telemetry lanes ``H_SURV`` / ``H_CANDS`` (summed by
   ``accounting.record_scan_summary``) equal a host count over
   ``native_bits``, and on the block's first 8 MiB the select kernel's
   table (lanes included) equals its plain version's (``PLANES sweep``:
   first-use and steady ms a block, chunks, launches).  (c), inside
   NAMENODE after its step (d), on the demoted cluster (its NameNode
   runs its status server): one scrub cycle a DataNode with the scrub
   throttle raised to 1 GiB/s (stripes CRC'd, the any-k spot-check),
   no corruption found; then a fresh 80 MiB file, one byte flipped in a
   sealed container of its own and one in an owner's stripe: the next
   cycles quarantine both (``.quar``), the block is reported
   ``bad_block`` and re-replicated, the stripe is decoded back on the
   card, each decode equal to the plain version, and every block reads
   back equal; the NameNode's ``/prom`` and ``/contention`` (``PLANES
   scrub``).  (b) In a spawned process that runs while CLIENT and the
   sweep run here (``child_pool``): a port MiniCluster of three DataNodes
   (replication 3, ``cdc_adaptive``, a status port,
   ``provided_mount_root``) with
   ``tpu_worker=True`` and the port's HdrfClient on ``cuda``: fresh
   random blocks until the controllers have coarsened twice (every
   block's chunks equal the native cuts at the geometry its primary
   held, the worker's ledger grows by ``resident.cdc`` dispatches at
   each, every block reads back equal), ``get_reconfigurable`` and
   ``reconfigure`` refusals, a retune applied by ``dfsadmin -reconfig``
   and rolled back by the guard over an injected flight window
   (``PLANES adaptive``).  (d) The DataNode's ``/prom`` and
   ``/timeseries``, the gateway's ``/health``, a ``--block-mib`` CREATE
   and OPEN through the gateway's two-step redirect, read back equal,
   ``/traces?format=chrome`` parsed, and ``alias_add`` of an 8 MiB
   region under the mount root read back with ``READ_BLOCK`` (``PLANES
   surface``).  Every step holds ``DN_FAULTS``.
15. RESILIENCE, federation, lazy persist and the crash points on the
   card, in a spawned process that starts when PLANES (b)/(d) end and
   runs while CLIENT and PLANES (a) run here; BENCH waits for it.  (a)
   A port ``MiniCluster`` with two nameservices (two
   NameNodes, pools 0 and 1) over three DataNodes (replication 1,
   ``--block-mib`` blocks, 32 MiB containers, 1 s heartbeats) and
   ``tpu_worker=True``: one ``dedup_lz4`` block of the ``reduce`` corpus
   a namespace, written at once by two port clients on ``cuda``, read
   back at once, equal; each namespace's block ids ``>> 48`` equal its pool
   index, the pools are disjoint, and a full block report of every
   DataNode to both NameNodes invalidates nothing (``RESILIENCE
   federation``).  (b) One DataNode with a RAM_DISK and a DISK volume,
   its ``reduce`` and seals sent to (a)'s worker: a ``dedup_lz4`` block
   under the ``lazy_persist`` policy lands on the RAM volume (a 0-byte
   replica file, no container there), the lazy writer shadows it onto
   DISK, the shm directory is deleted while the DataNode is down, and
   the restarted DataNode reads the block back equal from its shadow
   (``RESILIENCE lazy_persist``).  (c) SCHEME's in-process ``dedup_lz4``
   wiring: two blocks reduced, the seal of the open container crashed
   (``fault_injection`` at ``container.seal``: the raw file survives,
   no sealed file, both blocks read back) and retried (every sealed
   file decodes to its payload); a third block's WAL append crashed
   (``index.wal_append``: the index unchanged) and retried; the index
   closed and reopened equal, all three blocks read back (``RESILIENCE
   crash``).  The worker's launches in (a) and in (b) are the change
   of its wrappers' counters (``kernel_launches`` in its ``stats``
   reply) across each part, (c)'s the change of this process's; each
   reduce and seal kernel must launch in each part (the worker's ledger
   dispatches by op are printed beside them).
16. BENCH, the port's nine harnesses (hdrf_tpu_torch/benchmarks.py)
   through ``benchmarks.main(argv)`` in this process on the card, their
   standard output captured: ``reduction`` and ``cdc`` at ``--mb 128``
   (one HDFS block), ``sort``, ``ec``, ``ec --repair-ab``, ``recon``,
   ``multichip`` and ``churn`` at the reference's defaults, ``dfs --mb
   16``, ``dfs --pipeline-ab --rounds 1 --mb 16`` (``--backend cuda``),
   ``nn`` and ``nn --observer-ab --rounds 1`` at ``--ops 200``, ``nn
   --kill-active --duration 3``.  Each line prints as ``BENCH <which>
   <line>``; each
   harness must print the lines its reference's docstring gives it, run
   on ``cuda``, and hold its oracle flags: ``cdc``'s cuts against the
   native library and its ``H_SURV`` / ``H_CANDS`` lanes equal to the
   plain scan's count on the same block (rebuilt from its seed),
   ``reduction``'s chunk count equal to the native library's on its
   corpus, ``ec``'s parity against ``encode_ref`` and its 1.5 ratio,
   ``--repair-ab``'s 129 erasure patterns pinned, ``multichip``'s
   oracle and one ledger dispatch a mesh step, ``nn``'s zero errors, no
   stale read past a failover.  Every kernel but the shard scan
   launches in the phase (``BENCH launches``; no ('data', 1) mesh runs
   the shard scan), which takes at most 120 s (``BENCH done in``).
17. One JSON line ``{"kernels": [...]}`` (the ``cdc_select`` entry with
   the sweep's ``surv_cands_max_abs_err`` and ``sweep_launches``, the
   ``rs`` entry with the scrubber's ``scrub_launches`` and
   ``scrub_max_abs_err``, every entry with its ``bench_launches`` and
   RESILIENCE's ``resilience_launches`` (in this process, (c)) and
   ``resilience_worker_launches`` (the worker's counters, (a) and (b))),
   the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

kernel_times.py times the scans, the select, SHA-256, the match deltas,
the row sort, the RS kernel and the raw gather of any checkout on the
same inputs (``time_scan``, ``time_image``, ``time_shard``,
``time_select``, ``time_sha``, ``time_match``, ``time_sort_site``,
``time_rs``, ``time_raw``).

The CDC kernel pair is two wrapper calls with a launch count each:
``cdc_scan`` and ``cdc_select`` (whose four kernels count as one
launch); ``be_image`` (the scan's words-only mode, its own counter) and
``shard_scan`` (the same source) are the third and fourth.  Their launch
counts are those of the seal's and the MESH phase's ``reduce_sharded``
requests.  ``gather_raw`` (the raw lane gather of the read path, a
jitted XLA program in the reference, not a ``pallas_call``) counts its
launches over SCHEME's first full read pass, ``rs`` (the reference's
jitted bit-matrix product, filed under its "TPU kernels") its launches
over EC's demote, degraded reads and repairs; the client's in CLIENT
(the EC write's encode, the degraded reads' decodes) and their error
there stand in the ``rs`` entry's own ``client_launches`` and
``client_max_abs_err``.  Bounds use the card's
published peaks: 3.35 TB/s HBM, and
16.7 T int32 ops/s (132 SMs x 64 INT32 lanes x 1.98 GHz; the kernels are
integer work).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from hdrf_tpu_torch import native
from hdrf_tpu_torch.config import CdcConfig
from hdrf_tpu_torch.ops import (_build, cdc_cuda, gather_cuda, gear,
                                lz4_device,
                                sha256_cuda, sort_cuda)
from hdrf_tpu_torch.ops import dispatch as ops_dispatch
from hdrf_tpu_torch.ops.dispatch import gear_mask
from hdrf_tpu_torch.ops.resident import ResidentReducer
from hdrf_tpu_torch.ops.sha256 import sha256_words
from hdrf_tpu_torch.parallel import launch, sharded
from hdrf_tpu_torch.proto.datatransfer import DEFAULT_PACKET
from hdrf_tpu_torch.reduction import scheme as ops_scheme
from hdrf_tpu_torch.server.reduction_worker import (ReductionWorker,
                                                    WorkerClient,
                                                    kernel_launches)
from hdrf_tpu_torch.utils import metrics, profiler

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer ops per unit of work as sm_90 issues them: a rotate is one SHF,
# a three-input logic op one LOP3, a three-operand add one IADD3, a
# shift-add one LEA.  SHA-256 per 64-byte block: a schedule word is
# sigma0 + sigma1 (2 SHF + 1 SHR + 1 LOP3 each) and 2 IADD3 = 10, a round
# is Sigma1 + Sigma0 (3 SHF + 1 LOP3 each), Ch and Maj (1 LOP3 each),
# T1 (2 IADD3), e and a (1 IADD3 each) = 14, then 8 state adds.  CDC scan
# per byte: byte extract, table load, shift-add, mask test (LOP3 to a
# predicate), bit set.  CDC select per cut: frontier adds and min, a find-
# first-set, the bin test, the cut and lane stores.
SHA_OPS_PER_BLOCK = 48 * 10 + 64 * 14 + 8
CDC_SCAN_OPS_PER_BYTE = 5
CDC_SELECT_OPS_PER_CUT = 8
# Match deltas per entry: the hash (IMAD + SHF), the same-hash test, the
# gram compare with the previous occurrence, the rotate of the degenerate
# test (SHF) and its compare, the offset (IADD3, IMAD by the stride), the
# cap compare and the select.
MATCH_OPS_PER_ENTRY = 10
MIB = 1 << 20
SEAL_BYTES = 32 * MIB        # the reference's container_size (1 << 25)
_I32_MIN = -(1 << 31)
TRACE_DIR = Path(__file__).resolve().parent / "chiprun_out"
# runtime calls that put work on the device, and the trace categories of
# their device records (``profiled`` matches each call to its record)
DEVICE_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROFILE_WARMUP_LAUNCHES = 512
MISPLACED_US = 50_000.0     # a record this far before its call is misplaced
SELECT_KERNELS = ("cdc_select",)     # the select's kernels, by name
SCAN_KERNELS = ("cdc_scan_kernel",)
# be_image's words-only scan; a checkout without it runs the full scan
IMAGE_KERNELS = ("be_image_kernel", "cdc_scan_kernel")
SHARD_KERNELS = ("cdc_shard_scan_kernel",)
SHA_KERNELS = ("sha256_kernel",)
MATCH_KERNELS = ("match_",)          # the match deltas' kernels
SHA_TIMED = ("random-block", "text-block", "zeros-block")
MATCH_TIMED = ("random", "zeros", "text", "source", "sparse")
IMAGE_TIMED = "random"               # be_image's 32 MiB container
SORT_KERNELS = ("sort_",)            # the row sort's tile and merge kernels
L2_SCRUB_BYTES = 128 * MIB           # written before each timed call
FILL_KERNELS = ("FillFunctor",)      # the scrub's write, by kernel name
REDUCE_KERNEL_NAMES = {"cdc_scan_kernel": "cdc_scan",
                       "cdc_select_": "cdc_select",   # its four kernels
                       "gather_pad_kernel": "gather_pad",
                       "sha256_kernel": "sha256"}
SORT_SITES = ("L1", "L2", "L3", "E1", "E2")   # match_scan's sort call sites
# under min_chunk and no power of two's divisor: chains meet late (1,531)
# or never (3, a solid 24-bit colour)
ADVERSARIAL_PERIODS = {"periodic-block": 1531, "period3-block": 3}

KERNELS = {
    "cdc_scan": ("hdrf_tpu_torch/csrc/cdc.cu",
                 "hdrf_tpu/ops/cdc_pallas.py:476"),
    "cdc_select": ("hdrf_tpu_torch/csrc/cdc.cu",
                   "hdrf_tpu/ops/cdc_pallas.py:476"),
    "be_image": ("hdrf_tpu_torch/csrc/cdc.cu",
                 "hdrf_tpu/ops/cdc_pallas.py:476"),
    "gather_pad": ("hdrf_tpu_torch/csrc/gather.cu",
                   "hdrf_tpu/ops/gather_pallas.py:122"),
    "sha256": ("hdrf_tpu_torch/csrc/sha256.cu",
               "hdrf_tpu/ops/sha256_pallas.py:99"),
    "match_deltas": ("hdrf_tpu_torch/csrc/sort.cu",
                     "hdrf_tpu/ops/sort_pallas.py:273"),
    "sort_rows": ("hdrf_tpu_torch/csrc/sort.cu",
                  "hdrf_tpu/ops/sort_pallas.py:148"),
    "shard_scan": ("hdrf_tpu_torch/csrc/cdc.cu",
                   "hdrf_tpu/ops/cdc_pallas.py:570"),
    # a jitted XLA program of the reference, not a pallas_call
    "gather_raw": ("hdrf_tpu_torch/csrc/gather.cu",
                   "hdrf_tpu/ops/reconstruct.py:46"),
    # the reference's jitted bit-matrix product, filed under "TPU kernels"
    "rs": ("hdrf_tpu_torch/csrc/rs.cu", "hdrf_tpu/ops/rs.py:167"),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def probe() -> dict:
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvidia_smi": nvidia_smi(),
            "nvcc": _build.nvcc_path(), "triton": has_triton,
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count()}


def standard_corpora():
    """The seven corpora of tests/test_cdc_pallas.py, from their seed."""
    rng = np.random.default_rng(7)
    text = rng.integers(97, 123, size=200_000, dtype=np.uint8)
    yield "random", rng.integers(0, 256, 150_000, dtype=np.uint8), \
        0x1FFF, 2048, 65536
    yield "text-low-entropy", text, 0x1FFF, 2048, 65536
    yield "forced-max-runs", rng.integers(0, 256, 120_000, dtype=np.uint8), \
        0xFFFFFF, 512, 4096
    yield "dense", rng.integers(0, 256, 30_000, dtype=np.uint8), 0x7, 8, 64
    yield "tail-short-chunk", rng.integers(0, 256, 65536 + 37,
                                           dtype=np.uint8), \
        0x1FFF, 2048, 65536
    yield "single-tile", rng.integers(0, 256, 65536, dtype=np.uint8), \
        0x3FF, 256, 8192
    yield "sub-tile", rng.integers(0, 256, 300, dtype=np.uint8), 0x3F, 16, 128


def buckets_of(mask: int, max_chunk: int) -> tuple[int, int]:
    """(b_small, b_big) by the ResidentReducer rule for a mask's bit count."""
    mb = max(bin(mask).count("1"), 1)
    max_nb = (max_chunk + 9 + 63) // 64
    return max(1, min((2 << mb) // 64, max_nb)), max_nb


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


_scrub: list = []


def scrub_l2() -> None:
    """Write a buffer larger than the card's L2 (50 MB), so that the next
    call reads its inputs from HBM, as the byte bound assumes."""
    if not _scrub:
        _scrub.append(torch.empty(L2_SCRUB_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    _scrub[0].fill_(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), the
    L2 scrubbed before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        scrub_l2()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


class Traced(NamedTuple):
    """One profiled window: its host-clock bounds (us), the launch and
    copy calls made inside it, those without a device record, those
    whose record starts more than ``MISPLACED_US`` before the call, and
    the device records (trace events) of its calls."""
    lo: float
    hi: float
    calls: int
    lost: int
    misplaced: int
    records: list


def profiled(fn, trace: Path,
             warmup: int = PROFILE_WARMUP_LAUNCHES) -> Traced:
    """Run ``fn()`` (then a device synchronize) as the window
    ``smoke.window`` of a torch.profiler session (CPU and CUDA), after
    ``warmup`` small launches in the same session, and export the trace
    to ``trace``.  The window's calls are those made (by any thread)
    between its host-clock bounds; their records are found by
    correlation id, not by time.

    The warm-up: the first records of a session carry device timestamps
    hundreds of ms early, so the profiler drops them as out of its range
    or keeps them out of place; the older the process, the more records
    (none in a fresh process).  The warm-up launches take those
    (``PROFILE warmup`` lines count them).  A window with a call that
    lost its record or has it out of place is not measured."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(warmup):
            x.add_(1)
        torch.cuda.synchronize()
        with record_function("smoke.window"):
            fn()
            torch.cuda.synchronize()
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    win = next(e for e in events if e.get("name") == "smoke.window"
               and e.get("cat") == "user_annotation")
    lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    recs = {e["args"]["correlation"]: e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and "correlation" in e.get("args", {})}
    calls = [(e["args"]["correlation"], float(e["ts"])) for e in events
             if e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})
             and e["name"].startswith(DEVICE_CALLS)
             and lo <= float(e["ts"]) <= hi]
    return Traced(lo, hi, len(calls),
                  sum(c not in recs for c, _ in calls),
                  sum(c in recs and float(recs[c]["ts"]) < t - MISPLACED_US
                      for c, t in calls),
                  [recs[c] for c, _ in calls if c in recs])


def warmup_probe(t_start: float) -> dict:
    """The profiler's early records against the warm-up: 30 small
    launches ~2 ms apart in a window without a warm-up and in one after
    ``PROFILE_WARMUP_LAUNCHES``; each window's calls without a device
    record or with it out of place, at this process age."""
    x = torch.ones(1 << 20, device="cuda")

    def launches():
        for _ in range(30):
            x.add_(1)
            time.sleep(0.001)
    out = {"process_age_s": time.perf_counter() - t_start}
    for warm in (0, PROFILE_WARMUP_LAUNCHES):
        w = profiled(launches, TRACE_DIR / "warmup_trace.json", warm)
        out[f"warmup_{warm}"] = {"calls": w.calls, "lost": w.lost,
                                 "misplaced": w.misplaced}
    print("PROFILE warmup " + json.dumps(out), flush=True)
    return out


def device_ms(fn, names, reps: int = 10, exclude=()):
    """Device time per call of ``fn``'s kernels — those whose name holds
    one of ``names`` and none of ``exclude`` — summed from torch.profiler
    (``profiled``) over ``reps`` calls after one warm-up, the L2 scrubbed
    before each; None when the window holds none of them or is not
    measured.  Unlike ``cuda_ms`` it leaves out the host's launch
    overhead."""
    fn()

    def run():
        for _ in range(reps):
            scrub_l2()
            fn()
    w = profiled(run, TRACE_DIR / "device_ms_trace.json")
    us = [float(e["dur"]) for e in w.records if e["cat"] == "kernel"
          and any(n in e["name"] for n in names)
          and not any(n in e["name"] for n in exclude)]
    return sum(us) / 1e3 / reps if us and not (w.lost or w.misplaced) \
        else None


def timed(fn):
    """(result, wall ms) of one synchronised call — the plain versions are
    run once, their time taken on that run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Cdc(NamedTuple):
    """One corpus's block on the card and the CDC pair's outputs."""
    block: torch.Tensor
    n: int
    words: torch.Tensor
    bitmap: torch.Tensor
    sel: tuple            # (table, ols, olb)
    b_small: int
    scan_plain_ms: float
    select_plain_ms: float


def cdc_phase(name, a, mask, mn, mx, dev, errs) -> Cdc:
    """The CDC scan and select kernels against their plain versions on
    one corpus: words, bitmap, header, cuts and both lane tables."""
    b_small, _ = buckets_of(mask, mx)
    block, n = cdc_cuda.padded_block(a, dev)
    words, bitmap = cdc_cuda.cdc_scan(block, n, mask, mn)
    (pw, pb), scan_ms = timed(lambda: cdc_cuda.cdc_scan_plain(block, n, mask,
                                                              mn))
    e = max(max_err(words, pw), max_err(bitmap, pb))
    errs["cdc_scan"] = max(errs["cdc_scan"], e)
    check(e == 0, f"{name}: cdc scan kernel != plain (max err {e})")
    e = max_err(cdc_cuda.be_image(block), pw)
    errs["be_image"] = max(errs["be_image"], e)
    check(e == 0, f"{name}: be_image kernel != plain (max err {e})")
    del pw, pb
    k = cdc_cuda.cdc_select(bitmap, n, mn, mx, b_small)
    p, sel_ms = timed(lambda: cdc_cuda.cdc_select_plain(bitmap, n, mn, mx,
                                                        b_small))
    hk, hp = k[0][:8].cpu().tolist(), p[0][:8].cpu().tolist()
    check(hk[:4] == hp[:4], f"{name}: cdc header {hk} != {hp}")
    nc, _, ns, nbg = hk[:4]
    e = max(max_err(k[0][:8 + nc], p[0][:8 + nc]),
            max_err(k[1][:, :ns], p[1][:, :ns]),
            max_err(k[2][:, :nbg], p[2][:, :nbg]))
    errs["cdc_select"] = max(errs["cdc_select"], e)
    check(e == 0, f"{name}: cdc select kernel != plain (max err {e})")
    return Cdc(block, n, words, bitmap, k, b_small, scan_ms, sel_ms)


def time_select(name, c: Cdc, mn, mx) -> dict:
    """The select's time on one corpus: one wrapper call (CUDA events),
    its kernels alone (profiler), and its byte bound — the bitmap read,
    header + cuts and one lane entry per cut written."""
    def sel():
        return cdc_cuda.cdc_select(c.bitmap, c.n, mn, mx, c.b_small)
    nc = int(c.sel[0][0])
    b = bound(c.bitmap.numel() * 4 + 4 * (8 + nc) + 8 * nc,
              CDC_SELECT_OPS_PER_CUT * nc)
    row = {"cuts": nc, "ms": cuda_ms(sel),
           "device_ms": device_ms(sel, SELECT_KERNELS), "bound_ms": b[0],
           "bound_by": b[1]}
    print(f"TIMING cdc_select {name}: " + json.dumps(row), flush=True)
    return row


def time_scan(name, c: Cdc, mask, mn) -> dict:
    """The scan's time on one corpus: one wrapper call (CUDA events), its
    kernel alone (profiler), and its byte bound — the block read, the word
    image and the bitmap written."""
    def scan():
        return cdc_cuda.cdc_scan(c.block, c.n, mask, mn)
    b = bound(c.block.numel() + c.words.numel() * 4 + c.bitmap.numel() * 4,
              CDC_SCAN_OPS_PER_BYTE * c.n)
    row = {"bytes": c.block.numel(), "ms": cuda_ms(scan),
           "device_ms": device_ms(scan, SCAN_KERNELS), "bound_ms": b[0],
           "bound_by": b[1]}
    print(f"TIMING cdc_scan {name}: " + json.dumps(row), flush=True)
    return row


def library_image(block: torch.Tensor) -> torch.Tensor:
    """The BE word image in one PyTorch call (the yardstick of
    ``be_image``; the port never calls it)."""
    return block.view(-1, 4).flip(-1).contiguous().view(torch.int32) \
        .reshape(-1)


def time_image(name, block: torch.Tensor) -> dict:
    """``be_image`` on one padded block: one wrapper call (CUDA events), its
    kernel alone (profiler), the library call, and the byte bound — the
    block read once, the image written once.  Held first against the
    plain version and the library call, tolerance zero."""
    def img():
        return cdc_cuda.be_image(block)
    want = gear.be_words(block)
    e = max(max_err(img(), want), max_err(library_image(block), want))
    check(e == 0, f"be_image {name}: kernel != plain (max err {e})")
    del want
    b = bound(2 * block.numel(), 0)
    row = {"bytes": block.numel(), "ms": cuda_ms(img),
           "device_ms": device_ms(img, IMAGE_KERNELS),
           "library_ms": cuda_ms(lambda: library_image(block)),
           "bound_ms": b[0], "bound_by": b[1]}
    print(f"TIMING be_image {name}: " + json.dumps(row), flush=True)
    return row


def time_shard(name, local, halo, base, mask, n_seq) -> dict:
    """The shard scan on one shard: one wrapper call (CUDA events), its
    kernel alone (profiler), and its byte bound — the shard and halo read,
    the bitmap and count written."""
    def shard():
        return cdc_cuda.shard_scan(local, halo, base, mask)
    (kw, kc), (pw, pc) = shard(), cdc_cuda.shard_scan_plain(local, halo,
                                                            base, mask)
    e = max(max_err(kw, pw), max_err(kc, pc))
    check(e == 0, f"shard_scan {name} n_seq {n_seq}: kernel != plain (max "
                  f"err {e})")
    del kw, kc, pw, pc
    m = local.numel()
    b = bound(m + 31 + m // 8 + 4, CDC_SCAN_OPS_PER_BYTE * m)
    row = {"n_seq": n_seq, "bytes": m, "ms": cuda_ms(shard),
           "device_ms": device_ms(shard, SHARD_KERNELS), "bound_ms": b[0],
           "bound_by": b[1]}
    print(f"TIMING shard_scan {name} n_seq {n_seq}: " + json.dumps(row),
          flush=True)
    return row


def lane_tables(c: Cdc, mask: int, mx: int) -> list:
    """Both lane tables of a CDC result as the reducer hashes them: [(big
    bucket's lanes, bucket), (small bucket's lanes, bucket)]."""
    b_small, b_big = buckets_of(mask, mx)
    _, _, ns, nbg = c.sel[0][:4].cpu().tolist()
    return [(c.sel[2][:, :nbg], b_big), (c.sel[1][:, :ns], b_small)]


def lane_phase(name, a, c: Cdc, mask, mx, dev, errs, timing=None) -> None:
    """The gather and SHA-256 kernels against their plain versions on
    both lane tables of one corpus, SHA-256 through one grouped launch and
    through the one-table call (small corpora also against hashlib); with
    ``timing`` (a dict), also time the gather at this corpus's shapes and
    take the plain SHA's time."""
    nc = int(c.sel[0][0])
    if timing is not None:
        timing["gather_pad"] = {"ms": 0.0, "plain_ms": 0.0,
                                "library_ms": None, "bytes": 0.0, "ops": 0.0}
        timing["sha256"] = {"plain_ms": 0.0, "library_ms": None}
    lts, tables, digs = lane_tables(c, mask, mx), [], {}
    for lanes, bucket in lts:
        mk = gather_cuda.gather_pad_messages(c.words, lanes, bucket)
        mp, mp_ms = timed(lambda: gather_cuda.gather_pad_messages_plain(
            c.words, lanes, bucket))
        eg = max_err(mk, mp)
        errs["gather_pad"] = max(errs["gather_pad"], eg)
        check(eg == 0, f"{name}: gather kernel != plain (max err {eg})")
        tables.append((mk, ((lanes[1] + 9 + 63) // 64).to(torch.int32)))
        if timing is not None and lanes.shape[1]:
            L, W = lanes.shape[1], bucket * 16
            g = timing["gather_pad"]
            g["ms"] += cuda_ms(lambda: gather_cuda.gather_pad_messages(
                c.words, lanes, bucket))
            g["plain_ms"] += mp_ms
            byte_idx = (lanes[0].to(torch.int64)[:, None] + torch.arange(
                W * 4, device=dev)[None, :]).clamp_(max=c.block.numel() - 1)
            g["library_ms"] = (g["library_ms"] or 0.0) + cuda_ms(
                lambda: c.block[byte_idx], reps=5, warmup=1)
            del byte_idx
            g["bytes"] += int(lanes[1].sum()) + 8 * L + 4 * L * W
    grouped = sha256_cuda.sha256_words_grouped(tables)
    for (mk, nb), (lanes, _), dk in zip(tables, lts, grouped):
        dp, dp_ms = timed(lambda: sha256_words(mk, nb))
        torch.cuda.synchronize()
        es = max(max_err(dk, dp),
                 max_err(sha256_cuda.sha256_words_cuda(mk, nb), dp))
        errs["sha256"] = max(errs["sha256"], es)
        check(es == 0, f"{name}: sha256 kernel != plain (max err {es})")
        if timing is not None:
            timing["sha256"]["plain_ms"] += dp_ms
        for o, ln, d in zip(lanes[0].cpu().numpy(), lanes[1].cpu().numpy(),
                            dk.cpu().numpy()):
            digs[int(o)] = (int(ln), d)
    if timing is not None:
        t = timing["gather_pad"]
        t["bound"] = bound(t.pop("bytes"), t.pop("ops"))
    # the small corpora are also held against hashlib
    if a.size <= 1 << 20:
        cuts = c.sel[0][8:8 + nc].cpu().numpy().astype(np.int64)
        check(len(digs) == nc, f"{name}: {len(digs)} digests for {nc} cuts")
        for o in np.concatenate([[0], cuts[:-1]]):
            ln, d = digs[int(o)]
            check(bytes(d) == hashlib.sha256(a[o:o + ln].tobytes()).digest(),
                  f"{name}: digest at {o} != hashlib")


def time_sha(name, a, c: Cdc, mask, mx, chain) -> dict:
    """SHA-256 at one 128 MiB block's shapes: each lane table alone (one
    one-table launch each) and both grouped (one launch; two one-table
    launches for a checkout without the grouped call), each as
    one wrapper call (CUDA events) and its kernel alone (profiler), held
    against hashlib on a sample of chunks.  Bounds: bytes (messages read
    once, digests written), operations (1,384 a block), and the chain of
    the longest lane (``chain``: ns a SHF -> LOP3 -> IADD3 link, x 64
    rounds x its blocks)."""
    tables = []
    for lanes, bucket in lane_tables(c, mask, mx):
        tables.append((gather_cuda.gather_pad_messages(c.words, lanes,
                                                       bucket),
                       ((lanes[1] + 9 + 63) // 64).to(torch.int32), lanes))
    grouped = getattr(sha256_cuda, "sha256_words_grouped", None)

    def both():
        if grouped is None:
            return [sha256_cuda.sha256_words_cuda(m, nb)
                    for m, nb, _ in tables]
        return grouped([(m, nb) for m, nb, _ in tables])
    got = both()
    rng = np.random.default_rng(len(name))
    for (_, _, lanes), dk in zip(tables, got):
        for i in rng.integers(0, max(lanes.shape[1], 1),
                              min(lanes.shape[1], 16)):
            o, ln = (int(x) for x in lanes[:, i].cpu())
            check(bytes(dk[i].cpu().numpy())
                  == hashlib.sha256(a[o:o + ln].tobytes()).digest(),
                  f"{name}: grouped digest of lane {i} != hashlib")
    nblk = sum(int(nb.sum()) for _, nb, _ in tables)
    lmax = max(int(nb.max()) if nb.numel() else 0 for _, nb, _ in tables)
    L = sum(nb.numel() for _, nb, _ in tables)
    row = {"lanes": [nb.numel() for _, nb, _ in tables], "blocks": nblk,
           "longest_lane_blocks": lmax}
    for tag, (m, nb, _) in zip(("big", "small"), tables):
        if nb.numel():
            def one(m=m, nb=nb):
                return sha256_cuda.sha256_words_cuda(m, nb)
            row[f"{tag}_ms"] = cuda_ms(one)
            row[f"{tag}_device_ms"] = device_ms(one, SHA_KERNELS)
    row["grouped_ms"] = cuda_ms(both)
    row["grouped_device_ms"] = device_ms(both, SHA_KERNELS)
    row["bytes_bound_ms"] = (64 * nblk + 36 * L) / HBM_BYTES_PER_S * 1e3
    row["op_bound_ms"] = SHA_OPS_PER_BLOCK * nblk / INT32_OPS_PER_S * 1e3
    row["chain_bound_ms"] = (None if chain is None else
                             chain["ns_per_link"] * 64 * lmax / 1e6)
    print(f"TIMING sha256 {name}: " + json.dumps(row), flush=True)
    return row


def periodic_block(seed: int, n: int, period: int, mask: int) -> np.ndarray:
    """n bytes: one random pattern of ``period`` bytes repeated, drawn so
    that the repetition holds exactly one candidate per period.  With a
    period under min_chunk that divides no segment width, the select's
    speculative chains a period apart need not meet."""
    rng = np.random.default_rng(seed)
    reps = -(-64 // period) + 2      # two whole periods past the window
    while True:
        pat = rng.integers(0, 256, period, dtype=np.uint8)
        c = native.gear_candidates(np.tile(pat, reps), mask)
        if np.count_nonzero(c > (reps - 2) * period) == 2:
            return np.resize(pat, n)


def big_blocks(seed: int, nbig: int, mask: int):
    """(name, bytes) of the select's big corpora, one at a time: random,
    zeros, low-entropy text and the periodic adversaries."""
    yield "random-block", np.random.default_rng(seed + 1).integers(
        0, 256, nbig, dtype=np.uint8)
    yield "zeros-block", np.zeros(nbig, dtype=np.uint8)
    yield "text-block", np.random.default_rng(seed + 4).integers(
        97, 123, nbig, dtype=np.uint8)
    for i, (name, period) in enumerate(ADVERSARIAL_PERIODS.items()):
        yield name, periodic_block(seed + 5 + i, nbig, period, mask)


def main_path_corpus(seed: int, nblocks: int, block_mib: int) -> list:
    rng = np.random.default_rng(seed)
    segs, blocks = [], []
    for b in range(nblocks):
        if b == nblocks - 1:
            blocks.append(rng.integers(97, 123, block_mib * MIB,
                                       dtype=np.uint8))
            continue
        blk = np.empty(block_mib * MIB, dtype=np.uint8)
        for i in range(block_mib):
            if segs and rng.random() < 0.25:
                seg = segs[int(rng.integers(0, len(segs)))]
            else:
                seg = rng.integers(0, 256, MIB, dtype=np.uint8)
            blk[i * MIB:(i + 1) * MIB] = seg
            segs.append(blk[i * MIB:(i + 1) * MIB])
        blocks.append(blk)
    return blocks


def packets(a: np.ndarray):
    mv = memoryview(a)
    for off in range(0, a.size, DEFAULT_PACKET):
        yield mv[off:off + DEFAULT_PACKET]


def _host_waits(ledger) -> dict:
    """Cumulative ms the worker's host thread waited on the device, per
    ledger op: the CDC header readback (``resident.cdc``) and the gather +
    SHA + result copies (``resident.sha``).  Not device busy time: copies
    and device work that overlapped Python are not in it."""
    hist = ledger.snapshot()["histograms"]
    return {op: hist[f"wait_us|op={op}"]["sum"] / 1e3
            for op in ("resident.cdc", "resident.sha")
            if f"wait_us|op={op}" in hist}


def _union(spans: list, lo: float, hi: float) -> float:
    """Length of the union of (start, end) spans clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(spans):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def profile_window(tag: str, run_requests, nreq: int, names) -> dict:
    """``nreq`` requests (``run_requests()``) as a ``profiled`` window:
    the device's busy share of the window (the union of the kernel, copy
    and fill records of its calls over its length) and the device ms per
    request of each kernel, by the first of ``names`` (kernel name ->
    label) found in its name.  The trace is kept in
    ``chiprun_out/smoke_trace_<tag>.json``."""
    w = profiled(run_requests, TRACE_DIR / f"smoke_trace_{tag}.json")
    if w.lost or w.misplaced or not any(e["cat"] == "kernel"
                                        for e in w.records):
        print(f"PROFILE {tag} not measured: of {w.calls} launch and copy "
              f"calls {w.lost} without a device record, {w.misplaced} "
              f"out of place", flush=True)
        return {"busy_share": None, "calls": w.calls, "lost": w.lost,
                "misplaced": w.misplaced}
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in w.records]
    per_kernel: dict = {}
    for e in w.records:
        key = e["name"] if e["cat"] != "kernel" else next(
            (label for k, label in names.items() if k in e["name"]),
            "other kernels")
        per_kernel[key] = per_kernel.get(key, 0.0) \
            + float(e["dur"]) / 1e3 / nreq
    out = {"requests": nreq, "window_ms": (w.hi - w.lo) / 1e3,
           "busy_share": _union(spans, w.lo, w.hi) / (w.hi - w.lo),
           "device_ms_per_request": per_kernel, "calls": w.calls}
    print(f"PROFILE {tag} " + json.dumps(out), flush=True)
    return out


def main_path(args, dev, cdc: CdcConfig) -> dict:
    blocks = main_path_corpus(args.seed, args.requests, args.block_mib)
    worker = ReductionWorker("127.0.0.1", 0, backend="cuda").start()
    client = WorkerClient(worker.addr)
    ledger = metrics.registry("device_ledger")
    waits0 = _host_waits(ledger)
    try:
        replies, lat = [], []
        cdc_cuda.scan_launches = cdc_cuda.select_launches = 0
        gather_cuda.launches = sha256_cuda.launches = 0
        for blk in blocks:
            t0 = time.perf_counter()
            replies.append(client.reduce_stream(packets(blk), cdc))
            lat.append(time.perf_counter() - t0)
        launches = {"cdc_scan": cdc_cuda.scan_launches,
                    "cdc_select": cdc_cuda.select_launches,
                    "gather_pad": gather_cuda.launches,
                    "sha256": sha256_cuda.launches}
        waits = {k: v - waits0.get(k, 0.0)
                 for k, v in _host_waits(ledger).items()}
        stats = client.stats()
        again = []
        prof = profile_window(
            "reduce", lambda: again.extend(
                client.reduce_stream(packets(b), cdc) for b in blocks[:2]),
            2, REDUCE_KERNEL_NAMES)
        for (c0, d0), (c1, d1) in zip(replies, again):
            check(np.array_equal(c0, c1) and np.array_equal(d0, d1),
                  "profiled request != its first reply")
    finally:
        client.close()
        worker.stop()
    mask = gear_mask(cdc)
    b_small, _ = buckets_of(mask, cdc.max_chunk)
    all_digs, nchunks = set(), 0
    unique, unique_n = [], 0    # the unique chunks, up to one container
    for i, (blk, (cuts, digs)) in enumerate(zip(blocks, replies)):
        block, n = cdc_cuda.padded_block(blk, dev)
        _, table, _, _ = cdc_cuda.cdc_block_plain(block, n, mask,
                                                  cdc.min_chunk,
                                                  cdc.max_chunk, b_small)
        want = cdc_cuda.table_cuts(table.cpu().numpy()).astype(np.int64)
        check(np.array_equal(cuts, want), f"request {i}: cuts != plain CDC")
        check(digs.shape == (cuts.size, 32), f"request {i}: digest shape")
        start = 0
        for c, d in zip(cuts, digs):
            check(d.tobytes() == hashlib.sha256(blk[start:c]).digest(),
                  f"request {i}: digest of chunk at {start} != hashlib")
            if unique_n < SEAL_BYTES and d.tobytes() not in all_digs:
                all_digs.add(d.tobytes())
                unique.append(blk[start:c])
                unique_n += int(c) - start
            start = int(c)
        all_digs.update(d.tobytes() for d in digs)
        nchunks += cuts.size
        mbps = blk.size / MIB / lat[i]
        print(f"REQUEST {i}: {blk.size} bytes, {cuts.size} chunks, "
              f"latency_ms={lat[i] * 1e3:.3f} MiB/s={mbps:.1f}", flush=True)
    for kname, cnt in launches.items():
        check(cnt > 0, f"main path never launched the {kname} kernel")
    out = {"requests": len(blocks), "chunks": nchunks,
           "dedup_ratio": len(all_digs) / nchunks,
           "latency_ms": [x * 1e3 for x in lat],
           "mib_per_s": [b.size / MIB / x for b, x in zip(blocks, lat)],
           "host_wait_ms_per_request": {
               k: v / len(blocks) for k, v in waits.items()},
           "launches": launches, "profile": prof, "worker_stats": stats}
    print("MAIN_PATH " + json.dumps(out), flush=True)
    return out, np.concatenate(unique)


# ------------------------------------------------------------------- seal


def _seal_text(rng, n: int) -> np.ndarray:
    """tests/test_lz4_tpu.py's word soup: 500 words of 2-8 letters."""
    vocab = [rng.integers(97, 123, size=rng.integers(2, 9),
                          dtype=np.uint8).tobytes() for _ in range(500)]
    out = b" ".join(vocab[i] for i in rng.integers(0, 500, size=n // 5))
    return np.frombuffer(out[:n], np.uint8)


def _fill(b: bytes, n: int) -> np.ndarray:
    return np.frombuffer((b * (n // len(b) + 1))[:n], np.uint8)


def _sparse_copies(rng, n: int) -> np.ndarray:
    """Random bytes with copies confined to part of each 128 KiB supertile:
    80 KiB of fresh bytes, then 48 KiB (three 16 KiB record rows) carrying
    a copy of a 16-256-byte span up to 8 KiB back after every 128-512
    fresh bytes (one copy in 50 is instead a 1,100-2,000-byte run of the
    last 16-64 bytes); every 32nd supertile has no copies.  Its match density lies between the emit and flood regimes:
    above the race threshold (one record per 2 KiB), under the flood cap,
    and in few enough record rows that the L2 slices hold them.  A long
    copy escapes its length and a copy-free supertile the position gap of
    the next record, so both escape lanes carry records."""
    out = rng.integers(0, 256, n, dtype=np.uint8)
    span = 128 << 10
    for base in range(0, n, span):
        if base // span % 32 == 31:
            continue
        p, end = base + (80 << 10), base + span
        while True:
            p += int(rng.integers(128, 513))
            long = rng.random() < 0.02
            ln = int(rng.integers(1100, 2001) if long
                     else rng.integers(16, 257))
            if p + ln > end:
                break
            if long:    # a run: the last 16-64 bytes repeated
                out[p:p + ln] = np.resize(out[p - int(rng.integers(16, 65)):p],
                                          ln)
            else:
                src = p - int(rng.integers(ln, ln + 8193))
                out[p:p + ln] = out[src:src + ln]
            p += ln
    return out


def source_container(n: int) -> np.ndarray:
    """The reference package's source text (structured code), repeated to
    n bytes."""
    root = Path(__file__).resolve().parent / "hdrf_tpu"
    return _fill(b"".join(p.read_bytes() for p in sorted(root.rglob("*.py"))),
                 n)


def seal_corpora(seed: int, chunks: np.ndarray) -> dict:
    """One 32 MiB container of each kind: the generators of
    tests/test_lz4_tpu.py scaled up, the reference package's source text
    (structured code), the unique chunks of the reduce corpus (what a
    dedup_lz4 container holds), and ``sparse``, whose match density lies
    between the emit and flood regimes (the grey-zone race)."""
    rng = np.random.default_rng(seed + 2)
    n = SEAL_BYTES
    return {"text": _seal_text(rng, n),
            "zeros": np.zeros(n, np.uint8),
            "random": rng.integers(0, 256, n, dtype=np.uint8),
            "rand_ascii": rng.integers(97, 123, n, dtype=np.uint8),
            "repeat997": _fill(rng.integers(0, 256, 997,
                                            dtype=np.uint8).tobytes(), n),
            "source": source_container(n),
            "chunks": _fill(chunks.tobytes(), n),
            "sparse": _sparse_copies(rng, n)}


def sort_err(got, want) -> int:
    """Keys and values over every slot: both sorts are stable."""
    return max(max_err(g, w) for g, w in zip(got, want))


def captured_sorts(block, stride: int, p: tuple) -> tuple[list, int]:
    """The inputs of every sort_rows call of one match scan, as the scan
    makes them (L1, L2, L3 and the two escape lanes), and the scan's
    count of kept records."""
    calls = []
    real = sort_cuda.sort_rows

    def record(key, *vals, **kw):
        calls.append((key.clone(), [v.clone() for v in vals], kw))
        return real(key, *vals, **kw)

    sort_cuda.sort_rows = record
    try:
        row = lz4_device.match_scan(block, stride, 4, *p)
    finally:
        sort_cuda.sort_rows = real
    return calls, int(row[0])


def synthetic_sorts(rng, dev) -> list:
    """Unique i32 keys, u32 keys across the sign bit and a padded row that
    is not a power of two."""
    def keys(t, e, off):
        k = np.stack([rng.permutation(e).astype(np.int64) + off
                      for _ in range(t)])
        return torch.from_numpy((k & 0xFFFFFFFF).astype(np.uint32)
                                .view(np.int32)).to(dev)

    def vals(t, e):
        return torch.from_numpy(rng.integers(-2**31, 2**31, (t, e))
                                .astype(np.int32)).to(dev)

    return [
        (keys(2048, 8192, -4096), [vals(2048, 8192), vals(2048, 8192)], {}),
        (keys(128, 8192, 0x80000000 - 4096),
         [vals(128, 8192), vals(128, 8192)], {"key_unsigned": True}),
        (keys(1, 300_000, 0), [vals(1, 300_000)],
         {"pad_key": 2**31 - 1, "pad_vals": (0,)}),
    ]


def sort_library(key, vals, kw):
    """torch.sort + torch.gather of each value: the library yardstick."""
    k = key ^ _I32_MIN if kw.get("key_unsigned") else key
    sk, order = torch.sort(k, dim=1)
    return [sk, *[torch.gather(v, 1, order) for v in vals]]


def sort_bytes(key, vals) -> int:
    return 2 * 4 * key.numel() * (1 + len(vals))


def sort_ops(key) -> float:
    """n log2 n compares per row: the fewest any comparison sort does."""
    e = key.shape[1]
    return key.numel() * max(math.log2(e), 1.0)


def time_sort_site(site: str, key, vs, kw) -> dict:
    """sort_rows at one call site: one wrapper call (CUDA events), its
    kernels alone (profiler), the library call and the byte bound."""
    def srt():
        return sort_cuda.sort_rows(key, *vs, **kw)
    row = {"site": site, "shape": list(key.shape), "ms": cuda_ms(srt),
           "device_ms": device_ms(srt, SORT_KERNELS),
           "library_ms": cuda_ms(lambda: sort_library(key, vs, kw)),
           "bound_ms": bound(sort_bytes(key, vs), sort_ops(key))[0]}
    print("TIMING sort_rows " + json.dumps(row), flush=True)
    return row


def time_match(name, stride, vals, pos_bits) -> dict:
    """match_deltas on one container at one stride: one wrapper call (CUDA
    events), its kernels alone (profiler; also its tile sort and its
    look-back apart), and the byte bound (entries read once, deltas
    written once)."""
    def md():
        return sort_cuda.match_deltas(vals, stride, pos_bits)
    b = bound(8 * vals.numel(), MATCH_OPS_PER_ENTRY * vals.numel())
    row = {"corpus": name, "stride": stride, "shape": list(vals.shape),
           "ms": cuda_ms(md), "device_ms": device_ms(md, MATCH_KERNELS),
           "tile_device_ms": device_ms(md, ("match_tile",)),
           "look_device_ms": device_ms(md, ("match_look",)),
           "bound_ms": b[0], "bound_by": b[1]}
    print("TIMING match_deltas " + json.dumps(row), flush=True)
    return row


def seal_kernel_phase(corpora: dict, dev, errs: dict, timing: dict) -> dict:
    """match_deltas (stride 2 and 4) and sort_rows (every call site of the
    match scan, plus synthetic rows) against their plain versions on the
    card, on every seal corpus; ``match_deltas`` timed at both strides on
    the MATCH_TIMED containers, ``sort_rows`` per call site on the source
    container at stride 2 (the main path's stride, also the ``kernels``
    line's figure for both).  Returns each corpus's count of kept match
    records at stride 2."""
    records = {}
    md = timing["match_deltas"] = {"ms": 0.0, "plain_ms": 0.0,
                                   "library_ms": None}
    sr = timing["sort_rows"] = {"ms": 0.0, "plain_ms": 0.0,
                                "library_ms": 0.0, "sites": []}
    for name, a in corpora.items():
        block = torch.from_numpy(a.copy()).to(dev)
        pw, p_ms = timed(lambda: gear.be_words(block))
        e = max_err(cdc_cuda.be_image(block), pw)
        errs["be_image"] = max(errs["be_image"], e)
        check(e == 0, f"seal {name}: be_image kernel != plain (max err {e})")
        del pw
        if name == IMAGE_TIMED:
            row = time_image(name, block)
            timing["be_image"] = {"ms": row["ms"], "plain_ms": p_ms,
                                  "library_ms": row["library_ms"],
                                  "bound": (row["bound_ms"],
                                            row["bound_by"])}
        for stride in (2, 4):
            vals, pos_bits = lz4_device.entries(block, stride)
            k = sort_cuda.match_deltas(vals, stride, pos_bits)
            p, p_ms = timed(lambda: sort_cuda.match_deltas_plain(
                vals, stride, pos_bits))
            e = max_err(k, p)
            errs["match_deltas"] = max(errs["match_deltas"], e)
            check(e == 0, f"seal {name} stride {stride}: match_deltas "
                          f"kernel != plain (max err {e})")
            timed_here = name == "source" and stride == 2
            if name in MATCH_TIMED:
                row = time_match(name, stride, vals, pos_bits)
                if timed_here:
                    md["ms"] = row["ms"]
                    md["plain_ms"] = p_ms
                    md["bound"] = (row["bound_ms"], row["bound_by"])
            del vals, k, p
            shapes = lz4_device.DeviceLz4(stride=stride,
                                          device=dev)._shapes(block.numel())
            calls, kept = captured_sorts(block, stride, shapes)
            if stride == 2:
                records[name] = kept
            if timed_here:
                calls += synthetic_sorts(np.random.default_rng(5), dev)
            nbytes = ops = 0.0
            for i, (key, vs, kw) in enumerate(calls):
                got = sort_cuda.sort_rows(key, *vs, **kw)
                want, w_ms = timed(lambda: sort_cuda.sort_rows_plain(
                    key, *vs, **kw))
                e = sort_err(got, want)
                errs["sort_rows"] = max(errs["sort_rows"], e)
                check(e == 0, f"seal {name} stride {stride}: sort_rows call "
                              f"{i} {tuple(key.shape)} kernel != plain "
                              f"(max err {e})")
                if timed_here and i < len(SORT_SITES):   # the scan's sites
                    site = time_sort_site(SORT_SITES[i], key, vs, kw)
                    sr["sites"].append(site)
                    sr["ms"] += site["ms"]
                    sr["plain_ms"] += w_ms
                    sr["library_ms"] += site["library_ms"]
                    nbytes += sort_bytes(key, vs)
                    ops += sort_ops(key)
            if timed_here:
                sr["bound"] = bound(nbytes, ops)
            del calls
        print(f"KERNELS seal {name}: {a.size} bytes, {records[name]} match "
              f"records, match_deltas and sort_rows identical at stride 2 "
              f"and 4", flush=True)
        del block
    torch.cuda.empty_cache()
    return records


# At 32 MiB text, rand_ascii, repeat997 and source flood the record
# slices (native fallback); zeros, random and chunks emit from a few
# device records, and sparse from tens of thousands, enough to run the
# grey-zone race against the native encoder.  The order alternates floods
# and emits, so two floods in a row never turn on the bypass and every
# container's scan runs on the card.  A batch's reply is one frame of at
# most 64 MiB (rpc.MAX_FRAME, the reference's wire limit), so a group
# holds at most one incompressible container.
SEAL_SINGLES = ("text", "zeros", "rand_ascii", "random", "repeat997",
                "chunks", "source", "sparse")
SEAL_BATCHES = (("text", "random", "source", "zeros"),
                ("repeat997", "zeros", "text", "sparse"))
SEAL_PROFILED = ("sparse", "source")
RACE_MIN_RECORDS = (SEAL_BYTES // 2) >> 10    # DeviceLz4's grey-zone floor
TWIN_THREADS = 4     # the CPU seal twin's threads, beside MESH and SCHEME
SEAL_KERNEL_NAMES = {"match_tile_kernel": "match_deltas",
                     "match_look_kernel": "match_deltas",
                     "sort_tile_kernel": "sort_rows",
                     "sort_merge_kernel": "sort_rows",
                     "be_image_kernel": "be_image"}
BRANCHES = ("bypassed_scans", "native_fallbacks", "native_wins",
            "races_skipped", "emits", "escape_rescans")


def _branch(c0: dict, c1: dict) -> dict:
    return {k: c1.get(k, 0) - c0.get(k, 0) for k in BRANCHES
            if c1.get(k, 0) != c0.get(k, 0)}


def child_pool(card: bool = False):
    """Spawned processes for work that needs none of this process's
    state: a phase on its own cluster, or a CPU oracle, beside the card
    work here.  The tasks run one at a time, each in a process of its
    own (its counters its own), on ``cuda:0`` when ``card``.  Leaving
    the ``with`` block waits for them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        max_tasks_per_child=1,
        initializer=torch.cuda.set_device if card else None,
        initargs=(0,) if card else ())


def seal_twin(corpora: dict, reqs: list, outs: list,
              prof_outs: list) -> list:
    """A CPU DeviceLz4 fed the card's sequence of seals (its slice hints,
    flood streak and bypass carry from request to request): the requests
    whose reply differs from the CPU engine's stream.  Runs in a
    ``child_pool`` process, with ``TWIN_THREADS`` threads, while the card
    runs the next phases."""
    torch.set_num_threads(TWIN_THREADS)
    twin = lz4_device.DeviceLz4(device="cpu")
    bad = []
    for i, (names, got) in enumerate(zip(reqs, outs)):
        datas = [corpora[k] for k in names]
        want = (twin.compress_many(datas) if len(names) > 1
                else [twin.compress(datas[0])])
        bad += [f"seal request {i} ({k})"
                for k, g, w in zip(names, got, want) if g != w]
    bad += [f"profiled seal ({k})" for k, g in zip(SEAL_PROFILED, prof_outs)
            if g != twin.compress(corpora[k])]
    return bad


def seal_main_path(corpora: dict, records: dict, pool) -> dict:
    """The port's worker on the card seals 8 single containers
    (``compress``) and 2 groups of 4 (``compress_batch``), driven by the
    port's WorkerClient.  Every reply decodes to its payload, and the
    single ``sparse`` seal must emit from its device records and run the
    grey-zone race.  The replies' check against a CPU DeviceLz4 fed the
    same sequence (``seal_twin``) runs in ``pool``: its future is the
    result's ``twin``."""
    worker = ReductionWorker("127.0.0.1", 0, backend="cuda").start()
    client = WorkerClient(worker.addr)
    reg = metrics.registry("lz4_device")
    serial = {k: len(native.lz4_compress(a)) for k, a in corpora.items()}
    reqs = [[k] for k in SEAL_SINGLES] + [list(b) for b in SEAL_BATCHES]
    rows, outs = [], []
    try:
        sort_cuda.match_deltas_launches = sort_cuda.sort_rows_launches = 0
        cdc_cuda.image_launches = 0
        for names in reqs:
            datas = [corpora[k] for k in names]
            c0 = dict(reg.snapshot()["counters"])
            t0 = time.perf_counter()
            if len(names) == 1:
                got = [client.compress("lz4", datas[0].tobytes())]
            else:
                got = client.compress_batch("lz4",
                                            [d.tobytes() for d in datas])
            lat = time.perf_counter() - t0
            rows.append((names, lat, [len(g) for g in got],
                         _branch(c0, dict(reg.snapshot()["counters"]))))
            outs.append(got)
        launches = {"match_deltas": sort_cuda.match_deltas_launches,
                    "sort_rows": sort_cuda.sort_rows_launches,
                    "be_image": cdc_cuda.image_launches}
        stats = client.stats()
        prof_outs = []
        prof = profile_window(
            "seal", lambda: prof_outs.extend(
                client.compress("lz4", corpora[k].tobytes())
                for k in SEAL_PROFILED),
            len(SEAL_PROFILED), SEAL_KERNEL_NAMES)
    finally:
        client.close()
        worker.stop()
    for kname, cnt in launches.items():
        check(cnt > 0, f"seal main path never launched the {kname} kernel")
    twin = pool.submit(seal_twin, corpora, reqs, outs, prof_outs)
    for i, (names, got) in enumerate(zip(reqs, outs)):
        datas = [corpora[k] for k in names]
        for k, d, g in zip(names, datas, got):
            check(native.lz4_decompress(g, d.size) == d.tobytes(),
                  f"seal request {i} ({k}): reply does not decode")
        names, lat, sizes, branch = rows[i]
        mib = sum(d.size for d in datas) / MIB
        ratio = [sz / serial[k] for k, sz in zip(names, sizes)]
        print(f"SEAL {i}: {'+'.join(names)} {mib:.0f} MiB "
              f"latency_ms={lat * 1e3:.3f} MiB/s={mib / lat:.1f} "
              f"compressed={sizes} vs_serial={[round(r, 6) for r in ratio]} "
              f"records={[records[k] for k in names]} "
              f"branch={json.dumps(branch)}", flush=True)
        if names == ["sparse"]:
            check(records["sparse"] > RACE_MIN_RECORDS
                  and branch.get("emits") == 1
                  and "native_fallbacks" not in branch,
                  f"sparse seal did not emit from {records['sparse']} device "
                  f"records in the race zone (branch {branch})")
    out = {"requests": [
        {"payloads": r[0], "latency_ms": r[1] * 1e3,
         "mib_per_s": sum(corpora[k].size for k in r[0]) / MIB / r[1],
         "compressed": r[2],
         "vs_serial": [sz / serial[k] for k, sz in zip(r[0], r[2])],
         "records": [records[k] for k in r[0]],
         "branch": r[3]} for r in rows],
        "launches": launches, "profile": prof, "worker_stats": stats}
    print("SEAL_PATH " + json.dumps(out), flush=True)
    out["twin"] = twin
    return out


# ------------------------------------------------------------------- mesh

MESH_SHAPES = ((1, 4), (2, 2))
MESH_SEQS = (1, 4, 8)
MESH_SMALL = 40_000      # shards under one gather window: all-gather SHA
MESH_SEAL = ("sparse", "random", "chunks", "zeros")
MESH_KERNEL_NAMES = {"cdc_shard_scan_kernel": "shard_scan",
                     "be_image_kernel": "be_image",
                     "cdc_scan_kernel": "cdc_scan",
                     "gather_pad_kernel": "gather_pad",
                     "sha256_kernel": "sha256"}


def native_bits(a: np.ndarray, mask: int) -> np.ndarray:
    """bool[n]: bit i set when pos1 = i + 1 is a native candidate."""
    bits = np.zeros(a.size, dtype=bool)
    bits[native.gear_candidates(a, mask).astype(np.int64) - 1] = True
    return bits


def shard_scan_phase(name, a, mask, dev, errs, timing=None) -> None:
    """The shard-scan kernel against its plain version on every shard of
    ``a`` for each n_seq, and the shards' words against the native scan."""
    want = native_bits(a, mask)
    for n_seq in MESH_SEQS:
        chunk = 256 * n_seq
        buf = np.zeros(a.size + (-a.size) % chunk, np.uint8)
        buf[:a.size] = a
        block = torch.from_numpy(buf).to(dev)
        m = buf.size // n_seq
        words = []
        for s in range(n_seq):
            local = block[s * m:(s + 1) * m]
            halo = (block[s * m - 31:s * m] if s
                    else torch.zeros(31, dtype=torch.uint8, device=dev))
            kw, kc = cdc_cuda.shard_scan(local, halo, s * m, mask)
            (pw, pc), p_ms = timed(lambda: cdc_cuda.shard_scan_plain(
                local, halo, s * m, mask))
            e = max(max_err(kw, pw), max_err(kc, pc))
            errs["shard_scan"] = max(errs["shard_scan"], e)
            check(e == 0, f"{name} n_seq {n_seq} shard {s}: shard scan "
                          f"kernel != plain (max err {e})")
            if timing is not None and n_seq in (4, 8) and s == 1:
                row = time_shard(name, local, halo, s * m, mask, n_seq)
                if n_seq == 4:
                    timing["shard_scan"] = {
                        "ms": row["ms"], "plain_ms": p_ms,
                        "library_ms": None,
                        "bound": (row["bound_ms"], row["bound_by"])}
            words.append(kw.cpu().numpy())
            del pw, pc
        got = np.unpackbits(np.concatenate(words).view(np.uint8),
                            bitorder="little")[:a.size].astype(bool)
        check(np.array_equal(got, want), f"{name} n_seq {n_seq}: shard words "
                                         f"!= native.gear_candidates")
        del block
    print(f"MESH scan {name}: {a.size} bytes, {int(want.sum())} candidates, "
          f"shard scan identical at n_seq {MESH_SEQS}", flush=True)


def oracle(a: np.ndarray, cdc: CdcConfig):
    cuts = native.cdc_select(native.gear_candidates(a, gear_mask(cdc)),
                             a.size, cdc.min_chunk, cdc.max_chunk)
    starts = np.concatenate([[0], cuts[:-1]]).astype(np.uint64)
    return cuts, native.sha256_batch(a, starts, cuts - starts)


def mesh_reduce_phase(blocks, want, dev, cdc: CdcConfig) -> dict:
    """reduce_sharded on the 1x4 and 2x2 meshes over ``dev`` repeated and
    on the global mesh; every reply equal to ``want``."""
    meshes = {f"{d}x{s}": sharded.make_mesh(d, s, [dev] * (d * s))
              for d, s in MESH_SHAPES}
    meshes["global"] = launch.global_mesh()
    routes, real = [], (sharded._sha_chunks_halo, sharded._sha_chunks_sharded)

    def spy(route, fn):
        return lambda *a: routes.append(route) or fn(*a)
    sharded._sha_chunks_halo = spy("halo", real[0])
    sharded._sha_chunks_sharded = spy("all-gather", real[1])
    rows = []
    try:
        cdc_cuda.shard_scan_launches = cdc_cuda.scan_launches = 0
        cdc_cuda.image_launches = 0
        gather_cuda.launches = sha256_cuda.launches = 0
        for mname, mesh in meshes.items():
            for i, blk in enumerate(blocks):
                t0 = time.perf_counter()
                cuts, digs = sharded.reduce_sharded(blk, cdc, mesh)
                lat = time.perf_counter() - t0
                rows.append((mname, i, routes[-1], lat, cuts, digs))
        launches = {"shard_scan": cdc_cuda.shard_scan_launches,
                    "be_image": cdc_cuda.image_launches,
                    "gather_pad": gather_cuda.launches,
                    "sha256": sha256_cuda.launches}
        hashing_scans = cdc_cuda.scan_launches
    finally:
        sharded._sha_chunks_halo, sharded._sha_chunks_sharded = real
    out = []
    for mname, i, route, lat, cuts, digs in rows:
        wc, wd = want[i]
        check(np.array_equal(cuts, wc) and np.array_equal(digs, wd),
              f"reduce_sharded {mname} request {i}: != native oracle and "
              f"serial ResidentReducer")
        print(f"MESH reduce {mname} request {i}: {blocks[i].size} bytes, "
              f"{cuts.size} chunks, sha_route={route} "
              f"latency_ms={lat * 1e3:.3f} "
              f"MiB/s={blocks[i].size / MIB / lat:.1f}", flush=True)
        out.append({"mesh": mname, "request": i, "route": route,
                    "latency_ms": lat * 1e3})
    for kname, cnt in launches.items():
        check(cnt > 0, f"reduce_sharded never launched the {kname} kernel")
    print("MESH launches " + json.dumps({**launches,
                                         "cdc_scan": hashing_scans}),
          flush=True)
    check(hashing_scans == 0, f"reduce_sharded ran the hashing block scan "
                              f"{hashing_scans} times (its image is words "
                              f"only)")
    check({"halo", "all-gather"} <= set(routes), f"SHA routes {set(routes)}")
    again = []
    prof = profile_window(
        "mesh", lambda: again.extend(sharded.reduce_sharded(
            b, cdc, meshes["1x4"]) for b in blocks[:2]),
        2, MESH_KERNEL_NAMES)
    for (c, d), (wc, wd) in zip(again, want):
        check(np.array_equal(c, wc) and np.array_equal(d, wd),
              "profiled reduce_sharded request != native oracle")
    return {"requests": out, "launches": launches, "profile": prof}


def mesh_plane_phase(blocks, want, dev, cdc: CdcConfig) -> dict:
    """MeshReducer (n_data 2 over ``dev`` repeated) against the serial
    results, then a second pass of the first group after note_new."""
    r = sharded.MeshReducer(cdc, sharded.make_mesh(2, 1, [dev, dev]))
    g = r.max_group()
    steps = []
    res = []
    for at in range(0, len(blocks), g):
        t0 = time.perf_counter()
        res.extend(r.finish_many(r.submit_many(blocks[at:at + g])))
        steps.append((time.perf_counter() - t0) * 1e3)
    for i, ((c, d, probe), (wc, wd)) in enumerate(zip(res, want)):
        check(np.array_equal(c, wc) and np.array_equal(d, wd),
              f"MeshReducer block {i} != serial ResidentReducer")
        check(probe == frozenset(), f"MeshReducer block {i}: hits on an "
                                    f"empty table")
    first = blocks[:g]
    r.table.note_new([row.tobytes() for _, d, _ in res[:g] for row in d])
    t0 = time.perf_counter()
    again = r.reduce_many(first)
    steps.append((time.perf_counter() - t0) * 1e3)
    hits = 0
    for i, (c, d, probe) in enumerate(again):
        hm = r.table.host_probe(d)
        check(probe == frozenset(d[j].tobytes() for j in np.nonzero(hm)[0]),
              f"MeshReducer block {i}: device probe != host_probe")
        hits += len(probe)
    check(hits > 0, "MeshReducer second pass voted no hits")
    out = {"steps_ms": steps, "group": g, "second_pass_hits": hits}
    print("MESH plane " + json.dumps(out), flush=True)
    return out


def mesh_lz4_phase(corpora: dict, dev) -> dict:
    datas = [corpora[k] for k in MESH_SEAL]
    mesh = sharded.make_mesh(2, 1, [dev, dev])
    t0 = time.perf_counter()
    got = sharded.lz4_compress_many_sharded(lz4_device.DeviceLz4(device=dev),
                                            datas, mesh)
    lat = time.perf_counter() - t0
    want = lz4_device.DeviceLz4(device=dev).compress_many(datas)
    for k, d, g, w in zip(MESH_SEAL, datas, got, want):
        check(g == w, f"sharded LZ4 ({k}) != DeviceLz4.compress_many")
        check(native.lz4_decompress(g, d.size) == d.tobytes(),
              f"sharded LZ4 ({k}) does not decode")
    out = {"payloads": list(MESH_SEAL), "latency_ms": lat * 1e3,
           "compressed": [len(g) for g in got]}
    print("MESH lz4 " + json.dumps(out), flush=True)
    return out


def mesh_phase(args, dev, cdc: CdcConfig, corpora: dict, errs: dict,
               timing: dict) -> dict:
    t0 = time.perf_counter()
    for name, a, mask, _, _ in standard_corpora():
        shard_scan_phase(name, a, mask, dev, errs)
    mask = gear_mask(cdc)
    rng = np.random.default_rng(args.seed + 1)   # phase 3's random block
    big = rng.integers(0, 256, args.block_mib * MIB, dtype=np.uint8)
    shard_scan_phase("random-block", big, mask, dev, errs, timing)
    del big
    shard_scan_phase("zeros-block", np.zeros(args.block_mib * MIB, np.uint8),
                     mask, dev, errs)
    torch.cuda.empty_cache()
    print_timing({"shard_scan": timing["shard_scan"]})
    blocks = main_path_corpus(args.seed, args.requests, args.block_mib)
    blocks.append(np.random.default_rng(args.seed + 3).integers(
        0, 256, MESH_SMALL, dtype=np.uint8))
    want = [oracle(b, cdc) for b in blocks]
    serial = ResidentReducer(cdc, device=dev).reduce_many(blocks)
    for i, ((sc, sd), (wc, wd)) in enumerate(zip(serial, want)):
        check(np.array_equal(sc, wc) and np.array_equal(sd, wd),
              f"serial ResidentReducer block {i} != native oracle")
    reduce = mesh_reduce_phase(blocks, want, dev, cdc)
    torch.cuda.empty_cache()
    plane = mesh_plane_phase(blocks, want, dev, cdc)
    torch.cuda.empty_cache()
    lz4 = mesh_lz4_phase(corpora, dev)
    out = {"seconds": time.perf_counter() - t0, "reduce": reduce,
           "plane": plane, "lz4": lz4}
    print(f"MESH done in {out['seconds']:.1f}s", flush=True)
    return out


# ----------------------------------------------------------------- scheme

SCHEME_BUCKETS = tuple(16 << i for i in range(8))     # 16 .. 2048
# the scheme's and the EC tier's blocks, the last of them text: more
# only repeat the same path (the smoke's time budget, PERF.md section 5)
SCHEME_BLOCKS = 4
SCHEME_KERNEL_NAMES = {**REDUCE_KERNEL_NAMES, **SEAL_KERNEL_NAMES,
                       "gather_raw_kernel": "gather_raw"}
SCHEME_WRITE_KERNELS = ("cdc_scan", "cdc_select", "gather_pad", "sha256",
                        "match_deltas", "sort_rows", "be_image")
SCHEME_READ_KERNELS = ("gather_raw", "be_image")
RAW_KERNELS = ("gather_raw_kernel",)


def _scheme_launch_counts() -> dict:
    return kernel_launches()


def _zero_launch_counts() -> None:
    cdc_cuda.scan_launches = cdc_cuda.select_launches = 0
    cdc_cuda.image_launches = gather_cuda.launches = 0
    sha256_cuda.launches = gather_cuda.raw_launches = 0
    sort_cuda.match_deltas_launches = sort_cuda.sort_rows_launches = 0


def library_raw(words: torch.Tensor, ol: torch.Tensor,
                bucket: int) -> torch.Tensor:
    """The raw lane gather as PyTorch calls — advanced indexing of the
    words by ``q[:, None] + arange(W + 1)`` and the funnel shift — the
    yardstick of ``gather_raw`` (the port never calls it)."""
    W = bucket * 16
    q = (ol[0] >> 2).to(torch.int64)
    s = ((ol[0] & 3) * 8)[:, None]
    lanes = words[q[:, None] + torch.arange(W + 1, device=words.device)]
    a, b = lanes[:, :W], lanes[:, 1:]
    low = (b >> (32 - s).clamp(max=31)) & ((1 << s) - 1)
    return torch.where(s == 0, a, (a << s) | low)


def raw_kernel_phase(dev, errs: dict) -> None:
    """The raw gather kernel against its plain version on every lane, at
    every bucket from 16 to 2048, in both orders (words and bytes), on a
    random and a zeros image the size of a staged 32 MiB container
    (payload + the reconstructor's headroom, on its 512-byte grid): all
    four byte alignments, random offsets and a lane whose window ends at
    the image's edge.  Tolerance zero."""
    nw = (SEAL_BYTES + (1 << 20) + 4096) // 4
    rng = np.random.default_rng(11)
    images = {"random": torch.from_numpy(rng.integers(
                  -(1 << 31), 1 << 31, nw, dtype=np.int64).astype(np.int32))
                  .to(dev),
              "zeros": torch.zeros(nw, dtype=torch.int32, device=dev)}
    for fill, words in images.items():
        for bucket in SCHEME_BUCKETS:
            W = bucket * 16
            hi = (nw - W - 1) * 4
            offs = np.concatenate([rng.integers(0, hi, 1019),
                                   [0, 1, 2, 3, hi - 1, hi - 2, hi - 3, hi,
                                    hi + 3]])
            ol = torch.from_numpy(np.stack([
                offs, rng.integers(1, W * 4 - 4, offs.size)]).astype(
                    np.int32)).to(dev)
            for order in ("words", "bytes"):
                e = max_err(
                    gather_cuda.gather_lanes_raw(words, ol, bucket, order),
                    gather_cuda.gather_lanes_raw_plain(words, ol, bucket,
                                                       order))
                errs["gather_raw"] = max(errs["gather_raw"], e)
                check(e == 0, f"gather_raw {fill} bucket {bucket} {order}: "
                              f"kernel != plain (max err {e})")
    print(f"KERNELS gather_raw: buckets {SCHEME_BUCKETS[0]}-"
          f"{SCHEME_BUCKETS[-1]}, random and zeros images, 1,028 lanes "
          f"each, words and bytes, identical", flush=True)


def scheme_context(root: str, payloads: dict):
    """The DataNode's wiring of ``dedup_lz4`` (hdrf_tpu/server/
    datanode.py:139-262) on the port, at ReductionConfig() defaults:
    32 MiB lz4 containers sealed by the device LZ4, the chunk index with
    its group-commit window, a DeviceReconstructor (its invalidation on
    container delete), the read plane with its admission controller.
    ``payloads`` collects each sealed container's payload digest (the
    store's roll hook)."""
    from hdrf_tpu_torch.config import ReductionConfig
    from hdrf_tpu_torch.index.chunk_index import ChunkIndex
    from hdrf_tpu_torch.ops.reconstruct import DeviceReconstructor
    from hdrf_tpu_torch.reduction.scheme import ReductionContext
    from hdrf_tpu_torch.server.read_plane import ReadPlane
    from hdrf_tpu_torch.storage.container_store import ContainerStore
    from hdrf_tpu_torch.utils import qos

    red = ReductionConfig()
    backend = ops_dispatch.resolve_backend(red.backend)
    containers = ContainerStore(
        os.path.join(root, "containers"),
        container_size=red.container_size, codec=red.container_codec,
        compress_fn=lambda d: ops_dispatch.block_compress("lz4", d, backend),
        compress_batch_fn=lambda ds: ops_dispatch.block_compress_batch(
            "lz4", ds, backend),
        fsync=red.fsync_containers,
        on_roll=lambda cid, p: payloads.__setitem__(
            cid, (len(p), hashlib.sha256(p).digest())))
    index = ChunkIndex(os.path.join(root, "index"),
                       group_window_s=(red.group_commit_window_ms / 1000.0
                                       if red.pipeline_depth > 1 else 0.0),
                       group_max=red.pipeline_max_inflight)
    recon = DeviceReconstructor()
    containers._on_delete = recon.invalidate
    ctrl = qos.AdmissionController(rate_mb_s=red.qos_tenant_rate_mb_s,
                                   burst_mb=red.qos_tenant_burst_mb,
                                   shed_p95_mult=red.shed_p95_mult)
    rp = ReadPlane(containers, chunk_cache_mb=red.chunk_cache_mb,
                   window_ms=red.read_batch_window_ms,
                   max_inflight=red.read_max_inflight, backend=backend,
                   qos_ctrl=ctrl)
    rp.attach_store(containers)
    return ReductionContext(config=red, containers=containers, index=index,
                            backend=backend, recon=recon, read_plane=rp)


def _check_sealed(ctx, payloads: dict) -> dict:
    """Every sealed container file decodes (``native.lz4_decompress``
    for an lz4 frame) to the payload its roll saw."""
    from hdrf_tpu_torch.storage import container_store as cs
    from hdrf_tpu_torch.utils import codec as codecs

    kinds: dict = {}
    for cid in ctx.containers.container_ids():
        blob = ctx.containers.sealed_file_bytes(cid)
        if blob is None:
            continue
        magic, usize, cid_codec = cs._SEAL_HDR.unpack(blob[:cs._SEAL_HDR.size])
        body = blob[cs._SEAL_HDR.size:]
        codec = codecs.CODEC_NAMES[cid_codec]
        data = native.lz4_decompress(body, usize) if codec == "lz4" else body
        check(magic == cs._SEAL_MAGIC and cid in payloads
              and (len(data), hashlib.sha256(data).digest()) == payloads[cid],
              f"sealed container {cid} ({codec}) != its payload")
        kinds[codec] = kinds.get(codec, 0) + 1
    return kinds


def _phase_ms(t0: float, t1: float, n: int) -> dict:
    """Host ms per block of each phase the scheme's layers recorded
    (utils/profiler: ``dedup_lookup``, ``container_io`` (the seals on
    roll included), ``wal_commit``, ``index_lookup``, ``container_decode``
    (the reconstructor's staging, gather and copy-out), ``cache_probe``,
    ``decode_wait``) in [t0, t1], exclusive, as the overlap accountant
    partitions them."""
    prof = profiler.window_profile(t0, t1)
    return {k: v * 1e3 / n for k, v in prof["phases"].items()}


def scheme_write(ctx, blocks: list, want: list) -> dict:
    s = ops_scheme.get("dedup_lz4")
    datas = [b.tobytes() for b in blocks]
    _zero_launch_counts()
    lat = []
    t_start = profiler.mark()
    for bid, d in enumerate(datas):
        t0 = time.perf_counter()
        check(s.reduce(bid, d, ctx) == b"", f"block {bid}: stored bytes")
        lat.append(time.perf_counter() - t0)
    phases = _phase_ms(t_start, profiler.mark(), len(datas))
    t0 = time.perf_counter()
    ctx.containers.flush_open(on_seal=ctx.index.seal_container)
    flush_ms = (time.perf_counter() - t0) * 1e3
    launches = _scheme_launch_counts()
    for kname in SCHEME_WRITE_KERNELS:
        check(launches[kname] > 0,
              f"SCHEME write never launched the {kname} kernel")
    for bid, (cuts, digs) in enumerate(want):
        hashes = ctx.index.get_block(bid).hashes
        locs = ctx.index.lookup_chunks(hashes)
        lens = np.array([locs[h].length for h in hashes], np.uint64)
        check(hashes == [bytes(d) for d in digs]
              and np.array_equal(np.cumsum(lens), cuts),
              f"block {bid}: scheme cuts/digests != native oracle")
    st = ctx.index.stats()
    return {"blocks": len(datas), "block_mib": blocks[0].size / MIB,
            "ms_per_block": [x * 1e3 for x in lat],
            "mib_per_s": [b.size / MIB / x for b, x in zip(blocks, lat)],
            "flush_open_ms": flush_ms, "phase_ms_per_block": phases,
            "dedup_ratio": st["logical_bytes"] / st["unique_chunk_bytes"],
            "chunks": st["chunks"], "containers_sealed":
                st["sealed_containers"], "launches": launches}


def _recon_counts() -> dict:
    c = metrics.registry("device_recon").snapshot()["counters"]
    return {k: c.get(k, 0) for k in ("image_hits", "images_staged",
                                     "chunks_gathered")}


def scheme_read_pass(ctx, blocks: list, bids=None) -> dict:
    """Every block whole, bit-identical; ``bids`` are the blocks' ids
    (their positions in ``blocks`` by default)."""
    s = ops_scheme.get("dedup_lz4")
    c0 = _recon_counts()
    lat, phases = [], {}
    for bid, blk in zip(bids or range(len(blocks)), blocks):
        t0 = time.perf_counter()
        m0 = profiler.mark()
        got = s.reconstruct(bid, b"", blk.size, ctx)
        m1 = profiler.mark()
        lat.append(time.perf_counter() - t0)
        for k, v in _phase_ms(m0, m1, len(blocks)).items():
            phases[k] = phases.get(k, 0.0) + v
        check(got == blk.tobytes(), f"block {bid}: read != written bytes")
    c1 = _recon_counts()
    return {"ms_per_block": [x * 1e3 for x in lat],
            "mib_per_s": [b.size / MIB / x for b, x in zip(blocks, lat)],
            "phase_ms_per_block": phases,
            **{k: c1[k] - c0[k] for k in c1}}


def scheme_ranged(ctx, blocks: list, bids=None) -> dict:
    """Ranged reads at odd offsets, above DEVICE_RECON_MIN (the
    reconstructor) and below it (the read plane); each equals its
    slice.  ``bids`` as in ``scheme_read_pass``."""
    from hdrf_tpu_torch.reduction.dedup import DEVICE_RECON_MIN

    s = ops_scheme.get("dedup_lz4")
    n_dev = n_plane = 0
    for bid, blk in zip(bids or range(len(blocks)), blocks):
        for off, ln in ((12_345 + 7_777 * bid, DEVICE_RECON_MIN + 4_099),
                        (blk.size - DEVICE_RECON_MIN - 3 - bid, -1),
                        (99_999 + bid, 65_537),
                        (blk.size - 1_000 - bid, 5_000)):
            got = s.reconstruct(bid, b"", blk.size, ctx, off, ln)
            end = blk.size if ln < 0 else min(off + ln, blk.size)
            check(got == blk[off:end].tobytes(),
                  f"block {bid}: ranged read ({off}, {ln}) != slice")
            if end - off >= DEVICE_RECON_MIN:
                n_dev += 1
            else:
                n_plane += 1
    return {"device_recon_reads": n_dev, "read_plane_reads": n_plane}


def scheme_repeat(ctx, blk) -> dict:
    """A resident image serves a later request: one ranged read above
    DEVICE_RECON_MIN, then the same read again, which must stage no image
    and hit the images the first left resident."""
    from hdrf_tpu_torch.reduction.dedup import DEVICE_RECON_MIN

    s = ops_scheme.get("dedup_lz4")
    off, ln = 54_321, DEVICE_RECON_MIN + 8_191
    counts = []
    for _ in range(2):
        c0 = _recon_counts()
        got = s.reconstruct(0, b"", blk.size, ctx, off, ln)
        check(got == blk[off:off + ln].tobytes(),
              f"repeated ranged read ({off}, {ln}) != slice")
        counts.append({k: v - c0[k] for k, v in _recon_counts().items()})
    check(counts[1]["images_staged"] == 0 and counts[1]["image_hits"] > 0,
          f"SCHEME read: a repeated read restaged its images {counts}")
    return {"first": counts[0], "repeat": counts[1]}


def raw_calls(groups: dict, image_of) -> tuple[list, int, int]:
    """(calls, bytes, lanes) of the raw gathers of ``groups`` ((image
    key, bucket) -> chunk offsets) as ``DeviceReconstructor.gather``
    makes them: one call a group, padded to a multiple of 128 lanes.
    ``bytes`` is the byte bound's count: the image bytes under the union
    of the lanes' windows ``[off, off + 4(W + 1))`` read once (a lane's
    window runs into the next chunks' bytes, and the padding lanes all
    read offset 0), its W words a lane written, its offset read."""
    calls, windows, nbytes, lanes = [], {}, 0, 0
    for (key, b), offs in groups.items():
        img = image_of(key)
        L = -(-len(offs) // 128) * 128
        ol = np.zeros((2, L), np.int32)
        ol[0, :len(offs)] = offs
        calls.append((img, torch.from_numpy(ol).to(img.device), b))
        W = b * 16
        windows.setdefault(key, []).extend(
            (int(o), int(o) + 4 * (W + 1)) for o in ol[0])
        nbytes += L * W * 4 + 4 * L
        lanes += L
    read_bytes = sum(_union(w, 0, math.inf) for w in windows.values())
    return calls, nbytes + int(read_bytes), lanes


def time_raw(tag: str, calls: list, nbytes: int, lanes: int,
             **meta) -> dict:
    """``gather_raw`` over ``calls`` (one wrapper call a group) in both
    orders, each held against the plain words (tolerance zero): card ms
    (CUDA events) and device ms (profiler) of the words and of the bytes
    the read path takes (the kernels of the call, less the L2 scrub's
    fill), the plain version once, the library call (advanced indexing
    + shift) and the byte bound."""
    e = 0
    for img, ol, b in calls:
        want = gather_cuda.gather_lanes_raw_plain(img, ol, b)
        e = max(e, max_err(gather_cuda.gather_lanes_raw(img, ol, b), want),
                max_err(library_raw(img, ol, b), want))
        flipped = want.view(torch.uint8).view(want.shape[0], -1, 4).flip(-1)
        got = gather_cuda.gather_lanes_raw(img, ol, b, order="bytes")
        e = max(e, max_err(got.reshape(flipped.shape[0], -1),
                           flipped.reshape(flipped.shape[0], -1)))
        del want, flipped, got
    check(e == 0, f"TIMING gather_raw {tag}: kernel or library call != "
                  f"plain (max err {e})")

    def run(order):
        return lambda: [gather_cuda.gather_lanes_raw(i, o, b, order=order)
                        for i, o, b in calls]

    def library():
        return [library_raw(i, o, b) for i, o, b in calls]
    _, plain_ms = timed(lambda: [gather_cuda.gather_lanes_raw_plain(i, o, b)
                                 for i, o, b in calls])
    bd = bound(nbytes, 0)
    row = {"read": tag, **meta, "groups": len(calls), "lanes": lanes,
           "ms": cuda_ms(run("bytes")),
           "device_ms": device_ms(run("bytes"), ("",), exclude=FILL_KERNELS),
           "words_ms": cuda_ms(run("words")),
           "words_device_ms": device_ms(run("words"), RAW_KERNELS),
           "plain_ms": plain_ms,
           "library_ms": cuda_ms(library, reps=5, warmup=1),
           "bound_ms": bd[0], "bound_by": bd[1], "bytes": nbytes}
    print("TIMING gather_raw " + json.dumps(row), flush=True)
    return row


def read_groups(ctx, bid: int) -> dict:
    """(container, bucket) -> chunk offsets of block ``bid``'s full read,
    grouped as ``DeviceReconstructor.gather`` groups them."""
    from hdrf_tpu_torch.ops import reconstruct
    from hdrf_tpu_torch.server.read_plane import resolve_chunk_plan

    groups: dict = {}
    for cid, off, ln in resolve_chunk_plan(ctx.index, bid).wanted:
        b = reconstruct._bucket_of(-(-ln // 64) + 1)
        groups.setdefault((cid, b), []).append(off)
    return groups


def time_gather_raw(ctx, blocks: list) -> list:
    """``gather_raw`` at the shapes of two 128 MiB reads: block 0 and the
    block whose read makes the most (container, bucket) groups, every
    group of its plan, images resident (``time_raw``)."""
    groups = [read_groups(ctx, bid) for bid in range(len(blocks))]
    most = max(range(len(blocks)), key=lambda i: len(groups[i]))
    rows = []
    for bid in dict.fromkeys((0, most)):
        calls, nbytes, lanes = raw_calls(
            groups[bid], lambda cid: ctx.recon._image(
                cid, lambda c=cid: ctx.containers.read_container(c)))
        rows.append(time_raw(f"block {bid}", calls, nbytes, lanes,
                             block=bid, most_groups=bid == most,
                             bytes_read=blocks[bid].size))
        del calls
    return rows


# ------------------------------------------------------------------ EC

EC_K, EC_M = 6, 3            # the NameNode's RS(6,3) (hdrf_tpu/config.py:319)
BALANCER_BANDWIDTH = 100 * MIB   # the DataNode's background-transfer cap
RS_GEOMETRIES = ((6, 3), (10, 4), (1, 1), (24, 8))
RS_LENGTHS = (1, 3, 15, 16, 17, 4097, -(-(SEAL_BYTES + 16) // EC_K))
RS_EVERY_K_LENGTHS = (17, 4096, 65_541)     # k 1-24 x rows 1-8
RS_KERNELS = ("rs_apply_kernel",)
EC_KERNEL_NAMES = {**SCHEME_KERNEL_NAMES, "rs_apply_kernel": "rs"}
P1_SLOTS = (1, 4, 7)         # holder p1's stripes: slot i on holder i % 3
OWNER_SLOTS = (0, 3, 6)


class EcNode:
    """A stand-in DataNode carrying exactly what ``EcTier`` and
    ``CodedExchange`` read (hdrf_tpu/server/datanode.py:120-276); a peer
    call is served by the target's ``EcTier`` over a socket pair in the
    port's wire codec (proto/datatransfer ``send_op`` / ``recv_op``,
    proto/rpc ``recv_frame``)."""

    def __init__(self, dn_id: str, data_dir: str, containers, index, red,
                 cluster: dict, nns: list) -> None:
        from types import SimpleNamespace

        from hdrf_tpu_torch.server.coded_exchange import CodedExchange
        from hdrf_tpu_torch.server.ec_tier import EcTier
        from hdrf_tpu_torch.utils import qos
        from hdrf_tpu_torch.utils.throttler import Throttler

        self.dn_id, self.addr = dn_id, ("127.0.0.1", 20000 + len(cluster))
        self.config = SimpleNamespace(data_dir=data_dir)
        self.containers, self.index = containers, index
        self.reduction_ctx = SimpleNamespace(config=red)
        self.qos = qos.AdmissionController()
        self.balance_throttler = Throttler(BALANCER_BANDWIDTH)
        self._nns, self._cluster = nns, cluster
        cluster[self.addr] = self
        self.ec = EcTier(self)
        self.coded = CodedExchange(self)

    @property
    def target(self) -> list:
        return [self.dn_id, *self.addr]

    def _peer_call(self, addr, op: str, **fields) -> dict:
        import socket
        import threading

        from hdrf_tpu_torch.proto import datatransfer as dt
        from hdrf_tpu_torch.proto.rpc import recv_frame

        peer = self._cluster[tuple(addr)]
        a, b = socket.socketpair()
        t = threading.Thread(target=peer._xceive, args=(b,), daemon=True)
        t.start()
        try:
            dt.send_op(a, op, **fields)
            return recv_frame(a)
        finally:
            a.close()
            t.join()

    def _xceive(self, sock) -> None:
        from hdrf_tpu_torch.proto import datatransfer as dt
        from hdrf_tpu_torch.utils import retry

        serve = {dt.STRIPE_READ: self.ec.serve_read,
                 dt.STRIPE_WRITE: self.ec.serve_write,
                 dt.STRIPE_CODED_READ: self.ec.serve_coded_read}
        try:
            op, fields = dt.recv_op(sock)
            with retry.bind_remaining(fields.pop(retry.DEADLINE_KEY, None)):
                serve[op](sock, fields)
        except (OSError, ConnectionError):
            pass
        finally:
            sock.close()


class StandInNN:
    def __init__(self) -> None:
        self.calls: list = []

    def call(self, method: str, **kw):
        self.calls.append((method, kw))
        return {"ok": True}


def _edge_coeffs(rng, nrows: int, k: int) -> np.ndarray:
    c = rng.integers(0, 256, (nrows, k), dtype=np.uint8)
    c.flat[::3] = 0
    c.flat[1::4] = 1
    c.flat[2::5] = 0xFF
    return c


def rs_kernel_phase(dev, errs: dict, sealed: list) -> None:
    """The GF(2^8) kernel against its plain version on the card,
    tolerance zero: the encode matrices of RS(6,3), (10,4), (1,1) and
    (24,8) at every length of ``RS_LENGTHS`` (the last a 32 MiB
    container's stripe), rows aligned and at odd byte offsets; every
    shard count the kernel is instantiated for (1-24) at every row count
    1-8 and the lengths of ``RS_EVERY_K_LENGTHS``; partial sums on
    column slices with zeros, ones and 0xFF; every one of the 129
    erasure patterns of RS(6,3) through ``rs_decode`` (equal to the data
    and parity); and the parity of two sealed 32 MiB containers against
    ``encode_ref`` on the host."""
    from hdrf_tpu_torch.ops import rs, rs_cuda

    import itertools

    g = torch.Generator(device=dev).manual_seed(8)

    def held(c, k, L, what):
        flat = torch.randint(0, 256, (k * L + 16,), generator=g,
                             dtype=torch.uint8, device=dev)
        for off in ((0, 1) if L > 17 else (0, 1, 2, 3)):
            d = flat[off:off + k * L].view(k, L)
            e = max_err(rs_cuda.gf_apply(c, d), rs_cuda.gf_apply_plain(c, d))
            errs["rs"] = max(errs["rs"], e)
            check(e == 0, f"rs {what} L={L} offset {off}: kernel != plain "
                          f"(max err {e})")
    for k, m in RS_GEOMETRIES:
        for L in RS_LENGTHS:
            held(rs.rs_matrix(k, m)[k:], k, L, f"RS({k},{m})")
        torch.cuda.empty_cache()
    rng = np.random.default_rng(12)
    for k in range(1, rs_cuda.MAX_K + 1):     # every instantiation
        for nrows in range(1, rs_cuda.MAX_ROWS + 1):
            for L in RS_EVERY_K_LENGTHS:
                held(_edge_coeffs(rng, nrows, k), k, L,
                     f"k {k} rows {nrows}")
    for nwant, ncol in ((3, 2), (3, 1), (2, 4), (8, 24), (1, 6)):
        c = _edge_coeffs(rng, nwant, ncol)
        for L in (17, 4097, RS_LENGTHS[-1]):
            held(c, ncol, L, f"partial sums {nwant}x{ncol}")
        st = rng.integers(0, 256, (ncol, 4097), dtype=np.uint8)
        check(np.array_equal(rs.partial_sums(st, c, device=dev),
                             rs.partial_sums_ref(st, c)),
              f"partial_sums {nwant}x{ncol} != partial_sums_ref")
    d = rng.integers(0, 256, (EC_K, 4097), dtype=np.uint8)
    allsh = np.concatenate([d, rs.encode_ref(d, EC_M)])
    n = 0
    for r in range(1, EC_M + 1):
        for lost in itertools.combinations(range(EC_K + EC_M), r):
            have = {i: allsh[i] for i in range(EC_K + EC_M) if i not in lost}
            got = rs.rs_decode(have, EC_K, EC_M, want=list(lost), device=dev)
            check(all(np.array_equal(got[i], allsh[i]) for i in lost),
                  f"rs_decode lost {lost} != the shards")
            n += 1
    for blob in sealed:
        L = -(-len(blob) // EC_K)
        a = np.frombuffer(blob + bytes(EC_K * L - len(blob)),
                          np.uint8).reshape(EC_K, L)
        check(np.array_equal(rs.rs_encode(a, EC_K, EC_M, device=dev),
                             rs.encode_ref(a, EC_M)),
              f"rs_encode of a {len(blob)}-byte container != encode_ref")
    torch.cuda.empty_cache()
    print(f"KERNELS rs: RS{RS_GEOMETRIES} x L {RS_LENGTHS}, k 1-"
          f"{rs_cuda.MAX_K} x rows 1-{rs_cuda.MAX_ROWS} x L "
          f"{RS_EVERY_K_LENGTHS}, partial sums, "
          f"{n} erasure patterns, {len(sealed)} sealed containers vs "
          f"encode_ref, identical", flush=True)


def time_rs(name: str, c: np.ndarray, L: int, dev,
            launches: int | None = None, offset: int = 0) -> dict:
    """One RS call at the main path's shapes, rows staged as ops/rs.py
    stages them (16-byte aligned row stride; ``offset`` bytes later when
    given, every row then as far from 16-byte alignment): card ms (CUDA
    events), device ms (profiler), the plain version once, the library
    call (the reference's bit-plane product through torch.matmul in
    f32), the bound, and ``launches``, the main path's launches of this
    kind of call."""
    from hdrf_tpu_torch.ops import rs, rs_cuda

    nrows, k = c.shape
    g = torch.Generator(device=dev).manual_seed(L + k)
    lp = -(-L // 16) * 16
    buf = torch.randint(0, 256, (k * lp + 16,), generator=g,
                        dtype=torch.uint8, device=dev)
    d = buf[offset:offset + k * lp].view(k, lp)[:, :L]
    bm = torch.from_numpy(rs._bit_matrix(c)).to(dev)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmul is on: the library call would not be full f32")

    def kernel():
        return rs_cuda.gf_apply(c, d)

    def library():
        return rs_cuda.bit_matmul_plain(bm, d, nrows)
    want, plain_ms = timed(lambda: rs_cuda.gf_apply_plain(c, d))
    check(max_err(kernel(), want) == 0 and max_err(library(), want) == 0,
          f"TIMING rs {name}: kernel or library call != plain")
    del want
    # bytes: k*L read, nrows*L written; operations: the bit matrix applied
    # bit-sliced, one 32-bit XOR per set entry per 32 positions
    bd = bound((k + nrows) * L, float(rs._bit_matrix(c).sum()) * -(-L // 32))
    row = {"call": name, "k": k, "nrows": nrows, "L": L, "offset": offset,
           "ms": cuda_ms(kernel), "device_ms": device_ms(kernel, RS_KERNELS),
           "plain_ms": plain_ms,
           "library_ms": cuda_ms(library, reps=5, warmup=1),
           "bound_ms": bd[0], "bound_by": bd[1],
           "bytes": (k + nrows) * L, "launches": launches}
    print("TIMING rs " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    return row


def _drop_caches(ctx) -> None:
    """Forget every decoded payload: the reconstructor's images, the
    store's LRU and the read plane's chunk cache."""
    cids = set(ctx.containers.container_ids())
    for cid in cids | set(ctx.index.stripe_manifests()):
        ctx.recon.invalidate(cid)
        ctx.read_plane.cache.invalidate_container(cid)
    with ctx.containers._cache_lock:
        ctx.containers._cache.clear()


def _ec_counts() -> dict:
    c = metrics.registry("ec").snapshot()["counters"]
    keys = ("containers_demoted", "degraded_reads", "stripes_decoded",
            "coded_repairs", "stripes_repaired", "stripe_gathers",
            "ec_hedges_fired", "ec_hedge_fallbacks", "breaker_skips",
            "repair_wire_bytes", "repair_rebuilt_bytes",
            "stripe_push_raw_bytes", "stripe_push_wire_bytes")
    return {k: c.get(k, 0) for k in keys}


def _ec_delta(c0: dict) -> dict:
    return {k: v - c0[k] for k, v in _ec_counts().items()}


def _lose(owner, holder, slots) -> dict:
    """Unlink ``holder``'s stripe files of ``slots`` of every striped
    container; returns their bytes."""
    lost = {}
    for cid in owner.index.stripe_manifests():
        for s in slots:
            p = holder.ec.store._path(owner.dn_id, cid, s)
            with open(p, "rb") as f:
                lost[(cid, s)] = f.read()
            os.unlink(p)
    return lost


def _repair(owner, holder, lost: dict) -> dict:
    """Repair every lost stripe onto ``holder``; each rebuilt file must
    equal the original and its CRC the manifest's."""
    from hdrf_tpu_torch.utils import profiler as prof

    c0 = _ec_counts()
    t0 = time.perf_counter()
    m0 = prof.mark()
    for cid in sorted({c for c, _ in lost}):
        slots = sorted(s for c, s in lost if c == cid)
        owner.ec.repair({"cid": cid, "missing": slots,
                         "targets": [holder.target] * len(slots),
                         "block_id": None})
    secs = time.perf_counter() - t0
    phases = _phase_ms(m0, prof.mark(), len(lost))
    for (cid, s), data in lost.items():
        p = holder.ec.store._path(owner.dn_id, cid, s)
        with open(p, "rb") as f:
            got = f.read()
        check(got == data and native.crc32c(got)
              == owner.index.stripe_manifest(cid)["crcs"][s],
              f"repaired stripe {cid}/{s} != the original")
    return {"stripes": len(lost), "seconds": secs,
            "mib_per_s": sum(map(len, lost.values())) / MIB / secs,
            "phase_ms_per_stripe": phases, "ec": _ec_delta(c0)}


def _degraded_reads(ctx, blocks: list, tag: str) -> dict:
    """Block 0 (random) and the last block (text, the only one whose
    containers seal as lz4 frames) read whole and ranged with the caches
    dropped; the sealed files the stripes rebuilt, by codec, must hold
    an lz4 one."""
    from hdrf_tpu_torch.storage import container_store as cs
    from hdrf_tpu_torch.utils import codec as codecs

    store = ctx.containers
    fallback, rebuilt = store._stripe_fallback, {}

    def counted(cid):
        blob = fallback(cid)
        if blob is not None:
            name = codecs.CODEC_NAMES[cs._SEAL_HDR.unpack(
                blob[:cs._SEAL_HDR.size])[2]]
            rebuilt[name] = rebuilt.get(name, 0) + 1
        return blob

    bids = [0, len(blocks) - 1]
    picked = [blocks[b] for b in bids]
    c0 = _ec_counts()
    _drop_caches(ctx)
    store._stripe_fallback = counted
    try:
        first = scheme_read_pass(ctx, picked, bids)
        ranged = scheme_ranged(ctx, picked, bids)
    finally:
        store._stripe_fallback = fallback
    d = _ec_delta(c0)
    check(d["degraded_reads"] > 0, f"EC read {tag}: no degraded read")
    check(rebuilt.get("lz4", 0) > 0,
          f"EC read {tag}: no lz4 container rebuilt from stripes "
          f"({rebuilt})")
    return {"blocks": bids, "pass": first, **ranged,
            "rebuilt_by_codec": rebuilt, "ec": d}


def ec_phase(ctx, root: str, blocks: list, extra, errs: dict,
             timing: dict) -> dict:
    """EC: the cold tier of the DataNode (hdrf_tpu/server/datanode.py:269,
    276) over SCHEME's store and index, at RS(6,3) with ReductionConfig()
    defaults (hedge delta 1, coded repair, exchange compression): demote
    every block, degraded reads after losing holder p1 whole and then the
    owner's stripes, coded and classic repair, the index reopened."""
    from hdrf_tpu_torch.index.chunk_index import ChunkIndex
    from hdrf_tpu_torch.ops import rs, rs_cuda
    from hdrf_tpu_torch.reduction import accounting
    from hdrf_tpu_torch.storage.container_store import ContainerStore
    from hdrf_tpu_torch.utils import retry

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    ctx.containers.flush_open(on_seal=ctx.index.seal_container)
    s = ops_scheme.get("dedup_lz4")
    cids = ctx.containers.container_ids()
    sealed = [b for b in (ctx.containers.sealed_file_bytes(c)
                          for c in cids[:2]) if b is not None]
    rs_kernel_phase(dev, errs, sealed)
    red = ctx.config
    nn = StandInNN()
    cluster: dict = {}
    owner = EcNode("dn-owner", os.path.join(root, "owner"), ctx.containers,
                   ctx.index, red, cluster, [nn])
    peers = [EcNode(f"dn-p{i}", os.path.join(root, f"peer{i}"),
                    ContainerStore(os.path.join(root, f"peer{i}", "c")),
                    ChunkIndex(os.path.join(root, f"peer{i}", "i")), red,
                    cluster, [nn]) for i in (1, 2)]
    holders = [owner, *peers]
    targets = [holders[i % 3].target for i in range(EC_K + EC_M)]
    extra_bid = 100        # SCHEME's profiled block, in containers of its own
    try:
        # (b) demote
        _zero_launch_counts()
        rs_cuda.launches = 0
        c0 = _ec_counts()
        t1 = time.perf_counter()
        m0 = profiler.mark()
        for bid in range(len(blocks)):
            owner.ec.demote({"block_id": bid, "k": EC_K, "m": EC_M,
                             "targets": targets})
        demote_s = time.perf_counter() - t1
        demote_phases = _phase_ms(m0, profiler.mark(), len(blocks))
        pw = profile_window("ec_demote", lambda: owner.ec.demote(
            {"block_id": extra_bid, "k": EC_K, "m": EC_M,
             "targets": targets}), 1, EC_KERNEL_NAMES)
        man = ctx.index.stripe_manifests()
        check(sorted(man) == cids and not ctx.containers.container_ids()
              and all(ctx.containers.sealed_file_bytes(c) is None
                      for c in cids),
              f"EC demote: striped {sorted(man)} != sealed {cids}")
        logical = sum(int(m["length"]) for m in man.values())
        physical = sum(h.ec.store.physical_bytes() for h in holders)
        pad = sum((EC_K + EC_M) * int(m["stripe_len"]) - 1.5 * int(m["length"])
                  for m in man.values())
        ratio = accounting.stripe_ratio(logical, physical)
        check(abs(physical - 1.5 * logical - pad) < 1
              and 0 <= pad < (EC_K + EC_M) * len(man),
              f"EC demote: physical/logical {ratio} != 1.5 up to padding")
        check(owner.ec.report()["striped_containers"] == len(man)
              and sum(len(kw["containers"]) for _, kw in nn.calls)
              == len(man), "EC demote: reports != the striped containers")
        demote = {"containers": len(man), "seconds": demote_s,
                  "logical_bytes": logical, "physical_bytes": physical,
                  "ratio": ratio, "phase_ms_per_block": demote_phases,
                  "ec": _ec_delta(c0),
                  "rs_launches": rs_cuda.launches}
        check(rs_cuda.launches > 0, "EC demote never launched the rs kernel")
        print("EC demote " + json.dumps(demote), flush=True)
        by_call = {"encode": rs_cuda.launches}
        # (c) degraded reads: holder p1 lost whole (data 1, 4; parity 7)
        lost1 = _lose(owner, peers[0], P1_SLOTS)
        _zero_launch_counts()
        r1 = _degraded_reads(ctx, blocks, "p1 lost")
        launches = {**_scheme_launch_counts(), "rs": rs_cuda.launches}
        for kname in ("be_image", "gather_raw"):
            check(launches[kname] > 0,
                  f"EC read never launched the {kname} kernel")
        _drop_caches(ctx)
        pr = profile_window(
            "ec_read", lambda: check(
                s.reconstruct(extra_bid, b"", extra.size, ctx)
                == extra.tobytes(), "profiled degraded read != written"),
            1, EC_KERNEL_NAMES)
        print("EC read p1_lost " + json.dumps({**r1, "launches": launches}),
              flush=True)
        by_call["decode"] = rs_cuda.launches - by_call["encode"]
        # (d) repair: the coded exchange, then the owner's stripes lost
        # and read, and the classic full gather
        rep1 = _repair(owner, peers[0], lost1)
        check(rep1["ec"]["coded_repairs"] > 0, "EC repair: no coded repair")
        print("EC repair coded " + json.dumps(rep1), flush=True)
        by_call["partial_sums"] = rs_cuda.launches - sum(by_call.values())
        retry.reset_breakers()   # holder p1 is back
        lost2 = _lose(owner, owner, OWNER_SLOTS)
        r2 = _degraded_reads(ctx, blocks, "owner lost")
        print("EC read owner_lost " + json.dumps(r2), flush=True)
        red.ec_coded_repair = False
        try:
            rep2 = _repair(owner, owner, lost2)
        finally:
            red.ec_coded_repair = True
        check(rep2["ec"]["coded_repairs"] == 0
              and rep2["ec"]["stripes_repaired"] == len(lost2),
              "EC repair classic: took the coded path")
        print("EC repair classic " + json.dumps(rep2), flush=True)
        rs_launches = rs_cuda.launches
        by_call["decode"] += rs_launches - sum(by_call.values())
        # (e) the index reopened: manifests equal
        man = ctx.index.stripe_manifests()
        ctx.index.close()
        ctx.index = owner.index = ChunkIndex(os.path.join(root, "index"))
        check(ctx.index.stripe_manifests() == man,
              "EC reopen: manifests != before")
        print(f"EC reopen: {len(man)} manifests equal", flush=True)
        # (f) timing at the main path's shapes
        L = max(int(m["stripe_len"]) for m in man.values())
        dec = rs.repair_rows(EC_K, EC_M, (3, 4, 5, 6, 7, 8), (0, 1, 2))
        rows = {"encode": time_rs("encode", rs.rs_matrix(EC_K, EC_M)[EC_K:],
                                  L, dev, by_call["encode"]),
                "decode": time_rs("decode", dec, L, dev, by_call["decode"]),
                "partial_sums": time_rs("partial_sums", rs.repair_rows(
                    EC_K, EC_M, (0, 2, 3, 5, 6, 8), (1, 4, 7))[:, [1, 4]],
                    L, dev, by_call["partial_sums"])}
        enc = rows["encode"]
        timing["rs"] = {"ms": enc["ms"], "plain_ms": enc["plain_ms"],
                        "library_ms": enc["library_ms"],
                        "bound": (enc["bound_ms"], enc["bound_by"])}
    finally:
        for p in peers:
            p.index.close()
    out = {"seconds": time.perf_counter() - t0, "demote": demote,
           "read_p1_lost": r1, "repair_coded": rep1, "read_owner_lost": r2,
           "repair_classic": rep2, "timing": rows,
           "profile": {"demote": pw, "read": pr},
           "launches": {"rs": rs_launches}}
    print(f"EC done in {out['seconds']:.1f}s", flush=True)
    return out


def scheme_phase(args, dev, cdc: CdcConfig, errs: dict,
                 timing: dict) -> dict:
    """SCHEME: the in-process dedup_lz4 scheme on the card, reached as the
    DataNode reaches it (``scheme.get("dedup_lz4").reduce`` /
    ``.reconstruct``), over the ``reduce`` corpus."""
    import tempfile

    t0 = time.perf_counter()
    raw_kernel_phase(dev, errs)
    torch.cuda.empty_cache()
    blocks = main_path_corpus(args.seed, min(args.requests, SCHEME_BLOCKS),
                              args.block_mib)
    want = [oracle(b, cdc) for b in blocks]
    payloads: dict = {}
    with tempfile.TemporaryDirectory(prefix="smoke_scheme_") as root:
        ctx = scheme_context(root, payloads)
        try:
            wr = scheme_write(ctx, blocks, want)
            wr["sealed_by_codec"] = _check_sealed(ctx, payloads)
            print("SCHEME write " + json.dumps(wr), flush=True)
            _zero_launch_counts()
            first = scheme_read_pass(ctx, blocks)
            rd_launches = _scheme_launch_counts()
            for kname in SCHEME_READ_KERNELS:
                check(rd_launches[kname] > 0,
                      f"SCHEME read never launched the {kname} kernel")
            second = scheme_read_pass(ctx, blocks[:2])
            check(second["image_hits"] > 0,
                  "SCHEME read: no image hits within a block")
            ranged = scheme_ranged(ctx, blocks)
            repeat = scheme_repeat(ctx, blocks[0])
            print("SCHEME read " + json.dumps({
                "first_pass": first, "second_pass": second, **ranged,
                "repeated_ranged_read": repeat,
                "launches": rd_launches,
                "gather_raw_launches_per_block":
                    rd_launches["gather_raw"] / len(blocks)}), flush=True)
            # restart the index: close, reopen from its directory
            from hdrf_tpu_torch.index.chunk_index import ChunkIndex

            ctx.index.close()
            ctx.index = ChunkIndex(os.path.join(root, "index"))
            model: dict = {}
            for _, digs in want:
                for d in digs:
                    model[bytes(d)] = model.get(bytes(d), 0) + 1
            locs = ctx.index.lookup_chunks(list(model))
            check(ctx.index.stats()["chunks"] == len(model)
                  and all(locs[h] is not None and locs[h].refcount == c
                          for h, c in model.items()),
                  "reopened index refcounts != the blocks written")
            again = scheme_read_pass(ctx, blocks[:2])
            scheme_ranged(ctx, blocks[:2])
            print(f"SCHEME restart: index reopened, {len(model)} chunks, "
                  f"refcounts equal the model; blocks 0-1 read back "
                  f"{again['ms_per_block']} ms", flush=True)
            raw = time_gather_raw(ctx, blocks)[0]     # block 0's read
            timing["gather_raw"] = {
                "ms": raw["ms"], "plain_ms": raw["plain_ms"],
                "library_ms": raw["library_ms"],
                "bound": (raw["bound_ms"], raw["bound_by"])}
            s = ops_scheme.get("dedup_lz4")
            extra = main_path_corpus(args.seed + 9, 2, args.block_mib)[0]
            data = extra.tobytes()
            pw = profile_window(
                "scheme_write", lambda: s.reduce(100, data, ctx), 1,
                SCHEME_KERNEL_NAMES)
            pr = profile_window(
                "scheme_read", lambda: check(
                    s.reconstruct(100, b"", extra.size, ctx) == data,
                    "profiled read != written"),
                1, SCHEME_KERNEL_NAMES)
            ec = ec_phase(ctx, root, blocks, extra, errs, timing)
        finally:
            ctx.read_plane.close()
            ctx.index.close()
    out = {"seconds": time.perf_counter() - t0, "write": wr,
           "read": {"first": first, "second": second},
           "profile": {"write": pw, "read": pr}, "ec": ec,
           "launches": {"gather_raw": rd_launches["gather_raw"],
                        **ec["launches"]}}
    print(f"SCHEME done in {out['seconds']:.1f}s", flush=True)
    return out


# -------------------------------------------------------------- datanode

DN_WRITE_KERNELS = ("cdc_scan", "cdc_select", "gather_pad", "sha256",
                    "be_image", "match_deltas", "sort_rows")
DN_PHASES = ("recv", "checksum", "pipeline_submit", "device_wait",
             "dedup_lookup", "wal_commit", "container_io", "mirror_stream",
             "ack")
# one block a stream: the reference harness's dfs --pipeline-ab --streams
# 4, cut to two to keep the smoke inside its 1,050 s target
DN_STREAMS = 2
# counters of work a DataNode lost or degraded while answering success (a
# mirror leg that failed still acks the client, as pipeline recovery does)
DN_FAULTS = {"block_receiver": ("mirror_failures", "worker_fallbacks",
                                "degraded_writes", "stale_gen_rejected"),
             "datanode": ("worker_fallbacks", "op_errors", "op_io_errors",
                          "op_auth_failures", "ibr_failures",
                          "startup_lost_container_blocks"),
             "mirror": ("coded_fallbacks", "segment_ingest_failures",
                        "assemble_failures")}


class SmokeNN:
    """Stand-in NameNode over the port's RPC frames (``[req_id, method,
    kwargs]`` -> ``[req_id, 0, result]``): registration without block
    keys, block reports, heartbeats without commands, and the IBRs,
    recorded per DataNode."""

    def __init__(self) -> None:
        import socketserver
        import threading

        from hdrf_tpu_torch.proto.rpc import recv_frame, send_frame

        self.lock = threading.Lock()
        self.ibrs: dict[str, list] = {}
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                self.request.settimeout(600)
                try:
                    while True:
                        rid, method, kw = recv_frame(self.request)
                        send_frame(self.request,
                                   [rid, 0, outer.answer(method, kw)])
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def addr(self):
        return self._server.server_address

    def answer(self, method: str, kw: dict):
        if method == "register_datanode":
            return {"heartbeat_interval_s": 1.0, "block_keys": None,
                    "nameservice_id": "ns0", "block_pool_index": 0}
        if method == "heartbeat":
            return {"commands": []}
        if method == "block_received":
            with self.lock:
                self.ibrs.setdefault(kw["dn_id"], []).append(
                    (kw["block_id"], kw["length"], bool(kw["partial"])))
        return {}

    def ibrs_of(self, dn_id: str) -> list:
        with self.lock:
            return sorted(self.ibrs.get(dn_id, []))

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def start_dn(root: str, nn, dn_id: str, **red):
    """A port DataNode on ``cuda:0`` at DataNodeConfig() /
    ReductionConfig() defaults (dedup_lz4, 32 MiB lz4 containers,
    pipeline_depth 4, a 2 ms group commit, 64 KiB packets, 4 write
    slots) unless ``red`` says otherwise."""
    from hdrf_tpu_torch.config import DataNodeConfig
    from hdrf_tpu_torch.server.datanode import DataNode

    cfg = DataNodeConfig(data_dir=os.path.join(root, dn_id))
    cfg.reduction.backend = "cuda"
    for k, v in red.items():
        setattr(cfg.reduction, k, v)
    return DataNode(cfg, nn.addr, dn_id=dn_id).start()


def dn_write(addr, bid: int, blk: np.ndarray, targets=(),
             gen_stamp: int = 1) -> float:
    """WRITE_BLOCK of ``blk`` in 64 KiB packets on a fresh connection, the
    acks read as they come (``datatransfer.stream_acked``, the reference
    client's response processor: a writer that left them unread would
    stall the stream on a full window); every packet and the LAST one
    acked, the last with status 0.  Returns ms from the first packet to
    the final ack (client clock)."""
    import socket

    from hdrf_tpu_torch.proto import datatransfer as dt

    npkt = -(-blk.size // DEFAULT_PACKET)
    s = socket.create_connection(tuple(addr), timeout=600)
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        dt.send_op(s, dt.WRITE_BLOCK, block_id=bid, gen_stamp=gen_stamp,
                   scheme="dedup_lz4", targets=list(targets),
                   _client="smoke")
        t0 = time.perf_counter()
        acks = dt.stream_acked(s, memoryview(blk), DEFAULT_PACKET)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        s.close()
    check(len(acks) == npkt + 1 and acks[-1] == (npkt, 0)
          and all(st == 0 for _, st in acks),
          f"block {bid}: write not acked {acks[-3:]}")
    return ms


def dn_read(addr, bid: int, offset: int = 0, length: int = -1):
    """READ_BLOCK -> (header, bytes); BLOCK_CHECKSUM -> reply."""
    import socket

    from hdrf_tpu_torch.proto import datatransfer as dt
    from hdrf_tpu_torch.proto.rpc import recv_frame

    s = socket.create_connection(tuple(addr), timeout=600)
    try:
        dt.send_op(s, dt.READ_BLOCK, block_id=bid, offset=offset,
                   length=length)
        hdr = recv_frame(s)
        check(hdr["status"] == 0, f"block {bid}: read refused {hdr}")
        return hdr, dt.collect_packets(s)
    finally:
        s.close()


def dn_checksum(addr, bid: int) -> dict:
    import socket

    from hdrf_tpu_torch.proto import datatransfer as dt
    from hdrf_tpu_torch.proto.rpc import recv_frame

    s = socket.create_connection(tuple(addr), timeout=600)
    try:
        dt.send_op(s, dt.BLOCK_CHECKSUM, block_id=bid)
        return recv_frame(s)
    finally:
        s.close()


def _target(dn) -> dict:
    return {"dn_id": dn.dn_id, "addr": list(dn.addr)}


def _dn_faults() -> dict:
    return {f"{r}.{k}": metrics.registry(r).counter(k)
            for r, ks in DN_FAULTS.items() for k in ks}


def check_faults(f0: dict, what: str, allowed: dict | None = None) -> dict:
    """The DN_FAULTS counters that moved since ``f0`` must be exactly
    ``allowed`` (what a pass injected); returns them."""
    moved = {k: v - f0[k] for k, v in _dn_faults().items() if v != f0[k]}
    check(moved == (allowed or {}),
          f"DATANODE {what}: failure counters moved {moved}, "
          f"want {allowed or {}}")
    return moved


def _wait_ibrs(nn, dn_id: str, want: list) -> None:
    """The IBRs ``nn`` recorded from ``dn_id`` equal ``want`` (sorted
    (block, length, partial)); IBRs are sent by a DataNode thread after
    the ack, so they are waited for up to 60 s."""
    t_end = time.monotonic() + 60
    while nn.ibrs_of(dn_id) != want and time.monotonic() < t_end:
        time.sleep(0.05)
    check(nn.ibrs_of(dn_id) == want,
          f"{dn_id}: IBRs {nn.ibrs_of(dn_id)} != the blocks written {want}")


def _drain(dns) -> None:
    for dn in dns:
        dn.containers.drain_seals()


def _write_streams(dn, blocks, first_id: int, targets=()) -> tuple:
    """``blocks`` over DN_STREAMS concurrent client streams; returns (ms a
    block on the client clock, wall s, the host cores this process used
    meanwhile: its user + system CPU s, every thread's, over the wall)."""
    from concurrent.futures import ThreadPoolExecutor

    c0, t0 = os.times(), time.perf_counter()
    with ThreadPoolExecutor(DN_STREAMS) as pool:
        ms = list(pool.map(
            lambda i: dn_write(dn.addr, first_id + i, blocks[i], targets),
            range(len(blocks))))
    wall, c1 = time.perf_counter() - t0, os.times()
    return ms, wall, (c1.user - c0.user + c1.system - c0.system) / wall


def _write_phases(first_id: int, n: int, hops: tuple) -> dict:
    """Phase ms a block of each hop's timeline, exclusive as the overlap
    accountant partitions each block's wall: a block's timelines in order
    of start are the primary's write (the one with a ``pipeline_submit``
    span), then each mirror's ingest down the chain.  A hop's
    ``mirror_stream`` holds its push to the next hop, which returns only
    after the whole rest of the chain has stored the block."""
    by_block: dict = {}
    for t in profiler.timelines_snapshot():
        if first_id <= t["block_id"] < first_id + n:
            by_block.setdefault(t["block_id"], []).append(t)
    check(sorted(by_block) == list(range(first_id, first_id + n))
          and all(len(v) == len(hops) for v in by_block.values()),
          f"write timelines {[len(v) for v in by_block.values()]}, want "
          f"{len(hops)} for each of {n} blocks")
    out = {h: {p: 0.0 for p in DN_PHASES} for h in hops}
    for tls in by_block.values():
        tls.sort(key=lambda t: t["t0"])
        check(any(s[0] == "pipeline_submit" for s in tls[0]["spans"]),
              "a block's first timeline is not the primary's write")
        for h, t in zip(hops, tls):
            for p, v in t["profile"]["phases"].items():
                out[h][p] = out[h].get(p, 0.0) + v * 1e3 / n
            out[h]["wall"] = out[h].get("wall", 0.0) \
                + t["profile"]["wall_s"] * 1e3 / n
    return out


def _stats(xs) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def datanode_main(root: str, nn, blocks: list, extra: list) -> dict:
    """Three DataNodes, replication 3: DN1 with targets DN2, DN3; the
    corpus over four concurrent streams; every block read back from all
    three, checksums and IBRs held; DN1 restarted with device_recon and
    every block read again through the raw gather."""
    dns = [start_dn(root, nn, f"dn{i}") for i in range(1, 4)]
    tg = [_target(d) for d in dns[1:]]
    wp = metrics.registry("write_pipeline")
    g0 = wp.counter("device_batches")
    hist0 = wp.snapshot()["histograms"].get("device_batch_blocks",
                                            {"count": 0, "sum": 0.0})
    profiler.reset()
    _zero_launch_counts()
    faults0 = _dn_faults()
    ms, wall, cores = _write_streams(dns[0], blocks, 1000, tg)
    _drain(dns)
    launches = _scheme_launch_counts()
    for kname in DN_WRITE_KERNELS:
        check(launches[kname] > 0,
              f"DATANODE write never launched the {kname} kernel")
    groups = wp.counter("device_batches") - g0
    hist = wp.snapshot()["histograms"]["device_batch_blocks"]
    check(groups > 0, "DATANODE write: the coalescer ran no group")
    # no failed leg, no seal fell back to the host codec (worker_fallbacks)
    faults = check_faults(faults0, "write")
    phases = _write_phases(1000, len(blocks), tuple(d.dn_id for d in dns))
    acc = [d.index.accounting() for d in dns]
    logical = sum(b.size for b in blocks)
    out = {"write": {
        "blocks": len(blocks), "block_mib": blocks[0].size / MIB,
        "streams": DN_STREAMS, "replication": 3,
        "ms_per_block": _stats(ms), "ms_all": ms,
        "aggregate_mib_s": logical / MIB / wall,
        "host_cores_used": cores, "host_cores": os.cpu_count(),
        "phase_ms_per_block": phases["dn1"],
        # the mirrors' ingest timelines: dn2's mirror_stream is its relay
        # to dn3
        "mirror_phase_ms_per_block": {h: phases[h] for h in ("dn2", "dn3")},
        "dedup_ratio": acc[0]["logical_bytes"] / acc[0]["unique_chunk_bytes"],
        # a mirror leg carries the chunk delta: the chunks the mirror lacked
        "mirror_leg_wire_bytes": [a["unique_chunk_bytes"] for a in acc[1:]],
        "mirror_leg_wire_ratio": [a["unique_chunk_bytes"] / logical
                                  for a in acc[1:]],
        "logical_bytes": logical,
        "coalescer_groups": groups,
        "mean_group_blocks": (hist["sum"] - hist0["sum"])
        / max(hist["count"] - hist0["count"], 1),
        "worker_fallbacks": sum(faults.get(f"{r}.worker_fallbacks", 0)
                                for r in ("datanode", "block_receiver")),
        "launches": launches,
        "launches_per_block": {k: v / len(blocks)
                               for k, v in launches.items()}}}
    print("DATANODE write " + json.dumps(out["write"]), flush=True)
    reads = {}
    want_ibr = sorted((1000 + i, b.size, False) for i, b in enumerate(blocks))
    for dn in dns:
        _wait_ibrs(nn, dn.dn_id, want_ibr)
        lat = []
        for i, b in enumerate(blocks):
            t0 = time.perf_counter()
            _, got = dn_read(dn.addr, 1000 + i)
            lat.append((time.perf_counter() - t0) * 1e3)
            check(got == b.tobytes(), f"{dn.dn_id} block {i}: read != written")
            ck = dn_checksum(dn.addr, 1000 + i)
            check(ck["checksums"] == [int(c) for c in native.crc32c_chunks(
                b, ck["checksum_chunk"])] and ck["logical_len"] == b.size,
                f"{dn.dn_id} block {i}: BLOCK_CHECKSUM != crc32c")
        reads[dn.dn_id] = _stats(lat)
    _, part = dn_read(dns[1].addr, 1000 + len(blocks) - 1, 12_345_677,
                      3_000_001)
    check(part == blocks[-1][12_345_677:15_345_678].tobytes(),
          "ranged read != slice")
    pw = profile_window(
        "datanode_write", lambda: [dn_write(dns[0].addr, 1100 + i, b, tg)
                                   for i, b in enumerate(extra)],
        len(extra), SCHEME_KERNEL_NAMES)
    _drain(dns)
    # the profiled block landed on every replica, as the first ones did
    want_ibr += [(1100 + i, b.size, False) for i, b in enumerate(extra)]
    for dn in dns:
        _wait_ibrs(nn, dn.dn_id, want_ibr)
    for i, b in enumerate(extra):
        _, got = dn_read(dns[2].addr, 1100 + i)
        check(got == b.tobytes(), f"dn3 profiled block {i}: read != written")
    check_faults(faults0, "reads and the profiled write")
    for dn in dns:
        dn.stop()
    # restart DN1 on its directory with the device reconstructor
    lost0 = metrics.registry("datanode").counter(
        "startup_lost_container_blocks")
    dn1 = start_dn(root, nn, "dn1", device_recon=True)
    try:
        check(dn1.reduction_ctx.recon is not None, "no reconstructor")
        check(metrics.registry("datanode").counter(
            "startup_lost_container_blocks") == lost0,
            "restart dropped blocks")
        _zero_launch_counts()
        faults0 = _dn_faults()
        lat = []
        for i, b in enumerate(blocks):
            t0 = time.perf_counter()
            _, got = dn_read(dn1.addr, 1000 + i)
            lat.append((time.perf_counter() - t0) * 1e3)
            check(got == b.tobytes(), f"recon read of block {i} != written")
        recon_launches = _scheme_launch_counts()
        check(recon_launches["gather_raw"] > 0,
              "device_recon reads never launched gather_raw")
        check_faults(faults0, "device_recon reads")
    finally:
        dn1.stop()
    out["read"] = {"ms_per_block": reads,
                   "device_recon_ms_per_block": _stats(lat),
                   "device_recon_launches": {
                       k: recon_launches[k] for k in SCHEME_READ_KERNELS},
                   "gather_raw_per_block":
                       recon_launches["gather_raw"] / len(blocks)}
    print("DATANODE read " + json.dumps(out["read"]), flush=True)
    out["profile"] = pw
    return out


def datanode_coded(root: str, nn, blocks: list) -> dict:
    """mirror_parity 1 over four fresh DataNodes: DN1 with targets
    DN2-DN4 (k 2, m 1).  The first block's data legs land; the second
    block's leg to DN3 is refused, so the parity leg to DN4 is hedged in.
    Each mirror that took a leg holds a segment (partial IBRs); DN2
    assembles the second block through the RS decode of the parity."""
    from hdrf_tpu_torch.ops import rs_cuda
    from hdrf_tpu_torch.utils import fault_injection

    dns = [start_dn(root, nn, f"dc{i}", mirror_parity=1)
           for i in range(1, 5)]
    m0 = metrics.registry("mirror").snapshot()["counters"]
    faults0 = _dn_faults()
    try:
        tg = [_target(d) for d in dns[1:]]
        rs_cuda.launches = 0
        ms = [dn_write(dns[0].addr, 2000, blocks[0], tg)]

        def refuse(**kw):
            if kw.get("peer") == dns[2].dn_id:
                raise IOError("leg refused")
        with fault_injection.inject("mirror_plane.leg", refuse):
            ms.append(dn_write(dns[0].addr, 2001, blocks[1], tg))
        t_end = time.monotonic() + 60
        while dns[3].mirror.report()["segments_held"] < 1 \
                and time.monotonic() < t_end:
            time.sleep(0.05)
        held = [d.mirror.report()["segments_held"] for d in dns[1:]]
        check(held[0] == 2 and held[1] == 1 and held[2] >= 1,
              f"segments held {held}")
        enc = rs_cuda.launches
        t0 = time.perf_counter()
        dns[1]._execute({"cmd": "mirror_assemble", "block_id": 2001})
        asm_ms = (time.perf_counter() - t0) * 1e3
        check(rs_cuda.launches > enc, "assemble ran no RS decode")
        _, got = dn_read(dns[1].addr, 2001)
        check(got == blocks[1].tobytes(), "assembled replica != written")
        partial = [r for r in nn.ibrs_of(dns[1].dn_id) if r[2]]
        check([r[0] for r in partial] == [2000, 2001],
              f"partial IBRs {partial}")
        c = metrics.registry("mirror").snapshot()["counters"]
        delta = {k: c.get(k, 0) - m0.get(k, 0) for k in c}
        check(delta.get("coded_pushes", 0) == 2
              and delta.get("coded_fallbacks", 0) == 0,
              f"coded pushes {delta}")
        # the one refused leg is the only failure the pass may show
        faults = check_faults(faults0, "coded mirror",
                              {"block_receiver.mirror_failures": 1})
        out = {"k": 2, "m": 1, "write_ms": ms, "segments_held": held,
               "assemble_ms": asm_ms, "rs_launches": rs_cuda.launches,
               "rs_encode_launches": enc, "mirror": delta, "faults": faults}
    finally:
        for dn in dns:
            dn.stop()
    print("DATANODE mirror " + json.dumps(out), flush=True)
    return out


def datanode_phase(args) -> dict:
    """DATANODE: the port's DataNode on the card through its wire entry
    points (a stand-in NameNode; a wire client on the port's
    datatransfer): the main pass and the coded mirror.  Each pass's
    directories are deleted when it ends."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    # the first blocks of a three-block corpus: random 1 MiB segments
    # with copies (a corpus's last block is text, which the coded pass
    # does not take)
    blocks = main_path_corpus(args.seed, 3, args.block_mib)[:DN_STREAMS]
    extra = main_path_corpus(args.seed + 9, 2, args.block_mib)[:1]
    nn = SmokeNN()
    out = {}
    try:
        for name, run_pass in (
                ("main", lambda r: datanode_main(r, nn, blocks, extra)),
                ("mirror", lambda r: datanode_coded(r, nn, blocks))):
            root = tempfile.mkdtemp(prefix=f"smoke_dn_{name}_")
            try:
                out[name] = run_pass(root)
            finally:
                shutil.rmtree(root, ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        nn.stop()
    out["seconds"] = time.perf_counter() - t0
    print(f"DATANODE done in {out['seconds']:.1f}s", flush=True)
    return out


# -------------------------------------------------------------- namenode

NN_DATANODES = 4
NN_META_PAIRS = 1000     # NNThroughputBenchmark-style create + complete
NN_META_THREADS = 8
NN_WAIT_S = 180.0
NN_WATCH = ("repair", "demot", "stripe", "replicat", "dead", "fail",
            "error", "invalid", "gather")


def _wait_for(pred, what: str, timeout: float = NN_WAIT_S,
              detail=None) -> float:
    """Poll ``pred`` until true; returns the seconds it took, fails the
    smoke after ``timeout`` with the NameNode's and the EC tier's
    scheduling counters (and ``detail()``) in the message."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 >= timeout:
            counters = {r: {k: v for k, v in metrics.registry(r).snapshot()[
                "counters"].items() if any(w in k for w in NN_WATCH)}
                for r in ("namenode", "ec", "datanode")}
            more = "" if detail is None else "; " + json.dumps(detail())
            check(False, f"NAMENODE: timed out after {timeout:.0f}s waiting "
                  f"for {what}; {json.dumps(counters)}{more}")
        time.sleep(0.05)
    return time.monotonic() - t0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nn_start(meta_dir: str, port: int, block_mib: int):
    """The port NameNode at NameNodeConfig() defaults (replication 3,
    1 s heartbeats, 6 s dead-node detection) on ``meta_dir`` and a fixed
    port, its block size ``--block-mib`` (128 MiB, the default, at the
    smoke's defaults), so that every corpus block is one file block, and
    its status HTTP server on a free port."""
    from hdrf_tpu_torch.config import NameNodeConfig
    from hdrf_tpu_torch.server.namenode import NameNode

    return NameNode(NameNodeConfig(meta_dir=meta_dir, port=port,
                                   block_size=block_mib * MIB,
                                   status_port=0)).start()


def _timed_write(c, path: str, blocks: list, **kw) -> list:
    """``c.write`` of the blocks' bytes as one file; returns the client
    ms of each block (``HdrfClient._write_block``: add_block, the block
    streamed down the pipeline the NameNode chose, its final ack)."""
    ms: list = []
    inner = c._write_block

    def timed(path, block, retries=3):
        t0 = time.perf_counter()
        bid = inner(path, block, retries)
        ms.append((time.perf_counter() - t0) * 1e3)
        return bid
    c._write_block = timed
    try:
        c.write(path, b"".join(b.tobytes() for b in blocks), **kw)
    finally:
        c._write_block = inner
    return ms


def _nn_write_file(addr, path: str, blocks: list) -> dict:
    """The port's HdrfClient writing ``blocks`` as one dedup_lz4 file:
    create, per block add_block and the block streamed down the pipeline
    the NameNode chose, then complete polled until the IBRs are in."""
    from hdrf_tpu_torch.client.filesystem import HdrfClient

    with HdrfClient(addr, name=f"smoke{path.replace('/', '-')}") as c:
        ms = _timed_write(c, path, blocks, scheme="dedup_lz4")
        bids = [b["block_id"] for b in c._call(
            "get_block_locations", path=path)["blocks"]]
    check(len(ms) == len(blocks) == len(bids),
          f"{path}: {len(ms)} blocks written, {len(bids)} located")
    return {"ms": ms, "block_ids": bids}


def _locations(nn, path: str) -> dict:
    return {b["block_id"]: sorted(loc["dn_id"] for loc in b["locations"])
            for b in nn.rpc_get_block_locations(path)["blocks"]}


def _nn_counts() -> dict:
    from hdrf_tpu_torch.ops import rs_cuda

    return {**_scheme_launch_counts(), "rs": rs_cuda.launches}


def _nn_zero() -> None:
    from hdrf_tpu_torch.ops import rs_cuda

    _zero_launch_counts()
    rs_cuda.launches = 0


def _nn_counter(key: str) -> int:
    return metrics.registry("namenode").counter(key)


# what the DataNodes did with the NameNode's commands in a step: a
# heartbeat or a full report that failed, a command that failed, an
# xceiver op's OSError, a replica pushed, a replicate with no source
# replica, a push to a target that held it already, a block whose
# containers were all striped, an open container a demotion sealed
NN_COMMAND_COUNTERS = {
    "datanode": ("heartbeat_failures", "block_report_failures",
                 "command_errors", "op_io_errors", "blocks_replicated",
                 "replicate_source_missing"),
    "block_receiver": ("replicas_already_held",),
    "ec": ("demotes_already_striped", "demote_open_sealed")}


def _stripe_counts(dns: dict) -> dict:
    """Each stripe group, by its owner and container: its stripes a
    DataNode (the owner's manifest holders)."""
    out: dict = {}
    for d, dn in sorted(dns.items()):
        for cid, man in sorted(dn.index.stripe_manifests().items()):
            held: dict = {}
            for h in man["holders"]:
                held[h[0]] = held.get(h[0], 0) + 1
            out[f"{d}/{cid}"] = held
    return out


def _check_spread(nn, dns: dict, when: str, over_m: int = 0) -> dict:
    """No DataNode holds more than m stripes of a group, so that any one
    loss leaves k; prints each group's stripes a DataNode.  ``over_m``:
    the repairs the NameNode placed past m because its live pool had no
    room (``stripe_repairs_over_m``), each of which may leave one group
    so."""
    counts = _stripe_counts(dns)
    m = nn.config.ec_parity_shards
    print(f"NAMENODE stripes {when} " + json.dumps(
        {"groups": counts, "repairs_over_m": over_m,
         "vetoed": _vetoed(nn)}), flush=True)
    over = [g for g, v in counts.items() if max(v.values()) > m]
    check(counts and len(over) <= over_m,
          f"NAMENODE (d) {when}: groups {over} hold more than {m} stripes "
          f"on one DataNode ({over_m} repairs had no room): {counts}")
    return counts


def _vetoed(nn) -> dict:
    """What the NameNode's health report leaves out of the stripes'
    placement pool."""
    with nn._lock:
        h = nn._health_report()
    return {"slow_peers": sorted(h["slow_peers"]),
            "degraded_nodes": h["degraded_nodes"],
            "slow_volumes": sorted(h["slow_volumes"])}


def _command_counts() -> dict:
    return {f"{r}.{k}": metrics.registry(r).counter(k)
            for r, ks in NN_COMMAND_COUNTERS.items() for k in ks}


def _command_delta(c0: dict) -> dict:
    return {k: v - c0[k] for k, v in _command_counts().items()}


def _read_back(dns: dict, where: dict, data: dict, what: str,
               checksums: bool = False) -> list:
    """Every listed replica read with READ_BLOCK equals the bytes written
    (and with ``checksums``, BLOCK_CHECKSUM equals their CRC32C); returns
    the read ms."""
    lat = []
    for bid, holders in where.items():
        check(holders, f"{what}: block {bid} has no location")
        for d in holders:
            t0 = time.perf_counter()
            _, got = dn_read(dns[d].addr, bid)
            lat.append((time.perf_counter() - t0) * 1e3)
            check(got == data[bid], f"{what}: {d} block {bid} != written")
            if checksums:
                ck = dn_checksum(dns[d].addr, bid)
                check(ck["checksums"] == [int(c) for c in native.crc32c_chunks(
                    np.frombuffer(data[bid], np.uint8), ck["checksum_chunk"])]
                    and ck["logical_len"] == len(data[bid]),
                    f"{what}: {d} block {bid}: BLOCK_CHECKSUM != crc32c")
    return lat


class DnCommandLog:
    """Logs what the DataNodes do with their NameNode's commands while the
    NAMENODE phase runs, for the faults of its steps (c) and (d) that
    recur rarely: each ``replicate``'s outcome (the source's meta missing,
    pushed in s, or the exception), every command that raises, and every
    OSError an xceiver op swallows (counted as ``op_io_errors``).  The
    DataNode's methods are wrapped for the ``with`` block only; each entry
    prints at once as a ``NAMENODE log`` line."""

    def __init__(self):
        self.entries: list[str] = []

    def _log(self, dn, what: str) -> None:
        line = f"{time.strftime('%H:%M:%S')} {dn.dn_id} {what}"
        self.entries.append(line)
        print("NAMENODE log " + line, flush=True)

    def __enter__(self):
        from hdrf_tpu_torch.server.datanode import DataNode
        from hdrf_tpu_torch.utils.qos import ShedError

        self._saved = {n: getattr(DataNode, n) for n in
                       ("_replicate", "_execute", "_dispatch_op")}
        replicate, execute, dispatch_op = (self._saved[n] for n in
                                           ("_replicate", "_execute",
                                            "_dispatch_op"))
        log = self._log

        def _replicate(dn, cmd):
            bid, t0 = cmd["block_id"], time.perf_counter()
            to = [t["dn_id"] for t in cmd["targets"]]
            if dn.replicas.get_meta(bid) is None:
                log(dn, f"replicate {bid} -> {to}: meta missing, nothing "
                        "pushed")
            try:
                replicate(dn, cmd)
            except BaseException as e:
                log(dn, f"replicate {bid} -> {to}: raised {e!r}")
                raise
            log(dn, f"replicate {bid} -> {to}: returned in "
                    f"{time.perf_counter() - t0:.2f}s")

        def _execute(dn, cmd):
            try:
                execute(dn, cmd)
            except BaseException as e:
                log(dn, f"command {cmd.get('cmd')} "
                        f"{cmd.get('block_id', cmd.get('block_ids'))}: "
                        f"raised {e!r}")
                raise

        def _dispatch_op(dn, sock, op, fields):
            try:
                dispatch_op(dn, sock, op, fields)
            except ShedError:
                raise
            except (ConnectionError, OSError) as e:
                log(dn, f"xceiver op {op} block {fields.get('block_id')}: "
                        f"{e!r}")
                raise

        DataNode._replicate = _replicate
        DataNode._execute = _execute
        DataNode._dispatch_op = _dispatch_op
        return self

    def __exit__(self, *exc):
        from hdrf_tpu_torch.server.datanode import DataNode

        for n, f in self._saved.items():
            setattr(DataNode, n, f)
        return False


def namenode_phase(args, after_demotion=None) -> dict:
    """NAMENODE: the port's NameNode at NameNodeConfig() defaults running
    four port DataNodes on ``cuda:0``, driven by a writer on the port's
    RpcClient: (a) write and read, (b) NameNode restart, (c) re-replication
    and excess pruning, (d) demotion and stripe repair, then
    ``after_demotion(nn, dns, data, owners, addr)`` on the demoted
    cluster (PLANES (c)), (e) metadata ops."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    from hdrf_tpu_torch.proto.rpc import RpcClient, packb

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="smoke_nn_")
    meta, port = os.path.join(root, "name"), _free_port()
    addr = ("127.0.0.1", port)
    nn_ref = SimpleNamespace(addr=addr)
    corpus = main_path_corpus(args.seed, 3, args.block_mib)
    # one block a writer: a second block of one file only repeated the
    # write path (the smoke's time budget, PERF.md section 5)
    files = {"/nn/f0": corpus[:1], "/nn/f1": corpus[2:3]}
    out: dict = {"launches": {}}
    nn = _nn_start(meta, port, args.block_mib)
    dns: dict = {}
    try:
        dns = {f"nd{i}": start_dn(root, nn_ref, f"nd{i}")
               for i in range(1, NN_DATANODES + 1)}
        _wait_for(lambda: len(nn._datanodes) == NN_DATANODES,
                  "DataNode registration")

        # ---- (a) write and read ------------------------------------------
        t0 = time.perf_counter()
        _nn_zero()
        faults0 = _dn_faults()
        with ThreadPoolExecutor(len(files)) as pool:
            wrote = dict(zip(files, pool.map(
                lambda p: _nn_write_file(addr, p, files[p]), files)))
        for dn in dns.values():
            dn.containers.drain_seals()
        launches = _nn_counts()
        for kname in DN_WRITE_KERNELS:
            check(launches[kname] > 0,
                  f"NAMENODE write never launched the {kname} kernel")
        data = {bid: b.tobytes() for p in files
                for bid, b in zip(wrote[p]["block_ids"], files[p])}
        where = {}
        for p, blocks in files.items():
            st = nn.rpc_stat(p)
            check(st["length"] == sum(b.size for b in blocks)
                  and st["complete"], f"NAMENODE stat {p}: {st}")
            where.update(_locations(nn, p))
        check(all(len(h) == 3 for h in where.values()),
              f"NAMENODE: replicas {where}")
        read_ms = _read_back(dns, where, data, "NAMENODE (a)", True)
        check_faults(faults0, "NAMENODE write and read")
        out["a"] = {"seconds": time.perf_counter() - t0,
                    "files": {p: len(b) for p, b in files.items()},
                    "block_mib": args.block_mib,
                    "write_ms_per_block": _stats(
                        [m for w in wrote.values() for m in w["ms"]]),
                    "read_ms_per_replica": _stats(read_ms),
                    "locations": {str(b): h for b, h in where.items()},
                    "launches": launches}
        out["launches"]["a"] = launches
        print("NAMENODE write " + json.dumps(out["a"]), flush=True)

        # ---- (b) restart the NameNode on its meta dir --------------------
        t0 = time.perf_counter()
        faults0 = _dn_faults()
        cmds0 = _command_counts()
        before = (packb(nn._snapshot()), nn._next_inode, nn._next_block_id,
                  nn._gen_stamp, nn.rpc_listing("/nn"))
        seq = nn._editlog.seq
        nn.stop()
        nn = _nn_start(meta, port, args.block_mib)
        after = (packb(nn._snapshot()), nn._next_inode, nn._next_block_id,
                 nn._gen_stamp, nn.rpc_listing("/nn"))
        check(after == before and nn._editlog.seq == seq,
              "NAMENODE restart: namespace differs after replay")
        check(nn.rpc_safemode("get"), "NAMENODE restart: no startup safemode")
        safe_s = _wait_for(lambda: not nn.rpc_safemode("get"),
                           "safemode exit after the block reports")
        locs_s = _wait_for(lambda: {b: h for p in files
                                    for b, h in _locations(nn, p).items()}
                           == where, "locations after the restart")
        check_faults(faults0, "NAMENODE restart")
        out["b"] = {"seconds": time.perf_counter() - t0,
                    "editlog_seq": seq, "safemode_exit_s": safe_s,
                    "locations_s": locs_s,
                    "commands": _command_delta(cmds0)}
        print("NAMENODE restart " + json.dumps(out["b"]), flush=True)

        # ---- (c) re-replication, then excess pruning ---------------------
        t0 = time.perf_counter()
        _nn_zero()
        faults0 = _dn_faults()
        cmds0 = _command_counts()
        repl0 = _nn_counter("replications_scheduled")
        victim = where[wrote["/nn/f0"]["block_ids"][0]][0]
        dns[victim].stop()
        dead_s = _wait_for(lambda: victim not in nn._datanodes,
                           f"{victim} declared dead")

        def rereplicated():
            now = {b: h for p in files for b, h in _locations(nn, p).items()}
            return now if all(len(h) == 3 and victim not in h
                              for h in now.values()) else None
        repl_s = _wait_for(rereplicated, "re-replication")
        check(_nn_counter("replications_scheduled") > repl0,
              "NAMENODE: no replicate command scheduled")
        moved = {b: [d for d in h if d not in where[b]]
                 for b, h in rereplicated().items() if victim in where[b]}
        check(moved and all(len(v) == 1 for v in moved.values()),
              f"NAMENODE re-replication: new holders {moved}")
        _read_back(dns, moved, data, "NAMENODE (c) new replicas")
        excess0 = _nn_counter("excess_replicas_pruned")
        dns[victim] = start_dn(root, nn_ref, victim)

        def pruned():
            now = {b: h for p in files for b, h in _locations(nn, p).items()}
            held = {b: sorted(d for d, dn in dns.items()
                              if b in dn.replicas.block_ids()) for b in now}
            return now if all(len(h) == 3 and held[b] == h
                              for b, h in now.items()) else None
        prune_s = _wait_for(lambda: _nn_counter("excess_replicas_pruned")
                            > excess0 and pruned(),
                            "excess replicas pruned by invalidate")
        where = pruned()
        # every other replica listed was read in (a) or as a new one: the
        # restarted holder's kept replicas are the ones left to read
        _read_back(dns, {b: [victim] for b, h in where.items()
                         if victim in h}, data,
                   "NAMENODE (c) after pruning")
        check_faults(faults0, "NAMENODE re-replication")
        out["c"] = {"seconds": time.perf_counter() - t0, "victim": victim,
                    "dead_after_s": dead_s, "rereplicated_s": repl_s,
                    "rereplicated_blocks": len(moved),
                    "s_per_block": repl_s / len(moved),
                    "excess_pruned": _nn_counter("excess_replicas_pruned")
                    - excess0, "pruned_s": prune_s,
                    "replications_scheduled":
                    _nn_counter("replications_scheduled") - repl0,
                    "commands": _command_delta(cmds0),
                    "launches": _nn_counts()}
        out["launches"]["c"] = out["c"]["launches"]
        print("NAMENODE rereplicate " + json.dumps(out["c"]), flush=True)

        # ---- (d) demotion, then repair of a lost stripe holder -----------
        t0 = time.perf_counter()
        _nn_zero()
        faults0 = _dn_faults()
        cmds0 = _command_counts()
        demote0 = _nn_counter("ec_demotions_scheduled")
        ec = metrics.registry("ec")

        def containers_of_blocks():
            """Each block's holders and, on its owner (the first), the
            states of the containers holding its chunks."""
            out = {}
            for p in files:
                for b, h in _locations(nn, p).items():
                    dn = dns[h[0]]
                    entry = dn.index.get_block(b)
                    cids = sorted({loc.container_id for loc in (
                        dn.index.chunk_location(x) for x in entry.hashes)
                        if loc is not None}) if entry else []
                    out[str(b)] = {"holders": h, "demoted":
                                   b in nn._ec_demoted, "containers": {
                                       str(c): "striped" if
                                       dn.index.stripe_manifest(c)
                                       else "sealed" if os.path.exists(
                                           dn.volumes.volume_of_cid(c)
                                           .containers._sealed_path(c))
                                       else "open" for c in cids}}
            return out
        print("NAMENODE containers before demotion "
              + json.dumps(containers_of_blocks()), flush=True)
        nn.config.ec_demote_after_s = 1.0
        demote_s = _wait_for(
            lambda: nn.rpc_ec_status()["demoted_blocks"] == len(data),
            "stripe_demote of every block and its stripe_complete",
            detail=lambda: {
                "ec_demotions_deferred": _nn_counter("ec_demotions_deferred"),
                "vetoed": _vetoed(nn),
                "containers": containers_of_blocks()})
        print("NAMENODE containers after demotion "
              + json.dumps(containers_of_blocks()), flush=True)
        demoted = _check_spread(nn, dns, "after demotion")
        _wait_for(lambda: nn.rpc_ec_status()["striped_containers"] > 0,
                  "the striped-container census")
        _wait_for(lambda: all(len(h) == 1 for p in files
                              for h in _locations(nn, p).values()),
                  "the full replicas invalidated down to the owner")
        owners = {b: h[0] for p in files
                  for b, h in _locations(nn, p).items()}
        enc = _nn_counts()
        check(enc["rs"] > 0, "NAMENODE demote launched no rs kernel")
        _read_back(dns, {b: [o] for b, o in owners.items()}, data,
                   "NAMENODE (d) demoted")
        status = nn.rpc_ec_status()
        holders = {h[0] for dn in dns.values()
                   for m in dn.index.stripe_manifests().values()
                   for h in m["holders"]}
        slow = _vetoed(nn)["slow_peers"]
        # the stripes' placement pool leaves out the DataNodes the health
        # report vetoes (a slow peer of the write): the holder stopped is
        # one that holds a stripe and owns no block
        lost = next((d for d in sorted(dns) if d not in owners.values()
                     and d in holders), None)
        check(lost is not None, f"NAMENODE: no stripe holder but the "
              f"owners {sorted(set(owners.values()))}: holders "
              f"{sorted(holders)}, slow peers {slow}")
        _nn_zero()
        rep0 = ec.counter("stripes_repaired")
        sched0 = _nn_counter("stripe_repairs_scheduled")
        over0 = _nn_counter("stripe_repairs_over_m")
        t1 = time.perf_counter()
        dns[lost].stop()
        del dns[lost]
        repair_s = _wait_for(
            lambda: ec.counter("stripes_repaired") > rep0 and all(
                h[0] != lost for dn in dns.values()
                for m in dn.index.stripe_manifests().values()
                for h in m["holders"]), "stripe_repair of every group",
            detail=lambda: {"lost": lost, "holders": {
                d: {c: [h[0] for h in m["holders"]] for c, m in
                    dn.index.stripe_manifests().items()}
                for d, dn in dns.items()}})
        dec = _nn_counts()
        check(_nn_counter("stripe_repairs_scheduled") > sched0,
              "NAMENODE: no stripe_repair scheduled")
        check(dec["rs"] > 0, "NAMENODE repair launched no rs kernel")
        repaired = _check_spread(
            nn, dns, "after repair",
            _nn_counter("stripe_repairs_over_m") - over0)
        unrecoverable = nn.rpc_ec_status()["stripe_groups_unrecoverable"]
        check(unrecoverable == 0,
              f"NAMENODE (d): {unrecoverable} stripe groups unrecoverable")
        _read_back(dns, {b: [o] for b, o in owners.items()}, data,
                   "NAMENODE (d) repaired")
        check_faults(faults0, "NAMENODE demote and repair")
        out["d"] = {"seconds": time.perf_counter() - t0,
                    "demote_s": demote_s, "ec_status": status,
                    "stripe_holders": sorted(holders), "slow_peers": slow,
                    "stripes_demoted": demoted, "stripes_repaired_to":
                    repaired, "demotions_deferred":
                    _nn_counter("ec_demotions_deferred"),
                    "repairs_over_m":
                    _nn_counter("stripe_repairs_over_m") - over0,
                    "groups_unrecoverable": unrecoverable,
                    "lost_holder": lost, "repair_s": repair_s,
                    "repair_wall_s": time.perf_counter() - t1,
                    "stripes_repaired": ec.counter("stripes_repaired")
                    - rep0, "demotions_scheduled":
                    _nn_counter("ec_demotions_scheduled") - demote0,
                    "commands": _command_delta(cmds0),
                    "demote_launches": enc,
                    "repair_launches": dec}
        out["launches"]["d_demote"] = enc
        out["launches"]["d_repair"] = dec
        print("NAMENODE ec " + json.dumps(out["d"]), flush=True)
        if after_demotion is not None:
            out["after_demotion"] = after_demotion(nn, dns, data, owners,
                                                   addr)

        # ---- (e) metadata ops, for information ---------------------------
        t0 = time.perf_counter()
        faults0 = _dn_faults()
        lat: list = []

        def bench(t: int) -> list:
            mine = []
            with RpcClient(addr) as c:
                for i in range(t, NN_META_PAIRS, NN_META_THREADS):
                    p = f"/nnbench/t{t}/f{i}"
                    for method, kw in (("create", {}),
                                       ("complete", {"block_lengths": {}})):
                        s0 = time.perf_counter()
                        got = c.call(method, path=p, client=f"b{t}", **kw)
                        mine.append((time.perf_counter() - s0) * 1e3)
                    check(got is True, f"NAMENODE bench: complete {p}")
            return mine
        with ThreadPoolExecutor(NN_META_THREADS) as pool:
            for part in pool.map(bench, range(NN_META_THREADS)):
                lat += part
        wall = time.perf_counter() - t0
        lat.sort()
        out["e"] = {"seconds": wall, "pairs": NN_META_PAIRS,
                    "threads": NN_META_THREADS,
                    "ops_per_s": 2 * NN_META_PAIRS / wall,
                    "client_ms_p50": lat[len(lat) // 2],
                    "client_ms_p99": lat[int(len(lat) * 0.99)],
                    "rpc_namenode_p99_ms": nn._rpc.rpc_p99_ms()}
        check(len(nn.rpc_listing("/nnbench")) == NN_META_THREADS,
              "NAMENODE bench: files missing")
        check_faults(faults0, "NAMENODE metadata ops")
        print("NAMENODE meta " + json.dumps(out["e"]), flush=True)
    finally:
        for dn in dns.values():
            dn.stop()
        nn.stop()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    total = {k: sum(v.get(k, 0) for v in out["launches"].values())
             for k in _nn_counts()}
    out["seconds"] = time.perf_counter() - t_phase
    print("NAMENODE launches " + json.dumps(total), flush=True)
    print(f"NAMENODE done in {out['seconds']:.1f}s", flush=True)
    return out


# ---------------------------------------------------------------- client

CLIENT_DATANODES = 9     # RS-6-3-1024k, HDFS's default EC policy: k + m
CLIENT_EC = "rs-6-3-1024k"
CLIENT_SEAL_OPS = ("resident.cdc", "resident.sha", "lz4.scan")


def _counter_of(registry: str, key: str) -> int:
    return metrics.registry(registry).counter(key)


def _hop_phases(bids: list, since: float) -> dict:
    """Phase ms a block of each hop's write timeline (the DataNodes'
    ``utils/profiler`` BlockTimelines of ``bids`` that started after
    ``since``, a ``profiler._now()`` reading; each block's in order of
    start: the primary, then each mirror down the chain), rounded."""
    by_block: dict = {}
    for t in profiler.timelines_snapshot():
        if t["block_id"] in bids and t["t0"] >= since:
            by_block.setdefault(t["block_id"], []).append(t)
    out: dict = {}
    for tls in by_block.values():
        tls.sort(key=lambda t: t["t0"])
        for i, t in enumerate(tls):
            hop = out.setdefault("primary" if i == 0 else f"mirror{i}", {})
            for ph, v in {**t["profile"]["phases"],
                          "wall": t["profile"]["wall_s"]}.items():
                hop[ph] = hop.get(ph, 0.0) + v * 1e3 / len(by_block)
    return {h: {k: round(v, 1) for k, v in ph.items() if v >= 0.05}
            for h, ph in out.items()}


def _cores(c0, wall: float) -> float:
    """Host cores this process used since ``c0`` (os.times) over wall s."""
    c1 = os.times()
    return (c1.user - c0.user + c1.system - c0.system) / wall


def _mib_s(nbytes: int, ms: float) -> float:
    return nbytes / MIB / (ms / 1e3)


def _plain_err(coeffs: np.ndarray, src: np.ndarray,
               got: np.ndarray) -> int:
    """Max abs difference of ``got`` u8[nrows, L] from the GF kernel's
    plain version (``rs_cuda.gf_apply_plain``) of ``coeffs`` applied to
    host rows ``src`` u8[k, L], on the card in column windows of 4 MiB."""
    from hdrf_tpu_torch.ops import rs_cuda

    dev = torch.device("cuda:0")
    err = 0
    for lo in range(0, src.shape[1], 4 * MIB):
        want = rs_cuda.gf_apply_plain(
            coeffs, torch.from_numpy(
                np.ascontiguousarray(src[:, lo:lo + 4 * MIB])).to(dev))
        err = max(err, max_err(torch.from_numpy(np.ascontiguousarray(
            got[:, lo:lo + 4 * MIB])).to(dev), want))
    return err


def client_phase(args) -> dict:
    """CLIENT: the port's MiniCluster on ``cuda:0`` (NameNodeConfig
    defaults where they matter: 128 MiB blocks, replication 3, 1 s
    heartbeats, 6 s dead-node verdict; 32 MiB containers; nine native
    DataNodes) with ``tpu_worker=True``: one port reduction worker process
    owns the card, and the DataNodes send it ``reduce`` and the seals.
    The port's HdrfClient in this process (device ``cuda``): (a) dedup_lz4
    writes and reads over TCP, (b) a direct file read through the
    short-circuit fd and over the wire, deleted and re-created (one MiB
    of other bytes), (c) the
    same bytes as an RS-6-3-1024k file, read whole and degraded."""
    import shutil
    import tempfile

    from hdrf_tpu_torch.client.filesystem import HdrfClient
    from hdrf_tpu_torch.client.striped import layout_shards
    from hdrf_tpu_torch.config import ClientConfig
    from hdrf_tpu_torch.ops import rs, rs_cuda
    from hdrf_tpu_torch.proto import datatransfer as dt
    from hdrf_tpu_torch.reduction import accounting
    from hdrf_tpu_torch.server.reduction_worker import WorkerClient
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    t_phase = time.perf_counter()
    bs = args.block_mib * MIB
    corpus = main_path_corpus(args.seed, 3, args.block_mib)
    a_bytes = corpus[0].tobytes() + corpus[1].tobytes()
    root = tempfile.mkdtemp(prefix="smc_")   # AF_UNIX paths: keep it short
    out: dict = {}
    mc = MiniCluster(n_datanodes=CLIENT_DATANODES, base_dir=root,
                     replication=3, block_size=bs,
                     container_size=SEAL_BYTES, heartbeat_s=1.0,
                     dead_node_s=6.0, tpu_worker=True)
    try:
        t0 = time.perf_counter()
        mc.start()
        start_s = time.perf_counter() - t0
        worker = WorkerClient(mc._worker_addr, deadline_s=600)
        ping = worker.ping()
        check(ping["backend"] == "cuda",
              f"CLIENT: the worker runs on {ping}, not the card")
        c = mc.client("smoke-client")
        check(c.device == "cuda", f"CLIENT: client device {c.device}")
        dns = [d for d in mc.datanodes if d is not None]

        # ---- (a) dedup_lz4 through the worker, reads over TCP ------------
        t0 = time.perf_counter()
        faults0 = _dn_faults()
        sc0 = _counter_of("client", "short_circuit_reads")
        md0 = _counter_of("shortcircuit", "metadata_only")
        acc0 = accounting.snapshot()["counters"]
        w0 = worker.stats()
        since = profiler._now()
        c0, t1 = os.times(), time.perf_counter()
        a_ms = _timed_write(c, "/c/a", corpus[:2], scheme="dedup_lz4")
        a_cores = _cores(c0, time.perf_counter() - t1)
        acc1 = accounting.snapshot()["counters"]
        dup_ms = _timed_write(c, "/c/dup", corpus[:1], scheme="dedup_lz4")
        acc2 = accounting.snapshot()["counters"]
        a_bids = [b["block_id"] for p in ("/c/a", "/c/dup") for b in
                  c._call("get_block_locations", path=p)["blocks"]]
        _drain(dns)
        w1 = worker.stats()
        check(w1["blocks_reduced"] - w0["blocks_reduced"] >= 3
              and w1["compress_jobs"] > w0["compress_jobs"],
              f"CLIENT: the worker reduced and sealed too little {w0} {w1}")
        ops = {e["op"] for e in worker.traces()["ledger"]}
        check(set(CLIENT_SEAL_OPS) <= ops,
              f"CLIENT: worker ledger ops {sorted(ops)} lack "
              f"{CLIENT_SEAL_OPS}")
        read_ms = []
        for p, want in (("/c/a", a_bytes), ("/c/dup", a_bytes[:bs])):
            t1 = time.perf_counter()
            check(c.read(p) == want, f"CLIENT (a): {p} != written")
            read_ms.append((time.perf_counter() - t1) * 1e3)
            ck = c.get_file_checksum(p)
            check(ck["crc"] == native.crc32c(want)
                  and ck["length"] == len(want),
                  f"CLIENT (a): {p} checksum {ck} != crc32c")
        for off, ln in ((bs - 12_345, 1_000_003), (77_777, 5 * MIB + 1),
                        (2 * bs - 3, 3)):
            check(c.read("/c/a", offset=off, length=ln)
                  == a_bytes[off:off + ln],
                  f"CLIENT (a): /c/a [{off}, +{ln}) != written")
        check(_counter_of("client", "short_circuit_reads") == sc0
              and _counter_of("shortcircuit", "metadata_only") > md0,
              "CLIENT (a): a reduced replica passed an fd")

        def delta(x, y, key):
            return y.get(key, 0) - x.get(key, 0)
        dup_logical = delta(acc1, acc2, "logical_bytes__dedup_lz4")
        dup_physical = delta(acc1, acc2, "physical_bytes__dedup_lz4")
        check_faults(faults0, "CLIENT (a)")
        out["a"] = {"seconds": time.perf_counter() - t0,
                    "write_ms_per_block": _stats(a_ms),
                    "write_mib_s": _mib_s(len(a_bytes), sum(a_ms)),
                    "dup_ms": dup_ms[0],
                    "dup_dedup": dup_logical / max(dup_physical, 1),
                    "a_dedup": delta(acc0, acc1, "logical_bytes__dedup_lz4")
                    / max(delta(acc0, acc1, "physical_bytes__dedup_lz4"), 1),
                    "dup_chunks_hit": delta(acc1, acc2, "dedup_chunks_hit"),
                    "dup_chunks_miss": delta(acc1, acc2, "dedup_chunks_miss"),
                    "read_ms": read_ms, "host_cores_used": a_cores,
                    "phase_ms_per_block": _hop_phases(a_bids[:2], since),
                    "dup_phase_ms": _hop_phases(a_bids[2:], since),
                    "worker": w1, "worker_ledger_ops": sorted(ops)}
        print("CLIENT write " + json.dumps(out["a"]), flush=True)

        # ---- (b) direct: short-circuit against the wire -------------------
        t0 = time.perf_counter()
        faults0 = _dn_faults()
        d_bytes = corpus[2].tobytes()
        since = profiler._now()
        c0, t1 = os.times(), time.perf_counter()
        d_ms = _timed_write(c, "/c/d", corpus[2:3], scheme="direct")
        d_cores = _cores(c0, time.perf_counter() - t1)
        d_write_s = time.perf_counter() - t1
        sc0 = _counter_of("client", "short_circuit_reads")
        sc_ms, wire_ms = [], []
        with HdrfClient(mc.nn_addrs()[0], name="smoke-wire",
                        config=ClientConfig(short_circuit=False)) as wc:
            # the second short-circuit read is served by the cached fd
            for reader, lat in ((c, sc_ms), (wc, wire_ms), (c, sc_ms)):
                t1 = time.perf_counter()
                check(reader.read("/c/d") == d_bytes,
                      "CLIENT (b): /c/d != written")
                lat.append((time.perf_counter() - t1) * 1e3)
        check(_counter_of("client", "short_circuit_reads") - sc0 == 2,
              "CLIENT (b): the reads did not take the short circuit")
        loc = c._call("get_block_locations", path="/c/d")["blocks"][0]
        old = loc["block_id"]
        # the replica whose fd the client holds, behind its shm slot
        sock = next(x["sc_path"] for x in loc["locations"]
                    if (x["sc_path"], old) in c._sc_cache._fds)
        c.delete("/c/d")
        inv_s = _wait_for(lambda: all(d.replicas.get_meta(old) is None
                                      for d in dns),
                          "/c/d's replicas invalidated")
        rev0 = _counter_of("shortcircuit", "cached_fd_revoked")
        check(c._sc_cache.read(sock, old, 0, -1) is None
              and _counter_of("shortcircuit", "cached_fd_revoked") - rev0
              == 1, "CLIENT (b): a revoked fd served a read")
        new_bytes = corpus[0][:MIB].tobytes()   # other bytes, one MiB
        c.write("/c/d", new_bytes, scheme="direct")
        check(c.read("/c/d") == new_bytes,
              "CLIENT (b): the re-created /c/d read stale bytes")
        check_faults(faults0, "CLIENT (b)")
        out["b"] = {"seconds": time.perf_counter() - t0,
                    "write_ms": d_ms[0], "write_s_with_complete": d_write_s,
                    "write_host_cores_used": d_cores,
                    "write_phase_ms": _hop_phases([old], since),
                    "short_circuit_ms": sc_ms, "wire_ms": wire_ms,
                    "short_circuit_mib_s": _mib_s(bs, min(sc_ms)),
                    "wire_mib_s": _mib_s(bs, min(wire_ms)),
                    "invalidated_s": inv_s}
        print("CLIENT read " + json.dumps(out["b"]), flush=True)

        # ---- (c) the same bytes striped, then degraded ------------------
        t0 = time.perf_counter()
        faults0 = _dn_faults()
        rs0 = rs_cuda.launches
        t1 = time.perf_counter()
        c.write("/c/ec", a_bytes, ec=CLIENT_EC)
        ec_write_ms = (time.perf_counter() - t1) * 1e3
        enc = rs_cuda.launches - rs0
        check(enc > 0, "CLIENT (c): the EC write launched no rs kernel")
        t1 = time.perf_counter()
        check(c.read("/c/ec") == a_bytes, "CLIENT (c): /c/ec != written")
        ec_read_ms = (time.perf_counter() - t1) * 1e3
        ck_ec, ck_a = c.get_file_checksum("/c/ec"), \
            c.get_file_checksum("/c/a")
        check(ck_ec == ck_a, f"CLIENT (c): checksums {ck_ec} != {ck_a}")
        loc = c._call("get_block_locations", path="/c/ec")
        grp = loc["groups"][0]
        k, m, cell = rs.parse_policy(CLIENT_EC)
        # the card's encode: the parity the DataNodes store, against the
        # plain version of the cell layout of the same bytes
        data_sh = layout_shards(a_bytes, k, cell)
        stored = np.stack([np.frombuffer(dt.fetch_block(
            tuple(b["locations"][0]["addr"]), b["block_id"],
            token=b.get("token")), np.uint8) for b in grp["blocks"][k:]])
        enc_err = _plain_err(rs.rs_matrix(k, m)[k:], data_sh, stored)
        check(enc_err == 0, f"CLIENT (c): stored parity != the plain "
                            f"encode (max err {enc_err})")
        victim = tuple(grp["blocks"][1]["locations"][0]["addr"])
        mc.stop_datanode(next(i for i, d in enumerate(mc.datanodes)
                              if d is not None and tuple(d.addr) == victim))
        deg0 = _counter_of("client_ec", "ec_degraded_reads")
        rs1 = rs_cuda.launches
        decodes: list = []   # (survivors, want, the card's result)
        decode = rs.rs_decode

        def recorded(shards, k, m, want=None, device="cuda"):
            got = decode(shards, k, m, want=want, device=device)
            decodes.append((dict(shards), want, got))
            return got
        rs.rs_decode = recorded
        try:
            t1 = time.perf_counter()
            check(c.read("/c/ec") == a_bytes, "CLIENT (c): degraded read")
            deg_ms = (time.perf_counter() - t1) * 1e3
            check(c.read("/c/ec", offset=bs - 7, length=3 * MIB + 11)
                  == a_bytes[bs - 7:bs + 3 * MIB + 4],
                  "CLIENT (c): degraded ranged read")
        finally:
            rs.rs_decode = decode
        dec = rs_cuda.launches - rs1
        check(dec > 0 and len(decodes) == 2
              and _counter_of("client_ec", "ec_degraded_reads") > deg0,
              "CLIENT (c): the degraded reads decoded nothing")
        # the card's decodes against the plain version on the same shards
        dec_err = 0
        for have, want, got in decodes:
            surv = sorted(have)[:k]
            e = _plain_err(rs.repair_rows(k, m, tuple(surv), tuple(want)),
                           np.stack([have[i] for i in surv]),
                           np.stack([got[i] for i in want]))
            dec_err = max(dec_err, e)
            check(e == 0, f"CLIENT (c): the decode of {want} from {surv} "
                          f"!= plain (max err {e})")
        del data_sh, stored, decodes
        check_faults(faults0, "CLIENT (c)")
        out["c"] = {"seconds": time.perf_counter() - t0,
                    "write_ms": ec_write_ms, "read_ms": ec_read_ms,
                    "degraded_read_ms": deg_ms,
                    "write_mib_s": _mib_s(len(a_bytes), ec_write_ms),
                    "rs_launches_write": enc, "rs_launches_decode": dec,
                    "rs_max_abs_err": max(enc_err, dec_err),
                    "groups": len(loc["groups"])}
        print("CLIENT ec " + json.dumps(out["c"]), flush=True)
        out["launches"] = {"rs": rs_cuda.launches - rs0}
        out["max_abs_err"] = {"rs": max(enc_err, dec_err)}
        c.close()
        worker.close()
    finally:
        t0 = time.perf_counter()
        mc.stop()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
        stop_s = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"CLIENT done in {out['seconds']:.1f}s (cluster start "
          f"{start_s:.1f}s, stop {stop_s:.1f}s)", flush=True)
    return out


# ---------------------------------------------------------------- planes

PLANES_CHECK_MIB = 8     # the lanes' kernel-vs-plain block at each geometry
PLANES_MAX_BLOCKS = 6    # (b): fresh blocks written until two retunes
PLANES_RETUNES = 2
PLANES_ALIAS_BYTES = 8 * MIB
PLANES_BASELINE_S = 9.0  # flight samples (1 s) after the warm-up write
SCRUB_RATE_MB_S = 1024.0  # the smoke's scrub throttle (default 8 MB/s)


def native_lanes(a: np.ndarray, mask: int, mn: int) -> tuple[int, int]:
    """(H_SURV, H_CANDS) counted on the host over ``native_bits``: the
    candidates at ``pos1 >= skip_ahead_threshold(min)`` and the rows of
    512 positions holding one."""
    bits = native_bits(a, mask)
    bits[:gear.skip_ahead_threshold(mn) - 1] = False
    rows = np.zeros(-(-a.size // 512) * 512, dtype=bool)
    rows[:a.size] = bits
    return (int(rows.reshape(-1, 512).any(axis=1).sum()),
            int(bits.sum()))


def planes_sweep(args, dev) -> dict:
    """PLANES (a): one block of the ``reduce`` corpus through
    ``ResidentReducer`` on the card at each geometry the adaptive
    controller can emit; cuts and digests against the native oracle, the
    header lanes against the host count, and on the block's first
    ``PLANES_CHECK_MIB`` MiB the select kernel's table (lanes included)
    against its plain version."""
    from hdrf_tpu_torch.reduction import accounting
    from hdrf_tpu_torch.reduction.accounting import AdaptiveChunkController

    t_phase = time.perf_counter()
    blk = main_path_corpus(args.seed, 2, args.block_mib)[0]
    small = blk[:PLANES_CHECK_MIB * MIB]
    rows, err = [], 0
    _zero_launch_counts()
    reducers = {}   # one a geometry, kept as the worker keeps them
    for mb, mn, mx in AdaptiveChunkController().emit_range():
        torch.cuda.reset_peak_memory_stats(dev)
        cdc = CdcConfig(mask_bits=mb, min_chunk=mn, max_chunk=mx)
        mask = gear_mask(cdc)
        r = reducers[mb] = ResidentReducer(cdc, device=dev)
        acc0 = accounting.snapshot()["counters"]
        (cuts, digs), first_ms = timed(lambda: r.reduce(blk))
        acc1 = accounting.snapshot()["counters"]
        (cuts2, _), ms = timed(lambda: r.reduce(blk))
        want_cuts, want_digs = oracle(blk, cdc)
        check(np.array_equal(cuts, want_cuts)
              and np.array_equal(cuts2, want_cuts)
              and np.array_equal(digs, want_digs),
              f"PLANES sweep mb {mb}: cuts or digests != native")
        got = (acc1.get("cdc_scan_slab_survivors", 0)
               - acc0.get("cdc_scan_slab_survivors", 0),
               acc1.get("cdc_scan_candidates", 0)
               - acc0.get("cdc_scan_candidates", 0))
        want = native_lanes(blk, mask, mn)
        e = max(abs(got[0] - want[0]), abs(got[1] - want[1]))
        block, n = cdc_cuda.padded_block(small, dev)
        _, bm = cdc_cuda.cdc_scan(block, n, mask, mn)
        k = cdc_cuda.cdc_select(bm, n, mn, mx, 4)[0]
        p = cdc_cuda.cdc_select_plain(bm, n, mn, mx, 4)[0]
        nc = int(k[0])
        e = max(e, max_err(k[:8 + nc], p[:8 + nc]))
        check(e == 0, f"PLANES sweep mb {mb}: lanes {got} kernel table "
                      f"vs plain / host count {want}: max err {e}")
        err = max(err, e)
        lens = np.diff(cuts.astype(np.int64), prepend=0)
        b_small, _ = buckets_of(mask, mx)
        rows.append({"mask_bits": mb, "min_chunk": mn, "max_chunk": mx,
                     "chunks": int(cuts.size),
                     "small_lanes": int(((lens + 72) // 64 <= b_small)
                                        .sum()),
                     "longest": int(lens.max()), "first_ms": first_ms,
                     "ms": ms, "h_surv": got[0], "h_cands": got[1],
                     "peak_mib": torch.cuda.max_memory_allocated(dev) / MIB})
        del r, block, bm, k, p
    # what the cached reducers hold once their calls are done
    held_mib = torch.cuda.memory_allocated(dev) / MIB
    launches = _scheme_launch_counts()
    for kname in ("cdc_scan", "cdc_select", "gather_pad", "sha256"):
        check(launches[kname] > 0, f"PLANES sweep never launched {kname}")
    out = {"block_mib": args.block_mib, "geometries": rows,
           "reducers_cached": len(reducers), "held_mib": held_mib,
           "launches": {k: v for k, v in launches.items() if v},
           "surv_cands_max_abs_err": err,
           "seconds": time.perf_counter() - t_phase}
    print("PLANES sweep " + json.dumps(out), flush=True)
    torch.cuda.empty_cache()
    return out


def planes_scrub(nn, dns: dict, data: dict, owners: dict, addr) -> dict:
    """PLANES (c), on the NAMENODE phase's demoted cluster after its step
    (d): one scrub cycle a DataNode (stripes CRC'd, the any-k decode
    spot-check), then one byte flipped in a sealed container of a fresh
    file and one in an owner's stripe: the next cycle quarantines both,
    the container's block is reported ``bad_block`` and re-replicated,
    the stripe repaired in place by a decode on the card; every decode
    of the step is held against the plain version on the same shards and
    every block reads back equal."""
    from hdrf_tpu_torch.ops import rs
    from hdrf_tpu_torch.ops.dispatch import resolve_device
    from hdrf_tpu_torch.server.scrubber import QUAR_SUFFIX

    t_phase = time.perf_counter()
    scrub = metrics.registry("scrub")
    faults0 = _dn_faults()
    keys = ("scrub_cycles", "scrub_corrupt|class=container",
            "scrub_corrupt|class=stripe", "scrub_corrupt|class=replica",
            "scrub_repairs_triggered", "scrub_decode_checks",
            "scrub_decode_failures", "scrub_bytes_verified")

    def counts():
        return {k: scrub.counter(k) for k in keys}
    decodes: list = []
    real = rs._apply

    def spy(coeffs, shards, device):
        got = real(coeffs, shards, device)
        if resolve_device(device).type == "cuda":
            decodes.append(_plain_err(np.asarray(coeffs),
                                      rs._host_rows(shards).numpy(), got))
        return got

    def cycle(dn) -> tuple[dict, float]:
        c0 = scrub.counter("scrub_cycles")
        census, s = timed(dn.scrubber.run_cycle)
        check(scrub.counter("scrub_cycles") == c0 + 1,
              f"PLANES scrub: {dn.dn_id}'s cycle was vetoed")
        return census, s / 1e3
    rs._apply = spy
    try:
        for dn in dns.values():
            dn.config.scrub_rate_mb_s = SCRUB_RATE_MB_S
            # the block scanner verifies a replica every scan_interval_s
            # as well: slowed for this step, so that the scrubber is the
            # plane that finds the flipped container and quarantines it
            check(dn.reconfigure("scan_interval_s", 3600.0)["ok"],
                  "PLANES scrub: scan_interval_s not reconfigured")
        _nn_zero()
        c0 = counts()
        clean = {d: cycle(dn) for d, dn in sorted(dns.items())}
        c1 = counts()
        check(all(c1[k] == c0[k] for k in keys if "corrupt" in k),
              f"PLANES scrub: a clean cycle found corruption {c0} {c1}")
        check(c1["scrub_decode_checks"] > c0["scrub_decode_checks"],
              "PLANES scrub: no decode spot-check ran")
        clean_launches = _nn_counts()["rs"]

        # a fresh file whose first container seals (demotion now off)
        nn.config.ec_demote_after_s = 0.0
        fresh = np.random.default_rng(7).integers(
            0, 256, 2 * SEAL_BYTES + SEAL_BYTES // 2, dtype=np.uint8)
        bid = _nn_write_file(addr, "/nn/scrub", [fresh])["block_ids"][0]
        for dn in dns.values():
            dn.containers.drain_seals()
        victim = dns[_locations(nn, "/nn/scrub")[bid][-1]]

        def containers(b) -> set:
            e = victim.index.get_block(b)
            return {victim.index.chunk_location(h).container_id
                    for h in e.hashes} if e else set()
        others = set().union(*(containers(b) for b in
                               victim.index.block_ids() if b != bid))
        # a sealed container holding the fresh file's chunks alone: its
        # quarantine must cost no other block a replica
        cid = next(c for c in sorted(containers(bid) - others)
                   if victim.index.is_sealed(c)
                   and victim.index.stripe_manifest(c) is None)
        store = victim.volumes.volume_of_cid(cid).containers
        cpath = store._sealed_path(cid)
        victim.config.scrub_sample_frac = 1.0
        owner = next(dn for dn in dns.values()
                     if any(s[0] == dn.dn_id
                            for s in dn.ec.store.iter_stripes()))
        _, scid, sidx, _ = sorted(s for s in owner.ec.store.iter_stripes()
                                  if s[0] == owner.dn_id)[0]
        spath = os.path.join(owner.ec.store._dir,
                             f"{owner.dn_id}.{scid}.{sidx}.stripe")
        _nn_zero()
        bad0 = _nn_counter("corrupt_replicas_reported")
        c2 = counts()
        dirty = []     # each file's flip, then at once its holder's cycle
        for dn, path in ((victim, cpath), (owner, spath)):
            raw = bytearray(open(path, "rb").read())
            raw[len(raw) // 2] ^= 0xFF
            with open(path, "wb") as f:
                f.write(raw)
            with store._cache_lock:
                store._cache.clear()
            dirty.append((dn.dn_id, cycle(dn)[1]))
        c3 = counts()
        repair_launches = _nn_counts()["rs"]
        check(c3["scrub_corrupt|class=container"]
              > c2["scrub_corrupt|class=container"]
              and c3["scrub_corrupt|class=stripe"]
              > c2["scrub_corrupt|class=stripe"]
              and c3["scrub_repairs_triggered"]
              >= c2["scrub_repairs_triggered"] + 2,
              f"PLANES scrub: the flipped bytes were not found {c2} {c3}")
        check(os.path.exists(cpath + QUAR_SUFFIX)
              and os.path.exists(spath + QUAR_SUFFIX),
              "PLANES scrub: a corrupt file was not quarantined")
        check(os.path.exists(spath), "PLANES scrub: stripe not repaired")
        check(repair_launches > 0, "PLANES scrub: no rs launch")
        check(decodes and max(decodes) == 0,
              f"PLANES scrub: a decode != the plain version {decodes}")
        check(_nn_counter("corrupt_replicas_reported") > bad0,
              "PLANES scrub: no bad_block report reached the NameNode")
        def rereplicated():
            h = _locations(nn, "/nn/scrub")[bid]
            return len(h) == 3 and all(bid in dns[d].replicas.block_ids()
                                       for d in h)
        rerep_s = _wait_for(rereplicated,
                            "the quarantined block re-replicated")
        data = {**data, bid: fresh.tobytes()}
        _read_back(dns, {bid: _locations(nn, "/nn/scrub")[bid]}, data,
                   "PLANES scrub fresh")
        _read_back(dns, {b: [o] for b, o in owners.items()}, data,
                   "PLANES scrub demoted")
        check_faults(faults0, "PLANES scrub")
        na = nn._status.addr
        st, _, prom = _http("GET", f"http://{na[0]}:{na[1]}/prom")
        check(st == 200 and b'registry="namenode"' in prom,
              "PLANES: NameNode /prom")
        st, _, body = _http("GET", f"http://{na[0]}:{na[1]}/contention")
        check(st == 200 and "methods" in json.loads(body),
              "PLANES: NameNode /contention")
    finally:
        rs._apply = real
    out = {"cycle_s": {d: s for d, (_, s) in clean.items()},
           "census": {d: c for d, (c, _) in clean.items()},
           "clean": {k: c1[k] - c0[k] for k in keys},
           "clean_rs_launches": clean_launches,
           "dirty_cycle_s": dirty,
           "dirty": {k: c3[k] - c2[k] for k in keys},
           "rs_launches": repair_launches, "decodes": len(decodes),
           "decode_max_abs_err": max(decodes, default=0),
           "quarantined": [os.path.basename(cpath),
                           os.path.basename(spath)],
           "rereplicated_s": rerep_s,
           "seconds": time.perf_counter() - t_phase}
    print("PLANES scrub " + json.dumps(out), flush=True)
    return out


def _http(method: str, url: str, data: bytes | None = None):
    """(status, headers, body) of one request; a 307 is returned, not
    followed."""
    import urllib.error
    import urllib.request

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **kw):
            return None
    opener = urllib.request.build_opener(NoRedirect)
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with opener.open(req, timeout=600) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _wait_until(want, seconds: float) -> None:
    """Poll ``want`` for up to ``seconds`` (a condition that may not come)."""
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end and not want():
        time.sleep(0.1)


def planes_cluster(args) -> dict:
    """PLANES (b) and (d) on one port MiniCluster on ``cuda:0``: three
    DataNodes at replication 3 with ``cdc_adaptive`` and a status port,
    ``tpu_worker=True`` (the worker process owns the card), the port's
    HdrfClient on ``cuda``.  (b) Fresh random blocks until the
    controllers have coarsened twice: each block's chunks equal the
    native cuts at the geometry its primary held, the worker's ledger
    grows by ``resident.cdc`` dispatches at each geometry, every block
    (the first ones included) reads back equal; ``get_reconfigurable``
    and ``reconfigure`` replies; a retune applied by ``dfsadmin
    -reconfig`` and rolled back by the guard over an injected flight
    window.  (d) ``/prom`` and ``/timeseries`` of a DataNode, the
    gateway's ``/health``, a 128 MiB CREATE and OPEN through the two-step
    redirect, ``/traces?format=chrome``, and ``alias_add`` of a region
    under ``provided_mount_root`` read back through READ_BLOCK."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    from hdrf_tpu_torch.reduction import accounting
    from hdrf_tpu_torch.server.datanode import DataNode
    from hdrf_tpu_torch.server.http_gateway import HttpGateway
    from hdrf_tpu_torch.server.reduction_worker import WorkerClient
    from hdrf_tpu_torch.testing.minicluster import MiniCluster
    from hdrf_tpu_torch.tools import cli

    t_phase = time.perf_counter()
    bs = args.block_mib * MIB
    root = tempfile.mkdtemp(prefix="spl_")
    mount = os.path.join(root, "mount")
    os.makedirs(mount)
    mc = MiniCluster(n_datanodes=3, base_dir=root, replication=3,
                     block_size=bs, container_size=SEAL_BYTES,
                     heartbeat_s=1.0, dead_node_s=6.0, tpu_worker=True,
                     dn_config_overrides={"status_port": 0,
                                          "provided_mount_root": mount},
                     reduction_overrides={"cdc_adaptive": True})
    out: dict = {}
    try:
        mc.start()
        worker = WorkerClient(mc._worker_addr, deadline_s=600)
        check(worker.ping()["backend"] == "cuda",
              "PLANES: the worker does not run on the card")
        c = mc.client("smoke-planes")
        dns = [d for d in mc.datanodes if d is not None]
        by_id = {d.dn_id: d for d in dns}
        nn_arg = f"{mc.namenode.addr[0]}:{mc.namenode.addr[1]}"

        # ---- (b) adaptive retunes under fresh blocks ---------------------
        t0 = time.perf_counter()
        faults0 = _dn_faults()
        acc0 = accounting.snapshot()["counters"]
        rng = np.random.default_rng(args.seed + 13)
        written, blocks = [], {}

        def geometry(dn):
            g = dn.reduction_ctx.config.cdc
            return (g.mask_bits, g.min_chunk, g.max_chunk)
        # the first block is written with the controllers parked, and
        # the flight rings then fill with samples taken after it: a
        # retune's guard compares against a baseline of a cluster that
        # has written, not of an empty one (whose write p95 and storage
        # ratio read 0, so that any retune would look like a regression)
        ctls = {d.dn_id: d._cdc_controller for d in dns}
        for d in dns:
            d._cdc_controller = None
            # the process's earlier dedup counters are history: absorbed,
            # so that the controllers' first window is the first block's
            ctls[d.dn_id].observe(*accounting.dedup_counters(),
                                  geometry(d)[0])
            ctls[d.dn_id]._win_hit = ctls[d.dn_id]._win_miss = 0
        while len(written) < PLANES_MAX_BLOCKS:
            blk = rng.integers(0, 256, bs, dtype=np.uint8)
            path = f"/planes/b{len(written)}"
            before = {d.dn_id: geometry(d) for d in dns}
            cdc0 = sum(e["op"] == "resident.cdc"
                       for e in worker.traces()["ledger"])
            ms = _timed_write(c, path, [blk], scheme="dedup_lz4")
            _drain(dns)
            bid = c._call("get_block_locations",
                          path=path)["blocks"][0]["block_id"]
            locs = [loc["dn_id"] for loc in c._call(
                "get_block_locations", path=path)["blocks"][0]["locations"]]
            holder = by_id[locs[0]]
            entry = holder.index.get_block(bid)
            cuts = np.cumsum([holder.index.chunk_location(h).length
                              for h in entry.hashes], dtype=np.int64)
            # the primary cut at the geometry it held when the block came
            g = next((g for g in sorted(set(before.values()))
                      if np.array_equal(cuts, oracle(blk, CdcConfig(
                          mask_bits=g[0], min_chunk=g[1],
                          max_chunk=g[2]))[0].astype(np.int64))), None)
            check(g is not None, f"PLANES (b) {path}: chunks != native "
                                 f"cuts at the geometries {before}")
            lens = np.diff(cuts, prepend=0)
            cdc1 = sum(e["op"] == "resident.cdc"
                       for e in worker.traces()["ledger"])
            check(cdc1 > cdc0, f"PLANES (b) {path}: no resident.cdc "
                               "dispatch in the worker's ledger")
            blocks[path] = blk
            written.append({"path": path, "geometry": g, "ms": ms[0],
                            "chunks": int(lens.size)})
            if len({w["geometry"][0] for w in written}) > PLANES_RETUNES:
                break        # the last geometry written: no retune to wait
            if len(written) == 1:
                time.sleep(PLANES_BASELINE_S)
                for d in dns:
                    d._cdc_controller = ctls[d.dn_id]
            # the heartbeat ticks feed the controllers this block's
            # commits: a retune (three reconfigure steps) lands within a
            # tick or two, and its guard decides three samples later
            _wait_until(lambda: all(geometry(d) != before[d.dn_id]
                                    for d in dns), 4.0)
            _wait_until(lambda: all(d._cdc_guard is None for d in dns), 8.0)
        for d in dns:
            d._cdc_controller = None         # parked for the steps below
        acc1 = accounting.snapshot()["counters"]
        retunes = acc1.get("cdc_retunes__cdc_mask_bits", 0) - acc0.get(
            "cdc_retunes__cdc_mask_bits", 0)
        mbs = sorted({w["geometry"][0] for w in written})
        check(len(mbs) > PLANES_RETUNES and retunes >= PLANES_RETUNES,
              f"PLANES (b): blocks written at mask bits {mbs}, "
              f"{retunes} mask-bit retunes")
        read_ms = []
        for path, blk in blocks.items():
            t1 = time.perf_counter()
            check(c.read(path) == blk.tobytes(),
                  f"PLANES (b): {path} != written")
            read_ms.append((time.perf_counter() - t1) * 1e3)
        dn = dns[0]
        dn_arg = f"{dn.addr[0]}:{dn.addr[1]}"
        keys = cli._dn_call(dn_arg, "get_reconfigurable")["keys"]
        check(keys == sorted(DataNode.RECONFIGURABLE),
              f"PLANES (b): get_reconfigurable {keys}")
        bad = [cli._dn_call(dn_arg, "reconfigure", key=k, value=v)
               for k, v in (("cdc_mask_bits", 99),
                            ("cdc_min_chunk", 1 << 22),
                            ("data_dir", "/x"))]
        check(not any(r["ok"] for r in bad)
              and "outside" in bad[0]["error"]
              and "reorder" in bad[1]["error"]
              and "not reconfigurable" in bad[2]["error"],
              f"PLANES (b): reconfigure refusals {bad}")
        ctl = ctls[dn.dn_id]
        g0 = geometry(dn)
        new = g0[0] + 1 if g0[0] < ctl.MASK_BITS_MAX else g0[0] - 1
        for key, value in ctl.steps(g0[0], new):
            buf = io.StringIO()
            with redirect_stdout(buf):
                cli.main(["dfsadmin", "--namenode", nn_arg, "-reconfig",
                          dn_arg, key, str(value)])
            r = json.loads(buf.getvalue())
            check(r["ok"] and r["new"] == value,
                  f"PLANES (b): dfsadmin -reconfig {key} {value}: {r}")
        check(geometry(dn)[0] == new, "PLANES (b): -reconfig not applied")
        base = time.monotonic() + 1e6       # past every real sample
        rb0 = acc1.get("retune_rollbacks", 0)
        dn.flight._ring.extend({"t": base + i, "mono": base + i,
                                "write_p95_ms": 10.0} for i in range(8))
        dn._arm_cdc_guard(g0[0], new)
        dn.flight._ring.extend({"t": base + 10 + i, "mono": base + 10 + i,
                                "write_p95_ms": 30.0}
                               for i in range(dn.GUARD_MIN_SAMPLES))
        dn._cdc_guard_tick(ctl)
        rolled = accounting.snapshot()["counters"].get(
            "retune_rollbacks", 0) - rb0
        check(geometry(dn) == g0 and rolled == 1,
              f"PLANES (b): guard left {geometry(dn)} (was {g0}), "
              f"rollbacks {rolled}")
        check_faults(faults0, "PLANES adaptive")
        out["b"] = {"seconds": time.perf_counter() - t0,
                    "blocks": written, "mask_bits": mbs,
                    "mask_bit_retunes": retunes,
                    "cdc_retunes": acc1.get("cdc_retunes", 0)
                    - acc0.get("cdc_retunes", 0),
                    "guard_rollbacks_in_writes": acc1.get(
                        "retune_rollbacks", 0) - acc0.get(
                        "retune_rollbacks", 0),
                    "read_ms": read_ms, "guard_rolled_back": rolled,
                    "geometries_now": {d.dn_id: geometry(d) for d in dns}}
        print("PLANES adaptive " + json.dumps(out["b"]), flush=True)

        # ---- (d) the operator surface ------------------------------------
        t0 = time.perf_counter()
        faults0 = _dn_faults()
        sa = dns[1]._status.addr      # dns[0]'s ring holds the guard's
        st, _, prom = _http("GET", f"http://{sa[0]}:{sa[1]}/prom")
        check(st == 200 and b'registry="datanode"' in prom
              and b"hdrf_cdc_retunes_total" in prom,
              "PLANES (d): DataNode /prom")
        st, _, ts = _http("GET", f"http://{sa[0]}:{sa[1]}/timeseries")
        samples = json.loads(ts)["samples"]
        check(st == 200 and samples and "garbage_bytes" in samples[-1],
              "PLANES (d): DataNode /timeseries")
        gw = HttpGateway(mc.namenode.addr).start()
        try:
            base_url = f"http://{gw.addr[0]}:{gw.addr[1]}"
            st, _, body = _http("GET", base_url + "/health")
            health = json.loads(body)
            check(st == 200 and health["status"] in ("healthy", "degraded"),
                  f"PLANES (d): gateway /health {health}")
            payload = np.random.default_rng(args.seed + 17).integers(
                0, 256, bs, dtype=np.uint8).tobytes()
            url = f"{base_url}/webhdfs/v1/planes/gw?op=CREATE&scheme=dedup_lz4"
            st, hdrs, _ = _http("PUT", url)
            check(st == 307 and "step=2" in hdrs["Location"],
                  f"PLANES (d): CREATE step 1 answered {st}")
            t1 = time.perf_counter()
            st, _, _ = _http("PUT", hdrs["Location"], payload)
            create_s = time.perf_counter() - t1
            check(st == 201, f"PLANES (d): CREATE step 2 answered {st}")
            st, hdrs, body = _http("GET", base_url
                                   + "/webhdfs/v1/planes/gw?op=OPEN")
            t1 = time.perf_counter()
            if st == 307:
                st, _, body = _http("GET", hdrs["Location"])
            open_s = time.perf_counter() - t1
            check(st == 200 and body == payload,
                  "PLANES (d): OPEN != the bytes created")
            st, _, tr = _http("GET", base_url + "/traces?format=chrome")
            events = json.loads(tr)["traceEvents"]
            check(st == 200 and events, "PLANES (d): /traces?format=chrome")
        finally:
            gw.stop()
        region = np.random.default_rng(args.seed + 19).integers(
            0, 256, PLANES_ALIAS_BYTES, dtype=np.uint8).tobytes()
        src = os.path.join(mount, "region.bin")
        with open(src, "wb") as f:
            f.write(b"\0" * 4096 + region)
        alias_bid = (1 << 40) + 1
        r = cli._dn_call(dn_arg, "alias_add",
                         regions=[[alias_bid, "file://" + src, 4096,
                                   len(region)]], tokens=None)
        check(r == {"ok": True, "count": 1}, f"PLANES (d): alias_add {r}")
        outside = cli._dn_call(dn_arg, "alias_add", regions=[
            [alias_bid + 1, "file:///etc/hostname", 0, 4]], tokens=None)
        check(not outside["ok"], "PLANES (d): alias outside the mount")
        _, got = dn_read(dn.addr, alias_bid)
        check(got == region, "PLANES (d): the PROVIDED block != its file")
        check_faults(faults0, "PLANES operator surface")
        out["d"] = {"seconds": time.perf_counter() - t0,
                    "prom_bytes": len(prom), "timeseries": len(samples),
                    "health": health["status"],
                    "gateway_create_s": create_s,
                    "gateway_open_s": open_s,
                    "gateway_mib_s": {"create": bs / MIB / create_s,
                                      "open": bs / MIB / open_s},
                    "chrome_events": len(events),
                    "alias_bytes": len(region)}
        print("PLANES surface " + json.dumps(out["d"]), flush=True)
        c.close()
    finally:
        mc.stop()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------- resilience

RES_DATANODES = 3        # the federation cluster: two pools over three
# one replica a block, for the phase's 70 s budget: at replication 2 a
# write took 18-25 s and the phase 88-92 s on the H100 (the mirror leg)
RES_REPLICATION = 1
RES_SHADOW_S = 30.0      # the lazy writer's shadow, at most


class _Boom(Exception):
    """The fault the RESILIENCE phase injects."""


def _once(exc):
    """A fault_injection hook that raises ``exc`` at its first call."""
    fired: list = []

    def fire(**kw):
        if not fired:
            fired.append(kw)
            raise exc
    fire.fired = fired
    return fire


def _ledger_mark(worker) -> int:
    evs = worker.traces()["ledger"]
    return max((e["id"] for e in evs), default=0)


def _worker_dispatches(worker, since: int) -> dict:
    """The worker's device-ledger dispatches after event ``since``, by op:
    {op: [dispatches, blocks or containers]}."""
    out: dict = {}
    for e in worker.traces()["ledger"]:
        if e["id"] > since and e["kind"] == "dispatch":
            n = out.setdefault(e["op"], [0, 0])
            n[0] += 1
            n[1] += e["batch"]
    return out


def _worker_kernel_launches(worker) -> dict:
    """The worker process's kernel launch counters (its ``stats``)."""
    return worker.stats()["kernel_launches"]


def _launches_since(worker, before: dict) -> dict:
    return {k: n - before[k]
            for k, n in _worker_kernel_launches(worker).items()}


def resilience_federation(args, corpus, mc, worker) -> dict:
    """(a) Two nameservices over one DataNode set: one block a namespace,
    written at once by two clients and read back at once, pools
    disjoint, a full report cycle to both NameNodes invalidates
    nothing."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    faults0 = _dn_faults()
    inv0 = _counter_of("datanode", "blocks_invalidated")
    mark = _ledger_mark(worker)
    k0 = _worker_kernel_launches(worker)
    clients = [mc.client(f"smoke-ns{i}", nsi=i, device="cuda")
               for i in range(2)]
    try:
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(_timed_write, c, "/fed/f", [corpus[i]],
                              scheme="dedup_lz4")
                    for i, c in enumerate(clients)]
            ms = [f.result()[0] for f in futs]
        _drain([d for d in mc.datanodes if d is not None])
        disp = _worker_dispatches(worker, mark)

        def read(i: int) -> float:
            t1 = time.perf_counter()
            check(clients[i].read("/fed/f") == corpus[i].tobytes(),
                  f"RESILIENCE (a): ns{i}'s /fed/f != the bytes written")
            return (time.perf_counter() - t1) * 1e3
        with ThreadPoolExecutor(2) as ex:
            read_ms = list(ex.map(read, range(2)))
        pools = []
        for i, c in enumerate(clients):
            bids = [b["block_id"] for b in c._call(
                "get_block_locations", path="/fed/f")["blocks"]]
            check(len(bids) == 1 and all(b >> 48 == i for b in bids),
                  f"RESILIENCE (a): ns{i}'s block ids {bids} not in pool {i}")
        for i, ns in enumerate(mc.ns):
            pools.append(set(ns["active"]._blocks))
            check(all(b >> 48 == i for b in pools[-1]),
                  f"RESILIENCE (a): ns{i} maps a block of another pool")
        check(not pools[0] & pools[1], "RESILIENCE (a): pools overlap")
        locs = [_locations(ns["active"], "/fed/f") for ns in mc.ns]
        for dn in mc.datanodes:
            dn._send_block_report()
        time.sleep(1.5)     # a heartbeat: any invalidation is sent
        check(_counter_of("datanode", "blocks_invalidated") == inv0
              and [_locations(ns["active"], "/fed/f") for ns in mc.ns]
              == locs, "RESILIENCE (a): a full report cycle invalidated "
                       "a replica of the other pool")
        check_faults(faults0, "RESILIENCE (a)")
    finally:
        for c in clients:
            c.close()
    return {"seconds": time.perf_counter() - t0, "write_ms": ms,
            "read_ms": read_ms, "pools": [sorted(p) for p in pools],
            "replicas": [len(v) for loc in locs for v in loc.values()],
            "worker_dispatches": disp,
            "worker_launches": _launches_since(worker, k0)}


def resilience_lazy_persist(args, corpus, root, worker_addr, worker) -> dict:
    """(b) One DataNode with a RAM_DISK and a DISK volume sending its
    reduce and seals to (a)'s worker: a ``dedup_lz4`` block under the
    ``lazy_persist`` policy lands on the RAM volume (a 0-byte replica
    file: its chunks go to containers, never on RAM), the lazy writer
    shadows it onto DISK, the RAM is lost while the DataNode is down,
    and the restarted DataNode serves the block from its shadow."""
    import shutil

    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    t0 = time.perf_counter()
    faults0 = _dn_faults()
    mark = _ledger_mark(worker)
    k0 = _worker_kernel_launches(worker)
    bs = args.block_mib * MIB
    data = corpus[1].tobytes()
    mc = MiniCluster(n_datanodes=1, base_dir=root, replication=1,
                     block_size=bs, container_size=SEAL_BYTES,
                     heartbeat_s=1.0, dead_node_s=6.0,
                     volume_types=["RAM_DISK", "DISK"],
                     dn_config_overrides={"lazy_writer_interval_s": 0.2},
                     reduction_overrides={"worker_addr": list(worker_addr)})
    try:
        mc.start()
        dn = mc.datanodes[0]
        ram, disk = (next(v for v in dn.volumes.volumes
                          if (v.storage_type == "RAM_DISK") is want)
                     for want in (True, False))
        with mc.client("smoke-lazy", device="cuda") as c:
            c.mkdir("/hot")
            c.set_storage_policy("/hot", "lazy_persist")
            ms = _timed_write(c, "/hot/f", [corpus[1]], scheme="dedup_lz4")
            bid = c._call("get_block_locations",
                          path="/hot/f")["blocks"][0]["block_id"]
        check(ram.root.startswith("/dev/shm/")
              and ram.replicas.get_meta(bid) is not None
              and dn.volumes._where[bid] == ram.vol_id,
              "RESILIENCE (b): the lazy_persist block is not on the RAM "
              "volume")
        check(os.path.getsize(ram.replicas.data_path(bid)) == 0
              and not os.listdir(os.path.join(ram.root, "containers")),
              "RESILIENCE (b): reduced bytes on the RAM volume")
        shadow_s = _wait_for(lambda: disk.replicas.get_meta(bid) is not None,
                             "RESILIENCE (b): the disk shadow", RES_SHADOW_S)
        _drain([dn])
        disp = _worker_dispatches(worker, mark)
        mc.stop_datanode(0)
        shutil.rmtree(ram.root)                  # the RAM is lost
        dn = mc.restart_datanode(0)
        mc.wait_for_datanodes(1, timeout=30.0)
        check(dn.volumes._where.get(bid) == next(
                  v.vol_id for v in dn.volumes.volumes
                  if v.storage_type != "RAM_DISK"),
              "RESILIENCE (b): the restarted DataNode lost the shadow")
        with mc.client("smoke-lazy2", device="cuda") as c:
            t1 = time.perf_counter()
            got = None
            while got is None:
                try:
                    got = c.read("/hot/f")
                except OSError:
                    # until the restarted DataNode's report is in
                    check(time.perf_counter() - t1 < 30.0,
                          "RESILIENCE (b): no read after the RAM loss")
                    time.sleep(0.2)
            read_ms = (time.perf_counter() - t1) * 1e3
        check(got == data, "RESILIENCE (b): the block read after the RAM "
                           "loss != the bytes written")
        check_faults(faults0, "RESILIENCE (b)")
    finally:
        mc.stop()
    return {"seconds": time.perf_counter() - t0, "write_ms": ms[0],
            "shadow_s": shadow_s, "read_after_loss_ms": read_ms,
            "worker_dispatches": disp,
            "worker_launches": _launches_since(worker, k0)}


def resilience_scheme(args, corpus, root) -> dict:
    """(c) The in-process ``dedup_lz4`` scheme on the card (SCHEME's
    wiring): two blocks reduced; the seal of the open container crashed
    (``container.seal``) — its raw file survives and both blocks read
    back — then sealed by the retry; a WAL append crashed
    (``index.wal_append``) in a third block's commit — the index is left
    as it was — then committed by the retry; the index closed and
    reopened from its WAL and checkpoint: its blocks and refcounts equal
    the ones before, and every block reads back."""
    from hdrf_tpu_torch.index.chunk_index import ChunkIndex
    from hdrf_tpu_torch.utils import fault_injection

    t0 = time.perf_counter()
    payloads: dict = {}
    ctx = scheme_context(root, payloads)
    s = ops_scheme.get("dedup_lz4")
    datas = [b.tobytes() for b in corpus]
    store = ctx.containers

    def table() -> tuple:
        blocks = {bid: ctx.index.get_block(bid) for bid in range(3)}
        hashes = {h for e in blocks.values() if e is not None
                  for h in e.hashes}
        locs = ctx.index.lookup_chunks(sorted(hashes))
        return ({b: None if e is None else (e.logical_len, e.hashes)
                 for b, e in blocks.items()},
                {h: (v.container_id, v.offset, v.length, v.refcount)
                 for h, v in locs.items()})

    def read_all(n: int) -> None:
        for bid in range(n):
            check(s.reconstruct(bid, b"", len(datas[bid]), ctx, 0,
                                len(datas[bid])) == datas[bid],
                  f"RESILIENCE (c): block {bid} != the bytes written")

    try:
        _zero_launch_counts()
        for bid in range(2):
            check(s.reduce(bid, datas[bid], ctx) == b"",
                  f"RESILIENCE (c): block {bid}: stored bytes")
        open_cids = [cid for cid in store.container_ids()
                     if os.path.exists(store._raw_path(cid))]
        check(open_cids, "RESILIENCE (c): no open container to seal")
        seal = _once(_Boom())
        with fault_injection.inject("container.seal", seal):
            try:
                store.flush_open(on_seal=ctx.index.seal_container)
                check(False, "RESILIENCE (c): the injected seal crash "
                             "did not raise")
            except _Boom:
                pass
        check(seal.fired and all(os.path.exists(store._raw_path(c))
                                 and not os.path.exists(store._sealed_path(c))
                                 for c in open_cids),
              "RESILIENCE (c): the crashed seal lost its raw container "
              "or published a sealed file")
        read_all(2)
        store.flush_open(on_seal=ctx.index.seal_container)
        check(all(os.path.exists(store._sealed_path(c)) for c in open_cids),
              "RESILIENCE (c): the retried seal left a container unsealed")
        kinds = _check_sealed(ctx, payloads)
        before = table()
        wal = _once(OSError("injected: disk full"))
        with fault_injection.inject("index.wal_append", wal):
            try:
                s.reduce(2, datas[2], ctx)
                check(False, "RESILIENCE (c): the injected WAL append "
                             "crash did not raise")
            except OSError:
                pass
        check(wal.fired and table() == before,
              "RESILIENCE (c): the failed WAL append changed the index")
        check(s.reduce(2, datas[2], ctx) == b"",
              "RESILIENCE (c): block 2's retry: stored bytes")
        store.flush_open(on_seal=ctx.index.seal_container)
        launches = _scheme_launch_counts()
        after = table()
        check(after[0][2] is not None and all(
                  v[3] >= 1 for v in after[1].values()),
              "RESILIENCE (c): block 2 not committed by the retry")
        ctx.index.close()
        ctx.index = ChunkIndex(os.path.join(root, "index"))
        check(table() == after, "RESILIENCE (c): the reopened index != "
                                "the index before")
        read_all(3)
        for kname in ("cdc_scan", "cdc_select", "gather_pad", "sha256",
                      "be_image", "match_deltas", "sort_rows", "gather_raw"):
            check(launches[kname] > 0,
                  f"RESILIENCE (c): never launched the {kname} kernel")
    finally:
        ctx.read_plane.close()
        ctx.index.close()
    return {"seconds": time.perf_counter() - t0, "sealed": kinds,
            "chunks": len(after[1]), "launches": launches}


def resilience_phase(args) -> dict:
    """RESILIENCE: federation, lazy persist and the crash points on the
    card; (a) and (b) share one worker process."""
    import shutil
    import tempfile

    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    t_phase = time.perf_counter()
    corpus = main_path_corpus(args.seed, 3, args.block_mib)
    root = tempfile.mkdtemp(prefix="smr_")   # AF_UNIX paths: keep it short
    out: dict = {}
    mc = MiniCluster(n_datanodes=RES_DATANODES, base_dir=os.path.join(
                         root, "fed"),
                     replication=RES_REPLICATION,
                     block_size=args.block_mib * MIB,
                     container_size=SEAL_BYTES, heartbeat_s=1.0,
                     dead_node_s=6.0, nameservices=2, tpu_worker=True,
                     worker_backend="cuda")
    try:
        mc.start()
        worker = WorkerClient(mc._worker_addr, deadline_s=600)
        ping = worker.ping()
        check(ping["backend"] == "cuda",
              f"RESILIENCE: the worker runs on {ping}, not the card")
        out["a"] = resilience_federation(args, corpus, mc, worker)
        print("RESILIENCE federation " + json.dumps(out["a"]), flush=True)
        out["b"] = resilience_lazy_persist(
            args, corpus, os.path.join(root, "lazy"), mc._worker_addr,
            worker)
        print("RESILIENCE lazy_persist " + json.dumps(out["b"]), flush=True)
        worker.close()
    finally:
        mc.stop()
    try:
        out["c"] = resilience_scheme(args, corpus,
                                     os.path.join(root, "scheme"))
        print("RESILIENCE crash " + json.dumps(out["c"]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    worker_launches = {k: n + out["b"]["worker_launches"][k]
                       for k, n in out["a"]["worker_launches"].items()}
    for kname in ("cdc_scan", "cdc_select", "gather_pad", "sha256",
                  "be_image", "match_deltas", "sort_rows"):
        for part in ("a", "b"):
            check(out[part]["worker_launches"][kname] > 0,
                  f"RESILIENCE ({part}): the worker never launched the "
                  f"{kname} kernel")
    out["launches"] = {"worker": worker_launches,
                       "in_process": out["c"]["launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"RESILIENCE done in {out['seconds']:.1f}s (federation "
          f"{out['a']['seconds']:.1f}, lazy persist {out['b']['seconds']:.1f}"
          f", crash points {out['c']['seconds']:.1f})", flush=True)
    return out


# ----------------------------------------------------------------- bench

BENCH_MB = 128           # reduction and cdc: one HDFS block (PERF.md 1a-2)
BENCH_BUDGET_S = 120.0
BENCH_CDC = CdcConfig(mask_bits=13, min_chunk=2048)   # the cdc defaults
# (label, argv, lines the reference's docstring gives the harness on a card)
BENCH_RUNS = (
    ("reduction", ["reduction", "--mb", str(BENCH_MB), "--backend", "cuda"],
     1),
    ("cdc", ["cdc", "--mb", str(BENCH_MB), "--device", "cuda"], 1),
    ("sort", ["sort", "--device", "cuda"], 5),     # 2 legs x 2 + readback
    ("ec", ["ec", "--device", "cuda"], 1),
    ("ec --repair-ab", ["ec", "--repair-ab", "--device", "cuda"], 1),
    ("recon", ["recon", "--device", "cuda"], 3),   # host, device, kernel
    ("multichip", ["multichip", "--device", "cuda"], 1),
    ("dfs", ["dfs", "--mb", "16", "--device", "cuda"], 3),   # a scheme each
    ("dfs --pipeline-ab", ["dfs", "--pipeline-ab", "--rounds", "1",
                           "--mb", "16", "--backend", "cuda"], 1),
    ("nn", ["nn", "--ops", "200", "--device", "cuda"], 1),
    ("nn --observer-ab", ["nn", "--observer-ab", "--rounds", "1", "--ops",
                          "200", "--device", "cuda"], 1),
    ("nn --kill-active", ["nn", "--kill-active", "--duration", "3",
                          "--device", "cuda"], 1),
    ("churn", ["churn", "--device", "cuda"], 1),
)


def _bench_lines(argv: list) -> list:
    """``hdrf_tpu_torch.benchmarks.main(argv)`` in this process, its
    standard output captured: the JSON lines it printed."""
    import contextlib
    import io

    from hdrf_tpu_torch import benchmarks

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = benchmarks.main(list(argv))
    check(rc == 0, f"BENCH {argv}: exit {rc}")
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def _bench_oracle(label: str, lines: list, dev) -> None:
    """The harness's own oracle flags, and the facts the smoke recomputes
    from the harness's seed: the reduction's chunk count against the
    native library, the select's telemetry lanes against the plain scan
    of the same block."""
    o = lines[0]
    for x in lines:
        if "backend" in x and label != "dfs --pipeline-ab":
            check(x["backend"] == "cuda", f"BENCH {label}: ran on "
                  f"{x['backend']}")
    if label == "reduction":
        data = np.random.default_rng(3).integers(0, 256, size=BENCH_MB * MIB,
                                                 dtype=np.uint8)
        cdc = CdcConfig()
        want = native.cdc_select(native.gear_candidates(data, gear_mask(cdc)),
                                 data.size, cdc.min_chunk, cdc.max_chunk)
        check(o["op"] == "reduction pipeline [cuda]"
              and o["chunks"] == want.size,
              f"BENCH reduction: {o['chunks']} chunks, native {want.size}")
    elif label == "cdc":
        n = BENCH_MB * MIB
        rng = np.random.default_rng(17)
        a = rng.integers(0, 256, n, dtype=np.uint8)
        a[: n // 4] = rng.integers(97, 123, size=n // 4, dtype=np.uint8)
        block, _ = cdc_cuda.padded_block(a, dev)
        _, bitmap = cdc_cuda.cdc_scan_plain(block, n, gear_mask(BENCH_CDC),
                                            BENCH_CDC.min_chunk)
        surv, cands = cdc_cuda.scan_telemetry_plain(bitmap)
        check(o["cuts_verified"] is True and o["interpret"] is False,
              f"BENCH cdc: {o}")
        check((o["scan_slab_survivors"], o["scan_candidates"])
              == (surv, cands), f"BENCH cdc: lanes {o['scan_slab_survivors']}"
              f" / {o['scan_candidates']}, plain {surv} / {cands}")
    elif label == "sort":
        check([x["op"] for x in lines] == [
            "match_deltas [plain]", "match_deltas [cuda]",
            "sort_rows [plain]", "sort_rows [cuda]", "record readback"],
            f"BENCH sort: {[x['op'] for x in lines]}")
    elif label == "ec":
        check(o["parity_oracle_ok"] is True and o["storage_ratio"] == 1.5,
              f"BENCH ec: {o}")
    elif label == "ec --repair-ab":
        check(o["parity_oracle_ok"] is True and o["patterns_pinned"] == 129,
              f"BENCH ec --repair-ab: {o}")
    elif label == "multichip":
        check(o["oracle_ok"] is True and o["one_dispatch_per_step"] is True,
              f"BENCH multichip: {o}")
    elif label in ("nn", "nn --observer-ab"):
        check(o["errors"] == 0, f"BENCH {label}: {o['errors']} errors")
    elif label == "nn --kill-active":
        check(o["stale_beyond_bound"] == 0 and o["reads"] > 0,
              f"BENCH {label}: {o}")


def _all_launch_counts() -> dict:
    from hdrf_tpu_torch.ops import rs_cuda

    return {**_scheme_launch_counts(), "rs": rs_cuda.launches,
            "shard_scan": cdc_cuda.shard_scan_launches}


def _zero_all_launch_counts() -> None:
    from hdrf_tpu_torch.ops import rs_cuda

    _zero_launch_counts()
    rs_cuda.launches = cdc_cuda.shard_scan_launches = 0


def bench_phase(dev) -> dict:
    """BENCH: every harness of ``hdrf_tpu_torch.benchmarks`` once on the
    card, in this process: its lines (``BENCH <which> <line>``), their
    count, its oracle flags, and each kernel's launches over the phase
    (every kernel but the shard scan, which no ('data', 1) mesh runs)."""
    t_phase = time.perf_counter()
    _zero_all_launch_counts()
    out: dict = {"seconds_by_harness": {}}
    for label, argv, nlines in BENCH_RUNS:
        t0 = time.perf_counter()
        lines = _bench_lines(argv)
        out["seconds_by_harness"][label] = round(time.perf_counter() - t0, 1)
        for ln in lines:
            print(f"BENCH {label} {json.dumps(ln)}", flush=True)
        check(len(lines) == nlines,
              f"BENCH {label}: {len(lines)} lines, expected {nlines}")
        _bench_oracle(label, lines, dev)
        torch.cuda.empty_cache()
    out["launches"] = _all_launch_counts()
    for kname, n in out["launches"].items():
        check(n > 0 or kname == "shard_scan",
              f"BENCH launched no {kname} kernel")
    out["seconds"] = time.perf_counter() - t_phase
    print("BENCH launches " + json.dumps(out["launches"]), flush=True)
    print("BENCH seconds " + json.dumps(out["seconds_by_harness"]),
          flush=True)
    print(f"BENCH done in {out['seconds']:.1f}s", flush=True)
    check(out["seconds"] <= BENCH_BUDGET_S,
          f"BENCH took {out['seconds']:.1f}s, over {BENCH_BUDGET_S:.0f}s")
    return out


def print_timing(timing: dict) -> None:
    for kname, t in timing.items():
        print(f"TIMING {kname}: kernel_ms={t['ms']:.4f} "
              f"plain_ms={t['plain_ms']:.2f} library_ms={t['library_ms']} "
              f"bound_ms={t['bound'][0]:.4f} ({t['bound'][1]})", flush=True)


def _kernel_name(mangled: str) -> str:
    """``rs_apply_kernel<6>`` of an Itanium-mangled kernel name: its last
    name and its first template argument, if an integer or a bool."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    names, i = [], 0
    while (m := re.match(r"\d+", s[i:])):
        n, i = int(m.group()), i + m.end()
        names.append(s[i:i + n])
        i += n
    if not names:
        return mangled
    t = re.match(r"IL[a-z](\d+)E", s[i:])
    return f"{names[-1]}<{t.group(1)}>" if t else names[-1]


def ptxas_report(log: str) -> list[str]:
    """One entry a kernel of nvcc's ``-Xptxas -v`` log (``== source``
    lines between files): its name, registers, and its stack frame and
    spill stores/loads in bytes where it has any."""
    rows, name, spill = [], "", ""
    for ln in log.splitlines():
        if ln.startswith("=="):
            rows.append(ln.strip())
        elif m := re.search(r"Compiling entry function '(\S+)'", ln):
            name, spill = _kernel_name(m.group(1)), ""
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                             r"stores, (\d+) bytes spill loads", ln)) \
                and any(map(int, m.groups())):
            spill = " stack {} spill {}/{}".format(*m.groups())
        elif m := re.search(r"Used (\d+) registers", ln):
            rows.append(f"{name} {m.group(1)} regs{spill}")
    return rows


def run(args) -> int:
    t_start = time.perf_counter()
    info = probe()
    print("PROBE " + json.dumps(info), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    _build.library()
    print(f"BUILD {time.perf_counter() - t0:.1f}s " + " | ".join(
        ptxas_report(_build.BUILD_LOG.read_text())), flush=True)
    warmup_probe(t_start)

    errs = {k: 0 for k in KERNELS}
    for name, a, mask, mn, mx in standard_corpora():
        c = cdc_phase(name, a, mask, mn, mx, dev, errs)
        lane_phase(name, a, c, mask, mx, dev, errs)
        print(f"KERNELS {name}: {a.size} bytes, {int(c.sel[0][0])} chunks, "
              f"identical", flush=True)
    cdc = CdcConfig()
    mask, mn, mx = gear_mask(cdc), cdc.min_chunk, cdc.max_chunk
    chain = sha256_cuda.chain_probe(dev)
    print("SHA chain probe " + json.dumps(chain), flush=True)
    timing: dict = {}
    for name, a in big_blocks(args.seed, args.block_mib * MIB, mask):
        c = cdc_phase(name, a, mask, mn, mx, dev, errs)
        row = time_select(name, c, mn, mx)
        scan = time_scan(name, c, mask, mn)
        if name == "random-block":
            timing["cdc_scan"] = {"ms": scan["ms"],
                                  "plain_ms": c.scan_plain_ms,
                                  "library_ms": None,
                                  "bound": (scan["bound_ms"],
                                            scan["bound_by"])}
            time_image(name, c.block)
            timing["cdc_select"] = {"ms": row["ms"],
                                    "plain_ms": c.select_plain_ms,
                                    "library_ms": None,
                                    "bound": (row["bound_ms"],
                                              row["bound_by"])}
        if name in ("random-block", "zeros-block"):
            lane_phase(name, a, c, mask, mx, dev, errs,
                       timing if name == "random-block" else None)
        if name in SHA_TIMED:
            srow = time_sha(name, a, c, mask, mx, chain)
            if name == "random-block":
                timing["sha256"]["ms"] = srow["grouped_ms"]
                timing["sha256"]["bound"] = bound(
                    64 * srow["blocks"] + 36 * sum(srow["lanes"]),
                    SHA_OPS_PER_BLOCK * srow["blocks"])
        print(f"KERNELS {name}: {a.size} bytes, {row['cuts']} chunks, "
              f"identical", flush=True)
        del a, c
    torch.cuda.empty_cache()
    print_timing(timing)

    mp, chunks = main_path(args, dev, cdc)
    corpora = seal_corpora(args.seed, chunks)
    del chunks
    seal_timing: dict = {}
    records = seal_kernel_phase(corpora, dev, errs, seal_timing)
    print_timing(seal_timing)
    timing.update(seal_timing)
    with child_pool() as pool:
        sp = seal_main_path(corpora, records, pool)
        ms = mesh_phase(args, dev, cdc, corpora, errs, timing)
        torch.cuda.empty_cache()
        sc = scheme_phase(args, dev, cdc, errs, timing)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        bad = sp.pop("twin").result()
        print(f"SEAL twin: {len(bad)} of {len(SEAL_SINGLES)} singles, "
              f"{len(SEAL_BATCHES)} batches and {len(SEAL_PROFILED)} "
              f"profiled seals differ from the CPU engine's streams "
              f"(waited {time.perf_counter() - t0:.1f}s)", flush=True)
    check(not bad, f"card streams != CPU engine streams: {bad}")
    datanode_phase(args)
    with DnCommandLog():
        nm = namenode_phase(args, after_demotion=planes_scrub)
    # PLANES (b)/(d), then RESILIENCE, each on clusters of its own in a
    # child process, beside CLIENT and the sweep here; BENCH runs alone
    print("CLIENT and the PLANES sweep run beside PLANES (b)/(d) and then "
          "RESILIENCE in a child process: their times are taken under "
          "that load", flush=True)
    with child_pool(card=True) as pool:
        pc = pool.submit(planes_cluster, args)
        res = pool.submit(resilience_phase, args)
        cl = client_phase(args)
        sw = planes_sweep(args, dev)
        t0 = time.perf_counter()
        pc, res = pc.result(), res.result()
        print(f"waited {time.perf_counter() - t0:.1f}s for the child "
              f"process's phases", flush=True)
    scrub_s = nm["after_demotion"]["seconds"]
    print(f"PLANES done in {scrub_s + sw['seconds'] + pc['seconds']:.1f}"
          f"s (scrub {scrub_s:.1f}, sweep {sw['seconds']:.1f}, cluster "
          f"{pc['seconds']:.1f})", flush=True)
    bn = bench_phase(dev)
    warmup_probe(t_start)
    launches = {**mp["launches"], **sp["launches"],
                "shard_scan": ms["reduce"]["launches"]["shard_scan"],
                **sc["launches"]}

    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        t = timing[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[kname],
                        "max_abs_err": errs[kname], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                        "bound_by": t["bound"][1],
                        "library_ms": t["library_ms"]})
        if kname == "cdc_select":
            # the adaptive geometry sweep: its lanes' error and launches
            kernels[-1]["surv_cands_max_abs_err"] = \
                sw["surv_cands_max_abs_err"]
            kernels[-1]["sweep_launches"] = sw["launches"]
        if kname == "rs":
            # the scrubber's decodes (PLANES (c)) on the NAMENODE cluster
            kernels[-1]["scrub_launches"] = \
                nm["after_demotion"]["rs_launches"]
            kernels[-1]["scrub_max_abs_err"] = \
                nm["after_demotion"]["decode_max_abs_err"]
        kernels[-1]["resilience_launches"] = \
            res["launches"]["in_process"].get(kname, 0)
        kernels[-1]["resilience_worker_launches"] = \
            res["launches"]["worker"].get(kname, 0)
        kernels[-1]["bench_launches"] = bn["launches"][kname]
        if kname in cl["launches"]:
            # the client's own path: its launches and its error there
            kernels[-1]["client_launches"] = cl["launches"][kname]
            kernels[-1]["client_max_abs_err"] = cl["max_abs_err"][kname]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"SECONDS {time.perf_counter() - t_start:.1f}", flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chip_smoke")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--block-mib", type=int, default=128)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    try:
        return run(args)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
