#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``curvine_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, each raising on a fault (the exit code is then non-zero):

1. build: compile every source of the port, all at once: the CUDA ones
   with ``nvcc`` (sm_90a), the host C++ ones (crc32c, the GF(256) loop
   of the erasure codec, the native engine of the master's KV metadata
   store) with ``c++``; each
   kernel's registers, spills and stack as ptxas reports them;
2. kernel: ``block_checksum`` on the card against its plain PyTorch
   version and the host hash at sizes from 1 byte to 64 MiB + 1, a bit
   flip and a word swap; its time at 64 MiB (CUDA events, median of 20,
   L2 flushed between launches) beside its bound and the plain version;
3. main path: 96 distinct 64 MiB blocks in the worker's on-disk layout,
   promoted with ``promote_block`` (media crc, device copy, kernel hash
   against host hash) into a 4 GiB S3-FIFO ``MultiHbmTier``: a hot set
   of 16 touched 3 times, then a one-touch scan of 80. Checks that every
   pin was verified by the kernel, that the tier spilled, that the hot
   set survived the scan, and that a corrupted device copy is caught and
   dropped. Measures mmap views → tier against a pinned 128 MiB buffer
   → device, interleaved;
4. feed: 8 int32 token shards of 64 MiB, files under a POSIX directory,
   through ``PosixTrainFeed`` at batch 32 x seq 8192, depth 2, over the
   whole epoch; every device batch must equal the host tokens;
4b. client: a cache of the port's master, started as its own process
   (``python -m curvine_tpu_torch.master``: a journal under the data
   directory and its namespace in the KV metadata store beside it, on
   the native engine, as every master of the run; this process's user as
   its superuser; it must load no module of JAX or of the JAX package),
   and the port's own worker
   (``curvine_tpu_torch.worker.server.WorkerServer``, in this process on a
   thread with its own event loop: a mem tier on the same tmpfs, a 4 GiB
   device tier-0, 64 MiB blocks), which must be the master's only live
   worker, here and at the end of the run; every later phase's cluster
   traffic goes through it. 8 new shards of 64 MiB written through the
   port's ``CurvineClient`` (``write_token_shards``, one block each) and
   streamed through the client-backed ``GpuTrainFeed`` (short-circuit
   ``mmap_view``, prefetch advice to the master, which plans prefetch
   jobs whose tasks cost the port's worker one probe each: the shards
   are cached) at phase 4's batch;
   every device batch must equal the host tokens, and some bytes must
   come by short circuit; rates beside phase 4's, stage shares, bytes by
   each path, advise RPCs, write GiB/s (by short circuit); then one
   shard read twice through READ_BLOCK (received into the caller's
   buffer) with the short circuit off, byte-equal; then the shards are
   deleted;
4c. worker: the device tier-0 through the port's worker: 16 hot and 16
   cold files of one 64 MiB block written through the port's client by
   short circuit, one more with a byte of its block file flipped after
   the commit. Until the hot set is pinned, the hot set is read once
   through the client (its read-heat reports) and one promote cycle runs
   (at most 256 MiB a cycle, each pin verified by K1 on the card): 4
   cycles, 16 pins, every hot block and no cold one in the tier, K1
   launches equal to the pins, the corrupt block refused, counted and
   reported to the master; a cold block whose device copy is flipped after
   its H2D copy refused by K1 (one launch), counted and reported; autopin
   GiB/s beside phase 3's and each pin's split (map, media crc, host
   hash, H2D, K1); every pinned tensor equal to its file on the card; a
   tier-0 hit (``hbm_get`` and a device-to-device copy of the block)
   against the short-circuit read staged to the card, median of 16; HBM_PIN and
   HBM_UNPIN over the port's connection, the master's view of one
   ``hbm:0`` of 4 GiB between; a deleted file's device copy gone within
   10 heartbeats;
5. flash: the four K3 kernels (forward, di, dK/dV, dQ) on the card against
   their plain PyTorch versions, element by element and row by row
   (``flash_errors``), at the flagship's attention shape
   [16, 20, 1024, 128] bf16, causal, at phase pipeline's microbatch
   [8, 20, 1024, 128], and at [1, 2, 128, 128], [2, 4, 2048, 128] and
   [3, 5, 384, 128]; each kernel's time at the
   flagship's shape (CUDA events, median of 20, L2 flushed) beside its
   bound, the plain version's and ``scaled_dot_product_attention``'s
   (di's: ``torch.linalg.vecdot(o, do)``, the library's formula; each a
   yardstick only);
6. train: the flagship 1.03 B-parameter transformer (bench.py's: vocab
   32,000, d_model 2560, 20 heads, 12 layers, d_ff 10,240, bf16, flash
   attention, chunked cross entropy) on one card at batch 16 x seq 1024:
   a cache-fed pass through the client-backed ``GpuTrainFeed`` from the
   same cluster (10 shards of one batch under ``/ds/train``; the next
   batch's fetch overlaps the step, one sync a step) and a synthetic
   pass on one fixed device tensor; step times,
   ``ingest_overlap_ratio``, tokens/s, MFU, peak memory, every loss,
   K3's share of the step; a profiler table of
   two steps; at batch 2 the loss and every gradient of the kernel path
   against the same model with its attention taken by the plain
   versions, and each layer's dQ, dK and dV against f64 dense
   attention; last, a float32 model at head_dim 128 with flash attention
   asked for, one layer forward at L 128: the gate admits it as the
   reference's does, and the kernels' argument check must refuse it
   before any launch (they take bf16 only), never dense in its place;
6a. ufs: a dataset in a ``file://`` under-store (8 token shards of 64
   MiB under ``<data dir>/ufs/train``, ids below the flagship's vocab,
   and 4 more under ``ufs/next``), mounted read-only (``/ufs/train``,
   ``/ufs/next``; ``/ufs/out`` rw) through the port's client; before any
   load LIST_STATUS gives the 8 names in state UFS, FILE_STATUS and
   EXISTS answer for an uncached shard, a user's CREATE_FILE is refused
   by the read-only guard, and ``read_all`` of an uncached shard equals
   its file and leaves no cached copy. SUBMIT_JOB ``load`` of
   ``/ufs/train``, polled until COMPLETED: 8 tasks, each COMPLETED on the
   port's worker (SUBMIT_TASK), every shard's block located there and
   equal to its file; the load's GiB/s, time to the first task and a
   task's split (UFS read, cache write). The loaded blocks read up to
   ``WORKER_MIN_READS`` and pinned by promote cycles, each pin verified
   by K1 (launches equal to the pins). ``GpuTrainFeed`` over the loaded
   dataset at phase 4's batch with a prefetch window of 4 (its advice
   now served: the prefetch jobs and their tasks counted, none failed),
   beside phase client's rates; then three flagship steps with phase 6's
   parameters and AdamW at batch 16 x 1024 on the loaded tokens (each
   batch equal to the under-store's tokens in the epoch order, finite
   losses, K3's four kernels 36 launches each). PREFETCH_WINDOW on the
   uncached ``/ufs/next`` (cursor 0, window 4): its 4 shards cached in
   the epoch order, each task's ``loaded_len`` 64 MiB; one 64 MiB file
   under ``/ufs/out`` exported by SUBMIT_JOB ``export``, the ``file://``
   object byte-equal. Last the phase's cached files are deleted (their
   device copies gone), ``/ufs/next`` unmounted and the under-store
   removed; the mounts and job records stay for phase 8;
6g. drain: a worker decommissioned under a running feed, with phase
   ufs's parameters and step: a master of the phase's own (``ici``
   placement, a lost timeout of 3 s) and three of the port's workers in
   this process, A, B and C at ICI (0..2, 0), each with a mem tier and a
   640 MiB tier-0 on the card. (a) 8 token shards of 64 MiB written to
   ``/drain/train`` at two replicas from (0, 0): every block on A and C.
   (b) ``GpuTrainFeed`` over them at phase 4's batch, epoch after epoch;
   4 batches in, DECOMMISSION_WORKER of A (DECOMMISSIONING); while A
   drains, every batch equal to its tokens and no read raising, a
   WRITE_BLOCK to A refused with ``WorkerDraining`` once its heartbeat
   carried the flag, and a small file written at two replicas placed on
   B and C; A DECOMMISSIONED within 60 s, the feed one more epoch after;
   every block then on B and C, none located on A, and A's full block
   report bringing none back; the drain's seconds and GiB/s, B's pulls
   by the ``ici`` hint and by TCP, the feed's batches/s beside phase
   client's. (c) The moved blocks read from B (the reading client's
   board holds C's breaker open) and pinned by B's promote cycles, K1
   verifying each pin (launches equal to the 8 pins), each device copy
   equal to its tokens; three flagship steps on batches fed from
   ``/drain/train``, each equal to its tokens, finite losses, K3's four
   kernels once a layer a step. (d) A recommissioned (LIVE) and a new
   file placed on A and C; A decommissioned again and the phase's master
   restarted on its journal: A DECOMMISSIONING, told to drain;
6h. ec: erasure coding, with phase ufs's parameters and step: a master
   of the phase's own (the ``local`` placement, a lost timeout of 3 s)
   and four of the port's workers in this process, A to D, each with a
   mem tier and a 320 MiB tier-0 on the card. (a) 8 token shards of 64
   MiB written to ``/ec/train`` at two replicas. (b) SET_ATTR's ``ec``
   (rs-2-1) and an ``ec_convert`` job: COMPLETED, every block striped
   into three 32 MiB cells on three distinct workers with its replicas
   retired, within 60 s; the conversion's seconds and GiB/s, a stripe's
   pull, encode, placement and commit, and the port's codec on the host
   (64 MiB at rs-2-1 and rs-6-3, native and table, bit-exact). (c) One
   epoch of ``GpuTrainFeed`` at phase 4's batch over the stripes: every
   batch equal to its tokens, no degraded read. (d) The holder of block
   0's cell 0 stopped; one epoch, every batch equal to its tokens,
   degraded reads counted. (e) Every cell back on a live holder within
   60 s of the stop; one epoch with no degraded read. (f) The rebuilt
   cells read twice through the client and pinned by their holders'
   promote cycles, K1 verifying each pin (launches equal to the pins),
   each device copy equal to the port's encoding of its shard; three
   flagship steps on batches fed from the stripes, each equal to its
   tokens, finite losses, K3's four kernels once a layer a step. (g)
   ``/ec/train`` deleted: no block left in the master, none in the
   workers' stores after their heartbeats; the master's
   ``ec.stripes_committed`` (8), ``ec.degraded_reads`` and
   ``replication.reconstructs`` read after its stop;
6i. kv: the master's KV metadata store, with phase ufs's parameters and
   step. (a) 200,000 files in 200 directories (1,000,000 took 184 s to
   create on the card's host) through ``MasterFilesystem`` over
   ``KvMetaStore`` (the native engine, an inode cache of 4,096) in this
   process:
   creates/s, the resident set's growth at 100,000 files and at 200,000
   (at most 120 MB), a checkpoint and a restart at each, the last in
   under 5 s with the same inode count, a stat and a listing of 1,000;
   the same directory reopened on the Python engine (the same count,
   1,000 seeded statuses equal); beside it the same files on the mem
   store (growth, snapshot, restart). (b) A master of the phase's
   own and two of the port's workers; 8 token shards of 64 MiB written at
   one replica while a second client writes 4 KiB files, the master
   killed (SIGKILL) after the 4th shard's commit and started again on its
   journal and KV directory: no caller error (the clients' retries),
   every acknowledged create and complete there; the restart's seconds,
   ``applied_seq`` against the journal's seq, the tail replayed, the
   seconds until the writers move. (c) One epoch of ``GpuTrainFeed`` over
   the shards, every batch equal to its tokens; the shards pinned by the
   promote cycles (K1 launches equal to the pins); three flagship steps
   on batches taken from the pinned copies (K3 once a layer a step);
6j. ha: raft HA of the master, with phase ufs's parameters and step.
   (a) Three of the port's masters in their own processes, one raft
   group (``raft_peers``), each with its journal and KV directory, and
   two of the port's workers that heartbeat all three (and report their
   blocks in full every second, so that a follower knows each replica):
   the seconds to one leader. (b) Phase kv (b)'s writers, the leader
   SIGKILLed after the 4th shard: the seconds to a new leader and until
   each writer's next acknowledgement, no caller error, every
   acknowledged file on the new leader, the survivors equal; the killed
   master started again and caught up. (c) A round at 9 and three at 36
   8 MiB xattrs (72 and 288 MiB, past MAX_FRAME): a follower stopped and
   wiped, the pads set, leadership handed to the other follower
   (RAFT_TRANSFER), the wiped node started again and caught up by a
   chunked snapshot; each round's chunks, the cut's seconds on the
   leader's loop and the drain, build and pack's in a forked child, the
   leader's longest loop stall, the wiped node's install on its thread,
   its swap and its longest loop stall (either stall at 300 ms, half the
   least election timeout, or a cut of 5 ms on the loop fails the
   phase), and whether an election followed. (d) ``GpuTrainFeed`` over the shards through a second
   RAFT_TRANSFER 4 batches in, every batch equal to its tokens. (e) The
   shards and the small files pinned (K1 launches equal to the pins),
   three flagship steps on the pinned copy (K3);
6k. shm: the shared-memory read plane, with phase ufs's parameters and
   step: a master of the phase's own (``ici`` placement) and three of
   the port's workers, F with ``shm_reads`` off, S with it on and a
   tier-0, W on an SSD tier with a warm cache; phase feed's shape
   written to each. (a) ``GpuTrainFeed`` over F's shards (the fd path)
   and S's (the sealed memfds' mappings), interleaved twice: GiB/s into
   device memory, batches/s and ``cache_fetch`` split into the probe,
   the map and the copy, beside phase 3's ``link_gibs``; through shm a
   hit a block and no fallback. (b) W's shards fed by the fd path, read
   until they are warm, fed again: a warm hit a block, the warm cache's
   stats. (d) S's blocks pinned (K1), three flagship steps fed from the
   mappings (K3). (c) A block deleted under a reader's view: the view
   stays equal. A side channel that did not start fails the phase; any
   phase whose reads fell back from a mapping fails the run (each
   phase's shm counters are logged);
6l. wire: the wire transport (every RPC of the run rides it) and the
   reader's read-ahead, with phase ufs's parameters and step: a master
   of the phase's own (the robin placement) and two of the port's
   workers, A and B, with a tier-0 each; phase feed's shape written with
   its blocks alternating between them, and read with the short circuit
   off. (b) The shards into device memory through the pinned staging
   ring by ``read_all``, by ``pread_view`` in 4 MiB steps behind a
   prefetch window of 4 segments and by ``read_range`` in 4 slices:
   GiB/s beside phase 3's ``link_gibs``, the seconds awaiting reads and
   staging, ``pf.bytes.read`` (above 0 through the window, 0 for
   ``read_all``), ``read.zero_copy_bytes`` and the registered pool's
   stats; every shard equal to its tokens on the card. (c) Positional
   reads of one shard flipping between sequential runs and random
   probes, each equal, ``detector.sequential`` after each run. (d) The
   shards pinned (K1, launches equal to the pins), three flagship steps
   on batches read by ``pread_view`` through the window (K3). (a)
   Behind streams: 4 tasks read shards whole while 64 callers read 4 KiB
   at random offsets of the others over the same pool, 3 s at the
   defaults and 3 s at ``send_coalesce_frames = 1``: small reads/s,
   p50, p99, the streams' GiB/s and the workers' frames a send (their
   replies queue behind ``sendfile`` chunks). Then 64 callers of
   GET_FILE_STATUS and GET_BLOCK_LOCATIONS for 5 s against the master
   restarted on its journal, at the defaults and at one frame a send,
   in turns: calls/s, p50, p99, the master's frames a send and its
   dispatch split into the reply's send and the rest (its
   ``--metrics-out`` dump). A byte of (a)-(d) by the short circuit or
   shm, a pass's bytes unequal, or a writer broken in (b)-(d) or in an
   (a) run (the master's too, from its dump) fails the phase; a writer
   broken mid-frame in any phase that stops, kills or restarts no worker
   or master fails the run: this process's, and each master's, counted
   in its dump when it is stopped (each phase's breaks are logged);
6m. trace: tracing, the reader's deadlines and the metrics flush, with
   phase ufs's parameters and step: a master of the phase's own (the
   ``ici`` placement, a 30 s lost timeout), worker A in this process
   with a tier-0 at ICI (0, 0) and worker B in a process of its own
   (``python -m curvine_tpu_torch.worker``, which must load no module of
   JAX or of the JAX package) at (1, 0); phase feed's shape at two
   replicas, written near B (every block lists B first), read with the
   short circuit off and a 2 s read budget (``op_deadline_ms``). (a)
   ``GpuTrainFeed`` over one epoch with tracing at the ``[obs]``
   defaults and with it off, twice in turns: batches/s. (b) One shard
   whose first replica is B's read into device memory under a sampled
   root; ``get_trace`` (the master's GET_SPANS collect, reaching B's
   process) must give one tree across the client, the master and B,
   each span inside its parent's interval within 50 ms; the tree is
   printed. (c) The feed epoch after epoch while B is stopped (SIGSTOP
   after 4 batches, SIGCONT 8 s later: a hung host, not a crash): each
   read that paid a wedged hop with its seconds and its trace, the
   wedged hops before B's breaker opened and after it half-opened, the
   longest wait for one batch and the batches/s across the wedge; a read
   through the wedge over the budget + 0.5 s, no wedged hop at all, or a
   batch unequal fails the phase. (d) The shards pinned into A's tier-0
   (K1, launches equal to the pins, each device copy equal), three
   flagship steps on batches read by ``pread_view`` under the budget
   (K3). (e) Every client flushed at its close: the master's
   ``--metrics-out`` dump's ``client.*`` counters equal the sums of the
   phase's clients' own (``read.zero_copy_bytes`` among them);
6b. ckpt: the flagship's parameters as phase ufs left them (99 tensors,
   1.92 GiB of bf16) saved with ``save_checkpoint`` through the port's
   client into the cluster, every byte by short circuit (SC_WRITE_OPEN:
   the worker is on this host), then loaded onto the card with
   ``distribute_checkpoint_to_device`` by short circuit and again with
   it off (READ_BLOCK received into the caller's buffer); each load bit
   for bit equal to the saved tensors, compared on the card through
   integer views, and the loss of one train batch from the loaded
   parameters equal to the saved ones' (K3's forward); save and load
   GiB/s beside phase 3's ``link_gibs``, the pinned ring's staging time;
   then every block of the checkpoint pinned into the port's worker's
   tier-0 by HBM_PIN (no K1) and the checkpoint distributed over a
   ``(1,)`` NCCL mesh by ``distribute_checkpoint``, ``"tree"`` (every
   block from the tier-0: ``ici.peer_pulls`` equal to the blocks, no
   byte by short circuit or READ_BLOCK) and ``"flat"``, each leaf
   replicated and bit-equal on the card; the blocks unpinned after;
6f. recover: the client's write recovery, with phase ckpt's parameters
   still on the card: a master of the phase's own (``ici`` placement, a
   lost timeout of 3 s) and four of the port's workers in this process,
   A to D at ICI (0..3, 0), each with a mem tier and a 256 MiB tier-0 on
   the card; writes from (0, 0). (a) 8 x 64 MiB of tokens written to one
   file in 16 MiB writes, one replica by short circuit, A stopped 40 MiB
   into block 1: its SC_WRITE_COMMIT fails and the block is replayed
   whole onto B; ``hflush`` after block 3, seen by another client; the
   file equal to its tokens, no block on A, its GiB/s beside the same
   write with no death. (b) The flagship's parameters saved with two
   replicas at a floor of two (on B and D), once with no death, then
   again with D stopped at 1 GiB written: the open block replayed onto
   B and C, D's earlier blocks healed onto C; the checkpoint loaded onto
   the card bit for bit and its loss equal to the saved parameters'
   (K3's forward); the save's GiB/s beside the save with no death and
   phase ckpt's, the heal's seconds. (c) The replayed blocks read up to
   the promote threshold and pinned by their holders' promote cycles,
   K1 verifying each pin, each device copy equal to its file. (d) A
   fifth worker E; a reader opened on a checkpoint tensor of
   several blocks (on B and C); C stopped and its blocks healed onto E,
   B stopped; the open reader's ``read_all`` bit-equal through exactly
   one location refresh. No error reaches a caller in (a) or (b). The
   client's circuit breaker is on (the default): in (b) the opens placed
   on D first are at most its threshold, and once D's breaker opened no
   placement names D; (d) reads with the breakers' order;
6c. mesh: an NCCL world of this process alone (``multihost.initialize``)
   and a (1, 1) ``("data", "model")`` mesh on the card; phase 6's initial
   parameters (the same seed) placed by ``shard_params``, a fresh AdamW,
   and phase 6's cache-fed steps through ``GpuTrainFeed(mesh=...)`` and
   synthetic steps, in the same order: every batch a DTensor laid out by
   ``batch_spec``, K3's four kernels launched once a layer a step (under
   ``local_map``, on the local heads), every loss equal to phase 6's bit
   for bit; ``train_step_ms``, ``mfu``, ``ingest_overlap_ratio``, peak
   memory and device busy over two profiled steps beside phase 6's; then
   dryrun_multichip's MoE config (experts sharded over ``ep``) two steps
   on a (1, 1) ``("data", "ep")`` mesh and without one, equal losses;
6d. pipeline: the flagship through ``gpu/pipeline.py`` on a ``(1,)``
   ``("pp",)`` NCCL mesh: phase 6's initial parameters stacked and placed
   by ``shard_stacked``; ``pipeline_forward``'s logits on phase 6's
   synthetic batch against the unsharded ``forward``'s, then three steps
   of ``pipeline_loss`` (full f32 logits) at batch 16 x 1024 in 2
   microbatches, its backward and AdamW: K3's four kernels launched once
   a layer a microbatch a step (the stages call ``_block``); the
   unsharded model's three steps with the same loss after, each loss and
   every gradient leaf against the pipeline's (``PIPE_*`` limits);
6e. ring: the flagship with ``use_ring_attention`` on a (1, 1, 1)
   ``("data", "model", "seq")`` NCCL mesh, phase 6's initial parameters,
   a fresh AdamW, three steps on phase 6's synthetic batch through the
   ring of ``gpu/attention.py`` (plain torch, as the reference's XLA
   blocks): K3 launched no time, the losses within ``RING_LOSS_ABS`` of
   the unsharded K3 steps' from the same parameters, step times and
   peak memory; before the steps, the ring's attention output at the
   first layer within ``RING_ATTN_ABS`` of f32 dense attention, and a
   ring without its causal mask (a planted fault) outside it. On one
   card ``pp`` and ``seq`` have one rank: the shifts are local copies,
   and no NCCL send runs;
7. vector: K2, the ADC scan, on the card against its plain version, bit
   for bit, at four shapes (the path's own among them) with planted
   out-of-range codes, both code layouts; its time at the path's shape
   beside its bound, the plain version's and ``embedding_bag``'s (a
   yardstick only). Then bench.py's headline ANN configuration at full
   size through the port's ``VectorTable`` on the port's client (the
   table in the cluster, by short circuit both ways): 500,000
   rows x 256 from a mixture of 1,024 Gaussians, an IVF-PQ index (nlist
   1024, pq_m 16, cap_pct 90), ``AnnServer.query_many`` (4,096 queries,
   batch 256, depth 4), 3,072 concurrent ``query()`` callers, flat IVF,
   the exact scan in float32 and bf16, recall@10 of both indexed paths
   against the exact scan (at least 0.9 each, scripts/perf_floor.json),
   and the PQ search of 64 queries with K2 against the same search with
   its ADC stage taken by the plain version (ids and scores equal); last,
   a small table compacted, its old row group deleted through the
   client's ``meta.delete``;
8. master: the port's master's count and p50 of each RPC code, then the
   master stopped and started again on its journal and KV directory (its
   recovery timed: ``applied_seq``, the tail replayed, the KV directory's
   segments and bytes; the native engine before and after);
   every file the run left (the train shards, the checkpoint's 99 tensors
   and manifest, the worker phase's files, the vector table) listed again
   with the same length and blocks, each block located once the port's
   worker has sent the full report the restarted master asks for; phase
   ufs's mount table and job records the same after the restart; the
   master lists that worker alone; one checkpoint tensor of several
   blocks read back through the port's client bit for bit;
9. ici: the peer-device plane (``gpu/ici_plane.py``) on one card: a
   master of the phase's own and two more of the port's workers in this
   process, each with a tier-0 on the card and ICI coordinates. One 64
   MiB block written to worker A, pinned by A's promote cycle (one K1
   launch), read from A by READ_BLOCK and moved to worker B by
   ICI_TRANSFER five times (a copy within the card through the device
   domain, then D2H, crc32c, write, commit, report, each timed); B's
   block equal to A's bit for bit with A's commit crc, located on both;
   after A unpins it, ICI_TRANSFER answers ``success: False`` with one
   TCP fallback counted. Then bench.py's rail A/B (bench.py:1198-1264)
   over a ``(1,)`` NCCL mesh: ``broadcast_bytes`` against
   ``flat_replicate`` of 64 MiB, bit-exact on the card
   (``ckpt_broadcast_gibs``: with one rank, the chunked host-to-device
   path);
10. replicate: blocks kept at their replica count, on one card: a master
   of the phase's own (``block_placement_policy = "ici"``, a lost timeout
   of 3 s) and three of the port's workers in this process, A, B and C at
   ICI (0, 0), (1, 0) and (2, 0), each with a tier-0 on the card. Two
   files of four 64 MiB blocks written with two replicas (every block on
   A and C, each replica's block file equal to the bytes); A's promote
   cycle pins the first (four K1 launches), a byte
   of one block's media copy on C is flipped and C's promote cycle
   refuses and reports it, and the master's evacuation lands it on B
   from A's tier-0 by the ICI hint (one peer pull, no fallback, no byte
   read from A), retires C's copy and has it deleted; then the first file
   deleted, C stopped, and the second file's blocks pulled by B from A by
   READ_BLOCK (no hint); every block back at two replicas and read bit
   for bit; times from the report and from the loss, each path's GiB/s
   and split, and the master's ``replication.*`` counters.

The kernel launch counts are set to 0 just before phase 3 and read just
after phase 4 (K1), again just before phase 4c's promote cycles and read
just after them (K1), again just before phase 9's promote cycle and read
just after it (K1), again just before phase 10's promote cycle and read
just after it (K1), again just before phase 6a's promote cycles and read
just after them (K1), again just before phase 6g's promote cycles and
read just after them (K1), again just before the two passes of phase 6
and read just after them (K3), again just before phase 6a's three steps
and read just after them (K3), again just before phase 6g's three steps
and read just after them (K3), again just before phase 6h's promote
cycles and read just after them (K1), again just before phase 6h's three
steps and read just after them (K3), again just before phase 6i's promote
cycles and read just after them (K1), again just before phase 6i's three
steps and read just after them (K3), again just before phase 6j's promote
cycles and read just after them (K1), again just before phase 6j's three
steps and read just after them (K3), again just before phase 6k's promote
cycles and read just after them (K1), again just before phase 6k's three
steps and read just after them (K3), again just before phase 6l's promote
cycles and read just after them (K1), again just before phase 6l's three
steps and read just after them (K3), again just before phase 6b and read just
after it (K3's forward, twice a layer for the two losses, and no backward
kernel), again just before phase 6f's two losses and read just after
them (K3's forward, as in 6b), again just before phase 6f's promote
cycles and read just after them (K1), again just before the two passes of phase 6c and read just
after them (K3), again just before phase 6d's three pipeline steps and
read just after them (K3), again just before phase 6e's three ring
steps and read just after them (K3: none), and just before phase 7's
``query_many`` and read just after it (K2, which must equal the ADC
stages the search issued). The kernels line gives K1's twelve counts
summed (each held to its pins, the refused device copies included) and
phase 6's, 6a's, 6g's, 6h's, 6i's, 6j's, 6k's, 6l's, 6c's, 6d's and
6f's K3 counts summed.
The port's
worker and master are stopped, the process group destroyed, and the
data directory removed, however the run ends. No process of the run
loads a module of JAX or of the JAX package. Prints each phase's
numbers, the card's name and power limit, one JSON line of kernels, and
last the line ``{"ok": true, "device": {...}}``. Exits non-zero, and
prints no result, where no CUDA device is visible or the port is not
importable."""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

MiB = 1 << 20
GiB = 1 << 30
BLOCK = 64 * MiB                   # worker block_size default
N_BLOCKS = 96
N_HOT = 16
TIER_BYTES = 4 * GiB
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published memory rate
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
SIZES = [1, 3, 4, 262143, 262144, 262145, MiB + 13, BLOCK, BLOCK + 1]
SHARDS = 8
SHARD_BYTES = 64 * MiB
BATCH, SEQ = 32, 8192
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 8
PIPE_MICROBATCHES = 2              # phase pipeline's microbatches
# the flagship's first, then phase pipeline's microbatch; [3, 5, 384,
# 128] has an odd B*H and three 128-row tiles, so diagonal tiles and
# partial walks run in every kernel
FLASH_SHAPES = [(TRAIN_BATCH, 20, TRAIN_SEQ, 128),
                (TRAIN_BATCH // PIPE_MICROBATCHES, 20, TRAIN_SEQ, 128),
                (1, 2, 128, 128), (2, 4, 2048, 128), (3, 5, 384, 128)]
CHECK_BATCH = 2                    # the full-width agreement check
# bench.py:1581-1693, the headline ANN configuration (docs/ann-serving.md)
VEC_ROWS, VEC_DIM, VEC_CENTERS, VEC_SIGMA = 500_000, 256, 1024, 0.25
VEC_INDEX = dict(nlist=1024, metric="cosine", iters=4, pq_m=16, cap_pct=90.0)
VEC_K, VEC_NPROBE, VEC_RERANK = 10, 8, 512
ANN_QUERIES, ANN_BATCH, ANN_DEPTH = 4096, 256, 4
SERVED_QUERIES, FLAT_QUERIES, SCAN_REPS, RECALL_QUERIES = 3072, 512, 8, 64
# K2 against its plain version: (Q, W, M, ksub); the path's own shape,
# (256, W of the run, 16, 256), is added by the phase
PQ_SHAPES = [(1, 1, 4, 16), (3, 1000, 8, 32), (16, 7777, 64, 256)]
HERE = os.path.dirname(os.path.abspath(__file__))
# the flagship's checkpoint: 1,028,323,840 bf16 parameters, 1.92 GiB
CKPT_PATH, CKPT_BYTES = "/ckpt/flagship", 2 * GiB
# the cluster's mem tier holds, without evicting: the client phase's
# shards, the checkpoint, the vector table, and 1 GiB for the rest (the
# train phase's shards, 768 KiB; the index; the compaction check; the
# block being written, which the worker reserves at its full size)
CLUSTER_TIER_BYTES = SHARDS * SHARD_BYTES + CKPT_BYTES \
    + VEC_ROWS * VEC_DIM * 4 + GiB
MASTER_START_S = 60
# the worker phase: a hot set and as many cold files of one 64 MiB block,
# and one more whose file is corrupted before its pin
WORKER_HOT = WORKER_COLD = 16
WORKER_PHASE_BYTES = (WORKER_HOT + WORKER_COLD + 1) * BLOCK
# phase ufs: an under-store (file://) of phase feed's dataset shape and 4
# more shards, token ids below the flagship's vocab; a prefetch window of
# 4; three flagship steps on the loaded tokens; one 64 MiB file exported.
# Its cached copies, and the under-store's files, take UFS_PHASE_BYTES
UFS_NEXT_SHARDS = 4
UFS_WINDOW = 4
UFS_STEPS = 3
UFS_VOCAB = 32_000
UFS_PHASE_BYTES = (SHARDS + UFS_NEXT_SHARDS + 1) * SHARD_BYTES
# the port's worker: its mem tier holds the cluster's data, the worker
# phase's and phase ufs's; its device tier-0 is phase 3's size; heat of
# one read pass through the client is 2 (the open's probe and the read's
# report)
WORKER_TIER_BYTES = CLUSTER_TIER_BYTES + WORKER_PHASE_BYTES \
    + UFS_PHASE_BYTES
WORKER_MIN_READS = 2
WORKER_HEARTBEAT_MS = 1000
# phase ici: two more of the port's workers under a master of their own,
# each a mem tier of a few blocks; ICI_TRANSFER of one 64 MiB block timed
# ICI_REPS times; bench.py's _ici_smoke rail A/B (bench.py:1198-1264): a
# 64 MiB payload, 2 warm-ups and the best of 3 rounds a rail
ICI_TIER_BYTES = 4 * BLOCK
ICI_REPS = 5
# phase replicate: three of the port's workers under a master of their own
# (the ici placement, a lost timeout of a few seconds); two files of
# REP_BLOCKS blocks, two replicas each; a mem tier holds both files'
# replicas, the healed ones and the blocks being written
REP_BLOCKS = 4
REP_TIER_BYTES = 16 * BLOCK
REP_LOST_MS = 3_000
ICI_PAYLOAD, ICI_ROUNDS, ICI_WARMUPS = 64 * MiB, 3, 2
# phase recover: four of the port's workers under a master of their own
# (the ici placement, REP_LOST_MS), and a fifth for the refresh; a file of
# SHARDS token shards written in RECOVER_WRITE pieces, its first block's
# worker stopped RECOVER_KILL_AT into it; the checkpoint saved with two
# replicas at a floor of two, a leg's worker stopped once the save has
# written RECOVER_SAVE_KILL bytes. A mem tier holds every file's
# replicas; the tier-0s hold the replayed blocks. The phase writes at
# most RECOVER_PHASE_BYTES to the data directory (files, replays, heals)
RECOVER_WRITE = 16 * MiB
RECOVER_KILL_AT = 40 * MiB
RECOVER_SAVE_KILL = GiB
RECOVER_TIER_BYTES = CKPT_BYTES + 2 * SHARDS * SHARD_BYTES
RECOVER_HBM_BYTES = 4 * BLOCK
RECOVER_PHASE_BYTES = 2 * SHARDS * SHARD_BYTES + 4 * CKPT_BYTES
# phase drain: three of the port's workers under a master of their own
# (the ici placement, REP_LOST_MS); phase feed's shape at two replicas,
# the first worker decommissioned DRAIN_DECO_AFTER batches into a feed
# and drained within DRAIN_LIMIT_S; a mem tier holds a worker's share of
# the shards, the small files and the blocks being written; the new
# holder's tier-0 holds every drained block. The phase writes at most
# DRAIN_PHASE_BYTES to the data directory (replicas, pulls, small files)
DRAIN_DECO_AFTER = 4
DRAIN_LIMIT_S = 60
DRAIN_SMALL_BYTES = MiB
DRAIN_TIER_BYTES = SHARDS * SHARD_BYTES + 4 * BLOCK
DRAIN_HBM_BYTES = (SHARDS + 2) * BLOCK
DRAIN_PHASE_BYTES = 3 * SHARDS * SHARD_BYTES + 4 * DRAIN_SMALL_BYTES
# phase ec: four of the port's workers under a master of their own (the
# local placement, REP_LOST_MS); phase feed's shape at two replicas,
# converted to EC_PROFILE stripes (three cells of 32 MiB a block, on
# three distinct workers), then a holder stopped and its cells rebuilt,
# each within EC_LIMIT_S. A mem tier holds a worker's share of the
# replicas, the cells and the rebuilt cells; a tier-0 holds its rebuilt
# cells. The phase writes at most EC_PHASE_BYTES to the data directory
# (1 GiB of replicas, 768 MiB of cells, at most 256 MiB rebuilt)
EC_PROFILE = "rs-2-1"
EC_LIMIT_S = 60
EC_TIER_BYTES = 2 * SHARDS * SHARD_BYTES + 2 * BLOCK
EC_HBM_BYTES = (SHARDS + 2) * BLOCK // 2
EC_PHASE_BYTES = 4 * SHARDS * SHARD_BYTES
# phase kv: (a) KV_FILES files in directories of KV_PER_DIR through a
# MasterFilesystem over KvMetaStore in this process (an inode cache of
# KV_CACHE_INODES; the reference's test's bounds: KV_RSS_MB of RSS growth,
# a restart under KV_RESTART_S; a reading and a restart at KV_FIRST), the
# same files on the mem store;
# (b) a master of the phase's own killed after KV_KILL_AFTER of phase
# feed's shards, with a writer of KV_SMALL-byte files running, its
# clients retrying KV_RETRY_MAX times; two workers, each able to hold
# every shard; (c) the shards pinned. The phase writes at most
# KV_PHASE_BYTES to the data directory (the KV directory and journals of
# (a), the shards and small files of (b))
# 1,000,000 took 184.3 s to create on an H100 machine's host (NVIDIA
# H100 80GB HBM3, 700 W): cut to the reference test's default, which
# keeps the phase near 90 s
KV_FILES = 200_000
KV_PER_DIR = 1_000
KV_FIRST = 100_000
KV_CACHE_INODES = 4_096
KV_RSS_MB = 120
KV_RESTART_S = 5.0
KV_STATS = 1_000
KV_KILL_AFTER = 4
KV_SMALL = 4 * 1024
KV_RETRY_MAX = 8
KV_TIER_BYTES = SHARDS * SHARD_BYTES + 6 * BLOCK
KV_HBM_BYTES = (SHARDS + 2) * BLOCK
KV_PHASE_BYTES = 2 * GiB + SHARDS * SHARD_BYTES + 256 * MiB
# phase ha: HA_MASTERS of the port's masters in one raft group, two
# workers (each able to hold every shard) that report their blocks in
# full every HA_REPORT_MS; phase kv (b)'s writers with the leader killed
# after HA_KILL_AFTER shards; HA_PADS files with an xattr of HA_PAD bytes
# (the namespace past MAX_FRAME, as tests/test_raft.py:491-541 makes it);
# a RAFT_TRANSFER HA_TRANSFER_AFTER batches into the feed; each wait at
# most HA_LIMIT_S. The phase writes at most HA_PHASE_BYTES to the data
# directory (the shards and small files, and each master's journal, KV
# directory and snapshot of the pads)
HA_MASTERS = 3
HA_KILL_AFTER = 4
HA_TRANSFER_AFTER = 4
HA_PADS, HA_PADS_BIG, HA_PAD = 9, 36, 8 * MiB
# the rounds at HA_PADS_BIG pads, for the spread of their stalls
HA_BIG_ROUNDS = 3
# a loop stall that fails the phase: half the least election timeout
HA_STALL_MS = 300
# a cut on the leader's loop that fails the phase: cursors opened, no
# record read (a copy of the records took 119-176 ms at 72 MiB)
HA_CUT_MS = 5.0
HA_REPORT_MS = 1_000
HA_LIMIT_S = 60
HA_PHASE_BYTES = SHARDS * SHARD_BYTES \
    + 4 * HA_MASTERS * HA_PADS_BIG * HA_PAD + 256 * MiB
# phase shm: three of the port's workers under a master of their own (the
# ici placement, REP_LOST_MS), each able to hold phase feed's shards: F
# with shm_reads off, S with it on and a tier-0 for its shards, W on an
# SSD tier with a warm cache that holds them; each wait at most
# SHM_LIMIT_S. The phase writes at most SHM_PHASE_BYTES to the data
# directory (the shards three times)
SHM_TIER_BYTES = SHARDS * SHARD_BYTES + 4 * BLOCK
SHM_HBM_BYTES = (SHARDS + 2) * BLOCK
SHM_WARM_MB = (SHARDS + 2) * SHARD_BYTES // MiB
SHM_LIMIT_S = 60
SHM_PHASE_BYTES = 3 * SHARDS * SHARD_BYTES + 64 * MiB
# phase wire: two of the port's workers under a master of their own (the
# robin placement, REP_LOST_MS), each with a tier-0 for its half of phase
# feed's shards; (a) WIRE_CALLERS callers for WIRE_CALL_S a run; (b) the
# pread_view pass in WIRE_STEP reads with a window of WIRE_READ_AHEAD
# segments, the read_range pass in WIRE_PARALLEL slices; (c) WIRE_FLIPS
# sequential runs of WIRE_RUN reads of WIRE_RUN_READ bytes, each followed
# by WIRE_PROBES random reads of WIRE_PROBE bytes. At most WIRE_PHASE_BYTES on the data directory
WIRE_CALLERS = 64
WIRE_CALL_S = 5.0
# phase wire (a) behind streams: shards read whole by this many tasks
# while WIRE_CALLERS callers read WIRE_SMALL bytes at random offsets
WIRE_STREAMS = 4
WIRE_SMALL = 4096
WIRE_SHARED_S = 3.0
WIRE_STEP = 4 * MiB
WIRE_READ_AHEAD = 4
WIRE_PARALLEL = 4
WIRE_FLIPS = 6
WIRE_RUN = 8
WIRE_RUN_READ = MiB
WIRE_PROBES = 4
WIRE_PROBE = 64 * 1024
WIRE_TIER_BYTES = SHARDS * SHARD_BYTES // 2 + 4 * BLOCK
WIRE_HBM_BYTES = (SHARDS // 2 + 2) * BLOCK
WIRE_PHASE_BYTES = SHARDS * SHARD_BYTES + 64 * MiB
# phase trace: a master of its own (the ici placement, a lost timeout
# longer than the phase, so that the hung worker stays listed), worker A
# in this process with a tier-0 and worker B in its own process; phase
# feed's shards at two replicas, read by clients with the short circuit
# off and a read budget of TRACE_BUDGET_MS (the reference's storm test's);
# (c) B stopped after TRACE_STOP_AFTER batches for TRACE_WEDGE_S, every
# read through it held to TRACE_BUDGET_MS + TRACE_SLACK_S; the wedge
# outlasts the breaker's first open window (its third hop ends about 3.3
# s in, then breaker_open_ms), so a half-open probe meets B still stopped
TRACE_LOST_MS = 30_000
TRACE_BUDGET_MS = 2_000
TRACE_SLACK_S = 0.5
TRACE_STOP_AFTER = 4
TRACE_WEDGE_S = 12.0
TRACE_NEST_S = 0.05              # (b): a span within its parent's interval
TRACE_TIER_BYTES = SHARDS * SHARD_BYTES + 4 * BLOCK
TRACE_HBM_BYTES = (SHARDS + 2) * BLOCK
TRACE_PHASE_BYTES = 2 * TRACE_TIER_BYTES + 64 * MiB


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, scratch: torch.Tensor, prep=None
             ) -> list[float]:
    """Per-call device times of ``fn`` (CUDA events); before each call,
    outside the timed span, ``prep()`` and an L2 flush (a 256 MiB write,
    five times the 50 MB L2)."""
    times = []
    for _ in range(reps):
        if prep is not None:
            prep()
        scratch.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


# ------------------------------------------------------------------ phases

def _kernel_name(mangled: str) -> str:
    """The function's own name out of an Itanium-mangled one: the
    shortest length-prefixed part that ends in ``_kernel`` (a length may
    follow other digits, and a hash in the namespace may look like one),
    with a template's arguments as mangled, else the whole."""
    found = []
    for m in re.finditer(r"\d+", mangled):
        for k in range(m.start(), m.end()):
            n = int(mangled[k:m.end()])
            cand = mangled[m.end():m.end() + n]
            if len(cand) == n and cand.endswith("_kernel"):
                targs = re.match(r"I(\w+?)E", mangled[m.end() + n:])
                found.append(cand + (f"<{targs.group(1)}>" if targs else ""))
    return min(found, key=len) if found else mangled


def ptxas_stats(log_text: str) -> dict:
    """Per kernel, what ``ptxas -v`` reports: registers, bytes of stack,
    spill stores and loads, static shared memory."""
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {
                "registers": None, "stack": 0, "spill_stores": 0,
                "spill_loads": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def phase_build() -> dict:
    from curvine_tpu_torch.gpu import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, i in sorted(info.items()):
        log(f"build: {name}: {i['seconds']:.2f}s")
        ptxas[name] = ptxas_stats(i["log"])
        for kern, st in ptxas[name].items():
            log(f"  ptxas: {kern}: {st['registers']} registers, "
                f"{st['spill_stores']} bytes spill stores, "
                f"{st['spill_loads']} bytes spill loads, {st['stack']} bytes "
                f"stack, {st['smem']} bytes static smem")
    log(f"build: all sources in {secs:.2f}s")
    return {"seconds": secs, "ptxas": ptxas}


def phase_kernel(rng: np.random.Generator, dev: torch.device) -> dict:
    from curvine_tpu_torch.gpu import cuda_ops as ops
    max_err = 0
    for n in SIZES:
        host = rng.integers(0, 256, n, dtype=np.uint8)
        t = torch.from_numpy(host).to(dev)
        k = ops.block_checksum(t)
        p = ops.block_checksum_torch(t)
        h = ops.block_checksum_host(host)
        max_err = max(max_err, abs(k - p), abs(k - h))
        if not k == p == h:
            raise AssertionError(f"size {n}: kernel {k:#010x} plain {p:#010x}"
                                 f" host {h:#010x}")
        if n > 8:
            # a 4-byte-aligned base that is not 16-byte aligned takes the
            # word-by-word path of the kernel
            k4 = ops.block_checksum(t[4:])
            h4 = ops.block_checksum_host(host[4:])
            if k4 != h4:
                raise AssertionError(f"size {n} at offset 4: kernel "
                                     f"{k4:#010x} host {h4:#010x}")
        log(f"kernel: {n:>9} B  hash {k:#010x}  kernel == plain == host")
    # sensitivity at the main path's size
    base = rng.integers(0, 256, BLOCK, dtype=np.uint8)
    t = torch.from_numpy(base).to(dev)
    h0 = ops.block_checksum(t)
    flipped = t.clone()
    flipped[1000] ^= 0xFF
    # the hash sees a swap of words i and j through the bits where their
    # index terms differ: words 0 and 127 differ in the 7 low bits, so the
    # swap goes unseen only where the two words agree there (1 in 128)
    swapped = t.clone()
    swapped[0:4], swapped[508:512] = t[508:512].clone(), t[0:4].clone()
    for what, v in (("bit flip", flipped), ("word swap", swapped)):
        hv = ops.block_checksum(v)
        if hv == h0 or hv != ops.block_checksum_host(v.cpu().numpy()):
            raise AssertionError(f"{what}: hash {hv:#010x} vs {h0:#010x}")
        log(f"kernel: {what} changes the hash ({h0:#010x} -> {hv:#010x})")
    # time at 64 MiB: the kernel alone (one launch into a zeroed output),
    # and the plain version as a whole call
    scratch = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    out = torch.zeros(2, dtype=torch.int32, device=dev)

    kernel_ms = statistics.median(
        event_ms(lambda: ops.launch(t, out), 20, scratch, prep=out.zero_))
    plain_ms = statistics.median(
        event_ms(lambda: ops.block_checksum_torch(t), 20, scratch))
    bound_ms = BLOCK / HBM_BYTES_PER_S * 1e3
    host_t0 = time.perf_counter()
    for _ in range(3):
        ops.block_checksum_host(base)
    host_s = (time.perf_counter() - host_t0) / 3
    res = {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "checksum_gibs": BLOCK / GiB / (kernel_ms
                                                                  / 1e3),
           "host_hash_gibs": BLOCK / GiB / host_s,
           "launches_in_phase": ops.block_checksum.launches}
    log(f"kernel: 64 MiB in {kernel_ms:.4f} ms, checksum_gibs "
        f"{res['checksum_gibs']:.1f} (bound {bound_ms:.4f} ms by "
        f"bytes, {bound_ms / kernel_ms:.1%} of it); plain version "
        f"{plain_ms:.4f} ms; host hash {res['host_hash_gibs']:.3f} GiB/s; "
        f"launches in this phase {res['launches_in_phase']}")
    return res


class _FlipDeviceCopy:
    """A tier whose device copies arrive with one byte flipped: the bytes
    pass the media crc and then diverge on the device."""

    def __init__(self, tier):
        self.tier = tier

    def put(self, block_id, data):
        arr = self.tier.put(block_id, data)
        arr[12345] ^= 0x01
        return arr

    def drop(self, block_id, evicted=False):
        self.tier.drop(block_id, evicted=evicted)


def pick_data_dir(need: int) -> str:
    shm = "/dev/shm"
    if os.path.isdir(shm):
        st = os.statvfs(shm)
        if st.f_bavail * st.f_frsize > need + GiB:
            return tempfile.mkdtemp(prefix="curvine-smoke-", dir=shm)
    return tempfile.mkdtemp(prefix="curvine-smoke-")


def phase_main(rng: np.random.Generator, dev: torch.device, root: str
               ) -> dict:
    from curvine_tpu_torch.gpu.cuda_ops import block_checksum_host
    from curvine_tpu_torch.gpu.hbm import HbmTier, MultiHbmTier
    from curvine_tpu_torch.common.errors import AbnormalData
    from curvine_tpu_torch.worker.blockfile import (
        block_path, crc_update, map_block)
    from curvine_tpu_torch.worker.promote import promote_block

    blocks = os.path.join(root, "mem")
    t0 = time.perf_counter()
    crcs = {}
    for bid in range(1, N_BLOCKS + 1):
        data = rng.integers(0, 1 << 64, BLOCK // 8, dtype=np.uint64)
        p = block_path(blocks, bid)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        data.tofile(p)
        crcs[bid] = zlib.crc32(data)
    log(f"main: wrote {N_BLOCKS} blocks of {BLOCK // MiB} MiB "
        f"({N_BLOCKS * BLOCK / GiB:.1f} GiB) in "
        f"{time.perf_counter() - t0:.1f}s")

    tier = MultiHbmTier(TIER_BYTES, devices=[dev], admission="s3fifo")
    hot = list(range(1, N_HOT + 1))
    scan = list(range(N_HOT + 1, N_BLOCKS + 1))

    def promote(bid):
        return promote_block(tier, bid, block_path(blocks, bid), 0, BLOCK,
                             crc=crcs[bid], crc_algo="crc32")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bid in hot:
        promote(bid)
    for _ in range(3):
        for bid in hot:
            if tier.get(bid) is None:
                raise AssertionError(f"hot block {bid} missing")
    for bid in scan:
        promote(bid)
    torch.cuda.synchronize()
    promote_s = time.perf_counter() - t0
    pins = N_BLOCKS
    # a copy that passes the media crc and then diverges on the device
    try:
        promote_block(_FlipDeviceCopy(tier), 10_000,
                      block_path(blocks, hot[0] + 1), 0, BLOCK,
                      crc=crcs[hot[0] + 1], crc_algo="crc32")
    except AbnormalData as e:
        log(f"main: corrupted device copy caught: {e}")
    else:
        raise AssertionError("a corrupted device copy was promoted")
    pins += 1
    if 10_000 in tier:
        raise AssertionError("the corrupted block stayed in the tier")
    st = tier.stats()
    if st["spills"] <= 0:
        raise AssertionError(f"the tier never spilled: {st}")
    resident = [bid for bid in hot if bid in tier]
    if len(resident) != N_HOT:
        raise AssertionError(f"the scan spilled the hot set: "
                             f"{len(resident)}/{N_HOT} resident")
    # resident bytes equal the files
    for bid in (hot[0], scan[-1]):
        got = tier.get(bid)
        if got is None or not torch.equal(
                got.cpu(), torch.from_numpy(
                    np.fromfile(block_path(blocks, bid), dtype=np.uint8))):
            raise AssertionError(f"block {bid}: device bytes differ")
    log(f"main: {pins} pins ({N_BLOCKS} verified + 1 corrupted) in "
        f"{promote_s:.2f}s ({N_BLOCKS * BLOCK / GiB / promote_s:.3f} GiB/s "
        f"promoted); tier {st['blocks']} blocks, {st['used'] / GiB:.2f} "
        f"GiB used, spills {st['spills']}, scan_evicted "
        f"{st['scan_evicted']}, hot {len(resident)}/{N_HOT} resident")
    del tier

    # the raw rails: mmap views → tier, pinned buffer → device. The views
    # are mapped once, so the first read pass also faults their pages in
    views = [map_block(block_path(blocks, bid), 0, BLOCK) for bid in hot]
    link_buf = torch.from_numpy(
        rng.integers(0, 256, 128 * MiB, dtype=np.uint8)).pin_memory()
    link_dst = torch.empty(128 * MiB, dtype=torch.uint8, device=dev)

    def link_pass() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        link_dst.copy_(link_buf, non_blocking=True)
        torch.cuda.synchronize()
        return 128 * MiB / GiB / (time.perf_counter() - t)

    def read_pass() -> float:
        rt = HbmTier(len(views) * BLOCK, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i, v in enumerate(views):
            rt.put(i, v)
        torch.cuda.synchronize()
        return len(views) * BLOCK / GiB / (time.perf_counter() - t)

    link_pass()
    reads, links = [], []
    for _ in range(4):
        links.append(link_pass())
        reads.append(read_pass())
    crc_t = time.perf_counter()
    for v in views[:4]:
        crc_update("crc32", v)
    crc_gibs = 4 * BLOCK / GiB / (time.perf_counter() - crc_t)
    hh_t = time.perf_counter()
    for v in views[:4]:
        block_checksum_host(v)
    host_gibs = 4 * BLOCK / GiB / (time.perf_counter() - hh_t)
    res = {"pins": pins, "verified_pins": N_BLOCKS, "spills": st["spills"],
           "scan_evicted": st["scan_evicted"],
           "hot_resident": len(resident), "promote_s": promote_s,
           "promote_gibs": N_BLOCKS * BLOCK / GiB / promote_s,
           "read_gibs_into_device": max(reads), "link_gibs": max(links),
           "pipeline_vs_link": max(reads) / max(links),
           "read_passes_gibs": reads, "link_passes_gibs": links,
           "crc32_gibs": crc_gibs, "host_hash_gibs": host_gibs}
    log(f"main: read_gibs_into_device {res['read_gibs_into_device']:.3f} "
        f"link_gibs {res['link_gibs']:.3f} pipeline_vs_link "
        f"{res['pipeline_vs_link']:.3f} (best of 4 interleaved passes); "
        f"media crc32 {crc_gibs:.3f} GiB/s; host hash {host_gibs:.3f} GiB/s")
    return res


async def drive_feed(feed, expect: torch.Tensor, dev: torch.device
                     ) -> tuple[int, int, float]:
    """Drain a feed of [BATCH, SEQ] device batches, each compared on the
    card with its slice of ``expect``: (batches, tokens that differ,
    seconds)."""
    per_batch = BATCH * SEQ
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    n = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    async for b in feed:
        if b.shape != (BATCH, SEQ) or b.device != dev:
            raise AssertionError(f"batch {n}: {b.shape} on {b.device}")
        ref = expect[n * per_batch:(n + 1) * per_batch].view(BATCH, SEQ)
        bad += (b != ref).sum()
        n += 1
    torch.cuda.synchronize()
    return n, int(bad), time.perf_counter() - t


def feed_stats(phase: str, n: int, secs: float, prof) -> dict:
    """A feed's rates and the profiler's stage shares, logged."""
    per_batch = BATCH * SEQ
    summary = prof.summary()
    snap = prof.snapshot()["stages"]
    res = {"batches": n, "batches_per_s": n / secs,
           "tokens_per_s": n * per_batch / secs,
           "gibs": n * per_batch * 4 / GiB / secs,
           "fractions": summary["fractions"],
           "stage_p50_ms": {k: v["p50"] * 1e3 for k, v in snap.items()},
           "stage_total_s": {k: v["total_s"] for k, v in snap.items()}}
    log(f"{phase}: {n} batches of {BATCH}x{SEQ} int32, all equal to the "
        f"host tokens, {res['batches_per_s']:.1f} batches/s "
        f"({res['gibs']:.3f} GiB/s)")
    for k in ("host_to_hbm", "input_wait", "compute_wait", "cache_fetch",
              "decode"):
        if k in snap:
            log(f"{phase}: {k:>12}: total {snap[k]['total_s']:.4f}s "
                f"p50 {snap[k]['p50'] * 1e3:.3f} ms "
                f"share {summary['fractions'][k]:.3f}")
    return res


def feed_tokens(rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 50257, SHARDS * SHARD_BYTES // 4, dtype=np.int32)


def phase_feed(rng: np.random.Generator, dev: torch.device, root: str
               ) -> dict:
    from curvine_tpu_torch.gpu.loader import PosixTrainFeed, write_posix_shards
    tokens = feed_tokens(rng)
    shard_dir = os.path.join(root, "shards")
    write_posix_shards(shard_dir, tokens, SHARD_BYTES // 4)
    expect = torch.from_numpy(tokens).to(dev)
    n_expect = tokens.size // (BATCH * SEQ)

    async def run():
        feed = PosixTrainFeed(shard_dir, BATCH, SEQ, depth=2, device=dev)
        return await drive_feed(feed, expect, dev), feed.profiler

    (n, bad, secs), prof = asyncio.run(run())
    if n != n_expect or bad:
        raise AssertionError(f"feed: {n}/{n_expect} batches, {bad} tokens "
                             f"differ from the host tokens")
    return feed_stats("feed", n, secs, prof)


# ------------------------------------------------------------ the cluster

def master_conf(root: str, port: int = 0, lost_ms: int = 30_000,
                policy: str = "local", rpc: dict | None = None) -> str:
    """The cluster's TOML file for the port's master: the loopback
    ``port`` (0: the master binds a free one and prints it; a restart is
    given that one, so the worker and the client find it again), its
    journal under ``root`` and its KV metadata store beside it
    (``<journal_dir>-meta``, the native engine: the reference's default
    store, and no fallback), the lost timeout (the JAX cluster's by
    default), the heartbeat check, the placement ``policy``, this
    process's user as the superuser (the port's client names the OS
    user) and ``rpc``, the ``[rpc]`` table's keys (its defaults when
    None)."""
    from curvine_tpu_torch.client.fs_client import _os_user
    path = os.path.join(root, "cluster.toml")
    with open(path, "w") as f:
        f.write(f"""[master]
hostname = "127.0.0.1"
rpc_port = {port}
journal_dir = "{os.path.join(root, 'cluster', 'journal')}"
worker_lost_timeout_ms = {lost_ms}
heartbeat_check_ms = 200
block_placement_policy = "{policy}"
superuser = "{_os_user()}"
meta_store = "kv"
meta_engine = "native"
""")
        if rpc:
            f.write("[rpc]\n" + "".join(f"{k} = {json.dumps(v)}\n"
                                        for k, v in rpc.items()))
    return path


def start_master(root: str, conf: str, n: int = 0):
    """``python -m curvine_tpu_torch.master --conf conf`` in its own
    process, its counts written to ``root/master<n>.json`` when it stops.
    Returns the process and its JSON line (address, pid, ``jax_free``,
    ``recover_s``) with ``start_s``, the seconds from the launch to the
    line; raises when the line does not come within MASTER_START_S or
    the master loaded a module of JAX or of the JAX package."""
    return master_line(*launch_master(root, conf, n))


def launch_master(root: str, conf: str, n: int = 0):
    """``start_master``'s launch: the process, not waited for."""
    err = open(os.path.join(root, f"master{n}.err"), "wb")
    t = time.perf_counter()
    out = os.path.join(root, f"master{n}.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "curvine_tpu_torch.master", "--conf", conf,
         "--metrics-out", out], cwd=HERE, stdout=subprocess.PIPE, stderr=err)
    err.close()
    proc.metrics_out, proc.launched = out, time.time()
    return root, n, proc, t


def master_line(root: str, n: int, proc, t: float):
    """``start_master``'s wait for the launched master's JSON line."""
    import select
    ready, _, _ = select.select([proc.stdout], [], [], MASTER_START_S)
    line = proc.stdout.readline() if ready else b""
    if not line:
        stop_master(proc)
        with open(os.path.join(root, f"master{n}.err"), "rb") as f:
            tail = f.read()[-4000:].decode(errors="replace")
        raise RuntimeError(f"the port's master did not start (exit "
                           f"{proc.returncode}):\n{tail}")
    info = json.loads(line)
    info["start_s"] = time.perf_counter() - t
    log(f"master: the port's master (pid {info['pid']}) serves at "
        f"{info['addr']}, {info['start_s']:.3f}s after its launch "
        f"(construction to serving, journal replay and bind, "
        f"{info['recover_s']:.3f}s of it); modules of "
        f"JAX or the JAX package loaded there: "
        f"{'none' if info['jax_free'] else 'SOME'}")
    if info["jax_free"] is not True:
        stop_master(proc)
        raise AssertionError("the port's master loaded a module of JAX or "
                             "of the JAX package")
    return proc, info


def stop_master(proc) -> None:
    """Stop the master and file its writers' breaks (``master_breaks``)."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    proc.stdout.close()
    if not hasattr(proc, "breaks"):
        proc.breaks = master_breaks(proc)
        WRITER_BREAKS.extend(proc.breaks)


def master_breaks(proc) -> list[tuple[str, str, bool]]:
    """The stopped master's writer breaks, as WRITER_BREAKS entries, from
    the counters of its ``--metrics-out`` dump: ``rpc.writer_breaks``,
    ``rpc.writer_breaks_peer_gone`` of them where the client had left.
    A master killed by SIGKILL writes no dump and files none: every
    phase that kills one is in BREAKS_EXPECTED."""
    if not hasattr(proc, "metrics_out"):
        return []
    try:
        if os.path.getmtime(proc.metrics_out) < proc.launched:
            return []                       # an earlier run's dump
        with open(proc.metrics_out) as f:
            c = json.load(f)["counters"]
    except (OSError, ValueError, KeyError):
        return []
    if c.get("blocks.report_kept"):
        REPORTS_KEPT[f"master pid {proc.pid}"] = c["blocks.report_kept"]
    n, gone = c.get("rpc.writer_breaks", 0), \
        c.get("rpc.writer_breaks_peer_gone", 0)
    name = f"master pid {proc.pid}"
    return [(name, "counted in its dump, its stderr has the error",
             k < gone) for k in range(n)]


class PortWorker:
    """The port's ``WorkerServer`` in this process, on a thread with its
    own event loop (the phases' clients run their own loops and reach it
    over loopback TCP, and the worker phase takes device tensors from
    ``worker.hbm``): a mem tier of ``tier_bytes`` under ``root``, a device
    tier-0 of ``hbm_bytes`` on ``dev``, 64 MiB blocks, no periodic promote
    cycle (the worker phase runs its cycles itself), ICI coordinates
    ``coords``; it joins the device domain of this process. ``master``
    is one master's address or a raft group's list; ``report_ms``, when
    set, is its full block report's period; ``tier`` names the tier's
    storage type, and ``worker`` sets other fields of its conf (the shm
    plane's)."""

    def __init__(self, master, root: str, tier_bytes: int,
                 dev: torch.device, coords=(), hbm_bytes: int = TIER_BYTES,
                 report_ms: int = 0, tier: str = "mem", **worker):
        import threading
        from curvine_tpu_torch.common.conf import ClusterConf, TierConf
        from curvine_tpu_torch.worker.server import WorkerServer
        conf = ClusterConf()
        conf.client.master_addrs = _addrs(master)
        if report_ms:
            conf.worker.block_report_interval_ms = report_ms
        conf.client.block_size = BLOCK
        wc = conf.worker
        wc.hostname, wc.rpc_port = "127.0.0.1", 0
        wc.heartbeat_ms = WORKER_HEARTBEAT_MS
        wc.promote_interval_ms = 0
        wc.promote_min_reads = WORKER_MIN_READS
        wc.tiers = [TierConf(storage_type=tier,
                             dir=os.path.join(root, "worker", tier),
                             capacity=tier_bytes)]
        wc.hbm_capacity = hbm_bytes
        wc.ici_coords = list(coords)
        for k, v in worker.items():
            setattr(wc, k, v)
        self.conf = conf
        self.worker = WorkerServer(conf, devices=[dev])
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="port-worker", daemon=True)
        self.thread.start()
        self.call(self.worker.start())

    def call(self, coro, timeout: float = 600):
        """Run ``coro`` on the worker's loop and return its result."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def stop(self) -> None:
        try:
            self.call(self.worker.stop(), timeout=120)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=60)
            if not self.thread.is_alive():
                self.loop.close()


async def live_workers(client) -> list[dict]:
    """The master's live workers (GET_MASTER_INFO), as wire dicts."""
    from curvine_tpu_torch.rpc.codes import RpcCode
    rep = await client.meta.call(RpcCode.GET_MASTER_INFO, {})
    return rep["info"]["live_workers"]


def await_port_worker(master: str, pw: PortWorker, timeout: float = 60
                      ) -> None:
    """Wait until the master lists exactly one live worker, the port's;
    raises otherwise."""
    async def run():
        async with port_client(master) as c:
            t = time.perf_counter()
            while True:
                live = await live_workers(c)
                if live or time.perf_counter() - t > timeout:
                    return live
                await asyncio.sleep(0.1)

    live = asyncio.run(run())
    ids = [w["address"]["worker_id"] for w in live]
    if ids != [pw.worker.worker_id]:
        raise AssertionError(f"the master's live workers are {ids}, not the "
                             f"port's worker {pw.worker.worker_id} alone")


def _addrs(master) -> list[str]:
    return [master] if isinstance(master, str) else list(master)


def port_client(master, coords=(), rpc: dict | None = None,
                obs: dict | None = None, **client):
    """The port's client of ``master`` (an address, or a raft group's
    list); its writes are placed near ICI ``coords``; ``rpc`` and
    ``obs`` set keys of its ``[rpc]`` and ``[obs]`` tables."""
    from curvine_tpu_torch.client.unified import CurvineClient
    from curvine_tpu_torch.common.conf import ClusterConf
    conf = ClusterConf()
    conf.client.master_addrs = _addrs(master)
    conf.worker.ici_coords = list(coords)
    for k, v in client.items():
        setattr(conf.client, k, v)
    for k, v in (rpc or {}).items():
        setattr(conf.rpc, k, v)
    for k, v in (obs or {}).items():
        setattr(conf.obs, k, v)
    c = CurvineClient(conf)
    CLIENT_COUNTERS.append(c.counters)
    return c


# every port client's counters, in the order the clients were made: each
# phase's shared-memory reads are tallied from the clients it made
CLIENT_COUNTERS: list[dict] = []
SHM_KEYS = ("read.shm_hits", "read.shm_warm_hits", "read.shm_fallbacks",
            "read.shm_warm_fallbacks", "sc.bytes.read")


# every first break of a coalesced writer: in this process (the port's
# clients and workers; count_writer_breaks) the writer's name, the
# error, and whether it is a server's writer whose client had already
# left (``peer_gone``); and each master's, filed from its dump when it
# is stopped (stop_master)
WRITER_BREAKS: list[tuple[str, str, bool]] = []
# per stopped master, the replicas a full block report built before they
# landed kept located (ROADMAP C15)
REPORTS_KEPT: dict = {}
# the phases that stop, kill or restart a worker or a master, where a
# connection may break mid-frame (phase wire holds its own reads and its
# call runs to none); a break anywhere else fails the run
BREAKS_EXPECTED = ("recover", "drain", "ec", "kv", "ha", "replicate",
                   "master", "wire", "trace")


def count_writer_breaks() -> None:
    """Record each writer's first break in WRITER_BREAKS (installed once,
    before any phase): a writer breaks when part of a frame may be on the
    wire, and its connection closes."""
    from curvine_tpu_torch.rpc.transport import CoalescedWriter
    real = CoalescedWriter._break
    if getattr(real, "counted", False):
        return

    def _break(self, exc):
        if self.broken is None:
            WRITER_BREAKS.append((
                self.name, f"{type(exc).__name__}: {exc}",
                self.name == "server" and isinstance(
                    exc, (ConnectionResetError, BrokenPipeError))))
        return real(self, exc)

    _break.counted = True
    CoalescedWriter._break = _break


def shm_tally(since: int) -> dict:
    """The shared-memory counters summed over the clients made since
    ``since`` (an index of CLIENT_COUNTERS)."""
    return {k: sum(c.get(k, 0) for c in CLIENT_COUNTERS[since:])
            for k in SHM_KEYS}


def phase_client(rng: np.random.Generator, dev: torch.device, master: str,
                 posix: dict) -> dict:
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_token_shards
    tokens = feed_tokens(rng)
    expect = torch.from_numpy(tokens).to(dev)
    n_expect = tokens.size // (BATCH * SEQ)

    async def run():
        async with port_client(master) as c:
            t = time.perf_counter()
            paths = await write_token_shards(c, "/ds/feed", tokens,
                                             SHARD_BYTES // 4)
            write_s = time.perf_counter() - t
            written = dict(c.counters)
            feed = GpuTrainFeed(c, "/ds/feed", BATCH, SEQ, prefetch=True,
                                device=dev)
            fed = await drive_feed(feed, expect, dev)
            counters = {k: v - written.get(k, 0)
                        for k, v in c.counters.items()}
        # twice: the worker's first READ_BLOCK is its slowest
        raws, rb_s = [], []
        async with port_client(master, short_circuit=False) as c:
            for _ in range(2):
                t = time.perf_counter()
                raws.append(await c.read_all(paths[0]))
                rb_s.append(time.perf_counter() - t)
            rb_counters = dict(c.counters)
            # the shards are the hottest blocks the worker holds: gone,
            # they leave the worker phase's promote cycles to its own
            await c.meta.delete("/ds/feed", recursive=True)
        return paths, write_s, written, fed, feed.profiler, counters, raws, \
            rb_s, rb_counters, dict(feed.source.fetch_split)

    paths, write_s, written, (n, bad, secs), prof, counters, raws, rb_s, \
        rb, split = asyncio.run(run())
    if len(paths) != SHARDS or n != n_expect or bad:
        raise AssertionError(f"client: {len(paths)} shards, {n}/{n_expect} "
                             f"batches, {bad} tokens differ from the host "
                             f"tokens")
    res = feed_stats("client", n, secs, prof)
    sc = counters.get("sc.bytes.read", 0)
    res.update({
        "write_s": write_s, "write_gibs": tokens.nbytes / GiB / write_s,
        "sc_bytes": sc, "read_block_bytes": counters.get(
            "read.zero_copy_bytes", 0),
        "advise_rpcs": counters.get("advise.rpcs", 0),
        "sc_bytes_written": written.get("sc.bytes.written", 0),
        "sc_write_fallbacks": written.get("sc.write.fallbacks", 0),
        "read_block_check_bytes": rb.get("read.zero_copy_bytes", 0),
        "read_block_gibs": SHARD_BYTES / GiB / rb_s[0],
        "read_block_again_gibs": SHARD_BYTES / GiB / rb_s[1],
        "posix_batches_per_s": posix["batches_per_s"],
        "posix_gibs": posix["gibs"],
        "shm_hits": counters.get("read.shm_hits", 0),
        "shm_fallbacks": counters.get("read.shm_fallbacks", 0),
        "fetch_split_ms_per_block": {k: v * 1e3 / SHARDS
                                     for k, v in split.items()}})
    if not all(np.array_equal(np.frombuffer(raw, dtype=np.int32),
                              tokens[:SHARD_BYTES // 4]) for raw in raws):
        raise AssertionError(f"client: {paths[0]} read through READ_BLOCK "
                             f"differs from the host tokens")
    if res["read_block_check_bytes"] != 2 * SHARD_BYTES:
        raise AssertionError(f"client: READ_BLOCK served "
                             f"{res['read_block_check_bytes']} bytes of "
                             f"{2 * SHARD_BYTES}")
    log(f"client: wrote {SHARDS} shards of {SHARD_BYTES // MiB} MiB through "
        f"the port's client in {write_s:.3f}s ({res['write_gibs']:.3f} "
        f"GiB/s; {res['sc_bytes_written']} bytes by short circuit, "
        f"{res['sc_write_fallbacks']} blocks over WRITE_BLOCK); the feed "
        f"read {sc} bytes by short circuit (mmap_view; "
        f"{res['shm_hits']} reads from the worker's sealed memfds, "
        f"{res['shm_fallbacks']} fallbacks; cache_fetch a block: probe "
        f"{res['fetch_split_ms_per_block']['probe']:.3f} ms, map "
        f"{res['fetch_split_ms_per_block']['map']:.3f} ms, copy "
        f"{res['fetch_split_ms_per_block']['copy']:.3f} ms) "
        f"and {res['read_block_bytes']} by READ_BLOCK, sent "
        f"{res['advise_rpcs']} advise RPCs; {res['batches_per_s']:.1f} "
        f"batches/s ({res['gibs']:.3f} GiB/s) against phase 4's POSIX "
        f"{posix['batches_per_s']:.1f} batches/s ({posix['gibs']:.3f} "
        f"GiB/s) on this machine")
    log(f"client: with short circuit off, {paths[0]} read twice through "
        f"READ_BLOCK into the caller's buffer, byte-equal, in "
        f"{rb_s[0]:.3f}s ({res['read_block_gibs']:.3f} GiB/s, the worker's "
        f"first READ_BLOCK) and {rb_s[1]:.3f}s "
        f"({res['read_block_again_gibs']:.3f} GiB/s)")
    if sc == 0:
        raise AssertionError("client: no byte came through the short "
                             "circuit, the path this phase drives")
    if res["sc_bytes_written"] != tokens.nbytes:
        raise AssertionError(f"client: {res['sc_bytes_written']} of "
                             f"{tokens.nbytes} bytes written by short "
                             f"circuit to a worker on this host")
    return res


# ------------------------------------------------------------------ worker

def _timed(fn, into: list):
    """``fn`` with each call's seconds appended to ``into``."""
    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            into.append(time.perf_counter() - t)
    return timed


def phase_worker(rng: np.random.Generator, dev: torch.device, master: str,
                 pw: PortWorker, promote_gibs: float) -> dict:
    """The device tier-0 through the port's worker: 16 hot and 16 cold
    files of one 64 MiB block written through the port's client by short
    circuit, and one more whose block file gets one byte flipped after its
    commit. Until the hot set is pinned: the hot set read once through the
    client, then one promote cycle (at most 256 MiB pinned a cycle, each
    pin verified by K1 on the card). Then a device copy flipped after its
    H2D copy, refused by K1; the pinned tensors against the files; a
    tier-0 hit against the short-circuit read staged to the card;
    HBM_PIN / HBM_UNPIN over the port's connection with the master's view
    between, the refused corrupt block, and a delete's device copy gone
    within 10 heartbeats."""
    from curvine_tpu_torch.gpu import cuda_ops
    from curvine_tpu_torch.gpu.ingest import DeviceCopier
    from curvine_tpu_torch.rpc.client import Connection
    from curvine_tpu_torch.rpc.codes import RpcCode
    from curvine_tpu_torch.rpc.frame import pack
    from curvine_tpu_torch.worker import promote, server
    w = pw.worker
    hot = [f"/worker/hot-{i:02d}" for i in range(WORKER_HOT)]
    cold = [f"/worker/cold-{i:02d}" for i in range(WORKER_COLD)]
    bad = "/worker/corrupt"
    res = {}
    # the client phase's shards, deleted at its end, leave on a heartbeat
    for _ in range(10):
        if not w.store.hot_blocks(WORKER_MIN_READS):
            break
        pw.call(w.heartbeat_once())
    else:
        raise AssertionError(f"worker: blocks already hot before the phase: "
                             f"{w.store.hot_blocks(WORKER_MIN_READS)[:4]}")

    async def setup():
        async with port_client(master) as c:
            ids = {}
            t = time.perf_counter()
            for p in hot + cold + [bad]:
                await c.write_all(p, rng.integers(0, 1 << 64, BLOCK // 8,
                                                  dtype=np.uint64))
                fb = await c.meta.get_block_locations(p)
                ids[p] = fb.block_locs[0].block.id
            return ids, time.perf_counter() - t, dict(c.counters)

    ids, write_s, wrote = asyncio.run(setup())
    n_files = len(ids)
    if wrote.get("sc.bytes.written") != n_files * BLOCK:
        raise AssertionError(f"worker: {wrote} for {n_files} blocks")
    # one byte of the corrupt block's file, after its commit, before a pin
    bad_id = ids[bad]
    with open(w.store.get(bad_id, touch=False).path, "r+b") as f:
        f.seek(BLOCK // 3)
        b = f.read(1)
        f.seek(BLOCK // 3)
        f.write(bytes([b[0] ^ 0x40]))

    async def heat_pass(first: bool) -> None:
        async with port_client(master) as c:
            for p in hot:
                await c.read_all(p)
            if first:
                # heat for the corrupt block as a client reports it, above
                # the hot set's so the first cycle tries it first
                conn = await Connection(w.addr).connect()
                try:
                    await conn.call(RpcCode.SC_READ_REPORT, data=pack(
                        {"block_reads": {bad_id: WORKER_MIN_READS + 1}}))
                finally:
                    await conn.close()

    # each pin's split, timed inside promote_block: the map, the media
    # crc, the host hash, H2D (the put, then its stream synchronised), K1
    # (the launch and the result's read)
    split = {"map": [], "media_crc": [], "host_hash": [], "h2d": [],
             "k1": []}
    real = {n: getattr(promote, n) for n in
            ("map_block", "crc_update", "block_checksum",
             "block_checksum_host")}
    real_put = w.hbm.put

    def h2d_put(block_id, data, device=None):
        t = time.perf_counter()
        out = real_put(block_id, data, device)
        torch.cuda.current_stream(out.device).synchronize()
        split["h2d"].append(time.perf_counter() - t)
        return out

    promote.map_block = _timed(real["map_block"], split["map"])
    promote.crc_update = _timed(real["crc_update"], split["media_crc"])
    promote.block_checksum_host = _timed(real["block_checksum_host"],
                                         split["host_hash"])
    promote.block_checksum = _timed(real["block_checksum"], split["k1"])
    w.hbm.put = h2d_put
    hot_ids = [ids[p] for p in hot]
    cycle_s, read_s = [], []
    try:
        cuda_ops.block_checksum.launches = 0
        while not all(w.hbm_holds(b) for b in hot_ids) and len(cycle_s) < 8:
            t = time.perf_counter()
            asyncio.run(heat_pass(not cycle_s))
            read_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            pw.call(w._promote_once())
            cycle_s.append(time.perf_counter() - t)
        launches = cuda_ops.block_checksum.launches
    finally:
        for n, fn in real.items():
            setattr(promote, n, fn)
        del w.hbm.put
    counters = dict(w.metrics.counters)
    pins = counters.get("blocks.hbm_pinned", 0)
    pinned_bytes = pins * BLOCK
    res.update(files=n_files, write_s=write_s,
               write_gibs=n_files * BLOCK / GiB / write_s, cycles=len(cycle_s),
               cycle_s=cycle_s, read_pass_s=read_s, pins=pins,
               pinned_bytes=pinned_bytes, k1_launches=launches,
               autopin_gibs=pinned_bytes / GiB / sum(cycle_s),
               promote_gibs=promote_gibs,
               corrupt=counters.get("blocks.corrupt", 0),
               corrupt_reported=counters.get("blocks.corrupt_reported", 0),
               split_ms={k: [x * 1e3 for x in v] for k, v in split.items()},
               split_median_ms={k: statistics.median(v) * 1e3
                                for k, v in split.items() if v})
    log(f"worker: wrote {n_files} blocks of 64 MiB through the port's "
        f"client in {write_s:.3f}s ({res['write_gibs']:.3f} GiB/s, all by "
        f"short circuit); {len(cycle_s)} promote cycles pinned {pins} "
        f"blocks ({pinned_bytes / GiB:.2f} GiB) in {sum(cycle_s):.3f}s: "
        f"autopin_gibs {res['autopin_gibs']:.3f} against phase 3's "
        f"promote_gibs {promote_gibs:.3f} on this machine; K1 launches "
        f"{launches}; read passes {sum(read_s):.3f}s")
    sm = res["split_median_ms"]
    log(f"worker: a pin's split, median ms: map {sm['map']:.3f}, media crc "
        f"{sm['media_crc']:.2f}, host hash {sm['host_hash']:.2f}, H2D "
        f"{sm['h2d']:.2f}, K1 {sm['k1']:.3f}")
    missing = [b for b in hot_ids if not w.hbm_holds(b)]
    cold_pinned = [ids[p] for p in cold if w.hbm_holds(ids[p])]
    if missing or cold_pinned or pins != WORKER_HOT \
            or len(cycle_s) != -(-WORKER_HOT * BLOCK // server.PIN_BUDGET):
        raise AssertionError(f"worker: {len(cycle_s)} cycles, {pins} pins, "
                             f"hot missing {missing}, cold pinned "
                             f"{cold_pinned}")
    if launches != pins or len(split["k1"]) != pins:
        raise AssertionError(f"worker: {launches} K1 launches for {pins} "
                             f"pins")
    if w.hbm_holds(bad_id) or res["corrupt"] != 1 \
            or res["corrupt_reported"] != 1:
        raise AssertionError(f"worker: the corrupt block: in the tier "
                             f"{w.hbm_holds(bad_id)}, counted "
                             f"{res['corrupt']}, reported "
                             f"{res['corrupt_reported']}")
    log(f"worker: every hot block in the tier-0, no cold one; the corrupt "
        f"block refused by its media crc, counted (blocks.corrupt "
        f"{res['corrupt']}) and reported to the master")

    # a good media copy whose device copy diverges after the H2D copy:
    # refused by K1 on the card, on the worker's own promotion
    flip_id = ids[cold[1]]

    def flip_put(block_id, data, device=None):
        out = real_put(block_id, data, device)
        if block_id == flip_id:
            out[BLOCK // 5] ^= 0x01
        return out

    w.hbm.put = flip_put
    try:
        cuda_ops.block_checksum.launches = 0
        flip_pinned = pw.call(w._autopin_block(flip_id))
        flip_launches = cuda_ops.block_checksum.launches
    finally:
        del w.hbm.put
    after = dict(w.metrics.counters)
    if flip_pinned or flip_launches != 1 or w.hbm_holds(flip_id) \
            or after.get("blocks.corrupt") != res["corrupt"] + 1 \
            or after.get("blocks.corrupt_reported") != \
            res["corrupt_reported"] + 1 \
            or after.get("blocks.hbm_pinned") != pins:
        raise AssertionError(f"worker: the diverging device copy: pinned "
                             f"{flip_pinned} bytes, K1 launches "
                             f"{flip_launches}, in the tier "
                             f"{w.hbm_holds(flip_id)}, counters {after}")
    res.update(k1_refused_launches=flip_launches,
               k1_launches=launches + flip_launches)
    log(f"worker: a device copy flipped after its H2D copy refused by K1 "
        f"({flip_launches} launch), counted (blocks.corrupt "
        f"{after['blocks.corrupt']}) and reported; not pinned")

    # the pinned tensors against the files, on the card, as integers
    for bid in hot_ids:
        got = w.hbm_get(bid)
        ref = torch.from_numpy(np.fromfile(
            w.store.get(bid, touch=False).path, dtype=np.uint8)).to(dev)
        if not torch.equal(got.view(torch.int64), ref.view(torch.int64)):
            raise AssertionError(f"worker: block {bid}: device bytes differ")
    del ref

    # a tier-0 hit against the short-circuit read staged to the card
    hit_bid, hit_path = hot_ids[0], hot[0]

    dst = torch.empty(BLOCK, dtype=torch.uint8, device=dev)

    def hit(use: bool) -> float:
        """The tier's lookup alone, or with a first use that moves every
        byte: a device-to-device copy of the block."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = w.hbm_get(hit_bid)
        if use:
            dst.copy_(got)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    async def staged():
        copier = DeviceCopier(dev)
        fetch, stage = [], []
        async with port_client(master) as c:
            r = await c.open(hit_path)
            try:
                for _ in range(16):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    view = await r.mmap_view(0, BLOCK)
                    t1 = time.perf_counter()
                    out = copier.deliver(copier.transfer(view))
                    torch.cuda.synchronize()
                    fetch.append(t1 - t)
                    stage.append(time.perf_counter() - t1)
            finally:
                await r.close()
        return fetch, stage, out

    lookups = [hit(False) for _ in range(16)]
    hits = [hit(True) for _ in range(16)]
    if not torch.equal(dst.view(torch.int64),
                       w.hbm_get(hit_bid).view(torch.int64)):
        raise AssertionError("worker: the tier-0 hit's copy differs")
    fetch, stage, out = asyncio.run(staged())
    if not torch.equal(out.view(torch.int64),
                       w.hbm_get(hit_bid).view(torch.int64)):
        raise AssertionError("worker: the staged block differs from the "
                             "tier-0's")
    del out, dst
    res.update(hit_ms=statistics.median(hits) * 1e3,
               lookup_ms=statistics.median(lookups) * 1e3,
               cache_fetch_ms=statistics.median(fetch) * 1e3,
               host_to_hbm_ms=statistics.median(stage) * 1e3,
               staged_ms=statistics.median(
                   [a + b for a, b in zip(fetch, stage)]) * 1e3)
    log(f"worker: a 64 MiB block from the tier-0 in {res['hit_ms']:.4f} ms "
        f"(hbm_get and a device-to-device copy of the block, median of 16; "
        f"the lookup alone {res['lookup_ms']:.4f} ms) against "
        f"{res['staged_ms']:.3f} ms by short circuit and staging "
        f"(cache_fetch {res['cache_fetch_ms']:.3f} + host_to_hbm "
        f"{res['host_to_hbm_ms']:.3f})")

    async def rpc_and_master():
        cold_id = ids[cold[0]]
        conn = await Connection(w.addr).connect()
        try:
            rep = (await conn.call(RpcCode.HBM_PIN, data=pack(
                {"block_id": cold_id}))).header
            if rep["len"] != BLOCK or rep["holders"] != [0] \
                    or not w.hbm_holds(cold_id):
                raise AssertionError(f"worker: HBM_PIN answered {rep}")
            await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                w.heartbeat_once(), pw.loop))
            async with port_client(master) as c:
                live = await live_workers(c)
            hbm = [s for x in live for s in x["storages"]
                   if s["storage_type"] == -1]
            if [x["address"]["worker_id"] for x in live] != [w.worker_id] \
                    or [(s["dir_id"], s["capacity"]) for s in hbm] != \
                    [("hbm:0", TIER_BYTES)]:
                raise AssertionError(f"worker: the master sees {live}")
            await conn.call(RpcCode.HBM_UNPIN, data=pack(
                {"block_id": cold_id}))
            if w.hbm_holds(cold_id):
                raise AssertionError("worker: HBM_UNPIN left the copy")
            return hbm[0]
        finally:
            await conn.close()

    res["master_hbm_storage"] = asyncio.run(rpc_and_master())
    log(f"worker: HBM_PIN of a cold block over the port's connection: len "
        f"{BLOCK}, holders [0]; the master lists the port's worker alone, "
        f"with {res['master_hbm_storage']}; HBM_UNPIN dropped the copy")

    async def delete():
        async with port_client(master) as c:
            await c.meta.delete(hot[1])
        for k in range(1, 11):
            await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                w.heartbeat_once(), pw.loop))
            if not w.hbm_holds(hot_ids[1]):
                return k
        return None

    beats = asyncio.run(delete())
    if beats is None or w.store.contains(hot_ids[1]):
        raise AssertionError("worker: a deleted block's device copy stayed "
                             "10 heartbeats")
    res["delete_heartbeats"] = beats
    log(f"worker: {hot[1]} deleted through the port's client; its device "
        f"copy gone after {beats} heartbeat(s)")
    return res


# K3 against its plain version. The plain version rounds P to bf16 after
# normalising it, the forward kernel before (against a running maximum),
# and both round their f32 sums, taken in other orders, to bf16. So an
# element may be off by the rounding of its own value (2 bf16 ulps of
# it) plus a sum of small rounding differences of P (and dS) that scales
# with its row, not with the element: near zero an element has no ulps
# to spare. The floor is FLASH_ROW_FLOOR_ULPS bf16 ulps of its row's
# scale: the median magnitude of the row (a query row of o and dq, a key
# row of dk and dv), or of the whole tensor where that is larger, since
# a row may be nothing but rounding (dQ's first row is exactly 0: dS of
# a row sums to 0 and that row has one key). A row as a whole, against
# its norm or the median row norm where that is larger, and the whole
# tensor must agree to FLASH_ROW_REL and FLASH_REL in relative norm: a
# kernel that drops or mis-scales a tile moves whole rows. lse is f32,
# sums of up to L exponentials in another order and __expf's few-ulp
# error: 1e-4 at |lse| <= 20. di is f32, a sum of L products P dP: 1e-4
# of its own magnitude plus 1e-4 of the median one.
FLASH_ELEM_ULPS = 2
FLASH_ROW_FLOOR_ULPS = 8
FLASH_ROW_REL = 1e-2
FLASH_REL = 1e-2
FLASH_LSE_ABS = 1e-4
FLASH_DI_REL = 1e-4


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) at each magnitude of ``x``."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def flash_pairs(q, k, v, do) -> dict:
    """Each K3 kernel's outputs beside its plain version's, in f32 from
    the same bf16 inputs, the same ``do`` and the same residuals (lse, di
    from the kernels)."""
    from curvine_tpu_torch.gpu import flash
    o, lse = flash.flash_fwd(q, k, v)
    di = flash.flash_bwd_di(q, k, v, do, lse)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, di)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, di)
    o_p, lse_p = flash.flash_fwd_plain(q, k, v)
    di_p = flash.flash_bwd_di_plain(q, k, v, do, lse)
    dq_p, dk_p, dv_p = flash.flash_bwd_plain(q, k, v, do, lse, di)
    return {"o": (o, o_p), "dk": (dk, dk_p), "dv": (dv, dv_p),
            "dq": (dq, dq_p), "lse": (lse, lse_p), "di": (di, di_p)}


def flash_errors(name: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far ``got`` is from ``ref`` against the limits above:
    ``elem_ratio`` is the largest error over its element's tolerance and
    ``ok`` whether every limit holds."""
    g, r = got.float(), ref.float()
    err, mag = (g - r).abs(), r.abs()
    med = mag.median()
    if name == "lse":
        tol = torch.full_like(mag, FLASH_LSE_ABS)
    elif name == "di":
        tol = FLASH_DI_REL * (mag + med)
    else:
        row_scale = mag.median(dim=-1, keepdim=True).values.clamp_min(med)
        tol = (FLASH_ELEM_ULPS * _bf16_ulp(mag)
               + FLASH_ROW_FLOOR_ULPS * _bf16_ulp(row_scale))
    out = {"max_abs_err": err.max().item(), "max_abs_ref": mag.max().item(),
           "median_abs_ref": med.item(),
           "elem_ratio": (err / tol).max().item(),
           "rel": (err.norm() / r.norm()).item()}
    ok = out["elem_ratio"] <= 1.0
    if name in ("o", "dk", "dv", "dq"):
        norms = r.norm(dim=-1)
        out["row_rel"] = (err.norm(dim=-1) / norms.clamp_min(
            norms.median())).max().item()
        ok = ok and out["row_rel"] <= FLASH_ROW_REL and out["rel"] <= FLASH_REL
    out["ok"] = ok
    return out


def flash_bounds(shape) -> dict:
    """Each K3 kernel's least time on the card at ``shape``: the larger of
    its operations (the causal half: L(L+1)/2 query-key pairs a head, 2D
    FLOP a pair a product) over the bf16 peak, and its bytes (each input
    read once, each output written once) over the memory rate."""
    B, H, L, D = shape
    prod = 2 * D * B * H * L * (L + 1) / 2      # FLOP of one product
    t = B * H * L * D * 2                       # bytes of one bf16 operand
    r = B * H * L * 4                           # bytes of one f32 row vector
    work = {
        # S, P V; q, k, v in, o and lse out
        "flash_fwd": (2 * prod, 4 * t + r),
        # S, dP; q, k, v, do, lse in, di out
        "flash_bwd_di": (2 * prod, 4 * t + 2 * r),
        # S, dP, dV, dK; q, k, v, do, lse, di in, dk, dv out
        "flash_bwd_dkv": (4 * prod, 6 * t + 2 * r),
        # S, dP, dQ; q, k, v, do, lse, di in, dq out
        "flash_bwd_dq": (3 * prod, 5 * t + 2 * r),
    }
    out = {}
    for name, (flop, nbytes) in work.items():
        ops_ms = flop / BF16_FLOP_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"flop": flop, "bytes": nbytes,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes"}
    return out


def phase_flash(dev: torch.device, seed: int) -> dict:
    import torch.nn.functional as F
    from curvine_tpu_torch.gpu import flash
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {"shapes": {}}
    main = None
    for shape in FLASH_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        pairs = flash_pairs(q, k, v, do)
        torch.cuda.synchronize()
        errs = {n: flash_errors(n, g, r) for n, (g, r) in pairs.items()}
        lse, di = pairs["lse"][0], pairs["di"][0]
        bad = {n: e for n, e in errs.items() if not e["ok"]}
        if bad:
            raise AssertionError(f"flash {shape}: kernel and plain version "
                                 f"disagree: {bad}")
        res["shapes"][str(list(shape))] = errs
        log(f"flash: {list(shape)} kernel vs plain: " + "; ".join(
            f"{n} max abs err {e['max_abs_err']:.3g} (|ref| median "
            f"{e['median_abs_ref']:.3g}, max {e['max_abs_ref']:.3g}), "
            f"worst element at {e['elem_ratio']:.3f} of its tolerance"
            + (f", worst row rel {e['row_rel']:.2e}" if "row_rel" in e
               else "") + f", rel {e['rel']:.2e}" for n, e in errs.items()))
        if main is None:
            main = (shape, q, k, v, do, pairs["o"][0], lse, di, errs)
        del pairs
    shape, q, k, v, do, o, lse, di, errs = main
    scratch = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)

    def med(fn, prep=None):
        fn()
        torch.cuda.synchronize()
        return statistics.median(event_ms(fn, 20, scratch, prep=prep))

    fwd_ms = med(lambda: flash.flash_fwd(q, k, v))
    di_ms = med(lambda: flash.flash_bwd_di(q, k, v, do, lse))
    dkv_ms = med(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, di))
    dq_ms = med(lambda: flash.flash_bwd_dq(q, k, v, do, lse, di))
    fwd_plain_ms = med(lambda: flash.flash_fwd_plain(q, k, v))
    di_plain_ms = med(lambda: flash.flash_bwd_di_plain(q, k, v, do, lse))
    bwd_plain_ms = med(lambda: flash.flash_bwd_plain(q, k, v, do, lse, di))
    # yardstick only: PyTorch's fused attention, forward, and its
    # backward (dq, dk, dv in one call) through autograd
    sdpa_fwd_ms = med(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd_ms = med(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    # the library's di = rowsum(o * do) from the forward's bf16 o: too
    # coarse for dQ (PERF.md §6), a yardstick of speed only
    vecdot_ms = med(lambda: torch.linalg.vecdot(o, do, dim=-1))
    del out, qg, kg, vg, o, scratch
    bounds = flash_bounds(shape)
    err_of = {"flash_fwd": max(errs["o"]["max_abs_err"],
                               errs["lse"]["max_abs_err"]),
              "flash_bwd_di": errs["di"]["max_abs_err"],
              "flash_bwd_dkv": max(errs["dk"]["max_abs_err"],
                                   errs["dv"]["max_abs_err"]),
              "flash_bwd_dq": errs["dq"]["max_abs_err"]}
    timed = {"flash_fwd": (fwd_ms, fwd_plain_ms, sdpa_fwd_ms),
             "flash_bwd_di": (di_ms, di_plain_ms, vecdot_ms),
             "flash_bwd_dkv": (dkv_ms, bwd_plain_ms, sdpa_bwd_ms),
             "flash_bwd_dq": (dq_ms, bwd_plain_ms, sdpa_bwd_ms)}
    res["kernels"] = {}
    for name, (ms, plain_ms, lib_ms) in timed.items():
        b = bounds[name]
        res["kernels"][name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "max_abs_err": err_of[name], "flop": b["flop"],
            "bytes": b["bytes"], "tflops": b["flop"] / ms / 1e9}
        lib = "vecdot(o, do)" if name == "flash_bwd_di" else "sdpa"
        log(f"flash: {name} at {list(shape)}: {ms:.4f} ms "
            f"({b['flop'] / ms / 1e9:.1f} TFLOP/s), bound {b['bound_ms']:.4f}"
            f" ms by {b['bound_by']} ({b['bound_ms'] / ms:.1%} of it); "
            f"plain {plain_ms:.4f} ms; {lib} {lib_ms:.4f} ms")
    log("flash: the plain backward and sdpa's backward compute dq, dk and "
        "dv in one call: their time stands beside both backward kernels; "
        "di's yardstick is the library's formula, rowsum(o * do) from the "
        "bf16 o, not the function the kernel computes")
    return res


def _flagship():
    from curvine_tpu_torch.gpu.model import ModelConfig
    # bench.py:1751-1755
    return ModelConfig(vocab=32_000, d_model=2560, n_heads=20, n_layers=12,
                       d_ff=10_240, max_seq=1024, dtype="bfloat16",
                       use_flash_attention=True, ce_chunk=2048)


K3_NAMES = ("flash_fwd", "flash_bwd_di", "flash_bwd_dkv", "flash_bwd_dq")


def device_work(prof) -> tuple[list, float]:
    """Work on the card in a profile: kernels and copies, less CUPTI's
    "Command Buffer Full" spans (the host waiting on a full launch queue)
    and the device-side ranges of user annotations; and the busy time in
    microseconds, the union of their spans."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation and e.name != "Command Buffer Full"]
    busy_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return kern, busy_us


def flash_gate_check(dev: torch.device, seed: int) -> dict:
    """A float32 model at head_dim 128, flash attention asked for, one
    layer forward at L 128 on the card: the gate admits it, as the
    reference's does on the TPU, and the kernels' argument check refuses
    it (they take bf16 only) with a ValueError before any launch; it never
    runs quietly as dense attention. The same model with flash attention
    off runs dense, finite."""
    import dataclasses
    from curvine_tpu_torch.gpu import flash, model as tm
    cfg = tm.ModelConfig(vocab=128, d_model=256, n_heads=2, n_layers=1,
                         d_ff=512, max_seq=128, dtype="float32",
                         use_flash_attention=True)
    params = tm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, dev)
    tok = torch.randint(0, cfg.vocab, (2, 128), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 1), dtype=torch.int32)
    before = flash.flash_fwd.launches
    refused = ""
    with torch.no_grad():
        try:
            tm.forward(params, tok, cfg)
        except ValueError as e:
            refused = str(e)
        dense = tm.forward(params, tok, dataclasses.replace(
            cfg, use_flash_attention=False))
    torch.cuda.synchronize()
    ok = ("bf16" in refused and flash.flash_fwd.launches == before
          and tm._flash_eligible(cfg, 128, dev)
          and dense.shape == (2, 128, cfg.vocab)
          and bool(torch.isfinite(dense).all()))
    what = f"refused before any launch ({refused})" if ok else "FAILED"
    log(f"train: float32 head_dim 128 with flash attention asked for, one "
        f"layer at L 128: {what}; flash off: dense, logits "
        f"{tuple(dense.shape)}")
    if not ok:
        raise AssertionError(f"the flash path took or hid a float32 config "
                             f"(error {refused!r})")
    return {"refused": refused, "dense_shape": list(dense.shape)}


def train_tokens(cfg, seed: int) -> np.ndarray:
    """bench.py:1761-1763: batch·seq·(steps+2) tokens, one batch a shard."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, TRAIN_BATCH * TRAIN_SEQ * (TRAIN_STEPS + 2),
        dtype=np.int32)


async def timed_steps(step, params, batches, check=None):
    """bench.py:1777-1791: batch k+1's fetch and copy overlap step k (the
    step returns once its work is queued); one sync a step. ``check`` is
    called on each batch before its step."""
    times, losses = [], []
    nxt = await anext(batches, None)
    while nxt is not None:
        if check is not None:
            check(nxt)
        t = time.perf_counter()
        loss = step(params, nxt)
        nxt = await anext(batches, None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss)
    return times, [float(x) for x in losses]


async def repeat(tok, n):
    for _ in range(n):
        yield tok


def synthetic_batch(cfg, seed: int, dev: torch.device) -> torch.Tensor:
    """The fixed batch of the synthetic steps."""
    return torch.from_numpy(np.random.default_rng(seed + 5).integers(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ), dtype=np.int32)).to(dev)


def profiled_steps(step, params, tok) -> tuple[object, float, list, float]:
    """Two steps under the profiler: the profile, wall seconds, the
    device's work and its busy microseconds (``device_work``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(2):
            step(params, tok)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    kern, busy_us = device_work(prof)
    return prof, wall_s, kern, busy_us


def phase_train(dev: torch.device, master: str, seed: int, flash_res: dict
                ) -> tuple[dict, dict, object]:
    """The flagship trained on the card; returns its numbers, its
    parameters as the steps left them and its step (with its AdamW)."""
    from curvine_tpu_torch.gpu import flash, model as tm
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_token_shards
    cfg = _flagship()
    B, L, steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    tokens = train_tokens(cfg, seed)

    async def write():
        async with port_client(master) as c:
            return await write_token_shards(c, "/ds/train", tokens,
                                            shard_tokens=B * L)

    n_shards = len(asyncio.run(write()))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, dev)
    n_params = tm.n_params(params)
    opt = tm.make_optimizer(params)
    step = tm.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    log(f"train: {n_params:,} parameters initialised on {dev} in "
        f"{time.perf_counter() - t0:.2f}s")
    D, Fd = cfg.d_model, cfg.d_ff
    expect = (cfg.vocab + cfg.max_seq + 1) * D + cfg.n_layers * (
        4 * D * D + 2 * D * Fd + 2 * D)         # 1,028,323,840
    if n_params != expect:
        raise AssertionError(f"{n_params} parameters, {expect} expected")

    async def cache_fed():
        async with port_client(master) as c:
            feed = GpuTrainFeed(c, "/ds/train", B, L, depth=2, device=dev)
            return feed.profiler, await timed_steps(
                step, params, feed.prefetcher), \
                c.counters.get("sc.bytes.read", 0)

    tok0 = synthetic_batch(cfg, seed, dev)
    kernels = [getattr(flash, n) for n in K3_NAMES]
    for fn in kernels:
        fn.launches = 0
    feed_prof, (cache_times, cache_losses), sc_bytes = asyncio.run(
        cache_fed())
    synth_times, synth_losses = asyncio.run(timed_steps(
        step, params, repeat(tok0, steps)))
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    n_steps = len(cache_times) + len(synth_times)
    for name, n in launches.items():
        if n != cfg.n_layers * n_steps:
            raise AssertionError(f"{name} launched {n} times in {n_steps} "
                                 f"steps of {cfg.n_layers} layers")
    losses = cache_losses + synth_losses
    if len(cache_times) != steps + 2 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: {len(cache_times)} cache-fed steps, "
                             f"losses {losses}")
    step_s = statistics.median(cache_times[1:])      # the first warms up
    synth_s = statistics.median(synth_times)
    tokens_per_step = B * L
    mfu = 6.0 * n_params * tokens_per_step / step_s / BF16_FLOP_PER_S
    k3_ms = sum(flash_res["kernels"][n]["ms"] for n in K3_NAMES)
    k3_share = cfg.n_layers * k3_ms / (step_s * 1e3)
    fractions = feed_prof.summary()["fractions"]
    res = {"params": n_params, "batch": B, "seq": L,
           "train_step_ms": step_s * 1e3, "train_step_synth_ms": synth_s * 1e3,
           "ingest_overlap_ratio": step_s / synth_s,
           "tokens_per_s": tokens_per_step / step_s, "mfu": mfu,
           "peak_bytes": peak, "losses_cache_fed": cache_losses,
           "losses_synthetic": synth_losses,
           "step_ms_cache_fed": [t * 1e3 for t in cache_times],
           "step_ms_synthetic": [t * 1e3 for t in synth_times],
           "launches": launches, "k3_share_of_step": k3_share,
           "feed_fractions": fractions, "shards": n_shards,
           "feed_sc_bytes": sc_bytes}
    if sc_bytes != tokens.nbytes:
        raise AssertionError(f"train: the client feed read {sc_bytes} of "
                             f"{tokens.nbytes} bytes by short circuit")
    log(f"train: cache-fed steps read {n_shards} shards of {B}x{L} int32 "
        f"through the port's client (/ds/train, {sc_bytes} bytes by short "
        f"circuit)")
    log(f"train: cache-fed step times ms "
        f"{[round(t * 1e3, 2) for t in cache_times]} (first dropped); "
        f"synthetic {[round(t * 1e3, 2) for t in synth_times]}")
    log(f"train: losses cache-fed {[round(x, 4) for x in cache_losses]}; "
        f"synthetic {[round(x, 4) for x in synth_losses]}")
    log(f"train: train_step_ms {res['train_step_ms']:.2f} "
        f"train_step_synth_ms {res['train_step_synth_ms']:.2f} "
        f"ingest_overlap_ratio {res['ingest_overlap_ratio']:.4f} "
        f"tokens_per_s {res['tokens_per_s']:.0f} mfu {mfu:.4f} (6 x "
        f"params x tokens / step / 989 TFLOP/s) peak "
        f"{peak / GiB:.2f} GiB; K3 launches {launches} in {n_steps} steps; "
        f"K3 share of the step {k3_share:.3f} ({cfg.n_layers} x "
        f"{k3_ms:.3f} ms / {step_s * 1e3:.2f} ms); feed input_wait "
        f"{fractions.get('input_wait', 0.0):.3f} host_to_hbm "
        f"{fractions.get('host_to_hbm', 0.0):.3f}")

    # where the step goes: two synthetic steps under the profiler
    prof, wall_s, kern, busy_us = profiled_steps(step, params, tok0)
    k3_us = sum(e.time_range.elapsed_us() for e in kern
                if "flash_" in e.name)
    res["profile"] = {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
                      "k3_device_ms": k3_us / 1e3, "device_events": len(kern)}
    if kern:
        log(f"train: profiler, 2 steps: wall {wall_s * 1e3:.1f} ms, device "
            f"kernels {busy_us / 1e3:.1f} ms (busy share "
            f"{busy_us / 1e3 / (wall_s * 1e3):.3f}), K3 {k3_us / 1e3:.1f} ms"
            f" ({k3_us / max(busy_us, 1):.3f} of device time)")
        for line in prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=14,
                max_name_column_width=48).splitlines():
            log(f"  {line}")
    else:
        log("train: the profiler recorded no device time (not measured)")
    del prof, kern

    # the loss alone, forward and backward, on hidden states of the
    # flagship's batch: peak memory chunked (one [ce_chunk, V] f32 slice
    # of logits alive at a time) and one-shot (all B·(L-1) rows at once)
    x = torch.randn(B * (L - 1), cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed)
                    ).to(torch.bfloat16).requires_grad_(True)
    targets = torch.from_numpy(tokens[:B * (L - 1)]).to(dev).long()
    ce_peak = {}
    for name, chunk in (("chunked", cfg.ce_chunk), ("one_shot", 0)):
        for p in tm.leaves(params):
            p.grad = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        loss = (tm._chunked_ce(x, targets, params["embed"], chunk) if chunk
                else tm._oneshot_ce(x, targets, params["embed"]))
        loss.backward()
        torch.cuda.synchronize()
        ce_peak[name] = torch.cuda.max_memory_allocated(dev) - base
        x.grad = None
        del loss
    res["ce_peak_bytes"] = ce_peak
    log(f"train: cross entropy of {B * (L - 1)} rows x {cfg.vocab} vocab, "
        f"forward and backward: peak {ce_peak['chunked'] / GiB:.3f} GiB "
        f"above its inputs in chunks of {cfg.ce_chunk}, "
        f"{ce_peak['one_shot'] / GiB:.3f} GiB one-shot")
    del x, targets

    # full width, batch 2: the kernel path against the plain versions
    check = torch.from_numpy(tokens[:CHECK_BATCH * L].reshape(
        CHECK_BATCH, L)).to(dev)
    leaves = tm.leaves(params)

    def loss_and_grads():
        for p in leaves:
            p.grad = None
        loss = tm.loss_fn(params, check, cfg)
        loss.backward()
        return loss.item(), [p.grad for p in leaves]

    real = tm.flash_attention
    seen = []                   # each layer's q, k, v and incoming do

    def recording(q, k, v, causal=True, sm_scale=None):
        o = real(q, k, v, causal, sm_scale)
        entry = [q.detach(), k.detach(), v.detach(), None]
        o.register_hook(lambda g: entry.__setitem__(3, g.contiguous()))
        seen.append(entry)
        return o

    before = [fn.launches for fn in kernels]
    tm.flash_attention = recording
    try:
        loss_k, grads_k = loss_and_grads()
    finally:
        tm.flash_attention = real
    if [fn.launches - b for fn, b in zip(kernels, before)] != \
            [cfg.n_layers] * len(kernels):
        raise AssertionError("the kernel path did not launch K3 once a layer")
    tm.flash_attention = flash.flash_attention_plain
    try:
        before = [fn.launches for fn in kernels]
        loss_p, grads_p = loss_and_grads()
        if [fn.launches for fn in kernels] != before:
            raise AssertionError("the plain path launched a kernel")
    finally:
        tm.flash_attention = real
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = [torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()
        for a, b in zip(grads_k, grads_p)]
    worst = min(range(len(cos)), key=cos.__getitem__)
    res["check"] = {"batch": CHECK_BATCH, "loss_kernel": loss_k,
                    "loss_plain": loss_p, "loss_rel_diff": rel,
                    "min_grad_cosine": cos[worst], "worst_leaf": worst,
                    "grad_cosines": cos}
    log(f"train: full-width check at batch {CHECK_BATCH}: loss kernel "
        f"{loss_k:.6f} plain {loss_p:.6f} (rel diff {rel:.2e}, limit 1e-3); "
        f"gradient cosine min {cos[worst]:.6f} (leaf {worst} of "
        f"{len(cos)}, limit 0.99)")
    if not rel <= 1e-3 or not cos[worst] >= 0.99:
        raise AssertionError(f"kernel path and plain path disagree: loss "
                             f"rel {rel}, gradient cosine {cos[worst]}")

    # each layer's dQ, dK and dV from the kernels (di the row sums of
    # P dP) against f64 dense attention on the same q, k, v and do
    from curvine_tpu_torch.gpu.attention import dense_attention
    cos64 = {"dq": [], "dk": [], "dv": []}
    for q, k, v, do in seen:
        _, lse = flash.flash_fwd(q, k, v)
        di = flash.flash_bwd_di(q, k, v, do, lse)
        got = {"dq": flash.flash_bwd_dq(q, k, v, do, lse, di)}
        got["dk"], got["dv"] = flash.flash_bwd_dkv(q, k, v, do, lse, di)
        q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
        dense_attention(q64, k64, v64).backward(do.double())
        for name, ref in (("dq", q64), ("dk", k64), ("dv", v64)):
            cos64[name].append(torch.nn.functional.cosine_similarity(
                got[name].double().flatten(), ref.grad.flatten(),
                dim=0).item())
        del lse, di, got, q64, k64, v64
    for name, cos_l in cos64.items():
        res[f"{name}_cosine_f64"] = cos_l
        log(f"train: {name} against f64 dense attention, layer by layer, at "
            f"batch {CHECK_BATCH}: cosine {[round(c, 5) for c in cos_l]} "
            f"(limit 0.99)")
    worst = {name: min(cos_l) for name, cos_l in cos64.items()}
    if not min(worst.values()) >= 0.99:
        raise AssertionError(f"gradients against f64: cosine {worst}")
    del seen
    for p in leaves:
        p.grad = None
    del grads_k, grads_p, leaves, opt
    torch.cuda.empty_cache()
    res["flash_gate"] = flash_gate_check(dev, seed)
    return res, params, step


# ------------------------------------------------------------------- ufs

def ufs_tokens(seed: int, n_shards: int, salt: int) -> np.ndarray:
    """``n_shards`` shards of int32 token ids below the flagship's vocab,
    made from ``seed`` (``salt`` tells the datasets apart)."""
    return np.random.default_rng((seed, salt)).integers(
        0, UFS_VOCAB, n_shards * SHARD_BYTES // 4, dtype=np.int32)


def _task_recorder(w, into: list):
    """``w._run_load_task`` wrapped: each task's kind, job, path, end
    state, bytes, and its start and end on the host clock."""
    real = w._run_load_task

    async def run(task):
        t = time.perf_counter()
        await real(task)
        into.append({"kind": task.kind, "job_id": task.job_id,
                     "path": task.path, "state": int(task.state),
                     "loaded_len": task.loaded_len, "message": task.message,
                     "start": t, "end": time.perf_counter()})
    return run


async def _job_done(c, job_id: str, timeout: float, rolling: bool = False):
    """Poll GET_JOB_STATUS every 20 ms until the job is finished (or, for
    a rolling prefetch window, until every planned task is); returns the
    job and the seconds waited."""
    from curvine_tpu_torch.common.types import JobState
    t = time.perf_counter()
    while True:
        job = await c.meta.job_status(job_id)
        done = job.state in (JobState.COMPLETED, JobState.FAILED,
                             JobState.CANCELLED)
        if rolling and job.tasks and all(
                x.state in (JobState.COMPLETED, JobState.FAILED)
                for x in job.tasks):
            done = True
        if done or time.perf_counter() - t > timeout:
            return job, time.perf_counter() - t
        await asyncio.sleep(0.02)


def phase_ufs(dev: torch.device, master: str, pw: "PortWorker", root: str,
              seed: int, params: dict, step, client_res: dict) -> dict:
    """A dataset in a ``file://`` under-store, mounted read-only, loaded
    by a job into the port's cluster, pinned into the tier-0 (K1) and fed
    to the flagship (K3); a cold prefetch window and an export; the
    phase's files deleted at the end, its mounts and jobs left in the
    master's journal for phase master's restart."""
    from curvine_tpu_torch.client import writer as writer_mod
    from curvine_tpu_torch.common import errors as cerr
    from curvine_tpu_torch.common.types import JobState, StorageState
    from curvine_tpu_torch.gpu import cuda_ops, flash
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_posix_shards
    from curvine_tpu_torch.ufs import local as local_ufs
    w = pw.worker
    res = {}
    base = os.path.join(root, "ufs")
    t = time.perf_counter()
    tokens = ufs_tokens(seed, SHARDS, 0x75667331)
    nxt_tokens = ufs_tokens(seed, UFS_NEXT_SHARDS, 0x6e657874)
    train_files = write_posix_shards(os.path.join(base, "train"), tokens,
                                     SHARD_BYTES // 4)
    next_files = write_posix_shards(os.path.join(base, "next"), nxt_tokens,
                                    SHARD_BYTES // 4)
    os.makedirs(os.path.join(base, "out"))
    names = [os.path.basename(f) for f in train_files]
    train = [f"/ufs/train/{n}" for n in names]
    res["ufs_write_s"] = time.perf_counter() - t
    log(f"ufs: an under-store of {SHARDS} + {UFS_NEXT_SHARDS} token shards "
        f"of {SHARD_BYTES // MiB} MiB (ids below {UFS_VOCAB:,}, from seed "
        f"{seed}) under file://{base}, made in {res['ufs_write_s']:.3f}s")

    async def mount_and_meta():
        async with port_client(master) as c:
            for d, mode in (("train", "r"), ("next", "r"), ("out", "rw")):
                await c.meta.mount(f"/ufs/{d}",
                                   f"file://{os.path.join(base, d)}",
                                   access_mode=mode)
            table = [m.to_wire() for m in await c.meta.mount_table()]
            ls = await c.meta.list_status("/ufs/train")
            st = await c.meta.file_status(train[3])
            ex = (await c.meta.exists(train[3]),
                  await c.meta.exists("/ufs/train/none.bin"))
            try:
                await c.meta.create_file("/ufs/train/user.bin")
                refused = ""
            except cerr.Unsupported as e:
                refused = str(e)
            t = time.perf_counter()
            raw = await c.read_all(train[5])
            read_s = time.perf_counter() - t
            try:
                await c.meta.get_block_locations(train[5])
                left = True
            except cerr.FileNotFound:
                left = False
            return table, ls, st, ex, refused, raw, read_s, left

    table, ls, st, ex, refused, raw, read_s, left = asyncio.run(
        mount_and_meta())
    if [m["cv_path"] for m in table] != ["/ufs/next", "/ufs/out",
                                        "/ufs/train"] \
            or [m["access_mode"] for m in table] != ["r", "rw", "r"]:
        raise AssertionError(f"ufs: the mount table is {table}")
    if [x.name for x in ls] != names or any(
            x.storage_policy.state != StorageState.UFS
            or x.len != SHARD_BYTES for x in ls):
        raise AssertionError(f"ufs: LIST_STATUS of /ufs/train gave "
                             f"{[(x.name, x.len) for x in ls]}")
    if st.len != SHARD_BYTES or st.storage_policy.state != StorageState.UFS \
            or ex != (True, False):
        raise AssertionError(f"ufs: FILE_STATUS {st}, EXISTS {ex}")
    if "read-only mount" not in refused:
        raise AssertionError(f"ufs: a user's CREATE_FILE under the read-only "
                             f"mount was not refused ({refused!r})")
    shard_tokens = SHARD_BYTES // 4
    if not np.array_equal(np.frombuffer(raw, dtype=np.int32),
                          tokens[5 * shard_tokens:6 * shard_tokens]) or left:
        raise AssertionError(f"ufs: read_all of the uncached {train[5]} "
                             f"differs from its file, or left a cached copy "
                             f"({left})")
    del raw
    res.update(mounts=table, uncached_read_s=read_s,
               uncached_read_gibs=SHARD_BYTES / GiB / read_s)
    log(f"ufs: mounted /ufs/train and /ufs/next read-only, /ufs/out rw; "
        f"before any load LIST_STATUS of /ufs/train gave the {SHARDS} names "
        f"in state UFS, FILE_STATUS and EXISTS answered for an uncached "
        f"shard, a user's CREATE_FILE was refused ({refused}); read_all of "
        f"an uncached shard through its mount, byte-equal, in {read_s:.3f}s "
        f"({res['uncached_read_gibs']:.3f} GiB/s), no cached copy left")

    # the load: every task's run on the worker, and its UFS reads and
    # cache writes, timed
    tasks: list[dict] = []
    split = {"ufs_read": {}, "cache_write": {}}
    real_read, real_write = local_ufs.LocalUfs.read, writer_mod.FsWriter.write

    async def timed_read(self, uri, *a, **kw):
        gen = real_read(self, uri, *a, **kw)
        path = "/ufs/train/" + uri.rsplit("/", 1)[-1]
        while True:
            t0 = time.perf_counter()
            try:
                chunk = await anext(gen)
            except StopAsyncIteration:
                break
            finally:
                split["ufs_read"][path] = split["ufs_read"].get(path, 0.0) \
                    + time.perf_counter() - t0
            yield chunk

    async def timed_write(self, data):
        t0 = time.perf_counter()
        try:
            return await real_write(self, data)
        finally:
            split["cache_write"][self.path] = \
                split["cache_write"].get(self.path, 0.0) \
                + time.perf_counter() - t0

    async def load():
        async with port_client(master) as c:
            t = time.perf_counter()
            job_id = await c.meta.submit_load("/ufs/train")
            job, wait_s = await _job_done(c, job_id, 300)
            return t, job, wait_s

    w._run_load_task = _task_recorder(w, tasks)
    local_ufs.LocalUfs.read, writer_mod.FsWriter.write = timed_read, \
        timed_write
    try:
        t_submit, job, load_s = asyncio.run(load())
    finally:
        local_ufs.LocalUfs.read, writer_mod.FsWriter.write = real_read, \
            real_write
    if job.state != JobState.COMPLETED or len(job.tasks) != SHARDS or any(
            x.state != JobState.COMPLETED or x.worker_id != w.worker_id
            or x.loaded_len != SHARD_BYTES for x in job.tasks) \
            or sorted(x.path for x in job.tasks) != train:
        raise AssertionError(f"ufs: the load job {job.state!r} "
                             f"({job.message}), tasks "
                             f"{[(x.path, x.state, x.loaded_len) for x in job.tasks]}")
    loads = [x for x in tasks if x["kind"] == "load"]
    per_task = [x["end"] - x["start"] for x in loads]
    reads = [split["ufs_read"].get(x["path"], 0.0) for x in loads]
    writes = [split["cache_write"].get(x["path"], 0.0) for x in loads]
    res["load"] = {
        "job_id": job.job_id, "s": load_s,
        "gibs": SHARDS * SHARD_BYTES / GiB / load_s,
        "first_task_start_s": min(x["start"] for x in loads) - t_submit,
        "first_task_done_s": min(x["end"] for x in loads) - t_submit,
        "task_s_median": statistics.median(per_task),
        "task_ufs_read_s_median": statistics.median(reads),
        "task_cache_write_s_median": statistics.median(writes),
        "task_other_s_median": statistics.median(
            [a - b - c for a, b, c in zip(per_task, reads, writes)]),
        "tasks": len(loads)}
    ld = res["load"]
    log(f"ufs: SUBMIT_JOB load /ufs/train: COMPLETED in {load_s:.3f}s "
        f"(polled every 20 ms), {SHARDS} tasks each COMPLETED on the port's "
        f"worker {w.worker_id}, {ld['gibs']:.3f} GiB/s from the UFS to the "
        f"cache; the first task started {ld['first_task_start_s']:.3f}s and "
        f"ended {ld['first_task_done_s']:.3f}s after the submit; a task "
        f"(median, {w.conf.worker.task_parallelism} at once) "
        f"{ld['task_s_median']:.3f}s: UFS read {ld['task_ufs_read_s_median']:.3f}s"
        f", cache write {ld['task_cache_write_s_median']:.3f}s, the rest "
        f"(create, commit, report) {ld['task_other_s_median']:.3f}s")

    async def check_cached():
        async with port_client(master) as c:
            ids = {}
            for i, p in enumerate(train):
                fb = await c.meta.get_block_locations(p)
                if len(fb.block_locs) != 1 or [
                        x.worker_id for x in fb.block_locs[0].locs] != \
                        [w.worker_id] or fb.status.storage_policy.ufs_mtime < 1:
                    raise AssertionError(f"ufs: {p} is cached as {fb}")
                ids[p] = fb.block_locs[0].block.id
                got = await c.read_all(p)
                if not np.array_equal(np.frombuffer(got, dtype=np.int32),
                                      tokens[i * shard_tokens:
                                             (i + 1) * shard_tokens]):
                    raise AssertionError(f"ufs: {p} differs from its file")
            return ids, dict(c.counters)

    ids, counters = asyncio.run(check_cached())
    log(f"ufs: every shard's one block located on the port's worker, its "
        f"policy carrying the UFS mtime, and equal to its file byte for byte "
        f"({counters.get('sc.bytes.read', 0):,} bytes read back by short "
        f"circuit)")

    # the tier-0: the loaded blocks made hot by reads up to
    # WORKER_MIN_READS, then promote cycles, each pin verified by K1
    ufs_ids = list(ids.values())
    pins0 = w.metrics.counters.get("blocks.hbm_pinned", 0)

    async def heat():
        async with port_client(master) as c:
            for p in train:
                await c.read_all(p)

    cycles = []
    cuda_ops.block_checksum.launches = 0
    while not all(w.hbm_holds(b) for b in ufs_ids) and len(cycles) < 8:
        asyncio.run(heat())
        t = time.perf_counter()
        pw.call(w._promote_once())
        cycles.append(time.perf_counter() - t)
    k1 = cuda_ops.block_checksum.launches
    pins = w.metrics.counters.get("blocks.hbm_pinned", 0) - pins0
    missing = [b for b in ufs_ids if not w.hbm_holds(b)]
    if missing or k1 != pins:
        raise AssertionError(f"ufs: {len(cycles)} promote cycles, {pins} "
                             f"pins, {k1} K1 launches, loaded blocks not "
                             f"pinned {missing}")
    for p in train[:2]:
        got = w.hbm_get(ids[p])
        ref = torch.from_numpy(tokens[train.index(p) * shard_tokens:
                                      (train.index(p) + 1) * shard_tokens]
                               ).to(dev)
        if not torch.equal(got.view(torch.int32), ref):
            raise AssertionError(f"ufs: {p}'s pinned block differs")
    del got, ref
    res.update(k1_launches=k1, pins=pins, pin_cycles=len(cycles),
               pin_cycle_s=cycles)
    log(f"ufs: {len(cycles)} promote cycles pinned {pins} blocks ({SHARDS} "
        f"of them the loaded shards'), each verified by K1 on the card: "
        f"{k1} launches; two pinned shards equal to the under-store's tokens "
        f"on the card")

    # the feed at phase feed's batch, advising the window, then three
    # flagship steps on the loaded tokens
    expect = torch.from_numpy(tokens).to(dev)

    async def feed():
        async with port_client(master) as c:
            replies = []
            real_advise = c.advise

            async def advise(*a, **kw):
                replies.append(await real_advise(*a, **kw))
                return replies[-1]

            c.advise = advise
            f = GpuTrainFeed(c, "/ufs/train", BATCH, SEQ, prefetch=True,
                             prefetch_window=UFS_WINDOW, device=dev)
            fed = await drive_feed(f, expect, dev)
            # the window's tasks run after the advice: wait for them
            pjobs = {}
            for jid in sorted({r["job_id"] for r in replies}):
                pjobs[jid] = (await _job_done(c, jid, 60, rolling=True))[0]
            return fed, f.profiler, c.counters.get("advise.rpcs", 0), pjobs

    tasks.clear()
    (n, bad, secs), prof, advise, pjobs = asyncio.run(feed())
    if n != tokens.size // (BATCH * SEQ) or bad:
        raise AssertionError(f"ufs: the feed gave {n} batches, {bad} tokens "
                             f"differ from the under-store's")
    fres = feed_stats("ufs", n, secs, prof)
    del expect
    planned = sum(len(j.tasks) for j in pjobs.values())
    t = time.perf_counter()
    while len(tasks) < planned and time.perf_counter() - t < 10:
        time.sleep(0.02)      # the worker records a task after its report
    failed = [x for j in pjobs.values() for x in j.tasks
              if x.state != JobState.COMPLETED]
    if advise < SHARDS or {j.epoch for j in pjobs.values()} != {0, 1} \
            or failed or len(tasks) != planned \
            or any(x["kind"] != "prefetch" for x in tasks):
        raise AssertionError(f"ufs: {advise} advise RPCs, prefetch jobs "
                             f"{[(j.epoch, j.state, len(j.tasks)) for j in pjobs.values()]}"
                             f", {len(tasks)} tasks run of {planned}, not "
                             f"completed {failed}")
    fres.update(advise_rpcs=advise, prefetch_jobs=len(pjobs),
                prefetch_tasks=len(tasks),
                prefetch_loaded_bytes=sum(x["loaded_len"] for x in tasks),
                input_wait=fres["fractions"].get("input_wait", 0.0),
                client_batches_per_s=client_res["batches_per_s"],
                client_input_wait=client_res["fractions"].get("input_wait",
                                                               0.0))
    res["feed"] = fres
    log(f"ufs: the loaded dataset through GpuTrainFeed (prefetch window "
        f"{UFS_WINDOW}): {fres['batches_per_s']:.1f} batches/s, input_wait "
        f"share {fres['input_wait']:.3f}, against phase client's "
        f"{fres['client_batches_per_s']:.1f} batches/s and "
        f"{fres['client_input_wait']:.3f}; {advise} advise RPCs served: "
        f"{len(pjobs)} prefetch jobs ("
        + ", ".join(f"epoch {j.epoch} {JobState(j.state).name} "
                    f"{len(j.tasks)} tasks" for j in pjobs.values())
        + f"), {len(tasks)} tasks on the port's worker, each COMPLETED, "
        f"{fres['prefetch_loaded_bytes']} bytes loaded (every shard cached)")
    if fres["prefetch_loaded_bytes"]:
        raise AssertionError("ufs: a prefetch task of a cached shard loaded "
                             "bytes")

    cfg = _flagship()
    kernels = [getattr(flash, nm) for nm in K3_NAMES]
    first = tokens[:TRAIN_BATCH * TRAIN_SEQ * UFS_STEPS].reshape(
        UFS_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    seen = []

    def check(b):
        seen.append(bool(torch.equal(b, torch.from_numpy(
            first[len(seen)]).to(dev))))

    async def train_steps():
        async with port_client(master) as c:
            f = GpuTrainFeed(c, "/ufs/train", TRAIN_BATCH, TRAIN_SEQ,
                             depth=2, device=dev)

            async def take():
                for _ in range(UFS_STEPS):
                    yield await anext(f.prefetcher)

            try:
                return await timed_steps(step, params, take(), check)
            finally:
                await f.prefetcher.aclose()

    for fn in kernels:
        fn.launches = 0
    step_s, losses = asyncio.run(train_steps())
    launches = {fn.__name__: fn.launches for fn in kernels}
    if seen != [True] * UFS_STEPS or not all(map(math.isfinite, losses)) \
            or set(launches.values()) != {cfg.n_layers * UFS_STEPS}:
        raise AssertionError(f"ufs: batches equal to the under-store's "
                             f"tokens {seen}, losses {losses}, K3 launches "
                             f"{launches}")
    res["train"] = {"losses": losses, "step_ms": [x * 1e3 for x in step_s],
                    "launches": launches}
    res["launches"] = launches
    log(f"ufs: {UFS_STEPS} flagship steps (phase 6's parameters and AdamW) "
        f"at {TRAIN_BATCH}x{TRAIN_SEQ} on the loaded tokens, each batch "
        f"equal to the under-store's tokens in the epoch order: losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(x * 1e3, 2) for x in step_s]}; K3 launches {launches}")

    # a cold prefetch window over /ufs/next
    async def cold():
        async with port_client(master) as c:
            t = time.perf_counter()
            rep = await c.advise("/ufs/next", cursor=0, window=UFS_WINDOW)
            job, _ = await _job_done(c, rep["job_id"], 300)
            secs = time.perf_counter() - t
            same = []
            for i, x in enumerate(job.tasks):
                got = await c.read_all(x.path)
                same.append(np.array_equal(
                    np.frombuffer(got, dtype=np.int32),
                    nxt_tokens[i * shard_tokens:(i + 1) * shard_tokens]))
            return job, secs, same

    job, cold_s, same = asyncio.run(cold())
    want = [f"/ufs/next/{os.path.basename(f)}" for f in next_files]
    if job.state != JobState.COMPLETED or [x.path for x in job.tasks] != \
            want or any(x.loaded_len != SHARD_BYTES for x in job.tasks) \
            or same != [True] * UFS_NEXT_SHARDS:
        raise AssertionError(f"ufs: the cold window {job.state!r}, tasks "
                             f"{[(x.path, x.loaded_len) for x in job.tasks]}"
                             f", equal {same}")
    res["prefetch"] = {"job_id": job.job_id, "s": cold_s,
                       "gibs": UFS_NEXT_SHARDS * SHARD_BYTES / GiB / cold_s}
    log(f"ufs: PREFETCH_WINDOW on the uncached /ufs/next at cursor 0, window "
        f"{UFS_WINDOW}: its {UFS_NEXT_SHARDS} shards in the epoch order "
        f"cached in {cold_s:.3f}s ({res['prefetch']['gibs']:.3f} GiB/s), "
        f"each task's loaded_len {SHARD_BYTES}, each equal to its file")

    # an export through /ufs/out
    out = np.random.default_rng((seed, 0x6f7574)).integers(
        0, 1 << 63, SHARD_BYTES // 8, dtype=np.int64)

    async def export():
        async with port_client(master) as c:
            await c.write_all("/ufs/out/export.bin", out)
            t = time.perf_counter()
            job_id = await c.meta.submit_export("/ufs/out")
            job, _ = await _job_done(c, job_id, 300)
            return job, time.perf_counter() - t

    job, exp_s = asyncio.run(export())
    on_disk = np.fromfile(os.path.join(base, "out", "export.bin"),
                          dtype=np.int64)
    if job.state != JobState.COMPLETED or not np.array_equal(on_disk, out):
        raise AssertionError(f"ufs: the export {job.state!r} ({job.message})"
                             f", the file:// object equal "
                             f"{np.array_equal(on_disk, out)}")
    del on_disk
    res["export"] = {"job_id": job.job_id, "s": exp_s,
                     "gibs": SHARD_BYTES / GiB / exp_s}
    log(f"ufs: SUBMIT_JOB export /ufs/out: {SHARD_BYTES // MiB} MiB written "
        f"out in {exp_s:.3f}s ({res['export']['gibs']:.3f} GiB/s), the "
        f"file:// object equal byte for byte")

    del w._run_load_task

    # the phase's files go; its mounts and jobs stay for phase master
    async def cleanup():
        async with port_client(master) as c:
            for jid, j in pjobs.items():
                if j.state in (JobState.PENDING, JobState.RUNNING):
                    await c.meta.cancel_job(jid)
            for d in ("/ufs/train", "/ufs/next"):
                await c.meta.update_mount(d, access_mode="rw")
            await c.meta.delete("/ufs", recursive=True)
            await c.meta.umount("/ufs/next")
            table = [m.to_wire() for m in await c.meta.mount_table()]
            jobs = {jid: (await c.meta.job_status(jid)).to_wire()
                    for jid in [res["load"]["job_id"], *pjobs,
                                res["prefetch"]["job_id"],
                                res["export"]["job_id"]]}
            return table, jobs

    res["mounts_after"], res["jobs"] = asyncio.run(cleanup())
    shutil.rmtree(base)
    for k in range(1, 11):
        pw.call(w.heartbeat_once())
        if not any(w.hbm_holds(b) for b in ufs_ids):
            break
    else:
        raise AssertionError("ufs: the deleted shards' device copies stayed "
                             "10 heartbeats")
    states = {j["kind"] + ":" + j["job_id"][:6]: JobState(j["state"]).name
              for j in res["jobs"].values()}
    log(f"ufs: the phase's files deleted (device copies gone after {k} "
        f"heartbeat(s)), /ufs/next unmounted; the master keeps the mounts "
        f"{[m['cv_path'] for m in res['mounts_after']]} and the jobs {states}")
    return res


# ------------------------------------------------------------ checkpoint

def _int_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its width, for a comparison bit for
    bit (a float compare would call -0.0 and 0.0 equal, NaN unequal)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().reshape(-1).view(ints[t.element_size()])


def phase_ckpt(dev: torch.device, master: str, seed: int, params: dict,
               link_gibs: float, pw: "PortWorker"
               ) -> tuple[dict, tuple[str, np.ndarray]]:
    """The flagship's parameters as phases train and ufs left them, saved
    through the port's client into the cluster (every byte by short
    circuit: the worker is on this host) and loaded back onto the card
    twice with ``distribute_checkpoint_to_device``: by short circuit, and
    with it off (READ_BLOCK into the caller's buffer, the path of a host
    without a worker). Each load bit-equal to the saved tensors on the
    card; one forward loss of a train batch from the loaded parameters
    equal to the saved ones' (K3's forward, counted here). Then
    ``ckpt_on_a_mesh``. Returns the numbers, and the path and host bytes
    of the first saved tensor that spans more than one block (the master
    phase reads it back)."""
    from curvine_tpu_torch.gpu import broadcast, flash, ingest, model as tm
    cfg = _flagship()
    saved = tm.leaves(params)
    nbytes = sum(t.nbytes for t in saved)
    batch = torch.from_numpy(train_tokens(cfg, seed)[
        :TRAIN_BATCH * TRAIN_SEQ].reshape(TRAIN_BATCH, TRAIN_SEQ)).to(dev)
    kernels = [getattr(flash, n) for n in K3_NAMES]

    def loss_of(p) -> torch.Tensor:
        with torch.no_grad():
            return tm.loss_fn(p, batch, cfg)

    # timed inside the save: each tensor's copy to the host; inside the
    # short-circuit load: the pinned ring's host side (np.copyto into the
    # ring's buffers and the copies' enqueue)
    real_leaf_bytes = broadcast._leaf_bytes
    real_transfer = ingest.DeviceCopier.transfer
    to_host, staging = [], []

    def timed_leaf_bytes(leaf):
        t = time.perf_counter()
        out = real_leaf_bytes(leaf)
        to_host.append(time.perf_counter() - t)
        return out

    def timed_transfer(self, raw):
        t = time.perf_counter()
        out = real_transfer(self, raw)
        staging.append(time.perf_counter() - t)
        return out

    async def load(short_circuit: bool):
        async with port_client(master, short_circuit=short_circuit) as c:
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = await broadcast.distribute_checkpoint_to_device(
                c, CKPT_PATH, dev)
            torch.cuda.synchronize()
            return got, time.perf_counter() - t, dict(c.counters)

    async def run():
        async with port_client(master) as c:
            torch.cuda.synchronize()
            broadcast._leaf_bytes = timed_leaf_bytes
            try:
                t = time.perf_counter()
                await broadcast.save_checkpoint(c, CKPT_PATH, params)
                save_s = time.perf_counter() - t
            finally:
                broadcast._leaf_bytes = real_leaf_bytes
            save_counters = dict(c.counters)
        ingest.DeviceCopier.transfer = timed_transfer
        try:
            sc_load = await load(True)
        finally:
            ingest.DeviceCopier.transfer = real_transfer
        return save_s, save_counters, sc_load

    for fn in kernels:
        fn.launches = 0
    save_s, wrote, (loaded, sc_s, sc_counters) = asyncio.run(run())
    manifest_bytes = wrote.get("write.bytes", 0) - nbytes
    res = {"tensors": len(saved), "bytes": nbytes,
           "manifest_bytes": manifest_bytes, "save_s": save_s,
           "save_gibs": nbytes / GiB / save_s,
           "save_to_host_s": sum(to_host),
           "sc_bytes_written": wrote.get("sc.bytes.written", 0),
           "write_bytes": wrote.get("write.bytes", 0),
           "sc_write_fallbacks": wrote.get("sc.write.fallbacks", 0),
           "load_sc_s": sc_s, "load_sc_gibs": nbytes / GiB / sc_s,
           "load_sc_bytes": sc_counters.get("sc.bytes.read", 0),
           "load_sc_read_block_bytes": sc_counters.get(
               "read.zero_copy_bytes", 0),
           "staging_s": sum(staging), "staging_share": sum(staging) / sc_s,
           "link_gibs": link_gibs}
    log(f"ckpt: saved {len(saved)} tensors, {nbytes:,} bytes (+ a "
        f"{manifest_bytes:,}-byte manifest) through the port's client in "
        f"{save_s:.3f}s ({res['save_gibs']:.3f} GiB/s; the copies to the "
        f"host {res['save_to_host_s']:.3f}s of it); "
        f"{res['sc_bytes_written']:,} of {res['write_bytes']:,} bytes by "
        f"short circuit, {res['sc_write_fallbacks']} blocks over "
        f"WRITE_BLOCK")
    if res["sc_bytes_written"] != res["write_bytes"] or \
            res["sc_write_fallbacks"] or manifest_bytes <= 0:
        raise AssertionError("ckpt: the checkpoint did not go all by short "
                             "circuit to a worker on this host")

    def check(name: str, got: dict) -> None:
        back = tm.leaves(got)
        bad = [i for i, (a, b) in enumerate(zip(saved, back))
               if a.dtype != b.dtype or a.shape != b.shape
               or a.device != b.device
               or not torch.equal(_int_view(a), _int_view(b))]
        if len(back) != len(saved) or bad:
            raise AssertionError(f"ckpt: {name} load: {len(back)} tensors, "
                                 f"{len(bad)} not bit-equal ({bad[:5]})")

    check("short-circuit", loaded)
    loss_saved = loss_of(params)
    loss_loaded = loss_of(loaded)
    res["loss_saved"], res["loss_loaded"] = loss_saved.item(), \
        loss_loaded.item()
    del loaded
    log(f"ckpt: loaded onto {dev} by short circuit in {sc_s:.3f}s "
        f"({res['load_sc_gibs']:.3f} GiB/s against phase 3's link_gibs "
        f"{link_gibs:.3f}; {res['load_sc_bytes']:,} bytes by short "
        f"circuit, {res['load_sc_read_block_bytes']} by READ_BLOCK); "
        f"staging through the pinned ring on the event loop "
        f"{res['staging_s']:.3f}s ({res['staging_share']:.3f} of the "
        f"load); every tensor bit-equal on the card; loss of a "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} train batch saved "
        f"{res['loss_saved']!r} loaded {res['loss_loaded']!r}")
    if not (torch.equal(loss_saved, loss_loaded)
            and math.isfinite(res["loss_saved"])):
        raise AssertionError("ckpt: the loaded parameters' loss differs")
    if res["load_sc_bytes"] != nbytes + manifest_bytes or \
            res["load_sc_read_block_bytes"]:
        raise AssertionError("ckpt: the short-circuit load did not read "
                             "every byte by short circuit")

    loaded, rb_s, rb_counters = asyncio.run(load(False))
    res.update(load_rb_s=rb_s, load_rb_gibs=nbytes / GiB / rb_s,
               load_rb_bytes=rb_counters.get("read.zero_copy_bytes", 0),
               load_rb_sc_bytes=rb_counters.get("sc.bytes.read", 0))
    check("READ_BLOCK", loaded)
    del loaded
    launches = {fn.__name__: fn.launches for fn in kernels}
    res["launches"] = launches
    log(f"ckpt: loaded onto {dev} with the short circuit off in "
        f"{rb_s:.3f}s ({res['load_rb_gibs']:.3f} GiB/s; "
        f"{res['load_rb_bytes']:,} bytes by READ_BLOCK into the caller's "
        f"buffer, {res['load_rb_sc_bytes']} by short circuit); every "
        f"tensor bit-equal on the card; K3 launches on this path "
        f"{launches}")
    if res["load_rb_bytes"] != nbytes + manifest_bytes or \
            res["load_rb_sc_bytes"]:
        raise AssertionError("ckpt: the READ_BLOCK load took another path")
    if launches != {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_di": 0,
                    "flash_bwd_dkv": 0, "flash_bwd_dq": 0}:
        raise AssertionError(f"ckpt: K3 launches {launches} for two "
                             f"forward losses of {cfg.n_layers} layers")
    res["mesh"] = ckpt_on_a_mesh(dev, master, pw, saved, nbytes, sc_s)
    i = next(i for i, t in enumerate(saved) if t.nbytes > BLOCK)
    probe = (f"{CKPT_PATH}/t{i:05d}.bin",
             saved[i].detach().cpu().contiguous().reshape(-1)
             .view(torch.uint8).numpy())
    return res, probe


def ckpt_on_a_mesh(dev: torch.device, master: str, pw: "PortWorker",
                   saved: list, nbytes: int, sc_s: float) -> dict:
    """The checkpoint distributed over a ``(1,)`` NCCL mesh with
    ``distribute_checkpoint``: every block of its files (the manifest's
    too) pinned into the port's worker's tier-0 by HBM_PIN (no K1, as in
    the reference), then the ``"tree"`` schedule, which must take every
    block from the tier-0 (``ici.peer_pulls`` equal to the blocks, no
    byte by short circuit or READ_BLOCK), and the ``"flat"`` one; each
    leaf replicated and bit-equal to the saved tensor on the card. The
    blocks are unpinned after, so the mesh phase's memory is what it
    was."""
    from curvine_tpu_torch.gpu import broadcast, multihost
    from curvine_tpu_torch.gpu import model as tm
    from curvine_tpu_torch.gpu.mesh import make_mesh
    from curvine_tpu_torch.rpc.client import Connection
    from curvine_tpu_torch.rpc.codes import RpcCode
    from curvine_tpu_torch.rpc.frame import pack

    async def blocks():
        async with port_client(master) as c:
            out = []
            for st in await c.meta.list_status(CKPT_PATH):
                fb = await c.meta.get_block_locations(
                    f"{CKPT_PATH}/{st.name}")
                out += [lb.block.id for lb in fb.block_locs]
            return out

    async def pin(code, ids):
        conn = await Connection(pw.worker.addr).connect()
        try:
            for bid in ids:
                await conn.call(code, data=pack({"block_id": bid}))
        finally:
            await conn.close()

    ids = asyncio.run(blocks())
    t = time.perf_counter()
    asyncio.run(pin(RpcCode.HBM_PIN, ids))
    pin_s = time.perf_counter() - t

    def check(name: str, got: dict) -> None:
        back = tm.leaves(got)
        bad = [i for i, (a, b) in enumerate(zip(saved, back))
               if str(b.placements) != "(Replicate(),)"
               or a.dtype != b.dtype or a.shape != b.shape
               or b.to_local().device != dev
               or not torch.equal(_int_view(a), _int_view(b.to_local()))]
        if len(back) != len(saved) or bad:
            raise AssertionError(f"ckpt: {name} on the mesh: {len(back)} "
                                 f"tensors, {len(bad)} not bit-equal "
                                 f"({bad[:5]})")

    async def load(schedule: str):
        async with port_client(master) as c:
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = await broadcast.distribute_checkpoint(
                c, CKPT_PATH, mesh, schedule=schedule)
            torch.cuda.synchronize()
            return got, time.perf_counter() - t, dict(c.counters)

    res = {"blocks": len(ids), "pin_s": pin_s,
           "pin_gibs": nbytes / GiB / pin_s}
    multihost.initialize()
    try:
        mesh = make_mesh(axis_names=("x",))
        if mesh.device_type != "cuda" or tuple(mesh.shape) != (1,):
            raise AssertionError(f"ckpt: mesh {mesh}")
        for schedule in ("tree", "flat"):
            got, secs, counters = asyncio.run(load(schedule))
            check(schedule, got)
            del got
            res[schedule] = {"s": secs, "gibs": nbytes / GiB / secs,
                             "counters": counters}
    finally:
        multihost.shutdown()
        asyncio.run(pin(RpcCode.HBM_UNPIN, ids))
    tc = res["tree"]["counters"]
    log(f"ckpt: {len(ids)} blocks of the checkpoint pinned into the port's "
        f"worker's tier-0 by HBM_PIN in {pin_s:.3f}s "
        f"({res['pin_gibs']:.3f} GiB/s, no K1); distribute_checkpoint on a "
        f"(1,) NCCL mesh: tree {res['tree']['s']:.3f}s "
        f"({res['tree']['gibs']:.3f} GiB/s; ici.peer_pulls "
        f"{tc.get('ici.peer_pulls', 0)}, {tc.get('ici.peer_pull_bytes', 0):,}"
        f" bytes from the tier-0, {tc.get('sc.bytes.read', 0)} by short "
        f"circuit, {tc.get('read.zero_copy_bytes', 0)} by READ_BLOCK), flat "
        f"{res['flat']['s']:.3f}s ({res['flat']['gibs']:.3f} GiB/s), "
        f"against the short-circuit load's {nbytes / GiB / sc_s:.3f}; every "
        f"leaf replicated and bit-equal on the card on both")
    if tc.get("ici.peer_pulls") != len(ids) or tc.get("sc.bytes.read", 0) \
            or tc.get("read.zero_copy_bytes", 0) \
            or tc.get("ici.tcp_fallbacks", 0):
        raise AssertionError(f"ckpt: the tree load's counters {tc} for "
                             f"{len(ids)} pinned blocks")
    return res


# -------------------------------------------------------------------- mesh

def _moe_config():
    from curvine_tpu_torch.gpu.model import ModelConfig
    # __graft_entry__.py:182-184, dryrun_multichip's data x ep pass
    return ModelConfig(vocab=512, d_model=64, n_heads=4, n_layers=1, d_ff=64,
                       max_seq=64, dtype="float32", moe_experts=4)


def phase_mesh(dev: torch.device, master: str, seed: int, train: dict
               ) -> dict:
    """The flagship trained through a (1, 1) ``("data", "model")`` mesh
    over an NCCL world of one: phase 6's initial parameters (the same
    seed) placed by ``shard_params``, a fresh AdamW, phase 6's cache-fed
    steps through ``GpuTrainFeed(mesh=...)`` in the same order and its
    synthetic steps on the same batch. Every batch must be a DTensor laid
    out by ``batch_spec``, K3's four kernels must launch once a layer a
    step (under ``local_map``, on the local heads), and the losses must
    equal phase 6's bit for bit: on a mesh of one the local ops are the
    same. Then dryrun_multichip's MoE config one step on a (1, 1)
    ``("data", "ep")`` mesh and without one: equal losses."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from curvine_tpu_torch.gpu import flash, model as tm, multihost
    from curvine_tpu_torch.gpu.ingest import put_sharded
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed
    from curvine_tpu_torch.gpu.mesh import make_mesh, placements
    cfg = _flagship()
    B, L, steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    t0 = time.perf_counter()
    multihost.initialize()
    try:
        mesh = make_mesh()
        init_s = time.perf_counter() - t0
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda" or \
                tuple(mesh.shape) != (1, 1):
            raise AssertionError(f"mesh {mesh} over {dist.get_backend()}")
        log(f"mesh: {mesh.mesh_dim_names} {tuple(mesh.shape)} on "
            f"{mesh.device_type} over {dist.get_backend()}, world "
            f"{dist.get_world_size()} (group and mesh in {init_s:.2f}s)")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = tm.shard_params(tm.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg, dev), mesh)
        torch.cuda.empty_cache()
        step = tm.make_train_step(cfg, tm.make_optimizer(params), mesh)
        want = placements(mesh, tm.batch_spec(mesh))
        placed = []

        def check(batch):
            placed.append(isinstance(batch, DTensor)
                          and list(batch.placements) == want)

        async def cache_fed():
            async with port_client(master) as c:
                feed = GpuTrainFeed(c, "/ds/train", B, L, depth=2, mesh=mesh)
                return feed.profiler, await timed_steps(
                    step, params, feed.prefetcher, check)

        tok0 = put_sharded(synthetic_batch(cfg, seed, dev).cpu().numpy(),
                           mesh, tm.batch_spec(mesh))
        kernels = [getattr(flash, n) for n in K3_NAMES]
        for fn in kernels:
            fn.launches = 0
        feed_prof, (cache_times, cache_losses) = asyncio.run(cache_fed())
        synth_times, synth_losses = asyncio.run(timed_steps(
            step, params, repeat(tok0, steps), check))
        launches = {fn.__name__: fn.launches for fn in kernels}
        peak = torch.cuda.max_memory_allocated(dev)
        n_steps = len(cache_times) + len(synth_times)
        if not all(placed) or len(placed) != n_steps:
            raise AssertionError(f"mesh: {placed.count(False)} of "
                                 f"{len(placed)} batches not laid out as "
                                 f"{want}")
        for name, n in launches.items():
            if n != cfg.n_layers * n_steps:
                raise AssertionError(f"mesh: {name} launched {n} times in "
                                     f"{n_steps} steps of {cfg.n_layers} "
                                     f"layers")
        pairs = list(zip(cache_losses + synth_losses,
                         train["losses_cache_fed"]
                         + train["losses_synthetic"]))
        diff = max(abs(a - b) for a, b in pairs)
        step_s = statistics.median(cache_times[1:])
        synth_s = statistics.median(synth_times)
        mfu = 6.0 * train["params"] * B * L / step_s / BF16_FLOP_PER_S
        fractions = feed_prof.summary()["fractions"]
        prof, wall_s, kern, busy_us = profiled_steps(step, params, tok0)
        res = {"mesh": {"axes": list(mesh.mesh_dim_names),
                        "shape": list(mesh.shape),
                        "backend": dist.get_backend(), "init_s": init_s},
               "train_step_ms": step_s * 1e3,
               "train_step_synth_ms": synth_s * 1e3,
               "ingest_overlap_ratio": step_s / synth_s, "mfu": mfu,
               "peak_bytes": peak, "losses_cache_fed": cache_losses,
               "losses_synthetic": synth_losses, "max_loss_diff": diff,
               "step_ms_cache_fed": [t * 1e3 for t in cache_times],
               "step_ms_synthetic": [t * 1e3 for t in synth_times],
               "launches": launches, "feed_fractions": fractions,
               "profile": {"wall_ms": wall_s * 1e3,
                           "device_busy_ms": busy_us / 1e3,
                           "device_events": len(kern)}}
        log(f"mesh: {len(cache_times)} cache-fed steps through "
            f"GpuTrainFeed(mesh=...), every batch a DTensor {want}; K3 "
            f"launches {launches} in {n_steps} steps")
        log(f"mesh: losses cache-fed {[round(x, 4) for x in cache_losses]}"
            f"; synthetic {[round(x, 4) for x in synth_losses]}; largest "
            f"difference from phase 6's {diff} (bit-equal expected)")
        busy = busy_us / 1e3 / (wall_s * 1e3)
        p6 = train["profile"]
        log(f"mesh: train_step_ms {step_s * 1e3:.2f} (phase 6: "
            f"{train['train_step_ms']:.2f}) train_step_synth_ms "
            f"{synth_s * 1e3:.2f} ({train['train_step_synth_ms']:.2f}) "
            f"ingest_overlap_ratio {step_s / synth_s:.4f} "
            f"({train['ingest_overlap_ratio']:.4f}) mfu {mfu:.4f} "
            f"({train['mfu']:.4f}) peak {peak / GiB:.2f} GiB "
            f"({train['peak_bytes'] / GiB:.2f}); device busy, 2 profiled "
            f"steps, {busy:.3f} of {wall_s * 1e3:.1f} ms "
            f"({p6['device_busy_ms'] / p6['wall_ms']:.3f} of "
            f"{p6['wall_ms']:.1f} ms); feed input_wait "
            f"{fractions.get('input_wait', 0.0):.3f}")
        if kern:
            for line in prof.key_averages().table(
                    sort_by="self_cpu_time_total", row_limit=10,
                    max_name_column_width=48).splitlines():
                log(f"  {line}")
        del prof, kern, step, params, tok0
        torch.cuda.empty_cache()
        if diff != 0.0:
            raise AssertionError(f"mesh: losses differ from phase 6's by "
                                 f"up to {diff}: {pairs}")
        res["moe"] = moe_on_a_mesh(dev, seed)
        return res
    finally:
        multihost.shutdown()


def moe_on_a_mesh(dev: torch.device, seed: int) -> dict:
    """dryrun_multichip's MoE config (experts sharded over ``ep``) two
    steps on a (1, 1) ``("data", "ep")`` mesh and two without one, from
    the same parameters: the losses must be equal."""
    from curvine_tpu_torch.gpu import model as tm
    from curvine_tpu_torch.gpu.ingest import put_sharded
    from curvine_tpu_torch.gpu.mesh import make_mesh
    cfg = _moe_config()
    mesh = make_mesh(axis_names=("data", "ep"))
    tokens = np.random.default_rng(seed + 3).integers(0, cfg.vocab, (2, 64),
                                                      dtype=np.int32)
    losses = {}
    for name in ("plain", "mesh"):
        params = tm.init_params(torch.Generator(device=dev).manual_seed(
            seed + 2), cfg, dev)
        m = None if name == "plain" else mesh
        tok = torch.from_numpy(tokens).to(dev)
        if m is not None:
            params = tm.shard_params(params, m)
            tok = put_sharded(tokens, m, tm.batch_spec(m))
        step = tm.make_train_step(cfg, tm.make_optimizer(params), m)
        losses[name] = [float(step(params, tok)) for _ in range(2)]
    ew1 = [repr(p) for p in params["layers"][0]["ew1"].placements]
    log(f"mesh: MoE (4 experts, ew1 {ew1} over {mesh.mesh_dim_names}) "
        f"losses {losses['mesh']} on the mesh, {losses['plain']} without")
    if losses["mesh"] != losses["plain"] or \
            ew1 != ["Replicate()", "Shard(dim=0)"] or \
            not all(map(math.isfinite, losses["mesh"])):
        raise AssertionError(f"mesh: MoE losses {losses}")
    return {"losses": losses, "ew1_placements": ew1}


# ------------------------------------------------------ pipeline and ring

# Each limit sits about 10x above the reading of a sound run (NVIDIA
# H100 80GB HBM3; PERF.md §5): the pipeline's loss 1.87e-5 relative,
# its gradients 1 - cosine 5.3e-5, its logits bit-equal; the ring's
# losses 2.73e-4 from K3's.
PIPE_STEPS = 3
PIPE_LOSS_REL = 2e-4         # the pipeline's loss against the unsharded one
PIPE_LOGIT_ULPS = 1          # its logits, in bf16 ulps of the largest
PIPE_GRAD_COS = 0.9995       # each gradient leaf
RING_STEPS = 3
RING_LOSS_ABS = 3e-3         # the ring's losses against K3's (s in bf16)
RING_ATTN_ABS = 0.25         # its attention output against f32 dense


def _one_rank_mesh(axes: tuple) -> object:
    """A mesh of this process alone over an NCCL world of one on the
    card, every axis of size 1."""
    import torch.distributed as dist
    from curvine_tpu_torch.gpu import multihost
    from curvine_tpu_torch.gpu.mesh import make_mesh
    multihost.initialize()
    mesh = make_mesh(axis_names=axes, shape=(1,) * len(axes))
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        raise AssertionError(f"mesh {mesh} over {dist.get_backend()}")
    return mesh


def _cosines(a: list, b: list) -> list[float]:
    return [torch.nn.functional.cosine_similarity(
        x.float().flatten(), y.float().flatten(), dim=0).item()
        for x, y in zip(a, b)]


def phase_pipeline(dev: torch.device, seed: int) -> dict:
    """The flagship through ``gpu/pipeline.py`` on a ``(1,)`` ``("pp",)``
    NCCL mesh: phase 6's initial parameters stacked (``stack_layers``) and
    placed (``shard_stacked``), the logits of ``pipeline_forward`` on the
    synthetic batch against the unsharded ``forward``'s, then
    ``pipeline_loss`` (full f32 logits) and its backward at batch 16 x
    1024 in 2 microbatches with an AdamW update, three steps; K3's four
    kernels must launch once a layer a microbatch a step. Then the
    unsharded model takes the same three steps with the same loss: each
    loss and every gradient leaf against the pipeline's."""
    from curvine_tpu_torch.gpu import flash, model as tm, multihost
    from curvine_tpu_torch.gpu import pipeline as pl
    cfg = _flagship()
    M = PIPE_MICROBATCHES
    mesh = _one_rank_mesh(("pp",))
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = tm.init_params(torch.Generator(device=dev).manual_seed(seed),
                                cfg, dev)
        stacked = pl.shard_stacked(pl.stack_layers(params), mesh)
        tok = synthetic_batch(cfg, seed, dev)
        with torch.no_grad():
            got = pl.pipeline_forward(stacked, tok, cfg, mesh, M)
            want = tm.forward(params, tok, cfg)
            logit_err = (got - want).abs().max().item()
            logit_cos = _cosines([got], [want])[0]
            # the logits are bf16 products cast to f32: one ulp of the
            # largest is 2^(e - 7) for a largest in [2^e, 2^(e + 1))
            logit_lim = PIPE_LOGIT_ULPS * 2.0 ** (math.floor(math.log2(
                want.abs().max().item())) - 7)
            del got, want
        kernels = [getattr(flash, n) for n in K3_NAMES]
        opt = tm.make_optimizer(stacked)
        for fn in kernels:
            fn.launches = 0
        losses, grads, times = [], [], []
        for _ in range(PIPE_STEPS):
            t = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = pl.pipeline_loss(stacked, tok, cfg, mesh, M)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(loss.item())
            grads.append([p.grad.to_local() for p in tm.leaves(stacked)])
        launches = {fn.__name__: fn.launches for fn in kernels}
        peak = torch.cuda.max_memory_allocated(dev)
        want_n = cfg.n_layers * M * PIPE_STEPS
        for name, n in launches.items():
            if n != want_n:
                raise AssertionError(f"pipeline: {name} launched {n} times, "
                                     f"{want_n} expected")
        del opt, stacked
        opt = tm.make_optimizer(params)
        ref_losses, ref_times, cos = [], [], []
        for step in range(PIPE_STEPS):
            t = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = pl.next_token_nll(tm.forward(params, tok, cfg), tok)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            ref_times.append(time.perf_counter() - t)
            ref_losses.append(loss.item())
            # the pipeline's stacked leaves hold the layers in order
            ref = tm.leaves({
                **{k: params[k].grad for k in ("embed", "pos", "ln_f")},
                "layers": {k: torch.stack([layer[k].grad
                                           for layer in params["layers"]])
                           for k in params["layers"][0]}})
            cos.append(_cosines(grads[step], ref))
            del ref
        del opt, params, grads
        torch.cuda.empty_cache()
    finally:
        multihost.shutdown()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    worst = min(min(c) for c in cos)
    res = {"microbatches": M, "steps": PIPE_STEPS, "losses": losses,
           "losses_unsharded": ref_losses, "loss_rel_diff": rel,
           "logit_max_abs_err": logit_err, "logit_limit": logit_lim,
           "logit_cosine": logit_cos,
           "grad_cosines": cos, "min_grad_cosine": worst,
           "step_ms": [t * 1e3 for t in times],
           "step_ms_unsharded": [t * 1e3 for t in ref_times],
           "peak_bytes": peak, "launches": launches}
    log(f"pipeline: the flagship's {cfg.n_layers} layers stacked and split "
        f"over a (1,) ('pp',) NCCL mesh, batch {TRAIN_BATCH}x{TRAIN_SEQ} in "
        f"{M} microbatches: logits against the unsharded forward max abs "
        f"{logit_err:.4g} (limit {logit_lim:.4g}, {PIPE_LOGIT_ULPS} bf16 "
        f"ulp of the largest), cosine {logit_cos:.6f}")
    log(f"pipeline: losses {[round(x, 5) for x in losses]}, unsharded "
        f"{[round(x, 5) for x in ref_losses]} (rel diff max {max(rel):.2e},"
        f" limit {PIPE_LOSS_REL}); gradient cosine min {worst:.6f} over "
        f"{len(cos[0])} leaves x {PIPE_STEPS} steps (limit {PIPE_GRAD_COS})")
    log(f"pipeline: step ms {[round(t * 1e3, 2) for t in times]} (unsharded,"
        f" the same loss: {[round(t * 1e3, 2) for t in ref_times]}); peak "
        f"{peak / GiB:.2f} GiB; K3 launches {launches} ({cfg.n_layers} "
        f"layers x {M} microbatches x {PIPE_STEPS} steps)")
    if not (logit_err <= logit_lim and max(rel) <= PIPE_LOSS_REL
            and worst >= PIPE_GRAD_COS
            and all(map(math.isfinite, losses))):
        raise AssertionError(f"pipeline: logits {logit_err}, loss rel "
                             f"{rel}, gradient cosine {worst}")
    return res


def _ring_attention_errors(params: dict, tok: torch.Tensor, cfg,
                           mesh) -> dict:
    """The first layer's q, k, v of ``tok`` under ``params`` (placed on
    the one-rank ``mesh``) through ``ring_attention_sharded``, causal,
    and through K3, each against ``dense_attention`` of the same q, k, v
    in f32; and the ring without its causal mask, a planted fault that
    ``RING_ATTN_ABS`` must refuse. Max abs errors."""
    from torch.distributed.tensor import DTensor
    from curvine_tpu_torch.gpu import model as tm
    from curvine_tpu_torch.gpu.attention import (dense_attention,
                                                 ring_attention_sharded,
                                                 ring_spec)
    from curvine_tpu_torch.gpu.flash import flash_attention
    from curvine_tpu_torch.gpu.mesh import placements
    local = {k: params[k].to_local() for k in ("embed", "pos")}
    layer = {k: v.to_local() for k, v in params["layers"][0].items()}
    B, L = tok.shape
    with torch.no_grad():
        x = tm._rmsnorm(local["embed"][tok.long()] + local["pos"][:L],
                        layer["ln1"])
        q, k, v = ((x @ layer[w]).reshape(B, L, cfg.n_heads, cfg.head_dim)
                   .transpose(1, 2).contiguous() for w in ("wq", "wk", "wv"))
        want = dense_attention(q.float(), k.float(), v.float())
        lay = placements(mesh, ring_spec(mesh))
        qd, kd, vd = (DTensor.from_local(t, mesh, lay) for t in (q, k, v))
        errs = {}
        for name, causal in (("ring", True), ("ring_not_causal", False)):
            got = ring_attention_sharded(qd, kd, vd, mesh, causal=causal)
            errs[name] = (got.to_local().float() - want).abs().max().item()
        got = flash_attention(q, k, v, causal=True,
                              sm_scale=1.0 / math.sqrt(cfg.head_dim))
        errs["k3"] = (got.float() - want).abs().max().item()
        errs["max_abs_ref"] = want.abs().max().item()
    return errs


def phase_ring(dev: torch.device, seed: int) -> dict:
    """The flagship with ``use_ring_attention`` on a (1, 1, 1)
    ``("data", "model", "seq")`` NCCL mesh: phase 6's initial parameters,
    a fresh AdamW, three steps on phase 6's synthetic batch through the
    ring (plain torch: scores, m and s in bf16, as the reference keeps
    them), with K3 launched no time. First the unsharded model with K3
    takes the same three steps from the same parameters: the ring's
    losses must be within ``RING_LOSS_ABS`` of them. Before the steps,
    the ring's attention output at the first layer must be within
    ``RING_ATTN_ABS`` of f32 dense attention, and a ring without its
    causal mask must not (``_ring_attention_errors``)."""
    import dataclasses
    from curvine_tpu_torch.gpu import flash, model as tm, multihost
    from curvine_tpu_torch.gpu.ingest import put_sharded
    cfg = dataclasses.replace(_flagship(), use_ring_attention=True)
    tok = synthetic_batch(cfg, seed, dev)
    params = tm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, dev)
    step = tm.make_train_step(_flagship(), tm.make_optimizer(params))
    k3_losses, k3_times = [], []
    for _ in range(RING_STEPS):
        t = time.perf_counter()
        k3_losses.append(float(step(params, tok)))
        k3_times.append(time.perf_counter() - t)
    del step, params
    torch.cuda.empty_cache()
    mesh = _one_rank_mesh(("data", "model", "seq"))
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        params = tm.shard_params(tm.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg, dev), mesh)
        attn = _ring_attention_errors(params, tok, cfg, mesh)
        torch.cuda.empty_cache()
        step = tm.make_train_step(cfg, tm.make_optimizer(params), mesh)
        tok = put_sharded(tok.cpu().numpy(), mesh, tm.batch_spec(mesh))
        kernels = [getattr(flash, n) for n in K3_NAMES]
        for fn in kernels:
            fn.launches = 0
        losses, times = [], []
        for _ in range(RING_STEPS):
            t = time.perf_counter()
            losses.append(float(step(params, tok)))
            times.append(time.perf_counter() - t)
        launches = {fn.__name__: fn.launches for fn in kernels}
        peak = torch.cuda.max_memory_allocated(dev)
        del step, params, tok
        torch.cuda.empty_cache()
    finally:
        multihost.shutdown()
    diff = [abs(a - b) for a, b in zip(losses, k3_losses)]
    res = {"steps": RING_STEPS, "losses": losses, "losses_k3": k3_losses,
           "loss_abs_diff": diff, "step_ms": [t * 1e3 for t in times],
           "step_ms_k3": [t * 1e3 for t in k3_times],
           "attention_max_abs_err": attn, "peak_bytes": peak,
           "launches": launches}
    log(f"ring: the first layer's attention against f32 dense (|ref| max "
        f"{attn['max_abs_ref']:.4g}): the ring max abs {attn['ring']:.4g} "
        f"(limit {RING_ATTN_ABS}), K3 {attn['k3']:.4g}; the ring without "
        f"its causal mask {attn['ring_not_causal']:.4g}, which the limit "
        f"must refuse")
    log(f"ring: the flagship with ring attention on a (1, 1, 1) ('data', "
        f"'model', 'seq') NCCL mesh, batch {TRAIN_BATCH}x{TRAIN_SEQ}: "
        f"losses {[round(x, 5) for x in losses]}, K3 unsharded "
        f"{[round(x, 5) for x in k3_losses]} (abs diff max {max(diff):.4g},"
        f" limit {RING_LOSS_ABS}); step ms "
        f"{[round(t * 1e3, 2) for t in times]} (K3 unsharded "
        f"{[round(t * 1e3, 2) for t in k3_times]}); peak {peak / GiB:.2f} "
        f"GiB; K3 launches {launches}")
    if any(launches.values()) or max(diff) > RING_LOSS_ABS or \
            not all(map(math.isfinite, losses)) or \
            not attn["ring"] <= RING_ATTN_ABS < attn["ring_not_causal"]:
        raise AssertionError(f"ring: losses {losses} against {k3_losses}, "
                             f"attention {attn}, K3 launches {launches}")
    return res


# ------------------------------------------------------------------ vector

def pq_case(gen: torch.Generator, dev: torch.device, q: int, w: int, m: int,
            ksub: int, pre_offset: bool):
    """A random LUT [Q, M, ksub] and codes [Q, W, M] on the card, with
    planted out-of-range codes: -1, past the table, and (pre-offset) a
    code in the next subspace's range."""
    lut = torch.randn((q, m, ksub), generator=gen, device=dev)
    codes = torch.randint(0, ksub, (q, w, m), generator=gen, device=dev,
                          dtype=torch.int32)
    if pre_offset:
        codes += torch.arange(m, device=dev, dtype=torch.int32) * ksub
    codes[:, ::7, 0] = -1
    codes[:, 1::5, m - 1] = m * ksub + 3
    if m > 1:
        codes[:, 2::3, 1] += ksub
    return lut, codes


def pq_bit_check(lut, codes, pre_offset: bool) -> float:
    """K2 against its plain version on the same tensors: every float32
    bit equal (both add the same terms in the same order). Returns the
    largest absolute difference (0 when equal)."""
    from curvine_tpu_torch.gpu import pq
    got = pq.pq_lut_scan(lut, codes, pre_offset=pre_offset)
    ref = pq.pq_lut_scan_plain(lut, codes, pre_offset=pre_offset)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        raise AssertionError(f"pq_lut_scan {tuple(lut.shape)} x "
                             f"{tuple(codes.shape)} pre_offset={pre_offset}:"
                             f" {bad} scores differ from the plain version "
                             f"(max abs {(got - ref).abs().max().item()})")
    return (got - ref).abs().max().item()


def pq_timing(lut, codes, dev: torch.device) -> dict:
    """K2 at the path's shape, on the search's own LUT and pre-offset
    codes: CUDA events, median of 20, L2 flushed before each launch;
    beside its bound, the plain version and one ``embedding_bag`` call
    on the same codes offset per query (computed outside the timing)."""
    import torch.nn.functional as F
    from curvine_tpu_torch.gpu import pq
    q, w, m = codes.shape
    ksub = lut.shape[2]
    scratch = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    flat_idx = (codes + (torch.arange(q, device=dev, dtype=torch.int32)
                         * (m * ksub))[:, None, None]).view(q * w, m)
    table = lut.reshape(-1, 1)

    def med(fn):
        fn()
        torch.cuda.synchronize()
        return statistics.median(event_ms(fn, 20, scratch))

    ms = med(lambda: pq.pq_lut_scan(lut, codes, pre_offset=True))
    plain_ms = med(lambda: pq.pq_lut_scan_plain(lut, codes, pre_offset=True))
    lib_ms = med(lambda: F.embedding_bag(flat_idx, table, mode="sum"))
    lib = F.embedding_bag(flat_idx, table, mode="sum").view(q, w)
    got = pq.pq_lut_scan(lut, codes, pre_offset=True)
    lib_err = (lib - got).abs().max().item()
    nbytes = q * w * m * 4 + q * m * ksub * 4 + q * w * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    del scratch
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
            "embedding_bag_max_abs_diff": lib_err}


def phase_vector(dev: torch.device, master: str, seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from curvine_tpu_torch.common.errors import FileNotFound
    from curvine_tpu_torch.gpu import pq
    from curvine_tpu_torch.vector import AnnServer, VectorTable
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {"pq_shapes": {}}
    max_err = 0.0
    for shape in PQ_SHAPES:
        for pre_offset in (False, True):
            max_err = max(max_err, pq_bit_check(
                *pq_case(gen, dev, *shape, pre_offset), pre_offset))
        res["pq_shapes"][str(list(shape))] = "bit-equal"
        log(f"vector: K2 {list(shape)} (Q, W, M, ksub), both code layouts, "
            f"planted out-of-range codes: bit-equal to the plain version")

    # bench.py:1587-1592: a mixture of 1,024 Gaussians, sigma 0.25
    centers = rng.standard_normal((VEC_CENTERS, VEC_DIM), dtype=np.float32)
    vecs = rng.standard_normal((VEC_ROWS, VEC_DIM), dtype=np.float32)
    vecs *= VEC_SIGMA
    vecs += centers[rng.integers(0, VEC_CENTERS, VEC_ROWS)]
    queries = vecs[rng.integers(0, VEC_ROWS, ANN_QUERIES)]

    def recall10(ann_i, exact_i) -> float:
        hits = sum(len(set(map(int, a)) & set(map(int, b)))
                   for a, b in zip(ann_i[:RECALL_QUERIES], exact_i))
        return hits / (RECALL_QUERIES * 10)

    async def compaction(client) -> None:
        """A small table's first row group deleted and compacted away:
        the port client's ``meta.delete`` of one row-group file."""
        small = vecs[:2000]
        t = await VectorTable.create(client, "/bench/compact", VEC_DIM)
        await t.append(small[:1000])
        await t.append(small[1000:])
        await t.delete(list(range(1000)))
        if await t.compact() != 1000 or t.row_groups != 1:
            raise AssertionError("vector: compaction kept the deleted rows")
        try:
            await client.meta.file_status("/bench/compact/rg-00001.vec")
            raise AssertionError("vector: compaction left its old row group")
        except FileNotFound:
            pass
        got, _ = await t.take([0, 999])
        if not np.array_equal(got, small[[1000, 1999]]):
            raise AssertionError("vector: compacted rows differ")
        res["compaction"] = "row group rg-00001.vec deleted, rows equal"

    async def run():
        async with port_client(master) as client:
            out = await serve(client)
            await compaction(client)
            res["client_counters"] = dict(client.counters)
        return out

    async def serve(client):
        t0 = time.perf_counter()
        table = await VectorTable.create(client, "/bench/vec", VEC_DIM)
        await table.append(vecs)
        res["append_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        await table.knn(vecs[0], k=8, device=dev)        # pin
        res["pin_s"] = time.perf_counter() - t0
        # the pinned tensors, and all that pinning and the first scan left
        # allocated (cuBLAS keeps its workspace in PyTorch's allocator)
        res["table_bytes_pinned"] = sum(
            t.nbytes for t in next(iter(table._dev_cache.values())))
        res["allocated_after_pin_bytes"] = \
            torch.cuda.memory_allocated(dev) - base
        # a stream of single-query scans, one sync at the end
        t0 = time.perf_counter()
        outs = [await table.knn(vecs[123 + i], k=8, device=dev,
                                materialize=False) for i in range(SCAN_REPS)]
        ids = outs[-1][0].cpu().numpy()
        res["vector_scan_mrows_s"] = SCAN_REPS * VEC_ROWS / (
            time.perf_counter() - t0) / 1e6
        if int(ids[0, 0]) != 123 + SCAN_REPS - 1:
            raise AssertionError(f"exact scan: top id {ids[0, 0]}")

        t0 = time.perf_counter()
        idx = await table.create_index(device=dev, **VEC_INDEX)
        torch.cuda.synchronize()
        res["vector_index_build_s"] = time.perf_counter() - t0
        cap = int(idx.lists.shape[1])
        res.update(list_cap=cap, nlist_total=idx.nlist_total,
                   width=VEC_NPROBE * cap)
        exact_i, _ = await table.knn(queries[:RECALL_QUERIES], k=10,
                                     device=dev, use_index=False)

        # the PQ search of 64 queries: K2 against the plain ADC stage,
        # passed in through the search's hook; and the path's own K2
        # inputs (the first 256 queries' LUT and codes) for the timing
        v, vid = await table._device_vectors("cosine", dev)
        kw = dict(k=VEC_K, metric="cosine", nprobe=VEC_NPROBE, device=dev,
                  rerank=VEC_RERANK)
        s_k, i_k = idx.search(queries[:64], v, vid, **kw)
        s_p, i_p = idx.search(queries[:64], v, vid, adc=pq.pq_lut_scan_plain,
                              **kw)
        if not (torch.equal(i_k, i_p) and torch.equal(s_k, s_p)):
            raise AssertionError("the PQ search with K2 and with its plain "
                                 "ADC stage disagree")
        seen = []

        def capture(lut, codes, pre_offset):
            seen.append((lut, codes))
            return pq.pq_lut_scan_plain(lut, codes, pre_offset)
        idx.search(queries[:ANN_BATCH], v, vid, adc=capture, **kw)
        del v, vid

        srv = await AnnServer(table, k=VEC_K, nprobe=VEC_NPROBE,
                              rerank=VEC_RERANK, device=dev,
                              max_batch=ANN_BATCH, warm_all=False).start()
        await srv.query_many(queries[:ANN_BATCH])          # warm
        pq.pq_lut_scan.launches = 0
        idx.adc_calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ann_i, _ = await srv.query_many(queries, batch=ANN_BATCH,
                                        depth=ANN_DEPTH)
        ann_s = time.perf_counter() - t0
        launches, adc_calls = pq.pq_lut_scan.launches, idx.adc_calls
        # where a batch goes: 4 batches of query_many under the profiler
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            await srv.query_many(queries[:4 * ANN_BATCH], batch=ANN_BATCH,
                                 depth=ANN_DEPTH)
            wall_s = time.perf_counter() - t0
        kern, busy_us = device_work(prof)
        k2_us = sum(e.time_range.elapsed_us() for e in kern
                    if "pq_scan" in e.name)
        res["profile"] = {"wall_ms": wall_s * 1e3,
                          "device_busy_ms": busy_us / 1e3,
                          "k2_device_ms": k2_us / 1e3,
                          "device_events": len(kern)}
        if kern:
            log(f"vector: profiler, query_many of {4 * ANN_BATCH}: wall "
                f"{wall_s * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms"
                f" (busy share {busy_us / 1e3 / (wall_s * 1e3):.3f}), K2 "
                f"{k2_us / 1e3:.3f} ms, {len(kern)} device events")
            for line in prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=12,
                    max_name_column_width=48).splitlines():
                log(f"  {line}")
        else:
            log("vector: the profiler recorded no device time "
                "(not measured)")
        del prof, kern
        await srv.stop()
        if not 0 < launches == adc_calls:
            raise AssertionError(f"query_many: {launches} K2 launches for "
                                 f"{adc_calls} ADC stages")
        res.update(vector_ann_qps=ANN_QUERIES / ann_s,
                   vector_ann_recall10=recall10(ann_i, exact_i),
                   k2_launches=launches, adc_calls=adc_calls)

        srv = await AnnServer(table, k=VEC_K, nprobe=VEC_NPROBE,
                              use_pq=False, device=dev, max_batch=ANN_BATCH,
                              warm_all=False).start()
        await srv.query_many(queries[:ANN_BATCH])          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat_i, _ = await srv.query_many(queries[:FLAT_QUERIES],
                                         batch=ANN_BATCH, depth=ANN_DEPTH)
        res["vector_ann_flat_qps"] = FLAT_QUERIES / (time.perf_counter() - t0)
        res["vector_ann_flat_recall10"] = recall10(flat_i, exact_i)
        await srv.stop()

        srv = await AnnServer(table, k=VEC_K, nprobe=VEC_NPROBE,
                              rerank=VEC_RERANK, device=dev,
                              max_batch=ANN_BATCH, max_wait_ms=2.0).start()
        await asyncio.gather(*(srv.query(q) for q in queries[:ANN_BATCH]))
        t0 = time.perf_counter()
        served = await asyncio.gather(
            *(srv.query(q) for q in queries[:SERVED_QUERIES]))
        res["vector_ann_served_qps"] = SERVED_QUERIES / (
            time.perf_counter() - t0)
        st = srv.stats()
        res["vector_ann_batch_occupancy"] = st["batch_occupancy"]
        res["served_batches"] = st["batches"]
        await srv.stop()
        res["vector_ann_served_recall10"] = recall10(
            np.stack([i for i, _ in served]), exact_i)

        torch.cuda.synchronize()
        res["device_bytes_after_index"] = torch.cuda.memory_allocated(dev)
        await table.knn(vecs[0], k=8, device=dev, use_index=False,
                        dtype="bf16")                      # re-pin in bf16
        t0 = time.perf_counter()
        outs = [await table.knn(vecs[123 + i], k=8, device=dev,
                                use_index=False, materialize=False,
                                dtype="bf16") for i in range(SCAN_REPS)]
        ids = outs[-1][0].cpu().numpy()
        res["vector_scan_bf16_mrows_s"] = SCAN_REPS * VEC_ROWS / (
            time.perf_counter() - t0) / 1e6
        if int(ids[0, 0]) != 123 + SCAN_REPS - 1:
            raise AssertionError(f"bf16 scan: top id {ids[0, 0]}")
        res["table_bf16_bytes_pinned"] = sum(
            t.nbytes for t in next(iter(table._dev_cache.values())))
        return seen[0]

    lut, codes = asyncio.run(run())
    cc = res["client_counters"]
    if cc.get("sc.write.fallbacks") or not cc.get("sc.bytes.written") or \
            cc.get("read.zero_copy_bytes"):
        raise AssertionError(f"vector: the table's bytes took another path "
                             f"than the short circuit: {cc}")
    q, w, m = codes.shape
    ksub = lut.shape[2]
    for pre_offset in (False, True):          # the path's own shape
        max_err = max(max_err, pq_bit_check(
            *pq_case(gen, dev, q, w, m, ksub, pre_offset), pre_offset))
    max_err = max(max_err, pq_bit_check(lut, codes, True))
    res["pq_shapes"][str([q, w, m, ksub])] = "bit-equal"
    res["max_abs_err"] = max_err
    res["k2"] = pq_timing(lut, codes, dev)
    res["k2"]["shape"] = [q, w, m, ksub]
    k2 = res["k2"]
    log(f"vector: K2 {[q, w, m, ksub]} (the path's, and on its own "
        f"inputs): bit-equal to the plain version; {k2['ms']:.4f} ms, "
        f"bound {k2['bound_ms']:.4f} ms by bytes ({k2['bound_ms'] / k2['ms']:.1%}"
        f" of it); plain {k2['plain_ms']:.4f} ms; embedding_bag "
        f"{k2['library_ms']:.4f} ms (max abs diff "
        f"{k2['embedding_bag_max_abs_diff']:.3g})")
    for key in ("vector_ann_recall10", "vector_ann_flat_recall10",
                "vector_ann_served_recall10"):
        if not res[key] >= 0.9:          # scripts/perf_floor.json:13
            raise AssertionError(f"{key} {res[key]} < 0.9")
    log(f"vector: the table through the port's client: "
        f"{cc.get('sc.bytes.written', 0):,} bytes written and "
        f"{cc.get('sc.bytes.read', 0):,} read by short circuit; "
        f"{res['compaction']}")
    log(f"vector: {VEC_ROWS:,} x {VEC_DIM} f32 appended in "
        f"{res['append_s']:.2f}s, pinned in {res['pin_s']:.2f}s "
        f"({res['table_bytes_pinned'] / MiB:.1f} MiB pinned, "
        f"{res['allocated_after_pin_bytes'] / MiB:.1f} MiB more allocated on"
        f" the card); "
        f"vector_index_build_s {res['vector_index_build_s']:.3f} (list cap "
        f"{res['list_cap']}, {res['nlist_total']} lists with spills, W "
        f"{res['width']}); device memory after the index "
        f"{res['device_bytes_after_index'] / MiB:.1f} MiB; bf16 table "
        f"{res['table_bf16_bytes_pinned'] / MiB:.1f} MiB pinned")
    log(f"vector: vector_ann_qps {res['vector_ann_qps']:.1f} "
        f"vector_ann_recall10 {res['vector_ann_recall10']:.4f} "
        f"vector_ann_flat_qps {res['vector_ann_flat_qps']:.1f} "
        f"vector_ann_flat_recall10 {res['vector_ann_flat_recall10']:.4f} "
        f"vector_ann_served_qps {res['vector_ann_served_qps']:.1f} "
        f"vector_ann_batch_occupancy {res['vector_ann_batch_occupancy']:.3f}"
        f" ({res['served_batches']} batches, recall10 "
        f"{res['vector_ann_served_recall10']:.4f}) vector_scan_mrows_s "
        f"{res['vector_scan_mrows_s']:.1f} vector_scan_bf16_mrows_s "
        f"{res['vector_scan_bf16_mrows_s']:.1f}; K2 launches in "
        f"query_many {res['k2_launches']} for {res['adc_calls']} ADC "
        f"stages; PQ search with K2 == with the plain ADC (64 queries)")
    return res


# ------------------------------------------------------------------ master

async def namespace(c, path: str = "/") -> dict:
    """Every file under ``path``: its length, whether it is complete, its
    blocks (id, length) and whether each block has a live location."""
    out = {}
    for st in await c.meta.list_status(path):
        if st.is_dir:
            out.update(await namespace(c, st.path))
            continue
        fb = await c.meta.get_block_locations(st.path)
        out[st.path] = {
            "len": st.len, "complete": st.is_complete,
            "blocks": [[lb.block.id, lb.block.len] for lb in fb.block_locs],
            "located": all(lb.locs for lb in fb.block_locs)}
    return out


def journal_files(conf: str) -> dict:
    import tomllib
    with open(conf, "rb") as f:
        jdir = tomllib.load(f)["master"]["journal_dir"]
    names = os.listdir(jdir)
    size = {n: os.path.getsize(os.path.join(jdir, n)) for n in names}
    return {"segments": sum(n.startswith("edits-") for n in names),
            "segment_bytes": sum(b for n, b in size.items()
                                 if n.startswith("edits-")),
            "snapshots": sum(n.startswith("snapshot-") for n in names),
            "snapshot_bytes": sum(b for n, b in size.items()
                                  if n.startswith("snapshot-"))}


def kv_files(conf: str) -> dict:
    """The master's KV directory (``<journal_dir>-meta``): its segments
    and WAL files, each with their bytes."""
    import tomllib
    with open(conf, "rb") as f:
        kdir = tomllib.load(f)["master"]["journal_dir"] + "-meta"
    names = os.listdir(kdir)
    size = {n: os.path.getsize(os.path.join(kdir, n)) for n in names}
    return {"kv_segments": sum(n.startswith("seg-") for n in names),
            "kv_segment_bytes": sum(b for n, b in size.items()
                                    if n.startswith("seg-")),
            "kv_wals": sum(n.startswith("wal-") for n in names),
            "kv_wal_bytes": sum(b for n, b in size.items()
                                if n.startswith("wal-"))}


def phase_master(root: str, conf: str, cluster: dict, pw: PortWorker,
                 probe: tuple[str, np.ndarray], ufs: dict) -> dict:
    """The port's master as the run left it: its per-code RPC counts and
    p50s, then a stop and a restart on the same journal and KV directory
    (recovery timed: the store opened at its ``applied_seq``, the
    journal's tail past it replayed; the store's engine must be the
    native one, and the applied seq the journal's after the restart),
    every file of the run listed again with the same length and blocks
    once the port's worker has sent the report the restarted master asks
    for (``report_now``), phase ufs's mount table and job records the
    same after the restart (the journal's ``mount_*`` and ``job_*``
    entries replayed), and one checkpoint tensor read back bit for bit
    through the port's client. ``cluster["proc"]`` is the master's
    process, replaced by the restarted one's."""
    master = cluster["info"]["addr"]

    async def walk() -> dict:
        async with port_client(master) as c:
            return await namespace(c)

    async def mounts_and_jobs() -> tuple[list, dict]:
        async with port_client(master) as c:
            table = [m.to_wire() for m in await c.meta.mount_table()]
            jobs = {}
            for jid in ufs["jobs"]:
                wire = (await c.meta.job_status(jid)).to_wire()
                wire.pop("tasks")          # never journaled
                jobs[jid] = wire
            return table, jobs

    before = asyncio.run(walk())
    if not before or not all(f["located"] and f["complete"]
                             for f in before.values()):
        raise AssertionError("master: the run left no file, or a file "
                             "incomplete or with a block nowhere")
    mj_before = asyncio.run(mounts_and_jobs())
    t = time.perf_counter()
    stop_master(cluster["proc"])
    stop_s = time.perf_counter() - t
    # this master served phases client to vector, which stop no master:
    # its breaks are filed under this phase, so they are held here
    served = [b for b in cluster["proc"].breaks if not b[2]]
    if served:
        raise AssertionError(f"master: the cluster's master broke "
                             f"{len(served)} writers in the phases before "
                             f"this one, which stop no master")
    with open(os.path.join(root, "master0.json")) as f:
        stats = json.load(f)
    files = journal_files(conf) | kv_files(conf)
    cluster["proc"], info = start_master(root, conf, 1)
    rec = info["recovery"]
    if info["store"].get("engine") != "native" \
            or stats["store"].get("engine") != "native" \
            or rec["applied_seq"] != info["journal_seq"] \
            or info["journal_seq"] != stats["journal_seq"]:
        raise AssertionError(f"master: the store before the stop "
                             f"{stats['store']}, after the restart "
                             f"{info['store']}, recovery {rec}, journal "
                             f"seq {stats['journal_seq']} then "
                             f"{info['journal_seq']}")
    t = time.perf_counter()
    while True:
        after = asyncio.run(walk())
        located = all(f["located"] for f in after.values())
        if located or time.perf_counter() - t > 120:
            break
        time.sleep(0.1)
    rejoin_s = time.perf_counter() - t
    strip = {p: {k: v for k, v in f.items() if k != "located"}
             for p, f in before.items()}
    if {p: {k: v for k, v in f.items() if k != "located"}
            for p, f in after.items()} != strip or not located:
        diff = sorted(p for p in set(before) | set(after)
                      if before.get(p) != after.get(p))
        raise AssertionError(f"master: after the restart {len(after)} files "
                             f"of {len(before)}, {len(diff)} differ or lack a "
                             f"location: {diff[:5]}")
    await_port_worker(master, pw)
    mj_after = asyncio.run(mounts_and_jobs())
    if mj_after != mj_before or not mj_before[0] \
            or len(mj_before[1]) != len(ufs["jobs"]):
        raise AssertionError(f"master: phase ufs's mounts and jobs before "
                             f"the restart {mj_before}, after {mj_after}")

    async def read_probe():
        async with port_client(master) as c:
            t = time.perf_counter()
            raw = await c.read_all(probe[0])
            return raw, time.perf_counter() - t

    raw, probe_s = asyncio.run(read_probe())
    if not np.array_equal(np.frombuffer(raw, dtype=np.uint8), probe[1]):
        raise AssertionError(f"master: {probe[0]} read after the restart "
                             f"differs from the saved tensor")
    n_blocks = sum(len(f["blocks"]) for f in before.values())
    res = {"start_s": cluster["info"]["start_s"],
           "start_recover_s": cluster["info"]["recover_s"],
           "stop_s": stop_s, "restart_s": info["start_s"],
           "recover_s": info["recover_s"], "rejoin_s": rejoin_s,
           "journal_seq": stats["journal_seq"], "groups": stats["groups"],
           "entries": stats["entries"], **files, "store": info["store"],
           "recovery": rec,
           "files": len(before), "blocks": n_blocks,
           "mounts": len(mj_before[0]), "jobs": len(mj_before[1]),
           "probe": probe[0], "probe_bytes": int(probe[1].nbytes),
           "probe_read_s": probe_s, "rpc": stats["rpc"],
           "counters": stats["counters"], "gauges": stats["gauges"]}
    log(f"master: before its stop the port's master served "
        + ", ".join(f"{k} {v['count']} (p50 {v['p50_ms']:.3f} ms)"
                    for k, v in stats["rpc"].items()))
    log(f"master: journal of {res['journal_seq']} entries "
        f"({res['entries']} in {res['groups']} group commits), "
        f"{res['segments']} segments of {res['segment_bytes']:,} bytes; "
        f"the namespace in the KV store ({info['store']['engine']} "
        f"engine, no snapshot: {res['snapshots']}): "
        f"{res['kv_segments']} segments of {res['kv_segment_bytes']:,} "
        f"bytes and {res['kv_wals']} WAL files of {res['kv_wal_bytes']:,} "
        f"bytes after the stop; stopped in {stop_s:.3f}s, back in "
        f"{res['restart_s']:.3f}s (construction to serving "
        f"{res['recover_s']:.3f}s: {rec['inodes']} inodes and "
        f"{rec['blocks']} blocks at applied_seq {rec['applied_seq']}, "
        f"{rec['replayed']} tail entries replayed); every one of "
        f"{len(before)} files ({n_blocks} blocks) listed again with the same "
        f"length and blocks, each located {rejoin_s:.3f}s after the restart "
        f"(the worker's report); phase ufs's {res['mounts']} mounts and "
        f"{res['jobs']} job records the same after the restart; {probe[0]} "
        f"({res['probe_bytes']:,} bytes) read back bit for bit in "
        f"{probe_s:.3f}s")
    return res


# ------------------------------------------------------------- recover

class _Tripwire(dict):
    """A client's counters that call ``fire`` once, on the thread that
    counts, when ``key`` first reaches ``at``."""

    def __init__(self, key: str, at: int, fire):
        super().__init__()
        self.key, self.at, self.fire, self.fired = key, at, fire, False

    def __setitem__(self, k, v) -> None:
        super().__setitem__(k, v)
        if k == self.key and v >= self.at and not self.fired:
            self.fired = True
            self.fire()


def _record_placements(c, into: list) -> None:
    """``c.meta.add_block`` wrapped: each placed block's time and worker
    ids appended to ``into``."""
    real = c.meta.add_block

    async def add_block(path, *a, **kw):
        lb = await real(path, *a, **kw)
        into.append((time.perf_counter(), [x.worker_id for x in lb.locs]))
        return lb
    c.meta.add_block = add_block


def phase_recover(dev: torch.device, root: str, seed: int, params: dict,
                  ckpt: dict) -> dict:
    """The client's write recovery on one card: a master of the phase's
    own (``ici`` placement, a lost timeout of REP_LOST_MS) and four of the
    port's workers in this process, A to D at ICI (0..3, 0), each with a
    mem tier under the phase's directory and a small tier-0 on the card;
    the client writes from (0, 0), so placement is fixed: the nearest
    worker first, then the farthest. (a) ``/recover/shards``, SHARDS
    token shards (ids below the flagship's vocab, from ``seed``), one
    replica, written by short circuit through one ``FsWriter`` in
    RECOVER_WRITE pieces; RECOVER_KILL_AT into block 1, its worker (A) is
    stopped. The temp file stays writable, so the death shows at the
    block's SC_WRITE_COMMIT: the block is abandoned, re-placed on B and
    replayed whole. After block 3 seals, ``hflush`` journals its commit
    and a second client's GET_BLOCK_LOCATIONS lists the three blocks
    before ``close``. ``close`` raises nothing, the file equals its tokens,
    no block is on A; the write's GiB/s beside the same file written
    before with no death. (b) Phase ckpt's parameters saved with two
    replicas at a floor of two (every block on B and D), first with no
    death (then deleted), then to ``/recover/ckpt``; once that save has
    written RECOVER_SAVE_KILL bytes, the leg of the open block that holds
    none of (a)'s blocks (D) is stopped: the surviving leg is below the
    floor, so the block is replayed onto B and C; D's earlier blocks keep
    their replica on B and the master heals them onto C. Each block open
    after the stop is timed, and those placed on D first counted (the
    master lists D until its lost timeout, and each such open dials it,
    fails and asks again). The checkpoint loaded onto the card with
    ``distribute_checkpoint_to_device``, bit for bit equal to the saved
    tensors, and the loss of one train batch from it equal to the saved
    parameters' (K3's forward, twice a layer). (c) The earlier reads'
    heat decayed by the workers' host promotion scans, each replayed
    block read up to WORKER_MIN_READS through a client, and its holders'
    promote cycles pin it, K1 verifying each pin; each device copy equal
    to its block file on the card. (d) A fifth worker E at (4, 0); a
    reader opened on the checkpoint's first tensor of several blocks
    (every block on B and C); C stopped and its blocks healed onto E; B
    stopped; the open reader's ``read_all`` equals the tensor after
    exactly one more GET_BLOCK_LOCATIONS (the refresh). The phase's files
    are deleted, its workers and master stopped and its directory
    removed, however it ends."""
    from curvine_tpu_torch.client import writer as fswriter
    from curvine_tpu_torch.common.conf import ClientConf
    from curvine_tpu_torch.gpu import broadcast, cuda_ops, flash
    from curvine_tpu_torch.gpu import model as tm
    base = os.path.join(root, "recover")
    os.makedirs(base)
    res = {"lost_timeout_ms": REP_LOST_MS}
    workers: dict[str, PortWorker] = {}
    proc = None
    recoveries = []
    opens = []
    real_recover = fswriter.FsWriter._recover_block
    real_next = fswriter.FsWriter._next_block

    async def timed_recover(self, cause):
        n = len(self._replay) if self._replay is not None else 0
        t = time.perf_counter()
        await real_recover(self, cause)
        recoveries.append({"path": self.path, "bytes": n,
                           "s": time.perf_counter() - t,
                           "block": self._block.block.id})

    async def timed_next(self, *a, **kw):
        t = time.perf_counter()
        try:
            return await real_next(self, *a, **kw)
        finally:
            opens.append((self.path, t, time.perf_counter() - t))

    def stop(name: str) -> float:
        """Stop worker ``name``; returns the time it stopped."""
        workers.pop(name).stop()
        return time.perf_counter()

    def ids_of(*names) -> list[int]:
        return [workers[n].worker.worker_id for n in names]

    tokens = ufs_tokens(seed, SHARDS, 0x72656376)
    raw = memoryview(tokens.view(np.uint8))
    cfg = _flagship()
    saved = tm.leaves(params)
    nbytes = sum(t.nbytes for t in saved)
    kernels = [getattr(flash, n) for n in K3_NAMES]
    fswriter.FsWriter._recover_block = timed_recover
    fswriter.FsWriter._next_block = timed_next
    try:
        conf = master_conf(base, lost_ms=REP_LOST_MS, policy="ici")
        proc, info = start_master(base, conf)
        master = info["addr"]
        res["master_start_s"] = info["start_s"]
        for i, name in enumerate("abcd"):
            workers[name] = PortWorker(
                master, os.path.join(base, name), RECOVER_TIER_BYTES, dev,
                coords=(i, 0), hbm_bytes=RECOVER_HBM_BYTES)
        names = {workers[n].worker.worker_id: n for n in workers}
        await_live(master, ids_of(*"abcd"), phase="recover")

        # (a) one replica by short circuit, its worker stopped mid-block
        cuts = sorted(set(range(0, len(raw) + 1, RECOVER_WRITE))
                      | {RECOVER_KILL_AT})
        pieces = list(zip(cuts, cuts[1:]))

        async def write_a():
            async with port_client(master, coords=(0, 0)) as c, \
                    port_client(master) as other:
                t = time.perf_counter()
                w = await c.create("/recover/clean", replicas=1)
                for o, e in pieces:
                    await w.write(raw[o:e])
                await w.close()
                clean_s = time.perf_counter() - t
                await c.meta.delete("/recover/clean")
                placed = []
                _record_placements(c, placed)
                flushed = None
                t = time.perf_counter()
                w = await c.create("/recover/shards", replicas=1)
                for o, e in pieces:
                    await w.write(raw[o:e])
                    if e == RECOVER_KILL_AT:
                        victim = placed[0][1][0]
                        await asyncio.to_thread(stop, names[victim])
                    if e == 3 * BLOCK:
                        await w.hflush()
                        fb = await other.meta.get_block_locations(
                            "/recover/shards")
                        flushed = (fb.status.is_complete,
                                   [lb.block.len for lb in fb.block_locs])
                await w.close()
                shards_s = time.perf_counter() - t
                back = await c.read_all("/recover/shards")
                fb = await c.meta.get_block_locations("/recover/shards")
                locs = [[x.worker_id for x in lb.locs]
                        for lb in fb.block_locs]
                return (clean_s, shards_s, victim, flushed, locs,
                        back == raw, dict(c.counters))

        clean_s, shards_s, victim_a, flushed, locs_a, equal, ca = \
            asyncio.run(write_a())
        rec_a = [r for r in recoveries if r["path"] == "/recover/shards"]
        holders_a = {w for ids in locs_a for w in ids}
        if names.get(victim_a) != "a" or not equal \
                or flushed != (False, [BLOCK] * 3) \
                or victim_a in holders_a or len(locs_a) != SHARDS \
                or len(rec_a) != 1 or rec_a[0]["bytes"] != BLOCK \
                or ca.get("write.block_replay_bytes") != BLOCK \
                or ca.get("write.replica_failover", 0) < 1:
            raise AssertionError(
                f"recover (a): victim {victim_a} ({names.get(victim_a)}), "
                f"file equal {equal}, after hflush {flushed}, blocks on "
                f"{locs_a}, recoveries {rec_a}, counters {ca}")
        size = len(raw)
        res["a"] = dict(
            bytes=size, victim=victim_a, clean_s=clean_s,
            clean_gibs=size / GiB / clean_s, write_s=shards_s,
            write_gibs=size / GiB / shards_s, replay_bytes=rec_a[0]["bytes"],
            replay_s=rec_a[0]["s"],
            replica_failover=ca["write.replica_failover"],
            sc_bytes_written=ca.get("sc.bytes.written", 0),
            blocks_on=sorted(holders_a))
        ra = res["a"]
        log(f"recover (a): /recover/shards, {size // MiB} MiB of tokens in "
            f"{RECOVER_WRITE // MiB} MiB writes, one replica by short "
            f"circuit; worker A ({victim_a}) stopped {RECOVER_KILL_AT // MiB} "
            f"MiB into block 1; its SC_WRITE_COMMIT failed and the block was "
            f"replayed onto B ({ra['replay_bytes']:,} bytes, the whole "
            f"block, in {ra['replay_s']:.3f}s); hflush after block 3: "
            f"another client saw 3 blocks of {BLOCK // MiB} MiB, the file "
            f"open; close "
            f"raised nothing: {ra['write_gibs']:.3f} GiB/s against "
            f"{ra['clean_gibs']:.3f} with no death; the file equal to its "
            f"tokens, its blocks on {ra['blocks_on']}, none on A; "
            f"write.replica_failover {ra['replica_failover']}")
        if holders_a != set(ids_of("b")):
            raise AssertionError(f"recover (a): blocks on {holders_a}, not "
                                 f"all on B")
        await_live(master, ids_of(*"bcd"), phase="recover")

        # (b) the checkpoint at two replicas and a floor of two, a leg's
        # worker stopped mid-block
        stopped = {}

        def kill_b():
            legs = save_placed[-1][1]
            spare = [x for x in legs if x not in holders_a]
            stopped["victim"] = spare[0] if spare else None
            stopped["legs"] = legs
            if spare:
                stopped["t"] = stop(names[spare[0]])

        save_placed = []
        breaker = {}

        def note_breaker(c) -> None:
            """``c.health.fail`` wrapped: when the stopped worker's
            breaker opens, and after how many failures."""
            from curvine_tpu_torch.client.health import OPEN
            real = c.health.fail
            fails = []

            def fail(addr, worker_id=None):
                real(addr, worker_id=worker_id)
                if worker_id is None or worker_id != stopped.get("victim"):
                    return
                fails.append(time.perf_counter())
                if "t" not in breaker and c.health.state(addr) == OPEN:
                    breaker["t"] = fails[-1]
                    breaker["fails"] = len(fails)
            c.health.fail = fail

        async def save_b():
            async with port_client(master, coords=(0, 0), replicas=2,
                                   write_min_replicas=2) as c:
                torch.cuda.synchronize()
                t = time.perf_counter()
                await broadcast.save_checkpoint(c, "/recover/clean", params)
                clean_s = time.perf_counter() - t
                await c.meta.delete("/recover/clean", recursive=True)
                _record_placements(c, save_placed)
                note_breaker(c)
                c.counters = _Tripwire("write.bytes", RECOVER_SAVE_KILL,
                                       kill_b)
                t = time.perf_counter()
                await broadcast.save_checkpoint(c, "/recover/ckpt", params)
                return clean_s, time.perf_counter() - t, dict(c.counters)

        clean_s, save_s, cb = asyncio.run(save_b())
        # the save's block opens after the stop, and those that were
        # placed on the stopped worker first (the master lists it until
        # its lost timeout; the open dials it, fails and asks again)
        after = [(t, dt) for p, t, dt in opens
                 if p.startswith("/recover/ckpt/") and t >= stopped["t"]]
        dead = [(t, dt) for t, dt in after if any(
            t <= at <= t + dt and stopped["victim"] in legs
            for at, legs in save_placed)]
        rec_b = [r for r in recoveries if r["path"].startswith(
            "/recover/ckpt/")]
        victim_b = stopped.get("victim")
        # with the breaker: once D's opened, no placement names D
        named_after = [at - stopped["t"] for at, legs in save_placed
                       if "t" in breaker and at > breaker["t"]
                       and victim_b in legs]
        threshold = ClientConf().breaker_fail_threshold
        if names.get(victim_b) != "d" or sorted(stopped["legs"]) != \
                sorted(ids_of("b") + [victim_b]) or len(rec_b) != 1 \
                or not cb.get("write.block_replay_bytes") or named_after \
                or len(dead) > threshold:
            raise AssertionError(f"recover (b): stopped {stopped} "
                                 f"({names.get(victim_b)}), recoveries "
                                 f"{rec_b}, counters {cb}, D's breaker "
                                 f"{breaker}, {len(dead)} opens placed on D "
                                 f"first, placements naming D after its "
                                 f"breaker opened (s after the stop) "
                                 f"{named_after}")

        async def ckpt_locs():
            async with port_client(master) as c:
                out = {}
                for st in await c.meta.list_status("/recover/ckpt"):
                    fb = await c.meta.get_block_locations(st.path)
                    out[st.path] = [(lb.block.id, sorted(
                        x.worker_id for x in lb.locs))
                        for lb in fb.block_locs]
                return out

        bc = sorted(ids_of("b", "c"))
        heal_s = time.perf_counter() - stopped["t"] + _poll(
            lambda: all(ids == bc for locs in asyncio.run(ckpt_locs())
                        .values() for _, ids in locs),
            120, "healed /recover/ckpt to B and C", 0.2, "recover")
        batch = torch.from_numpy(train_tokens(cfg, seed)[
            :TRAIN_BATCH * TRAIN_SEQ].reshape(TRAIN_BATCH, TRAIN_SEQ)).to(dev)

        async def load_b():
            async with port_client(master) as c:
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = await broadcast.distribute_checkpoint_to_device(
                    c, "/recover/ckpt", dev)
                torch.cuda.synchronize()
                return got, time.perf_counter() - t

        loaded, load_s = asyncio.run(load_b())
        back = tm.leaves(loaded)
        bad = [i for i, (x, y) in enumerate(zip(saved, back))
               if x.dtype != y.dtype or x.shape != y.shape
               or y.device != x.device
               or not torch.equal(_int_view(x), _int_view(y))]
        for fn in kernels:
            fn.launches = 0
        with torch.no_grad():
            loss_saved = tm.loss_fn(params, batch, cfg)
            loss_loaded = tm.loss_fn(loaded, batch, cfg)
        launches = {fn.__name__: fn.launches for fn in kernels}
        del loaded, back
        res["b"] = dict(
            bytes=nbytes, tensors=len(saved), victim=victim_b,
            save_s=save_s, save_gibs=nbytes / GiB / save_s,
            clean_s=clean_s, clean_gibs=nbytes / GiB / clean_s,
            ckpt_save_gibs=ckpt["save_gibs"],
            replay_bytes=cb["write.block_replay_bytes"],
            replay_s=rec_b[0]["s"],
            replica_failover=cb.get("write.replica_failover", 0),
            opens_after=len(after), opens_after_s=sum(d for _, d in after),
            dead_opens=len(dead), dead_opens_s=sum(d for _, d in dead),
            breaker_open_s=(breaker["t"] - stopped["t"] if breaker
                            else None),
            breaker_fails=breaker.get("fails"),
            heal_s=heal_s, load_s=load_s, load_gibs=nbytes / GiB / load_s,
            loss_saved=loss_saved.item(), loss_loaded=loss_loaded.item())
        rb = res["b"]
        log(f"recover (b): phase ckpt's {len(saved)} tensors saved to "
            f"/recover/ckpt with two replicas at a floor of two (B and D); "
            f"at {RECOVER_SAVE_KILL / GiB:g} GiB written, D ({victim_b}), "
            f"a leg of the open block, stopped; the surviving leg below the "
            f"floor, the block replayed onto B and C ({rb['replay_bytes']:,} "
            f"bytes in {rb['replay_s']:.3f}s); the save raised nothing: "
            f"{rb['save_gibs']:.3f} GiB/s against {rb['clean_gibs']:.3f} "
            f"for the same save with no death and phase ckpt's "
            f"{rb['ckpt_save_gibs']:.3f} (one replica, short circuit); "
            f"{rb['dead_opens']} of the {rb['opens_after']} block opens "
            f"after the stop were placed on D first and took "
            f"{rb['dead_opens_s']:.3f}s of their {rb['opens_after_s']:.3f}s; "
            + (f"D's breaker opened {rb['breaker_open_s']:.3f}s after the "
               f"stop, after {rb['breaker_fails']} failures noted against "
               f"it, and no later open named D; "
               if rb["breaker_open_s"] is not None
               else "D's breaker never opened; ")
            + f"every block back at two live replicas (B, C) {heal_s:.3f}s "
            f"after the stop; loaded onto {dev} in {load_s:.3f}s "
            f"({rb['load_gibs']:.3f} GiB/s), {len(bad)} tensors not "
            f"bit-equal; loss saved {rb['loss_saved']!r} loaded "
            f"{rb['loss_loaded']!r}; K3 launches {launches}")
        if bad or not torch.equal(loss_saved, loss_loaded) \
                or not math.isfinite(rb["loss_saved"]) \
                or launches != {"flash_fwd": 2 * cfg.n_layers,
                                "flash_bwd_di": 0, "flash_bwd_dkv": 0,
                                "flash_bwd_dq": 0}:
            raise AssertionError(f"recover (b): tensors not bit-equal "
                                 f"{bad[:5]}, losses {rb['loss_saved']} "
                                 f"{rb['loss_loaded']}, K3 {launches}")

        # (c) the replayed blocks pinned, each pin verified by K1
        replayed = {r["block"]: r["path"] for r in rec_a + rec_b}
        for pw_ in workers.values():
            for _ in range(3):
                pw_.worker.store.promote_scan(WORKER_MIN_READS)

        async def heat():
            async with port_client(master) as c:
                for bid, path in replayed.items():
                    fb = await c.meta.get_block_locations(path)
                    lb = next(x for x in fb.block_locs if x.block.id == bid)
                    r = await c.open(path)
                    try:
                        await r.pread(lb.offset, lb.block.len)
                    finally:
                        await r.close()

        def holder(bid):
            return next((pw_.worker for pw_ in workers.values()
                         if pw_.worker.hbm_holds(bid)), None)

        pins0 = sum(pw_.worker.metrics.counters.get("blocks.hbm_pinned", 0)
                    for pw_ in workers.values())
        cuda_ops.block_checksum.launches = 0
        cycles = 0
        while any(holder(b) is None for b in replayed) and cycles < 4:
            asyncio.run(heat())
            for pw_ in workers.values():
                pw_.call(pw_.worker._promote_once())
            cycles += 1
        k1 = cuda_ops.block_checksum.launches
        pins = sum(pw_.worker.metrics.counters.get("blocks.hbm_pinned", 0)
                   for pw_ in workers.values()) - pins0
        missing = [b for b in replayed if holder(b) is None]
        if missing or k1 != pins or pins != len(replayed):
            raise AssertionError(f"recover (c): {cycles} promote cycles, "
                                 f"{pins} pins, {k1} K1 launches, replayed "
                                 f"blocks {sorted(replayed)} not pinned "
                                 f"{missing}")
        for bid in replayed:
            w = holder(bid)
            got = w.hbm_get(bid).reshape(-1).view(torch.uint8)
            ref = torch.from_numpy(np.fromfile(
                w.store.get(bid, touch=False).path, dtype=np.uint8)).to(dev)
            if not torch.equal(got, ref):
                raise AssertionError(f"recover (c): block {bid}'s device "
                                     f"copy differs from its file")
        del got, ref
        res["c"] = dict(replayed=sorted(replayed), pins=pins,
                        k1_launches=k1, cycles=cycles)
        log(f"recover (c): the replayed blocks {sorted(replayed)} read up "
            f"to {WORKER_MIN_READS} and pinned by their holders' promote "
            f"cycles ({cycles} a worker): {pins} pins, {k1} K1 launches; "
            f"each device copy equal to its block file on the card")

        # (d) the reader's location refresh
        workers["e"] = PortWorker(
            master, os.path.join(base, "e"), RECOVER_TIER_BYTES, dev,
            coords=(4, 0), hbm_bytes=RECOVER_HBM_BYTES)
        names[workers["e"].worker.worker_id] = "e"
        await_live(master, ids_of("b", "c", "e"), phase="recover")
        i = next(i for i, t in enumerate(saved) if t.nbytes > BLOCK)
        path = f"/recover/ckpt/t{i:05d}.bin"
        want = saved[i].detach().cpu().contiguous().reshape(-1) \
            .view(torch.uint8).numpy()
        be = sorted(ids_of("b", "e"))

        async def refresh():
            async with port_client(master, short_circuit=False) as c:
                r = await c.open(path)
                before = [ids for _, ids in (await ckpt_locs())[path]]
                calls = []
                real = c.meta.get_block_locations

                async def get_block_locations(p, *a, **kw):
                    calls.append(p)
                    return await real(p, *a, **kw)
                c.meta.get_block_locations = get_block_locations
                t = await asyncio.to_thread(stop, "c")
                healed_s = await asyncio.to_thread(
                    _poll, lambda: all(
                        sorted(ids) == be
                        for _, ids in _block_locs(master, path)),
                    60, f"healed {path} onto E", 0.05, "recover")
                await asyncio.to_thread(stop, "b")
                t = time.perf_counter()
                got = await r.read_all()
                read_s = time.perf_counter() - t
                await r.close()
                board = {names.get(v["worker_id"]): (v["state"],
                                                     v["failures"])
                         for v in c.health.snapshot().values()}
                return before, calls, healed_s, read_s, \
                    np.array_equal(np.frombuffer(got, np.uint8), want), board

        before, calls, healed_s, read_s, equal, board = \
            asyncio.run(refresh())
        res["d"] = dict(path=path, bytes=want.size,
                        blocks=len(before), healed_s=healed_s,
                        read_s=read_s, refreshes=len(calls),
                        breakers=board)
        log(f"recover (d): a reader of {path} ({want.size:,} bytes, "
            f"{len(before)} blocks, every one on B and C) opened; C stopped "
            f"and its blocks healed onto E {healed_s:.3f}s after; B stopped; "
            f"the open reader's read_all took {read_s:.3f}s through "
            f"{len(calls)} GET_BLOCK_LOCATIONS (the refresh), bit-equal "
            f"{equal}; the reader's breakers after it (state, failures) "
            f"{board}")
        if not equal or calls != [path] or \
                any(ids != bc for ids in before):
            raise AssertionError(f"recover (d): located {before} at the "
                                 f"open, refreshes {calls}, equal {equal}")
    finally:
        fswriter.FsWriter._recover_block = real_recover
        fswriter.FsWriter._next_block = real_next
        try:
            if proc is not None and proc.poll() is None:
                async def delete():
                    async with port_client(master) as c:
                        await c.meta.delete("/recover", recursive=True)
                asyncio.run(delete())
        except Exception as e:  # noqa: BLE001 — the directory goes anyway
            log(f"recover: deleting /recover failed: {e}")
        for name in list(workers):
            stop(name)
        if proc is not None:
            stop_master(proc)
        shutil.rmtree(base, ignore_errors=True)
    res["k1_launches"] = k1
    res["launches"] = launches
    return res


# ------------------------------------------------------------------ ici

async def _rpc(addr: str, code, body: dict) -> dict:
    from curvine_tpu_torch.rpc.client import Connection
    from curvine_tpu_torch.rpc.frame import pack, unpack
    conn = await Connection(addr).connect()
    try:
        rep = await conn.call(code, data=pack(body))
        return rep.header or unpack(rep.data)
    finally:
        await conn.close()


def await_live(master: str, ids: list[int], timeout: float = 60,
               phase: str = "ici") -> None:
    """Wait until the master lists exactly the workers ``ids``."""
    async def run():
        async with port_client(master) as c:
            t = time.perf_counter()
            while True:
                live = sorted(w["address"]["worker_id"]
                              for w in await live_workers(c))
                if live == sorted(ids) or time.perf_counter() - t > timeout:
                    return live
                await asyncio.sleep(0.1)

    live = asyncio.run(run())
    if live != sorted(ids):
        raise AssertionError(f"{phase}: the master's live workers are "
                             f"{live}, not {sorted(ids)}")


def phase_ici(rng: np.random.Generator, dev: torch.device, root: str
              ) -> dict:
    """The peer-device plane on one card: a master of the phase's own and
    two of the port's workers in this process, A at ICI coordinates
    (0, 0) and B at (1, 0), each with a tier-0 on the card. A 64 MiB
    block written to A through the port's client (B not yet started) is
    pinned by A's promote cycle, K1 verifying the pin; then read from A
    by READ_BLOCK (short circuit off), and moved to B by ICI_TRANSFER
    ICI_REPS times (B's copy deleted between), each split into fetch
    (the peer's tensor through the device domain), D2H, crc32c, write,
    commit and report. B's block must equal A's file bit for bit, its
    commit crc A's, and the master must locate the block on both. Then
    A unpins the block and an ICI_TRANSFER answers ``success: False``
    with one TCP fallback counted. Last, bench.py's rail A/B over a
    ``(1,)`` NCCL mesh of this process: ``broadcast_bytes`` against
    ``flat_replicate`` of 64 MiB, each bit-exact on the card."""
    from curvine_tpu_torch.gpu import cuda_ops, ici_plane, multihost
    from curvine_tpu_torch.gpu.mesh import make_mesh
    from curvine_tpu_torch.rpc.codes import RpcCode
    from curvine_tpu_torch.worker import server
    base = os.path.join(root, "ici")
    os.makedirs(base)
    conf = master_conf(base)
    proc, info = start_master(base, conf)
    master = info["addr"]
    workers = []
    path = "/ici/block"
    res = {"master_start_s": info["start_s"]}
    try:
        a = PortWorker(master, os.path.join(base, "a"), ICI_TIER_BYTES, dev,
                       coords=(0, 0))
        workers.append(a)
        await_live(master, [a.worker.worker_id])
        data = rng.integers(0, 1 << 64, BLOCK // 8, dtype=np.uint64)

        async def write_and_heat():
            async with port_client(master) as c:
                await c.write_all(path, data)
                await c.read_all(path)           # heat 2: probe and read
                fb = await c.meta.get_block_locations(path)
                return fb.block_locs[0].block.id

        bid = asyncio.run(write_and_heat())
        b = PortWorker(master, os.path.join(base, "b"), ICI_TIER_BYTES, dev,
                       coords=(1, 0))
        workers.append(b)
        wa, wb = a.worker, b.worker
        await_live(master, [wa.worker_id, wb.worker_id])
        cuda_ops.block_checksum.launches = 0
        a.call(wa._promote_once())
        k1 = cuda_ops.block_checksum.launches
        if not wa.hbm_holds(bid) or k1 != 1:
            raise AssertionError(f"ici: A's promote cycle pinned the block "
                                 f"{wa.hbm_holds(bid)} with {k1} K1 "
                                 f"launches")
        a_info = wa.store.get(bid, touch=False)
        pinned = wa.hbm_get(bid)
        if pinned.device != dev or not torch.equal(
                pinned.view(torch.int64),
                torch.from_numpy(data.view(np.int64)).to(dev)):
            raise AssertionError("ici: A's pinned tensor differs from the "
                                 "block")
        del pinned

        async def read_block():
            async with port_client(master, short_circuit=False) as c:
                out = []
                for _ in range(2):
                    t = time.perf_counter()
                    raw = await c.read_all(path)
                    out.append((time.perf_counter() - t, raw))
                return out, dict(c.counters)

        rb, rb_counters = asyncio.run(read_block())
        if not all(np.array_equal(np.frombuffer(raw, dtype=np.uint64), data)
                   for _, raw in rb) or \
                rb_counters.get("read.zero_copy_bytes") != 2 * BLOCK:
            raise AssertionError(f"ici: READ_BLOCK from A: {rb_counters}")

        split = {k: [] for k in ("fetch", "d2h", "crc32c", "write",
                                 "commit", "report")}
        real = {"fetch": (ici_plane, "fetch_device_block"),
                "d2h": (server, "_to_host"), "crc32c": (server, "crc_update"),
                "write": (server, "_write_file"),
                "commit": (wb.store, "commit"),
                "report": (wb, "_leader_call")}
        saved = {k: getattr(o, n) for k, (o, n) in real.items()}

        def timed_async(fn, into):
            async def timed(*a, **kw):
                t = time.perf_counter()
                try:
                    return await fn(*a, **kw)
                finally:
                    into.append(time.perf_counter() - t)
            return timed

        for k, (o, n) in real.items():
            setattr(o, n, (timed_async if k == "report" else _timed)(
                saved[k], split[k]))
        ask = {"block_id": bid, "source_worker_id": wa.worker_id,
               "block_len": BLOCK}
        rpc_s, replies = [], []
        try:
            for _ in range(ICI_REPS):
                if wb.store.contains(bid):
                    wb._apply_deletes([bid])
                t = time.perf_counter()
                replies.append(asyncio.run(_rpc(wb.addr,
                                                RpcCode.ICI_TRANSFER, ask)))
                rpc_s.append(time.perf_counter() - t)
        finally:
            for k, (o, n) in real.items():
                if k in ("commit", "report"):
                    delattr(o, n)
                else:
                    setattr(o, n, saved[k])
        if replies != [{"success": True, "via": "ici"}] * ICI_REPS:
            raise AssertionError(f"ici: ICI_TRANSFER answered {replies}")
        b_info = wb.store.get(bid, touch=False)
        landed = np.fromfile(b_info.path, dtype=np.uint64)
        if not np.array_equal(landed, data) or b_info.len != BLOCK \
                or (b_info.crc_algo, b_info.crc32c) != \
                (a_info.crc_algo, a_info.crc32c):
            raise AssertionError(
                f"ici: B's block ({b_info.len} bytes, {b_info.crc_algo} "
                f"{b_info.crc32c:#x}) against A's ({a_info.crc_algo} "
                f"{a_info.crc32c:#x}), bytes equal "
                f"{np.array_equal(landed, data)}")

        async def locations():
            async with port_client(master) as c:
                fb = await c.meta.get_block_locations(path)
                return sorted(x.worker_id for x in fb.block_locs[0].locs)

        where = asyncio.run(locations())
        if where != sorted([wa.worker_id, wb.worker_id]):
            raise AssertionError(f"ici: the master locates the block on "
                                 f"{where}")
        pulls = wb.metrics.counters.get("ici.peer_pulls", 0)
        read_a = wa.metrics.counters.get("bytes.read", 0)
        if pulls != ICI_REPS or read_a != 2 * BLOCK:
            raise AssertionError(f"ici: {pulls} peer pulls, {read_a} bytes "
                                 f"read from A (the two READ_BLOCKs only)")

        # the miss: A no longer pins the block
        asyncio.run(_rpc(wa.addr, RpcCode.HBM_UNPIN, {"block_id": bid}))
        wb._apply_deletes([bid])
        before = wb.metrics.counters.get("ici.tcp_fallbacks", 0)
        miss = asyncio.run(_rpc(wb.addr, RpcCode.ICI_TRANSFER, ask))
        fallbacks = wb.metrics.counters.get("ici.tcp_fallbacks", 0) - before
        if miss != {"success": False, "via": ""} or fallbacks != 1 \
                or wb.store.contains(bid):
            raise AssertionError(f"ici: after the unpin ICI_TRANSFER "
                                 f"answered {miss}, {fallbacks} fallbacks")
    finally:
        for w in reversed(workers):
            w.stop()
        stop_master(proc)

    med = {k: statistics.median(v) for k, v in split.items()}
    xfer = statistics.median(rpc_s)
    res.update(
        block_id=bid, reps=ICI_REPS, k1_launches=k1,
        transfer_s=rpc_s, transfer_median_s=xfer,
        transfer_gibs=BLOCK / GiB / xfer,
        split_ms={k: [x * 1e3 for x in v] for k, v in split.items()},
        split_median_ms={k: v * 1e3 for k, v in med.items()},
        split_gibs={k: BLOCK / GiB / v for k, v in med.items()
                    if k in ("fetch", "d2h", "crc32c", "write")},
        read_block_s=[t for t, _ in rb],
        read_block_gibs=BLOCK / GiB / rb[0][0],
        read_block_again_gibs=BLOCK / GiB / rb[1][0],
        crc=[a_info.crc_algo, a_info.crc32c], peer_pulls=pulls,
        miss=miss, tcp_fallbacks=fallbacks)
    sm = res["split_median_ms"]
    log(f"ici: a {BLOCK // MiB} MiB block written to worker A "
        f"({wa.worker_id}, ICI "
        f"(0, 0)) and pinned by its promote cycle ({k1} K1 launch); "
        f"READ_BLOCK from A {rb[0][0]:.3f}s ({res['read_block_gibs']:.3f} "
        f"GiB/s), again {rb[1][0]:.3f}s "
        f"({res['read_block_again_gibs']:.3f} GiB/s)")
    log(f"ici: ICI_TRANSFER to worker B ({wb.worker_id}, ICI (1, 0)), "
        f"{ICI_REPS} times: median {xfer * 1e3:.2f} ms "
        f"({res['transfer_gibs']:.3f} GiB/s; a copy within one card, not "
        f"between cards), split median ms: fetch {sm['fetch']:.3f}, D2H "
        f"{sm['d2h']:.2f}, crc32c {sm['crc32c']:.2f}, write "
        f"{sm['write']:.2f}, commit {sm['commit']:.3f}, report "
        f"{sm['report']:.3f}; B's block bit-equal, its commit crc A's "
        f"({a_info.crc_algo} {a_info.crc32c:#010x}), located on both")
    log(f"ici: after A's HBM_UNPIN, ICI_TRANSFER answered {miss} "
        f"(ici.tcp_fallbacks +{fallbacks})")

    # bench.py's rail A/B on a (1,) NCCL mesh of this process: with one
    # rank, each chunk is a host-to-device copy, not a fan-out
    payload = rng.integers(0, 256, ICI_PAYLOAD, dtype=np.uint8)
    want = torch.from_numpy(payload).to(dev)
    multihost.initialize()
    try:
        mesh = make_mesh(axis_names=("x",))
        if mesh.device_type != "cuda" or tuple(mesh.shape) != (1,):
            raise AssertionError(f"ici: mesh {mesh}")

        def best(rail) -> tuple[float, object]:
            times, out = [], None
            for i in range(ICI_ROUNDS + ICI_WARMUPS):
                out = None
                t = time.perf_counter()
                out = rail(payload, mesh)
                if i >= ICI_WARMUPS:
                    times.append(time.perf_counter() - t)
            return min(times), out

        counters = {}
        pipe_s, rb_out = best(lambda d, m: ici_plane.broadcast_bytes(
            d, m, counters=counters))
        flat_s, flat_out = best(ici_plane.flat_replicate)
        got = torch.cat([c.to_local() for c in rb_out.chunks])
        if not torch.equal(got, want) or \
                not torch.equal(flat_out.to_local(), want) or \
                got.device != dev:
            raise AssertionError("ici: a rail's bytes differ on the card")
        n_chunks = len(rb_out.chunks)
        del got, rb_out, flat_out, want
    finally:
        multihost.shutdown()
    agg = ICI_PAYLOAD / GiB     # x 1 rank
    res.update(ckpt_broadcast_gibs=agg / pipe_s,
               ckpt_broadcast_flat_gibs=agg / flat_s,
               ckpt_broadcast_speedup=flat_s / pipe_s,
               broadcast_chunks=n_chunks, broadcast_counters=counters)
    log(f"ici: {ICI_PAYLOAD // MiB} MiB over a (1,) NCCL mesh, best of "
        f"{ICI_ROUNDS} after "
        f"{ICI_WARMUPS} warm-ups: broadcast_bytes ({n_chunks} chunks of 8 "
        f"MiB) ckpt_broadcast_gibs {res['ckpt_broadcast_gibs']:.3f}, "
        f"flat_replicate {res['ckpt_broadcast_flat_gibs']:.3f} (speedup "
        f"{res['ckpt_broadcast_speedup']:.2f}); one rank: the chunked "
        f"host-to-device path, not a fan-out; bit-exact on the card")
    return res


def _block_locs(master: str, path: str) -> list[tuple[int, list[int]]]:
    """Each block of ``path`` and the workers the master locates it on,
    in the master's order."""
    async def run():
        async with port_client(master) as c:
            fb = await c.meta.get_block_locations(path)
            return [(lb.block.id, [x.worker_id for x in lb.locs])
                    for lb in fb.block_locs]
    return asyncio.run(run())


def _poll(pred, timeout: float, what: str, step: float = 0.02,
          phase: str = "replicate") -> float:
    """Seconds until ``pred()`` holds; raises after ``timeout``."""
    t = time.perf_counter()
    while not pred():
        if time.perf_counter() - t > timeout:
            raise AssertionError(f"{phase}: never {what} in {timeout}s")
        time.sleep(step)
    return time.perf_counter() - t


def phase_replicate(rng: np.random.Generator, dev: torch.device, root: str
                    ) -> dict:
    """Blocks kept at their replica count, on one card: a master of the
    phase's own (``block_placement_policy = "ici"``, a lost timeout of
    REP_LOST_MS) and three of the port's workers in this process, A, B
    and C at ICI (0, 0), (1, 0) and (2, 0), each with a tier-0 on the
    card. (a) ``/rep/hot`` and ``/rep/cold``, REP_BLOCKS blocks each,
    written with two replicas through the port's client (placed from
    (0, 0): on A, then the farthest, C), every replica's block file
    equal to the bytes and ``/rep/hot`` read back through the client.
    (b) A's promote cycle pins ``/rep/hot`` (one K1 launch a pin) and a
    heartbeat advertises the pins; a byte of one block's media copy on C
    is flipped and C's promote cycle refuses the block and reports it;
    the master evacuates it: B lands it from A's tier-0 by the ICI hint
    (one peer pull, no fallback, no READ_BLOCK byte from A), the copy
    on C is retired and deleted within two heartbeats after, and B's
    file equals the block. (c)
    ``/rep/hot`` deleted, C stopped: the master marks it lost and B
    pulls each of ``/rep/cold``'s blocks from A by READ_BLOCK (no hint:
    A pinned none of them); every block back on two live workers and the
    file bit for bit. The master's ``replication.*`` counters come from
    its ``--metrics-out`` file, written when it stops."""
    from curvine_tpu_torch.gpu import cuda_ops, ici_plane
    from curvine_tpu_torch.rpc.codes import RpcCode
    from curvine_tpu_torch.worker import server
    base = os.path.join(root, "replicate")
    os.makedirs(base)
    conf = master_conf(base, lost_ms=REP_LOST_MS, policy="ici")
    proc, info = start_master(base, conf)
    master = info["addr"]
    workers = {}
    res = {"master_start_s": info["start_s"], "lost_timeout_ms": REP_LOST_MS}
    hot = rng.integers(0, 1 << 64, REP_BLOCKS * BLOCK // 8, dtype=np.uint64)
    cold = rng.integers(0, 1 << 64, REP_BLOCKS * BLOCK // 8, dtype=np.uint64)
    try:
        for name, coords in (("a", (0, 0)), ("b", (1, 0)), ("c", (2, 0))):
            workers[name] = PortWorker(master, os.path.join(base, name),
                                       REP_TIER_BYTES, dev, coords=coords)
        a, b, cw = workers["a"], workers["b"], workers["c"]
        wa, wb, wc = a.worker, b.worker, cw.worker
        await_live(master, [wa.worker_id, wb.worker_id, wc.worker_id],
                   phase="replicate")

        # (a) the replicated write
        async def write():
            async with port_client(master, coords=(0, 0)) as c:
                t = time.perf_counter()
                await c.write_all("/rep/hot", hot, replicas=2)
                await c.write_all("/rep/cold", cold, replicas=2)
                secs = time.perf_counter() - t
                back = np.frombuffer(await c.read_all("/rep/hot"),
                                     dtype=np.uint64)
                return secs, dict(c.counters), np.array_equal(back, hot)

        write_s, wrote, hot_ok = asyncio.run(write())
        placed = {p: _block_locs(master, p) for p in ("/rep/hot",
                                                      "/rep/cold")}
        want = [wa.worker_id, wc.worker_id]
        # every replica's block file against the file's bytes: a read
        # through the client would heat /rep/cold on A before its pins
        step = BLOCK // 8
        replicas_ok = all(
            np.array_equal(np.fromfile(w.store.get(bid, touch=False).path,
                                       dtype=np.uint64),
                           data[i * step:(i + 1) * step])
            for p, data in (("/rep/hot", hot), ("/rep/cold", cold))
            for i, (bid, _) in enumerate(placed[p]) for w in (wa, wc))
        # the master lists a block's holders in the order it learned of
        # them (the commit, or a holder's report before it): a set
        if any(sorted(ids) != sorted(want) for locs in placed.values()
               for _, ids in locs) \
                or any(len(locs) != REP_BLOCKS for locs in placed.values()) \
                or not hot_ok or not replicas_ok \
                or wrote.get("sc.bytes.written", 0):
            raise AssertionError(f"replicate: the write placed {placed} "
                                 f"(want every block on {want}), /rep/hot "
                                 f"read back {hot_ok}, every replica's "
                                 f"block file equal {replicas_ok}, "
                                 f"counters {wrote}")
        res.update(write_s=write_s,
                   write_gibs=2 * REP_BLOCKS * BLOCK / GiB / write_s)
        log(f"replicate: /rep/hot and /rep/cold, {REP_BLOCKS} blocks of "
            f"{BLOCK // MiB} MiB each, written with two replicas in "
            f"{write_s:.3f}s ({res['write_gibs']:.3f} GiB/s of file bytes, "
            f"each byte to two workers over WRITE_BLOCK); every block on "
            f"A ({wa.worker_id}, ICI (0, 0)) and C ({wc.worker_id}, (2, 0)),"
            f" as the ici policy places from (0, 0); /rep/hot read back and "
            f"every replica's block file bit-equal")

        # (b) a corrupt replica healed over the device path
        cuda_ops.block_checksum.launches = 0
        a.call(wa._promote_once())
        k1 = cuda_ops.block_checksum.launches
        hot_ids = [bid for bid, _ in placed["/rep/hot"]]
        if k1 != REP_BLOCKS or not all(wa.hbm_holds(x) for x in hot_ids):
            raise AssertionError(f"replicate: A's promote cycle pinned "
                                 f"{[wa.hbm_holds(x) for x in hot_ids]} "
                                 f"with {k1} K1 launches")
        a.call(wa.heartbeat_once())
        bid = hot_ids[0]
        c_path = wc.store.get(bid, touch=False).path
        with open(c_path, "r+b") as f:
            f.seek(BLOCK // 2)
            byte = f.read(1)
            f.seek(BLOCK // 2)
            f.write(bytes([byte[0] ^ 0x20]))
        read_a = wa.metrics.counters.get("bytes.read", 0)
        split = {k: [] for k in ("fetch", "d2h", "crc32c", "write")}
        real = {"fetch": (ici_plane, "fetch_device_block"),
                "d2h": (server, "_to_host"), "crc32c": (server, "crc_update"),
                "write": (server, "_write_file")}
        saved = {k: getattr(o, n) for k, (o, n) in real.items()}
        land = []

        def timed_async(fn, into):
            async def timed(*args, **kw):
                t = time.perf_counter()
                try:
                    return await fn(*args, **kw)
                finally:
                    into.append(time.perf_counter() - t)
            return timed

        for k, (o, n) in real.items():
            setattr(o, n, _timed(saved[k], split[k]))
        wb._ici_land = timed_async(wb._ici_land, land)
        try:
            t0 = time.perf_counter()
            refused = cw.call(wc._autopin_block(bid))
            reported_s = time.perf_counter() - t0

            def located(want: list[int]):
                return lambda: sorted(dict(_block_locs(
                    master, "/rep/hot"))[bid]) == sorted(want)
            # healed: B's copy located beside A's (C's flagged one still
            # listed); retired: C's dropped, which the master does at the
            # dispatch after the landing, its next scan
            heal_s = reported_s + _poll(
                located([wa.worker_id, wb.worker_id, wc.worker_id]), 30,
                "healed /rep/hot")
            retire_s = heal_s + _poll(located([wa.worker_id, wb.worker_id]),
                                      30, "retired C's copy")
            gone_s = retire_s + _poll(lambda: not wc.store.contains(bid),
                                      30, "deleted C's corrupt copy")
        finally:
            for k, (o, n) in real.items():
                setattr(o, n, saved[k])
            del wb._ici_land
        landed = np.fromfile(wb.store.get(bid, touch=False).path,
                             dtype=np.uint64)
        pulls = wb.metrics.counters.get("ici.peer_pulls", 0)
        fallbacks = wb.metrics.counters.get("ici.tcp_fallbacks", 0)
        read_a_delta = wa.metrics.counters.get("bytes.read", 0) - read_a

        async def read_hot():
            async with port_client(master) as c:
                return np.frombuffer(await c.read_all("/rep/hot"),
                                     dtype=np.uint64)

        # the retired copy goes at C's next heartbeat after the retire
        late = gone_s - retire_s > 2 * WORKER_HEARTBEAT_MS / 1000
        if refused != 0 or wc.metrics.counters.get("blocks.corrupt") != 1 \
                or late \
                or wc.metrics.counters.get("blocks.corrupt_reported") != 1 \
                or pulls != 1 or fallbacks != 0 or read_a_delta \
                or len(land) != 1 \
                or not np.array_equal(landed, hot[:BLOCK // 8]) \
                or not np.array_equal(asyncio.run(read_hot()), hot):
            raise AssertionError(
                f"replicate (b): refused {refused}, C's counters "
                f"{wc.metrics.counters}, B's peer pulls {pulls} and "
                f"fallbacks {fallbacks}, {read_a_delta} bytes read from A, "
                f"C's copy deleted {gone_s - retire_s:.3f}s after its retire "
                f"(two heartbeats allowed), {len(land)} landings, B's block "
                f"equal "
                f"{np.array_equal(landed, hot[:BLOCK // 8])}")
        med = {k: statistics.median(v) for k, v in split.items()}
        res["device"] = dict(
            block_id=bid, k1_launches=k1, reported_s=reported_s,
            healed_s=heal_s, retired_s=retire_s, corrupt_deleted_s=gone_s,
            land_s=land[0],
            land_gibs=BLOCK / GiB / land[0], peer_pulls=pulls,
            tcp_fallbacks=fallbacks, a_bytes_read=read_a_delta,
            split_ms={k: v * 1e3 for k, v in med.items()},
            split_gibs={k: BLOCK / GiB / v for k, v in med.items()})
        d = res["device"]
        sm = d["split_ms"]
        log(f"replicate (b): A pinned /rep/hot ({k1} K1 launches); C "
            f"refused block {bid} (a flipped byte of its media copy) and "
            f"reported it in {reported_s:.3f}s; the master evacuated it: B "
            f"landed it from A's tier-0 by the ICI hint in "
            f"{land[0] * 1e3:.2f} ms ({d['land_gibs']:.3f} GiB/s; fetch "
            f"{sm['fetch']:.3f}, D2H {sm['d2h']:.2f}, crc32c "
            f"{sm['crc32c']:.2f}, write {sm['write']:.2f} ms), {pulls} peer "
            f"pull, {fallbacks} fallbacks, {read_a_delta} bytes read from "
            f"A; healed {heal_s:.3f}s after the start of C's promote "
            f"cycle, C's copy retired at {retire_s:.3f}s (the master's "
            f"next scan) and deleted at {gone_s:.3f}s; B's block and "
            f"/rep/hot bit-equal")

        # (c) a lost holder healed by TCP
        async def delete_hot():
            async with port_client(master) as c:
                await c.meta.delete("/rep/hot")
        asyncio.run(delete_hot())
        _poll(lambda: not any(w.worker.store.contains(x)
                              for w in workers.values() for x in hot_ids),
              30, "deleted /rep/hot", step=0.05)
        split = {k: [] for k in ("pull", "crc32c", "write")}
        real = {"crc32c": (server, "crc_update"),
                "write": (server, "_append")}
        saved = {k: getattr(o, n) for k, (o, n) in real.items()}
        for k, (o, n) in real.items():
            setattr(o, n, _timed(saved[k], split[k]))
        wb._tcp_pull = timed_async(wb._tcp_pull, split["pull"])
        before = {k: wb.metrics.counters.get(k, 0)
                  for k in ("ici.peer_pulls", "ici.tcp_fallbacks")}
        read_a = wa.metrics.counters.get("bytes.read", 0)
        cold_ids = [x for x, _ in placed["/rep/cold"]]
        try:
            t0 = time.perf_counter()
            cw.stop()
            del workers["c"]

            def lost() -> bool:
                async def run():
                    async with port_client(master) as c:
                        return await live_workers(c)
                return wc.worker_id not in [
                    w["address"]["worker_id"] for w in asyncio.run(run())]
            lost_s = _poll(lost, 30, "marked C lost", step=0.05)

            def cold_healed() -> bool:
                return all(sorted(ids) == sorted([wa.worker_id, wb.worker_id])
                           for _, ids in _block_locs(master, "/rep/cold"))
            heal_s = lost_s + _poll(cold_healed, 60, "healed /rep/cold")
        finally:
            for k, (o, n) in real.items():
                setattr(o, n, saved[k])
            del wb._tcp_pull

        async def read_cold():
            async with port_client(master) as c:
                return np.frombuffer(await c.read_all("/rep/cold"),
                                     dtype=np.uint64)

        after = {k: wb.metrics.counters.get(k, 0) for k in before}
        streamed = wa.metrics.counters.get("bytes.read", 0) - read_a
        if after != before or len(split["pull"]) != REP_BLOCKS \
                or streamed < REP_BLOCKS * BLOCK \
                or not np.array_equal(asyncio.run(read_cold()), cold) \
                or not all(wb.store.contains(x) for x in cold_ids):
            raise AssertionError(
                f"replicate (c): B's counters {before} -> {after}, "
                f"{len(split['pull'])} pulls, {streamed} bytes streamed "
                f"from A")
        crc_s = sum(split["crc32c"])
        write_s = sum(split["write"])
        pull_s = sum(split["pull"])
        res["tcp"] = dict(
            blocks=REP_BLOCKS, lost_s=lost_s, healed_s=heal_s,
            pull_s=split["pull"], pull_gibs=REP_BLOCKS * BLOCK / GiB / pull_s,
            stream_ms=(pull_s - crc_s - write_s) * 1e3 / REP_BLOCKS,
            crc32c_ms=crc_s * 1e3 / REP_BLOCKS,
            write_ms=write_s * 1e3 / REP_BLOCKS, a_bytes_read=streamed)
        tc = res["tcp"]
        log(f"replicate (c): C stopped; the master marked it lost after "
            f"{lost_s:.3f}s (lost timeout {REP_LOST_MS} ms) and B pulled "
            f"/rep/cold's {REP_BLOCKS} blocks from A by READ_BLOCK, no "
            f"hint: {tc['pull_gibs']:.3f} GiB/s over the pulls (a block: "
            f"stream {tc['stream_ms']:.2f}, crc32c {tc['crc32c_ms']:.2f}, "
            f"write {tc['write_ms']:.2f} ms); healed {heal_s:.3f}s after "
            f"the stop; /rep/cold bit-equal on A and B")
    finally:
        for w in reversed(list(workers.values())):
            w.stop()
        stop_master(proc)
    with open(os.path.join(base, "master0.json")) as f:
        counters = json.load(f)["counters"]
    rep = {k[len("replication."):]: v for k, v in counters.items()
           if k.startswith("replication.")}
    res["master_counters"] = rep
    log(f"replicate: the master's counters {rep}")
    if (rep.get("ici_hinted"), rep.get("ici_transfers"),
            rep.get("evacuates"), rep.get("replicates")) != \
            (1, 1, 1, REP_BLOCKS):
        raise AssertionError(f"replicate: the master counted {rep}: one "
                             f"hinted pull, one over the device path, one "
                             f"evacuation, {REP_BLOCKS} replicates wanted")
    res["k1_launches"] = k1
    return res


# ---------------------------------------------------------------- drain

def phase_drain(dev: torch.device, root: str, seed: int, params: dict, step,
                client_res: dict) -> dict:
    """A worker decommissioned under a running feed, on one card: a master
    of the phase's own (``ici`` placement, REP_LOST_MS) and three of the
    port's workers in this process, A, B and C at ICI (0, 0), (1, 0) and
    (2, 0), each with a mem tier and a tier-0 on the card. (a) SHARDS
    token shards of 64 MiB (ids below the flagship's vocab, from
    ``seed``) written to ``/drain/train`` at two replicas from (0, 0):
    every block on A and C. (b) ``GpuTrainFeed`` over it at phase feed's
    batch, epoch after epoch; after DRAIN_DECO_AFTER batches A is
    decommissioned (DECOMMISSIONING). While A drains, every batch must
    equal its tokens and no read may raise; once A has the master's
    ``draining`` flag a WRITE_BLOCK to it is refused with
    ``WorkerDraining``, and a small file written at two replicas lands on
    B and C. The feed runs one more epoch after A is DECOMMISSIONED
    (within DRAIN_LIMIT_S); then every block is on B and C, the master
    names A for none, and a full block report from A brings none back;
    the drain's seconds and GiB/s, the pulls that took the ``ici`` hint
    and those by TCP, the feed's batches/s against phase client's. (c)
    The moved blocks read from B (the reading client's board holds C's
    breaker open, so its reads and its short circuit go to B first) up to
    WORKER_MIN_READS and pinned by B's promote cycles, K1 verifying each
    pin (launches equal to the pins), each device copy equal to its
    tokens; three flagship steps (phase ufs's parameters and step) on
    batches fed from ``/drain/train``: each batch equal to its tokens,
    finite losses, K3's four kernels once a layer a step. (d) A
    recommissioned (LIVE), a new file at two replicas placed on A again;
    A decommissioned again and the master restarted on the phase's
    journal: A DECOMMISSIONING there, and told to drain. The phase's
    files are deleted, its workers and master stopped and its directory
    removed, however it ends."""
    from curvine_tpu_torch.common import errors as cerr
    from curvine_tpu_torch.common.types import StorageType, WorkerState
    from curvine_tpu_torch.gpu import cuda_ops, flash
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_token_shards
    from curvine_tpu_torch.rpc.client import Connection
    from curvine_tpu_torch.rpc.codes import RpcCode
    base = os.path.join(root, "drain")
    os.makedirs(base)
    res = {"lost_timeout_ms": REP_LOST_MS}
    workers: dict[str, PortWorker] = {}
    proc = None
    master = None
    DECO, DONE, LIVE = (int(WorkerState.DECOMMISSIONING),
                        int(WorkerState.DECOMMISSIONED),
                        int(WorkerState.LIVE))
    tokens = ufs_tokens(seed, SHARDS, 0x6472616e)
    shard_tokens = SHARD_BYTES // 4
    small = np.random.default_rng(seed + 7).integers(
        0, 256, DRAIN_SMALL_BYTES, dtype=np.uint8)
    kernels = [getattr(flash, nm) for nm in K3_NAMES]
    cfg = _flagship()
    pulls = {"tcp": [], "ici": 0}

    def states(info) -> dict[int, int]:
        return {w.address.worker_id: int(w.state)
                for w in info.live_workers + info.lost_workers}

    try:
        conf = master_conf(base, lost_ms=REP_LOST_MS, policy="ici")
        proc, info = start_master(base, conf)
        master = info["addr"]
        master_conf(base, int(master.rsplit(":", 1)[1]), lost_ms=REP_LOST_MS,
                    policy="ici")
        res["master_start_s"] = info["start_s"]
        for i, name in enumerate("abc"):
            workers[name] = PortWorker(
                master, os.path.join(base, name), DRAIN_TIER_BYTES, dev,
                coords=(i, 0), hbm_bytes=DRAIN_HBM_BYTES)
        wa, wb, wc = (workers[n].worker for n in "abc")
        A, B, C = wa.worker_id, wb.worker_id, wc.worker_id
        await_live(master, [A, B, C], phase="drain")

        # (a) phase feed's shape at two replicas, from (0, 0)
        async def write():
            async with port_client(master, coords=(0, 0), replicas=2) as c:
                t = time.perf_counter()
                paths = await write_token_shards(c, "/drain/train", tokens,
                                                 shard_tokens)
                return paths, time.perf_counter() - t, dict(c.counters)

        paths, write_s, wrote = asyncio.run(write())
        placed = {p: _block_locs(master, p) for p in paths}
        if len(paths) != SHARDS or any(
                len(locs) != 1 or sorted(locs[0][1]) != sorted([A, C])
                for locs in placed.values()):
            raise AssertionError(f"drain (a): {len(paths)} shards placed "
                                 f"{placed}, not each one block on A and C")
        moved = {p: locs[0][0] for p, locs in placed.items()}
        res["a"] = dict(bytes=tokens.nbytes, write_s=write_s,
                        write_gibs=tokens.nbytes / GiB / write_s,
                        write_bytes=wrote.get("write.bytes", 0))
        log(f"drain (a): /drain/train, {SHARDS} shards of "
            f"{SHARD_BYTES // MiB} MiB of tokens, written at two replicas "
            f"from (0, 0) in {write_s:.3f}s ({res['a']['write_gibs']:.3f} "
            f"GiB/s of file bytes); every block on A ({A}) and C ({C})")

        # (b) A decommissioned under a running feed; B's pulls counted
        real_pull = wb._tcp_pull
        real_land = wb._try_ici_land

        async def tcp_pull(*a, **kw):
            t = time.perf_counter()
            await real_pull(*a, **kw)
            pulls["tcp"].append(time.perf_counter() - t)

        async def ici_land(*a, **kw):
            landed = await real_land(*a, **kw)
            pulls["ici"] += bool(landed)
            return landed

        wb._tcp_pull, wb._try_ici_land = tcp_pull, ici_land
        expect = torch.from_numpy(tokens).to(dev)
        per_batch = BATCH * SEQ
        n_epoch = tokens.size // per_batch

        async def drain():
            async with port_client(master, coords=(0, 0)) as c:
                ev, side = {}, {}

                async def watch():
                    while True:
                        st = states(await c.meta.master_info())
                        if st.get(A) == DONE:
                            ev["flip"] = time.perf_counter()
                            return
                        await asyncio.sleep(0.05)

                async def refusals():
                    t = time.perf_counter()
                    while not wa.draining:
                        if time.perf_counter() - t > 10:
                            raise AssertionError("drain (b): A never had "
                                                 "the draining flag")
                        await asyncio.sleep(0.02)
                    side["flag_s"] = time.perf_counter() - ev["deco"]
                    # a connection of its own: a refused upload leaves
                    # none of the feed's pooled ones mid-stream
                    conn = await Connection(wa.addr).connect()
                    try:
                        up = await conn.open_upload(
                            RpcCode.WRITE_BLOCK, header={
                                "block_id": 987_654_321,
                                "storage_type": int(StorageType.MEM),
                                "algo": "crc32c", "len_hint": BLOCK})
                        await up.finish(header={"crc32": 0,
                                                "algo": "crc32c"})
                        side["refused"] = None
                    except cerr.WorkerDraining as e:
                        side["refused"] = type(e).__name__
                    finally:
                        await conn.close()
                    await c.write_all("/drain/small", small, replicas=2)
                    fb = await c.meta.get_block_locations("/drain/small")
                    side["small_on"] = sorted(
                        {x.worker_id for lb in fb.block_locs
                         for x in lb.locs})
                    side["small_done"] = "flip" not in ev

                epochs, tasks = [], []
                while True:
                    after = "flip" in ev
                    f = GpuTrainFeed(c, "/drain/train", BATCH, SEQ,
                                     device=dev)
                    bad = torch.zeros((), dtype=torch.int64, device=dev)
                    n = 0
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    async for b in f:
                        ref = expect[n * per_batch:(n + 1) * per_batch]
                        bad += (b != ref.view(BATCH, SEQ)).sum()
                        n += 1
                        if not epochs and n == DRAIN_DECO_AFTER:
                            ev["deco"] = time.perf_counter()
                            ev["deco_state"] = \
                                await c.meta.decommission_worker(A)
                            tasks = [asyncio.ensure_future(watch()),
                                     asyncio.ensure_future(refusals())]
                    torch.cuda.synchronize()
                    epochs.append(dict(batches=n, bad=int(bad), start=t,
                                       s=time.perf_counter() - t,
                                       after_flip=after))
                    if after or time.perf_counter() - ev["deco"] \
                            > DRAIN_LIMIT_S:
                        break
                for x in tasks:
                    if not x.done():
                        x.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                for x in tasks:
                    if not x.cancelled() and x.exception() is not None:
                        raise x.exception()
                return ev, side, epochs, dict(c.counters)

        try:
            ev, side, epochs, fed = asyncio.run(drain())
        finally:
            wb._tcp_pull, wb._try_ici_land = real_pull, real_land
        del expect
        if "flip" not in ev:
            raise AssertionError(f"drain (b): A not DECOMMISSIONED within "
                                 f"{DRAIN_LIMIT_S}s of its decommission")
        drain_s = ev["flip"] - ev["deco"]
        during = [e for e in epochs if e["start"] < ev["flip"]]
        batches = sum(e["batches"] for e in during)
        secs = sum(e["s"] for e in during)
        locs = {p: _block_locs(master, p) for p in paths}
        workers["a"].call(wa.block_report_once())
        after_report = {p: _block_locs(master, p) for p in paths}
        bc = sorted([B, C])
        if ev["deco_state"] != DECO or any(
                e["batches"] != n_epoch or e["bad"] for e in epochs) \
                or not epochs[-1]["after_flip"] \
                or side.get("refused") != "WorkerDraining" \
                or side.get("small_on") != bc or not side["small_done"] \
                or any(sorted(x[0][1]) != bc for x in locs.values()) \
                or after_report != locs or len(pulls["tcp"]) \
                + pulls["ici"] != SHARDS:
            raise AssertionError(
                f"drain (b): decommission answered {ev['deco_state']}, "
                f"epochs {epochs} ({n_epoch} batches each), side checks "
                f"{side}, blocks after the flip {locs}, after A's report "
                f"{after_report}, pulls {pulls}")
        res["b"] = dict(
            deco_state=ev["deco_state"], drain_s=drain_s,
            drain_gibs=SHARDS * SHARD_BYTES / GiB / drain_s,
            flag_s=side["flag_s"], small_on=side["small_on"],
            small_during_drain=side["small_done"],
            epochs=len(epochs), epochs_during=len(during),
            batches_per_s=batches / secs,
            gibs=batches * per_batch * 4 / GiB / secs,
            client_batches_per_s=client_res["batches_per_s"],
            sc_bytes=fed.get("sc.bytes.read", 0),
            read_block_bytes=fed.get("read.zero_copy_bytes", 0),
            tcp_pulls=len(pulls["tcp"]), ici_pulls=pulls["ici"],
            tcp_pull_s=pulls["tcp"],
            tcp_pull_gibs=(len(pulls["tcp"]) * SHARD_BYTES / GiB
                           / sum(pulls["tcp"])) if pulls["tcp"] else None)
        rb = res["b"]
        log(f"drain (b): GpuTrainFeed over /drain/train, {len(epochs)} "
            f"epochs of {n_epoch} batches, every batch equal to its tokens; "
            f"A decommissioned after {DRAIN_DECO_AFTER} batches "
            f"(DECOMMISSIONING), had the draining flag "
            f"{rb['flag_s']:.3f}s later and refused a WRITE_BLOCK "
            f"({side['refused']}); /drain/small, written meanwhile at two "
            f"replicas, on {rb['small_on']} (B, C); A DECOMMISSIONED "
            f"{drain_s:.3f}s after its decommission "
            f"({rb['drain_gibs']:.3f} GiB/s of drained replicas); B pulled "
            f"{rb['tcp_pulls']} blocks by TCP and {rb['ici_pulls']} by the "
            f"ici hint"
            + (f" ({rb['tcp_pull_gibs']:.3f} GiB/s over the pulls)"
               if rb["tcp_pull_gibs"] else "")
            + f"; the feed during the drain {rb['batches_per_s']:.1f} "
            f"batches/s against phase client's "
            f"{rb['client_batches_per_s']:.1f}; one more epoch after the "
            f"flip; every block on B and C, none on A, and A's full block "
            f"report brought none back")

        # (c) the moved blocks pinned by B (K1), then three flagship steps
        pins0 = wb.metrics.counters.get("blocks.hbm_pinned", 0)

        async def heat(todo):
            async with port_client(master) as c:
                for _ in range(c.conf.client.breaker_fail_threshold):
                    c.health.fail(wc.addr, worker_id=C)
                for p in todo:
                    r = await c.open(p)
                    try:
                        await r.read_all()
                    finally:
                        await r.close()
                return dict(c.counters)

        cuda_ops.block_checksum.launches = 0
        cycles = 0
        heated = {}
        while not all(wb.hbm_holds(b) for b in moved.values()) \
                and cycles < 6:
            todo = [p for p, b in moved.items() if not wb.hbm_holds(b)]
            got = asyncio.run(heat(todo))
            for k, v in got.items():
                heated[k] = heated.get(k, 0) + v
            workers["b"].call(wb._promote_once())
            cycles += 1
        k1 = cuda_ops.block_checksum.launches
        pins = wb.metrics.counters.get("blocks.hbm_pinned", 0) - pins0
        missing = [b for b in moved.values() if not wb.hbm_holds(b)]
        if missing or k1 != pins or pins != SHARDS \
                or heated.get("read.zero_copy_bytes", 0):
            raise AssertionError(f"drain (c): {cycles} promote cycles on B, "
                                 f"{pins} pins, {k1} K1 launches, blocks not "
                                 f"pinned {missing}, heat reads {heated}")
        for i, p in enumerate(paths):
            got = wb.hbm_get(moved[p]).reshape(-1).view(torch.int32)
            ref = torch.from_numpy(
                tokens[i * shard_tokens:(i + 1) * shard_tokens]).to(dev)
            if not torch.equal(got, ref):
                raise AssertionError(f"drain (c): {p}'s device copy on B "
                                     f"differs from its tokens")
        del got, ref
        first = tokens[:TRAIN_BATCH * TRAIN_SEQ * UFS_STEPS].reshape(
            UFS_STEPS, TRAIN_BATCH, TRAIN_SEQ)
        seen = []

        def check(b):
            seen.append(bool(torch.equal(b, torch.from_numpy(
                first[len(seen)]).to(dev))))

        async def train_steps():
            async with port_client(master) as c:
                f = GpuTrainFeed(c, "/drain/train", TRAIN_BATCH, TRAIN_SEQ,
                                 depth=2, device=dev)

                async def take():
                    for _ in range(UFS_STEPS):
                        yield await anext(f.prefetcher)

                try:
                    return await timed_steps(step, params, take(), check)
                finally:
                    await f.prefetcher.aclose()

        for fn in kernels:
            fn.launches = 0
        step_s, losses = asyncio.run(train_steps())
        launches = {fn.__name__: fn.launches for fn in kernels}
        if seen != [True] * UFS_STEPS or not all(map(math.isfinite, losses)) \
                or set(launches.values()) != {cfg.n_layers * UFS_STEPS}:
            raise AssertionError(f"drain (c): batches equal to their tokens "
                                 f"{seen}, losses {losses}, K3 launches "
                                 f"{launches}")
        res["c"] = dict(pins=pins, k1_launches=k1, cycles=cycles,
                        heat_sc_bytes=heated.get("sc.bytes.read", 0),
                        losses=losses, step_ms=[x * 1e3 for x in step_s],
                        launches=launches)
        log(f"drain (c): the {SHARDS} moved blocks read from B (C's "
            f"breaker held open in the reading client: "
            f"{res['c']['heat_sc_bytes']:,} bytes by short circuit from B, "
            f"none by READ_BLOCK) and pinned by B's promote cycles "
            f"({cycles}): {pins} pins, {k1} K1 launches, each device copy "
            f"equal to its tokens; {UFS_STEPS} flagship steps (phase ufs's "
            f"parameters and AdamW) at {TRAIN_BATCH}x{TRAIN_SEQ} on "
            f"batches fed from B and C, each equal to its tokens: losses "
            f"{[round(x, 4) for x in losses]}, step ms "
            f"{[round(x * 1e3, 2) for x in step_s]}; K3 launches "
            f"{launches}")

        # (d) A back to LIVE; the intent across a master restart
        async def recommission():
            async with port_client(master, coords=(0, 0)) as c:
                st = await c.meta.decommission_worker(A, on=False)
                t = time.perf_counter()
                while wa.draining and time.perf_counter() - t < 10:
                    await asyncio.sleep(0.02)
                await c.write_all("/drain/back", small, replicas=2)
                fb = await c.meta.get_block_locations("/drain/back")
                back_on = sorted({x.worker_id for lb in fb.block_locs
                                  for x in lb.locs})
                again = await c.meta.decommission_worker(A)
                return st, back_on, again

        st, back_on, again = asyncio.run(recommission())
        stop_master(proc)
        with open(os.path.join(base, "master0.json")) as f:
            counters = json.load(f)["counters"]
        res["master_counters"] = {
            k[len("replication."):]: v for k, v in counters.items()
            if k.startswith("replication.")}
        proc, info = start_master(base, conf, 1)

        def listed():
            async def run():
                async with port_client(master) as c:
                    return states(await c.meta.master_info())
            return asyncio.run(run())

        _poll(lambda: set(listed()) == {A, B, C}, 30,
              "listed A, B and C after the restart", 0.1, "drain")
        after = listed()
        _poll(lambda: wa.draining, 10, "told A to drain after the restart",
              0.05, "drain")
        if st != LIVE or back_on != sorted([A, C]) or again != DECO \
                or after != {A: DECO, B: LIVE, C: LIVE}:
            raise AssertionError(f"drain (d): recommission answered {st}, "
                                 f"/drain/back on {back_on}, decommission "
                                 f"again {again}, states after the restart "
                                 f"{after}")
        res["d"] = dict(recommission_state=st, back_on=back_on,
                        restart_s=info["start_s"], after_restart=after)
        log(f"drain (d): A recommissioned (LIVE); /drain/back at two "
            f"replicas placed on A and C again; A decommissioned again and "
            f"the master restarted on the phase's journal in "
            f"{info['start_s']:.3f}s: A DECOMMISSIONING there, and told to "
            f"drain; the first master's replication counters "
            f"{res['master_counters']}")
    finally:
        try:
            if proc is not None and proc.poll() is None:
                async def delete():
                    async with port_client(master) as c:
                        await c.meta.delete("/drain", recursive=True)
                asyncio.run(delete())
        except Exception as e:  # noqa: BLE001 — the directory goes anyway
            log(f"drain: deleting /drain failed: {e}")
        for name in list(workers):
            workers.pop(name).stop()
        if proc is not None:
            stop_master(proc)
        shutil.rmtree(base, ignore_errors=True)
    res["k1_launches"] = k1
    res["launches"] = launches
    return res


def _ec_codec_times(tokens: np.ndarray) -> dict:
    """The port's codec on this host's CPU: one 64 MiB block encoded at
    rs-2-1 and rs-6-3, and decoded with m data cells lost, through the
    native routine (``csrc/gf256.cc``) and the table path; each pair
    bit-exact."""
    from curvine_tpu_torch.common import ec
    block = tokens[:SHARD_BYTES // 4].view(np.uint8)
    out = {"native_ssse3": ec.native_hw()}
    for name in ("rs-2-1", "rs-6-3"):
        prof = ec.ECProfile.parse(name)
        cells, cs = ec.split(block, prof.k)
        row = {"cell_size": cs}
        coded = {}
        for native in (True, False):
            t = time.perf_counter()
            parity = ec.encode(prof, cells, use_native=native)
            enc_s = time.perf_counter() - t
            lost = [None] * prof.m + list(cells[prof.m:]) + parity
            t = time.perf_counter()
            data = ec.decode(prof, lost, use_native=native)
            dec_s = time.perf_counter() - t
            key = "native" if native else "table"
            row[f"encode_{key}_s"] = enc_s
            row[f"decode_{key}_s"] = dec_s
            row[f"encode_{key}_gibs"] = block.nbytes / GiB / enc_s
            row[f"decode_{key}_gibs"] = block.nbytes / GiB / dec_s
            coded[key] = (parity, data)
        if any(not np.array_equal(a, b) for a, b in
               zip(coded["native"][0] + coded["native"][1],
                   coded["table"][0] + coded["table"][1])) \
                or ec.join(coded["native"][1], block.nbytes) \
                != block.tobytes():
            raise AssertionError(f"ec (b): the codec's native and table "
                                 f"paths differ at {name}")
        out[name] = row
    return out


def phase_ec(dev: torch.device, root: str, seed: int, params: dict, step,
             client_res: dict) -> dict:
    """Erasure coding on one card: a master of the phase's own (the
    ``local`` placement, REP_LOST_MS) and four of the port's workers in
    this process, A to D, each with a mem tier and a tier-0 on the card.
    (a) SHARDS token shards of 64 MiB (ids below the flagship's vocab,
    from ``seed``) written to ``/ec/train`` at two replicas. (b)
    SET_ATTR's ``ec`` = EC_PROFILE on the file's directory and an
    ``ec_convert`` job: COMPLETED, every block then striped (three cells
    on three distinct workers) with its replicas retired, within
    EC_LIMIT_S; the conversion's seconds and GiB/s, a stripe's split into
    its pull, encode, placement and commit (those calls timed in the
    workers), and the codec's host timings (``_ec_codec_times``). (c)
    One epoch of ``GpuTrainFeed`` at phase feed's batch: every batch
    equal to its tokens, no degraded read. (d) The worker holding cell 0
    of block 0 stopped (``stop()``); one more epoch: every batch equal to
    its tokens, no read raising, degraded reads counted. (e) Every cell
    back on a live holder off the stopped worker within EC_LIMIT_S (the
    seconds from the stop); one more epoch, every batch equal to its
    tokens and no more degraded reads. (f) The rebuilt cells read
    WORKER_MIN_READS times through the client (a data cell by ``pread``
    of its range, a parity cell, which no intact read touches, by the
    reader's cell read; the other cells' heat first decayed by three
    host scans a worker) and pinned by their new
    holders' promote cycles, K1 verifying each pin (launches equal to the
    pins, pins equal to the rebuilt cells), each device copy equal to the
    cell the port's codec computes from the shard's tokens on the host;
    three flagship steps (phase ufs's parameters and step) on batches fed
    from ``/ec/train``: each equal to its tokens, finite losses, K3's
    four kernels once a layer a step. (g) ``/ec/train`` deleted: the
    master then holds no block (GET_MASTER_INFO), and after the next
    heartbeats no live worker's store holds one of its blocks or cells.
    The master's ``ec.*`` and ``replication.*`` counters are read after
    its stop: ``ec.stripes_committed`` equal to SHARDS, and
    ``ec.degraded_reads`` and ``replication.reconstructs`` above 0. The
    phase's files are deleted, its workers and master stopped and its
    directory removed, however it ends."""
    from curvine_tpu_torch.common import ec
    from curvine_tpu_torch.common.types import JobState, SetAttrOpts
    from curvine_tpu_torch.gpu import cuda_ops, flash
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_token_shards
    base = os.path.join(root, "ec")
    os.makedirs(base)
    res = {"lost_timeout_ms": REP_LOST_MS, "profile": EC_PROFILE}
    workers: dict[str, PortWorker] = {}
    proc = None
    master = None
    deleted = False
    tokens = ufs_tokens(seed, SHARDS, 0x6563)
    shard_tokens = SHARD_BYTES // 4
    kernels = [getattr(flash, nm) for nm in K3_NAMES]
    cfg = _flagship()
    prof = ec.ECProfile.parse(EC_PROFILE)
    per_batch = BATCH * SEQ
    n_epoch = tokens.size // per_batch

    def layout() -> dict[str, object]:
        """Each shard's located block (one a shard), by path."""
        async def run():
            async with port_client(master) as c:
                out = {}
                for st in await c.meta.list_status("/ec/train"):
                    fb = await c.meta.get_block_locations(st.path)
                    out[st.path] = fb.block_locs
                return out
        return asyncio.run(run())

    def epoch(what: str) -> dict:
        """One epoch of GpuTrainFeed over /ec/train at phase feed's
        batch: its batches, the ones unequal to their tokens, seconds and
        the client's counters."""
        expect = torch.from_numpy(tokens).to(dev)

        async def run():
            async with port_client(master) as c:
                f = GpuTrainFeed(c, "/ec/train", BATCH, SEQ, device=dev)
                bad = torch.zeros((), dtype=torch.int64, device=dev)
                n = 0
                torch.cuda.synchronize()
                t = time.perf_counter()
                async for b in f:
                    ref = expect[n * per_batch:(n + 1) * per_batch]
                    bad += (b != ref.view(BATCH, SEQ)).sum()
                    n += 1
                torch.cuda.synchronize()
                s = time.perf_counter() - t
                return dict(batches=n, bad=int(bad), s=s,
                            batches_per_s=n / s,
                            gibs=n * per_batch * 4 / GiB / s,
                            counters=dict(c.counters))
        out = asyncio.run(run())
        if out["batches"] != n_epoch or out["bad"]:
            raise AssertionError(f"ec ({what}): {out['batches']} batches of "
                                 f"{n_epoch}, {out['bad']} tokens unequal")
        return out

    try:
        conf = master_conf(base, lost_ms=REP_LOST_MS)
        proc, info = start_master(base, conf)
        master = info["addr"]
        master_conf(base, int(master.rsplit(":", 1)[1]), lost_ms=REP_LOST_MS)
        res["master_start_s"] = info["start_s"]
        for i, name in enumerate("abcd"):
            workers[name] = PortWorker(
                master, os.path.join(base, name), EC_TIER_BYTES, dev,
                coords=(i, 0), hbm_bytes=EC_HBM_BYTES)
        by_id = {pw.worker.worker_id: pw for pw in workers.values()}
        await_live(master, list(by_id), phase="ec")

        # (a) phase feed's shape at two replicas
        async def write():
            async with port_client(master, replicas=2) as c:
                t = time.perf_counter()
                paths = await write_token_shards(c, "/ec/train", tokens,
                                                 shard_tokens)
                return paths, time.perf_counter() - t
        paths, write_s = asyncio.run(write())
        before = layout()
        if len(paths) != SHARDS or any(
                len(lbs) != 1 or len(lbs[0].locs) != 2
                for lbs in before.values()):
            raise AssertionError(f"ec (a): {len(paths)} shards, located "
                                 f"{before}")
        res["a"] = dict(bytes=tokens.nbytes, write_s=write_s,
                        write_gibs=tokens.nbytes / GiB / write_s)
        log(f"ec (a): /ec/train, {SHARDS} shards of {SHARD_BYTES // MiB} "
            f"MiB of tokens, written at two replicas in {write_s:.3f}s "
            f"({res['a']['write_gibs']:.3f} GiB/s of file bytes)")

        # (b) SET_ATTR's ec, then the ec_convert job; its calls timed
        split: dict[str, list[float]] = {k: [] for k in
                                         ("pull", "encode", "place",
                                          "commit")}

        def timed(name, fn):
            async def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return await fn(*a, **kw)
                finally:
                    split[name].append(time.perf_counter() - t)
            return run

        real_encode = ec.encode

        def encode(*a, **kw):
            t = time.perf_counter()
            try:
                return real_encode(*a, **kw)
            finally:
                split["encode"].append(time.perf_counter() - t)

        for pw in workers.values():
            w = pw.worker
            w._pull_any = timed("pull", w._pull_any)
            w._place_cells = timed("place", w._place_cells)
            w._commit_stripe = timed("commit", w._commit_stripe)
        ec.encode = encode

        async def convert():
            async with port_client(master) as c:
                t = time.perf_counter()
                await c.meta.set_attr("/ec/train", SetAttrOpts(ec=EC_PROFILE))
                for p in paths:
                    await c.meta.set_attr(p, SetAttrOpts(ec=EC_PROFILE))
                job_id = await c.meta.submit_job("ec_convert", "/ec/train")
                job, _ = await _job_done(c, job_id, EC_LIMIT_S)
                job_s = time.perf_counter() - t
                while time.perf_counter() - t < EC_LIMIT_S:
                    fbs = [await c.meta.get_block_locations(p) for p in paths]
                    if all(lb.ec is not None and not lb.locs
                           for fb in fbs for lb in fb.block_locs):
                        break
                    await asyncio.sleep(0.05)
                return job, job_s, time.perf_counter() - t
        try:
            job, job_s, convert_s = asyncio.run(convert())
        finally:
            ec.encode = real_encode
            for pw in workers.values():
                for name in ("_pull_any", "_place_cells", "_commit_stripe"):
                    pw.worker.__dict__.pop(name, None)
        after = layout()
        cells = {}                 # path -> [(cell id, [holder ids])]
        for p, lbs in after.items():
            lb = lbs[0]
            if lb.ec is None or lb.locs or lb.ec["profile"] != EC_PROFILE \
                    or len(lb.ec["cells"]) != prof.k + prof.m:
                raise AssertionError(f"ec (b): {p} not striped at "
                                     f"{EC_PROFILE} with its replicas "
                                     f"retired: {lb}")
            cells[p] = [(cl["block_id"],
                         [a["worker_id"] for a in cl["locs"]])
                        for cl in lb.ec["cells"]]
            holders = [h[0] for _c, h in cells[p] if len(h) == 1]
            if len(holders) != prof.k + prof.m \
                    or len(set(holders)) != len(holders):
                raise AssertionError(f"ec (b): {p}'s cells on {cells[p]}, "
                                     f"not one each on distinct workers")
        if job.state != JobState.COMPLETED or any(
                len(v) != SHARDS for v in split.values()):
            raise AssertionError(f"ec (b): the job ended {job.state.name} "
                                 f"({job.message!r}); timed calls "
                                 f"{ {k: len(v) for k, v in split.items()} }")
        codec = _ec_codec_times(tokens)
        res["b"] = dict(
            job_s=job_s, convert_s=convert_s,
            convert_gibs=tokens.nbytes / GiB / convert_s,
            cell_size=after[paths[0]][0].ec["cell_size"],
            stripe_ms={k: [x * 1e3 for x in v] for k, v in split.items()},
            stripe_ms_median={k: float(np.median(v)) * 1e3
                              for k, v in split.items()},
            codec=codec)
        rb = res["b"]
        log(f"ec (b): SET_ATTR ec={EC_PROFILE} and an ec_convert job over "
            f"/ec/train: COMPLETED in {job_s:.3f}s, every block striped "
            f"(cells of {rb['cell_size']:,} bytes on three distinct workers) "
            f"and its replicas retired {convert_s:.3f}s after the SET_ATTR "
            f"({rb['convert_gibs']:.3f} GiB/s of blocks); a stripe's median "
            f"ms: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                rb["stripe_ms_median"].items())
            + f"; the codec on the host ({SHARD_BYTES // MiB} MiB, "
            f"SSSE3 {codec['native_ssse3']}): "
            + "; ".join(
                f"{n} encode {codec[n]['encode_native_gibs']:.3f} GiB/s "
                f"native, {codec[n]['encode_table_gibs']:.3f} table, decode "
                f"of {ec.ECProfile.parse(n).m} lost data cells "
                f"{codec[n]['decode_native_gibs']:.3f} native, "
                f"{codec[n]['decode_table_gibs']:.3f} table"
                for n in ("rs-2-1", "rs-6-3"))
            + ", bit-exact")

        # (c) the intact feed
        c_ep = epoch("c")
        if c_ep["counters"].get("read.ec_degraded", 0) \
                or c_ep["counters"].get("sc.bytes.read", 0):
            raise AssertionError(f"ec (c): degraded or short-circuit reads "
                                 f"in the intact epoch: {c_ep['counters']}")
        res["c"] = dict(batches_per_s=c_ep["batches_per_s"],
                        gibs=c_ep["gibs"], s=c_ep["s"],
                        client_batches_per_s=client_res["batches_per_s"],
                        read_block_bytes=c_ep["counters"].get(
                            "read.zero_copy_bytes", 0))
        log(f"ec (c): one epoch of GpuTrainFeed over the stripes, "
            f"{n_epoch} batches, each equal to its tokens, no degraded "
            f"read: {c_ep['batches_per_s']:.2f} batches/s "
            f"({c_ep['gibs']:.3f} GiB/s) against phase client's "
            f"{client_res['batches_per_s']:.2f}")

        # (d) the holder of block 0's cell 0 stopped; a degraded epoch
        victim = cells[paths[0]][0][1][0]
        vname = next(n for n, pw in workers.items()
                     if pw.worker.worker_id == victim)
        lost = {p: [i for i, (_c, h) in enumerate(cl) if victim in h]
                for p, cl in cells.items()}
        stop_t = time.perf_counter()
        workers.pop(vname).stop()
        d_ep = epoch("d")
        degraded = d_ep["counters"].get("read.ec_degraded", 0)
        if not degraded:
            raise AssertionError(f"ec (d): no degraded read with worker "
                                 f"{victim} stopped: {d_ep['counters']}")
        res["d"] = dict(victim=victim, batches_per_s=d_ep["batches_per_s"],
                        gibs=d_ep["gibs"], s=d_ep["s"],
                        degraded_reads=degraded,
                        lost_cells=sum(map(len, lost.values())))
        log(f"ec (d): worker {vname.upper()} ({victim}), holder of "
            f"{res['d']['lost_cells']} cells, stopped; one epoch, every "
            f"batch equal to its tokens, {degraded} degraded reads: "
            f"{d_ep['batches_per_s']:.2f} batches/s ({d_ep['gibs']:.3f} "
            f"GiB/s)")

        # (e) healed: every cell on a live holder off the stopped worker
        def healed() -> bool:
            now = layout()
            return all(lb.ec is not None and all(
                any(a["worker_id"] != victim for a in cl["locs"])
                for cl in lb.ec["cells"])
                for lbs in now.values() for lb in lbs)

        _poll(healed, EC_LIMIT_S, "every cell live off the stopped worker",
              0.1, "ec")
        heal_s = time.perf_counter() - stop_t
        healed_cells = {}         # cell id -> (path, index, new holder)
        for p, lbs in layout().items():
            for i in lost[p]:
                cl = lbs[0].ec["cells"][i]
                healed_cells[cl["block_id"]] = (p, i, cl["locs"][0]
                                                ["worker_id"])
        e_ep = epoch("e")
        more = e_ep["counters"].get("read.ec_degraded", 0)
        if more:
            raise AssertionError(f"ec (e): {more} degraded reads after the "
                                 f"heal")
        res["e"] = dict(heal_s=heal_s, rebuilt=len(healed_cells),
                        batches_per_s=e_ep["batches_per_s"],
                        gibs=e_ep["gibs"], s=e_ep["s"])
        log(f"ec (e): every cell back on a live holder {heal_s:.3f}s after "
            f"the stop ({len(healed_cells)} cells rebuilt); one epoch, "
            f"every batch equal to its tokens, no degraded read: "
            f"{e_ep['batches_per_s']:.2f} batches/s")

        # (f) the rebuilt cells pinned by their holders (K1), then steps
        for pw in workers.values():
            for _ in range(3):
                pw.worker.store.promote_scan(WORKER_MIN_READS)

        async def heat():
            async with port_client(master) as c:
                for cid, (p, i, _h) in healed_cells.items():
                    r = await c.open(p)
                    try:
                        lb = r.blocks.block_locs[0]
                        e = lb.ec
                        if i < prof.k:
                            # a data cell: the client's pread of its
                            # range, which the intact path reads from it
                            off = i * e["cell_size"]
                            n = min(e["cell_size"], e["block_len"] - off)
                            got = await r.pread(lb.offset + off, n)
                            if len(got) != n:
                                raise AssertionError(
                                    f"ec (f): pread of cell {cid} gave "
                                    f"{len(got)} of {n} bytes")
                        else:
                            # a parity cell: no read of the file touches
                            # it while the stripe is intact, so the
                            # reader's cell read is called directly
                            buf = bytearray(e["cell_size"])
                            await r._read_cell(e, e["cells"][i], 0,
                                               memoryview(buf))
                    finally:
                        await r.close()
        holders = {by_id[h] for _p, _i, h in healed_cells.values()}
        pins0 = sum(pw.worker.metrics.counters.get("blocks.hbm_pinned", 0)
                    for pw in holders)
        for _ in range(WORKER_MIN_READS):
            asyncio.run(heat())
        cuda_ops.block_checksum.launches = 0
        for pw in holders:
            pw.call(pw.worker._promote_once())
        k1 = cuda_ops.block_checksum.launches
        pins = sum(pw.worker.metrics.counters.get("blocks.hbm_pinned", 0)
                   for pw in holders) - pins0
        missing = [cid for cid, (_p, _i, h) in healed_cells.items()
                   if not by_id[h].worker.hbm_holds(cid)]
        if missing or k1 != pins or pins != len(healed_cells):
            raise AssertionError(f"ec (f): {pins} pins, {k1} K1 launches, "
                                 f"rebuilt cells {sorted(healed_cells)} not "
                                 f"pinned {missing}")
        for cid, (p, i, h) in healed_cells.items():
            shard = paths.index(p)
            block = tokens[shard * shard_tokens:(shard + 1) * shard_tokens]
            data, _ = ec.split(block.view(np.uint8), prof.k)
            want = data[i] if i < prof.k else ec.encode(prof, data)[i - prof.k]
            got = by_id[h].worker.hbm_get(cid).reshape(-1).view(torch.uint8)
            if not torch.equal(got, torch.from_numpy(want).to(dev)):
                raise AssertionError(f"ec (f): cell {cid} ({p}, index {i}) "
                                     f"on {h} differs from its encoding")
        del got
        first = tokens[:TRAIN_BATCH * TRAIN_SEQ * UFS_STEPS].reshape(
            UFS_STEPS, TRAIN_BATCH, TRAIN_SEQ)
        seen = []

        def check(b):
            seen.append(bool(torch.equal(b, torch.from_numpy(
                first[len(seen)]).to(dev))))

        async def train_steps():
            async with port_client(master) as c:
                f = GpuTrainFeed(c, "/ec/train", TRAIN_BATCH, TRAIN_SEQ,
                                 depth=2, device=dev)

                async def take():
                    for _ in range(UFS_STEPS):
                        yield await anext(f.prefetcher)

                try:
                    return await timed_steps(step, params, take(), check)
                finally:
                    await f.prefetcher.aclose()

        for fn in kernels:
            fn.launches = 0
        step_s, losses = asyncio.run(train_steps())
        launches = {fn.__name__: fn.launches for fn in kernels}
        if seen != [True] * UFS_STEPS or not all(map(math.isfinite, losses)) \
                or set(launches.values()) != {cfg.n_layers * UFS_STEPS}:
            raise AssertionError(f"ec (f): batches equal to their tokens "
                                 f"{seen}, losses {losses}, K3 launches "
                                 f"{launches}")
        res["f"] = dict(pins=pins, k1_launches=k1, losses=losses,
                        step_ms=[x * 1e3 for x in step_s],
                        launches=launches)
        log(f"ec (f): the {len(healed_cells)} rebuilt cells read "
            f"{WORKER_MIN_READS} times through the client and pinned by "
            f"their holders' promote cycles: {pins} pins, {k1} K1 launches, "
            f"each device copy equal to the port's encoding of its shard; "
            f"{UFS_STEPS} flagship steps at {TRAIN_BATCH}x{TRAIN_SEQ} on "
            f"batches fed from the stripes, each equal to its tokens: "
            f"losses {[round(x, 4) for x in losses]}, step ms "
            f"{[round(x * 1e3, 2) for x in step_s]}; K3 launches "
            f"{launches}")

        # (g) deleted: no block left in the master or the workers' stores
        ids = {cid for cl in cells.values() for cid, _h in cl} \
            | set(healed_cells) | {lbs[0].block.id for lbs in
                                   before.values()}

        async def delete():
            async with port_client(master) as c:
                await c.meta.delete("/ec", recursive=True)
                rep = await c.meta.master_info()
                return rep.block_num
        block_num = asyncio.run(delete())
        deleted = True
        left = _poll(lambda: not any(pw.worker.store.contains(b)
                                     for pw in workers.values()
                                     for b in ids),
                     10 * WORKER_HEARTBEAT_MS / 1000,
                     "the stores freed of /ec/train's blocks and cells",
                     0.05, "ec")
        if block_num:
            raise AssertionError(f"ec (g): the master holds {block_num} "
                                 f"blocks after the delete")
        res["g"] = dict(block_num=block_num, stores_freed_s=left)
        log(f"ec (g): /ec/train deleted: the master holds {block_num} "
            f"blocks, and the live workers' stores none of its "
            f"{len(ids)} blocks and cells {left:.3f}s later")
        stop_master(proc)
        with open(os.path.join(base, "master0.json")) as f:
            counters = json.load(f)["counters"]
        res["master_counters"] = {k: v for k, v in counters.items()
                                  if k.startswith(("ec.", "replication."))}
        mc = res["master_counters"]
        if mc.get("ec.stripes_committed") != SHARDS \
                or not mc.get("ec.degraded_reads") \
                or not mc.get("replication.reconstructs"):
            raise AssertionError(f"ec: the master's counters {mc}")
        log(f"ec: the master's counters {mc}")
    finally:
        try:
            if not deleted and proc is not None and proc.poll() is None:
                async def delete():
                    async with port_client(master) as c:
                        await c.meta.delete("/ec", recursive=True)
                asyncio.run(delete())
        except Exception as e:  # noqa: BLE001 — the directory goes anyway
            log(f"ec: deleting /ec failed: {e}")
        for name in list(workers):
            workers.pop(name).stop()
        if proc is not None:
            stop_master(proc)
        shutil.rmtree(base, ignore_errors=True)
    res["k1_launches"] = k1
    res["launches"] = launches
    return res


# ------------------------------------------------------------------ kv

def rss_bytes() -> int:
    """This process's resident set now (``/proc/self/statm``): the peak
    (``ru_maxrss``) stays where earlier phases left it."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def rss_baseline() -> int:
    """``rss_bytes`` after a collection and after the C heap's free pages
    went back to the system (glibc's ``malloc_trim``), so that what a
    measured stretch allocates shows as growth, not as a reuse of what
    earlier phases freed."""
    import ctypes
    import gc
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass
    return rss_bytes()


def kv_namespace(base: str, seed: int) -> dict:
    """Phase kv (a), as ``tests/test_kvstore.py:228-268`` runs it: a
    ``MasterFilesystem`` over ``KvMetaStore(engine="native",
    cache_inodes=KV_CACHE_INODES)`` and the port's ``Journal`` under
    ``base``, KV_FILES empty files in directories of KV_PER_DIR; at
    KV_FIRST files a checkpoint, a close and a reopen (timed), then the
    rest. The resident set's growth at KV_FIRST and at KV_FILES, at most
    KV_RSS_MB; a checkpoint, a close, and a reopen in under KV_RESTART_S
    with the same inode count, one file's status and one directory's
    KV_PER_DIR entries; the directory reopened with the Python engine:
    the same count and KV_STATS seeded statuses equal. Beside it, the
    same KV_FILES files on the mem store: its growth, its snapshot and
    its restart (the snapshot loaded, the tail replayed)."""
    import gc

    from curvine_tpu_torch.common.journal import Journal
    from curvine_tpu_torch.master.filesystem import MasterFilesystem
    from curvine_tpu_torch.master.store import KvMetaStore
    meta, jdir = os.path.join(base, "meta"), os.path.join(base, "journal")
    n_dirs, first_dirs = KV_FILES // KV_PER_DIR, KV_FIRST // KV_PER_DIR

    def inodes(n: int) -> int:
        return n + n // KV_PER_DIR + 2          # the files, dirs, / and /big

    def open_fs(engine=None, journal=jdir):
        """The master over the KV store on ``engine``, or with no engine
        over the mem store, and the seconds to recover it."""
        t = time.perf_counter()
        store = None if engine is None else KvMetaStore(
            meta, cache_inodes=KV_CACHE_INODES, engine=engine)
        fs = MasterFilesystem(journal=Journal(journal), store=store)
        fs.recover()
        return fs, time.perf_counter() - t

    def create(fs, d0: int, d1: int) -> float:
        t = time.perf_counter()
        for d in range(d0, d1):
            fs.mkdir(f"/big/d{d:05d}")
            for i in range(KV_PER_DIR):
                fs.create_file(f"/big/d{d:05d}/f{i:03d}")
        return time.perf_counter() - t

    def close(fs) -> None:
        fs.journal.close()
        fs.store.close()

    rss0 = rss_baseline()
    fs, _ = open_fs("native")
    s_first = create(fs, 0, first_dirs)
    rss_first = (rss_bytes() - rss0) / MiB
    fs.checkpoint()
    close(fs)
    fs, restart_first = open_fs("native")
    if fs.tree.count() != inodes(KV_FIRST):
        raise AssertionError(f"kv (a): {fs.tree.count()} inodes after the "
                             f"reopen at {KV_FIRST} files")
    s_rest = create(fs, first_dirs, n_dirs)
    rss_all = (rss_bytes() - rss0) / MiB
    fs.checkpoint()
    close(fs)
    fs, restart_s = open_fs("native")
    mid = n_dirs // 2
    st = fs.file_status(f"/big/d{mid:05d}/f123")
    listed = fs.list_status(f"/big/d{mid:05d}")
    rng = np.random.default_rng(seed)
    picks = [f"/big/d{d:05d}/f{i:03d}" for d, i in zip(
        rng.integers(0, n_dirs, KV_STATS), rng.integers(0, KV_PER_DIR,
                                                        KV_STATS))]
    native_stats = [fs.file_status(p).to_wire() for p in picks]
    count, segments = fs.tree.count(), fs.store.kv.segment_count
    kv_bytes = sum(os.path.getsize(os.path.join(meta, n))
                   for n in os.listdir(meta))
    rec = dict(fs.recovery)
    close(fs)
    del fs
    if rss_first > KV_RSS_MB or rss_all > KV_RSS_MB \
            or restart_s >= KV_RESTART_S or count != inodes(KV_FILES) \
            or st.name != "f123" or len(listed) != KV_PER_DIR \
            or rec["replayed"]:
        raise AssertionError(
            f"kv (a): RSS grew {rss_first:.1f} MiB at {KV_FIRST} files and "
            f"{rss_all:.1f} MiB at {KV_FILES} (at most {KV_RSS_MB}); the "
            f"restart {restart_s:.3f}s (under {KV_RESTART_S}); {count} "
            f"inodes of {inodes(KV_FILES)}; {st.name}, {len(listed)} "
            f"entries listed; recovery {rec}")
    fs, restart_py = open_fs("python")
    py_count = fs.tree.count()
    same = sum(fs.file_status(p).to_wire() == w
               for p, w in zip(picks, native_stats))
    close(fs)
    del fs
    if py_count != count or same != KV_STATS:
        raise AssertionError(f"kv (a): the Python engine reads {py_count} "
                             f"inodes of {count}, {same} of {KV_STATS} "
                             f"statuses equal")
    # the mem store at KV_FILES files: snapshot and replay
    mem_j = os.path.join(base, "mem-journal")
    rss0 = rss_baseline()
    fs, _ = open_fs(journal=mem_j)
    s_mem = create(fs, 0, n_dirs)
    rss_mem = (rss_bytes() - rss0) / MiB
    t = time.perf_counter()
    fs.checkpoint()
    snapshot_s = time.perf_counter() - t
    fs.journal.close()
    del fs
    gc.collect()
    fs, restart_mem = open_fs(journal=mem_j)
    mem_count = fs.tree.count()
    snapshot_bytes = sum(os.path.getsize(os.path.join(mem_j, n))
                         for n in os.listdir(mem_j)
                         if n.startswith("snapshot-"))
    fs.journal.close()
    del fs
    gc.collect()
    if mem_count != inodes(KV_FILES):
        raise AssertionError(f"kv (a): the mem store restarted with "
                             f"{mem_count} inodes of {inodes(KV_FILES)}")
    shutil.rmtree(base, ignore_errors=True)
    res = dict(files=KV_FILES, dirs=n_dirs, inodes=count,
               creates_per_s=KV_FILES / (s_first + s_rest),
               create_s=s_first + s_rest, rss_first_mib=rss_first,
               rss_all_mib=rss_all, restart_first_s=restart_first,
               restart_s=restart_s, restart_python_s=restart_py,
               segments=segments, kv_bytes=kv_bytes,
               stats_equal=same, mem=dict(
                   files=KV_FILES, creates_per_s=KV_FILES / s_mem,
                   rss_mib=rss_mem, snapshot_s=snapshot_s,
                   snapshot_bytes=snapshot_bytes, restart_s=restart_mem))
    log(f"kv (a): {KV_FILES:,} files in {n_dirs:,} directories through "
        f"MasterFilesystem over KvMetaStore (native engine, an inode cache "
        f"of {KV_CACHE_INODES:,}) in {res['create_s']:.1f}s "
        f"({res['creates_per_s']:,.0f} creates/s); RSS +{rss_first:.1f} MiB "
        f"at {KV_FIRST:,} files and +{rss_all:.1f} MiB at {KV_FILES:,} (at "
        f"most {KV_RSS_MB}); restarts {restart_first:.3f}s at {KV_FIRST:,} "
        f"and {restart_s:.3f}s at {KV_FILES:,} (under {KV_RESTART_S}), "
        f"{count:,} inodes, {segments} segments of {kv_bytes:,} bytes; "
        f"/big/d{mid:05d}/f123 stated and its directory's {len(listed)} "
        f"entries listed; the same directory on the Python engine: "
        f"{py_count:,} inodes, {same} of {KV_STATS} seeded statuses equal, "
        f"reopened in {restart_py:.3f}s. The mem store at {KV_FILES:,} "
        f"files: {res['mem']['creates_per_s']:,.0f} creates/s, RSS "
        f"+{rss_mem:.1f} MiB, a snapshot of {snapshot_bytes:,} bytes in "
        f"{snapshot_s:.3f}s, a restart (snapshot and replay) in "
        f"{restart_mem:.3f}s")
    return res


def phase_kv(dev: torch.device, root: str, seed: int, params: dict, step,
             client_res: dict) -> dict:
    """The master's KV metadata store on one card, with phase ufs's
    parameters and step. (a) ``kv_namespace``. (b) A master of the
    phase's own (``python -m curvine_tpu_torch.master``: the KV store,
    the native engine) and two of the port's workers in this process,
    each with a mem tier and a tier-0 on the card. Phase feed's shape, 8
    token shards of 64 MiB (ids below the flagship's vocab, from
    ``seed``) at one replica, written one at a time to ``/kv/train``
    through the port's client while a second client, on a thread and an
    event loop of its own, writes 4 KiB files (a mkdir every 16) under
    ``/kv/small``; after the KV_KILL_AFTER-th
    shard's commit the master gets SIGKILL (no stop, no checkpoint, no
    memtable flush) and is started again on its journal and KV directory
    on the same port. Both clients retry up to KV_RETRY_MAX times: no
    caller may see an error, and every create and complete acknowledged
    before the kill, and after it, must be there (the small files'
    lengths, and the bytes of those written before the kill). The
    restart's seconds, ``applied_seq`` against the journal's seq, the
    tail entries replayed, and the seconds from the kill until a writer
    has its next acknowledgement. (c) One epoch of ``GpuTrainFeed`` over
    the shards at phase feed's batch: every batch equal to its tokens;
    the shards read through the client up to WORKER_MIN_READS and pinned
    by their holders' promote cycles, K1 verifying each pin (launches
    equal to the pins), each device copy equal to its tokens; three
    flagship steps on batches taken from the pinned copies on the card:
    each equal to its tokens, finite losses, K3's four kernels once a
    layer a step. The master's dump after its stop names the native
    engine. The phase's workers and master are stopped and its directory
    removed, however it ends."""
    import signal
    import threading

    from curvine_tpu_torch.gpu import cuda_ops, flash
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed
    base = os.path.join(root, "kv")
    os.makedirs(base)
    res = {"a": kv_namespace(os.path.join(base, "a"), seed)}
    workers: list[PortWorker] = []
    cluster = {"proc": None}
    tokens = ufs_tokens(seed, SHARDS, 0x6B76)
    shard_tokens = SHARD_BYTES // 4
    kernels = [getattr(flash, nm) for nm in K3_NAMES]
    cfg = _flagship()
    paths = [f"/kv/train/shard-{i:05d}.bin" for i in range(SHARDS)]

    def small_bytes(i: int) -> bytes:
        return (i.to_bytes(4, "little") * (KV_SMALL // 4))

    try:
        bdir = os.path.join(base, "b")
        os.makedirs(bdir)
        conf = master_conf(bdir)
        cluster["proc"], info = start_master(bdir, conf)
        master = info["addr"]
        master_conf(bdir, int(master.rsplit(":", 1)[1]))
        for i, name in enumerate("ab"):
            workers.append(PortWorker(
                master, os.path.join(bdir, name), KV_TIER_BYTES, dev,
                coords=(i, 0), hbm_bytes=KV_HBM_BYTES))
        by_id = {pw.worker.worker_id: pw for pw in workers}
        await_live(master, list(by_id), phase="kv")

        def restart() -> dict:
            """The killed master reaped, then started again (a thread:
            the writers' retries run on meanwhile)."""
            old = cluster["proc"]
            old.wait()
            old.stdout.close()
            cluster["proc"], again = start_master(bdir, conf, 1)
            return again

        # (path, started, acknowledged) of each small file
        acked: list[tuple[str, float, float]] = []
        done = threading.Event()
        failed: list[BaseException] = []

        def small():
            """The 4 KiB writer, on a thread and a loop of its own."""
            async def run():
                async with port_client(master,
                                       conn_retry_max=KV_RETRY_MAX) as c:
                    i = 0
                    while not done.is_set():
                        d = f"/kv/small/d{i // 16:04d}"
                        t = time.perf_counter()
                        if i % 16 == 0:
                            await c.meta.mkdir(d)
                        await c.write_all(f"{d}/f{i:05d}", small_bytes(i))
                        acked.append((f"{d}/f{i:05d}", t,
                                      time.perf_counter()))
                        i += 1
            try:
                asyncio.run(run())
            except BaseException as e:  # noqa: BLE001 — raised below
                failed.append(e)

        async def writers():
            kill = {}
            async with port_client(master, conn_retry_max=KV_RETRY_MAX) \
                    as c:
                th = threading.Thread(target=small, name="kv-small")
                th.start()
                t0 = time.perf_counter()
                shard_t = []
                restarted = None
                try:
                    await c.meta.mkdir("/kv/train")
                    for i, p in enumerate(paths):
                        await c.write_all(p, tokens[i * shard_tokens:
                                                    (i + 1) * shard_tokens])
                        shard_t.append(time.perf_counter())
                        if i + 1 == KV_KILL_AFTER:
                            kill["t"] = time.perf_counter()
                            kill["acked"] = len(acked)
                            os.kill(cluster["proc"].pid, signal.SIGKILL)
                            restarted = asyncio.ensure_future(
                                asyncio.to_thread(restart))
                finally:
                    done.set()
                    await asyncio.to_thread(th.join)
                if failed:
                    raise failed[0]
                again = await restarted
                return kill, shard_t, t0, again
        kill, shard_t, t0, again = asyncio.run(writers())
        master = again["addr"]
        # the first acknowledgement of a write begun after the kill
        move_s = min([a for _p, t, a in acked if t > kill["t"]]
                     + shard_t[KV_KILL_AFTER:KV_KILL_AFTER + 1]) - kill["t"]
        rec = again["recovery"]

        async def verify():
            async with port_client(master) as c:
                t = time.perf_counter()
                while True:
                    ns = await namespace(c, "/kv")
                    if all(f["located"] for f in ns.values()) \
                            or time.perf_counter() - t > 60:
                        break
                    await asyncio.sleep(0.1)
                before = [p for p, _t, _a in acked[:kill["acked"]]]
                same = [await c.read_all(p) == small_bytes(
                    int(p.rsplit("f", 1)[1])) for p in before]
                return ns, same
        ns, same = asyncio.run(verify())
        missing = [p for p, _t, _a in acked
                   if ns.get(p, {}).get("len") != KV_SMALL
                   or not ns[p]["complete"]]
        shards_bad = [p for p in paths
                      if ns.get(p, {}).get("len") != SHARD_BYTES
                      or not ns[p]["complete"] or not ns[p]["located"]]
        if missing or shards_bad or not all(same) or not kill["acked"] \
                or len(acked) == kill["acked"] \
                or again["store"].get("engine") != "native" \
                or rec["applied_seq"] != again["journal_seq"]:
            raise AssertionError(
                f"kv (b): {len(missing)} of {len(acked)} acknowledged small "
                f"files missing or short ({missing[:5]}), shards not "
                f"complete and located {shards_bad}, {same.count(False)} "
                f"pre-kill files unequal, {kill['acked']} files before the "
                f"kill and {len(acked) - kill['acked']} after; the restart "
                f"{again['store']}, recovery {rec}, journal seq "
                f"{again['journal_seq']}")
        res["b"] = dict(
            shards=SHARDS, write_s=shard_t[-1] - t0,
            small_files=len(acked), small_before_kill=kill["acked"],
            restart_s=again["start_s"], recover_s=again["recover_s"],
            applied_seq=rec["applied_seq"], journal_seq=again["journal_seq"],
            replayed=rec["replayed"], inodes=rec["inodes"],
            blocks=rec["blocks"], move_s=move_s,
            retry_max=KV_RETRY_MAX)
        rb = res["b"]
        log(f"kv (b): {SHARDS} shards of {SHARD_BYTES // MiB} MiB written "
            f"to /kv/train at one replica in {rb['write_s']:.3f}s while "
            f"{len(acked)} files of {KV_SMALL} bytes were written under "
            f"/kv/small; the master killed (SIGKILL) after shard "
            f"{KV_KILL_AFTER}'s commit with {kill['acked']} small files "
            f"acknowledged, back in {rb['restart_s']:.3f}s (construction to "
            f"serving {rb['recover_s']:.3f}s: applied_seq "
            f"{rb['applied_seq'] - rb['replayed']} in the store, "
            f"{rb['replayed']} tail entries replayed to the journal's seq "
            f"{rb['journal_seq']}; {rb['inodes']} inodes, {rb['blocks']} "
            f"blocks); the writers' next acknowledgement {move_s:.3f}s after "
            f"the kill; no caller saw an error (clients retrying up to "
            f"{KV_RETRY_MAX} times); every acknowledged create and complete "
            f"there, the {kill['acked']} files written before the kill "
            f"equal")

        # (c) the shards fed, pinned (K1) and trained on (K3)
        expect = torch.from_numpy(tokens).to(dev)

        async def feed():
            async with port_client(master) as c:
                f = GpuTrainFeed(c, "/kv/train", BATCH, SEQ, device=dev)
                return await drive_feed(f, expect, dev)
        n, bad, feed_s = asyncio.run(feed())
        del expect
        n_expect = tokens.size // (BATCH * SEQ)
        if n != n_expect or bad:
            raise AssertionError(f"kv (c): {n} batches of {n_expect}, {bad} "
                                 f"tokens unequal")
        holder = {p: ns[p]["blocks"][0][0] for p in paths}
        locs = {}

        async def heat(todo):
            async with port_client(master) as c:
                for p in todo:
                    fb = await c.meta.get_block_locations(p)
                    locs[p] = fb.block_locs[0].locs[0].worker_id
                    r = await c.open(p)
                    try:
                        await r.read_all()
                    finally:
                        await r.close()

        def unpinned() -> list[str]:
            return [p for p in paths if p not in locs or not
                    by_id[locs[p]].worker.hbm_holds(holder[p])]

        pins0 = sum(pw.worker.metrics.counters.get("blocks.hbm_pinned", 0)
                    for pw in workers)
        cuda_ops.block_checksum.launches = 0
        cycles = 0
        while cycles < 6 and unpinned():
            asyncio.run(heat(unpinned()))
            for pw in workers:
                pw.call(pw.worker._promote_once())
            cycles += 1
        k1 = cuda_ops.block_checksum.launches
        pins = sum(pw.worker.metrics.counters.get("blocks.hbm_pinned", 0)
                   for pw in workers) - pins0
        if unpinned() or k1 != pins or pins < SHARDS:
            raise AssertionError(f"kv (c): {cycles} promote cycles, {pins} "
                                 f"pins, {k1} K1 launches, not pinned "
                                 f"{unpinned()}")
        pinned = {}
        for i, p in enumerate(paths):
            got = by_id[locs[p]].worker.hbm_get(holder[p]).reshape(
                -1).view(torch.int32)
            if not torch.equal(got, torch.from_numpy(
                    tokens[i * shard_tokens:(i + 1) * shard_tokens]).to(dev)):
                raise AssertionError(f"kv (c): {p}'s device copy differs "
                                     f"from its tokens")
            pinned[p] = got
        per_step = TRAIN_BATCH * TRAIN_SEQ
        first = tokens[:per_step * UFS_STEPS].reshape(UFS_STEPS, TRAIN_BATCH,
                                                      TRAIN_SEQ)
        seen = []

        def check(b):
            seen.append(bool(torch.equal(b, torch.from_numpy(
                first[len(seen)]).to(dev))))

        async def from_tier0():
            src = pinned[paths[0]]
            for k in range(UFS_STEPS):
                yield src[k * per_step:(k + 1) * per_step].view(
                    TRAIN_BATCH, TRAIN_SEQ)

        for fn in kernels:
            fn.launches = 0
        step_s, losses = asyncio.run(timed_steps(step, params, from_tier0(),
                                                 check))
        launches = {fn.__name__: fn.launches for fn in kernels}
        del pinned, got
        if seen != [True] * UFS_STEPS or not all(map(math.isfinite, losses)) \
                or set(launches.values()) != {cfg.n_layers * UFS_STEPS}:
            raise AssertionError(f"kv (c): batches equal to their tokens "
                                 f"{seen}, losses {losses}, K3 launches "
                                 f"{launches}")
        res["c"] = dict(batches=n, feed_s=feed_s, batches_per_s=n / feed_s,
                        small_pins=pins - SHARDS,
                        client_batches_per_s=client_res["batches_per_s"],
                        cycles=cycles, pins=pins, k1_launches=k1,
                        losses=losses, step_ms=[x * 1e3 for x in step_s],
                        launches=launches)
        log(f"kv (c): one epoch of GpuTrainFeed over /kv/train, {n} "
            f"batches, each equal to its tokens: {n / feed_s:.2f} batches/s "
            f"against phase client's {client_res['batches_per_s']:.2f}; the "
            f"{SHARDS} shards pinned by their holders' promote cycles "
            f"({cycles}): {pins} pins ({pins - SHARDS} of them small files "
            f"the check read twice), {k1} K1 launches, each shard's device "
            f"copy equal to its tokens; {UFS_STEPS} flagship steps at "
            f"{TRAIN_BATCH}x{TRAIN_SEQ} on batches taken from the pinned "
            f"copy of {paths[0]} on the card, each equal to its tokens: "
            f"losses {[round(x, 4) for x in losses]}, step ms "
            f"{[round(x * 1e3, 2) for x in step_s]}; K3 launches {launches}")
        stop_master(cluster["proc"])
        with open(os.path.join(bdir, "master1.json")) as f:
            dump = json.load(f)
        if dump["store"].get("engine") != "native" \
                or dump["recovery"] != rec:
            raise AssertionError(f"kv: the master's dump {dump['store']}, "
                                 f"recovery {dump['recovery']}")
        res["master_store"] = dump["store"]
    finally:
        for pw in workers:
            pw.stop()
        if cluster["proc"] is not None:
            stop_master(cluster["proc"])
        shutil.rmtree(base, ignore_errors=True)
    res["k1_launches"] = k1
    res["launches"] = launches
    return res


# ------------------------------------------------------------------ ha

async def raft_statuses(addrs: list[str]) -> list[dict | None]:
    """RAFT_STATUS of each master (None for one that does not answer)."""
    from curvine_tpu_torch.rpc.client import Connection
    from curvine_tpu_torch.rpc.codes import RpcCode
    from curvine_tpu_torch.rpc.deadline import Deadline
    from curvine_tpu_torch.rpc.frame import pack, unpack

    async def one(a):
        try:
            conn = await asyncio.wait_for(Connection(a, 2_000).connect(), 2)
        except Exception:  # noqa: BLE001 — a master down answers None
            return None
        try:
            rep = await conn.call(RpcCode.RAFT_STATUS, data=pack({}),
                                  deadline=Deadline(2.0))
            return unpack(rep.data)
        except Exception:  # noqa: BLE001
            return None
        finally:
            await conn.close()
    return list(await asyncio.gather(*(one(a) for a in addrs)))


def one_leader(addrs: list[str], timeout: float = HA_LIMIT_S,
               above_term: int = -1, what: str = "one leader"
               ) -> tuple[list[dict], float]:
    """Poll RAFT_STATUS until the masters at ``addrs`` agree on one leader
    of a term above ``above_term``: their statuses and the seconds."""
    t = time.perf_counter()
    while True:
        st = asyncio.run(raft_statuses(addrs))
        lead = [s for s in st if s and s["role"] == "leader"
                and s["term"] > above_term]
        if len(lead) == 1 and all(
                s and s["leader_id"] == lead[0]["node_id"]
                and s["term"] == lead[0]["term"] for s in st):
            return st, time.perf_counter() - t
        if time.perf_counter() - t > timeout:
            raise AssertionError(f"ha: never {what} in {timeout}s: {st}")
        time.sleep(0.02)


def ha_master_conf(d: str, port: int, addrs: list[str], nid: int) -> str:
    """``master_conf``'s file for node ``nid`` of the raft group at
    ``addrs`` (its own journal, KV directory and port)."""
    path = master_conf(d, port)
    with open(path, "a") as f:
        f.write(f"raft_peers = {json.dumps(addrs)}\nraft_node_id = {nid}\n")
    return path


def start_ha(base: str) -> tuple[dict, list[str], dict, float]:
    """HA_MASTERS masters of one raft group, launched at once on loopback
    ports probed first; a port taken meanwhile by another process
    (EADDRINUSE) starts the whole group again on fresh ports and fresh
    directories, as the reference's ``_make_ha_cluster`` does. Returns
    {node id: [process, directory, conf, starts]}, the addresses, the
    start lines and the launch's time."""
    import socket
    for attempt in range(3):
        socks = [socket.socket() for _ in range(HA_MASTERS)]
        for s in socks:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
        ports = [s.getsockname()[1] for s in socks]
        for s in socks:
            s.close()
        addrs = [f"127.0.0.1:{p}" for p in ports]
        nodes, infos, launched = {}, {}, []
        t0 = time.perf_counter()
        for nid in range(1, HA_MASTERS + 1):
            d = os.path.join(base, f"a{attempt}", f"m{nid}")
            os.makedirs(d)
            conf = ha_master_conf(d, ports[nid - 1], addrs, nid)
            launched.append((nid, launch_master(d, conf, 0)))
            nodes[nid] = [launched[-1][1][2], d, conf, 1]
        try:
            for nid, la in launched:
                _p, infos[nid] = master_line(*la)
            return nodes, addrs, infos, t0
        except RuntimeError as e:
            for n in nodes.values():
                stop_master(n[0])
            if "Address already in use" not in str(e) or attempt == 2:
                raise
            log(f"ha (a): a port was taken meanwhile; starting again: {e}")
    raise AssertionError("unreachable")


def phase_ha(dev: torch.device, root: str, seed: int, params: dict, step,
             client_res: dict) -> dict:
    """Raft HA of the master on one card, with phase ufs's parameters and
    step. (a) HA_MASTERS of the port's masters in their own processes,
    one raft group (``raft_peers``), each with its journal, its KV
    directory (the native engine) and a 30 s lost timeout, and two of the
    port's workers in this process that heartbeat all three and report
    their blocks in full every HA_REPORT_MS (the reference's HA test sets
    300 ms: a replica's location reaches a follower only by a full
    report); the seconds from the launch to one leader, and each node's
    term and role. (b) Phase feed's shape at one replica with a writer
    of 4 KiB files beside it, the leader SIGKILLed after shard
    HA_KILL_AFTER: the seconds to a new leader and until each writer has
    its next acknowledgement, no caller error, every acknowledged file on
    the new leader with its length and the survivors equal (journal
    head, files); the killed master started again, and the seconds until
    its head is the leader's. (c) A round at HA_PADS files with an 8 MiB
    xattr each (SET_ATTR; 72 MiB, past MAX_FRAME), then HA_BIG_ROUNDS at
    HA_PADS_BIG (288 MiB): a follower stopped and its journal and KV
    directory wiped, the pads set, leadership handed to the other
    follower (RAFT_TRANSFER, timed; after the first round the node the
    last installed) and the wiped node started again: it must hold the last
    pad, caught up by a chunked snapshot; from the masters' dumps, each
    round's chunks, the cut's seconds on the leader's loop, the drain,
    build and pack's in a forked child, the leader's longest loop stall, and
    the wiped node's install on its thread, its swap and its longest loop
    stall; either stall at HA_STALL_MS or more, a cut at HA_CUT_MS or
    more, or an election after the transfer, fails the phase. (d)
    ``GpuTrainFeed`` over the shards, a RAFT_TRANSFER HA_TRANSFER_AFTER
    batches in: every batch equal to its tokens, batches/s beside phase
    client's. (e) The shards and the small files read through the client
    and pinned by the workers' promote cycles (K1 launches equal to the
    pins), three flagship steps on the pinned copy of the first shard
    (K3). Every master's dump after its stop: the ``raft.*`` counters.
    The phase's masters and workers are stopped and its directory
    removed, however it ends."""
    import signal
    import threading

    from curvine_tpu_torch.gpu import cuda_ops, flash
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed
    base = os.path.join(root, "ha")
    os.makedirs(base)
    res: dict = {}
    workers: list[PortWorker] = []
    nodes: dict = {}
    tokens = ufs_tokens(seed, SHARDS, 0x6861)
    shard_tokens = SHARD_BYTES // 4
    kernels = [getattr(flash, nm) for nm in K3_NAMES]
    cfg = _flagship()
    paths = [f"/ha/train/shard-{i:05d}.bin" for i in range(SHARDS)]
    t_phase = time.perf_counter()

    def small_bytes(i: int) -> bytes:
        return i.to_bytes(4, "little") * (KV_SMALL // 4)

    def restart(nid: int) -> dict:
        """Node ``nid``, stopped or killed, started again on its conf."""
        proc, d, conf, n = nodes[nid]
        if proc.poll() is None:
            stop_master(proc)
        else:
            proc.wait()
            proc.stdout.close()
        nodes[nid][0], info = start_master(d, conf, n)
        nodes[nid][3] = n + 1
        return info

    try:
        # (a) the group
        nodes, addrs, infos, t0 = start_ha(base)
        st, _ = one_leader(addrs)
        elect_s = time.perf_counter() - t0
        addr_of = {s["node_id"]: a for s, a in zip(st, addrs)}
        leader = st[0]["leader_id"]
        res["a"] = dict(elect_s=elect_s, term=st[0]["term"], leader=leader,
                        nodes={s["node_id"]: {"role": s["role"],
                                              "term": s["term"]} for s in st},
                        start_s={n: i["start_s"] for n, i in infos.items()})
        for i, name in enumerate("ab"):
            workers.append(PortWorker(
                addrs, os.path.join(base, name), KV_TIER_BYTES, dev,
                coords=(i, 0), hbm_bytes=KV_HBM_BYTES,
                report_ms=HA_REPORT_MS))
        by_id = {pw.worker.worker_id: pw for pw in workers}
        for a in addrs:
            await_live(a, list(by_id), phase="ha")
        log(f"ha (a): {HA_MASTERS} of the port's masters (one raft group, "
            f"each its own process, journal and KV directory) elected node "
            f"{leader} in term {st[0]['term']} {elect_s:.3f}s after the "
            f"launch; roles {[(s['node_id'], s['role']) for s in st]}; "
            f"both workers live on all three")

        # (b) writers through the leader's death
        acked: list[tuple[str, float, float]] = []
        done = threading.Event()
        failed: list[BaseException] = []
        kill: dict = {}

        def finished() -> bool:
            """The shards are written, and a small file begun after the
            kill is acknowledged (or HA_LIMIT_S passed since it)."""
            return done.is_set() and (
                "t" not in kill or (acked and acked[-1][1] > kill["t"])
                or time.perf_counter() - kill["t"] > HA_LIMIT_S)

        def small():
            async def run():
                async with port_client(addrs,
                                       conn_retry_max=KV_RETRY_MAX) as c:
                    i = 0
                    while not finished():
                        d = f"/ha/small/d{i // 16:04d}"
                        t = time.perf_counter()
                        if i % 16 == 0:
                            await c.meta.mkdir(d)
                        await c.write_all(f"{d}/f{i:05d}", small_bytes(i))
                        acked.append((f"{d}/f{i:05d}", t,
                                      time.perf_counter()))
                        i += 1
            try:
                asyncio.run(run())
            except BaseException as e:  # noqa: BLE001 — raised below
                failed.append(e)

        def watch():
            """The seconds from the kill to a new leader the survivors
            agree on."""
            survivors = [a for n, a in addr_of.items() if n != leader]
            st2, _s = one_leader(survivors, above_term=res["a"]["term"],
                                 what="a new leader after the kill")
            kill["elected"] = time.perf_counter()
            kill["status"] = st2

        async def writers():
            async with port_client(addrs, conn_retry_max=KV_RETRY_MAX) as c:
                th = threading.Thread(target=small, name="ha-small")
                th.start()
                t0w = time.perf_counter()
                shard_t = []
                wt = None
                try:
                    await c.meta.mkdir("/ha/train")
                    for i, p in enumerate(paths):
                        await c.write_all(p, tokens[i * shard_tokens:
                                                    (i + 1) * shard_tokens])
                        shard_t.append(time.perf_counter())
                        if i + 1 == HA_KILL_AFTER:
                            kill["t"] = time.perf_counter()
                            kill["acked"] = len(acked)
                            os.kill(nodes[leader][0].pid, signal.SIGKILL)
                            wt = threading.Thread(target=watch)
                            wt.start()
                finally:
                    done.set()
                    await asyncio.to_thread(th.join)
                    if wt is not None:
                        await asyncio.to_thread(wt.join)
                if failed:
                    raise failed[0]
                return shard_t, t0w
        shard_t, t0w = asyncio.run(writers())
        if "elected" not in kill:
            raise AssertionError("ha (b): no new leader after the kill")
        new_leader = kill["status"][0]["leader_id"]
        survivors = {n: a for n, a in addr_of.items() if n != leader}
        after = [a for _p, t, a in acked if t > kill["t"]]
        small_next = min(after) - kill["t"] if after else None
        shard_next = shard_t[HA_KILL_AFTER] - kill["t"]

        async def survey(a):
            """Every file under /ha on the master at ``a``: its length,
            whether it is complete, its blocks (id, length), those with
            bytes and no live location, and those of no bytes (a block
            whose ADD_BLOCK was retried on the new leader, whose retry
            cache never saw the first: it was left empty)."""
            async with port_client(a) as c:
                out = {}
                dirs = ["/ha"]
                while dirs:
                    for st in await c.meta.list_status(dirs.pop()):
                        if st.is_dir:
                            dirs.append(st.path)
                            continue
                        lbs = (await c.meta.get_block_locations(
                            st.path)).block_locs
                        out[st.path] = {
                            "len": st.len, "complete": st.is_complete,
                            "blocks": sorted([lb.block.id, lb.block.len]
                                             for lb in lbs),
                            "unlocated": [lb.block.id for lb in lbs
                                          if lb.block.len and not lb.locs],
                            "empty": [lb.block.id for lb in lbs
                                      if not lb.block.len]}
                return out

        def heads():
            return {s["node_id"]: s["last_seq"]
                    for s in asyncio.run(raft_statuses(
                        list(survivors.values()))) if s}
        conv_s = _poll(lambda: len(set(heads().values())) == 1
                       and len(heads()) == 2, HA_LIMIT_S,
                       "the survivors at one journal head", 0.05, "ha")
        ns = asyncio.run(survey(survivors[new_leader]))
        located_s = _poll(
            lambda: not any(f["unlocated"] for f in asyncio.run(
                survey(survivors[new_leader])).values()),
            HA_LIMIT_S, "every block with bytes located on the new leader",
            0.1, "ha")
        ns = asyncio.run(survey(survivors[new_leader]))
        other = next(n for n in survivors if n != new_leader)
        ns_other = asyncio.run(survey(survivors[other]))

        def files(x):
            return {p: (f["len"], f["complete"], f["blocks"])
                    for p, f in x.items()}
        missing = [p for p, _t, _a in acked
                   if ns.get(p, {}).get("len") != KV_SMALL
                   or not ns[p]["complete"]]
        shards_bad = [p for p in paths
                      if ns.get(p, {}).get("len") != SHARD_BYTES
                      or not ns[p]["complete"]]
        if missing or shards_bad or files(ns) != files(ns_other) \
                or not kill["acked"] or not after:
            raise AssertionError(
                f"ha (b): {len(missing)} of {len(acked)} acknowledged small "
                f"files missing or short ({missing[:5]}), shards {shards_bad}"
                f", the survivors' files equal: {files(ns) == files(ns_other)}"
                f", {kill['acked']} small files before the kill, "
                f"{len(after)} begun after it")
        head = heads()[new_leader]
        t = time.perf_counter()
        again = restart(leader)
        caught_s = _poll(
            lambda: (lambda h: h.get(leader) is not None
                     and h.get(leader) >= h.get(new_leader, 1 << 62))(
                {s["node_id"]: s["last_seq"] for s in asyncio.run(
                    raft_statuses(list(addr_of.values()))) if s}),
            HA_LIMIT_S, "the restarted master at the leader's head", 0.05,
            "ha")
        res["b"] = dict(
            shards=SHARDS, write_s=shard_t[-1] - t0w, small_files=len(acked),
            small_before_kill=kill["acked"], killed=leader,
            new_leader=new_leader, term=kill["status"][0]["term"],
            elect_s=kill["elected"] - kill["t"], shard_next_s=shard_next,
            small_next_s=small_next, converge_s=conv_s, located_s=located_s,
            empty_blocks=sum(len(f["empty"]) for f in ns.values()),
            head=head, restart_s=again["start_s"],
            caught_up_s=time.perf_counter() - t,
            caught_up_after_start_s=caught_s,
            retry_max=KV_RETRY_MAX)
        rb = res["b"]
        log(f"ha (b): {SHARDS} shards of {SHARD_BYTES // MiB} MiB written "
            f"to /ha/train at one replica in {rb['write_s']:.3f}s beside "
            f"{len(acked)} files of {KV_SMALL} bytes; the leader (node "
            f"{leader}) killed (SIGKILL) after shard {HA_KILL_AFTER}'s "
            f"commit with {kill['acked']} small files acknowledged; node "
            f"{new_leader} leader of term {rb['term']} {rb['elect_s']:.3f}s "
            f"after the kill; the writers' next acknowledgements "
            f"{shard_next:.3f}s (shards) and {small_next:.3f}s (small files) "
            f"after it; no caller saw an error (retrying up to "
            f"{KV_RETRY_MAX} times); every acknowledged file on the new "
            f"leader with its length, the survivors at one head "
            f"({rb['head']}) with the same files ({rb['empty_blocks']} empty "
            f"blocks of retried ADD_BLOCKs); the killed master back in "
            f"{rb['restart_s']:.3f}s and at the leader's head "
            f"{caught_s:.3f}s after its start")

        # (c) chunked snapshot installs at full frame size: a round at
        # HA_PADS pads, then HA_BIG_ROUNDS at HA_PADS_BIG, each to a wiped
        # node
        pad = "x" * HA_PAD
        res["c"] = {"rounds": []}
        made = 0
        for n_pads in (HA_PADS,) + (HA_PADS_BIG,) * HA_BIG_ROUNDS:
            st, _ = one_leader(list(addr_of.values()))
            lead_c = st[0]["leader_id"]
            fol = [n for n in sorted(addr_of) if n != lead_c]
            if res["c"]["rounds"]:
                # the node that installed last round takes over, and the
                # other follower is wiped
                f2 = res["c"]["rounds"][-1]["wiped"]
                f1 = next(n for n in fol if n != f2)
            else:
                f1, f2 = fol
            stop_master(nodes[f1][0])
            jdir = os.path.join(nodes[f1][1], "cluster", "journal")
            shutil.rmtree(jdir)
            shutil.rmtree(jdir + "-meta")
            leader_run = f"{f2}.{nodes[f2][3] - 1}"

            async def pads(lo, hi, to):
                from curvine_tpu_torch.common.types import SetAttrOpts
                async with port_client(addrs,
                                       conn_retry_max=KV_RETRY_MAX) as c:
                    if lo == 0:
                        await c.meta.mkdir("/ha/fat")
                    for i in range(lo, hi):
                        await c.meta.create_file(f"/ha/fat/f{i}")
                        await c.meta.complete_file(f"/ha/fat/f{i}", 0)
                        await c.meta.set_attr(
                            f"/ha/fat/f{i}",
                            SetAttrOpts(add_x_attr={"pad": pad}))
                    t = time.perf_counter()
                    target = await c.meta.raft_transfer(to)
                    return target, time.perf_counter() - t
            t = time.perf_counter()
            target, transfer_s = asyncio.run(pads(made, n_pads, f2))
            pads_s = time.perf_counter() - t - transfer_s
            made = n_pads
            st, _ = one_leader([addr_of[lead_c], addr_of[f2]])
            term_transfer = st[0]["term"]
            again = restart(f1)
            wiped_run = f"{f1}.{nodes[f1][3] - 1}"      # its dump's name

            def holds_pad() -> bool:
                async def run():
                    async with port_client(addr_of[f1]) as c:
                        last = f"/ha/fat/f{n_pads - 1}"
                        if not await c.meta.exists(last):
                            return False
                        stt = await c.meta.file_status(last)
                        return len(stt.x_attr.get("pad", "")) == HA_PAD
                try:
                    return asyncio.run(run())
                except Exception:  # noqa: BLE001 — installing: asked again
                    return False
            install_s = _poll(holds_pad, HA_LIMIT_S,
                              "the wiped master holding the last pad", 0.1,
                              "ha")
            st, _ = one_leader(list(addr_of.values()))
            rc = dict(wiped=f1, leader=f2, target=target,
                      transfer_s=transfer_s, pads=n_pads, pad_bytes=HA_PAD,
                      namespace_mib=n_pads * HA_PAD // MiB, pads_s=pads_s,
                      restart_s=again["start_s"], install_s=install_s,
                      term_after_transfer=term_transfer,
                      term_after_install=st[0]["term"],
                      leader_after_install=st[0]["leader_id"],
                      leader_run=leader_run, wiped_run=wiped_run)
            res["c"]["rounds"].append(rc)
            if target != f2 or rc["leader_after_install"] != f2:
                raise AssertionError(
                    f"ha (c): the transfer went to {target}, the leader is "
                    f"{rc['leader_after_install']}, not node {f2}")
            log(f"ha (c) at {rc['namespace_mib']} MiB: node {f1} stopped "
                f"and wiped; pads up to {n_pads} files with an "
                f"{HA_PAD // MiB} MiB xattr each, set in {pads_s:.3f}s; "
                f"leadership handed from node {lead_c} to node {f2} in "
                f"{transfer_s:.3f}s (term {term_transfer}); node {f1} back "
                f"in {rc['restart_s']:.3f}s and holding the last pad "
                f"{install_s:.3f}s after its start; term "
                f"{rc['term_after_install']} after the install "
                f"({'no' if rc['term_after_install'] == term_transfer else 'AN'}"
                f" election since the transfer)")
        f2 = res["c"]["rounds"][-1]["leader"]

        # (d) the feed through a second failover
        expect = torch.from_numpy(tokens).to(dev)
        per_batch = BATCH * SEQ

        async def feed():
            async with port_client(addrs,
                                   conn_retry_max=KV_RETRY_MAX) as c:
                f = GpuTrainFeed(c, "/ha/train", BATCH, SEQ, device=dev)
                bad = torch.zeros((), dtype=torch.int64, device=dev)
                n, tr = 0, None
                torch.cuda.synchronize()
                t = time.perf_counter()
                async for b in f:
                    ref = expect[n * per_batch:(n + 1) * per_batch]
                    bad += (b != ref.view(BATCH, SEQ)).sum()
                    n += 1
                    if n == HA_TRANSFER_AFTER:
                        tr = asyncio.ensure_future(timed_transfer(c))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                return n, int(bad), secs, await tr

        async def timed_transfer(c):
            t = time.perf_counter()
            target = await c.meta.raft_transfer()
            return target, time.perf_counter() - t
        n, bad, feed_s, (target_d, transfer_d) = asyncio.run(feed())
        del expect
        n_expect = tokens.size // (BATCH * SEQ)
        st, _ = one_leader(list(addr_of.values()))
        if n != n_expect or bad or st[0]["leader_id"] != target_d \
                or target_d == f2:
            raise AssertionError(f"ha (d): {n} batches of {n_expect}, {bad} "
                                 f"tokens unequal; transfer to {target_d}, "
                                 f"leader {st[0]['leader_id']}")
        res["d"] = dict(batches=n, feed_s=feed_s, batches_per_s=n / feed_s,
                        client_batches_per_s=client_res["batches_per_s"],
                        target=target_d, transfer_s=transfer_d,
                        term=st[0]["term"])
        log(f"ha (d): one epoch of GpuTrainFeed over /ha/train, {n} batches "
            f"at {BATCH}x{SEQ}, each equal to its tokens, through a "
            f"RAFT_TRANSFER {HA_TRANSFER_AFTER} batches in (node {f2} -> "
            f"{target_d}, {transfer_d:.3f}s, term {st[0]['term']}): "
            f"{n / feed_s:.2f} batches/s against phase client's "
            f"{client_res['batches_per_s']:.2f}")

        # (e) the device path: pins (K1) and steps (K3)
        small_paths = [p for p, _t, _a in acked]
        want = paths + small_paths
        holder, locs = {}, {}

        async def heat(todo):
            async with port_client(addrs) as c:
                for p in todo:
                    fb = await c.meta.get_block_locations(p)
                    lb = next(x for x in fb.block_locs if x.block.len)
                    holder[p] = lb.block.id
                    locs[p] = lb.locs[0].worker_id
                    r = await c.open(p)
                    try:
                        await r.read_all()
                    finally:
                        await r.close()

        def unpinned() -> list[str]:
            return [p for p in want if p not in locs or not
                    by_id[locs[p]].worker.hbm_holds(holder[p])]

        pins0 = sum(pw.worker.metrics.counters.get("blocks.hbm_pinned", 0)
                    for pw in workers)
        cuda_ops.block_checksum.launches = 0
        cycles = 0
        while cycles < 8 and unpinned():
            asyncio.run(heat(unpinned()))
            for pw in workers:
                pw.call(pw.worker._promote_once())
            cycles += 1
        k1 = cuda_ops.block_checksum.launches
        pins = sum(pw.worker.metrics.counters.get("blocks.hbm_pinned", 0)
                   for pw in workers) - pins0
        if unpinned() or k1 != pins or pins < len(want):
            raise AssertionError(f"ha (e): {cycles} promote cycles, {pins} "
                                 f"pins, {k1} K1 launches, not pinned "
                                 f"{unpinned()[:5]}")
        pinned = {}
        for i, p in enumerate(paths):
            got = by_id[locs[p]].worker.hbm_get(holder[p]).reshape(
                -1).view(torch.int32)
            if not torch.equal(got, torch.from_numpy(
                    tokens[i * shard_tokens:(i + 1) * shard_tokens]).to(dev)):
                raise AssertionError(f"ha (e): {p}'s device copy differs "
                                     f"from its tokens")
            pinned[p] = got
        for p in small_paths:
            got = by_id[locs[p]].worker.hbm_get(holder[p]).reshape(-1)
            want_b = small_bytes(int(p.rsplit("f", 1)[1]))
            if bytes(got.cpu().numpy().tobytes()) != want_b:
                raise AssertionError(f"ha (e): {p}'s device copy differs")
        per_step = TRAIN_BATCH * TRAIN_SEQ
        first = tokens[:per_step * UFS_STEPS].reshape(UFS_STEPS, TRAIN_BATCH,
                                                      TRAIN_SEQ)
        seen = []

        def check(b):
            seen.append(bool(torch.equal(b, torch.from_numpy(
                first[len(seen)]).to(dev))))

        async def from_tier0():
            src = pinned[paths[0]]
            for k in range(UFS_STEPS):
                yield src[k * per_step:(k + 1) * per_step].view(
                    TRAIN_BATCH, TRAIN_SEQ)

        for fn in kernels:
            fn.launches = 0
        step_s, losses = asyncio.run(timed_steps(step, params, from_tier0(),
                                                 check))
        launches = {fn.__name__: fn.launches for fn in kernels}
        del pinned, got
        if seen != [True] * UFS_STEPS or not all(map(math.isfinite, losses)) \
                or set(launches.values()) != {cfg.n_layers * UFS_STEPS}:
            raise AssertionError(f"ha (e): batches equal to their tokens "
                                 f"{seen}, losses {losses}, K3 launches "
                                 f"{launches}")
        res["e"] = dict(cycles=cycles, pins=pins, small_pins=len(small_paths),
                        k1_launches=k1, losses=losses,
                        step_ms=[x * 1e3 for x in step_s], launches=launches)
        log(f"ha (e): the {SHARDS} shards and {len(small_paths)} small files "
            f"read through the client and pinned by the workers' promote "
            f"cycles ({cycles}): {pins} pins, {k1} K1 launches, each device "
            f"copy equal to its bytes; {UFS_STEPS} flagship steps at "
            f"{TRAIN_BATCH}x{TRAIN_SEQ} on batches taken from the pinned copy "
            f"of {paths[0]}, each equal to its tokens: losses "
            f"{[round(x, 4) for x in losses]}, step ms "
            f"{[round(x * 1e3, 2) for x in step_s]}; K3 launches {launches}")

        # every master's dump: the raft counters
        for nid in sorted(nodes):
            stop_master(nodes[nid][0])
        dumps = {}
        for nid, (_p, d, _c, n) in sorted(nodes.items()):
            for k in range(n):
                path = os.path.join(d, f"master{k}.json")
                if os.path.exists(path):    # a SIGKILLed run wrote none
                    with open(path) as f:
                        dumps[f"{nid}.{k}"] = json.load(f)
        raft = {k: {c: v for c, v in {**x["counters"], **x["gauges"]}.items()
                    if c.startswith("raft.")} for k, x in dumps.items()}
        sent = sum(r.get("raft.snapshot_chunks_sent", 0)
                   for r in raft.values())
        installs = {k: r.get("raft.snapshot_installs", 0)
                    for k, r in raft.items()}
        stall = max(r.get("raft.snapshot_loop_stall_ms", 0)
                    for r in raft.values())
        res["raft"] = raft
        res["c"].update(chunks_sent=sent, installs=installs,
                        loop_stall_ms=stall)
        for rc in res["c"]["rounds"]:
            lr = raft.get(rc["leader_run"], {})
            wr = raft.get(rc["wiped_run"], {})
            rc.update(
                chunks_sent=lr.get("raft.snapshot_chunks_sent", 0),
                cut_s=lr.get("raft.snapshot_build_s", 0.0),
                fork_s=lr.get("raft.snapshot_fork_s", 0.0),
                pack_s=lr.get("raft.snapshot_pack_s", 0.0),
                leader_stall_ms=lr.get("raft.snapshot_loop_stall_ms", 0.0),
                leader_stall_at_s=lr.get("raft.snapshot_stall_at_s", 0.0),
                install_build_s=wr.get("raft.install_build_s", 0.0),
                install_swap_s=wr.get("raft.install_swap_s", 0.0),
                install_stall_ms=wr.get("raft.install_loop_stall_ms", 0.0),
                install_stall_at_s=wr.get("raft.install_stall_at_s", 0.0),
                installs=installs.get(rc["wiped_run"], 0),
                elections=rc["term_after_install"]
                - rc["term_after_transfer"])
            log(f"ha (c) at {rc['namespace_mib']} MiB: {rc['chunks_sent']} "
                f"chunks from node {rc['leader']}; the cut "
                f"{rc['cut_s'] * 1e3:.3f} ms and the fork "
                f"{rc['fork_s'] * 1e3:.3f} ms on the leader's loop, the "
                f"drain, build and pack {rc['pack_s']:.3f}s in the child; the "
                f"leader's longest loop stall {rc['leader_stall_ms']:.1f} ms, "
                f"{rc['leader_stall_at_s']:.3f}s after the cut; the wiped "
                f"node's install {rc['install_build_s']:.3f}s on a thread, "
                f"the swap {rc['install_swap_s'] * 1e3:.3f} ms, its longest "
                f"loop stall {rc['install_stall_ms']:.1f} ms, "
                f"{rc['install_stall_at_s']:.3f}s into the install; "
                f"{rc['elections']} elections after the transfer")
            # the wiped node's run after the wipe installed the stream; a
            # loop held past half the least election timeout fails
            if rc["installs"] < 1 or rc["chunks_sent"] * 4 * MiB \
                    <= rc["pads"] * HA_PAD or rc["elections"] \
                    or rc["leader_stall_ms"] >= HA_STALL_MS \
                    or rc["install_stall_ms"] >= HA_STALL_MS \
                    or rc["cut_s"] * 1e3 >= HA_CUT_MS:
                raise AssertionError(f"ha (c): the round {rc}, installs "
                                     f"{installs}")
        small, *bigs = res["c"]["rounds"]
        big = max(bigs, key=lambda rc: rc["cut_s"])
        res["c"]["cut_ratio"] = big["cut_s"] / max(small["cut_s"], 1e-9)
        res["b"]["rejoin_installs"] = installs.get(f"{leader}.1", 0)
        res["phase_s"] = time.perf_counter() - t_phase
        log(f"ha: the masters' raft counters {raft}")
        log(f"ha (c): {sent} snapshot chunks sent in all (the pads' streams "
            f"past MAX_FRAME), installs {installs}; the longest leader's "
            f"loop stall while it cut and sent a snapshot {stall:.1f} ms; "
            f"the longest cut at {big['namespace_mib']} MiB "
            f"{res['c']['cut_ratio']:.2f}x the cut at "
            f"{small['namespace_mib']} MiB (each below {HA_CUT_MS} ms); the "
            f"leader's stalls at {big['namespace_mib']} MiB "
            f"{[round(rc['leader_stall_ms'], 1) for rc in bigs]} ms; the "
            f"restarted "
            f"ex-leader caught up by "
            f"{'a snapshot' if res['b']['rejoin_installs'] else 'the log'}; "
            f"the phase {res['phase_s']:.1f}s")
    finally:
        for pw in workers:
            pw.stop()
        for n in nodes.values():
            stop_master(n[0])
        shutil.rmtree(base, ignore_errors=True)
    res["k1_launches"] = k1
    res["launches"] = launches
    return res

# ------------------------------------------------------------------- shm

async def fed_epoch(c, path: str, expect: torch.Tensor, dev: torch.device):
    """One epoch of ``GpuTrainFeed`` over ``path`` at phase feed's batch,
    each device batch held to ``expect``; (batches, tokens that differ,
    seconds, profiler, the source's cache_fetch split)."""
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed
    f = GpuTrainFeed(c, path, BATCH, SEQ, device=dev)
    n, bad, secs = await drive_feed(f, expect, dev)
    return n, bad, secs, f.profiler, dict(f.source.fetch_split)


def phase_shm(dev: torch.device, root: str, seed: int, params: dict, step,
              link_gibs: float) -> dict:
    """The shared-memory read plane, with phase ufs's parameters and
    step: a master of the phase's own (the ici placement) and three of
    the port's workers in this process, F at (0, 0) with ``shm_reads``
    off, S at (1, 0) with it on (the default) and a tier-0 on the card,
    and W at (2, 0) on an SSD tier (the file layout, under the run's
    data directory) with a warm cache of SHM_WARM_MB. Phase feed's shape
    written three times, by ICI coordinates: /shm/fd on F, /shm/shm on S,
    /shm/warm on W. (a) ``GpuTrainFeed`` at phase feed's batch over
    /shm/fd (the fd path) and /shm/shm (the mapping), interleaved twice,
    each batch equal to its tokens: batches/s, the GiB/s into device
    memory and ``cache_fetch`` split into the probe, the map and the copy,
    beside phase 3's ``link_gibs``; through shm, ``read.shm_hits`` equal
    to the blocks read and no fallback. (b) /shm/warm fed once (the fd
    path), each block read again until its heat reaches
    ``shm_warm_min_reads``, then fed again: ``read.shm_warm_hits`` equal to
    the blocks read, no fallback, the warm cache's stats. (d) S's blocks,
    hot from (a)'s reads, pinned into its tier-0 by promote cycles (K1
    against the host hash, launches equal to the pins), each device copy
    equal to its tokens; three flagship steps on batches fed from
    /shm/shm through the mappings, each equal to its tokens (K3). (c) A
    block of /shm/shm deleted while a reader holds its mapping's view:
    the view reads equal bytes after the worker dropped the block and its
    export, and after the reader dropped the mapping. Fails if a side
    channel did not start, or a read counted a fallback. The master and
    workers are stopped and the directory removed, however it ends."""
    from curvine_tpu_torch.gpu import cuda_ops, flash
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_token_shards
    base = os.path.join(root, "shm")
    os.makedirs(base)
    res: dict = {}
    workers: dict[str, PortWorker] = {}
    proc = None
    tokens = ufs_tokens(seed, SHARDS, 0x73686D)
    shard_tokens = SHARD_BYTES // 4
    kernels = [getattr(flash, nm) for nm in K3_NAMES]
    cfg = _flagship()
    t_phase = time.perf_counter()
    try:
        conf = master_conf(base, lost_ms=REP_LOST_MS, policy="ici")
        proc, info = start_master(base, conf)
        master = info["addr"]
        workers["f"] = PortWorker(master, os.path.join(base, "f"),
                                  SHM_TIER_BYTES, dev, coords=(0, 0),
                                  hbm_bytes=0, shm_reads=False)
        workers["s"] = PortWorker(master, os.path.join(base, "s"),
                                  SHM_TIER_BYTES, dev, coords=(1, 0),
                                  hbm_bytes=SHM_HBM_BYTES)
        workers["w"] = PortWorker(master, os.path.join(base, "w"),
                                  SHM_TIER_BYTES, dev, coords=(2, 0),
                                  hbm_bytes=0, tier="ssd",
                                  shm_warm_cap_mb=SHM_WARM_MB)
        wf, ws, ww = (workers[n].worker for n in "fsw")
        if wf.shm is not None or ws._shm_channel is None \
                or ww._shm_channel is None or ww.shm_warm is None:
            raise AssertionError(
                f"shm: F's exporter {wf.shm}, S's channel "
                f"{ws._shm_channel}, W's channel {ww._shm_channel} and warm "
                f"cache {ww.shm_warm}: a side channel did not start")
        await_live(master, [w.worker_id for w in (wf, ws, ww)], phase="shm")
        log(f"shm: a master and three of the port's workers: F "
            f"({wf.worker_id}, shm_reads off), S ({ws.worker_id}, its side "
            f"channel at {ws._shm_channel.path}) and W ({ww.worker_id}, an "
            f"SSD tier, a warm cache of {SHM_WARM_MB} MiB, its channel at "
            f"{ww._shm_channel.path})")

        async def write(path, coords, **kw):
            async with port_client(master, coords=coords, **kw) as c:
                t = time.perf_counter()
                await write_token_shards(c, path, tokens, shard_tokens)
                return time.perf_counter() - t

        placed = {}
        for path, coords, who, kw in (
                ("/shm/fd", (0, 0), wf, {}), ("/shm/shm", (1, 0), ws, {}),
                ("/shm/warm", (2, 0), ww, {"storage_type": "ssd"})):
            secs = asyncio.run(write(path, coords, **kw))
            locs = [_block_locs(master, f"{path}/shard-{i:05d}.bin")
                    for i in range(SHARDS)]
            if any(len(x) != 1 or x[0][1] != [who.worker_id] for x in locs):
                raise AssertionError(f"shm: {path} placed {locs}, not each "
                                     f"shard one block on {who.worker_id}")
            placed[path] = [x[0][0] for x in locs]
            res.setdefault("write_s", {})[path] = secs
        ssd = {b for b, i in ww.store.blocks.items()
               if i.tier.storage_type.name == "SSD"}
        if not set(placed["/shm/warm"]) <= ssd:
            raise AssertionError("shm: /shm/warm's blocks are not on W's "
                                 "SSD tier")
        expect = torch.from_numpy(tokens).to(dev)
        n_expect = tokens.size // (BATCH * SEQ)

        def run_feed(path: str, label: str) -> dict:
            async def run():
                async with port_client(master) as c:
                    got = await fed_epoch(c, path, expect, dev)
                    return got, dict(c.counters)
            (n, bad, secs, prof, split), counters = asyncio.run(run())
            if n != n_expect or bad:
                raise AssertionError(f"shm: {label}: {n}/{n_expect} batches, "
                                     f"{bad} tokens unequal")
            out = feed_stats(f"shm {label}", n, secs, prof)
            out.update(read_gibs_into_device=out["gibs"], fetch_split_s=split,
                       fetch_split_ms_per_block={
                           k: v * 1e3 / SHARDS for k, v in split.items()},
                       counters={k: counters.get(k, 0) for k in SHM_KEYS})
            log(f"shm {label}: {out['read_gibs_into_device']:.3f} GiB/s into "
                f"device memory ({out['batches_per_s']:.1f} batches/s) "
                f"against phase 3's link_gibs {link_gibs:.3f}; cache_fetch "
                f"a block: probe "
                f"{out['fetch_split_ms_per_block']['probe']:.3f} ms, map "
                f"{out['fetch_split_ms_per_block']['map']:.3f} ms, copy "
                f"{out['fetch_split_ms_per_block']['copy']:.3f} ms; "
                f"counters {out['counters']}")
            return out

        # (a) the fd path against the mapping, interleaved
        res["a"] = {"fd": [], "shm": []}
        for _ in range(2):
            res["a"]["fd"].append(run_feed("/shm/fd", "(a) fd path"))
            res["a"]["shm"].append(run_feed("/shm/shm", "(a) shm"))
        for r in res["a"]["fd"]:
            if r["counters"]["read.shm_hits"] or \
                    r["counters"]["read.shm_fallbacks"]:
                raise AssertionError(f"shm (a): F offered shm: "
                                     f"{r['counters']}")
        for r in res["a"]["shm"]:
            if r["counters"]["read.shm_hits"] != SHARDS or \
                    r["counters"]["read.shm_fallbacks"]:
                raise AssertionError(f"shm (a): {r['counters']['read.shm_hits']}"
                                     f" shm hits for {SHARDS} blocks read, "
                                     f"{r['counters']['read.shm_fallbacks']} "
                                     f"fallbacks")
        res["a"]["grants"] = ws.metrics.counters.get("shm.grants", 0)
        res["a"]["exports"] = ws.shm.exports
        res["a"]["export_hits"] = ws.shm.hits

        # (b) the warm cache: W's blocks heated by reads, then fed again
        res["b"] = {"fd": run_feed("/shm/warm", "(b) SSD, fd path")}
        min_reads = ww.conf.worker.shm_warm_min_reads

        async def heat():
            async with port_client(master) as c:
                for _ in range(min_reads - 1):
                    for i in range(SHARDS):
                        r = await c.open(f"/shm/warm/shard-{i:05d}.bin")
                        if await r.mmap_view(0, r.len) is None:
                            raise AssertionError("shm (b): no short circuit")
                        await r.close()
        asyncio.run(heat())
        heat_now = {b: ww.store.get(b, touch=False).heat
                    for b in placed["/shm/warm"]}
        res["b"]["warm"] = run_feed("/shm/warm", "(b) SSD, warm shm")
        res["b"]["heat"] = heat_now
        res["b"]["warm_stats"] = ww.shm_warm.stats()
        wc_ = res["b"]["warm"]["counters"]
        if wc_["read.shm_warm_hits"] != SHARDS or wc_["read.shm_hits"] \
                or wc_["read.shm_warm_fallbacks"] or \
                res["b"]["warm_stats"]["exports"] != SHARDS:
            raise AssertionError(f"shm (b): {wc_}, the warm cache "
                                 f"{res['b']['warm_stats']}, heat {heat_now}")
        log(f"shm (b): W's blocks read {min_reads} times (heat "
            f"{sorted(heat_now.values())}); the warm cache "
            f"{res['b']['warm_stats']}; warm grants "
            f"{ww.metrics.counters.get('shm.warm_grants', 0)}")

        # (d) S's blocks pinned by K1, then three steps fed by the mappings
        s_pw = workers["s"]
        pins0 = ws.metrics.counters.get("blocks.hbm_pinned", 0)
        cuda_ops.block_checksum.launches = 0
        cycles = []
        while not all(ws.hbm_holds(b) for b in placed["/shm/shm"]) \
                and len(cycles) < 8:
            t = time.perf_counter()
            s_pw.call(ws._promote_once())
            cycles.append(time.perf_counter() - t)
        k1 = cuda_ops.block_checksum.launches
        pins = ws.metrics.counters.get("blocks.hbm_pinned", 0) - pins0
        missing = [b for b in placed["/shm/shm"] if not ws.hbm_holds(b)]
        if missing or k1 != pins:
            raise AssertionError(f"shm (d): {len(cycles)} promote cycles, "
                                 f"{pins} pins, {k1} K1 launches, blocks not "
                                 f"pinned {missing}")
        for i, b in enumerate(placed["/shm/shm"]):
            got = ws.hbm_get(b)
            if not torch.equal(got.view(torch.int32),
                               expect[i * shard_tokens:
                                      (i + 1) * shard_tokens]):
                raise AssertionError(f"shm (d): block {b}'s device copy "
                                     f"differs from its tokens")
        del got
        first = tokens[:TRAIN_BATCH * TRAIN_SEQ * UFS_STEPS].reshape(
            UFS_STEPS, TRAIN_BATCH, TRAIN_SEQ)
        seen = []

        def check(b):
            seen.append(bool(torch.equal(b, torch.from_numpy(
                first[len(seen)]).to(dev))))

        async def train_steps():
            async with port_client(master) as c:
                f = GpuTrainFeed(c, "/shm/shm", TRAIN_BATCH, TRAIN_SEQ,
                                 depth=2, device=dev)

                async def take():
                    for _ in range(UFS_STEPS):
                        yield await anext(f.prefetcher)

                try:
                    got = await timed_steps(step, params, take(), check)
                finally:
                    await f.prefetcher.aclose()
                return got, dict(c.counters)

        for fn in kernels:
            fn.launches = 0
        (step_s, losses), counters = asyncio.run(train_steps())
        launches = {fn.__name__: fn.launches for fn in kernels}
        if seen != [True] * UFS_STEPS or not all(map(math.isfinite, losses)) \
                or set(launches.values()) != {cfg.n_layers * UFS_STEPS} \
                or not counters.get("read.shm_hits") \
                or counters.get("read.shm_fallbacks"):
            raise AssertionError(f"shm (d): batches equal {seen}, losses "
                                 f"{losses}, K3 launches {launches}, "
                                 f"counters {counters}")
        res["d"] = dict(cycles=len(cycles), pins=pins, k1_launches=k1,
                        losses=losses, step_ms=[x * 1e3 for x in step_s],
                        launches=launches,
                        shm_hits=counters.get("read.shm_hits", 0))
        log(f"shm (d): {len(cycles)} promote cycles pinned S's {pins} "
            f"shm-read blocks, each verified by K1 ({k1} launches) and "
            f"equal to its tokens on the card; {UFS_STEPS} flagship steps at "
            f"{TRAIN_BATCH}x{TRAIN_SEQ} on batches fed from the mappings "
            f"({res['d']['shm_hits']} shm hits), each equal to its tokens: "
            f"losses {[round(x, 4) for x in losses]}, step ms "
            f"{[round(x * 1e3, 2) for x in step_s]}; K3 launches {launches}")

        # (c) a block deleted under a reader's mapping
        victim = "/shm/shm/shard-00000.bin"
        bid = placed["/shm/shm"][0]

        async def deleted_under_view():
            async with port_client(master) as c:
                r = await c.open(victim)
                view = await r.mmap_view(0, r.len)
                if view is None or bid not in r._shm_maps:
                    raise AssertionError("shm (c): the block is not mapped")
                await c.meta.delete(victim)
                t = time.perf_counter()
                while ws.store.contains(bid) or bid in ws.shm._fds:
                    if time.perf_counter() - t > SHM_LIMIT_S:
                        raise AssertionError("shm (c): S kept the block")
                    await asyncio.sleep(0.05)
                gone_s = time.perf_counter() - t
                same = np.array_equal(view.view(np.int32),
                                      tokens[:shard_tokens])
                r._drop_shm(bid)              # the reader's eviction
                again = np.array_equal(view.view(np.int32),
                                       tokens[:shard_tokens])
                await r.close()
                return same, again, gone_s, dict(c.counters)
        same, again, gone_s, counters = asyncio.run(deleted_under_view())
        if not (same and again) or counters.get("read.shm_fallbacks"):
            raise AssertionError(f"shm (c): the view equal after the delete "
                                 f"{same}, after the reader's drop {again}; "
                                 f"{counters}")
        res["c"] = dict(dropped_s=gone_s, equal=True)
        log(f"shm (c): {victim} deleted while a reader held its mapping's "
            f"view; S dropped the block and its export {gone_s:.3f}s later, "
            f"and the view still equals its tokens, also after the reader "
            f"dropped the mapping")
        del expect
        res["phase_s"] = time.perf_counter() - t_phase
        log(f"shm: the phase {res['phase_s']:.1f}s")
    finally:
        for w in workers.values():
            w.stop()
        if proc is not None:
            stop_master(proc)
        shutil.rmtree(base, ignore_errors=True)
    res["k1_launches"] = res["d"]["k1_launches"]
    res["launches"] = res["d"]["launches"]
    return res


def wire_calls(master: str, paths: list[str], rpc: dict | None) -> dict:
    """Phase wire (a): WIRE_CALLERS callers over one port client's pool,
    each alternating GET_FILE_STATUS and GET_BLOCK_LOCATIONS of
    ``paths`` for WIRE_CALL_S; calls/s, p50 and p99 in ms, the client's
    frames a send, and the writers that broke meanwhile."""
    from curvine_tpu_torch.common.metrics import MetricsRegistry

    async def run():
        async with port_client(master, rpc=rpc) as c:
            c.meta.pool.metrics = MetricsRegistry("client")
            await c.meta.file_status(paths[0])         # the dial
            lat: list[float] = []
            mark = len(WRITER_BREAKS)
            t_end = time.perf_counter() + WIRE_CALL_S

            async def caller(k: int):
                i = k
                while time.perf_counter() < t_end:
                    p = paths[i % len(paths)]
                    t = time.perf_counter()
                    if i % 2:
                        fb = await c.meta.get_block_locations(p)
                        if fb.status.len != SHARD_BYTES:
                            raise AssertionError(f"wire (a): {p} {fb}")
                    else:
                        st = await c.meta.file_status(p)
                        if st.len != SHARD_BYTES:
                            raise AssertionError(f"wire (a): {p} {st}")
                    lat.append(time.perf_counter() - t)
                    i += 1

            t0 = time.perf_counter()
            await asyncio.gather(*(caller(k) for k in range(WIRE_CALLERS)))
            secs = time.perf_counter() - t0
            h = c.meta.pool.metrics.histograms["rpc.send_batch_frames"]
            return lat, secs, h.sum / h.count, WRITER_BREAKS[mark:]

    lat, secs, client_mean, breaks = asyncio.run(run())
    lat.sort()
    return {"calls": len(lat), "calls_per_s": len(lat) / secs,
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "client_frames_per_send": client_mean, "breaks": breaks}


def wire_shared(master: str, paths: list[str], workers: list, seed: int,
                rpc: dict | None) -> dict:
    """Phase wire (a) behind streams, the traffic whose replies queue:
    WIRE_STREAMS tasks read the first half of ``paths`` whole
    (``read_all``, READ_BLOCK chunks by ``sendfile``) over and over while
    WIRE_CALLERS callers read WIRE_SMALL bytes at random offsets of the
    other half (``pread``: no window), all over one client's pool with
    the short circuit off, for WIRE_SHARED_S; the ``workers`` (their
    servers and the client with ``rpc`` set in their ``[rpc]`` tables).
    The small reads/s, their p50 and p99 in ms, the streams' GiB/s, and
    the workers' frames a send meanwhile (``rpc.send_batch_frames``; a
    ``sendfile`` chunk is no frame of it, the EOFs queued behind one
    are)."""
    from curvine_tpu_torch.common.conf import RpcConf
    saved = [w.rpc.rpc_conf for w in workers]
    for w in workers:
        # the servers' writers take their frames a send at each accept
        w.rpc.rpc_conf = RpcConf(**(rpc or {}))
    hs = [w.metrics.histograms.get("rpc.send_batch_frames")
          for w in workers]
    before = [(h.count, h.sum) if h is not None else (0, 0) for h in hs]
    rng = np.random.default_rng(seed)
    half = len(paths) // 2
    no_sc = dict(short_circuit=False, read_ahead_chunks=WIRE_READ_AHEAD)

    async def run():
        async with port_client(master, rpc=rpc, **no_sc) as c:
            readers = [await c.open(p) for p in paths[half:]]
            lat: list[float] = []
            streamed = [0]
            t_end = time.perf_counter() + WIRE_SHARED_S

            async def stream(k: int):
                while time.perf_counter() < t_end:
                    streamed[0] += len(await c.read_all(paths[k % half]))

            async def caller(k: int):
                r = readers[k % len(readers)]
                while time.perf_counter() < t_end:
                    off = int(rng.integers(0, r.len - WIRE_SMALL))
                    t = time.perf_counter()
                    got = await r.pread(off, WIRE_SMALL)
                    lat.append(time.perf_counter() - t)
                    if len(got) != WIRE_SMALL:
                        raise AssertionError(f"wire (a): {len(got)} bytes")
            t0 = time.perf_counter()
            await asyncio.gather(*(stream(k) for k in range(WIRE_STREAMS)),
                                 *(caller(k) for k in range(WIRE_CALLERS)))
            secs = time.perf_counter() - t0
            for r in readers:
                await r.close()
            return lat, secs, streamed[0], dict(c.counters)

    mark = len(WRITER_BREAKS)
    try:
        lat, secs, streamed, counters = asyncio.run(run())
    finally:
        for w, rc in zip(workers, saved):
            w.rpc.rpc_conf = rc
    hs = [w.metrics.histograms.get("rpc.send_batch_frames")
          for w in workers]
    sends = sum(h.count for h in hs if h is not None) - \
        sum(b[0] for b in before)
    frames = sum(h.sum for h in hs if h is not None) - \
        sum(b[1] for b in before)
    lat.sort()
    return {"small_reads": len(lat), "small_reads_per_s": len(lat) / secs,
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "stream_gibs": streamed / GiB / secs,
            "workers_sends": sends, "workers_frames": frames,
            "workers_frames_per_send": frames / max(1, sends),
            "sc_bytes": counters.get("sc.bytes.read", 0),
            "shm_reads": sum(counters.get(k, 0) for k in SHM_KEYS
                             if k.startswith("read.shm")),
            "breaks": WRITER_BREAKS[mark:]}


def phase_wire(dev: torch.device, root: str, seed: int, params: dict, step,
               link_gibs: float) -> dict:
    """The wire transport and the reader's read-ahead, with phase ufs's
    parameters and step: a master of the phase's own on the KV store
    (the robin placement) and two of the port's workers in this process,
    A and B, each with a tier-0 on the card; phase feed's shape written
    to /wire/train, its blocks alternating between A and B. Every client
    of (b)-(d) has the short circuit off: every byte comes by READ_BLOCK
    over the coalesced writer and the bulk decoder.

    (b) The 8 shards into device memory through the pinned staging ring,
    three ways: ``read_all``, ``pread_view`` in sequential WIRE_STEP reads
    with a prefetch window of WIRE_READ_AHEAD segments, and
    ``read_range(0, n, parallel=WIRE_PARALLEL)``; each shard compared on
    the card with its tokens. Per pass: GiB/s into device memory, the
    reader's ``pf.bytes.read`` (above 0 for ``pread_view``, 0 for
    ``read_all``) and ``read.zero_copy_bytes``, the registered receive
    pool's stats (the workers' ``rpc.recv_*``), the workers' bytes sent;
    beside phase 3's ``link_gibs``. (c) Over one shard, WIRE_FLIPS
    sequential runs of ``pread_view``, each followed by WIRE_PROBES
    random probes: every read equal to its bytes, ``detector.sequential``
    after each run. (d) The shards, hot from (b), pinned into the
    workers' tier-0 by promote cycles (K1 against the host hash, launches
    equal to the pins), each device copy equal to its tokens; three
    flagship steps on batches read by ``pread_view`` through the window,
    each equal to its tokens (K3). (a) Behind streams (``wire_shared``):
    small reads sharing the pool with shard streams, at the defaults and
    at one frame a send (the workers' and the client's). Small calls,
    last: the master restarted on its journal, WIRE_CALLERS callers for
    WIRE_CALL_S (``wire_calls``), four times in turns: at the defaults,
    twice on a master and a client with ``send_coalesce_frames = 1``, at
    the defaults; the master's frames a send and its dispatch and reply
    send times from its ``--metrics-out`` dump. Fails if a byte of
    (a)-(d) came by the short circuit or shm, a pass's bytes differ, a
    run at one frame a send sent more, or a writer broke in (b)-(d) or in
    an (a) run, the master's included. The master and workers are
    stopped and the directory removed, however it ends."""
    from curvine_tpu_torch.gpu import cuda_ops, flash
    from curvine_tpu_torch.gpu.ingest import PinnedStager
    from curvine_tpu_torch.gpu.loader import write_token_shards
    from curvine_tpu_torch.rpc.transport import recv_pool
    base = os.path.join(root, "wire")
    os.makedirs(base)
    res: dict = {}
    workers: dict[str, PortWorker] = {}
    proc = None
    tokens = ufs_tokens(seed, SHARDS, 0x77697265)
    shard_tokens = SHARD_BYTES // 4
    kernels = [getattr(flash, nm) for nm in K3_NAMES]
    cfg = _flagship()
    t_phase = time.perf_counter()
    no_sc = dict(short_circuit=False, read_ahead_chunks=WIRE_READ_AHEAD)
    try:
        conf = master_conf(base, lost_ms=REP_LOST_MS, policy="robin")
        proc, info = start_master(base, conf)
        master = info["addr"]
        port = int(master.rsplit(":", 1)[1])
        conf = master_conf(base, port, REP_LOST_MS, "robin")
        for name, xy in (("a", (0, 0)), ("b", (1, 0))):
            workers[name] = PortWorker(master, os.path.join(base, name),
                                       WIRE_TIER_BYTES, dev, coords=xy,
                                       hbm_bytes=WIRE_HBM_BYTES)
        wa, wb = workers["a"].worker, workers["b"].worker
        await_live(master, [wa.worker_id, wb.worker_id], phase="wire")

        async def write():
            async with port_client(master) as c:
                t = time.perf_counter()
                paths = await write_token_shards(c, "/wire/train", tokens,
                                                 shard_tokens)
                return paths, time.perf_counter() - t
        paths, res["write_s"] = asyncio.run(write())
        locs = [_block_locs(master, p) for p in paths]
        holders = [x[0][1] for x in locs]
        blocks = [x[0][0] for x in locs]
        if any(len(x) != 1 or len(x[0][1]) != 1 for x in locs) or \
                any(holders[i] == holders[i + 1] for i in range(SHARDS - 1)) \
                or {h[0] for h in holders} != {wa.worker_id, wb.worker_id}:
            raise AssertionError(f"wire: {locs}: not one block a shard, "
                                 f"alternating between A and B")
        log(f"wire: a master and two of the port's workers, A "
            f"({wa.worker_id}) and B ({wb.worker_id}); {SHARDS} shards of "
            f"{SHARD_BYTES // MiB} MiB written in {res['write_s']:.3f}s, "
            f"their blocks alternating {[h[0] for h in holders]}")
        expect = torch.from_numpy(tokens).to(dev)

        def breaks_since(mark: int, label: str, got=None) -> list:
            got = WRITER_BREAKS[mark:] if got is None else got
            if got:
                raise AssertionError(f"wire {label}: writers broke: {got}")
            return got

        # (b) the three passes into device memory
        def one_pass(how: str) -> dict:
            stager = PinnedStager(dev)
            dst = torch.empty(SHARD_BYTES, dtype=torch.uint8, device=dev)
            bad = torch.zeros((), dtype=torch.int64, device=dev)
            pool0 = recv_pool().stats()
            sent0 = [w.metrics.counters.get("rpc.bytes_sent", 0)
                     for w in (wa, wb)]

            split = {"read": 0.0, "stage": 0.0}

            def stage(into, v) -> None:
                t = time.perf_counter()
                stager.copy_in(into, v)
                split["stage"] += time.perf_counter() - t

            async def read(coro):
                t = time.perf_counter()
                v = await coro
                split["read"] += time.perf_counter() - t
                return v

            async def run():
                async with port_client(master, **no_sc) as c:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for i, p in enumerate(paths):
                        r = await c.open(p)
                        if how == "pread_view":
                            got = 0
                            for off in range(0, r.len, WIRE_STEP):
                                v = await read(r.pread_view(off, WIRE_STEP))
                                stage(dst[off:off + len(v)], v)
                                got += len(v)
                        elif how == "read_all":
                            v = np.frombuffer(await read(r.read_all()),
                                              dtype=np.uint8)
                            got = len(v)
                            stage(dst[:got], v)
                        else:
                            v = await read(r.read_range(
                                0, r.len, parallel=WIRE_PARALLEL))
                            got = len(v)
                            stage(dst[:got], v)
                        await r.close()
                        if got != SHARD_BYTES:
                            raise AssertionError(f"wire (b) {how}: {p}: "
                                                 f"{got} bytes")
                        bad.add_((dst.view(torch.int32) != expect[
                            i * shard_tokens:(i + 1) * shard_tokens]).sum())
                    torch.cuda.synchronize()
                    return time.perf_counter() - t, dict(c.counters)

            secs, counters = asyncio.run(run())
            pool1 = recv_pool().stats()
            out = {"s": secs, "read_s": split["read"],
                   "stage_s": split["stage"],
                   "read_gibs_into_device": SHARDS * SHARD_BYTES / GiB / secs,
                   "tokens_unequal": int(bad),
                   "pf_bytes": counters.get("pf.bytes.read", 0),
                   "zero_copy_bytes": counters.get("read.zero_copy_bytes", 0),
                   "sc_bytes": counters.get("sc.bytes.read", 0),
                   "shm_reads": sum(counters.get(k, 0) for k in SHM_KEYS
                                    if k.startswith("read.shm")),
                   "recv": {k: pool1[k] - pool0[k] if k in (
                       "acquired", "reused") else pool1[k] for k in pool1},
                   "workers_bytes_sent": [
                       w.metrics.counters.get("rpc.bytes_sent", 0) - s0
                       for w, s0 in zip((wa, wb), sent0)]}
            log(f"wire (b) {how}: {SHARDS} shards into device memory through "
                f"the pinned staging ring in {secs:.3f}s (awaiting the "
                f"reads {split['read']:.3f}s, staging {split['stage']:.3f}s), "
                f"{out['read_gibs_into_device']:.3f} GiB/s against phase 3's "
                f"link_gibs {link_gibs:.3f}; pf.bytes.read "
                f"{out['pf_bytes']:,}, read.zero_copy_bytes "
                f"{out['zero_copy_bytes']:,}, short circuit "
                f"{out['sc_bytes']}, shm reads {out['shm_reads']}; the "
                f"registered pool {out['recv']}; the workers sent "
                f"{out['workers_bytes_sent']}")
            if out["tokens_unequal"]:
                raise AssertionError(f"wire (b) {how}: "
                                     f"{out['tokens_unequal']} tokens unequal")
            if out["sc_bytes"] or out["shm_reads"]:
                raise AssertionError(f"wire (b) {how}: bytes by the short "
                                     f"circuit or shm: {counters}")
            return out

        mark = len(WRITER_BREAKS)
        res["b"] = {how: one_pass(how)
                    for how in ("read_all", "pread_view", "read_range")}
        if res["b"]["pread_view"]["pf_bytes"] <= 0 or \
                res["b"]["read_all"]["pf_bytes"] != 0:
            raise AssertionError(f"wire (b): pf.bytes.read "
                                 f"{[r['pf_bytes'] for r in res['b'].values()]}")
        res["b"]["link_gibs"] = link_gibs

        # (c) the window after a flip, over shard 1 (on the other worker)
        flips = np.random.default_rng(seed + 23)
        host = tokens[shard_tokens:2 * shard_tokens].view(np.uint8)

        async def flipped():
            async with port_client(master, **no_sc) as c:
                r = await c.open(paths[1])
                seq, reads = [], 0
                for _ in range(WIRE_FLIPS):
                    n = WIRE_RUN_READ
                    pos = int(flips.integers(
                        0, (r.len - WIRE_RUN * n) // n + 1)) * n
                    for k in range(WIRE_RUN):
                        off = pos + k * n
                        v = await r.pread_view(off, n)
                        reads += 1
                        if not np.array_equal(v, host[off:off + n]):
                            raise AssertionError(f"wire (c): {off}")
                    seq.append(r.detector.sequential)
                    for _ in range(WIRE_PROBES):
                        off = int(flips.integers(0, r.len - WIRE_PROBE))
                        v = await r.pread_view(off, WIRE_PROBE)
                        reads += 1
                        if not np.array_equal(v, host[off:off + WIRE_PROBE]):
                            raise AssertionError(f"wire (c): probe {off}")
                    seq.append(r.detector.sequential)
                await r.close()
                return seq, reads, dict(c.counters)
        seq, reads, counters = asyncio.run(flipped())
        if counters.get("sc.bytes.read", 0):
            raise AssertionError(f"wire (c): short circuit {counters}")
        res["c"] = {"sequential_after_each_run": seq, "reads": reads,
                    "pf_bytes": counters.get("pf.bytes.read", 0)}
        log(f"wire (c): {reads} positional reads over {paths[1]}, "
            f"{WIRE_FLIPS} sequential runs of {WIRE_RUN} x "
            f"{WIRE_RUN_READ // 1024} KiB each "
            f"followed by {WIRE_PROBES} random probes of "
            f"{WIRE_PROBE // 1024} KiB, all equal; detector.sequential after "
            f"each run {seq}; pf.bytes.read {res['c']['pf_bytes']:,}")

        # (d) pins (K1), then three flagship steps read through the window
        pins0 = sum(w.metrics.counters.get("blocks.hbm_pinned", 0)
                    for w in (wa, wb))
        cuda_ops.block_checksum.launches = 0
        cycles = 0
        while not all(wa.hbm_holds(b) or wb.hbm_holds(b) for b in blocks) \
                and cycles < 8:
            for name in ("a", "b"):
                workers[name].call(workers[name].worker._promote_once())
            cycles += 1
        k1 = cuda_ops.block_checksum.launches
        pins = sum(w.metrics.counters.get("blocks.hbm_pinned", 0)
                   for w in (wa, wb)) - pins0
        if pins != SHARDS or k1 != pins:
            raise AssertionError(f"wire (d): {cycles} cycles, {pins} pins, "
                                 f"{k1} K1 launches")
        for i, b in enumerate(blocks):
            w = wa if wa.hbm_holds(b) else wb
            if not torch.equal(w.hbm_get(b).view(torch.int32),
                               expect[i * shard_tokens:
                                      (i + 1) * shard_tokens]):
                raise AssertionError(f"wire (d): block {b}'s device copy "
                                     f"differs from its tokens")
        first = tokens[:TRAIN_BATCH * TRAIN_SEQ * UFS_STEPS].reshape(
            UFS_STEPS, TRAIN_BATCH, TRAIN_SEQ)
        seen = []

        def check(b):
            seen.append(bool(torch.equal(b, torch.from_numpy(
                first[len(seen)]).to(dev))))

        async def train_steps():
            stager = PinnedStager(dev)
            nbytes = TRAIN_BATCH * TRAIN_SEQ * 4
            async with port_client(master, **no_sc) as c:
                r = await c.open(paths[0])

                async def take():
                    for k in range(UFS_STEPS):
                        v = await r.pread_view(k * nbytes, nbytes)
                        b = torch.empty(nbytes, dtype=torch.uint8,
                                        device=dev)
                        stager.copy_in(b, v)
                        yield b.view(torch.int32).view(TRAIN_BATCH,
                                                       TRAIN_SEQ)
                try:
                    got = await timed_steps(step, params, take(), check)
                finally:
                    await r.close()
                return got, dict(c.counters)

        for fn in kernels:
            fn.launches = 0
        (step_s, losses), counters = asyncio.run(train_steps())
        launches = {fn.__name__: fn.launches for fn in kernels}
        if seen != [True] * UFS_STEPS or not all(map(math.isfinite, losses)) \
                or set(launches.values()) != {cfg.n_layers * UFS_STEPS} \
                or not counters.get("pf.bytes.read") \
                or counters.get("sc.bytes.read"):
            raise AssertionError(f"wire (d): batches equal {seen}, losses "
                                 f"{losses}, K3 launches {launches}, "
                                 f"counters {counters}")
        res["d"] = dict(cycles=cycles, pins=pins, k1_launches=k1,
                        losses=losses, step_ms=[x * 1e3 for x in step_s],
                        launches=launches,
                        pf_bytes=counters.get("pf.bytes.read", 0))
        log(f"wire (d): {cycles} promote cycles of A and B pinned the "
            f"{pins} shards, each verified by K1 ({k1} launches) and equal "
            f"to its tokens on the card; {UFS_STEPS} flagship steps at "
            f"{TRAIN_BATCH}x{TRAIN_SEQ} on batches read by pread_view "
            f"through the window (pf.bytes.read {res['d']['pf_bytes']:,}), "
            f"each equal to its tokens: losses "
            f"{[round(x, 4) for x in losses]}, step ms "
            f"{[round(x * 1e3, 2) for x in step_s]}; K3 launches {launches}")
        res["breaks_bcd"] = breaks_since(mark, "(b)-(d)")
        del expect

        # (a) behind streams: small reads whose replies queue behind the
        # streams' sendfile chunks on the workers' writers, at the
        # defaults and at one frame a send (the workers' and the client's)
        one = {"send_coalesce_frames": 1}
        res["a_streams"] = {}
        for label, rpc in (("defaults", None),
                           ("send_coalesce_frames 1", one)):
            run = wire_shared(master, paths, [wa, wb], seed + 29, rpc)
            res["a_streams"][label] = run
            log(f"wire (a) behind streams, {label}: {WIRE_STREAMS} tasks "
                f"reading shards whole at {run['stream_gibs']:.3f} GiB/s "
                f"while {WIRE_CALLERS} callers read {WIRE_SMALL} B at "
                f"random offsets for {WIRE_SHARED_S:.0f}s: "
                f"{run['small_reads']} reads, "
                f"{run['small_reads_per_s']:.1f} reads/s, p50 "
                f"{run['p50_ms']:.3f} ms, p99 {run['p99_ms']:.3f} ms; the "
                f"workers' frames a send {run['workers_frames_per_send']:.3f}"
                f" ({run['workers_frames']} frames in {run['workers_sends']}"
                f" sends)")
            if run["breaks"] or run["sc_bytes"] or run["shm_reads"]:
                raise AssertionError(f"wire (a) behind streams {label}: {run}")
        if res["a_streams"]["send_coalesce_frames 1"][
                "workers_frames_per_send"] != 1:
            raise AssertionError("wire (a): send_coalesce_frames = 1 sent "
                                 "more than one frame a send")

        # (a) small calls, on a master restarted on its journal: at the
        # defaults and at one frame a send (the master's and the client's),
        # in turns
        res["a"] = {"defaults": [], "send_coalesce_frames 1": []}
        for n, (label, rpc) in enumerate(
                (("defaults", None), ("send_coalesce_frames 1", one),
                 ("send_coalesce_frames 1", one), ("defaults", None)),
                start=1):
            if proc is not None:                 # (b)-(d)'s master
                stop_master(proc)
                res["master_breaks_bcd"] = breaks_since(0, "(b)-(d)", [
                    b for b in proc.breaks if not b[2]])
                proc = None
            conf = master_conf(base, port, REP_LOST_MS, "robin", rpc=rpc)
            proc, _ = start_master(base, conf, n)
            run = wire_calls(master, paths, rpc)
            stop_master(proc)
            run["master_breaks"] = proc.breaks
            proc = None
            with open(os.path.join(base, f"master{n}.json")) as f:
                dump = json.load(f)
            run["master_send_batch_frames"] = dump["send_batch_frames"]
            run["master_rpc"] = {k: dump["rpc"].get(k) for k in (
                "file_status", "get_block_locations")}
            run["master_reply_send"] = dump["reply_send"]
            res["a"][label].append(run)
            mb = dump["send_batch_frames"] or {}
            log(f"wire (a) {label}: {WIRE_CALLERS} callers, GET_FILE_STATUS "
                f"and GET_BLOCK_LOCATIONS for {WIRE_CALL_S:.0f}s: "
                f"{run['calls']} calls, {run['calls_per_s']:.1f} calls/s, "
                f"p50 {run['p50_ms']:.3f} ms, p99 {run['p99_ms']:.3f} ms; "
                f"the master's frames a send {mb.get('mean', 0):.3f} (max "
                f"{mb.get('max')}, {mb.get('sends')} sends), the client's "
                f"{run['client_frames_per_send']:.3f}; the master's dispatch "
                f"p50/mean ms "
                f"{ {k: (round(v['p50_ms'], 3), round(v['mean_ms'], 3)) for k, v in run['master_rpc'].items() if v} }"
                f", of which the reply's send p50/mean ms "
                f"{round(run['master_reply_send']['p50_ms'], 4)}/"
                f"{round(run['master_reply_send']['mean_ms'], 4)}")
            bad = run["breaks"] + [b for b in run["master_breaks"]
                                   if not b[2]]
            if bad:
                raise AssertionError(f"wire (a) {label}: writers broke: "
                                     f"{bad}")
        res["phase_s"] = time.perf_counter() - t_phase
        log(f"wire: the phase {res['phase_s']:.1f}s")
    finally:
        for w in workers.values():
            w.stop()
        if proc is not None:
            stop_master(proc)
        shutil.rmtree(base, ignore_errors=True)
    res["k1_launches"] = res["d"]["k1_launches"]
    res["launches"] = res["d"]["launches"]
    return res


def launch_worker(master: str, root: str, name: str, tier_bytes: int,
                  coords=()):
    """``python -m curvine_tpu_torch.worker --conf <root>/<name>.toml`` in
    its own process, not waited for (``worker_line``): a mem tier of
    ``tier_bytes`` under ``root/name``, no tier-0, 64 MiB blocks, the
    heartbeat of the in-process workers, ICI coordinates ``coords``."""
    conf = os.path.join(root, f"{name}.toml")
    with open(conf, "w") as f:
        f.write(f"""[worker]
hostname = "127.0.0.1"
rpc_port = 0
heartbeat_ms = {WORKER_HEARTBEAT_MS}
promote_interval_ms = 0
hbm_capacity = 0
ici_coords = {json.dumps(list(coords))}
[[worker.tiers]]
storage_type = "mem"
dir = "{os.path.join(root, name, 'mem')}"
capacity = {tier_bytes}
[client]
master_addrs = {json.dumps(_addrs(master))}
block_size = {BLOCK}
""")
    err = open(os.path.join(root, f"{name}.err"), "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "curvine_tpu_torch.worker", "--conf", conf],
        cwd=HERE, stdout=subprocess.PIPE, stderr=err)
    err.close()
    proc.launched = time.perf_counter()
    return proc


def worker_line(proc, root: str, name: str) -> dict:
    """``launch_worker``'s wait for the worker's JSON line (address,
    worker id, pid, ``jax_free``), with ``start_s``, the seconds from the
    launch; raises when it does not come within MASTER_START_S or the
    worker loaded a module of JAX or of the JAX package."""
    import select
    ready, _, _ = select.select([proc.stdout], [], [], MASTER_START_S)
    line = proc.stdout.readline() if ready else b""
    if not line:
        stop_worker_proc(proc)
        with open(os.path.join(root, f"{name}.err"), "rb") as f:
            tail = f.read()[-4000:].decode(errors="replace")
        raise RuntimeError(f"the port's worker {name} did not start:\n{tail}")
    info = json.loads(line)
    info["start_s"] = time.perf_counter() - proc.launched
    if info.get("jax_free") is not True:
        stop_worker_proc(proc)
        raise AssertionError(f"the port's worker {name} (pid {info['pid']}) "
                             f"loaded a module of JAX or of the JAX package")
    return info


def stop_worker_proc(proc) -> None:
    """Stop a worker process: woken first (SIGCONT) if it was stopped,
    then SIGTERM, and SIGKILL after 60 s."""
    if proc.poll() is None:
        os.kill(proc.pid, signal.SIGCONT)
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    proc.stdout.close()


def watch_breaker(health, addr: str, marks: dict) -> None:
    """Record ``addr``'s breaker transitions on the client's board as
    they happen, wall clock (the spans' clock): each trip to OPEN in
    ``marks["opens"]``, each probe a HALF_OPEN breaker lets by in
    ``marks["half_opens"]``."""
    from curvine_tpu_torch.client.health import HALF_OPEN
    marks["opens"], marks["half_opens"] = [], []
    fail, allow = health.fail, health.allow

    def trips() -> int:
        return health.snapshot().get(addr, {}).get("trips", 0)

    def fail_watched(a, *args, **kw):
        before = trips() if a == addr else 0
        fail(a, *args, **kw)
        if a == addr and trips() > before:
            marks["opens"].append(time.time())

    def allow_watched(a):
        half = a == addr and health.state(a) == HALF_OPEN
        ok = allow(a)
        if half and ok:
            marks["half_opens"].append(time.time())
        return ok
    health.fail, health.allow = fail_watched, allow_watched


def trace_tree_faults(spans: list[dict], root_op: str) -> list[str]:
    """What is wrong with one traced read's spans, by the reference's
    acceptance trace (tests/test_obs.py:233): at least 4 spans from the
    client, the master and a worker, one root named ``root_op``, each
    master span under a client span, each worker span under a client
    ``read_block``, every span inside its parent's interval within
    TRACE_NEST_S. Empty when nothing is."""
    out = []
    comps = {s["component"] for s in spans}
    if len(spans) < 4 or not {"client", "master", "worker"} <= comps:
        out.append(f"{len(spans)} spans from {sorted(comps)}")
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] not in by_id]
    if len(roots) != 1 or roots[0]["op"] != root_op:
        out.append(f"roots {[(r['component'], r['op']) for r in roots]}")
    for s in spans:
        p = by_id.get(s["parent"])
        if p is None:
            continue
        if s["component"] == "master" and p["component"] != "client":
            out.append(f"master {s['op']} under {p['component']}")
        if s["component"] == "worker" and \
                (p["component"], p["op"]) != ("client", "read_block"):
            out.append(f"worker {s['op']} under {p['component']} {p['op']}")
        if s["dur"] < 0 or s["start"] < p["start"] - TRACE_NEST_S or \
                s["start"] + s["dur"] > p["start"] + p["dur"] + TRACE_NEST_S:
            out.append(f"{s['component']} {s['op']} outside "
                       f"{p['component']} {p['op']}")
    return out


def phase_trace(dev: torch.device, root: str, seed: int, params: dict, step,
                link_gibs: float) -> dict:
    """Tracing, the reader's deadlines and the metrics flush, with phase
    ufs's parameters and step: a master of the phase's own on the KV store
    (the ``ici`` placement, TRACE_LOST_MS: the hung worker stays
    listed), worker A in this process with a tier-0 on the card at ICI
    (0, 0) and worker B in a process of its own (``python -m
    curvine_tpu_torch.worker``, no tier-0) at (1, 0), launched before A
    so that its interpreter starts meanwhile; phase feed's shape written
    to /trace/train at two replicas by a client at (1, 0), so every
    block is on B and then A, and a reader with closed breakers tries B
    first. Every reading client has the short circuit off and
    ``op_deadline_ms`` TRACE_BUDGET_MS.

    (a) The cost of tracing: ``GpuTrainFeed`` at phase 4's batch over one
    epoch at the ``[obs]`` defaults and one with the client's and A's
    tracer off, twice in turns; batches/s of each (no claim). (b) One
    traced read: a shard (its first replica B's) read whole into
    device memory under a sampled root, then ``get_trace`` (the master's
    GET_SPANS collect, which reaches B's process): one tree across the
    client, the master and B, each span inside its parent's interval
    (``trace_tree_faults``), printed. (c) The hung host: the feed epoch
    after epoch; after TRACE_STOP_AFTER batches B gets SIGSTOP, and
    SIGCONT TRACE_WEDGE_S later; the feed runs to the end of the epoch
    in which B came back. Each shard read is a sampled trace of its own;
    a read that paid a wedged hop (a client ``read_block`` to B in error)
    is shown with its seconds and its tree; the wedged hops before B's
    breaker opened, while it was open and after it half-opened, split
    at the breaker's own transitions (its trips and its half-open
    permits, recorded as they happen), the longest wait for one batch,
    the batches/s across the wedge. (d) The shards pinned into
    A's tier-0 by promote cycles, before each of which the shards not
    held yet are read WORKER_MIN_READS times from A (B's breaker held
    open in that client): K1 against the host hash, launches equal to
    the pins, each device copy equal to its tokens; three flagship steps on
    batches read by ``pread_view`` through the budgeted reader (K3). (e)
    Every client closed (each flushes at close), the master stopped: its
    ``--metrics-out`` dump's ``client.<name>`` counters equal the sums of
    the phase's clients' own, ``read.zero_copy_bytes`` among them.

    Fails if a read through the wedge took longer than TRACE_BUDGET_MS +
    TRACE_SLACK_S, no read paid a wedged hop, a batch differs from its
    tokens, a caller saw an error, or a check of (b), (d) or (e) fails.
    B is woken before it is stopped; every process is stopped and the
    directory removed, however the phase ends."""
    from curvine_tpu_torch.gpu import cuda_ops, flash
    from curvine_tpu_torch.gpu.ingest import PinnedStager
    from curvine_tpu_torch.gpu.loader import GpuTrainFeed, write_token_shards
    from curvine_tpu_torch.obs.trace import assemble_tree, render_tree
    base = os.path.join(root, "trace")
    os.makedirs(base)
    res: dict = {"link_gibs": link_gibs}
    pa = proc = bproc = None
    mark = len(CLIENT_COUNTERS)
    tokens = ufs_tokens(seed, SHARDS, 0x74726163)
    shard_tokens = SHARD_BYTES // 4
    per_batch = BATCH * SEQ
    kernels = [getattr(flash, nm) for nm in K3_NAMES]
    cfg = _flagship()
    t_phase = time.perf_counter()
    budgeted = dict(short_circuit=False, op_deadline_ms=TRACE_BUDGET_MS)
    try:
        conf = master_conf(base, lost_ms=TRACE_LOST_MS, policy="ici")
        proc, info = start_master(base, conf)
        master = info["addr"]
        # B's interpreter starts while A does
        bproc = launch_worker(master, base, "b", TRACE_TIER_BYTES,
                              coords=(1, 0))
        pa = PortWorker(master, os.path.join(base, "a"), TRACE_TIER_BYTES,
                        dev, coords=(0, 0), hbm_bytes=TRACE_HBM_BYTES)
        wa = pa.worker
        binfo = worker_line(bproc, base, "b")
        res["b_start_s"] = binfo["start_s"]
        b_id, b_addr = binfo["worker_id"], binfo["addr"]
        await_live(master, [wa.worker_id, b_id], phase="trace")
        log(f"trace: a master and two of the port's workers, A "
            f"({wa.worker_id}, this process, a tier-0) and B ({b_id}, pid "
            f"{binfo['pid']}, its own process, started in "
            f"{res['b_start_s']:.3f}s; modules of JAX or the JAX package "
            f"loaded there: none)")

        async def write():
            # written near B: the ici placement lists B first, so that
            # a reader with closed breakers tries B first
            async with port_client(master, coords=(1, 0), replicas=2) as c:
                t = time.perf_counter()
                paths = await write_token_shards(c, "/trace/train", tokens,
                                                 shard_tokens)
                return paths, time.perf_counter() - t
        paths, res["write_s"] = asyncio.run(write())
        locs = [_block_locs(master, p) for p in paths]
        blocks = [x[0][0] for x in locs]
        firsts = [x[0][1][0] for x in locs]
        if any(len(x) != 1 or x[0][1] != [b_id, wa.worker_id]
               for x in locs):
            raise AssertionError(f"trace: {locs}: not one block a shard on "
                                 f"B, then A")
        log(f"trace: {SHARDS} shards of {SHARD_BYTES // MiB} MiB written "
            f"at two replicas in {res['write_s']:.3f}s; each block's first "
            f"replica {firsts}")
        expect = torch.from_numpy(tokens).to(dev)
        n_expect = tokens.size // per_batch

        # (a) the cost of tracing, in turns
        res["a"] = {"traced": [], "untraced": []}
        for traced in (True, False, True, False):
            wa.tracer.enabled = traced

            async def epoch(traced=traced):
                async with port_client(master, obs={"enabled": traced},
                                       **budgeted) as c:
                    feed = GpuTrainFeed(c, "/trace/train", BATCH, SEQ,
                                        depth=2, device=dev)
                    return await drive_feed(feed, expect, dev)
            n, bad, secs = asyncio.run(epoch())
            if n != n_expect or bad:
                raise AssertionError(f"trace (a): {n}/{n_expect} batches, "
                                     f"{bad} tokens differ")
            res["a"]["traced" if traced else "untraced"].append(n / secs)
        wa.tracer.enabled = True
        rates = {k: [round(x, 1) for x in v] for k, v in res["a"].items()}
        log(f"trace (a): the feed over one epoch, batches/s with tracing "
            f"at the [obs] defaults {rates['traced']}, with the client's "
            f"and A's tracer off {rates['untraced']} (in turns)")

        # (b) one traced read, its tree across client, master and B
        ib = firsts.index(b_id)

        async def traced_read():
            stager = PinnedStager(dev)
            dst = torch.empty(SHARD_BYTES, dtype=torch.uint8, device=dev)
            async with port_client(master, **budgeted) as c:
                t = time.perf_counter()
                with c.tracer.start_trace("e2e_read", sampled=True) as sp:
                    r = await c.open(paths[ib])
                    try:
                        v = await r.read_all()
                    finally:
                        await r.close()
                stager.copy_in(dst, np.frombuffer(v, dtype=np.uint8))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                t = time.perf_counter()
                spans = await c.get_trace(sp.ctx.trace_id)
                return sp.ctx.trace_id, spans, secs, \
                    time.perf_counter() - t, dst
        tid, spans, secs, collect_s, dst = asyncio.run(traced_read())
        equal = torch.equal(dst.view(torch.int32), expect[
            ib * shard_tokens:(ib + 1) * shard_tokens])
        del dst
        faults = trace_tree_faults(spans, "e2e_read")
        by_id = {s["span_id"]: s for s in spans}
        from_b = [s for s in spans if s["component"] == "worker"
                  and by_id.get(s["parent"], {}).get("attrs", {}).get(
                      "addr") == b_addr]
        res["b"] = {"read_s": secs, "collect_s": collect_s,
                    "spans": len(spans), "from_b": len(from_b),
                    "components": sorted({s["component"] for s in spans}),
                    "ops": sorted({f"{s['component']}:{s['op']}"
                                   for s in spans}), "faults": faults}
        log(f"trace (b): shard {ib} (first replica B) into device memory "
            f"in {secs:.3f}s under a sampled root, then get_trace in "
            f"{collect_s:.3f}s: {len(spans)} spans, {len(from_b)} of them "
            f"from B's process; the tree:\n"
            + render_tree(assemble_tree(spans), tid))
        if faults or not from_b or not equal:
            raise AssertionError(f"trace (b): {faults}, spans from B "
                                 f"{len(from_b)}, bytes equal {equal}")

        # (c) the hung host under the feed
        async def wedged_feed():
            loop = asyncio.get_running_loop()
            reads, stamps, marks = [], [], {}

            def resume():
                os.kill(bproc.pid, signal.SIGCONT)
                marks["cont"] = time.perf_counter()

            async with port_client(master, **budgeted) as c:
                watch_breaker(c.health, b_addr, marks)
                bad = torch.zeros((), dtype=torch.int64, device=dev)
                epochs = 0
                while "cont" not in marks:
                    feed = GpuTrainFeed(c, "/trace/train", BATCH, SEQ,
                                        depth=2, device=dev)
                    fetch = feed.source._fetch

                    async def timed_fetch(shard, fetch=fetch):
                        t = time.perf_counter()
                        with c.tracer.start_trace(
                                "feed_read", attrs={"shard": shard},
                                sampled=True) as sp:
                            out = await fetch(shard)
                        reads.append({"shard": shard, "t": t,
                                      "s": time.perf_counter() - t,
                                      "trace_id": sp.ctx.trace_id})
                        return out
                    feed.source._fetch = timed_fetch
                    n = 0
                    async for b in feed:
                        stamps.append(time.perf_counter())
                        bad += (b != expect[n * per_batch:(n + 1)
                                            * per_batch].view(BATCH, SEQ)
                                ).sum()
                        n += 1
                        if len(stamps) == TRACE_STOP_AFTER:
                            os.kill(bproc.pid, signal.SIGSTOP)
                            marks["stop"] = time.perf_counter()
                            marks["stop_wall"] = time.time()
                            loop.call_later(TRACE_WEDGE_S, resume)
                    if n != n_expect:
                        raise AssertionError(f"trace (c): epoch {epochs}: "
                                             f"{n}/{n_expect} batches")
                    epochs += 1
                torch.cuda.synchronize()
                # B is back: every read's trace, by the master's collect
                for rd in reads:
                    rd["spans"] = await c.get_trace(rd["trace_id"])
                return reads, stamps, marks, int(bad), epochs, \
                    c.health.snapshot().get(b_addr), c.health.fail_threshold
        t = time.perf_counter()
        reads, stamps, marks, bad, epochs, breaker, threshold = \
            asyncio.run(wedged_feed())
        feed_s = time.perf_counter() - t
        hops = []
        for rd in reads:
            rd["wedged"] = sorted(
                (s for s in rd["spans"] if s["component"] == "client"
                 and s["op"] == "read_block" and s["status"] == "error"
                 and s["attrs"].get("addr") == b_addr),
                key=lambda s: s["start"])
            rd["served_by_a"] = any(
                s["component"] == "client" and s["op"] == "read_block"
                and s["status"] == "ok" and s["attrs"].get("addr") == wa.addr
                for s in rd["spans"])
            hops += rd["wedged"]
        hops.sort(key=lambda s: s["start"])
        wedged = [rd for rd in reads if rd["wedged"]]
        # the hops split at B's breaker's first trip and its first
        # half-open permit after that trip, wall clock as the spans'
        opened = min(marks["opens"] or [math.inf])
        half = min([t for t in marks["half_opens"] if t > opened]
                   or [math.inf])
        gaps = [b - a for a, b in zip(stamps, stamps[1:])]
        in_wedge = [x for x in stamps if marks["stop"] <= x <= marks["cont"]]
        res["c"] = {
            "epochs": epochs, "batches": len(stamps), "reads": len(reads),
            "feed_s": feed_s, "tokens_unequal": bad,
            "wedge_s": marks["cont"] - marks["stop"],
            "wedged_reads": [{"shard": rd["shard"], "s": rd["s"],
                              "hop_s": [h["dur"] for h in rd["wedged"]],
                              "errors": [h["attrs"].get("error")
                                         for h in rd["wedged"]],
                              "served_by_a": rd["served_by_a"]}
                             for rd in wedged],
            "fail_threshold": threshold,
            "hops_before_open": sum(h["start"] < opened for h in hops),
            "hops_while_open": sum(opened <= h["start"] < half
                                   for h in hops),
            "hops_after_half_open": sum(h["start"] >= half for h in hops),
            "hop_at_s": [h["start"] - marks["stop_wall"] for h in hops],
            "opens_at_s": [t - marks["stop_wall"] for t in marks["opens"]],
            "half_opens_at_s": [t - marks["stop_wall"]
                                for t in marks["half_opens"]],
            "breaker": breaker,
            "longest_batch_wait_s": max(gaps),
            # where the longest wait fell, and the shard reads that were
            # in flight across it: (start, seconds), s after the SIGSTOP
            "longest_batch_wait_ends_at_s":
                stamps[gaps.index(max(gaps)) + 1] - marks["stop"],
            "reads_across_longest_wait": [
                (rd["t"] - marks["stop"], rd["s"]) for rd in reads
                if rd["t"] < stamps[gaps.index(max(gaps)) + 1]
                and rd["t"] + rd["s"] > stamps[gaps.index(max(gaps))]],
            "longest_batch_wait_in_wedge_s": max(
                [b - a for a, b in zip(in_wedge, in_wedge[1:])] or [0.0]),
            "batches_per_s_across_wedge":
                len(in_wedge) / (marks["cont"] - marks["stop"]),
            "read_s_p50": float(np.median([rd["s"] for rd in reads]))}
        rc = res["c"]
        paid = [(r["shard"].rsplit("/", 1)[1], round(r["s"], 3),
                 [round(h, 3) for h in r["hop_s"]])
                for r in rc["wedged_reads"]]
        across = [(round(a, 3), round(b, 3))
                  for a, b in rc["reads_across_longest_wait"]]
        log(f"trace (c): B (pid {bproc.pid}) stopped after "
            f"{TRACE_STOP_AFTER} batches for {rc['wedge_s']:.3f}s under the "
            f"feed: {rc['batches']} batches over {epochs} epochs in "
            f"{feed_s:.3f}s, {rc['reads']} shard reads (p50 "
            f"{rc['read_s_p50']:.3f}s); {len(wedged)} reads paid a wedged "
            f"hop (shard, s, the wedged hop's s): {paid}; wedged hops "
            f"{rc['hops_before_open']} before B's breaker opened (threshold "
            f"{threshold}), {rc['hops_while_open']} while it was open, "
            f"{rc['hops_after_half_open']} after it half-opened "
            f"(at {[round(x, 3) for x in rc['hop_at_s']]} s after the "
            f"SIGSTOP; it opened at "
            f"{[round(x, 3) for x in rc['opens_at_s']]} s, let a half-open "
            f"probe by at {[round(x, 3) for x in rc['half_opens_at_s']]} s, "
            f"B resumed at {rc['wedge_s']:.3f} s), the breaker {breaker}; "
            f"the longest wait for one "
            f"batch {rc['longest_batch_wait_s']:.3f}s, ending "
            f"{rc['longest_batch_wait_ends_at_s']:.3f}s after the SIGSTOP "
            f"(the reads across it, start and s: {across}), "
            f"{rc['batches_per_s_across_wedge']:.1f} batches/s across the "
            f"wedge; every batch equal to its tokens: {bad == 0}")
        if wedged:
            rd = wedged[0]
            log("trace (c): the first wedged read's trace:\n"
                + render_tree(assemble_tree(rd["spans"]), rd["trace_id"]))
        slow = [r for r in rc["wedged_reads"]
                if r["s"] > TRACE_BUDGET_MS / 1000 + TRACE_SLACK_S
                or not r["served_by_a"]]
        if not wedged or slow or bad:
            raise AssertionError(f"trace (c): wedged reads {len(wedged)}, "
                                 f"over the budget or not served by A "
                                 f"{slow}, tokens unequal {bad}")

        # (d) pins into A's tier-0 (K1), then three steps (K3)
        async def heat_a(todo: list[str]):
            async with port_client(master, **budgeted) as c:
                for _ in range(3):        # B's breaker held open: A serves
                    c.health.fail(b_addr, worker_id=b_id)
                for _ in range(WORKER_MIN_READS):
                    for p in todo:
                        r = await c.open(p)
                        await r.read_all()
                        await r.close()
        pins0 = wa.metrics.counters.get("blocks.hbm_pinned", 0)
        cuda_ops.block_checksum.launches = 0
        cycles = 0
        while not all(wa.hbm_holds(b) for b in blocks) and cycles < 8:
            # a cycle pins at most PIN_BUDGET and halves the heat of what
            # it leaves: the blocks not held yet are read again first
            asyncio.run(heat_a([p for p, b in zip(paths, blocks)
                                if not wa.hbm_holds(b)]))
            pa.call(wa._promote_once())
            cycles += 1
        k1 = cuda_ops.block_checksum.launches
        pins = wa.metrics.counters.get("blocks.hbm_pinned", 0) - pins0
        if pins != SHARDS or k1 != pins:
            raise AssertionError(f"trace (d): {cycles} cycles, {pins} pins, "
                                 f"{k1} K1 launches")
        for i, b in enumerate(blocks):
            if not torch.equal(wa.hbm_get(b).view(torch.int32),
                               expect[i * shard_tokens:
                                      (i + 1) * shard_tokens]):
                raise AssertionError(f"trace (d): block {b}'s device copy "
                                     f"differs from its tokens")
        first = tokens[:TRAIN_BATCH * TRAIN_SEQ * UFS_STEPS].reshape(
            UFS_STEPS, TRAIN_BATCH, TRAIN_SEQ)
        seen = []

        def check(b):
            seen.append(bool(torch.equal(b, torch.from_numpy(
                first[len(seen)]).to(dev))))

        async def train_steps():
            stager = PinnedStager(dev)
            nbytes = TRAIN_BATCH * TRAIN_SEQ * 4
            async with port_client(master, **budgeted) as c:
                r = await c.open(paths[0])

                async def take():
                    for k in range(UFS_STEPS):
                        v = await r.pread_view(k * nbytes, nbytes)
                        b = torch.empty(nbytes, dtype=torch.uint8,
                                        device=dev)
                        stager.copy_in(b, v)
                        yield b.view(torch.int32).view(TRAIN_BATCH,
                                                       TRAIN_SEQ)
                try:
                    return await timed_steps(step, params, take(), check)
                finally:
                    await r.close()

        for fn in kernels:
            fn.launches = 0
        step_s, losses = asyncio.run(train_steps())
        launches = {fn.__name__: fn.launches for fn in kernels}
        if seen != [True] * UFS_STEPS or not all(map(math.isfinite, losses)) \
                or set(launches.values()) != {cfg.n_layers * UFS_STEPS}:
            raise AssertionError(f"trace (d): batches equal {seen}, losses "
                                 f"{losses}, K3 launches {launches}")
        res["d"] = dict(cycles=cycles, pins=pins, k1_launches=k1,
                        losses=losses, step_ms=[x * 1e3 for x in step_s],
                        launches=launches)
        log(f"trace (d): {cycles} promote cycles of A pinned the {pins} "
            f"shards, each verified by K1 ({k1} launches) and equal to its "
            f"tokens on the card; {UFS_STEPS} flagship steps at "
            f"{TRAIN_BATCH}x{TRAIN_SEQ} on batches read by pread_view "
            f"under the {TRACE_BUDGET_MS} ms budget, each equal to its "
            f"tokens: losses {[round(x, 4) for x in losses]}, step ms "
            f"{[round(x * 1e3, 2) for x in step_s]}; K3 launches "
            f"{launches}")

        # (e) the flush: every client closed, the master's dump
        stop_master(proc)
        proc = None
        with open(os.path.join(base, "master0.json")) as f:
            dumped = json.load(f)["counters"]
        mine: dict = {}
        for cnt in CLIENT_COUNTERS[mark:]:
            for k, v in cnt.items():
                mine[k] = mine.get(k, 0) + v
        differ = {k: (v, dumped.get(f"client.{k}")) for k, v in mine.items()
                  if v and dumped.get(f"client.{k}") != v}
        res["e"] = {"clients": len(CLIENT_COUNTERS) - mark,
                    "zero_copy_bytes": mine.get("read.zero_copy_bytes", 0),
                    "master_zero_copy_bytes": dumped.get(
                        "client.read.zero_copy_bytes"),
                    "client_counters": sorted(
                        k for k in dumped if k.startswith("client.")),
                    "differ": differ}
        log(f"trace (e): {res['e']['clients']} clients flushed at close; the "
            f"master's dump: client.read.zero_copy_bytes "
            f"{res['e']['master_zero_copy_bytes']:,} against the clients' "
            f"{res['e']['zero_copy_bytes']:,}; its client.* counters "
            f"{res['e']['client_counters']}")
        if differ or not res["e"]["zero_copy_bytes"]:
            raise AssertionError(f"trace (e): the master's client.* "
                                 f"counters differ from the clients': "
                                 f"{differ}")
        res["phase_s"] = time.perf_counter() - t_phase
        log(f"trace: the phase {res['phase_s']:.1f}s")
    finally:
        if bproc is not None:
            stop_worker_proc(bproc)
        if pa is not None:
            pa.stop()
        if proc is not None:
            stop_master(proc)
        shutil.rmtree(base, ignore_errors=True)
    res["k1_launches"] = res["d"]["k1_launches"]
    res["launches"] = res["d"]["launches"]
    return res


# the cluster phase now running (``main``'s ``tallied``), named on the
# last line of standard error when the run fails
RUNNING: dict = {"phase": None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from curvine_tpu_torch.device import default_device
    from curvine_tpu_torch.gpu import cuda_ops

    dev = default_device()
    # the plain versions' f32 products in full f32, as stated
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_name_and_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card})")
    rng = np.random.default_rng(args.seed)
    results = {"card": card, "seed": args.seed}

    def tallied(fn, *a):
        """``fn(*a)``, its result (the first, when a tuple) given the
        shared-memory counters of the port clients it made and the
        writers that broke meanwhile."""
        mark, breaks = len(CLIENT_COUNTERS), len(WRITER_BREAKS)
        RUNNING["phase"] = fn.__name__
        out = fn(*a)
        RUNNING["phase"] = None
        first = out[0] if isinstance(out, tuple) else out
        first["shm_reads"] = shm_tally(mark)
        first["writer_breaks"] = WRITER_BREAKS[breaks:]
        return out
    count_writer_breaks()
    results["build"] = phase_build()
    results["kernel"] = phase_kernel(rng, dev)
    need = N_BLOCKS * BLOCK + SHARDS * SHARD_BYTES + WORKER_TIER_BYTES \
        + 2 * ICI_TIER_BYTES + 3 * REP_TIER_BYTES + UFS_PHASE_BYTES \
        + RECOVER_PHASE_BYTES + DRAIN_PHASE_BYTES + EC_PHASE_BYTES \
        + KV_PHASE_BYTES + HA_PHASE_BYTES + SHM_PHASE_BYTES \
        + WIRE_PHASE_BYTES + TRACE_PHASE_BYTES
    root = pick_data_dir(need)
    log(f"main: data under {root} (needs {need / GiB:.2f} GiB and 1 GiB "
        f"spare: {N_BLOCKS} blocks and {SHARDS} POSIX shards of 64 MiB, "
        f"the port's worker's mem tier of {WORKER_TIER_BYTES / GiB:.2f} "
        f"GiB, phase ici's two of {ICI_TIER_BYTES / GiB:.2f} GiB, phase "
        f"replicate's three of {REP_TIER_BYTES / GiB:.2f} GiB, phase ufs's "
        f"under-store of {UFS_PHASE_BYTES / GiB:.2f} GiB, phase recover's "
        f"files, replays and heals, at most "
        f"{RECOVER_PHASE_BYTES / GiB:.2f} GiB, phase drain's replicas and "
        f"pulls, at most {DRAIN_PHASE_BYTES / GiB:.2f} GiB, phase ec's "
        f"replicas, cells and rebuilt cells, at most "
        f"{EC_PHASE_BYTES / GiB:.2f} GiB, phase kv's namespace, journals "
        f"and shards, at most {KV_PHASE_BYTES / GiB:.2f} GiB, phase ha's "
        f"shards and three masters' journals and KV directories, at most "
        f"{HA_PHASE_BYTES / GiB:.2f} GiB, phase shm's shards three times, "
        f"at most {SHM_PHASE_BYTES / GiB:.2f} GiB, phase wire's shards, at "
        f"most {WIRE_PHASE_BYTES / GiB:.2f} GiB, phase trace's shards on "
        f"two workers, at most {TRACE_PHASE_BYTES / GiB:.2f} GiB)")
    cluster = pw = None
    try:
        cuda_ops.block_checksum.launches = 0
        results["main"] = phase_main(rng, dev, root)
        results["feed"] = phase_feed(rng, dev, root)
        launches = cuda_ops.block_checksum.launches
        conf = master_conf(root)
        cluster = {"proc": None}
        cluster["proc"], info = start_master(root, conf)
        cluster["info"] = results["cluster"] = info
        master_conf(root, int(info["addr"].rsplit(":", 1)[1]))
        pw = PortWorker(info["addr"], root, WORKER_TIER_BYTES, dev)
        await_port_worker(info["addr"], pw)
        log(f"client: the port's worker {pw.worker.worker_id} serves at "
            f"{pw.worker.addr}, the master's only live worker")
        results["client"] = tallied(phase_client, rng, dev, info["addr"],
                                    results["feed"])
        results["worker"] = tallied(phase_worker, rng, dev, info["addr"],
                                    pw, results["main"]["promote_gibs"])
        results["flash"] = phase_flash(dev, args.seed)
        results["train"], params, step = tallied(
            phase_train, dev, info["addr"], args.seed, results["flash"])
        log(f"train: mfu {results['train']['mfu']:.4f} on {card}")
        results["ufs"] = tallied(phase_ufs, dev, info["addr"], pw, root,
                                 args.seed, params, step, results["client"])
        for name, fn in (("drain", phase_drain), ("ec", phase_ec),
                         ("kv", phase_kv), ("ha", phase_ha)):
            results[name] = tallied(fn, dev, root, args.seed, params, step,
                                    results["client"])
        results["shm"] = tallied(phase_shm, dev, root, args.seed, params,
                                 step, results["main"]["link_gibs"])
        results["wire"] = tallied(phase_wire, dev, root, args.seed, params,
                                  step, results["main"]["link_gibs"])
        results["trace"] = tallied(phase_trace, dev, root, args.seed,
                                   params, step,
                                   results["main"]["link_gibs"])
        del step
        results["ckpt"], probe = tallied(phase_ckpt, dev, info["addr"],
                                         args.seed, params,
                                         results["main"]["link_gibs"], pw)
        results["recover"] = tallied(phase_recover, dev, root, args.seed,
                                     params, results["ckpt"])
        # freed at del, without the collector (ROADMAP C3)
        del params
        held = torch.cuda.memory_allocated(dev)
        results["mesh"] = tallied(phase_mesh, dev, info["addr"], args.seed,
                                  results["train"])
        results["mesh"]["held_before_bytes"] = held
        log(f"mesh: device memory allocated before the phase "
            f"{held / GiB:.2f} GiB (phase 6's parameters and optimizer "
            f"freed at del, no collector run), after it "
            f"{torch.cuda.memory_allocated(dev) / GiB:.2f} GiB")
        results["pipeline"] = phase_pipeline(dev, args.seed)
        results["ring"] = phase_ring(dev, args.seed)
        results["vector"] = tallied(phase_vector, dev, info["addr"],
                                    args.seed)
        results["master"] = tallied(phase_master, root, conf, cluster, pw,
                                    probe, results["ufs"])
        results["ici"] = tallied(phase_ici, rng, dev, root)
        results["replicate"] = tallied(phase_replicate, rng, dev, root)
        # which phases read through the shared-memory plane; none may
        # count a fallback
        shm_by_phase = {k: v["shm_reads"] for k, v in results.items()
                        if isinstance(v, dict) and "shm_reads" in v}
        results["shm_by_phase"] = shm_by_phase
        log(f"shm: the port clients' shared-memory reads by phase "
            f"{shm_by_phase}")
        fell = {k: v for k, v in shm_by_phase.items()
                if v["read.shm_fallbacks"] or v["read.shm_warm_fallbacks"]}
        if fell:
            raise AssertionError(f"shm: reads fell back from the mapping to "
                                 f"the fd path in {fell}")
        # writers that broke mid-frame, by phase: only where the phase
        # stops or kills a worker or a master, or a server's client left
        breaks = {k: v["writer_breaks"] for k, v in results.items()
                  if isinstance(v, dict) and v.get("writer_breaks")}
        results["writer_breaks"] = breaks
        log(f"wire: writers broken mid-frame by phase {breaks}")
        results["reports_kept"] = dict(REPORTS_KEPT)
        log(f"master: replicas a full block report built before they "
            f"landed kept located, by master (ROADMAP C15; the reference "
            f"drops them) {REPORTS_KEPT}")
        bad = {k: [b for b in v if not b[2]] for k, v in breaks.items()
               if k not in BREAKS_EXPECTED}
        if any(bad.values()):
            raise AssertionError(f"writers broke in phases that stop no "
                                 f"worker or master: {bad}")
        # every phase's cluster traffic went through the port's worker
        await_port_worker(info["addr"], pw)
        m = pw.worker.metrics
        results["port_worker"] = {
            "worker_id": pw.worker.worker_id, "counters": dict(m.counters),
            "rpcs": {k: v.count for k, v in m.histograms.items()}}
        log(f"worker: the port's worker {pw.worker.worker_id} served the "
            f"run: {results['port_worker']['rpcs']}; bytes.written "
            f"{m.counters.get('bytes.written', 0):,}, bytes.read (READ_BLOCK)"
            f" {m.counters.get('bytes.read', 0):,}")
        if not m.counters.get("bytes.read") or \
                not m.counters.get("bytes.written"):
            raise AssertionError("the port's worker served no READ_BLOCK or "
                                 "no write")
    finally:
        if pw is not None:
            pw.stop()
        if cluster is not None and cluster["proc"] is not None:
            stop_master(cluster["proc"])
        shutil.rmtree(root, ignore_errors=True)
    from curvine_tpu_torch.master.__main__ import jax_free
    if not jax_free():
        raise AssertionError("this process loaded a module of JAX or of the "
                             "JAX package")
    log("main: no process of this run (this one, where the port's workers "
        "run, and each of the port's masters it started: the cluster's "
        "twice, phase drain's twice, phase ec's, phase kv's twice, phase "
        "ha's three and their two restarts, phase trace's and its worker "
        "B, phase recover's, phase ici's and phase replicate's) loaded a "
        "module of JAX or of the JAX package")
    if launches != results["main"]["pins"]:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{results['main']['pins']} pins")
    wk = results["worker"]
    k = results["kernel"]
    kernels = [{
        "name": "block_checksum", "route": "cuda",
        "source": "curvine_tpu_torch/csrc/checksum.cu",
        "replaces": "curvine_tpu/tpu/pallas_ops.py:27",
        "launches": launches + wk["k1_launches"]
                    + results["ici"]["k1_launches"]
                    + results["replicate"]["k1_launches"]
                    + results["ufs"]["k1_launches"]
                    + results["drain"]["k1_launches"]
                    + results["ec"]["k1_launches"]
                    + results["kv"]["k1_launches"]
                    + results["ha"]["k1_launches"]
                    + results["shm"]["k1_launches"]
                    + results["wire"]["k1_launches"]
                    + results["trace"]["k1_launches"]
                    + results["recover"]["k1_launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]
    replaces = {"flash_fwd": ":758", "flash_bwd_di": ":273",
                "flash_bwd_dkv": ":1121", "flash_bwd_dq": ":1456"}
    for name in K3_NAMES:
        f = results["flash"]["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "curvine_tpu_torch/csrc/flash_attention.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py"
                        + replaces[name] + " (via curvine_tpu/tpu/model.py"
                        ":113)",
            "launches": results["train"]["launches"][name]
                        + results["ufs"]["launches"][name]
                        + results["drain"]["launches"][name]
                        + results["ec"]["launches"][name]
                        + results["kv"]["launches"][name]
                        + results["ha"]["launches"][name]
                        + results["shm"]["launches"][name]
                        + results["wire"]["launches"][name]
                        + results["trace"]["launches"][name]
                        + results["mesh"]["launches"][name]
                        + results["pipeline"]["launches"][name]
                        + results["recover"]["launches"][name],
            "max_abs_err": f["max_abs_err"], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": f["library_ms"]})
    v = results["vector"]
    kernels.append({
        "name": "pq_lut_scan", "route": "cuda",
        "source": "curvine_tpu_torch/csrc/pq_scan.cu",
        "replaces": "curvine_tpu/tpu/pallas_ops.py:111",
        "launches": v["k2_launches"], "max_abs_err": v["max_abs_err"],
        "ms": v["k2"]["ms"], "plain_ms": v["k2"]["plain_ms"],
        "bound_ms": v["k2"]["bound_ms"], "bound_by": "bytes",
        "library_ms": v["k2"]["library_ms"]})
    results["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        # the traceback, then the phase it came from on the last line of
        # standard error, where a log's tail shows it
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: failed in "
              f"{RUNNING['phase'] or 'a phase that runs no cluster'}",
              file=sys.stderr, flush=True)
        sys.exit(1)
