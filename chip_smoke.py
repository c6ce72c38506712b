#!/usr/bin/env python3
"""Drive the ddl_tpu_torch port on one NVIDIA card and check it.

    python3 chip_smoke.py            # the phases below
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of each fit,
                                     # of a device-fabric drain and of an ICI drain

Phase 1 builds the hand-written CUDA kernels from the sources in this
checkout (``ddl_tpu_torch/ops/csrc``, one ``nvcc`` per source, all
started together), the host-registration library beside them and the
native shared-memory ring (``g++``, ``transport/csrc/shm_ring.cpp``),
and identifies the card.
Phase 2 holds each kernel against its plain PyTorch version at the main
path's attention shapes (plus a ragged length, fp32, a call whose query
rows are all masked, and bf16 at head dims 16, 32 and 64), times kernel,
plain version and the PyTorch library call, and computes each kernel's
bound.  The packed-segment kernels K4-K6 get the same treatment on
packed-document ids, plus key ids that leave some queries without a key
and one-token segments.  Every case checks the routes of the forward, the
dQ and the dK/dV backward by their counters: bf16 on the wgmma kernels
(``flash_fwd_sm90.cu``, ``flash_bwd_sm90.cu``), fp32 on the FMA kernels;
that query rows with no key get dq = 0 and keys no query reaches dk = dv
= 0 exactly.  The timed K1/K4 and K2/K5 calls run with the kernel's own
count of the key tiles it loads, the timed K3/K6 calls with its count of
the query tiles it loads: K1's, K2's and K3's are the causal loop's, K4's,
K5's and K6's what their document skip leaves, and the packed rows give
the share; each must equal the count that ``live_tiles`` /
``live_tiles_dkv`` (the skips' rules in Python) give.  Phase 1 prints
the ptxas report of every instantiation and fails if the backward's
library spills or any wgmma kernel's products are serialized.
Phase 3 checks the model's loss and gradients through the kernels
against the dense path on a small input, unpacked and packed, at head_dim
64 and at the widths of examples/train_llama.py (head_dim 32), and the remat
policies against "none" (with their forward launch counts).
Phase 4 is the global shuffle: the exchange kernel K9 held byte for
byte against its plain version (n = 2, 3, 4, 8; fp32, int32, uint8, bf16;
rows that are not a multiple of 16 bytes; an odd exchange count; the
bench geometry), timed at the bench geometry (4 instances, pools of
8192 x 256 fp32, 4096 rows exchanged), with one fabric round's parts on
the host clock, then the path: four THREAD instances in this process,
each a ``DataPusher`` over a pool producer and a
``DistributedDataLoader``, drained in turn over the host exchange, the
one-card ``DeviceExchangeFabric`` twice, and the host exchange again —
the served streams must be byte-identical, mixed across instances, with
no device fallback and one K9 launch per fabric round.
Phase 5 is the ICI ingest tier: the fan-out kernels K7 (broadcast) and K8
(scatter) held byte for byte against their plain versions (n = 2, 3, 4,
8; fp32, int32, uint8, bf16; 7-byte rows; row counts that leave the
reference's chunk pipeline a tail or undercut its chunks; src != 0;
sources off 16-byte alignment; the 2-D views the path hands them; the
full-size (65536, 256) fp32 block), timed there with the ``copy_``
yardstick, then the path: 64 MiB ``ArrayProducer`` windows (32, 2048,
256) fp32 drained in THREAD mode through ``DistributedDataLoader(...,
sharding=..., distribute="ici")`` onto three meshes of positions of
cuda:0 (dp=4 split, dp=2 x fsdp=2 split, dp=4 replicated) and a token
stream at the Llama path's window, every position's shard byte-equal to
its slice of the host window, one K7/K8 launch per window and no
fallback; a ragged geometry through the plain route; and the A/B of the
tier against the plain per-position route.
Phase 6 runs the port's two training paths at Llama-3-8B's published
widths cut to 2 layers, with random weights from a seed: ``Trainer.fit``
over a ``TokenStreamProducer`` window stream (K1-K3), then over a
``PackedTokenProducer`` stream of documents (K4-K6), each twice from the
same parameters: with THREAD producers, then with spawned PROCESS
producers over native shared-memory rings that the loader page-locks
with ``cudaHostRegister``.  Every forward, dQ and dK/dV launch of every
fit must ride the wgmma kernels; every window must take the staged
engine's alias route (its copy to the card sourcing the page-locked
slot) with no fallback, drop, CRC failure or salvage; a PROCESS fit's
rings must be native and registered, its producers must exit 0, and
its losses must equal its THREAD twin's (relative 1e-5).  Each fit
prints its wall-time ms/step and, apart, its time to the first window
(spawn and handshake included), its steady state (every step, from the
first window to the end of the last steps, on the card's clock) and its
teardown.

Phase 7 is recovery in PROCESS mode, on the token cell of phase 6 over 6
windows: a PROCESS fit, then the same fit with one producer SIGKILLed at
its second refill under ``Trainer(watchdog_respawn=True)`` — losses bit-
equal, one respawn, no failure, the same kernel launches, every window
on the alias route — and a THREAD fit with producer 1's window of seq 2
corrupted after its trailer was stamped (a ``FaultPlan``:
``producer.commit`` RING_CORRUPTION) — one replay, losses bit-equal.  Then the global
shuffle of phase 4 with PROCESS producers: four instances over one
``ShmRendezvous`` session, windows onto cuda:0 through the staged engine,
byte-identical to the THREAD tier's drain, and again with instance 0's
producer SIGKILLed mid-exchange and respawned (every round's windows
partition the rows).  It prints the recovery time, the replay's cost and
the drains.

Phase 8 is the path ``examples/train_llama_torch.py`` drives, on the
token cell: the run's ``LoaderConfig``/``TrainConfig`` through ``load()``
(the checkpoint directory from ``DDL_TORCH_CHECKPOINT_DIR``, each field's
source printed); an undisturbed PROCESS fit of 4 windows; the same fit
with async checkpoints, drained by a ``PreemptionGuard`` notice after
window 2 (the ``resilience.notice`` fault site's PREEMPT_NOTICE at the
guard's second poll; the forced final generation, ~17.8 GB, after a disk
check for two), then resumed by a fresh ``Trainer`` — its losses
must equal the undisturbed fit's bit for bit and K1-K3 launch as often;
``Trainer.evaluate(window_stream=True)`` on three held-out streams (K1
only, within a limit of the dense path's loss that two controls, the
causal mask or the softmax scale dropped, must exceed); a greedy 16-token
KV-cache decode whose logits at each step match the no-cache forward;
and the twin example's ``main()`` in THREAD mode.  It prints the
snapshot stall (``resilience.ckpt_submit``), the write
(``resilience.ckpt_write``), the restore and the drain against its
deadline.

Phase 9 is the wire and the fault plan.  (a) The card's wire encode and
decode (``parallel.ici.encode2d``/``decode2d``) against the host
``wire.encode_window``/``decode_window`` on the ICI geometry's (65536,
256) fp32 block: bf16 and int8 byte for byte, payload and scales, and
bit for bit decoded, each timed; K7/K8 on uint8 wire rows 52 and 260
bytes wide.  (b) The ICI tier on the raw, bf16 and int8 wires: phase 5's
64 MiB windows put onto 4 positions of cuda:0 (K8 split, K7 replicated),
every position's values the host decode of the host encode, the drift in
the reference's bounds, ``ici.bytes`` the plan's, no fallback, one
launch per put on uint8 rows, and ms per put.  (c) The slot wire: the
ArrayProducer in bf16 and int8 through ``windows()`` onto cuda:0, THREAD
then PROCESS, the stream the host decode of the host encode bit for bit,
every window decoded and copied through the staging pool (never
aliased), and an encoded slot corrupted after its stamp (``wire.encode``)
replayed.  (d) The exchange lanes at phase 4's geometry: zlib lanes
byte-identical to the raw drain in THREAD (through the device shuffler,
whose tier the forced wire keeps off: no K9 launch) and in PROCESS over a
``ShmRendezvous``; int8 lanes within the drift bound of the raw drain,
whose every round partitions the rows.  (e) The ride-along, driven by
fault plans: a hung THREAD producer respawned under a 10 s stall budget
(the time from the hang to the replacement's first window), replay
exhaustion raising ``IntegrityError`` with two replays, the packed cell's
PROCESS fit through respawns of its crashing producer 1 (plan exported;
losses bit-equal to phase 6's), and a torn checkpoint generation at the
twin example's laptop scale quarantined and the previous one restored.
Run alone: ``python3 -c "import sys, tempfile; sys.path.insert(0, '.');
import chip_smoke as c; card = c.phase_build();
c.phase_wire(tempfile.mkdtemp(), card)"`` (it then makes its own
undisturbed fits).

Phase 10 is file shards through the shard cache.  (a) Phase 6's 4 M
Zipf(1.2) tokens cut into log-normal documents (median 300), written as
``tf.Example`` records with valid masked CRC32C framing in 8 C4-style
TFRecord shards; ``TFRecordTokenProducer`` timed alone over producer 1's
shards (cold with the CRC on, cold with it off, cold into a store with a
spill dir, warm from its RAM tier and from its disk tier; ms per refill,
tokens/s, every stream byte-equal); producer 2's shards warmed by its
``CacheWarmer``; then the token cell's fit three times: THREAD with
``cache=False``, THREAD over the warmed store (no cache miss and no fetch
from source), PROCESS with the producers' stores built from the exported
``LoaderConfig(cache=True, cache_spill_dir=...)`` (no fetch) — losses
bit-equal, K1-K3 on the wgmma route with phase 6's counts, every window
on the alias route, exits 0; a ``LoaderCheckpoint`` captured with the
store adopted through ``adopt_cache_manifest``.  (b) Phase 5's geometry
as 4 ``.npy`` shards of (65536, 256) fp32, drained by
``FileShardProducer`` over ``ThrottledBackend(latency_s=0.02)`` into a
512 MiB RAM store, 2 epochs onto dp=4 positions of cuda:0 (``distribute=
"ici"``): every shard byte-equal to the uncached drain's, one K8 launch a
window, no fallback, one miss a shard; the wait per window cold and warm.
(c) The ladder on those shards: ``CACHE_CORRUPTION`` at
``cache.disk_read`` (quarantined, refetched, the stream unchanged), a
``BACKEND_FETCH_FAIL`` at ``backend.fetch`` (one retry), zlib copies
through ``CodecBackend`` (the raw stream).  ``WebDatasetProducer`` is not
driven: it needs Pillow, which this script does not; the CPU tests hold
it.  Run
alone: ``python3 -c "import sys, tempfile; sys.path.insert(0, '.');
import chip_smoke as c; card = c.phase_build();
c.phase_files(tempfile.mkdtemp(), card)"``.

Phase 11 is the mesh path over positions of cuda:0.  (a) Ring attention
at Llama-3-8B attention width (B = 1, T = 8192, H = 32, Hkv = 8, D = 128,
bf16) over sp = 4 positions, on tokens (K1-K3) and on phase 2's document
ids with documents across the cuts (K4-K6): output and q/k/v grads
against the plain version over the whole T (relative Frobenius <= 2e-2,
computed a block of query rows at a time), the gap to one call over the
whole T beside it, sp^2 = 16 launches of each kernel on the wgmma route,
a nonzero lse cotangent reaching the backward, and each kernel's ms a
call in the ring beside phase 2's.  (b) The sp fit: Llama-3-8B widths
cut to 2 layers, one 8192-token row a step over ``{"sp": 4}`` with
``batch_spec = P(None, "sp")`` (windows by K8, the ring in every layer),
against the same fit with ``mesh=None`` (one K1-K3 call over the 8192
tokens): the largest relative loss gap under ``SP_LOSS_TOL``, which a
control (the ring with ``k_offset`` forced to ``q_offset``) must exceed;
K1-K3 sp^2 times a layer and step; one K8 launch a window.  (c) Phase 6's
token cell over ``{"dp": 4}``: optimizer sharding none, zero1, zero1 with
int8 gradient communication, and with stochastic rounding — zero1's
losses bit-equal to none's, each int8 fit inside ``loss_parity``, the
moments per replica at 1/4, one K8 launch a window; the zero1 fit stopped
after 2 windows (one async generation) and resumed by a fresh Trainer,
bit-equal.  (d) ``quantized_all_reduce`` of 4 x 16 M fp32 values within
the reference's bound of the fp32 mean, and ``DeviceGlobalShuffler`` over
8 rounds at phase 4's geometry, both strategies, every pool
byte-identical to a host oracle built from ``exchange_permutation``.
Run alone: ``python3 -c "import sys, tempfile; sys.path.insert(0, '.');
import chip_smoke as c; card = c.phase_build();
print(c.phase_mesh(tempfile.mkdtemp(), card))"``.

Phase 12 is the pipeline and MULTIHOST.  (a) Llama-3-8B widths cut to 4
layers (T = 2048, global B = 4 in 2 microbatches, phase 6's token
stream, THREAD producers): gpipe on ``{"pp": 2, "dp": 2}``, 1f1b (2
chunks) on the same mesh, tp-resident stages on ``{"pp": 2, "tp": 2}``
(16 query heads over 4 KV heads a tp position), the sequential fallback
on ``{"dp": 2}`` with the same stacked weights, a ``mesh=None`` plain fit
from the same weights and a control with the stages in the wrong order:
gpipe, 1f1b and the fallback within 1e-6 relative of each other, every
pipelined fit within ``PP_LOSS_TOL`` of the plain fit, which the control
must exceed; K1-K3 one launch per live (position, tick, layer), x tp for
the tp-resident stages; one K8 a window on the dp meshes (K7 on the
pp x tp mesh, whose windows land replicated); the idle ticks' share
beside ``bubble_fraction``.  (b) Two gloo processes sharing cuda:0
(``--multihost-child``), each with PROCESS producers under
``mode="multihost"``: ``core`` (every host's producers reach every
process, the dp step across processes, ``DeviceGlobalShuffler`` lanes
across processes keeping the rows and moving some), ``stream``
(``windows()`` over a process-spanning sharding), ``dpsp`` and ``ppdp``
(full-width fits over ``{"dp": 2, "sp": 2}`` and ``{"dp": 2, "pp": 2}``,
2 layers, global B = 4), ``packed`` (K4-K6 at a small width; the two
processes' mask counts must differ in some step), ``evaluate``
(``Trainer.evaluate`` over a process-spanning mesh on the token stream,
K1, and on the documents, K4: both processes return one value), ``ckpt``
(rank 0 writes, every rank restores and fast-forwards); the dpsp, ppdp
and packed losses, and both evaluate values, against the port's
one-process runs over the same global mesh and batches within
``MH_LOSS_TOL``, with the gloo all-reduce's ms and bytes a step and each
process's peak.  ZeRO-1 over the processes (``MH_ZERO1_LEGS``): ``z1``
and ``z1int8``, dpsp's fit with ``optimizer_sharding="zero1"`` (and
``grad_comm="int8"``): one gloo reduce-scatter and one all-gather a
step, each process's moments its replica's.  Gates: z1 bit-equal to
dpsp; z1int8 within ``PARITY_REL_TOL`` of z1 and within ``MH_LOSS_TOL``
of the port's one-process zero1 int8 run; each process's moments the
reference rule's count for one replica; the fp32 gather's bytes over
the int8 gather's in 3.7-4.1; K1-K3 launches a leg equal to dpsp's.  At
the small width: ``i8`` (int8 alone, within ``MH_LOSS_TOL`` of the
one-process int8 run and inside ``loss_parity`` of the fp32 run) and
``z1ckpt`` (ZeRO-1 steps interrupted, the sync checkpoint and an async
generation written with the moment slices gathered to rank 0, restored
on both ranks and run on bit-equal).  Each leg prints its ms/step, the
scatter, gather and all-reduce ms and bytes a step and each process's
peak.  (c) ``shuffle_impl="xla"`` beside
``"ring"`` at phase 4's geometry: byte-identical streams, K9 on the ring
route only, one round's ms each.  Run alone: ``python3 -c "import sys,
tempfile; sys.path.insert(0, '.'); import chip_smoke as c; card =
c.phase_build(); print(c.phase_pipeline(tempfile.mkdtemp(), card))"``.

Phase 13 is observability (``ddl_tpu_torch.obs``, ``profiling``).  (a)
Phase 6's token cell again, disarmed and with span tracing and the
flight recorder armed (exported: the PROCESS producers arm themselves at
import), in turns: THREAD disarmed, armed, armed, disarmed, then PROCESS
armed, disarmed.  Gates: every fit's losses and K1-K3 launches bit-equal
to phase 6's fit of its mode; every served window's ``producer.fill``,
``producer.commit``, ``consumer.acquire``, ``ingest.transfer``,
``trainer.consume`` and ``consumer.release`` events, keyed on its
trailer identity; in PROCESS mode the producers' lanes arrive through
ObsReports, the merger adopts ``producer.<idx>.*`` and the Chrome trace
has one flow per served window; ``north_star_report``'s window latency
p99 >= p50 > 0; no dump in a clean fit.  It prints ms/step armed and
disarmed (wall and steady), the ratios of their means, the disarmed
fits' spread, events a window and each ObsReport's pickled bytes.  (b) One
armed window inside ``profiling.trace``: the Chrome trace holds the
``ddl.window_wait`` and ``ddl.ingest_put_window`` ranges and K1-K3, K1's
events as many as its counter's launches; phase 5's geometry drained
onto ``{"dp": 4}`` (``distribute="ici"``) under armed spans: one
``ici.fanout`` span and one K8 launch a window.  (c) Phase 6's token
stream drained onto cuda:0 with spans and the recorder armed and producer 1's
second commit corrupted: exactly one dump names the quarantined window,
``python -m ddl_tpu_torch.obs dump`` prints it (exit code 0), and the
stream equals the undisturbed drain's.  Run alone (after phase 6, whose
fits it compares with): ``python3 -c "import sys, tempfile; sys.path.
insert(0, '.'); import chip_smoke as c; card = c.phase_build(); tmp =
tempfile.mkdtemp(); s = c.phase_train(tmp, card)[1];
print(c.phase_obs(tmp, card, s))"``.

Phase 14 is the other model families at their published widths.  First
K1-K3 with ``causal=False`` at the ViT-B/16 fit's shape (B = 32, T =
196, H = Hkv = 12, D = 64, bf16) against their plain versions, forward
and backward, at phase 2's tolerances, then timed with every tile pair
counted as loaded, beside the plain versions, SDPA's non-causal call and
the bound.  (a) The MoE at Mixtral-8x7B's widths (vocab 32000, d_model
4096, 32/8 heads, d_ff 14336, 8 experts, top-2) cut to 2 layers, B = 2,
T = 2048: one layer's MLP timed by part (routing, one-hot dispatch and
combine, expert products), then ``Trainer.fit`` over THREAD producers
three ways — the einsum impl on a Zipf token stream (K1-K3, profiled),
on packed documents with ``segment_ids`` (K4-K6), the ragged impl on the
token stream — each with finite, falling losses, one launch a layer a
step on the wgmma kernels, its peak memory and its share of dropped
picks; before the fits one fp32 step of each path against its
``attn_impl="dense"`` twin at phase 3's tolerances (loss 1e-5, every
gradient 1e-4), after them the einsum and packed fits again in fp32
beside their dense twins (per-window losses within 1e-4: Adam and the
capacity boundary amplify fp32 noise over the steps); greedy decode,
and the prefill's logits against the no-cache forward.
(b) ViT-B/16 through ``Trainer.fit`` with ``classification_loss`` over
``.npy`` shards of ``[pixels..., label]`` rows (``FileShardProducer``,
two splits), K1-K3 non-causal.  (c) PointNet over ``(pos, target,
weight)`` shards, no kernel.  Run alone: ``python3 -c "import sys,
tempfile; sys.path.insert(0, '.'); import chip_smoke as c; card =
c.phase_build(); print(c.phase_families(tempfile.mkdtemp(), card))"``.

Phase 15 is the cluster ladder (``ddl_tpu_torch.cluster``) under phase 6's
token cell: Llama-3-8B widths cut to 2 layers, bf16, seed-0 weights, T =
2048, B = 4, 2 steps a window, ``adamw(1e-5)``, two mock hosts
(producer 1 with the trainer on host 0, producer 2 on host 1) over 4
shards, each a fixed window of the Zipf corpus, served by a shard-range
producer with ``adopt_shards``; every window one multistep on cuda:0
through ``DistributedDataLoader(..., cluster=elastic).windows()``.  After
window 3: (a) ``kill_host(1)`` with THREAD producers (its ring shut);
(b) the same with PROCESS producers over page-locked native rings (its
process terminated); (c) ``HEARTBEAT_DROP`` at ``cluster.heartbeat`` for
host 1, the consumer waiting at the boundary until the 1.5 s lease
lapses into the view change while the producer lives on, parked; (d)
``drain_host(1)``, then ``rejoin_host`` after window 10; (e) a
``JournaledSupervisor`` under ``SupervisorHA`` (0.3 s lease) whose leader
dies by ``SUPERVISOR_CRASH`` at ``cluster.supervise``, the promoted
leader then handling ``kill_host(1)``.  Gates: every window a shard's
bytes, all 4 shards served, producer 1 serving shards 2-3 after the
change; one view change and one host loss (the drain: one drain, one
rejoin, no loss; the lease leg: heartbeats dropped and the lapse at
least the lease after the last beat; failover: one crash, one
promotion, the replayed journal's term 2); pool updates and shard
adoptions on both sides; no watchdog failure or respawn; K1-K3 once a
layer a step on the wgmma route; every window on the alias route; (b)'s
producers exiting 0 and terminated, both rings registered and
unregistered once; each leg's per-step losses bit-equal to a control fit
from the same weights whose one plain producer replays the shards the
leg served.  It prints, beside the card's name and power limit, the act
to the next and to the first survivor window, the last beat to the view
change (c), the crash to the promoted leader and its overshoot past the
lease (e), and ms/step before and after the change.  (f) The ``chaos``
leg of ``tests/torch_multihost_prog.py`` in two gloo processes on cuda:0
(``--cluster-child``), each with PROCESS producers: process 1 loses
producer 1 at its 3rd fill (the watchdog respawns it), then its whole
mock host; one gloo ``all_reduce`` of a cuda tensor a window in both
(its ms printed); every shard served in both processes, one respawn and
one host loss in process 1, no watchdog failure.  Run alone: ``python3
-c "import sys, tempfile; sys.path.insert(0, '.'); import chip_smoke as
c; card = c.phase_build(); print(c.phase_cluster(tempfile.mkdtemp(),
card))"``.

Phase 16 is the serving fabric (``ddl_tpu_torch.serve``).  One
``IngestFabric`` beside a ``JournaledSupervisor`` under ``SupervisorHA``
(0.3 s lease), two jobs reaching it through loopback ``FabricClient`` s,
each loader bound with ``FabricJob.bind(loader)`` and each job's
producers stamping its ``integrity_namespace`` as ``seq_base``; a job is
``DistributedDataLoader(...).windows()`` into the port's multistep
(phase 15's loop).  (a) Job A, phase 6's token cell (10 windows, weight
2), and job B, phase 14's ViT-B/16 fit (10 windows, weight 1, a byte
budget of half its solo control's served rate), in two threads at once.
(b) After A's window 4 the leader dies by ``SUPERVISOR_CRASH`` at
``cluster.supervise``; once the standby is promoted the fabric is
rebuilt with ``IngestFabric.from_journal`` and the clients rebind under
its term; client A's last admission envelope is sent again.  (c)
``JOB_CRASH`` at ``serve.fabric.grant`` on B's seventh grant.  Gates:
A's per-step losses bit-equal to its solo control's, B's up to its crash;
B's charged bytes within its token bucket's bound (budget x (wall + its
first full second) + one window); every journaled grant with its served
or aborted note or the crash's release, ``serve.admissions`` the
journal's grants; the rebuilt ledger equal to the dead leader's journal;
the re-sent envelope answered from the journaled reply with the ledger
unchanged; B's stream raising ``JobCrashed``, one job crash releasing its
in-flight grant; K1-K3 summed over both jobs' layers and steps, all on
the wgmma route.  (d) The autoscaler: phase 15's token cell over hosts 0
and 1 and a standby host 2 over 6 shards, ``Autoscaler(sustain_s=0,
cooldown_s=0)`` on an injected signal, high after window 3 (``"up"``:
``rejoin_host``), low after window 7 (``"down"``: a drain, then the
release); one scale-up and one scale-down, every shard served, no
watchdog failure, losses bit-equal to a replay control.  It prints each
job's ms/step alone and together, B's served rate against its budget,
the admission waits' p50/p99, the crash to the promoted fabric and the
rebuild's ms, the crash report, and the signal to the new host's first
window.  Run alone: ``python3 -c "import sys, tempfile; sys.path.insert(0,
'.'); import chip_smoke as c; card = c.phase_build();
print(c.phase_serve(tempfile.mkdtemp(), card))"``.

Phase 17 is the self-tuning data plane (``ddl_tpu_torch.tune``), with
the flight recorder armed.  (e) Phase 6's token cell from a mis-matched
seed, ``LoaderConfig(wire_dtype="raw", prefetch_depth=1)``: a
``Calibrator`` under ``DDL_TORCH_TUNE_DEADLINE_S`` whose link probe is
the pinned host-to-card copy into cuda:0, its ``TunedConfig`` applied,
then a ``KnobController`` over the loader's staging queue and pool
stepped once a window; against the seed run as shipped (the window
stream keeps ``prefetch_depth`` windows in flight).  (f) Phase 4's
global shuffle drained raw through the device fabric (K9), a
``Calibrator`` whose link probe is a simulated 16 MiB/s link, then the
exchange on the wire it picks against a hand-set int8 control.  Gates:
every decision with a ``cost_source``, one ``measured``, each in the
flight recorder and in ``tune.decisions``; (e) the tuned losses
bit-equal to the seed's and the wire kept raw on the card's link, every
revert after a slower window; (f) int8 from a measured link, the int8
pools byte-equal to the control's, K9 once a round on the raw drain.
Run alone: ``python3 -c "import sys, tempfile; sys.path.insert(0, '.');
import chip_smoke as c; card = c.phase_build();
print(c.phase_tune(tempfile.mkdtemp(), card))"``.

Phase 18 is the port's entry points on the card.  (a) Sampled KV-cache
decode at phase 8's widths from fresh seed-0 params: greedy, then
temperature 0.8 with top_k 8 and top_p 0.9 under two seeded CUDA
generators, then top_k 1; each sampled token must lie in the filtered
support of the no-cache forward's logits at its step (K1, its launches
counted; a token outside within bf16 tolerance of the support's edge is
reported, not failed), the cached logits within ``BF16_LOGIT_ATOL`` of
the no-cache ones, top_k 1 equal to greedy, the two seeds different; it
prints the ms a token.  (b) ``measure_h2d_bandwidth()`` on cuda:0 (finite
and positive).  (c) ``DeviceIngestor.put`` of three columns of a pinned
ring slot, staged and inline, the slot overwritten as soon as ``put``
returns: the landed columns equal the host's.  (d) ``Trainer.evaluate``
over phase 11's ``{"dp": 4}`` positions of cuda:0: every window lands
sharded (1/4 of the rows a position) and the loss equals the same
evaluate landed whole within rtol 1e-5.  (e) ``examples/
generate_torch.py``, ``run_ddl_torch.py`` (THREAD, then PROCESS, device
output) and ``global_shuffle_torch.py`` as subprocesses, each exiting 0
with its pass line; ``train_vit_torch.py`` needs Pillow and runs only
where it is installed (the line says which).  Run alone: ``python3 -c
"import sys, tempfile; sys.path.insert(0, '.'); import chip_smoke as c;
card = c.phase_build(); print(c.phase_entry(tempfile.mkdtemp(),
card))"``.

Output: progress lines, then one JSON line ``{"kernels": [...]}`` (K1-K6
with ``ring_launches``: K1-K3 from the sp fit, K4-K6 from the packed
ring of (a); ``multihost_launches`` from phase 12's two processes and
``zero1_launches`` from their z1 and z1int8 fits (12 b); K1-K3
with ``pipeline_launches`` from phase 12's gpipe fit; ``moe_launches``
from phase 14's MoE fits, K1-K3 with ``vit_launches`` and the
``vit_noncausal`` timings, K1-K3 with ``cluster_launches`` from
phase 15's five ladder fits, ``serve_launches`` from phase 16's two
concurrent jobs and autoscaled fit and ``tune_launches`` from phase
17's tuned fit, and K9 with ``tune_launches`` from phase 17's raw
drain; every row with ``entry_launches`` from phase 18 (a) and (d)), the
card's ``name, power.limit``, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
without that line.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks: dense bf16 tensor rate (the main path's
#: type) and HBM bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SEED = 0
MAIN = dict(B=4, T=2048, H=32, Hkv=8, D=128)  # the slice's attention shape
TRAIN = dict(seq_len=2048, batch_size=4, window_rows=8, n_producers=2,
             n_epochs=3, n_layers=2, n_tokens=4_000_000)
#: The global-shuffle path's geometry (bench.py's _run_shuffle_ab): 4
#: instances, pools of 8192 rows x 256 fp32 values, half of each window
#: exchanged per refill.
SHUFFLE = dict(n=4, rows=8192, cols=256, fraction=0.5, batch_size=2048,
               n_epochs=8)
#: The ICI ingest path's geometry (bench.py's ICI A/B, :74-75): an
#: ArrayProducer over 131072 x 256 fp32 values, windows of 65536 rows in
#: batches of 2048, so (32, 2048, 256) fp32 = 64 MiB a window; 4 ring
#: positions; 6 windows per mesh.  The kernels' standalone block is the
#: window's 2-D view on dim 0, (65536, 256).
ICI = dict(n=4, n_rows=131072, rows=65536, cols=256, window=65536,
           batch_size=2048, n_epochs=6)
#: Llama-3's <|end_of_text|>: the document delimiter of the packed path.
EOT = 128001
VOCAB = 128256


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


# ------------------------------------------------------------- phase 1 ---

#: The kernel sources, one library each.
SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_attention",
           "device_shuffle", "ici_fanout", "host_register")
#: The wgmma sources: their ptxas report must show no serialized wgmma
#: (C7512: too few registers; C7520: a wgmma in a divergent branch), and
#: the backward's (dK/dV and dQ) no spill.  The forward's K4 at head dim
#: 128 spills a few bytes at its 168-register cap: reported, not failed.
WGMMA_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90")
NO_SPILL_SOURCES = ("flash_bwd_sm90",)


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from ddl_tpu_torch.ops import _build
    from ddl_tpu_torch.transport import shm_ring

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        ring = pool.submit(shm_ring.build_native)
        libs = list(pool.map(_build.build, SOURCES))
        # A failed g++ build raises here: PROCESS mode must not fall back
        # to the Python ring in this run.
        log(f"[build] transport/csrc/shm_ring.cpp -> "
            f"{os.path.basename(ring.result())} (g++)")
    faults = []
    for name, lib in zip(SOURCES, libs):
        log(f"[build] {name}.cu -> {os.path.basename(lib)}")
        report = lib.parent / f"{lib.name}.log"
        if report.exists():
            for line in report.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line or "warning" in line):
                    log(f"[ptxas] {line.strip()}")
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", line)
                if ((name in NO_SPILL_SOURCES and spill
                     and spill.groups() != ("0", "0"))
                        or (name in WGMMA_SOURCES
                            and ("C7512" in line or "C7520" in line))):
                    faults.append(f"{name}: {line.strip()}")
    log(f"[build] {len(SOURCES) + 1} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    if faults:
        raise PhaseFailed("ptxas spills or serializes a wgmma kernel: "
                          + "; ".join(faults))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        raise PhaseFailed(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[card] {card}")
    return card


# ------------------------------------------------------------- phase 2 ---

def _rand(shape, dtype, gen, device):
    import torch

    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_tile_visits(fn, *args, rule: int):
    """``fn`` (a bf16 flash wrapper, K1-K6) timed by ``_time_ms`` with the
    kernel's tile counter on: (ms, tiles the kernel loaded per call — key
    tiles for the forward and dQ, query tiles for the dK/dV backward).
    Fails unless every call loaded ``rule`` tiles."""
    import torch

    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    reps, warmup = 10, 2
    ms = _time_ms(lambda: fn(*args, visited=visited), reps, warmup)
    total = int(visited)
    what, rule_fn = (("query tiles", "live_tiles_dkv") if "dkv" in fn.__name__
                     else ("key tiles", "live_tiles"))
    log(f"[time] {fn.__name__}: the kernel loaded {total} {what} in "
        f"{reps + warmup} calls; {rule_fn} (computed) gives {rule} a call")
    if total != (reps + warmup) * rule:
        raise PhaseFailed(f"{fn.__name__} loaded {total / (reps + warmup)} "
                          f"{what} a call, its rule says {rule}")
    return ms, total // (reps + warmup)


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _doc_lengths(rng, n_tokens: int):
    """Document lengths, log-normal with median 300 tokens and sigma 1.0,
    clipped to [16, 8192], drawn until they cover ``n_tokens``."""
    import numpy as np

    lens = np.zeros(0, np.int64)
    while lens.sum() < n_tokens:
        draw = rng.lognormal(np.log(300.0), 1.0, n_tokens // 300 + 16)
        lens = np.concatenate([lens, np.clip(np.rint(draw), 16, 8192)
                               .astype(np.int64)])
    return lens


def documents(n_tokens: int, seed: int = SEED, vocab: int = VOCAB,
              eot: int = EOT):
    """A web-text-like stream of packed documents: lengths log-normal with
    median 300 tokens and sigma 1.0, clipped to [16, 8192]; bodies are
    Zipf(1.2) ranks mod ``vocab`` (draws of the delimiter remapped);
    every document ends in ``eot``.  int32, ``n_tokens`` long."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ends = np.cumsum(_doc_lengths(rng, n_tokens)) - 1
    tokens = (rng.zipf(1.2, n_tokens) - 1) % vocab
    tokens[tokens == eot] = (eot + 1) % vocab
    tokens[ends[ends < n_tokens]] = eot
    return tokens.astype(np.int32)


def seg_ids(tokens, eot: int = EOT):
    """Row-local segment ids of (rows, T) tokens, as PackedTokenProducer
    writes them: a new document starts after each ``eot``."""
    import numpy as np

    seg = np.zeros_like(tokens)
    seg[:, 1:] = np.cumsum(tokens[:, :-1] == eot, axis=1)
    return seg


def _in_segment_causal_pairs(ids) -> int:
    """(q, k) pairs with k <= q in the same segment, per head, over the
    rows of contiguous row-local ids."""
    import numpy as np

    total = 0
    for row in ids:
        _, n = np.unique(row, return_counts=True)
        total += int((n * (n + 1) // 2).sum())
    return total


def _case(name, B, Tq, Tk, H, Hkv, D, dtype, q_off, k_off, causal, tol, gen,
          seg=None):
    """One kernel-vs-plain comparison: forward out/lse, then dq/dk/dv of a
    loss that weighs both outputs (so the lse cotangent is nonzero).
    ``seg``: (query, key) segment ids, int32 on the card — the packed
    kernels K4-K6.  Rows whose every key is masked must give out = 0,
    lse = -1e30 and dq = 0; keys that no query reaches, dk = dv = 0
    exactly.  The forward, the dQ and the dK/dV backward must take their
    wgmma kernels in bf16 and the FMA kernels in fp32 (their
    ``sm90_launches`` counters).  Returns (ok, errors, kernel outputs, v)."""
    import torch

    from ddl_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    rep = H // Hkv
    q = _rand((B, Tq, H, D), dtype, gen, dev)
    k = _rand((B, Tk, Hkv, D), dtype, gen, dev)
    v = _rand((B, Tk, Hkv, D), dtype, gen, dev)
    g_out = _rand((B, Tq, H, D), torch.float32, gen, dev)
    g_lse = _rand((B, H, Tq), torch.float32, gen, dev)

    def run(f):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out, lse = f(qq, kk, vv)
        live = lse > -1e29
        loss = (out.float() * g_out).sum() + torch.where(
            live, lse * g_lse, torch.zeros_like(lse)).sum()
        loss.backward()
        return out.detach(), lse.detach(), qq.grad, kk.grad, vv.grad

    sq, sk = seg if seg is not None else (None, None)
    routed = fa.KERNELS[:3] if seg is None else fa.KERNELS[3:]
    before = [(f.launches, f.sm90_launches) for f in routed]
    kern = run(lambda a, b, c: fa.flash_attention_with_lse(
        a, b, c, q_off, k_off, causal, rep, segment_ids=sq,
        kv_segment_ids=sk))
    route = [(f.launches - n, f.sm90_launches - m)
             for f, (n, m) in zip(routed, before)]
    want_route = [(1, 1 if dtype == torch.bfloat16 else 0)] * 3
    plain = run(lambda a, b, c: fa.attention_plain(
        a, b, c, q_off, k_off, causal, rep, sq, sk))
    torch.cuda.synchronize()
    errs = {
        "out_abs": float((kern[0].float() - plain[0].float()).abs().max()),
        "lse_abs": float((kern[1] - plain[1]).abs().max()),
    }
    for i, g in ((2, "dq"), (3, "dk"), (4, "dv")):
        errs[f"{g}_rel"] = _rel(kern[i], plain[i])
        errs[f"{g}_abs"] = float((kern[i].float() - plain[i].float()).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in kern)
    ok = (
        finite
        and route == want_route
        and errs["out_abs"] <= tol["out"]
        and errs["lse_abs"] <= tol["lse"]
        and max(errs["dq_rel"], errs["dk_rel"], errs["dv_rel"]) <= tol["grad"]
    )
    log(f"[check] {name}: " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
        + f" | tol out<={tol['out']} lse<={tol['lse']} grad_rel<={tol['grad']}"
        + f" finite={finite} route fwd/dq/dkv="
        + "/".join("sm90" if r[1] else "fma" for r in route)
        + f" -> {'ok' if ok else 'FAIL'}")
    # Rows with no key: the plain version's verdict, from the masks alone.
    empty = plain[1][:, 0] <= -1e29  # (B, Tq)
    if bool(empty.any()):
        lse_rows = kern[1].transpose(1, 2)[empty]
        held = (bool((lse_rows == -1e30).all())
                and float(kern[0][empty].abs().max()) == 0.0
                and float(kern[2][empty].abs().max()) == 0.0)
        log(f"[check] {name}: {int(empty.sum())} query rows with no key: "
            f"out = 0, lse = -1e30, dq = 0 -> {'ok' if held else 'FAIL'}")
        ok &= held
    # Keys that no query reaches, from the masks alone.
    allowed = torch.ones(B, Tq, Tk, dtype=torch.bool, device=dev)
    if causal:
        allowed &= ((k_off + torch.arange(Tk, device=dev))[None, :]
                    <= (q_off + torch.arange(Tq, device=dev))[:, None])
    if seg is not None:
        allowed &= sq.long()[:, :, None] == sk.long()[:, None, :]
    unreached = ~allowed.any(1)  # (B, Tk)
    del allowed
    if bool(unreached.any()):
        held = (float(kern[3][unreached].abs().max()) == 0.0
                and float(kern[4][unreached].abs().max()) == 0.0)
        log(f"[check] {name}: {int(unreached.sum())} keys no query reaches: "
            f"dk = dv = 0 exactly -> {'ok' if held else 'FAIL'}")
        ok &= held
    return ok, errs, kern, v


#: Tolerances and why.  bf16: the kernel rounds p (and ds) to bf16 before
#: its products, as the TPU kernel does, while the plain version stays in
#: fp32 — a relative error of ~2^-8 per term, so |out| <= ~3 carries ~1e-2
#: and the gradients' relative Frobenius error stays well under 2e-2; lse
#: is built from unrounded fp32 terms in both, only the summation order
#: differs.  fp32: both sides run exact fp32 products (no TF32), so only
#: the summation order differs.
TOL_BF16 = {"out": 2e-2, "lse": 1e-3, "grad": 2e-2}
TOL_F32 = {"out": 1e-4, "lse": 1e-4, "grad": 1e-4}


def phase_kernels():
    import torch

    from ddl_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    m = MAIN
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("main bf16 B=4 T=2048 H=32/8 D=128", m["B"], m["T"], m["T"], m["H"],
         m["Hkv"], m["D"], bf16, 0, 0, True, TOL_BF16),
        ("ragged bf16 T=1000", 1, 1000, 1000, m["H"], m["Hkv"], m["D"], bf16,
         0, 0, True, TOL_BF16),
        ("fp32 T=333 H=8/2 D=64", 2, 333, 333, 8, 2, 64, f32, 0, 0, True,
         TOL_F32),
        ("fp32 non-causal T=200 D=128", 1, 200, 260, 4, 4, 128, f32, 0, 0,
         False, TOL_F32),
        ("offsets q_off<k_off bf16 T=256", 1, 256, 256, m["H"], m["Hkv"],
         m["D"], bf16, 0, 100, True, TOL_BF16),
    ] + [
        # The head dims of the reference's smaller configs (16, 32) and 64.
        (f"bf16 D={d} T=300 H=8/2 q_off<k_off", 2, 300, 300, 8, 2, d, bf16,
         0, 20, True, TOL_BF16) for d in (16, 32, 64)
    ]
    ok = True
    errs_main = None
    for c in cases:
        c_ok, errs, _, _ = _case(*c, gen)
        ok &= c_ok
        if errs_main is None:
            errs_main = errs
    if not ok:
        raise PhaseFailed("a kernel disagrees with its plain version")
    rows = time_kernels(gen, errs_main)
    return rows + packed_kernels(gen, causal_tiles={
        row["name"]: row["tiles_visited"] for row in rows
        if "tiles_visited" in row})


def _ids(a):
    import torch

    return torch.tensor(a, dtype=torch.int32, device="cuda")


def packed_kernels(gen, causal_tiles):
    """K4-K6 against the plain version: (a) the main shape with ids from
    the document generator, (b) a ragged bf16 length, (c) fp32, (d) key ids
    that differ from the query ids so that some queries have no key,
    (e) every token its own segment, where out must equal the
    rep-expanded v.  Then their times at the main shape."""
    import numpy as np
    import torch

    m = MAIN
    bf16, f32 = torch.bfloat16, torch.float32
    docs = documents(m["B"] * m["T"] + 4096, seed=SEED + 1)
    main_ids = seg_ids(docs[: m["B"] * m["T"]].reshape(m["B"], m["T"]))

    def doc_ids(B, T, off):
        return seg_ids(docs[off: off + B * T].reshape(B, T))

    ids_d = doc_ids(2, 512, 100)
    keys_d = np.where(ids_d % 3 == 1, -7, ids_d)  # those documents lose their keys
    own = np.broadcast_to(np.arange(256, dtype=np.int32), (2, 256))
    cases = [
        ("(a) packed main bf16 B=4 T=2048 H=32/8 D=128", m["B"], m["T"], m["T"],
         m["H"], m["Hkv"], m["D"], bf16, 0, 0, True, TOL_BF16,
         (main_ids, main_ids)),
        ("(b) packed ragged bf16 T=1000", 1, 1000, 1000, m["H"], m["Hkv"],
         m["D"], bf16, 0, 0, True, TOL_BF16, (doc_ids(1, 1000, 7),) * 2),
        ("(c) packed fp32 T=333 H=8/2 D=64", 2, 333, 333, 8, 2, 64, f32, 0, 0,
         True, TOL_F32, (doc_ids(2, 333, 3000),) * 2),
        ("(d) packed bf16 kv ids != q ids T=512", 2, 512, 512, m["H"],
         m["Hkv"], m["D"], bf16, 0, 0, True, TOL_BF16, (ids_d, keys_d)),
        ("(e) packed bf16 one-token segments T=256", 2, 256, 256, m["H"],
         m["Hkv"], m["D"], bf16, 0, 0, True, TOL_BF16, (own, own)),
    ] + [
        (f"packed bf16 D={d} T=333 H=8/2", 2, 333, 333, 8, 2, d, bf16, 0, 0,
         True, TOL_BF16, (doc_ids(2, 333, 3000),) * 2) for d in (16, 32, 64)
    ]
    ok = True
    errs_main = None
    for *c, (sq, sk) in cases:
        c_ok, errs, kern, v = _case(*c, gen, seg=(_ids(sq), _ids(sk)))
        ok &= c_ok
        errs_main = errs_main or errs
        if c[0].startswith("(d)"):
            n_empty = int(np.isin(sq, sk, invert=True).sum())
            log(f"[check] (d): {n_empty} queries' documents have no key")
            ok &= n_empty > 0
        if c[0].startswith("(e)"):
            want = v.float().repeat_interleave(c[4] // c[5], dim=2)
            err = float((kern[0].float() - want).abs().max())
            log(f"[check] (e): out vs rep-expanded v max abs err {err:.3g} "
                f"| tol 0 -> {'ok' if err == 0.0 else 'FAIL'}")
            ok &= err == 0.0
    if not ok:
        raise PhaseFailed("a packed kernel disagrees with its plain version")
    return time_packed_kernels(gen, main_ids, errs_main, causal_tiles)


def time_kernels(gen, errs):
    """Kernel, plain and library times at the main path's shapes, with
    each kernel's bound."""
    import torch
    import torch.nn.functional as F

    from ddl_tpu_torch.ops import flash_attention as fa

    B, T, H, Hkv, D = (MAIN[k] for k in ("B", "T", "H", "Hkv", "D"))
    dt = torch.bfloat16
    rep = H // Hkv
    q = _rand((B, T, H, D), dt, gen, "cuda")
    k = _rand((B, T, Hkv, D), dt, gen, "cuda")
    v = _rand((B, T, Hkv, D), dt, gen, "cuda")
    dout = _rand((B, T, H, D), dt, gen, "cuda")
    out, lse = fa.flash_fwd(q, k, v)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dlse = torch.zeros_like(lse)

    # K1, K2 and K3 visit every tile of the causal loop: live_tiles and
    # live_tiles_dkv with one id.
    zeros = torch.zeros(B, T, dtype=torch.int32)
    causal_rule = H * int(fa.live_tiles(zeros, zeros).sum())
    fwd_ms, tiles = _timed_tile_visits(fa.flash_fwd, q, k, v, rule=causal_rule)
    dq_ms, dq_tiles = _timed_tile_visits(
        fa.flash_bwd_dq, q, k, v, dout, lse, delta, dlse, rule=causal_rule)
    dkv_ms, dkv_tiles = _timed_tile_visits(
        fa.flash_bwd_dkv, q, k, v, dout, lse, delta, dlse,
        rule=H * int(fa.live_tiles_dkv(zeros, zeros).sum()))
    ms = {"fwd": fwd_ms, "dq": dq_ms, "dkv": dkv_ms}

    # Plain versions: the dense forward, and its autograd backward asked
    # for dq alone (K2's function) or for dk, dv (K3's).
    def plain_graph():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        o, _ = fa.attention_plain(qq, kk, vv, kv_repeat=rep)
        return o, qq, kk, vv

    plain_ms = {"fwd": _time_ms(lambda: fa.attention_plain(q, k, v, kv_repeat=rep),
                                reps=5)}
    o, qq, kk, vv = plain_graph()
    plain_ms["dq"] = _time_ms(lambda: torch.autograd.grad(
        o, qq, dout, retain_graph=True), reps=5)
    plain_ms["dkv"] = _time_ms(lambda: torch.autograd.grad(
        o, (kk, vv), dout, retain_graph=True), reps=5)
    del o, qq, kk, vv
    torch.cuda.empty_cache()

    # The library yardstick: one scaled_dot_product_attention call on the
    # same inputs (timed here only; the port never calls it).
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    qs, ks_, vs = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    so = F.scaled_dot_product_attention(qs, ks_, vs, is_causal=True,
                                        enable_gqa=True)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
        so, (qs, ks_, vs), dout.transpose(1, 2), retain_graph=True))
    del so, qs, ks_, vs

    # Bounds from this run's shapes: causal pairs (q, k) with k <= q.
    pairs = B * H * T * (T + 1) // 2
    isz = 2
    rows = B * H * T * 4  # one fp32 row statistic
    n_q, n_kv = B * T * H * D * isz, B * T * Hkv * D * isz
    work = {
        # flops, bytes (each input read once, each output written once)
        "fwd": (4 * D * pairs, n_q + 2 * n_kv + n_q + rows),
        "dq": (6 * D * pairs, n_q + 2 * n_kv + n_q + 3 * rows + n_q),
        "dkv": (8 * D * pairs, n_q + 2 * n_kv + n_q + 3 * rows + 2 * n_kv),
    }
    info = {
        "fwd": ("flash_fwd", "_fwd_kernel", 97),
        "dq": ("flash_bwd_dq", "_dq_kernel", 251),
        "dkv": ("flash_bwd_dkv", "_dkv_kernel", 287),
    }
    rows_out = _kernel_rows(info, work, errs, ms, plain_ms, library_fwd,
                            {"fwd": {"tiles_visited": tiles},
                             "dq": {"tiles_visited": dq_tiles},
                             "dkv": {"tiles_visited": dkv_tiles}})
    log(f"[time] sdpa backward (dq, dk, dv together): {sdpa_bwd:.3f} ms")
    return rows_out


def _bound(flops, nbytes):
    """(bound ms, what bounds it) on the H100's published peaks."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _kernel_rows(info, work, errs, ms, plain_ms, library_fwd, extra=None):
    """The kernels-JSON rows of one fwd/dq/dkv triple.  ``max_abs_err`` is
    the largest elementwise difference from the plain version in the main
    case, ``rel_err`` (backward) the relative Frobenius error the check
    holds.  The bf16 forward and backward kernels are the wgmma kernels of
    their own sources."""
    abs_err = {"fwd": errs["out_abs"], "dq": errs["dq_abs"],
               "dkv": max(errs["dk_abs"], errs["dv_abs"])}
    rel_err = {"fwd": None, "dq": errs["dq_rel"],
               "dkv": max(errs["dk_rel"], errs["dv_rel"])}
    rows_out = []
    for key in ("fwd", "dq", "dkv"):
        bound_ms, bound_by = _bound(*work[key])
        name, tpu_fn, line = info[key]
        rows_out.append({
            "name": name,
            "route": "cuda",
            "source": "ddl_tpu_torch/ops/csrc/" + {
                "fwd": "flash_fwd_sm90.cu", "dq": "flash_bwd_sm90.cu",
                "dkv": "flash_bwd_sm90.cu"}[key],
            "replaces": f"ddl_tpu/ops/flash_attention.py:{line} ({tpu_fn})",
            "launches": 0,
            "max_abs_err": abs_err[key],
            "rel_err": rel_err[key],
            "ms": ms[key],
            "plain_ms": plain_ms[key],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_fwd if key == "fwd" else None,
            **(extra.get(key, {}) if extra else {}),
        })
        log(f"[time] {name}: {ms[key]:.3f} ms  plain {plain_ms[key]:.3f} ms  "
            f"bound {bound_ms:.4f} ms ({bound_by})"
            + (f"  causal-only bound {extra[key]['causal_bound_ms']:.4f} ms"
               if extra and key in extra and "causal_bound_ms" in extra[key]
               else "")
            + (f"  {'query' if key == 'dkv' else 'key'} tiles loaded "
               f"{extra[key]['tiles_visited']} (counted)"
               if extra and key in extra and "tiles_visited" in extra[key]
               else "")
            + (f"  sdpa {library_fwd:.3f} ms" if key == "fwd" else ""))
    return rows_out


def time_packed_kernels(gen, ids_np, errs, causal_tiles):
    """K4-K6's kernel, plain and library times at the main shape on the
    packed-document ids of case (a), with the bound of the in-segment
    causal pairs (the work these ids need) and, beside it, the causal-only
    bound (the work of every causal tile).  K4's and K5's key tiles and
    K6's query tiles loaded, counted by the kernels, over ``causal_tiles``
    (by unpacked wrapper name), those K1, K2 and K3 loaded at the same
    shape."""
    import torch
    import torch.nn.functional as F

    from ddl_tpu_torch.ops import flash_attention as fa

    B, T, H, Hkv, D = (MAIN[k] for k in ("B", "T", "H", "Hkv", "D"))
    dt = torch.bfloat16
    rep = H // Hkv
    q = _rand((B, T, H, D), dt, gen, "cuda")
    k = _rand((B, T, Hkv, D), dt, gen, "cuda")
    v = _rand((B, T, Hkv, D), dt, gen, "cuda")
    dout = _rand((B, T, H, D), dt, gen, "cuda")
    sid = _ids(ids_np)
    out, lse = fa.flash_fwd_seg(q, k, v, sid, sid)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dlse = torch.zeros_like(lse)
    live_rule = H * int(fa.live_tiles(sid, sid).sum())
    fwd_ms, tiles = _timed_tile_visits(fa.flash_fwd_seg, q, k, v, sid, sid,
                                       rule=live_rule)
    dq_ms, dq_tiles = _timed_tile_visits(
        fa.flash_bwd_dq_seg, q, k, v, dout, lse, delta, dlse, sid, sid,
        rule=live_rule)
    dkv_ms, dkv_tiles = _timed_tile_visits(
        fa.flash_bwd_dkv_seg, q, k, v, dout, lse, delta, dlse, sid, sid,
        rule=H * int(fa.live_tiles_dkv(sid, sid).sum()))
    ms = {"fwd": fwd_ms, "dq": dq_ms, "dkv": dkv_ms}

    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    plain_ms = {"fwd": _time_ms(lambda: fa.attention_plain(
        q, k, v, kv_repeat=rep, seg_q=sid, seg_k=sid), reps=5)}
    o, _ = fa.attention_plain(qq, kk, vv, kv_repeat=rep, seg_q=sid, seg_k=sid)
    plain_ms["dq"] = _time_ms(lambda: torch.autograd.grad(
        o, qq, dout, retain_graph=True), reps=5)
    plain_ms["dkv"] = _time_ms(lambda: torch.autograd.grad(
        o, (kk, vv), dout, retain_graph=True), reps=5)
    del o, qq, kk, vv
    torch.cuda.empty_cache()

    # The library yardstick: one scaled_dot_product_attention call with a
    # boolean (B, 1, T, T) mask, causal AND same segment (timed here only;
    # the port never calls it).
    pos = torch.arange(T, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (sid[:, :, None] == sid[:, None, :]))[:, None]
    # k/v go in expanded to the query heads (outside the timed call): the
    # masked call then takes SDPA's memory-efficient kernel, not its math
    # fallback.
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(rep, dim=2).transpose(1, 2) for t in (k, v))
    library_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    qs, ks_, vs = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    so = F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
        so, (qs, ks_, vs), dout.transpose(1, 2), retain_graph=True))
    del so, qs, ks_, vs, mask

    pairs = H * _in_segment_causal_pairs(ids_np)
    causal_pairs = B * H * T * (T + 1) // 2
    isz = 2
    rows = B * H * T * 4
    n_q, n_kv = B * T * H * D * isz, B * T * Hkv * D * isz
    n_ids = 2 * B * T * 4  # the two int32 id arrays

    def work_of(p):
        return {
            "fwd": (4 * D * p, n_q + 2 * n_kv + n_ids + n_q + rows),
            "dq": (6 * D * p, n_q + 2 * n_kv + n_q + 3 * rows + n_ids + n_q),
            "dkv": (8 * D * p, n_q + 2 * n_kv + n_q + 3 * rows + n_ids + 2 * n_kv),
        }

    causal = work_of(causal_pairs)
    extra = {key: {"causal_bound_ms": _bound(*causal[key])[0],
                   "in_segment_pairs": pairs, "causal_pairs": causal_pairs}
             for key in causal}
    # The tile skips on these ids, as the kernels counted them: the key
    # tiles K4 and K5 loaded against those K1 and K2 loaded at this shape,
    # the query tiles K6 loaded against K3's.
    for key, n, unpacked in (("fwd", tiles, "flash_fwd"),
                             ("dq", dq_tiles, "flash_bwd_dq"),
                             ("dkv", dkv_tiles, "flash_bwd_dkv")):
        extra[key].update(tiles_visited=n,
                          causal_tiles=causal_tiles[unpacked],
                          visited_share=n / causal_tiles[unpacked])
    log(f"[time] packed ids: {pairs} in-segment causal pairs of "
        f"{causal_pairs} causal ({pairs / causal_pairs:.3%}); K4 loaded "
        f"{tiles} of the {causal_tiles['flash_fwd']} key tiles K1 loaded "
        f"({tiles / causal_tiles['flash_fwd']:.3%}); K5 loaded {dq_tiles} "
        f"of the {causal_tiles['flash_bwd_dq']} key tiles K2 loaded "
        f"({dq_tiles / causal_tiles['flash_bwd_dq']:.3%}); K6 loaded {dkv_tiles} "
        f"of the {causal_tiles['flash_bwd_dkv']} query tiles K3 loaded "
        f"({dkv_tiles / causal_tiles['flash_bwd_dkv']:.3%})")
    info = {
        "fwd": ("flash_fwd_seg", "_fwd_kernel_seg", 334),
        "dq": ("flash_bwd_dq_seg", "_dq_kernel_seg", 340),
        "dkv": ("flash_bwd_dkv_seg", "_dkv_kernel_seg", 347),
    }
    rows_out = _kernel_rows(info, work_of(pairs), errs, ms, plain_ms,
                            library_fwd, extra)
    log(f"[time] sdpa masked backward (dq, dk, dv together): {sdpa_bwd:.3f} ms")
    return rows_out


# ------------------------------------------------------------- phase 3 ---

def _loss_and_grads(params, tokens, cfg, seg=None):
    """Loss and every parameter gradient, from fresh leaves."""
    from ddl_tpu_torch.models import llama

    leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(params)]
    tree = _rebuild(params, iter(leaves))
    loss = llama.next_token_loss(tree, tokens, cfg, segment_ids=seg)
    loss.backward()
    return float(loss.detach()), [t.grad for t in leaves]


def phase_model_check():
    """The model's loss and every gradient through the kernels against the
    dense path on a small fp32 input (the repo's own oracle), unpacked
    and with packed-document ids, at head_dim 64 and at the widths of
    ``examples/train_llama.py`` (d_model 128, 4 heads, 2 KV heads, d_ff
    256, so head_dim 32); then each remat policy against
    "none" on the packed input, with its forward launch counts."""
    import numpy as np
    import torch

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa

    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, dtype=torch.float32,
                            attn_impl="flash")
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 200), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    # Documents of ~40 tokens: a delimiter ends a document w.p. 1/40.
    ends = np.random.default_rng(SEED).random((2, 200)) < 1 / 40
    seg_np = np.zeros((2, 200), np.int64)
    seg_np[:, 1:] = np.cumsum(ends[:, :-1], axis=1)
    seg = torch.tensor(seg_np, device="cuda")
    example = dataclasses.replace(cfg, d_model=128, d_ff=256)
    example_params = llama.init_params(example, seed=SEED, device="cuda")
    for c, p in ((cfg, params), (example, example_params)):
        for label, ids in (("unpacked", None), ("packed", seg)):
            (l_f, g_f), (l_d, g_d) = (
                _loss_and_grads(p, tokens,
                                dataclasses.replace(c, attn_impl=impl), ids)
                for impl in ("flash", "dense"))
            worst = max(_rel(a, b) for a, b in zip(g_f, g_d))
            ok = abs(l_f - l_d) <= 1e-5 * abs(l_d) and worst <= 1e-4
            log(f"[check] llama fp32 head_dim {c.head_dim} {label} flash vs "
                f"dense: loss {l_f:.6f} vs {l_d:.6f}, worst grad rel err "
                f"{worst:.3g} | tol loss rel<=1e-5 grad rel<=1e-4 -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailed(f"{label} model at head_dim {c.head_dim} "
                                  "through the kernels disagrees with the "
                                  "dense path")

    # Forward kernel launches per layer: the backward re-runs attention
    # under "full" and "dots", never under "selective".
    fwd_per_layer = {"none": 1, "selective": 1, "full": 2, "dots": 2}
    base = None
    for policy, n in fwd_per_layer.items():
        fa.reset_launch_counts()
        loss, grads = _loss_and_grads(
            params, tokens, dataclasses.replace(cfg, remat=policy), seg)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in fa.KERNELS]
        base = base or (loss, grads)
        worst = max(_rel(a, b) for a, b in zip(grads, base[1]))
        want = [0, 0, 0, cfg.n_layers * n, cfg.n_layers, cfg.n_layers]
        ok = (abs(loss - base[0]) <= 1e-6 * abs(base[0]) and worst <= 1e-6
              and counts == want)
        log(f"[check] remat={policy}: loss {loss:.6f}, worst grad rel err vs "
            f"none {worst:.3g}, launches K1-K6 {counts} (expected {want}) "
            f"| tol rel<=1e-6 -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailed(f"remat={policy} disagrees with remat=none")


def _leaves(tree):
    from ddl_tpu_torch.parallel.train import tree_leaves

    return tree_leaves(tree)


def _rebuild(tree, it):
    from ddl_tpu_torch.parallel.train import tree_map

    return tree_map(lambda _: next(it), tree)


# ------------------------------------------------------------- phase 4 ---

def _bytes(t):
    """A tensor's bytes, for byte-exact comparisons whatever its dtype."""
    import torch

    return t.contiguous().view(torch.uint8)


def _exchange_case(n, rows, num_exchange, cols, dtype, gen, normal=False):
    """The global input of one round: n pools of ``rows`` rows on the
    card, of which each contributes its first ``2 * half`` rows (an odd
    ``num_exchange`` leaves its last exchange row at home).  Random bytes,
    or standard-normal values (``normal``, as the path's pools hold)."""
    import torch

    half = num_exchange // 2
    if normal:
        pools = torch.randn((n, rows, cols), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
    else:
        isz = torch.empty(0, dtype=dtype).element_size()
        pools = torch.randint(0, 256, (n, rows, cols * isz), generator=gen,
                              device="cuda", dtype=torch.uint8).view(dtype)
    return pools[:, :2 * half].reshape(n * 2 * half, cols).contiguous()


def _routes(n, round_):
    import numpy as np

    from ddl_tpu_torch.shuffle import exchange_permutation, inverse_permutation

    p = exchange_permutation(n, SEED, round_)
    return p, np.stack([p, inverse_permutation(p)])


def _time_cold_ms(fn, flush, reps: int = 31, warmup: int = 5) -> float:
    """Median device time of ``fn`` with the L2 cache flushed before each
    call (the exchange's 32 MiB of traffic fits the 50 MB L2, which the
    path's freshly landed input would not find warm).  The flush must
    keep the card busy for longer than ``fn``'s host work, so that the
    start event does not time the card waiting for the launch."""
    import torch

    times = []
    for i in range(warmup + reps):
        flush()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def shuffle_kernel_checks():
    """K9 against its plain version, byte for byte, then its times at the
    bench geometry.  Returns the kernels-JSON row (launches filled in by
    the path)."""
    import torch

    from ddl_tpu_torch.ops import device_shuffle as dsh

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, i32, u8, bf16 = torch.float32, torch.int32, torch.uint8, torch.bfloat16
    sh = SHUFFLE
    cases = [(f"n={n} fp32 x 256", n, 64, 64, 256, f32) for n in (2, 3, 4, 8)]
    cases += [
        ("odd num_exchange 7 of 16 rows, n=2, fp32 x 3", 2, 16, 7, 3, f32),
        ("12-byte rows (fp32 x 3), n=5", 5, 9, 5, 3, f32),
        ("10-byte rows (bf16 x 5), n=3", 3, 10, 10, 5, bf16),
        ("7-byte rows (uint8 x 7), n=8", 8, 12, 6, 7, u8),
        ("132-byte rows (int32 x 33), n=4", 4, 40, 22, 33, i32),
        ("int32 x 256, n=4", 4, 64, 64, 256, i32),
        ("uint8 x 256, n=4", 4, 64, 64, 256, u8),
        ("bf16 x 256, n=4", 4, 64, 64, 256, bf16),
        ("uint8 x 1000 (one lane of 2 rows), n=3", 3, 5, 5, 1000, u8),
    ]
    ok = True
    for i, (label, n, rows, nex, cols, dt) in enumerate(cases):
        gin = _exchange_case(n, rows, nex, cols, dt, gen)
        before = _bytes(gin).clone()
        _, routes = _routes(n, i)
        got = dsh.exchange_ring(gin, ["cuda:0"] * n, routes)
        want = dsh.exchange_plain(gin, routes)
        torch.cuda.synchronize()
        same = torch.equal(_bytes(got), _bytes(want))
        kept = torch.equal(_bytes(gin), before)
        log(f"[check] K9 {label}: byte-equal to plain {same}, input kept "
            f"{kept} -> {'ok' if same and kept else 'FAIL'}")
        ok &= same and kept

    n, half, cols = sh["n"], sh["rows"] // 2 // 2, sh["cols"]
    nex = int(sh["rows"] * sh["fraction"])
    gin = _exchange_case(n, sh["rows"], nex, cols, f32, gen, normal=True)
    _, routes = _routes(n, 0)
    devs = ["cuda:0"] * n
    got = dsh.exchange_ring(gin, devs, routes)
    want = dsh.exchange_plain(gin, routes)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    same = torch.equal(_bytes(got), _bytes(want))
    log(f"[check] K9 bench n={n} {sh['rows']}x{cols} fp32, num_exchange "
        f"{nex}: byte-equal {same}, max abs err {err} | tol 0 -> "
        f"{'ok' if same else 'FAIL'}")
    ok &= same
    if not ok:
        raise PhaseFailed("K9 disagrees with its plain version")

    # The library yardstick: two index_copy_ calls on precomputed indices
    # (timed here only; nothing in the port runs them).
    rows = 2 * half
    g = gin.view(n, rows, cols)
    out = torch.empty_like(g)
    r = torch.as_tensor(routes, dtype=torch.long, device="cuda")

    def library():
        out[:, :half].index_copy_(0, r[0], g[:, :half])
        out[:, half:].index_copy_(0, r[1], g[:, half:])

    # 1 GiB: ~0.3 ms of writes, several times the wrapper's host work.
    scratch = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    ms = _time_cold_ms(lambda: dsh.exchange_ring(gin, devs, routes), flush)
    plain_ms = _time_cold_ms(lambda: dsh.exchange_plain(gin, routes), flush)
    library_ms = _time_cold_ms(library, flush)
    # Back to back, a call costs the wrapper's host work (argument checks,
    # the pointer table, the output's allocation), not the kernel's time.
    call_ms = _time_ms(lambda: dsh.exchange_ring(gin, devs, routes), reps=50,
                       warmup=5)
    library()
    torch.cuda.synchronize()
    ok = torch.equal(_bytes(out.view_as(gin)), _bytes(want))
    del scratch
    if not ok:
        raise PhaseFailed("the library yardstick disagrees with K9")
    nbytes = 2 * n * rows * cols * 4  # each byte read once, written once
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log(f"[time] exchange_ring (K9): {ms:.4f} ms (L2 cold; {call_ms:.4f} ms "
        f"a call back to back)  plain {plain_ms:.4f} ms  index_copy_ x2 {library_ms:.4f} ms"
        f"  bound {bound_ms:.4f} ms (bytes, {nbytes / 2**20:.0f} MiB)")
    return {
        "name": "exchange_ring",
        "route": "cuda",
        "source": "ddl_tpu_torch/ops/csrc/device_shuffle.cu",
        "replaces": "ddl_tpu/ops/device_shuffle.py:78 (_exchange_kernel)",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "back_to_back_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


class PoolProducer:
    """A producer that keeps a pool (``examples/global_shuffle.py``'s
    shape): column 0 is ``instance * 1e6 + row``, the rest seeded
    standard-normal values; each refill shuffles the rows in place,
    so exchanged rows spread through the window.  Module-level, so a
    spawned PROCESS producer unpickles it; it imports the package only
    when called, so this script still starts without it.  Its first
    incarnation SIGKILLs itself at refill ``kill_at``, once, when a
    ``sentinel`` path is given (the file records the time of the kill).
    ``fast_forward`` replays only the RNG: a respawned pusher restores
    the pool from its ring's last committed slot."""

    def __init__(self, instance_idx, rows, cols, sentinel=None, kill_at=0,
                 tag_scale=1.0):
        self.instance_idx, self.rows, self.cols = instance_idx, rows, cols
        self.sentinel, self.kill_at = sentinel, kill_at
        self.tag_scale = tag_scale
        self.refills = 0

    def on_init(self, **kw):
        import numpy as np

        from ddl_tpu_torch import DataProducerOnInitReturn

        self._rng = np.random.default_rng([SEED, self.instance_idx])
        return DataProducerOnInitReturn(
            nData=self.rows, nValues=self.cols,
            shape=(self.rows, self.cols), splits=(self.cols,))

    def post_init(self, my_ary, **kw):
        import numpy as np

        my_ary[:, 1:] = self._rng.standard_normal(
            (self.rows, self.cols - 1), dtype=np.float32)
        my_ary[:, 0] = ((self.instance_idx * 1e6 + np.arange(self.rows))
                        * self.tag_scale)

    def execute_function(self, my_ary, **kw):
        self.refills += 1
        if self.refills == self.kill_at:
            _kill_once(self.sentinel, self.instance_idx)
        self._rng.shuffle(my_ary)

    def fast_forward(self, n, **kw):
        import numpy as np

        dummy = np.empty((self.rows, 1), np.float32)
        for _ in range(n):
            self._rng.shuffle(dummy)
        self.refills += n


def _pool_producer_class():
    return PoolProducer


def drain_instances(factory_of, tag_scale=1.0):
    """Four THREAD instances in this process, one producer each, drained
    to the card: returns (served streams, pushers, drain seconds).
    ``tag_scale`` scales the pools' row tags (column 0)."""
    import threading

    import torch

    from ddl_tpu_torch import DistributedDataLoader, Marker, RunMode, Topology
    from ddl_tpu_torch.datapusher import DataPusher
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.transport.connection import (
        ConsumerConnection, ProducerConnection, ThreadChannel,
    )

    sh = SHUFFLE
    Pool = _pool_producer_class()
    streams, pushers, errors = {}, {}, []

    def run_instance(i):
        try:
            topo = Topology(n_instances=sh["n"], instance_idx=i,
                            n_producers=1, mode=RunMode.THREAD)
            cons_end, prod_end = ThreadChannel.pair()
            pconn = ProducerConnection(prod_end, 1, pin_memory=True)

            def producer():
                try:
                    pushers[i] = DataPusher(pconn, topo, 1,
                                            shuffler_factory=factory_of(),
                                            metrics=Metrics())
                    pushers[i].push_data()
                except Exception as e:  # reported by the main thread
                    errors.append((f"producer {i}", repr(e)))

            pt = threading.Thread(target=producer, daemon=True)
            pt.start()
            loader = DistributedDataLoader(
                Pool(i, sh["rows"], sh["cols"], tag_scale=tag_scale),
                batch_size=sh["batch_size"],
                connection=ConsumerConnection([cons_end]),
                n_epochs=sh["n_epochs"],
                global_shuffle_fraction_exchange=sh["fraction"],
                output="device", device="cuda", metrics=Metrics(),
                timeout_s=120.0,
            )
            batches = []
            for _ in range(sh["n_epochs"]):
                for (b,) in loader:
                    batches.append(b)
                    loader.mark(Marker.END_OF_BATCH)
                loader.mark(Marker.END_OF_EPOCH)
            streams[i] = torch.cat(batches)
            torch.cuda.current_stream().synchronize()
            loader.shutdown()
            pt.join(60)
            if pt.is_alive():
                errors.append((f"producer {i}", "did not exit"))
        except Exception as e:  # reported by the main thread
            errors.append((f"instance {i}", repr(e)))

    t0 = time.perf_counter()
    ts = [threading.Thread(target=run_instance, args=(i,))
          for i in range(sh["n"])]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in ts) or errors:
        raise PhaseFailed(f"global-shuffle drain failed: {errors or 'hung'}")
    return streams, pushers, wall


def fabric_leg_parts(reps: int = 10):
    """Host-clock time of one device-fabric leg at the path's geometry,
    part by part, each part ending in a synchronise: the landing (the
    page-locked staging copy and the H2D copy), the exchange (K9), the
    hand-back (the D2H copy and the copies out to the producers).  In the
    path the landing runs into the exchange on one stream with no
    synchronise between them."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ops import device_shuffle as dsh

    sh = SHUFFLE
    n, half = sh["n"], int(sh["rows"] * sh["fraction"]) // 2
    rng = np.random.default_rng(SEED)
    blocks = [rng.standard_normal((2 * half, sh["cols"]), dtype=np.float32)
              for _ in range(n)]
    devs = ["cuda:0"] * n
    _, routes = _routes(n, 0)
    parts = dict(land=[], exchange=[], hand_back=[])
    for _ in range(reps + 2):
        t0 = time.perf_counter()
        gin = dsh.as_exchange_input(blocks, devs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = dsh.exchange_ring(gin, devs, routes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dsh.exchange_output_blocks(out, devs)
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    return {k: sorted(v[2:])[reps // 2] for k, v in parts.items()}


def phase_shuffle(profile: bool = False):
    """K9's checks and times, then the global-shuffle path: drained over
    the host exchange, the one-card device fabric, the fabric again and
    the host exchange again (turns, so neither side gains from going
    first).  Each device drain has the launch count set to 0 just before
    it and read just after."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ops import device_shuffle as dsh
    from ddl_tpu_torch.shuffle import (
        DeviceExchangeFabric, DeviceExchangeShuffler, Rendezvous,
        ThreadExchangeShuffler,
    )

    row = shuffle_kernel_checks()
    sh = SHUFFLE
    n = sh["n"]
    nex = int(sh["rows"] * sh["fraction"])
    round_bytes = dsh.exchange_wire_bytes(n, nex // 2, sh["cols"], np.float32)
    leg = fabric_leg_parts()
    log(f"[shuffle] one fabric leg, median of 10 (host clock, ms): "
        f"landing {leg['land']:.3f}, K9 round {leg['exchange']:.3f}, "
        f"hand-back {leg['hand_back']:.3f}")

    def host_drain():
        rdv = Rendezvous()
        return drain_instances(lambda: ThreadExchangeShuffler.factory(rdv))

    def device_drain():
        fabric = DeviceExchangeFabric(devices=["cuda:0"] * n)
        dsh.reset_launch_counts()
        streams, pushers, wall = drain_instances(
            lambda: DeviceExchangeShuffler.factory(fabric=fabric))
        torch.cuda.synchronize()
        return streams, pushers, wall, fabric, dsh.exchange_ring.launches

    host, host_pushers, host_s = host_drain()
    device_runs = [device_drain(), device_drain()]
    host2, _, host2_s = host_drain()

    ok = all(torch.equal(_bytes(host[i]), _bytes(host2[i])) for i in range(n))
    log(f"[shuffle] the two host-exchange drains serve the same streams {ok}")
    for k, (dev, pushers, _, fabric, launches) in enumerate(device_runs):
        for i in range(n):
            same = torch.equal(_bytes(host[i]), _bytes(dev[i]))
            origin = (dev[i][:, 0] / 1e6).floor().long().view(
                sh["n_epochs"], -1)
            mixed = all(bool((e != i).any()) for e in origin[1:])
            m = pushers[i].metrics
            fallbacks = m.counter("shuffle.device_fallbacks")
            rounds = m.counter("shuffle.device_rounds")
            inst_ok = (same and mixed and fallbacks == 0
                       and rounds >= sh["n_epochs"])
            log(f"[shuffle] device drain {k + 1}, instance {i}: stream "
                f"{tuple(dev[i].shape)} byte-identical to the host "
                f"exchange's {same}, epochs 1+ hold other instances' rows "
                f"{mixed}, device rounds {rounds:.0f}, fallbacks "
                f"{fallbacks:.0f} -> {'ok' if inst_ok else 'FAIL'}")
            ok &= inst_ok
        counted = launches == fabric.legs and launches > 0
        log(f"[shuffle] device drain {k + 1}: K9 launches {launches}, "
            f"fabric rounds {fabric.legs} -> {'ok' if counted else 'FAIL'}")
        ok &= counted
    host_rounds = min(p.shuffler.exchange_round for p in host_pushers.values())
    dev_rounds = [run[3].legs for run in device_runs]
    host_walls = [host_s, host2_s]
    dev_walls = [run[2] for run in device_runs]
    summary = {
        "host_drain_s": host_walls, "device_drain_s": dev_walls,
        "host_rounds": host_rounds, "device_rounds": dev_rounds,
        "round_bytes": round_bytes,
        "host_exchanged_bytes_per_s": [host_rounds * round_bytes / s
                                       for s in host_walls],
        "device_exchanged_bytes_per_s": [r * round_bytes / s for r, s
                                         in zip(dev_rounds, dev_walls)],
        "fabric_leg_ms": leg,
    }
    log(f"[shuffle] drains in turn (host, device, device, host): "
        f"{host_s:.3f}, {dev_walls[0]:.3f}, {dev_walls[1]:.3f}, "
        f"{host2_s:.3f} s; {host_rounds} / {dev_rounds[0]} / "
        f"{dev_rounds[1]} / {host_rounds} rounds of "
        f"{round_bytes / 2**20:.0f} MiB")
    if not ok:
        raise PhaseFailed("the global-shuffle path failed its checks")
    row["launches"] = device_runs[0][4]
    if profile:
        profile_run(device_drain, "device-fabric drain")
    return row, summary


# ------------------------------------------------------------- phase 5 ---

def _fanout_case(rows, cols, dtype, gen, offset=0):
    """A contiguous (rows, cols) block of random bytes of ``dtype`` on the
    card, starting ``offset`` bytes into its allocation (an offset that is
    not a multiple of 16 sends the kernels down their narrower paths)."""
    import torch

    isz = torch.empty(0, dtype=dtype).element_size()
    n = rows * cols * isz
    raw = torch.randint(0, 256, (n + offset,), generator=gen, device="cuda",
                        dtype=torch.uint8)
    return raw[offset:].view(dtype).view(rows, cols)


def _same_blocks(got, want):
    import torch

    return len(got.shards) == len(want) and all(
        torch.equal(_bytes(s.data), _bytes(w)) for s, w in zip(got.shards, want))


def fanout_kernel_checks():
    """K7 and K8 against their plain versions, byte for byte, on the shapes
    of phase (a) and on the 2-D views the main path hands them, then their
    times at the path's full-size geometry.  Returns the two kernels-JSON
    rows (launches filled in by the path)."""
    import torch

    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel.ici import _to2d

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, i32, u8, bf16 = torch.float32, torch.int32, torch.uint8, torch.bfloat16
    # (label, n, rows, cols, dtype, src, byte offset).  The reference
    # pipelines K7 in 4 chunks; its tail (10 rows) and its clamp (2 rows,
    # fewer than 16 chunks) are shapes here too.
    cases = [(f"n={n} fp32 x 256, src={n - 1}", n, 64, 256, f32, n - 1, 0)
             for n in (2, 3, 4, 8)]
    cases += [
        ("int32 x 256, n=4", 4, 64, 256, i32, 1, 0),
        ("uint8 x 256, n=4", 4, 64, 256, u8, 2, 0),
        ("bf16 x 256, n=4", 4, 64, 256, bf16, 3, 0),
        ("7-byte rows (uint8 x 7), n=8", 8, 24, 7, u8, 5, 0),
        ("10 rows (rows % 4 chunks != 0), n=2", 2, 10, 33, f32, 1, 0),
        ("2 rows (fewer than 16 chunks), n=2", 2, 2, 64, i32, 0, 0),
        ("source 3 bytes off 16-byte alignment, uint8 x 40, n=4", 4, 12, 40,
         u8, 1, 3),
        ("source 4 bytes off 16-byte alignment, fp32 x 9, n=3", 3, 6, 9, f32,
         2, 4),
    ]
    blocks = [(label, n, _fanout_case(rows, cols, dt, gen, offset), src)
              for label, n, rows, cols, dt, src, offset in cases]
    # The main path's own views (ici._to2d of its windows, on the anchor):
    # the 64 MiB window split on dim 1 (dp=4 and dp=2 x fsdp=2) and
    # flattened whole (replicated), and the token window split on dim 1.
    g = ICI
    window = (g["window"] // g["batch_size"], g["batch_size"], g["cols"])
    tokens = (TRAIN["window_rows"] // TRAIN["batch_size"],
              TRAIN["batch_size"], TRAIN["seq_len"])
    for label, shape, dt, split_dim in (
            ("window split on dim 1", window, f32, 1),
            ("window replicated", window, f32, 0),
            ("token window split on dim 1", tokens, i32, 1)):
        win = _fanout_case(math.prod(shape[:-1]), shape[-1], dt, gen).view(shape)
        view = _to2d(win, split_dim)
        blocks.append((f"path view {tuple(view.shape)} of the {shape} {label}",
                       g["n"], view, 0))
        del win
    ok = True
    for label, n, block, src in blocks:
        before = _bytes(block).clone()
        rows = block.shape[0]
        devs = ["cuda:0"] * n
        rep = fan.fanout_replicate(block, devs, src=src)
        shard = (fan.fanout_shard(block, devs, src=src) if rows % n == 0
                 else None)
        torch.cuda.synchronize()
        same_rep = _same_blocks(rep, fan.replicate_plain(block, n, src))
        same_shard = shard is None or _same_blocks(shard, fan.shard_plain(block, n))
        kept = torch.equal(_bytes(block), before)
        log(f"[check] K7/K8 {label}: K7 byte-equal to plain {same_rep}, K8 "
            + ("skipped (rows % n != 0)" if shard is None
               else f"byte-equal to plain {same_shard}")
            + f", input kept {kept} -> "
            + ("ok" if same_rep and same_shard and kept else "FAIL"))
        ok &= same_rep and same_shard and kept
    del blocks, block, rep, shard

    n, rows, cols = g["n"], g["rows"], g["cols"]
    block = torch.randn((rows, cols), generator=gen, device="cuda")
    devs = ["cuda:0"] * n
    rep = fan.fanout_replicate(block, devs)
    shard = fan.fanout_shard(block, devs)
    rep_want = fan.replicate_plain(block, n)
    shard_want = fan.shard_plain(block, n)
    torch.cuda.synchronize()
    errs = {
        "replicate": max(float((s.data - w).abs().max())
                         for s, w in zip(rep.shards, rep_want)),
        "shard": max(float((s.data - w).abs().max())
                     for s, w in zip(shard.shards, shard_want)),
    }
    full = _same_blocks(rep, rep_want) and _same_blocks(shard, shard_want)
    log(f"[check] K7/K8 full size n={n} ({rows}, {cols}) fp32: byte-equal "
        f"{full}, max abs err K7 {errs['replicate']} K8 {errs['shard']} | "
        f"tol 0 -> {'ok' if full else 'FAIL'}")
    ok &= full
    if not ok:
        raise PhaseFailed("K7/K8 disagree with their plain versions")
    del rep, shard, rep_want, shard_want

    # The library yardstick: one Tensor.copy_ per destination (timed here
    # only; nothing in the port runs it).
    block_rows = rows // n
    rep_dst = [torch.empty_like(block) for _ in range(n - 1)]
    shard_dst = [torch.empty((block_rows, cols), device="cuda")
                 for _ in range(n)]

    def copies_replicate():
        for d in rep_dst:
            d.copy_(block)

    def copies_shard():
        for i, d in enumerate(shard_dst):
            d.copy_(block[i * block_rows:(i + 1) * block_rows])

    # 4 GiB: ~1.3 ms of writes.  K7 launches only after allocating its
    # outputs (0.10-0.19 ms of host work a call, more on a slow host);
    # the flush must outlast that, or the start event times the wait.
    scratch = torch.empty(4 << 30, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    nbytes = rows * cols * 4
    timed = {
        "replicate": (lambda: fan.fanout_replicate(block, devs),
                      lambda: fan.replicate_plain(block, n), copies_replicate,
                      nbytes + (n - 1) * nbytes, f"copy_ x{n - 1}"),
        "shard": (lambda: fan.fanout_shard(block, devs),
                  lambda: fan.shard_plain(block, n), copies_shard,
                  2 * nbytes, f"copy_ x{n}"),
    }
    info = {"replicate": ("fanout_replicate", "_bcast_kernel", 99),
            "shard": ("fanout_shard", "_scatter_kernel", 155)}
    rows_out = []
    for mode, (kernel, plain, library, moved, lib_name) in timed.items():
        ms = _time_cold_ms(kernel, flush)
        plain_ms = _time_cold_ms(plain, flush)
        library_ms = _time_cold_ms(library, flush)
        call_ms = _time_ms(kernel, reps=50, warmup=5)
        bound_ms = moved / PEAK_BYTES * 1e3
        name, tpu_fn, line = info[mode]
        log(f"[time] {name}: {ms:.4f} ms (L2 cold; {call_ms:.4f} ms a call "
            f"back to back)  plain {plain_ms:.4f} ms  {lib_name} "
            f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms (bytes, "
            f"{moved / 2**20:.0f} MiB)")
        rows_out.append({
            "name": name,
            "route": "cuda",
            "source": "ddl_tpu_torch/ops/csrc/ici_fanout.cu",
            "replaces": f"ddl_tpu/ops/ici_fanout.py:{line} ({tpu_fn})",
            "launches": 0,
            "max_abs_err": errs[mode],
            "ms": ms,
            "back_to_back_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": library_ms,
            "library": lib_name,
        })
    del scratch, rep_dst, shard_dst
    return rows_out


def _sharding(axes, spec):
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh

    n = int(math.prod(axes.values()))
    return NamedSharding(make_mesh(axes, ["cuda:0"] * n), P(*spec))


def _ici_drain(producer, batch_size, n_epochs, host_windows=None, axes=None,
               spec=None, distribute="ici", waits=None):
    """Drain ``n_epochs`` windows of ``producer`` through a THREAD loader
    (2 producers).  Without ``axes`` the windows go to the host and are
    returned; with them each window lands on that mesh of positions of
    cuda:0, and every position's shard is held against its slice of
    ``host_windows``.  ``waits``, a list, gets each window's wait: from the
    end of the previous window's check to the window in hand.  Returns
    (windows or checks, metrics, wall s)."""
    import torch

    import ddl_tpu_torch
    from ddl_tpu_torch.observability import Metrics

    on_card = axes is not None
    metrics = Metrics()

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode="thread",
                                          nslots=2, pin_memory=on_card)
    def run(env):
        loader = ddl_tpu_torch.DistributedDataLoader(
            producer, batch_size=batch_size, connection=env.connection,
            n_epochs=n_epochs, output="device",
            device="cuda" if on_card else "cpu",
            sharding=_sharding(axes, spec) if on_card else None,
            distribute=distribute, metrics=metrics, timeout_s=120.0,
        )
        out = []
        t0 = t_prev = time.perf_counter()
        for k, win in enumerate(loader.windows(lookahead=1)):
            if waits is not None:
                if on_card:
                    torch.cuda.synchronize()
                waits.append(time.perf_counter() - t_prev)
            if not on_card:
                out.append(win.clone())
            else:
                host = host_windows[k]
                out.append(all(
                    s.data.is_contiguous() and torch.equal(
                        _bytes(s.data), _bytes(host[s.index].contiguous().cuda()))
                    for s in win.shards) and tuple(win.shape) == tuple(host.shape))
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
            if waits is not None:
                if on_card:
                    torch.cuda.synchronize()
                t_prev = time.perf_counter()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out, wall = run()
    return out, metrics, wall


def ici_ab(reps: int = 5):
    """The A/B of the JAX package's ICI bench: ``put_window`` of one 64 MiB
    window from page-locked memory through the ICI tier and through the
    plain per-position route, for the dp=4 and the replicated layouts,
    interleaved, each timed to a synchronise on the host clock; the
    minimum of ``reps``.  Then one window's parts, each synchronised."""
    import torch

    from ddl_tpu_torch.ingest import DeviceIngestor, device_put
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel import ici as ici_mod

    g = ICI
    shape = (g["window"] // g["batch_size"], g["batch_size"], g["cols"])
    window = torch.randn(shape, generator=torch.Generator().manual_seed(SEED))
    window = window.pin_memory()
    nbytes = window.numel() * 4
    out = {}
    for label, (axes, spec) in (("dp4", ({"dp": 4}, (None, "dp"))),
                                ("replicated", ({"dp": 4}, (None, None, None)))):
        sh = _sharding(axes, spec)
        ings = {d: DeviceIngestor(sharding=sh, distribute=d, metrics=Metrics())
                for d in ("ici", "xla")}
        times = {"ici": [], "xla": []}
        results = {}
        for _ in range(reps + 1):  # the first round warms both up
            for d, ing in ings.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results[d] = ing.hand_off(ing.put_window(window.numpy()))
                torch.cuda.synchronize()
                times[d].append(time.perf_counter() - t0)
        best = {d: min(t[1:]) for d, t in times.items()}
        same = all(torch.equal(_bytes(a.data), _bytes(b.data)) for a, b in
                   zip(results["ici"].shards, results["xla"].shards))
        fallbacks = ings["ici"].ici().metrics.counter("ici.fallbacks")
        out[label] = {
            "ici_bytes_per_s": nbytes / best["ici"],
            "plain_bytes_per_s": nbytes / best["xla"],
            "vs_plain": best["xla"] / best["ici"],
            "ici_ms": best["ici"] * 1e3, "plain_ms": best["xla"] * 1e3,
            "byte_identical": same, "fallbacks": fallbacks,
        }
        log(f"[ici-ab] {label} 64 MiB window, min of {reps}: ICI tier "
            f"{nbytes / best['ici'] / 1e9:.2f} GB/s ({best['ici'] * 1e3:.3f} ms), "
            f"plain route {nbytes / best['xla'] / 1e9:.2f} GB/s "
            f"({best['xla'] * 1e3:.3f} ms), vs_plain {best['xla'] / best['ici']:.3f}, "
            f"byte_identical {same}")
        if not same or fallbacks:
            raise PhaseFailed(f"ICI A/B {label}: byte_identical {same}, "
                              f"fallbacks {fallbacks}")

    # One dp=4 window's parts, each ending in a synchronise.
    sh = _sharding({"dp": 4}, (None, "dp"))
    dist = ici_mod.IciDistributor(sh, metrics=Metrics())
    plan = dist.plan(shape, torch.float32)
    ring = [sh.mesh.device_list[p] for p in plan.ring_positions]
    parts = dict(h2d=[], view_2d=[], kernel=[], finish=[])
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = device_put(window, dist.anchor(shape, torch.float32))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flat = ici_mod._to2d(block, plan.split_dim)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ring_out = fan.fanout_shard(flat, ring)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ici_mod._finish_shard(ring_out, plan, sh)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k].append(v * 1e3)
    out["dp4_parts_ms"] = {k: sorted(v[2:])[reps // 2] for k, v in parts.items()}
    log(f"[ici-ab] one dp=4 window's parts, median of {reps} (host clock, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["dp4_parts_ms"].items()))
    return out


def phase_ici(tmpdir: str, profile: bool = False):
    """K7/K8's checks and times, then the ICI ingest path: the 64 MiB
    windows of an ArrayProducer drained on three meshes of positions of
    cuda:0 (K8, K8 with the gather leg, K7) and a token stream at the
    Llama path's window (K8), every position's shard held against its
    slice of the host window; one ragged geometry through the plain route;
    the A/B.  Each drain has the launch counts set to 0 just before it and
    read just after."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ingest import DeviceIngestor
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.readers import ArrayProducer, TokenStreamProducer

    rows = fanout_kernel_checks()
    g = ICI
    data = np.random.default_rng(SEED).standard_normal(
        (g["n_rows"], g["cols"]), dtype=np.float32)

    def array_producer():
        return ArrayProducer(data, window_size=g["window"], seed=SEED)

    host, _, host_s = _ici_drain(array_producer(), g["batch_size"], g["n_epochs"])
    log(f"[ici] host stream: {len(host)} windows of {tuple(host[0].shape)} "
        f"fp32 ({host[0].numel() * 4 / 2**20:.0f} MiB) in {host_s:.3f} s")
    token_file = os.path.join(tmpdir, "ici_tokens.bin")
    ranks = np.random.default_rng(SEED).zipf(1.2, 1 << 20) - 1
    (ranks % VOCAB).astype(np.int32).tofile(token_file)

    def token_producer():
        return TokenStreamProducer(token_file, TRAIN["seq_len"],
                                   TRAIN["window_rows"], seed=SEED)

    tokens, _, _ = _ici_drain(token_producer(), TRAIN["batch_size"],
                              g["n_epochs"])
    runs = [
        ("dp=4, P(None, 'dp')", array_producer, g["batch_size"], host,
         {"dp": 4}, (None, "dp"), fan.fanout_shard),
        ("dp=2 x fsdp=2, P(None, 'dp')", array_producer, g["batch_size"], host,
         {"dp": 2, "fsdp": 2}, (None, "dp"), fan.fanout_shard),
        ("dp=4, replicated", array_producer, g["batch_size"], host,
         {"dp": 4}, (None, None, None), fan.fanout_replicate),
        ("token stream (2, 4, 2048) int32, dp=4, P(None, 'dp')", token_producer,
         TRAIN["batch_size"], tokens, {"dp": 4}, (None, "dp"), fan.fanout_shard),
    ]
    ok = True
    launches = {fn.__name__: 0 for fn in fan.KERNELS}
    summary = {"host_drain_s": host_s}
    for label, make, batch, want, axes, spec, kernel in runs:
        torch.cuda.synchronize()
        fan.reset_launch_counts()
        checks, m, wall = _ici_drain(make(), batch, g["n_epochs"], want, axes,
                                     spec)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in fan.KERNELS}
        windows = m.counter("ici.windows")
        fallbacks = m.counter("ici.fallbacks")
        idle = [fn for fn in fan.KERNELS if fn is not kernel]
        run_ok = (all(checks) and len(checks) == g["n_epochs"]
                  and fallbacks == 0 and windows == g["n_epochs"]
                  and counts[kernel.__name__] == windows
                  and all(counts[fn.__name__] == 0 for fn in idle))
        for name, c in counts.items():
            launches[name] += c
        log(f"[ici] {label}: {len(checks)} windows, every shard byte-equal to "
            f"its slice of the host window {all(checks)}, ici.windows "
            f"{windows:.0f}, ici.fallbacks {fallbacks:.0f}, launches {counts}, "
            f"drain {wall:.3f} s, ici.fanout {m.timer('ici.fanout').total_s * 1e3:.2f} ms"
            f", ici.redistribute {m.timer('ici.redistribute').total_s * 1e3:.2f} ms"
            f" (host clock, dispatch) -> {'ok' if run_ok else 'FAIL'}")
        summary[label] = {"drain_s": wall, "windows": windows,
                          "launches": counts}
        ok &= run_ok

    # A ragged geometry: a window whose batch dim (2) the dp=2 target
    # splits but the 4-position ring does not — no bounded plan, so it
    # takes the plain route, counted once.
    sh = _sharding({"dp": 2, "fsdp": 2}, (None, "dp"))
    ing = DeviceIngestor(sharding=sh, distribute="ici", metrics=Metrics())
    ragged = np.ascontiguousarray(host[0].numpy()[:, :2])
    fan.reset_launch_counts()
    got = [ing.hand_off(ing.put_window(ragged)) for _ in range(2)]
    torch.cuda.synchronize()
    fb = ing.metrics.counter("ici.fallbacks")
    same = all(torch.equal(_bytes(s.data), _bytes(
        torch.from_numpy(ragged)[s.index].contiguous().cuda()))
        for w in got for s in w.shards)
    ragged_ok = same and fb == 1 and sum(fn.launches for fn in fan.KERNELS) == 0
    log(f"[ici] ragged {ragged.shape} on dp=2 x fsdp=2: plain route, shards "
        f"byte-equal {same}, ici.fallbacks {fb:.0f} over 2 windows, no kernel "
        f"launch -> {'ok' if ragged_ok else 'FAIL'}")
    ok &= ragged_ok
    if not ok:
        raise PhaseFailed("the ICI ingest path failed its checks")
    if profile:
        profile_run(lambda: _ici_drain(array_producer(), g["batch_size"],
                                       g["n_epochs"], host, {"dp": 4},
                                       (None, "dp")), "ICI dp=4 drain")
    del host, tokens, got
    summary["ab"] = ici_ab()
    for row in rows:
        row["launches"] = launches[row["name"]]
    return rows, summary


# ------------------------------------------------------------- phase 6 ---

def profile_run(run, what: str) -> None:
    """Where a run's device time goes: ``torch.profiler`` over one more
    measured-size run (a fit, a drain).  Device-side events only
    (kernels, copies, sets), grouped; busy share is their summed time over
    the profiled run's wall (the side stream's copies overlap compute, so
    the sum can slightly exceed true occupancy)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side work only: not the CPU ops' attributed time, not the
    # device-side copies of annotation ranges (Optimizer.step#...), which
    # overlap the kernels they contain, nor CUPTI's queue-full markers.
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith(("Optimizer.", "ProfilerStep"))
        and "Command Buffer Full" not in e.key
    ]
    groups: dict = {}
    for e in events:
        name = e.key.lower()
        group = next((g for g, keys in (
            ("flash kernels", ("flash_", "id_range_kernel",
                               "row_terms_kernel", "pad_ids_kernel")),
            ("exchange kernel K9", ("exchange_kernel",)),
            ("fan-out kernels K7/K8", ("fanout_kernel",)),
            ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
            ("optimizer", ("multi_tensor_apply",)),
            ("copies", ("memcpy", "memset")),
        ) if any(k in name for k in keys)), "other elementwise / reductions")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    busy = sum(groups.values())
    log(f"[profile] profiled {what} {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / (wall * 1e3):.1%})")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {ms:9.2f} ms  {ms / busy:6.1%}  {g}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:5d}x  {e.key[:90]}")


def _corpus_stats(token_file: str, seq_len: int):
    """Mean segments per row and the share of positions the boundary mask
    drops, over the file's rows of ``seq_len`` tokens (the rows the
    producers draw from)."""
    import numpy as np

    tokens = np.fromfile(token_file, np.int32)
    rows = tokens[: len(tokens) // seq_len * seq_len].reshape(-1, seq_len)
    seg = seg_ids(rows)
    boundary = (seg[:, :-1] != seg[:, 1:]).sum()
    return float((seg[:, -1] + 1).mean()), float(boundary / seg.size)


def _shm_free_bytes() -> int:
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def _fit_mode(mode, producer, loss_fn, cfg, tag, card, profile=False,
              around=None, keep_metrics=False, init_params=None, train=None,
              optimizer=None, warmup=True, **loader_kw):
    """One training path in one producer mode at full width: a fresh
    ``Trainer`` from ``init_params`` (default: the Llama's of ``cfg`` at
    seed 0), a one-window warm-up fit (cuBLAS handles, allocator pools,
    the producers' first spawn) unless ``warmup`` is off, then the
    measured fit with the flash launch counts set to 0 just before it and
    read just after; ``loader_kw`` are further ``LoaderConfig`` fields of
    both fits.  ``train`` replaces the ``TRAIN`` geometry (batch_size,
    window_rows, n_epochs, n_producers; seq_len: the tokens a row counts)
    and ``optimizer`` the ``adamw(1e-5)`` factory.  ``around`` (a
    context-manager factory) wraps the measured fit only (phase 13 arms
    the observability there); ``keep_metrics`` returns its registry as
    ``summary["metrics"]``.  Everything else it allocated is dropped on
    return."""
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    tr = train or TRAIN
    trainer = Trainer(
        loss_fn=loss_fn,
        # No warm-up schedule in a 6-step smoke: a small rate keeps Adam's
        # first, sign-like steps from overshooting at this width.
        optimizer=optimizer or adamw(1e-5),
        init_params=(llama.init_params(cfg, seed=SEED, device="cuda")
                     if init_params is None else init_params),
        device="cuda",
        metrics=Metrics(),
    )

    def run(n_epochs):
        return trainer.fit(producer, config=LoaderConfig(
            batch_size=tr["batch_size"], n_epochs=n_epochs,
            n_producers=tr["n_producers"], mode=mode, window_stream=True,
            **loader_kw))

    if warmup:
        warm = run(1)
        del warm
        free_device_memory()  # the warm-up's state before the next one's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.metrics = m = Metrics()
    with (around() if around is not None else contextlib.nullcontext()):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        result = run(tr["n_epochs"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNELS}
    sm90 = {fn.__name__: fn.sm90_launches for fn in fa.KERNELS}
    steps_per_window = tr["window_rows"] // tr["batch_size"]
    steps = tr["n_epochs"] * steps_per_window
    tokens = steps * tr["batch_size"] * tr["seq_len"]
    # trainer.first_window: fit() to the first window handed to the steps
    # (spawn, handshake, first fill and copy); trainer.windows: from there
    # to the end of the last window's steps on the card's clock, every
    # step of the fit: the steady state.  The rest of the wall time is
    # teardown (loader shutdown, unregistering, joining the producers).
    first = m.timer("trainer.first_window").total_s
    steady_steps = steps
    steady_s = m.timer("trainer.windows").total_s
    summary = {
        "mode": mode, "losses": result.losses, "steps": steps,
        "step_ms": wall / steps * 1e3, "tokens_per_s": tokens / wall,
        "first_window_s": first,
        "handshake_s": m.timer("consumer.handshake").total_s,
        "teardown_s": wall - first - steady_s,
        "steady_step_ms": steady_s / steady_steps * 1e3,
        "steady_tokens_per_s": (steady_steps * tr["batch_size"]
                                * tr["seq_len"] / steady_s),
        "ingest_overlap_s": m.timer("trainer.ingest_overlap").total_s,
        "window_wait_s": m.timer("trainer.window_wait").total_s,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "counters": {k: m.counter(k) for k in (
            "transport.rings.NativeShmRing", "transport.rings.PyShmRing",
            "transport.rings.ThreadRing", "ingest.registered_rings",
            "consumer.windows", "staging.alias_windows",
            "staging.alias_fallbacks", "staging.pool_alias_drops",
            "integrity.staging_verify_failures", "staging.inline_fallbacks",
            "staging.pool_hits", "staging.pool_misses",
            "integrity.corrupt_windows", "producer.exits_clean",
            "producer.exits_failed")},
        "launches": launches, "sm90_launches": sm90,
    }
    log(f"{tag} {mode}: per-window losses {result.losses}")
    log(f"{tag} {mode}: {steps} steps in {wall:.3f} s: {wall / steps * 1e3:.1f} "
        f"ms/step, {tokens / wall:.0f} tokens/s, peak memory "
        f"{summary['peak_bytes'] / 2**30:.2f} GiB ({card})")
    log(f"{tag} {mode}: first window at the steps {first:.3f} s after "
        f"fit() (handshake {summary['handshake_s']:.3f} s); steady state, "
        f"the {steady_steps} steps from there, "
        f"{summary['steady_step_ms']:.1f} ms/step, "
        f"{summary['steady_tokens_per_s']:.0f} tokens/s; teardown "
        f"{summary['teardown_s']:.3f} s; "
        f"trainer.ingest_overlap {summary['ingest_overlap_s'] * 1e3:.2f} ms, "
        f"trainer.window_wait {summary['window_wait_s'] * 1e3:.2f} ms; "
        f"/dev/shm free {_shm_free_bytes()} bytes ({card})")
    log(f"{tag} {mode}: counters {json.dumps(summary['counters'])}")
    if keep_metrics:
        summary["metrics"] = m
    del result
    if profile:
        profile_run(lambda: run(tr["n_epochs"]), f"{tag} {mode} fit")
    del trainer
    free_device_memory()
    return summary


def _fit_gates(s, ran, idle, expected, faults) -> None:
    """The gates every full-width fit of ``_fit_mode`` shares: one finite
    loss a window; each kernel of ``ran`` launched ``expected`` times, all
    on the wgmma route, those of ``idle`` never; every window on the alias
    route with no fallback, drop or CRC failure.  Appends to ``faults``."""
    mode, c = s["mode"], s["counters"]
    if not (len(s["losses"]) == TRAIN["n_epochs"]
            and all(math.isfinite(x) for x in s["losses"])):
        faults.append(f"{mode}: losses {s['losses']}")
    if not (all(s["launches"][fn.__name__] == expected for fn in ran)
            and all(s["launches"][fn.__name__] == 0 for fn in idle)
            and all(s["sm90_launches"][fn.__name__] == expected
                    for fn in ran)):
        faults.append(f"{mode}: flash launches {s['launches']} / "
                      f"{s['sm90_launches']}")
    windows = c["consumer.windows"]
    if not (windows == TRAIN["n_epochs"]
            and c["staging.alias_windows"] == windows
            and c["staging.alias_fallbacks"] == 0
            and c["staging.pool_alias_drops"] == 0
            and c["integrity.staging_verify_failures"] == 0
            and c["staging.inline_fallbacks"] == 0
            and c["integrity.corrupt_windows"] == 0):
        faults.append(f"{mode}: staging counters {c}")


def _process_gates(s, faults) -> None:
    """A PROCESS fit's rings are native and registered and its producers
    exit 0.  Appends to ``faults``."""
    c, n = s["counters"], TRAIN["n_producers"]
    if not (c["transport.rings.NativeShmRing"] == n
            and c["transport.rings.PyShmRing"] == 0
            and c["ingest.registered_rings"] == n
            and c["producer.exits_clean"] == n
            and c["producer.exits_failed"] == 0):
        faults.append(f"process: rings, registration or exits {c}")


def phase_train(tmpdir: str, card: str, profile: bool = False,
                packed: bool = False):
    """One of the port's paths at full width: ``Trainer.fit`` over a
    ``TokenStreamProducer`` stream (K1-K3) or, ``packed``, over a
    ``PackedTokenProducer`` stream of documents into the segment-masked
    loss (K4-K6), first with THREAD producers, then with spawned PROCESS
    producers over native shm rings that the loader page-locks.  Both
    fits start from the same parameters and must see the same windows,
    run the same kernels and give the same losses."""
    import numpy as np

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.readers import PackedTokenProducer, TokenStreamProducer

    tr = TRAIN
    tag = "[train-packed]" if packed else "[train]"
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    token_file = os.path.join(tmpdir, "docs.bin" if packed else "tokens.bin")
    if packed:
        documents(tr["n_tokens"]).tofile(token_file)
        segs, dropped = _corpus_stats(token_file, tr["seq_len"])
        log(f"{tag} {tr['n_tokens']} tokens of documents: {segs:.2f} segments "
            f"per {tr['seq_len']}-token row, boundary mask drops {dropped:.3%} "
            f"of positions")
        producer = PackedTokenProducer(token_file, tr["seq_len"],
                                       tr["window_rows"], delimiter=EOT,
                                       seed=SEED)

        def loss_fn(p, b):
            return llama.next_token_loss(p, b[0], cfg, segment_ids=b[1])
    else:
        # A Zipf-distributed token stream (the rank-frequency law of
        # text): its unigram skew is learnable within a few steps, so the
        # losses should fall from the random-init level.
        ranks = np.random.default_rng(SEED).zipf(1.2, tr["n_tokens"]) - 1
        (ranks % cfg.vocab).astype(np.int32).tofile(token_file)
        producer = TokenStreamProducer(token_file, tr["seq_len"],
                                       tr["window_rows"], seed=SEED)

        def loss_fn(p, b):
            return llama.next_token_loss(p, b[0], cfg)
    log(f"{tag} llama3_8b widths, {cfg.n_layers} layers, "
        f"{llama.param_count(cfg) / 1e9:.3f} B params, dtype {cfg.dtype}, "
        f"attn_impl {cfg.attn_impl}, remat {cfg.remat}")

    thread = _fit_mode("thread", producer, loss_fn, cfg, tag, card, profile)
    proc = _fit_mode("process", producer, loss_fn, cfg, tag, card)

    steps = thread["steps"]
    expected = cfg.n_layers * steps
    fwd, dq, dkv = fa.KERNELS[3:] if packed else fa.KERNELS[:3]
    ran, idle = ((fa.KERNELS[3:], fa.KERNELS[:3]) if packed
                 else (fa.KERNELS[:3], fa.KERNELS[3:]))
    faults = []
    for s in (thread, proc):
        log(f"{tag} {s['mode']}: kernel launches in this run: {s['launches']} "
            f"(expected {cfg.n_layers} layers x {steps} steps = {expected} "
            f"for {[fn.__name__ for fn in ran]}, 0 for the others); on the "
            f"wgmma kernels: {s['sm90_launches']}")
        _fit_gates(s, ran, idle, expected, faults)
    _process_gates(proc, faults)
    rel = max(abs(a - b) / abs(b) for a, b in zip(proc["losses"],
                                                   thread["losses"]))
    log(f"{tag} process vs thread losses: max relative difference {rel:.3e} "
        f"({'bit-equal' if proc['losses'] == thread['losses'] else 'not bit-equal'})")
    if not rel <= 1e-5:
        faults.append(f"process losses {proc['losses']} vs thread "
                      f"{thread['losses']}")
    if faults:
        raise PhaseFailed(f"{tag} training runs failed their checks: "
                          + "; ".join(faults))
    summary = {
        "step_ms": thread["step_ms"], "tokens_per_s": thread["tokens_per_s"],
        "peak_bytes": thread["peak_bytes"], "losses": thread["losses"],
        "steps": steps, "sm90_launches": thread["sm90_launches"][fwd.__name__],
        "dq_sm90_launches": thread["sm90_launches"][dq.__name__],
        "dkv_sm90_launches": thread["sm90_launches"][dkv.__name__],
        "thread": thread, "process": proc,
    }
    if packed:
        summary.update(segments_per_row=segs, boundary_dropped=dropped)
    return thread["launches"], summary


# ------------------------------------------------------------- phase 7 ---

#: The recovery phase: the token cell of phase 6 over 6 windows (12 steps),
#: one producer SIGKILLed at its second refill; the global-shuffle
#: geometry of phase 4 with instance 0's producer SIGKILLed at its third.
RECOVERY = dict(n_epochs=6, kill_at=2, shuffle_kill_at=3)
#: /dev/shm the phase needs at least: the rings of the fits (2 x 2 slots
#: of 64 KiB) and of the four shuffle instances (4 x 2 slots of 8 MiB),
#: plus each round's lanes (2 x 2 MiB per instance) and their retained
#: copies, with room to spare.
RECOVERY_SHM_BYTES = 256 << 20


def _kill_once(sentinel, who) -> None:
    """SIGKILL this process (no ``finally`` runs, as under the OOM
    killer) unless the sentinel file says an earlier incarnation did; the
    file records the wall time of the kill and who died."""
    import signal

    if sentinel is None or os.path.exists(sentinel):
        return
    with open(sentinel, "w") as f:
        f.write(json.dumps({"t": time.time(), "who": who}))
    os.kill(os.getpid(), signal.SIGKILL)


class KillOnceProducer:
    """Wraps a producer function: producer ``victim``'s first
    incarnation SIGKILLs itself at its refill ``kill_at``, once
    (``_kill_once``); every call is otherwise the wrapped producer's, so
    a recovered run serves the same windows.  Module-level, so spawned
    producers unpickle it."""

    def __init__(self, inner, sentinel, kill_at, victim=1):
        self.inner, self.sentinel, self.kill_at = inner, sentinel, kill_at
        self.victim = victim
        self.refills = 0
        self.producer_idx = 0

    def __getattr__(self, name):
        # Capabilities (supports_inplace_fill) are the wrapped producer's.
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def on_init(self, **kw):
        self.producer_idx = kw.get("producer_idx", 0)
        return self.inner.on_init(**kw)

    def post_init(self, **kw):
        return self.inner.post_init(**kw)

    def execute_function(self, **kw):
        self.refills += 1
        if self.refills == self.kill_at and self.producer_idx == self.victim:
            _kill_once(self.sentinel, self.producer_idx)
        return self.inner.execute_function(**kw)

    def fast_forward(self, n, **kw):
        self.refills += n
        return self.inner.fast_forward(n, **kw)


def _token_trainer(cfg, respawn: bool):
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    return Trainer(
        loss_fn=lambda p, b: llama.next_token_loss(p, b[0], cfg),
        optimizer=adamw(1e-5),
        init_params=llama.init_params(cfg, seed=SEED, device="cuda"),
        device="cuda", metrics=Metrics(), watchdog_respawn=respawn,
    )


def _recovery_fit(trainer, producer, mode, tag, card):
    """One measured fit of the recovery cell: flash launch counts set to
    0 just before and read just after; each window's wall time when the
    stream hands it to the steps."""
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa

    rc, tr = RECOVERY, TRAIN
    served = []

    def hook(win):
        served.append(time.time())
        return win

    trainer.metrics = m = Metrics()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    res = trainer.fit(producer, window_hook=hook, config=LoaderConfig(
        batch_size=tr["batch_size"], n_epochs=rc["n_epochs"],
        n_producers=tr["n_producers"], mode=mode, window_stream=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = rc["n_epochs"] * tr["window_rows"] // tr["batch_size"]
    out = {
        "mode": mode, "losses": res.losses, "served": served, "wall_s": wall,
        "launches": [fn.launches for fn in fa.KERNELS],
        "sm90_launches": [fn.sm90_launches for fn in fa.KERNELS],
        "steady_step_ms": m.timer("trainer.windows").total_s / steps * 1e3,
        "first_window_s": m.timer("trainer.first_window").total_s,
        "window_wait_s": m.timer("trainer.window_wait").total_s,
        "respawn_call_s": m.timer("watchdog.respawn").total_s,
        "replay_s": m.timer("integrity.replay").total_s,
        "counters": {k: m.counter(k) for k in (
            "watchdog.respawns", "watchdog.failures", "consumer.windows",
            "staging.alias_windows", "staging.alias_fallbacks",
            "staging.pool_alias_drops", "staging.inline_fallbacks",
            "integrity.staging_verify_failures", "integrity.corrupt_windows",
            "integrity.replays", "integrity.replay_exhausted",
            "ingest.registered_rings", "transport.rings.NativeShmRing",
            "transport.rings.PyShmRing", "producer.exits_clean",
            "producer.exits_failed", "ctrl.acked")},
    }
    log(f"{tag}: {steps} steps in {wall:.3f} s, steady state "
        f"{out['steady_step_ms']:.1f} ms/step, first window "
        f"{out['first_window_s']:.3f} s, trainer.window_wait "
        f"{out['window_wait_s'] * 1e3:.2f} ms ({card})")
    log(f"{tag}: losses {res.losses}")
    log(f"{tag}: counters {json.dumps(out['counters'])}")
    del res
    return out


def _fit_faults(run, clean, tag, faults, **want):
    """The gates every recovery fit shares, plus ``want``'s counters."""
    rc, c = RECOVERY, run["counters"]
    if run["losses"] != clean["losses"]:
        faults.append(f"{tag}: losses {run['losses']} != {clean['losses']}")
    if (run["launches"] != clean["launches"]
            or run["sm90_launches"] != clean["sm90_launches"]):
        faults.append(f"{tag}: launches {run['launches']} / "
                      f"{run['sm90_launches']} != {clean['launches']} / "
                      f"{clean['sm90_launches']}")
    base = {"consumer.windows": rc["n_epochs"],
            "staging.alias_windows": rc["n_epochs"],
            "staging.alias_fallbacks": 0, "staging.pool_alias_drops": 0,
            "staging.inline_fallbacks": 0,
            "integrity.staging_verify_failures": 0,
            "watchdog.failures": 0, "integrity.replay_exhausted": 0,
            "transport.rings.PyShmRing": 0}
    base.update(want)
    bad = {k: (c[k], v) for k, v in base.items() if c[k] != v}
    if bad:
        faults.append(f"{tag}: counters (got, want) {bad}")


def recovery_fits(tmpdir: str, card: str):
    """(a) the token cell in PROCESS mode, undisturbed and with one
    producer SIGKILLed at its second refill under a respawning watchdog;
    (b) the same cell in THREAD mode with producer 1's window of seq 2
    corrupted after its trailer was stamped, by a fault plan
    (``producer.commit`` RING_CORRUPTION).  Both must give the undisturbed
    fit's losses bit for bit and launch the same kernels as often."""
    import numpy as np

    from ddl_tpu_torch import faults as flt
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.readers import TokenStreamProducer

    rc, tr = RECOVERY, TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    token_file = os.path.join(tmpdir, "tokens.bin")
    if not os.path.exists(token_file):
        ranks = np.random.default_rng(SEED).zipf(1.2, tr["n_tokens"]) - 1
        (ranks % cfg.vocab).astype(np.int32).tofile(token_file)
    tokens = TokenStreamProducer(token_file, tr["seq_len"], tr["window_rows"],
                                 seed=SEED)
    trainer = _token_trainer(cfg, respawn=True)
    clean = _recovery_fit(trainer, tokens, "process", "[recovery] clean",
                          card)
    sentinel = os.path.join(tmpdir, "killed")
    killed = _recovery_fit(
        trainer, KillOnceProducer(tokens, sentinel, rc["kill_at"]),
        "process", "[recovery] sigkill", card)

    # Producer 1's third commit (seq 2), flipped after the stamp.
    plan = flt.FaultPlan([flt.FaultSpec(
        "producer.commit", flt.FaultKind.RING_CORRUPTION, at=3,
        producer_idx=1, param=1)], seed=SEED)
    with flt.armed(plan):
        replayed = _recovery_fit(trainer, tokens, "thread",
                                 "[recovery] corrupt slot", card)
    fired = plan.fired
    del trainer
    free_device_memory()

    faults = []
    n = tr["n_producers"]
    proc = {"ingest.registered_rings": n, "transport.rings.NativeShmRing": n,
            "producer.exits_clean": n, "producer.exits_failed": 0,
            "integrity.corrupt_windows": 0, "integrity.replays": 0}
    _fit_faults(clean, clean, "clean", faults, **{"watchdog.respawns": 0},
                **proc)
    _fit_faults(killed, clean, "sigkill", faults,
                **{"watchdog.respawns": 1}, **proc)
    _fit_faults(replayed, clean, "corrupt slot", faults,
                **{"watchdog.respawns": 0, "integrity.corrupt_windows": 1,
                   "integrity.replays": 1, "ingest.registered_rings": 0})
    expected = cfg.n_layers * rc["n_epochs"] * tr["window_rows"] // tr[
        "batch_size"]
    if clean["launches"] != [expected] * 3 + [0] * 3:
        faults.append(f"clean fit launches {clean['launches']}, expected "
                      f"{expected} for K1-K3")
    if not os.path.exists(sentinel):
        faults.append("the SIGKILL never fired")
        recovery_s, died = float("nan"), None
    else:
        with open(sentinel) as f:
            kill = json.load(f)
        died = kill["who"]
        # Windows are served in rotation; the dead producer's first window
        # from its replacement is the one it was filling when it died.
        k = 2 * (rc["kill_at"] - 1) + (died - 1)
        recovery_s = killed["served"][k] - kill["t"]
    if len(fired) != 1:
        faults.append(f"the corruption fired {len(fired)} times")
    log(f"[recovery] producer {died} SIGKILLed at its refill "
        f"{rc['kill_at']}: recovery (kill to the replacement's first served "
        f"window) {recovery_s:.3f} s, of which the respawn call (spawn and "
        f"rejoin handshake) {killed['respawn_call_s']:.3f} s; "
        f"trainer.window_wait {killed['window_wait_s'] * 1e3:.1f} ms against "
        f"{clean['window_wait_s'] * 1e3:.1f} ms undisturbed; steady state "
        f"{killed['steady_step_ms']:.1f} against {clean['steady_step_ms']:.1f} "
        f"ms/step ({card})")
    log(f"[recovery] corrupt slot: replay (quarantine to the replayed "
        f"window) {replayed['replay_s'] * 1e3:.2f} ms; trainer.window_wait "
        f"{replayed['window_wait_s'] * 1e3:.1f} ms; steady state "
        f"{replayed['steady_step_ms']:.1f} ms/step ({card})")
    if faults:
        raise PhaseFailed("[recovery] fits failed their checks: "
                          + "; ".join(faults))
    return {
        "recovery_s": recovery_s,
        "respawn_call_s": killed["respawn_call_s"],
        "replay_s": replayed["replay_s"],
        "window_wait_s": {"clean": clean["window_wait_s"],
                          "sigkill": killed["window_wait_s"],
                          "corrupt": replayed["window_wait_s"]},
        "steady_step_ms": {"clean": clean["steady_step_ms"],
                           "sigkill": killed["steady_step_ms"],
                           "corrupt": replayed["steady_step_ms"]},
        "first_window_s": {"clean": clean["first_window_s"],
                           "sigkill": killed["first_window_s"],
                           "corrupt": replayed["first_window_s"]},
        "losses": clean["losses"],
        "clean": clean,
    }


def process_shuffle_drain(session, sentinel=None, **wire):
    """The global-shuffle path with PROCESS producers: four instances in
    this process, each a WorkerSet of one spawned producer exchanging
    over ``ShmRendezvous(session)``, each loader draining its windows
    onto cuda:0 through the staged engine.  With ``sentinel``, instance
    0's producer SIGKILLs itself at its refill ``shuffle_kill_at`` and a
    watchdog respawns it.  Returns (per-instance windows as card tensors
    of shape (rows, cols) per epoch, the loaders' metrics, the drain's
    seconds, the watchdog's respawns).  ``wire`` goes to the shuffler
    factory (``wire_dtype=``, ``codec=``)."""
    import threading

    import torch

    from ddl_tpu_torch import DistributedDataLoader, Marker, RunMode, Topology
    from ddl_tpu_torch.env import WorkerSet
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.shuffle import ShmRendezvous, ThreadExchangeShuffler
    from ddl_tpu_torch.watchdog import Watchdog

    sh, rc = SHUFFLE, RECOVERY
    factory = ThreadExchangeShuffler.factory(rendezvous=ShmRendezvous(session),
                                             **wire)
    streams, metrics, errors = {}, {}, []
    sets = [None] * sh["n"]
    t0 = time.perf_counter()
    for i in range(sh["n"]):  # the spawns start together
        sets[i] = WorkerSet(
            Topology(n_instances=sh["n"], instance_idx=i, n_producers=1,
                     mode=RunMode.PROCESS),
            nslots=2, pin_memory=True, shuffler_factory=factory)
    wd = None
    if sentinel is not None:
        wd = Watchdog(sets[0], poll_interval_s=0.2, stall_budget_s=60.0,
                      respawn=True, metrics=Metrics()).start()

    def run_instance(i):
        try:
            metrics[i] = Metrics()
            producer = PoolProducer(
                i, sh["rows"], sh["cols"],
                sentinel=sentinel if i == 0 else None,
                kill_at=rc["shuffle_kill_at"] if i == 0 else 0)
            loader = DistributedDataLoader(
                producer, batch_size=sh["batch_size"],
                connection=sets[i].connection, n_epochs=sh["n_epochs"],
                global_shuffle_fraction_exchange=sh["fraction"],
                output="device", device="cuda", metrics=metrics[i],
                timeout_s=120.0)
            wins = []
            for win in loader.windows(lookahead=1):
                wins.append(win.reshape(-1, sh["cols"]))
                loader.mark(Marker.END_OF_EPOCH)
            torch.cuda.current_stream().synchronize()
            streams[i] = wins
            loader.shutdown()
        except Exception as e:  # reported by the main thread
            errors.append((f"instance {i}", repr(e)))

    ts = [threading.Thread(target=run_instance, args=(i,))
          for i in range(sh["n"])]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    wall = time.perf_counter() - t0
    if wd is not None:
        wd.stop()
    for ws in sets:
        ws.abort()
        ws.join(30.0)
    if any(t.is_alive() for t in ts) or errors:
        raise PhaseFailed(f"PROCESS shuffle drain failed: {errors or 'hung'}")
    codes = [ws.exitcodes for ws in sets]
    if codes != [[0]] * sh["n"]:
        raise PhaseFailed(f"PROCESS shuffle producers exited with {codes}")
    return streams, metrics, wall, list(wd.respawns) if wd else []


def recovery_shuffle(tmpdir: str, card: str):
    """(c) The cross-process global shuffle at phase 4's geometry: the
    THREAD tier's host drain, then four PROCESS instances over one
    ShmRendezvous session (byte-identical streams, rows mixed across
    instances, the session directory gone after cleanup), then again
    with instance 0's producer SIGKILLed mid-exchange and respawned
    (every round's windows across the instances partition the rows)."""
    import torch

    from ddl_tpu_torch.shuffle import (
        Rendezvous, ShmRendezvous, ThreadExchangeShuffler, make_session,
    )

    sh = SHUFFLE
    free = _shm_free_bytes()
    if free < RECOVERY_SHM_BYTES:
        raise PhaseFailed(f"/dev/shm has {free} bytes free, the recovery "
                          f"phase needs {RECOVERY_SHM_BYTES}")
    rdv = Rendezvous()
    host, _, host_s = drain_instances(
        lambda: ThreadExchangeShuffler.factory(rdv))
    faults = []
    session = make_session("ddl-smoke")
    proc, pmetrics, proc_s, _ = process_shuffle_drain(session)
    board = ShmRendezvous(session)
    board.cleanup()
    if os.path.exists(board._dir):
        faults.append(f"session directory {board._dir} left after cleanup")
    for i in range(sh["n"]):
        got = torch.cat(proc[i])
        same = torch.equal(_bytes(got), _bytes(host[i]))
        origin = (got[:, 0] / 1e6).floor().long().view(sh["n_epochs"], -1)
        mixed = all(bool((e != i).any()) for e in origin[1:])
        m = pmetrics[i]
        routes = (m.counter("staging.alias_windows") == sh["n_epochs"]
                  and m.counter("ingest.registered_rings") == 1
                  and m.counter("staging.alias_fallbacks") == 0
                  and m.counter("staging.inline_fallbacks") == 0
                  and m.counter("transport.rings.NativeShmRing") == 1)
        log(f"[recovery-shuffle] PROCESS instance {i}: stream byte-identical "
            f"to the THREAD host drain's {same}, rows from other instances "
            f"{mixed}, alias route on a registered native ring {routes}")
        if not (same and mixed and routes):
            faults.append(f"instance {i}: same {same} mixed {mixed} "
                          f"routes {routes}")
    sentinel = os.path.join(tmpdir, "shuffle-killed")
    session2 = make_session("ddl-smoke")
    killed, kmetrics, killed_s, respawns = process_shuffle_drain(
        session2, sentinel=sentinel)
    ShmRendezvous(session2).cleanup()
    import numpy as np

    everything = np.sort(np.concatenate([
        i * 1e6 + np.arange(sh["rows"]) for i in range(sh["n"])]))
    partitions = all(
        np.array_equal(np.sort(torch.cat([killed[i][e][:, 0]
                                          for i in range(sh["n"])])
                               .cpu().numpy().astype(np.float64)),
                       everything)
        for e in range(sh["n_epochs"]))
    still_same = all(torch.equal(_bytes(torch.cat(killed[i])),
                                 _bytes(host[i])) for i in range(sh["n"]))
    log(f"[recovery-shuffle] SIGKILL of instance 0's producer at its refill "
        f"{RECOVERY['shuffle_kill_at']}: fired {os.path.exists(sentinel)}, "
        f"respawns {respawns}, every round partitions the rows {partitions}, "
        f"streams still byte-identical to the THREAD drain's {still_same}")
    if not (os.path.exists(sentinel) and respawns == [1] and partitions):
        faults.append(f"kill run: respawns {respawns}, partitions "
                      f"{partitions}")
    log(f"[recovery-shuffle] drains: THREAD host {host_s:.3f} s, PROCESS "
        f"{proc_s:.3f} s, PROCESS with a SIGKILL and a respawn "
        f"{killed_s:.3f} s (spawns included; {card})")
    if faults:
        raise PhaseFailed("[recovery-shuffle] failed its checks: "
                          + "; ".join(faults))
    return {"thread_drain_s": host_s, "process_drain_s": proc_s,
            "process_killed_drain_s": killed_s, "respawns": respawns,
            "killed_streams_identical": still_same}


def phase_recovery(tmpdir: str, card: str):
    """Phase 7: recovery in PROCESS mode — the respawned producer, the
    quarantine and replay of a corrupt slot, and the cross-process global
    shuffle with a producer death during the exchange."""
    t0 = time.perf_counter()
    fits = recovery_fits(tmpdir, card)
    shuffle = recovery_shuffle(tmpdir, card)
    free_device_memory()
    log(f"[recovery] phase 7 took {time.perf_counter() - t0:.1f} s")
    return {"fits": fits, "shuffle": shuffle}


# ------------------------------------------------------------- phase 8 ---

#: The example's path at full width (the token cell of phases 6-7): a
#: PROCESS fit preempted after window ``notice_at`` and resumed, against
#: an undisturbed fit; evaluate on a held-out stream; greedy decode.
EXAMPLE = dict(n_epochs=4, notice_at=2, eval_epochs=2,
               eval_seeds=(SEED + 1, SEED + 2, SEED + 3),
               prompt=16, new_tokens=16, deadline_s=120.0)
#: The evaluate gate: the flash metric against the dense path's loss on
#: the same batches, relative.  It lies between two readings of this
#: phase (PERF.md §6): the largest flash-vs-dense gap over the held-out
#: seeds, and the smallest gap of two controls, the dense path with its
#: causal mask or its softmax scale dropped.  The phase checks both
#: sides each run: gap <= limit < every control's gap.
EVAL_LOSS_RTOL = 1e-4
#: Cached-decode logits (O(1) at this init) against the no-cache
#: forward, absolute (~6 bf16 ulps at |logit| 4).
BF16_LOGIT_ATOL = 0.1


def _layered_config(tmpdir: str):
    """The run's configs through ``load()``, the checkpoint directory set
    through ``DDL_TORCH_CHECKPOINT_DIR``; returns them with each
    LoaderConfig field's source."""
    from ddl_tpu_torch.config import LoaderConfig, TrainConfig

    tr = TRAIN
    ckpt_dir = os.path.join(tmpdir, "ckpt")
    os.environ["DDL_TORCH_CHECKPOINT_DIR"] = ckpt_dir
    kw = dict(batch_size=tr["batch_size"], n_epochs=EXAMPLE["n_epochs"],
              n_producers=tr["n_producers"], mode="process",
              window_stream=True)
    try:
        cfg = LoaderConfig.load(**kw)
        train_cfg = TrainConfig.load()
        source = {
            f.name: ("kwarg" if f.name in kw else
                     "env" if f"DDL_TORCH_{f.name.upper()}" in os.environ
                     else "default")
            for f in dataclasses.fields(LoaderConfig)
        }
    finally:
        del os.environ["DDL_TORCH_CHECKPOINT_DIR"]
    if cfg.checkpoint_dir != ckpt_dir:
        raise PhaseFailed(f"[example] checkpoint_dir {cfg.checkpoint_dir!r} "
                          f"did not come from DDL_TORCH_CHECKPOINT_DIR")
    return cfg, train_cfg, source


def _example_fit(cfg, train_cfg, model, producer, ckpt_dir=None, guard=None,
                 notice_at=None):
    """One full-width PROCESS fit from ``init_params(seed=0)``; returns the
    result and the trainer (the caller drops both)."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    from ddl_tpu_torch import faults as flt

    trainer = Trainer(
        loss_fn=lambda p, b: llama.next_token_loss(p, b[0], model),
        optimizer=adamw(1e-5),
        init_params=llama.init_params(model, seed=SEED, device="cuda"),
        device="cuda", metrics=guard.metrics if guard else Metrics(),
        train_config=train_cfg, checkpoint_dir=ckpt_dir,
        # Only the drain's forced generation: a periodic one would write
        # another ~17.8 GB per window.
        checkpoint_every_epochs=1000, checkpoint_async=True,
        preemption_guard=guard,
    )
    # The notice: the resilience.notice site's PREEMPT_NOTICE at the
    # guard's notice_at-th poll, the boundary after window notice_at.
    plan = (flt.FaultPlan([flt.FaultSpec(
        "resilience.notice", flt.FaultKind.PREEMPT_NOTICE, at=notice_at)])
        if notice_at is not None else None)
    with (flt.armed(plan) if plan is not None else contextlib.nullcontext()):
        res = trainer.fit(producer, config=cfg)
    if plan is not None and len(plan.fired) != 1:
        raise PhaseFailed(f"[example] the notice fired {len(plan.fired)} "
                          "times")
    return res, trainer


def _dense_loss(params, batches, model, mask=True, scale=True):
    """Mean ``next_token_loss`` over ``batches`` through the dense
    attention, under ``no_grad``.  ``mask=False`` / ``scale=False`` are
    the evaluate gate's controls: the causal mask or the softmax scale
    dropped, the faults the gate must catch in the flash forward."""
    import torch

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel import ring_attention

    def dense(q, k, v, impl=None, causal=True, kv_repeat=1,
              segment_ids=None, mesh=None):
        if not scale:
            q = q * q.shape[-1] ** 0.5
        return ring_attention.attention_reference(
            q, k, v, causal=causal and mask, kv_repeat=kv_repeat,
            segment_ids=segment_ids)

    attention = ring_attention.attention
    ring_attention.attention = dense
    try:
        with torch.no_grad():
            return float(torch.stack([llama.next_token_loss(params, t, model)
                                      for t in batches]).mean())
    finally:
        ring_attention.attention = attention


def _greedy_check(params, model, prompt):
    """Greedy decode, then each step's cached logits against the no-cache
    forward of the same prefix (through the flash forward)."""
    import torch

    from ddl_tpu_torch.models import llama

    ex = EXAMPLE
    P, new = ex["prompt"], ex["new_tokens"]
    with torch.no_grad():
        t0 = time.perf_counter()
        out = llama.generate(params, prompt, model, max_new_tokens=new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        cache = llama.init_cache(model, 1, P + new, device="cuda")
        logits, cache = llama.forward_with_cache(params, out[:, :P], model,
                                                 cache, 0, last_only=True)
        steps = [logits[:, 0]]
        for pos in range(P, P + new - 1):
            step, cache = llama.forward_with_cache(
                params, out[:, pos:pos + 1], model, cache, pos)
            steps.append(step[:, 0])
        worst, flips, margins = 0.0, [], []
        for i, cached in enumerate(steps):
            full = llama.forward(params, out[:, :P + i], model)[:, -1]
            worst = max(worst, float((cached - full).abs().max()))
            top2 = torch.topk(full[0], 2).values
            margin = float(top2[0] - top2[1])
            margins.append(margin)
            if int(out[0, P + i]) != int(full[0].argmax()):
                flips.append((i, margin))
    return out, gen_s, worst, flips, min(margins)


def phase_example(tmpdir: str, card: str):
    """Phase 8: the path ``examples/train_llama_torch.py`` drives, at full
    width.  Layered configs; a PROCESS fit with async checkpoints that a
    programmatic ``PreemptionGuard`` notice drains after its second window
    (the forced final generation), resumed by a fresh ``Trainer`` and held
    bit for bit to an undisturbed fit from the same parameters;
    ``Trainer.evaluate`` on a held-out stream; greedy KV-cache decode
    against the no-cache forward; then the twin example itself."""
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.resilience import PreemptionGuard, list_generations

    t_phase = time.perf_counter()
    ex, tr = EXAMPLE, TRAIN
    tag = "[example]"
    cfg, train_cfg, source = _layered_config(tmpdir)
    log(f"{tag} LoaderConfig via load(): " + ", ".join(
        f"{k}={getattr(cfg, k)!r} ({source[k]})" for k in (
            "mode", "n_producers", "batch_size", "n_epochs", "window_stream",
            "nslots", "checkpoint_dir", "ring_timeout_s")))
    log(f"{tag} TrainConfig via load(): remat={train_cfg.remat!r}, "
        f"accum_steps={train_cfg.accum_steps} (defaults; no "
        f"DDL_TORCH_TRAIN_* set)")
    model = train_cfg.model_config(dataclasses.replace(
        llama.LlamaConfig.llama3_8b(), n_layers=tr["n_layers"]))
    token_file = os.path.join(tmpdir, "tokens.bin")
    if not os.path.exists(token_file):
        ranks = np.random.default_rng(SEED).zipf(1.2, tr["n_tokens"]) - 1
        (ranks % model.vocab).astype(np.int32).tofile(token_file)
    tokens = TokenStreamProducer(token_file, tr["seq_len"], tr["window_rows"],
                                 seed=SEED)
    faults = []
    steps_per_window = tr["window_rows"] // tr["batch_size"]

    # (a) The undisturbed fit, the bit-equality reference.
    fa.reset_launch_counts()
    ref, trainer = _example_fit(cfg, train_cfg, model, tokens)
    torch.cuda.synchronize()
    fit_launches = [fn.launches for fn in fa.KERNELS]
    ref_losses = list(ref.losses)
    del ref, trainer
    free_device_memory()
    expected = model.n_layers * ex["n_epochs"] * steps_per_window
    log(f"{tag} undisturbed PROCESS fit: losses {ref_losses}; launches "
        f"K1-K6 {fit_launches} (expected {expected} for K1-K3)")
    if fit_launches != [expected] * 3 + [0] * 3:
        faults.append(f"undisturbed fit launches {fit_launches}")

    # (b) Preempted after window notice_at: the drain writes the forced
    # final generation.  Disk first: room for two generations.
    n_params = llama.param_count(model)
    gen_bytes = 3 * 4 * n_params + 4
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    du = shutil.disk_usage(cfg.checkpoint_dir)
    log(f"{tag} a generation holds {gen_bytes} bytes of leaves (params, mu, "
        f"nu fp32 + count); {cfg.checkpoint_dir}: total {du.total}, free "
        f"{du.free} bytes")
    if du.free < 2 * gen_bytes:
        raise PhaseFailed(f"{tag} {du.free} bytes free under "
                          f"{cfg.checkpoint_dir}, two generations need "
                          f"{2 * gen_bytes}")
    m = Metrics()
    guard = PreemptionGuard(deadline_s=ex["deadline_s"], metrics=m)
    fa.reset_launch_counts()
    pre, trainer = _example_fit(cfg, train_cfg, model, tokens,
                                ckpt_dir=cfg.checkpoint_dir, guard=guard,
                                notice_at=ex["notice_at"])
    torch.cuda.synchronize()
    pre_launches = [fn.launches for fn in fa.KERNELS]
    pre_losses, preempted = list(pre.losses), pre.preempted
    del pre, trainer
    free_device_memory()
    gens = [(s, os.path.getsize(p))
            for s, p in list_generations(cfg.checkpoint_dir)]
    submit = m.timer("resilience.ckpt_submit")
    write = m.timer("resilience.ckpt_write")
    drain = m.timer("resilience.drain")
    log(f"{tag} preempted PROCESS fit: preempted={preempted}, losses "
        f"{pre_losses}; generations (step, bytes) {gens}")
    log(f"{tag} resilience.ckpt_submit (the step loop's stall for the "
        f"device-to-host snapshot) {submit.total_s:.3f} s; "
        f"resilience.ckpt_write (serialize + CRC + fsync + rename) "
        f"{write.total_s:.3f} s; drain {drain.total_s:.3f} s against a "
        f"{ex['deadline_s']:.0f} s deadline (within: "
        f"{m.gauge('resilience.drain_within_deadline') == 1.0}) ({card})")
    if not (preempted and len(pre_losses) == ex["notice_at"]
            and [s for s, _ in gens] == [ex["notice_at"] * steps_per_window]
            and m.counter("resilience.final_ckpts") == 1
            and m.counter("watchdog.failures") == 0):
        faults.append(f"preempted fit: preempted={preempted}, losses "
                      f"{pre_losses}, generations {gens}, final_ckpts "
                      f"{m.counter('resilience.final_ckpts')}")

    # (c) A fresh Trainer resumes from that generation and runs to the end.
    fa.reset_launch_counts()
    res, trainer = _example_fit(cfg, train_cfg, model, tokens,
                                ckpt_dir=cfg.checkpoint_dir)
    torch.cuda.synchronize()
    res_launches = [fn.launches for fn in fa.KERNELS]
    restore_s = trainer.metrics.timer("resilience.restore").total_s
    log(f"{tag} resumed PROCESS fit from epoch {res.resumed_from_epoch}: "
        f"losses {res.losses}; restore (verify + read onto the card) "
        f"{restore_s:.3f} s ({card}); launches K1-K6 preempted "
        f"{pre_launches} + resumed {res_launches}")
    joined = pre_losses + list(res.losses)
    log(f"{tag} preempted + resumed losses {'==' if joined == ref_losses else '!='}"
        f" undisturbed, bit for bit")
    if joined != ref_losses:
        faults.append(f"resumed losses {joined} != undisturbed {ref_losses}")
    if [a + b for a, b in zip(pre_launches, res_launches)] != fit_launches:
        faults.append(f"preempted + resumed launches {pre_launches} + "
                      f"{res_launches} != {fit_launches}")
    if trainer.metrics.counter("resilience.ckpt_restores") != 1:
        faults.append("the resumed fit restored no generation")
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)

    # (d) evaluate on held-out streams with the trained state, each held
    # to the dense path on the same batches and to the gate's controls.
    state = res.state
    fa.reset_launch_counts()
    evals, n_batches, eval_s = [], 0, 0.0
    for eval_seed in ex["eval_seeds"]:
        held_out = TokenStreamProducer(token_file, tr["seq_len"],
                                       tr["window_rows"], seed=eval_seed)
        seen = []

        def metric(p, b):
            seen.append(b[0].clone())
            return llama.next_token_loss(p, b[0], model)

        t0 = time.perf_counter()
        got = trainer.evaluate(held_out, state, metric,
                               batch_size=tr["batch_size"],
                               n_producers=tr["n_producers"],
                               window_stream=True, n_epochs=ex["eval_epochs"])
        torch.cuda.synchronize()
        eval_s += time.perf_counter() - t0
        n_batches += len(seen)
        if len(seen) != ex["eval_epochs"] * steps_per_window:
            faults.append(f"evaluate (seed {eval_seed}) saw {len(seen)} "
                          f"batches")
        direct = _dense_loss(state.params, seen, model)
        controls = {name: _dense_loss(state.params, seen, model, **kw)
                    for name, kw in (("mask dropped", {"mask": False}),
                                     ("scale dropped", {"scale": False}))}
        gap = abs(got - direct) / abs(direct)
        control_gaps = {name: abs(c - direct) / abs(direct)
                        for name, c in controls.items()}
        evals.append((eval_seed, got, direct, gap, control_gaps))
        log(f"{tag} evaluate(window_stream=True), held-out seed {eval_seed}, "
            f"{ex['eval_epochs']} windows: {got:.6f}; dense path on the same "
            f"batches {direct:.6f}, rel gap {gap:.3e}; controls " + ", ".join(
                f"{name} {controls[name]:.6f} (rel gap {g:.3e})"
                for name, g in control_gaps.items()))
    eval_launches = [fn.launches for fn in fa.KERNELS]
    max_gap = max(e[3] for e in evals)
    min_control = min(g for e in evals for g in e[4].values())
    n_eval = model.n_layers * n_batches
    log(f"{tag} evaluate over seeds {list(ex['eval_seeds'])} in {eval_s:.3f} "
        f"s ({card}): largest flash-vs-dense gap {max_gap:.3e} <= limit "
        f"{EVAL_LOSS_RTOL} < smallest control gap {min_control:.3e}: "
        f"{max_gap <= EVAL_LOSS_RTOL < min_control}; launches K1-K6 "
        f"{eval_launches} (K1 expected {n_eval}, no backward)")
    if not (max_gap <= EVAL_LOSS_RTOL < min_control
            and eval_launches == [n_eval] + [0] * 5):
        faults.append(f"evaluate: gaps {[e[3] for e in evals]}, control "
                      f"gaps {[e[4] for e in evals]}, limit {EVAL_LOSS_RTOL}, "
                      f"launches {eval_launches}")
    got, direct = evals[0][1], evals[0][2]

    # (e) Greedy decode on the trained params.
    prompt = torch.from_numpy(np.fromfile(token_file, np.int32,
                                          count=ex["prompt"])[None]).cuda()
    out, gen_s, worst, flips, min_margin = _greedy_check(state.params, model,
                                                         prompt)
    bad_flips = [f for f in flips if f[1] > BF16_LOGIT_ATOL]
    log(f"{tag} generate: {ex['new_tokens']} greedy tokens after a "
        f"{ex['prompt']}-token prompt in {gen_s:.3f} s ({card}): "
        f"{out[0, ex['prompt']:].tolist()}; cached vs no-cache logits max "
        f"abs diff {worst:.4f} (tol {BF16_LOGIT_ATOL}); argmax differs at "
        f"{flips} (step, top-2 margin), smallest margin {min_margin:.4f}")
    if worst > BF16_LOGIT_ATOL or bad_flips or int(out.max()) >= model.vocab:
        faults.append(f"generate: logits diff {worst}, flips {flips}")
    del res, state, trainer
    free_device_memory()

    # (f) The twin example on the card, THREAD mode, its own PASS rule.
    spec = importlib.util.spec_from_file_location(
        "train_llama_torch", os.path.join(ROOT, "examples",
                                          "train_llama_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    rc = example.main("thread", device="cuda")
    log(f"{tag} examples/train_llama_torch.py main('thread'): exit {rc} in "
        f"{time.perf_counter() - t0:.1f} s")
    if rc != 0:
        faults.append(f"the twin example exited {rc}")
    free_device_memory()
    log(f"{tag} phase 8 took {time.perf_counter() - t_phase:.1f} s")
    if faults:
        raise PhaseFailed(f"{tag} failed its checks: " + "; ".join(faults))
    return {
        "losses": ref_losses, "resumed_losses_equal": True,
        "ckpt_submit_s": submit.total_s, "ckpt_write_s": write.total_s,
        "restore_s": restore_s, "drain_s": drain.total_s,
        "deadline_s": ex["deadline_s"],
        "drain_within_deadline": m.gauge("resilience.drain_within_deadline"),
        "gen_bytes": gens[0][1] if gens else None, "eval": got,
        "eval_direct": direct, "eval_max_gap": max_gap,
        "eval_min_control_gap": min_control, "eval_s": eval_s,
        "generate_s": gen_s,
        "decode_max_abs": worst, "fit_launches": fit_launches,
        "eval_launches": eval_launches,
    }


# ------------------------------------------------------------- phase 9 ---

#: The wire and the fault plan.  ``ici_windows`` of phase 5's 64 MiB
#: ArrayProducer windows per ICI leg (their values held against the host
#: encode), ``reps`` timed puts each; ``slot_windows`` per slot-wire drain.
WIRE = dict(ici_windows=2, slot_windows=4, reps=5)
#: The drift bounds of the JAX package's wire tests, relative to max|x|
#: (tests/test_wire.py:918): int8 in (0, 0.02), bf16 under 0.01.
DRIFT = {"int8": 0.02, "bf16": 0.01}
#: The ride-along: producer 1 hangs at its ``hang_at``-th refill under a
#: ``stall_budget_s`` watchdog (THREAD); a corruption at producer 1's
#: ``exhaust_at``-th commit that outlasts DDL_TORCH_MAX_REPLAYS (its
#: ``count``); producer 1 crashes at its ``crash_at``-th refill in every
#: incarnation of the packed PROCESS fit (the plan exported); the fit
#: that must raise gets ``exhaust_timeout_s``.
CHAOS = dict(hang_at=2, stall_budget_s=10.0, exhaust_at=3, exhaust_count=50,
             crash_at=2, exhaust_timeout_s=120.0)
#: The pool producer's tag scale for the int8 exchange: small tags keep
#: every 256-value block's scale set by the pool's normal values, so rows
#: stay distinguishable after quantization.
INT8_TAG_SCALE = 1e-7


def _timed_plan(specs):
    """A fault plan that also records the wall time at which each of its
    specs fired in ``fired_at`` (stamped before the fault acts: a hang's
    start)."""
    from ddl_tpu_torch.faults import FaultPlan

    class TimedPlan(FaultPlan):
        def __init__(self, specs):
            super().__init__(specs)
            self.fired_at = []

        def fire(self, site, producer_idx, view, should_abort):
            t, n = time.time(), len(self.fired)
            try:
                return super().fire(site, producer_idx, view, should_abort)
            finally:
                self.fired_at.extend([t] * (len(self.fired) - n))

    return TimedPlan(specs)


def _wire_rows(x, wd):
    """The host ``encode_window`` of a 2-D array as the ICI wire's rows:
    the payload, then (int8) the row's scales."""
    import numpy as np

    from ddl_tpu_torch import wire

    payload, scales = wire.encode_window(x, wd)
    rows = x.shape[0]
    if scales is None:
        return payload.reshape(rows, -1)
    return np.concatenate([payload.reshape(rows, -1),
                           scales.view(np.uint8).reshape(rows, -1)], axis=1)


def _host_roundtrip(x, wd):
    """The host decode of the host encode of ``x`` (its rows the first
    dim, the rest flattened)."""
    from ddl_tpu_torch import wire

    flat = x.reshape(x.shape[0], -1)
    payload, scales = wire.encode_window(flat, wd)
    return wire.decode_window(payload, scales, flat.shape, flat.dtype,
                              wd).reshape(x.shape)


def wire_device_checks():
    """(a) The card's encode and decode against the host's, on the ICI
    geometry's (65536, 256) fp32 block from seed 0: encode byte for byte
    (payload and scales), decode bit for bit; each timed on the card
    (CUDA events) and on the host clock.  Then K7/K8 on encoded rows whose
    width is no multiple of 16 bytes, against their plain versions."""
    import numpy as np
    import torch

    from ddl_tpu_torch import wire
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel.ici import decode2d, encode2d

    g = ICI
    x = np.random.default_rng(SEED).standard_normal((g["rows"], g["cols"]),
                                                    dtype=np.float32)
    xd = torch.from_numpy(x).cuda()
    faults, out = [], {}
    for wd in ("bf16", "int8"):
        t0 = time.perf_counter()
        payload, scales = wire.encode_window(x, wd)
        host_enc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host_dec = wire.decode_window(payload, scales, x.shape, x.dtype, wd)
        host_dec_ms = (time.perf_counter() - t0) * 1e3
        want = _wire_rows(x, wd)
        w = encode2d(xd, wd)
        got = w.cpu().numpy()
        diff = np.flatnonzero(got.reshape(-1) != want.reshape(-1))
        back = decode2d(w, g["cols"], torch.float32, wd).cpu().numpy()
        same_dec = back.tobytes() == host_dec.tobytes()
        enc_ms = _time_ms(lambda: encode2d(xd, wd))
        dec_ms = _time_ms(lambda: decode2d(w, g["cols"], torch.float32, wd))
        where = ""
        if diff.size:
            first = np.unravel_index(diff[0], got.shape)
            where = (f" (first at row {first[0]}, byte {first[1]}: "
                     f"{'scales' if first[1] >= g['cols'] else 'payload'})")
        log(f"[wire] device {wd} encode of the ({g['rows']}, {g['cols']}) fp32 "
            f"block: {diff.size} bytes differ from the host encode{where}; "
            f"device decode bit-equal to the host decode {same_dec}; card "
            f"encode {enc_ms:.4f} ms, decode {dec_ms:.4f} ms (CUDA events); "
            f"host encode {host_enc_ms:.1f} ms, decode {host_dec_ms:.1f} ms "
            f"(numpy, host clock)")
        if diff.size or not same_dec or w.dtype != torch.uint8:
            faults.append(f"{wd}: {diff.size} encode bytes differ, decode "
                          f"bit-equal {same_dec}, encoded as {w.dtype}")
        out[wd] = {"device_encode_ms": enc_ms, "device_decode_ms": dec_ms,
                   "host_encode_ms": host_enc_ms,
                   "host_decode_ms": host_dec_ms,
                   "encode_bytes_differing": int(diff.size)}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    devs = ["cuda:0"] * g["n"]
    for rows, width in ((64, 52), (g["rows"], g["cols"] + 4)):
        block = _fanout_case(rows, width, torch.uint8, gen)
        same = (_same_blocks(fan.fanout_shard(block, devs),
                             fan.shard_plain(block, g["n"]))
                and _same_blocks(fan.fanout_replicate(block, devs),
                                 fan.replicate_plain(block, g["n"])))
        torch.cuda.synchronize()
        log(f"[wire] K8 and K7 on ({rows}, {width}) uint8 wire rows "
            f"({width} bytes, {width % 16} past a 16-byte multiple): "
            f"byte-equal to their plain versions {same}")
        if not same:
            faults.append(f"K7/K8 on ({rows}, {width}) wire rows")
    if faults:
        raise PhaseFailed("[wire] device encode/decode: " + "; ".join(faults))
    return out


def wire_ici_legs(host, card):
    """(b) The ICI tier on the wire: phase 5's 64 MiB windows put onto a
    mesh of 4 positions of cuda:0 by ``IciDistributor.put`` (the ingest
    seam's one call), K8 split and K7 replicated, on the raw, bf16 and
    int8 wires.  Every position's values equal the host decode of the
    host encode of the window's 2-D view; the drift stays in the
    reference's bounds; ``ici.bytes`` is the plan's wire bytes, with
    ``0 < wire.encoded_bytes < wire.payload_bytes``; no fallback; one
    launch per put, on uint8 rows.  Then ``reps`` timed puts a wire."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ingest import device_put
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel import ici as ici_mod

    pinned = [w.pin_memory() for w in host[:WIRE["ici_windows"]]]
    faults, out = [], {}
    for label, axes, spec, kname in (
            ("dp=4, P(None, 'dp')", {"dp": 4}, (None, "dp"), "fanout_shard"),
            ("dp=4, replicated", {"dp": 4}, (None, None, None),
             "fanout_replicate")):
        sh = _sharding(axes, spec)
        out[label] = {}
        for wd in ("raw", "bf16", "int8"):
            m = Metrics()
            dist = ici_mod.IciDistributor(sh, metrics=m, wire_dtype=wd)
            fan.reset_launch_counts()
            ok, drift = True, 0.0
            for w in pinned:
                res = dist.put(w, device_put)
                torch.cuda.synchronize()
                plan = dist.plan(w.shape, w.dtype)
                split = plan.split_dim or 0
                view = np.moveaxis(w.numpy(), split, 0)
                want = (view if wd == "raw"
                        else _host_roundtrip(np.ascontiguousarray(view), wd))
                want = torch.from_numpy(np.ascontiguousarray(
                    np.moveaxis(want, 0, split))).cuda()
                wd_dev = w.cuda()
                for s in res.shards:
                    ok &= bool(s.data.is_contiguous() and torch.equal(
                        _bytes(s.data), _bytes(want[s.index].contiguous())))
                    drift = max(drift, float(
                        (s.data - wd_dev[s.index]).abs().max()
                        / wd_dev.abs().max()))
                del want, wd_dev, res
            launches = {fn.__name__: fn.launches for fn in fan.KERNELS}
            # The rows K7/K8 carried: the plan's wire, encoded by the
            # card's encode (phase (a) holds it to the host encode).
            row_dtype = (torch.float32 if plan.wire_dtype == "raw" else
                         ici_mod.encode2d(pinned[0][0, :1].cuda(), wd).dtype)
            times = []
            for _ in range(WIRE["reps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.put(pinned[0], device_put)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            n = len(pinned)
            enc, pay = (m.counter("wire.encoded_bytes"),
                        m.counter("wire.payload_bytes"))
            wire_dtype = torch.uint8 if wd != "raw" else torch.float32
            leg_ok = (ok and plan.wire_dtype == wd
                      and m.counter("ici.fallbacks") == 0
                      and launches[kname] == n
                      and sum(launches.values()) == n
                      and m.counter("ici.bytes") == plan.wire_bytes * (
                          n + WIRE["reps"])
                      and row_dtype == wire_dtype
                      and (drift == 0.0 if wd == "raw" else
                           0.0 < drift < DRIFT[wd])
                      and ((enc, pay) == (0.0, 0.0) if wd == "raw"
                           else 0 < enc < pay))
            ms = min(times)
            log(f"[wire-ici] {label}, {wd}: {n} windows, values = host decode "
                f"of host encode {ok}, drift {drift:.3e}, launches {launches} "
                f"on {row_dtype} rows, ici.bytes "
                f"{m.counter('ici.bytes'):.0f} (plan {plan.wire_bytes} a put), "
                f"wire.encoded_bytes {enc:.0f} / wire.payload_bytes {pay:.0f}, "
                f"ici.fallbacks {m.counter('ici.fallbacks'):.0f}; put "
                f"{ms:.3f} ms (min of {WIRE['reps']}, host clock to a "
                f"synchronise, {card}) -> {'ok' if leg_ok else 'FAIL'}")
            if not leg_ok:
                faults.append(f"{label} {wd}")
            out[label][wd] = {"put_ms": ms, "drift": drift,
                              "wire_bytes": plan.wire_bytes,
                              "encoded_bytes": plan.encoded_bytes}
    if faults:
        raise PhaseFailed("[wire-ici] legs failed: " + "; ".join(faults))
    return out


def _slot_drain(producer, mode, n_epochs, metrics):
    """Drain ``n_epochs`` windows of ``producer`` (2 producers) onto
    cuda:0 through the staged engine; returns the windows on the card and
    the seconds to the loader (handshake, ring registration) and from
    there to the first window."""
    import torch

    import ddl_tpu_torch

    @ddl_tpu_torch.distributed_dataloader(n_producers=2, mode=mode, nslots=2)
    def run(env):
        t0 = time.perf_counter()
        loader = ddl_tpu_torch.DistributedDataLoader(
            producer, batch_size=ICI["batch_size"], connection=env.connection,
            n_epochs=n_epochs, output="device", device="cuda",
            metrics=metrics, timeout_s=120.0)
        t1 = time.perf_counter()
        wins, first = [], None
        for win in loader.windows(lookahead=1):
            wins.append(win.clone())
            first = first or time.perf_counter()
            loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
        torch.cuda.synchronize()
        return wins, t1 - t0, first - t1

    return run()


def wire_slot_streams(data, host, card):
    """(c) The slot wire: the ArrayProducer with ``wire_dtype`` bf16 and
    int8 through ``windows()`` onto cuda:0, THREAD then PROCESS.  The
    served stream equals the host decode of the host encode of the raw
    stream bit for bit; every window is decoded (``wire.decoded_windows``)
    and takes the staging pool's copying route, never the alias route; no
    CRC failure.  Then a THREAD int8 drain whose producer 1 corrupts its
    encoded slot after the stamp (``wire.encode`` WIRE_CORRUPTION): one
    replay, the stream unchanged."""
    import torch

    from ddl_tpu_torch import faults as flt
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.readers import ArrayProducer

    n = WIRE["slot_windows"]
    want = {wd: [torch.from_numpy(_host_roundtrip(w.numpy().reshape(
        ICI["window"], ICI["cols"]), wd).reshape(w.shape)) for w in host[:n]]
        for wd in ("bf16", "int8")}

    def producer(wd):
        p = ArrayProducer(data, window_size=ICI["window"], seed=SEED)
        p.wire_dtype = wd
        return p

    faults, out = [], {}
    runs = [(mode, wd, None) for mode in ("thread", "process")
            for wd in ("bf16", "int8")]
    runs.append(("thread", "int8", "corrupt"))
    for mode, wd, chaos in runs:
        m = Metrics()
        plan = (flt.FaultPlan([flt.FaultSpec(
            "wire.encode", flt.FaultKind.WIRE_CORRUPTION, at=2,
            producer_idx=1, param=6)]) if chaos else None)
        t0 = time.perf_counter()
        with (flt.armed(plan) if plan is not None
              else contextlib.nullcontext()):
            wins, loader_s, first_s = _slot_drain(producer(wd), mode, n, m)
        wall = time.perf_counter() - t0
        same = len(wins) == n and all(
            torch.equal(_bytes(g), _bytes(e.cuda())) for g, e in
            zip(wins, want[wd]))
        c = {k: m.counter(k) for k in (
            "wire.decoded_windows", "wire.encoded_bytes",
            "wire.payload_bytes", "staging.alias_windows",
            "integrity.corrupt_windows", "integrity.replays",
            "integrity.staging_verify_failures", "staging.inline_fallbacks")}
        copies = m.timer("ingest.stage_copy").count
        replays = 1 if chaos else 0
        run_ok = (same and c["wire.decoded_windows"] == n
                  and c["staging.alias_windows"] == 0 and copies == n
                  and c["integrity.corrupt_windows"] == replays
                  and c["integrity.replays"] == replays
                  and c["integrity.staging_verify_failures"] == 0
                  and c["staging.inline_fallbacks"] == 0
                  and 0 < c["wire.encoded_bytes"] < c["wire.payload_bytes"]
                  and (plan is None or len(plan.fired) == 1))
        tag = f"{mode} {wd}" + (", wire.encode corrupted" if chaos else "")
        log(f"[wire-slot] {tag}: {len(wins)} windows = host decode of host "
            f"encode {same}, staging copies {copies}, counters {json.dumps(c)}"
            f", drain {wall:.3f} s: to the loader {loader_s:.3f} s (the "
            f"handshake, spawns included, "
            f"{m.timer('consumer.handshake').total_s:.3f} s; the rest the "
            f"rings' registration), then to the first window {first_s:.3f} "
            f"s ({card}) -> {'ok' if run_ok else 'FAIL'}")
        if not run_ok:
            faults.append(tag)
        out[tag] = {"drain_s": wall, "loader_s": loader_s,
                    "first_window_s": first_s,
                    "ratio": c["wire.encoded_bytes"]
                    / max(c["wire.payload_bytes"], 1.0)}
        del wins
    if faults:
        raise PhaseFailed("[wire-slot] failed: " + "; ".join(faults))
    return out


def wire_exchange(card):
    """(d) The exchange lanes at phase 4's geometry: the THREAD host drain
    on the raw wire, then with ``codec="zlib"`` through the device
    shuffler (the forced wire keeps the host exchange: no K9 launch, no
    device round, no fallback) and over ``ShmRendezvous`` in PROCESS —
    both byte-identical to the raw drain; then int8 lanes on a pool with
    small tags against the same pool's raw drain: every round's raw
    windows partition the rows, and the int8 drain sits within the drift
    bound of it element by element (distinct rows differ by O(1))."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ops import device_shuffle as dsh
    from ddl_tpu_torch.shuffle import (
        DeviceExchangeFabric, DeviceExchangeShuffler, Rendezvous,
        ShmRendezvous, ThreadExchangeShuffler, make_session,
    )

    sh, n = SHUFFLE, SHUFFLE["n"]
    faults = []
    rdv = Rendezvous()
    raw, _, raw_s = drain_instances(
        lambda: ThreadExchangeShuffler.factory(rdv))
    fabric = DeviceExchangeFabric(devices=["cuda:0"] * n)
    rdv2 = Rendezvous()
    dsh.reset_launch_counts()
    zz, zp, zz_s = drain_instances(lambda: DeviceExchangeShuffler.factory(
        rendezvous=rdv2, fabric=fabric, codec="zlib"))
    k9 = dsh.exchange_ring.launches
    same = all(torch.equal(_bytes(raw[i]), _bytes(zz[i])) for i in range(n))
    tier = {k: sum(p.metrics.counter(k) for p in zp.values()) for k in (
        "shuffle.device_rounds", "shuffle.device_fallbacks",
        "wire.encoded_bytes", "wire.payload_bytes", "wire.fallbacks")}
    off = not any(p.shuffler.device_exchange_active for p in zp.values())
    ok = (same and k9 == 0 and fabric.legs == 0 and off
          and tier["shuffle.device_rounds"] == 0
          and tier["shuffle.device_fallbacks"] == 0
          and tier["wire.fallbacks"] == 0 and tier["wire.encoded_bytes"] > 0)
    log(f"[wire-exchange] THREAD zlib lanes through the device shuffler: "
        f"byte-identical to the raw drain {same}; device tier resolved off "
        f"{off}, K9 launches {k9}, counters {json.dumps(tier)}; drains raw "
        f"{raw_s:.3f} s, zlib {zz_s:.3f} s ({card}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        faults.append("THREAD zlib")
    session = make_session("ddl-smoke")
    proc, pm, proc_s, _ = process_shuffle_drain(session, codec="zlib")
    ShmRendezvous(session).cleanup()
    psame = all(torch.equal(_bytes(torch.cat(proc[i])), _bytes(raw[i]))
                for i in range(n))
    log(f"[wire-exchange] PROCESS zlib lanes over ShmRendezvous: "
        f"byte-identical to the raw THREAD drain {psame}, drain "
        f"{proc_s:.3f} s (spawns included; {card})")
    if not psame:
        faults.append("PROCESS zlib")
    rdv3, rdv4 = Rendezvous(), Rendezvous()
    small, _, _ = drain_instances(
        lambda: ThreadExchangeShuffler.factory(rdv3),
        tag_scale=INT8_TAG_SCALE)
    i8, i8p, i8_s = drain_instances(
        lambda: ThreadExchangeShuffler.factory(rdv4, wire_dtype="int8"),
        tag_scale=INT8_TAG_SCALE)
    everything = np.sort(np.concatenate([
        i * 1e6 + np.arange(sh["rows"]) for i in range(n)]))
    tags = [np.rint(small[i][:, 0].double().cpu().numpy() / INT8_TAG_SCALE)
            .reshape(sh["n_epochs"], -1) for i in range(n)]
    partitions = all(np.array_equal(np.sort(np.concatenate(
        [tags[i][e] for i in range(n)])), everything)
        for e in range(sh["n_epochs"]))
    drift = max(float((i8[i] - small[i]).abs().max() / small[i].abs().max())
                for i in range(n))
    enc = sum(p.metrics.counter("wire.encoded_bytes") for p in i8p.values())
    pay = sum(p.metrics.counter("wire.payload_bytes") for p in i8p.values())
    ok8 = partitions and 0.0 < drift < DRIFT["int8"] and 0 < enc < pay
    log(f"[wire-exchange] int8 lanes: every round of the raw drain "
        f"partitions the rows {partitions}; int8 drain against it: drift "
        f"{drift:.3e} (bound {DRIFT['int8']}), wire.encoded_bytes {enc:.0f} "
        f"/ wire.payload_bytes {pay:.0f}; drain {i8_s:.3f} s ({card}) -> "
        f"{'ok' if ok8 else 'FAIL'}")
    if not ok8:
        faults.append("int8 lanes")
    if faults:
        raise PhaseFailed("[wire-exchange] failed: " + "; ".join(faults))
    return {"raw_drain_s": raw_s, "zlib_drain_s": zz_s,
            "process_zlib_drain_s": proc_s, "int8_drain_s": i8_s,
            "int8_drift": drift, "zlib_ratio": tier["wire.encoded_bytes"]
            / max(tier["wire.payload_bytes"], 1.0)}


def _packed_cell(tmpdir):
    """The packed-document cell of phase 6: its config, producer and loss."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.readers import PackedTokenProducer

    tr = TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    docs = os.path.join(tmpdir, "docs.bin")
    if not os.path.exists(docs):
        documents(tr["n_tokens"]).tofile(docs)
    producer = PackedTokenProducer(docs, tr["seq_len"], tr["window_rows"],
                                   delimiter=EOT, seed=SEED)
    return cfg, producer, lambda p, b: llama.next_token_loss(
        p, b[0], cfg, segment_ids=b[1])


def _packed_fit(tmpdir, card, plan=None):
    """The packed cell's PROCESS fit at phase 6's length under a
    respawning watchdog, the plan exported to the producers; every
    respawn recorded with its producer."""
    import contextlib

    import torch

    from ddl_tpu_torch import env as env_mod
    from ddl_tpu_torch import faults as flt
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    tr = TRAIN
    cfg, producer, loss_fn = _packed_cell(tmpdir)
    m = Metrics()
    trainer = Trainer(loss_fn=loss_fn, optimizer=adamw(1e-5),
                      init_params=llama.init_params(cfg, seed=SEED,
                                                    device="cuda"),
                      device="cuda", metrics=m, watchdog_respawn=True)
    respawned = []
    original = env_mod.WorkerSet.respawn

    def recording(self, producer_idx):
        respawned.append(producer_idx)
        return original(self, producer_idx)

    env_mod.WorkerSet.respawn = recording
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with (flt.armed(plan, export=True) if plan is not None
              else contextlib.nullcontext()):
            res = trainer.fit(producer, config=LoaderConfig(
                batch_size=tr["batch_size"], n_epochs=tr["n_epochs"],
                n_producers=tr["n_producers"], mode="process",
                window_stream=True))
        torch.cuda.synchronize()
    finally:
        env_mod.WorkerSet.respawn = original
    wall = time.perf_counter() - t0
    out = {"losses": list(res.losses), "wall_s": wall,
           "launches": {fn.__name__: fn.launches for fn in fa.KERNELS},
           "respawned": respawned,
           "counters": {k: m.counter(k) for k in (
               "watchdog.respawns", "watchdog.failures", "consumer.windows",
               "staging.alias_windows", "staging.alias_fallbacks",
               "integrity.corrupt_windows", "ingest.registered_rings")}}
    del res, trainer
    free_device_memory()
    return out


def chaos_ride_along(tmpdir, card, token_ref, packed_ref):
    """(e) The ride-along, driven by fault plans, on phase 7's token cell
    (``token_ref``: its undisturbed fit) and phase 6's packed cell
    (``packed_ref``: its PROCESS fit's losses and launches).

    - A hung producer (THREAD, ``producer.fill`` PRODUCER_HANG on producer
      1) under ``Trainer(watchdog_respawn=True, stall_budget_s=10)``: one
      respawn, no failure, losses bit-equal, the same launches, every
      window on the alias route; the time from the hang to the
      replacement's first window.
    - Replay exhaustion: ``producer.commit`` RING_CORRUPTION on producer 1
      for more commits than DDL_TORCH_MAX_REPLAYS allows: the fit raises
      ``IntegrityError`` with ``integrity.replays == 2`` within its
      timeout, and its producers exit.
    - Packed documents through a respawn: the packed PROCESS fit with
      ``producer.fill`` PRODUCER_CRASH on producer 1, the plan exported
      (each incarnation arms it anew): respawns >= 1, all of producer 1,
      losses bit-equal to phase 6's PROCESS fit, the same K4-K6 launches.
    - ``resilience.ckpt_write`` CKPT_CORRUPTION at the twin example's
      laptop scale: the torn generation is quarantined and the previous
      verified one restores."""
    import threading

    import numpy as np
    import torch

    from ddl_tpu_torch import faults as flt
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.exceptions import IntegrityError
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.readers import TokenStreamProducer

    rc, tr, ch = RECOVERY, TRAIN, CHAOS
    faults, out = [], {}
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    token_file = os.path.join(tmpdir, "tokens.bin")
    if not os.path.exists(token_file):
        ranks = np.random.default_rng(SEED).zipf(1.2, tr["n_tokens"]) - 1
        (ranks % cfg.vocab).astype(np.int32).tofile(token_file)
    tokens = TokenStreamProducer(token_file, tr["seq_len"], tr["window_rows"],
                                 seed=SEED)
    trainer = _token_trainer(cfg, respawn=True)
    if token_ref is None:
        token_ref = _recovery_fit(trainer, tokens, "process",
                                  "[chaos] undisturbed", card)

    # The hung producer.
    trainer.stall_budget_s = ch["stall_budget_s"]
    plan = _timed_plan([flt.FaultSpec("producer.fill",
                                      flt.FaultKind.PRODUCER_HANG,
                                      at=ch["hang_at"], producer_idx=1)])
    with flt.armed(plan):
        hung = _recovery_fit(trainer, tokens, "thread", "[chaos] hang", card)
    _fit_faults(hung, token_ref, "hang", faults,
                **{"watchdog.respawns": 1, "integrity.corrupt_windows": 0,
                   "integrity.replays": 0, "ingest.registered_rings": 0})
    # Producer 1's seq s is the stream's window 2s; the hang holds the
    # fill of its seq hang_at - 1.
    first = hung["served"][2 * (ch["hang_at"] - 1)]
    hang_s = first - plan.fired_at[0] if plan.fired_at else float("nan")
    if len(plan.fired) != 1:
        faults.append(f"the hang fired {len(plan.fired)} times")
    log(f"[chaos] hung producer 1 (THREAD, stall budget "
        f"{ch['stall_budget_s']:.0f} s, the watchdog's 2 s poll): the hang "
        f"to the replacement's first served window {hang_s:.3f} s, of which "
        f"the respawn call {hung['respawn_call_s']:.3f} s ({card})")
    out["hang_to_first_window_s"] = hang_s
    out["hang_respawn_call_s"] = hung["respawn_call_s"]

    # Replay exhaustion.
    trainer.stall_budget_s = 300.0
    plan = flt.FaultPlan([flt.FaultSpec(
        "producer.commit", flt.FaultKind.RING_CORRUPTION, at=ch["exhaust_at"],
        count=ch["exhaust_count"], producer_idx=1, param=4)])
    trainer.metrics = m = Metrics()
    raised = None
    t0 = time.perf_counter()
    try:
        with flt.armed(plan):
            trainer.fit(tokens, config=LoaderConfig(
                batch_size=tr["batch_size"], n_epochs=rc["n_epochs"],
                n_producers=tr["n_producers"], mode="thread",
                window_stream=True, ring_timeout_s=ch["exhaust_timeout_s"]))
    except IntegrityError as e:
        # Only the text: the traceback's frames hold the fit's state.
        raised = f"IntegrityError ({e})"
    exhaust_s = time.perf_counter() - t0
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("ddl-torch-producer")]
    ok = (raised is not None and m.counter("integrity.replays") == 2
          and m.counter("integrity.replay_exhausted") == 1
          and exhaust_s < ch["exhaust_timeout_s"] and not alive)
    log(f"[chaos] replay exhaustion: the fit raised {raised} after "
        f"{exhaust_s:.3f} s; integrity.replays "
        f"{m.counter('integrity.replays'):.0f}, replay_exhausted "
        f"{m.counter('integrity.replay_exhausted'):.0f}, corrupt_windows "
        f"{m.counter('integrity.corrupt_windows'):.0f}; producer threads left "
        f"{alive} ({card}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        faults.append("replay exhaustion")
    out["exhaustion_s"] = exhaust_s
    del trainer
    free_device_memory()

    # Packed documents through a respawn.
    if packed_ref is None:
        packed_ref = _packed_fit(tmpdir, card)
    plan = flt.FaultPlan([flt.FaultSpec(
        "producer.fill", flt.FaultKind.PRODUCER_CRASH, at=ch["crash_at"],
        producer_idx=1)])
    crashed = _packed_fit(tmpdir, card, plan)
    c = crashed["counters"]
    ok = (crashed["losses"] == packed_ref["losses"]
          and crashed["launches"] == packed_ref["launches"]
          and len(crashed["respawned"]) >= 1
          and set(crashed["respawned"]) == {1}
          and c["watchdog.failures"] == 0
          and c["consumer.windows"] == tr["n_epochs"]
          and c["staging.alias_windows"] == tr["n_epochs"]
          and c["staging.alias_fallbacks"] == 0)
    log(f"[chaos] packed PROCESS fit with producer 1 crashing at its refill "
        f"{ch['crash_at']} (plan exported): respawns {crashed['respawned']}, "
        f"losses {crashed['losses']} "
        f"{'==' if crashed['losses'] == packed_ref['losses'] else '!='} the "
        f"undisturbed fit's, launches {crashed['launches']}, counters "
        f"{json.dumps(c)}, {crashed['wall_s']:.3f} s ({card}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        faults.append("packed respawn")
    out["packed_respawns"] = crashed["respawned"]

    # A torn checkpoint generation, at the example's laptop scale.
    from ddl_tpu_torch.parallel.train import adamw, make_train_step
    from ddl_tpu_torch.resilience import AsyncCheckpointer, restore_latest

    small = llama.LlamaConfig(vocab=1024, d_model=128, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=256, max_seq=64)
    init, _ = make_train_step(
        lambda p, b: llama.next_token_loss(p, b[0], small), adamw(1e-3),
        "cuda")
    st = init(llama.init_params(small, seed=SEED, device="cuda"))
    ckpt_dir = os.path.join(tmpdir, "chaos_ckpt")
    plan = flt.FaultPlan([flt.FaultSpec("resilience.ckpt_write",
                                        flt.FaultKind.CKPT_CORRUPTION, at=2,
                                        param=16)])
    m = Metrics()
    cp = AsyncCheckpointer(ckpt_dir, metrics=m)
    with flt.armed(plan):
        cp.submit(dataclasses.replace(st, step=1))
        cp.flush()
        cp.submit(dataclasses.replace(st, step=2))
        cp.flush()
    cp.close()
    like = init(llama.init_params(small, seed=SEED + 1, device="cuda"))
    restored = restore_latest(ckpt_dir, like=like, metrics=m)
    same = restored is not None and all(
        torch.equal(a, b) for a, b in zip(_leaves(like.params),
                                          _leaves(st.params)))
    ok = (len(plan.fired) == 1 and restored is not None
          and restored.step == 1 and same
          and m.counter("resilience.ckpt_quarantined") == 1)
    log(f"[chaos] resilience.ckpt_write CKPT_CORRUPTION on generation 2 "
        f"(laptop scale): restored step {restored.step if restored else None}"
        f", params equal to the saved state {same}, quarantined "
        f"{m.counter('resilience.ckpt_quarantined'):.0f} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        faults.append("checkpoint corruption")
    if faults:
        raise PhaseFailed("[chaos] ride-along failed: " + "; ".join(faults))
    return out


def phase_wire(tmpdir, card, token_ref=None, packed_ref=None):
    """Phase 9: the wire and the fault plan.  ``token_ref`` / ``packed_ref``
    are the undisturbed fits of phases 7 and 6; run alone, the phase makes
    its own."""
    import numpy as np

    from ddl_tpu_torch.readers import ArrayProducer

    t0 = time.perf_counter()
    g = ICI
    summary = {"device": wire_device_checks()}
    free_device_memory()
    data = np.random.default_rng(SEED).standard_normal(
        (g["n_rows"], g["cols"]), dtype=np.float32)
    host, _, _ = _ici_drain(ArrayProducer(data, window_size=g["window"],
                                          seed=SEED),
                            g["batch_size"], WIRE["slot_windows"])
    summary["ici"] = wire_ici_legs(host, card)
    free_device_memory()
    summary["slot"] = wire_slot_streams(data, host, card)
    del host, data
    free_device_memory()
    summary["exchange"] = wire_exchange(card)
    free_device_memory()
    summary["chaos"] = chaos_ride_along(tmpdir, card, token_ref, packed_ref)
    log(f"[wire] phase 9 took {time.perf_counter() - t0:.1f} s")
    return summary


# ------------------------------------------------------------ phase 10 ---

#: Phase 10: the token cell's corpus as C4-style TFRecord shards (8 files of
#: ``tf.Example`` records, one document each, an ``input_ids`` int64 list),
#: and phase 5's geometry as ``.npy`` shards (4 of (65536, 256) fp32, 64 MiB
#: each) through the shard cache: a 512 MiB RAM store over the bench's
#: default ``ThrottledBackend(latency_s=0.02)`` (``bench.py:2961-3050``),
#: 2 epochs onto dp=4 positions of cuda:0.
FILES = dict(tfrecord_shards=8, npy_shards=4, ram_mb=512, latency_s=0.02,
             mesh_epochs=2, warm_timeout_s=300.0)


def _varints(values):
    """The protobuf varint bytes of non-negative ``values`` (< 2**21), all
    at once, and each value's byte offset into them."""
    import numpy as np

    v = values.astype(np.int64)
    if v.size and (v.min() < 0 or v.max() >= 1 << 21):
        raise ValueError("varints here cover [0, 2**21)")
    two, three = v >= 1 << 7, v >= 1 << 14
    width = 1 + two.astype(np.int64) + three
    offs = np.cumsum(width) - width
    out = np.empty(int(width.sum()), np.uint8)
    out[offs] = (v & 0x7F) | (two.astype(np.int64) << 7)
    out[offs[two] + 1] = ((v[two] >> 7) & 0x7F) | (three[two].astype(np.int64) << 7)
    out[offs[three] + 2] = v[three] >> 14
    return out, offs


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        if n:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def _pb_field(field: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _pb_varint(field << 3 | 2) + _pb_varint(len(payload)) + payload


def masked_crc32c_many(bufs):
    """The TFRecord masked CRC32C of every buffer in ``bufs``, computed
    byte column by byte column over all buffers at once (the framing
    writer's: one record at a time, the table loop costs ~1 us a byte)."""
    import numpy as np

    from ddl_tpu_torch.readers import _make_crc32c_tables

    t0 = _make_crc32c_tables()[0]
    lens = np.array([len(b) for b in bufs], np.int64)
    order = np.argsort(-lens, kind="stable")
    crcs = np.empty(len(bufs), np.uint32)
    for g in range(0, len(order), 512):
        idx = order[g:g + 512]
        glens = lens[idx]  # descending
        pad = np.zeros((len(idx), int(glens[0]) if len(idx) else 0), np.uint8)
        for r, i in enumerate(idx):
            pad[r, :lens[i]] = np.frombuffer(bufs[i], np.uint8)
        crc = np.full(len(idx), 0xFFFFFFFF, np.uint32)
        neg = -glens
        for j in range(pad.shape[1]):
            a = int(np.searchsorted(neg, -j, side="left"))  # lens > j
            c = crc[:a]
            crc[:a] = t0[(c ^ pad[:a, j]) & 0xFF] ^ (c >> np.uint32(8))
        crcs[idx] = crc ^ np.uint32(0xFFFFFFFF)
    return ((crcs >> np.uint32(15)) | (crcs << np.uint32(17))) + np.uint32(0xA282EAD8)


def write_tfrecord_corpus(tmpdir, tokens, doc_lens, n_shards, key="input_ids"):
    """``tokens`` cut at ``doc_lens`` into documents, each one ``tf.Example``
    record with an int64 ``key`` feature, framed with valid masked CRC32C
    (u64 length, its CRC, payload, its CRC) into ``n_shards`` files of
    consecutive documents.  Returns (glob, [tokens per shard])."""
    import struct

    import numpy as np

    ends = np.minimum(np.cumsum(doc_lens), len(tokens))
    starts = np.concatenate([[0], ends[:-1]])
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    packed, offs = _varints(tokens)
    offs = np.append(offs, len(packed))
    key_field = _pb_field(1, key.encode())
    payloads = [
        _pb_field(1, _pb_field(1, key_field + _pb_field(2, _pb_field(
            3, _pb_field(1, packed[offs[a]:offs[b]].tobytes())))))
        for a, b in zip(starts, ends)]
    heads = [struct.pack("<Q", len(p)) for p in payloads]
    head_crc = masked_crc32c_many(heads)
    body_crc = masked_crc32c_many(payloads)
    shard_of = np.arange(len(payloads)) * n_shards // len(payloads)
    per_shard = []
    for s in range(n_shards):
        path = os.path.join(tmpdir, f"c4-train.{s:05d}-of-{n_shards:05d}.tfrecord")
        with open(path, "wb") as f:
            for i in np.flatnonzero(shard_of == s):
                f.write(heads[i])
                f.write(struct.pack("<I", int(head_crc[i])))
                f.write(payloads[i])
                f.write(struct.pack("<I", int(body_crc[i])))
        per_shard.append(int((ends - starts)[shard_of == s].sum()))
    return os.path.join(tmpdir, "c4-train.*-of-*.tfrecord"), per_shard


class FetchLog:
    """A storage backend over the local filesystem that appends every
    open to a file under ``log_dir`` (one per process), so a spawned
    producer's fetches reach the parent.  Its fingerprint is the local
    one: it keys the same cache entries.  Picklable: it holds a path."""

    name = "fetchlog"

    def __init__(self, log_dir):
        self.log_dir = log_dir

    def open(self, path):
        with open(os.path.join(self.log_dir, f"{os.getpid()}.log"), "a") as f:
            f.write(path + "\n")
        return open(path, "rb")

    def fingerprint(self, path):
        from ddl_tpu_torch.cache import LocalBackend

        return LocalBackend().fingerprint(path)

    def fetches(self):
        return sum(len(open(os.path.join(self.log_dir, n)).read().split())
                   for n in os.listdir(self.log_dir))


def _refills(producer, n, tail=0, **kw):
    """``on_init``, then ``n`` refills (``post_init`` and ``n - 1``
    ``execute_function``) into one window, then ``tail`` more, neither
    kept nor timed: the stream and the seconds of the ``n`` refills.  (A
    cold TFRecord shard enters the cache when its last record has been
    read, so filling a store takes one refill past the epoch.)"""
    import numpy as np

    ret = producer.on_init(**kw)
    win = np.zeros(ret.shape, ret.dtype)
    out = np.empty((n,) + tuple(ret.shape), ret.dtype)
    t0 = time.perf_counter()
    producer.post_init(my_ary=win)
    out[0] = win
    for k in range(1, n):
        producer.execute_function(my_ary=win)
        out[k] = win
    dt = time.perf_counter() - t0
    for _ in range(tail):
        producer.execute_function(my_ary=win)
    producer.on_push_end()
    return out, dt


def tfrecord_refill_ab(pattern, per_shard, spill_dir, card):
    """Phase 10a's A/B: ``TFRecordTokenProducer`` alone over producer 1's
    shards (of 2), one epoch of whole windows: cold with the CRC on, cold
    with it off, cold into a store with a spill dir, warm from that
    store's RAM tier and warm from its disk tier (a fresh store over the
    same dir, as a spawned producer builds).  Every stream byte-equal to
    the first.  Returns the store and the summary."""
    from ddl_tpu_torch.cache import CacheStore
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.readers import TFRecordTokenProducer

    tr = TRAIN
    win_tokens = tr["window_rows"] * tr["seq_len"]
    mine = per_shard[0::tr["n_producers"]]
    n = sum(mine) // win_tokens
    m = Metrics()
    store = CacheStore(ram_budget_bytes=FILES["ram_mb"] << 20,
                       spill_dir=spill_dir, metrics=m)

    def producer(**kw):
        return TFRecordTokenProducer(pattern, tr["seq_len"], tr["window_rows"],
                                     warm=False, **kw)

    legs = [("cold, CRC on", dict(cache=False, verify_crc=True)),
            ("cold, CRC off", dict(cache=False, verify_crc=False)),
            ("cold, into the store", dict(cache=store, verify_crc=True)),
            ("warm, RAM tier", dict(cache=store, verify_crc=True)),
            ("warm, disk tier", dict(verify_crc=True, cache=CacheStore(
                ram_budget_bytes=FILES["ram_mb"] << 20, spill_dir=spill_dir,
                metrics=Metrics())))]
    summary, ref, ok = {"windows": n, "tokens": n * win_tokens}, None, True
    for label, kw in legs:
        before = {k: m.counter(k) for k in ("cache.hits", "cache.misses")}
        stream, dt = _refills(producer(**kw), n,
                              tail=int(label == "cold, into the store"),
                              producer_idx=1, n_producers=tr["n_producers"])
        ref = stream if ref is None else ref
        same = stream.tobytes() == ref.tobytes()
        ok &= same
        row = {"ms_per_refill": dt / n * 1e3,
               "tokens_per_s": n * win_tokens / dt, "s": dt}
        if kw.get("cache") is store:
            row.update({k: m.counter(k) - before[k] for k in before})
        summary[label] = row
        log(f"[files] TFRecord refills, {label}: {n} windows of "
            f"{win_tokens} tokens in {dt:.3f} s, {row['ms_per_refill']:.3f} "
            f"ms per refill, {row['tokens_per_s']:.0f} tokens/s, stream "
            f"byte-equal to the first {same} ({card})")
    disk = legs[-1][1]["cache"].metrics
    ok &= (summary["cold, into the store"]["cache.misses"] == len(mine)
           and summary["warm, RAM tier"]["cache.misses"] == 0
           and summary["warm, RAM tier"]["cache.hits"] == len(mine)
           and disk.counter("cache.spill_hits") == len(mine)
           and disk.counter("cache.misses") == 0)
    parse = summary["cold, CRC on"]["ms_per_refill"]
    log(f"[files] the cold parse (CRC on) costs {parse:.3f} ms a window "
        f"refill, {parse / (2 * 1e3 * 0.16) * 100:.1f} % of a window's 2 "
        f"steps at phase 6's ~160 ms/step; CRC off {summary['cold, CRC off']['ms_per_refill']:.3f} "
        f"ms; warm {summary['warm, RAM tier']['ms_per_refill']:.3f} (RAM) / "
        f"{summary['warm, disk tier']['ms_per_refill']:.3f} (disk) ms")
    if not ok:
        raise PhaseFailed(f"[files] the TFRecord refill A/B failed: {summary}")
    return store, summary


def tfrecord_fits(pattern, store, spill_dir, tmpdir, card):
    """Phase 10a's fits at full width on the TFRecord stream: THREAD with
    ``cache=False``, THREAD over the warmed store (no miss, no fetch),
    PROCESS with each producer's store built from the exported
    ``LoaderConfig(cache=True, cache_spill_dir=...)`` (no fetch from
    source).  Losses bit-equal, K1-K3 on the wgmma route with phase 6's
    counts, every window on the alias route."""
    from ddl_tpu_torch import cache as cache_mod
    from ddl_tpu_torch.checkpoint import LoaderCheckpoint, adopt_cache_manifest
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.readers import TFRecordTokenProducer

    tr = TRAIN
    tag = "[files-fit]"
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])

    def loss_fn(p, b):
        return llama.next_token_loss(p, b[0], cfg)

    # Producer 2's shards into the store through its warmer (producer 1's
    # came from the A/B), so the warm fit starts with every shard cached.
    m = store.metrics
    p2 = TFRecordTokenProducer(pattern, tr["seq_len"], tr["window_rows"],
                               cache=store, warm=True)
    p2.on_init(producer_idx=2, n_producers=tr["n_producers"])
    deadline = time.monotonic() + FILES["warm_timeout_s"]
    while p2._warmer.alive and time.monotonic() < deadline:
        time.sleep(0.05)
    warmed = m.counter("cache.warmed")
    p2.on_push_end()
    if p2._warmer is not None or warmed != len(
            glob.glob(pattern)) // tr["n_producers"]:
        raise PhaseFailed(f"{tag} the warmer warmed {warmed} shards")
    log(f"{tag} producer 2's shards warmed by its CacheWarmer: {warmed:.0f}")

    fetch_dir = os.path.join(tmpdir, "fetches")
    os.makedirs(fetch_dir, exist_ok=True)
    log_backend = FetchLog(fetch_dir)
    plain = _fit_mode("thread", TFRecordTokenProducer(
        pattern, tr["seq_len"], tr["window_rows"], cache=False), loss_fn, cfg,
        tag + " cache=False", card)
    before = {k: m.counter(k) for k in ("cache.hits", "cache.misses")}
    warm = _fit_mode("thread", TFRecordTokenProducer(
        pattern, tr["seq_len"], tr["window_rows"], cache=store, warm=False,
        backend=log_backend), loss_fn, cfg, tag + " warm store", card)
    warm_hits = m.counter("cache.hits") - before["cache.hits"]
    warm_misses = m.counter("cache.misses") - before["cache.misses"]
    warm_fetches = log_backend.fetches()
    try:
        proc = _fit_mode("process", TFRecordTokenProducer(
            pattern, tr["seq_len"], tr["window_rows"], backend=log_backend),
            loss_fn, cfg, tag + " spill dir", card, cache=True,
            cache_spill_dir=spill_dir, cache_warm=False,
            cache_ram_mb=FILES["ram_mb"])
    finally:
        # The export was for the spawned producers: leave no cache knob
        # set in this process.
        for var in [v for v in os.environ if v.startswith("DDL_TORCH_CACHE")]:
            os.environ.pop(var)
    proc_fetches = log_backend.fetches() - warm_fetches

    # The manifest route a resumed PROCESS run takes: a loader checkpoint
    # captured with the store names its spill dir, and adopting it before
    # the spawn exports that dir.
    ck_path = os.path.join(tmpdir, "files_loader.json")

    class _Loader:
        _epoch = _target = _batches_in_window = 0

    LoaderCheckpoint.capture(_Loader(), cache=store).save(ck_path)
    cache_mod.reset_default_store()
    adopted = (adopt_cache_manifest(ck_path)
               and os.environ.get("DDL_TORCH_CACHE_SPILL_DIR") == store.spill_dir)
    os.environ.pop("DDL_TORCH_CACHE_SPILL_DIR", None)

    expected = cfg.n_layers * plain["steps"]
    faults = []
    for s in (plain, warm, proc):
        _fit_gates(s, fa.KERNELS[:3], fa.KERNELS[3:], expected, faults)
    _process_gates(proc, faults)
    equal = plain["losses"] == warm["losses"] == proc["losses"]
    log(f"{tag} losses cache=False {plain['losses']}, warm store "
        f"{warm['losses']}, PROCESS over the spill dir {proc['losses']}: "
        f"{'bit-equal' if equal else 'NOT bit-equal'}; K1-K3 launches "
        f"{[plain['launches'][fn.__name__] for fn in fa.KERNELS[:3]]} "
        f"(expected {expected} each, all on the wgmma route)")
    log(f"{tag} warm THREAD fit: cache.hits +{warm_hits:.0f}, cache.misses "
        f"+{warm_misses:.0f}, fetches from source {warm_fetches}; PROCESS "
        f"fit: fetches from source {proc_fetches}; manifest adopted from a "
        f"captured LoaderCheckpoint {adopted}")
    if not equal:
        faults.append("losses not bit-equal")
    if not (warm_misses == 0 and warm_hits > 0 and warm_fetches == 0
            and proc_fetches == 0 and adopted):
        faults.append(f"cache: warm misses {warm_misses}, hits {warm_hits}, "
                      f"fetches {warm_fetches} / {proc_fetches}, manifest "
                      f"{adopted}")
    if faults:
        raise PhaseFailed(f"{tag} the TFRecord fits failed their checks: "
                          + "; ".join(faults))
    return {name: {k: s[k] for k in ("losses", "step_ms", "steady_step_ms",
                                     "first_window_s", "launches")}
            for name, s in (("uncached", plain), ("warm", warm),
                            ("process", proc))}


def npy_mesh_drain(tmpdir, card):
    """Phase 10b: phase 5's geometry as 4 ``.npy`` shards, drained through
    ``FileShardProducer`` over ``ThrottledBackend(latency_s=0.02)`` into a
    512 MiB RAM store, 2 epochs onto dp=4 positions of cuda:0 (K8): every
    position's shard byte-equal to its slice of the uncached drain's host
    window, one K8 launch a window, no fallback, the warm epoch all hits.
    Returns the shard glob, the host windows and the summary."""
    import numpy as np
    import torch

    from ddl_tpu_torch.cache import CacheStore, ThrottledBackend
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.readers import FileShardProducer

    g = ICI
    n = FILES["npy_shards"]
    data = np.random.default_rng(SEED).standard_normal(
        (n * g["rows"], g["cols"]), dtype=np.float32)
    for i in range(n):
        np.save(os.path.join(tmpdir, f"shard-{i:03d}.npy"),
                data[i * g["rows"]:(i + 1) * g["rows"]])
    del data
    pattern = os.path.join(tmpdir, "shard-*.npy")
    n_windows = FILES["mesh_epochs"] * n
    host, _, host_s = _ici_drain(
        FileShardProducer(pattern, seed=SEED, cache=False), g["batch_size"],
        n_windows)
    m = Metrics()
    store = CacheStore(ram_budget_bytes=FILES["ram_mb"] << 20, metrics=m)
    producer = FileShardProducer(
        pattern, seed=SEED, cache=store, warm=False,
        backend=ThrottledBackend(latency_s=FILES["latency_s"]))
    waits = []
    torch.cuda.synchronize()
    fan.reset_launch_counts()
    checks, lm, wall = _ici_drain(producer, g["batch_size"], n_windows, host,
                                  {"dp": 4}, (None, "dp"), waits=waits)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in fan.KERNELS}
    cold, warm = waits[:n], waits[n:]
    summary = {
        "windows": len(checks), "drain_s": wall, "host_drain_s": host_s,
        "cold_ms_per_window": sum(cold) / len(cold) * 1e3,
        "warm_ms_per_window": sum(warm) / len(warm) * 1e3,
        "launches": counts, "cache.hits": m.counter("cache.hits"),
        "cache.misses": m.counter("cache.misses"),
        "ici.fallbacks": lm.counter("ici.fallbacks")}
    ok = (all(checks) and len(checks) == n_windows
          and lm.counter("ici.windows") == n_windows
          and lm.counter("ici.fallbacks") == 0
          and counts[fan.fanout_shard.__name__] == n_windows
          and counts[fan.fanout_replicate.__name__] == 0
          and m.counter("cache.misses") == n
          and m.counter("cache.hits") >= n_windows - n)
    log(f"[files] {n} .npy shards of ({g['rows']}, {g['cols']}) fp32 over "
        f"ThrottledBackend(latency_s={FILES['latency_s']}), "
        f"{FILES['ram_mb']} MiB store, {n_windows} windows onto dp=4 "
        f"positions of cuda:0: every shard byte-equal to the uncached "
        f"drain's {all(checks)}, ici.windows {lm.counter('ici.windows'):.0f}, "
        f"ici.fallbacks {lm.counter('ici.fallbacks'):.0f}, launches {counts}, "
        f"cache.misses {m.counter('cache.misses'):.0f} (one a shard), "
        f"cache.hits {m.counter('cache.hits'):.0f}; wait per window cold "
        f"{summary['cold_ms_per_window']:.3f} ms, warm "
        f"{summary['warm_ms_per_window']:.3f} ms "
        f"({[round(w * 1e3, 3) for w in waits]}); drain {wall:.3f} s, "
        f"uncached host drain {host_s:.3f} s ({card}) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed(f"[files] the .npy mesh drain failed: {summary}")
    return pattern, [w.numpy() for w in host], summary


def failure_ladder(pattern, host, tmpdir, card):
    """Phase 10c on phase 10b's shards, producer 1 of 2 driven alone for
    one epoch: a ``CACHE_CORRUPTION`` at ``cache.disk_read`` on a spilled
    entry (quarantined, refetched, the stream unchanged); a transient
    ``backend.fetch`` failure (one retry); zlib copies of the shard files
    through ``CodecBackend`` (the raw stream)."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ddl_tpu_torch import faults
    from ddl_tpu_torch.cache import CacheStore, CodecBackend
    from ddl_tpu_torch.faults import FaultKind, FaultPlan, FaultSpec
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.readers import FileShardProducer

    # One epoch of producer 1's shards, and the refill after it: the
    # pusher overwrites the post_init window before its first commit, so
    # refills 2.. are the windows the loader served from producer 1.
    n = FILES["npy_shards"] // TRAIN["n_producers"] + 1
    kw = dict(producer_idx=1, n_producers=TRAIN["n_producers"])

    def drive(**pkw):
        return _refills(FileShardProducer(pattern, seed=SEED, warm=False,
                                          **pkw), n, **kw)[0]

    want = drive(cache=False)
    served = np.stack(host[0:2 * (n - 1):2]).reshape(want[1:].shape)
    if want[1:].tobytes() != served.tobytes():
        raise PhaseFailed("[files] producer 1 alone does not refill the "
                          "windows the loader served from it")

    m = Metrics()
    store = CacheStore(ram_budget_bytes=FILES["ram_mb"] << 20,
                       spill_dir=os.path.join(tmpdir, "npy_spill"), metrics=m)
    first = drive(cache=store)
    store.clear()  # the next reads go through the disk tier
    plan = FaultPlan([FaultSpec("cache.disk_read", FaultKind.CACHE_CORRUPTION,
                                at=1, param=64)], seed=SEED)
    with faults.armed(plan):
        corrupted = drive(cache=store)
    spill = os.listdir(store.spill_dir)
    c1 = (first.tobytes() == want.tobytes() == corrupted.tobytes()
          and len(plan.fired) == 1 and m.counter("cache.quarantined") == 1
          and sum(f.endswith(".quarantined") for f in spill) == 1)
    log(f"[files] ladder 1: CACHE_CORRUPTION at cache.disk_read, fired "
        f"{plan.fired}: cache.quarantined {m.counter('cache.quarantined'):.0f}, "
        f"stream byte-equal {corrupted.tobytes() == want.tobytes()} "
        f"-> {'ok' if c1 else 'FAIL'}")

    m2 = Metrics()
    plan = FaultPlan([FaultSpec("backend.fetch", FaultKind.BACKEND_FETCH_FAIL,
                                at=2)])
    with faults.armed(plan):
        healed = drive(cache=CacheStore(ram_budget_bytes=FILES["ram_mb"] << 20,
                                        metrics=m2))
    c2 = (healed.tobytes() == want.tobytes() and len(plan.fired) == 1
          and m2.counter("cache.backend_retries") == 1
          and m2.counter("cache.backend_failures") == 0)
    log(f"[files] ladder 2: BACKEND_FETCH_FAIL at backend.fetch: "
        f"cache.backend_retries {m2.counter('cache.backend_retries'):.0f}, "
        f"stream byte-equal {healed.tobytes() == want.tobytes()} "
        f"-> {'ok' if c2 else 'FAIL'}")

    zdir = os.path.join(tmpdir, "zz")
    os.makedirs(zdir, exist_ok=True)

    def compress(path):
        with open(path, "rb") as f:
            raw = f.read()
        out = os.path.join(zdir, os.path.basename(path) + ".zz")
        with open(out, "wb") as f:
            f.write(zlib.compress(raw, 1))
        return len(raw), os.path.getsize(out)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(FILES["npy_shards"]) as pool:
        sizes = list(pool.map(compress, sorted(glob.glob(pattern))))
    squeeze = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = _refills(FileShardProducer(
        os.path.join(zdir, "shard-*.npy.zz"), seed=SEED, cache=False,
        backend=CodecBackend()), n, **kw)[0]
    read_s = time.perf_counter() - t0
    c3 = decoded.tobytes() == want.tobytes()
    log(f"[files] ladder 3: zlib shards ({sum(b for _, b in sizes) / sum(a for a, _ in sizes):.3f} "
        f"of the raw bytes, compressed in {squeeze:.3f} s) through "
        f"CodecBackend: stream byte-equal to the raw files' {c3}, {n} "
        f"refills in {read_s:.3f} s ({card}) -> {'ok' if c3 else 'FAIL'}")
    if not (c1 and c2 and c3):
        raise PhaseFailed("[files] the failure ladder failed its checks")
    return {"quarantined": m.counter("cache.quarantined"),
            "backend_retries": m2.counter("cache.backend_retries"),
            "zlib_ratio": sum(b for _, b in sizes) / sum(a for a, _ in sizes),
            "zlib_read_s": read_s}


def phase_files(tmpdir, card):
    """Phase 10: file shards through the shard cache.  (a) The token cell's
    corpus as C4-style TFRecord shards: the refill A/B, then three fits at
    full width (uncached, warm THREAD, PROCESS over the spill dir).  (b)
    ``.npy`` shards through a throttled backend and a RAM store onto a
    mesh of positions (K8).  (c) The failure ladder.  WebDataset shards
    are not driven here: that reader needs Pillow, which this script does
    not (the CPU tests hold it)."""
    import numpy as np

    from ddl_tpu_torch import cache as cache_mod

    t0 = time.perf_counter()
    tr = TRAIN
    files = os.path.join(tmpdir, "files")
    os.makedirs(files, exist_ok=True)
    tokens = ((np.random.default_rng(SEED).zipf(1.2, tr["n_tokens"]) - 1)
              % VOCAB).astype(np.int32)
    lens = _doc_lengths(np.random.default_rng(SEED), tr["n_tokens"])
    t1 = time.perf_counter()
    pattern, per_shard = write_tfrecord_corpus(files, tokens, lens,
                                               FILES["tfrecord_shards"])
    written = sum(os.path.getsize(p) for p in glob.glob(pattern))
    log(f"[files] {tr['n_tokens']} Zipf(1.2) tokens as "
        f"{FILES['tfrecord_shards']} TFRecord shards of tf.Example documents "
        f"(log-normal, median 300 tokens): {written} bytes, tokens per shard "
        f"{per_shard}, written in {time.perf_counter() - t1:.3f} s")
    spill = os.path.join(tmpdir, "tfrecord_spill")
    store, ab = tfrecord_refill_ab(pattern, per_shard, spill, card)
    summary = {"refill_ab": ab}
    summary["fits"] = tfrecord_fits(pattern, store, spill, tmpdir, card)
    del store
    cache_mod.reset_default_store()
    free_device_memory()
    npy, host, summary["mesh"] = npy_mesh_drain(files, card)
    free_device_memory()
    summary["ladder"] = failure_ladder(npy, host, tmpdir, card)
    del host
    summary["s"] = time.perf_counter() - t0
    log(f"[files] phase 10 took {summary['s']:.1f} s")
    return summary


# ------------------------------------------------------------ phase 11 ---

#: Phase 11's cells.  The ring kernels at Llama-3-8B attention width over
#: sp = 4 positions of cuda:0: B = 1, T = 8192, each block 2048 tokens (the
#: kernels' main shape).  The sp fit: Llama-3-8B widths cut to 2 layers,
#: one 8192-token row a step, 2 steps a window, 3 windows.  The dp fits:
#: phase 6's token cell (B = 4, T = 2048) over dp = 4 positions.  The
#: collectives on 4 positions at phase 4's geometry.
MESH = dict(sp=4, dp=4, B=1, T=8192, H=32, Hkv=8, D=128, sp_rows=2,
            n_epochs=3)
#: The sp fit's loss gate: the largest relative gap between the ring fit's
#: per-window losses and the one-call fit's stays under this, and the
#: control (the ring with k_offset forced to q_offset: the wrong causal
#: mask) must exceed it.  Set from phase 11's first readings (PERF.md, PR
#: 14; NVIDIA H100 80GB HBM3, 700 W): gap 1.9e-05, control 8.9e-03.
SP_LOSS_TOL = 1e-3


def _plain_chunked(q, k, v, dout, ids, rep, chunk=1024):
    """``attention_plain``'s output and q/k/v grads over the whole T,
    one block of query rows at a time (rows at their global offsets
    against every key; dk/dv summed over the blocks): the plain version
    without a (B, H, T, T) score tensor."""
    import torch

    from ddl_tpu_torch.ops import flash_attention as fa

    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    T = q.shape[1]
    outs, dqs = [], []
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c in range(0, T, chunk):
        qc = qf[:, c:c + chunk].clone().requires_grad_(True)
        kk, vv = kf.clone().requires_grad_(True), vf.clone().requires_grad_(True)
        o, _ = fa.attention_plain(
            qc, kk, vv, q_offset=c, k_offset=0, causal=True, kv_repeat=rep,
            seg_q=None if ids is None else ids[:, c:c + chunk], seg_k=ids)
        gq, gk, gv = torch.autograd.grad(o, (qc, kk, vv),
                                         dout[:, c:c + chunk].float())
        outs.append(o.detach())
        dqs.append(gq)
        dk += gk
        dv += gv
        del o, qc, kk, vv
    return torch.cat(outs, 1), (torch.cat(dqs, 1), dk, dv)


def _ring_ids(B, T, sp):
    """Phase 2's document ids (log-normal documents, median 300 tokens)
    for B rows of T tokens; fails unless a document straddles a cut."""
    import numpy as np

    ids = seg_ids(documents(B * T, seed=SEED + 3).reshape(B, T))
    blk = T // sp
    straddle = sum(int(ids[b, c * blk - 1] == ids[b, c * blk])
                   for b in range(B) for c in range(1, sp))
    if not straddle:
        raise PhaseFailed("[mesh] no document straddles a shard cut")
    return np.ascontiguousarray(ids, np.int32), straddle


def _ring_kernel_ms(q, k, v, dout, ids, sp, packed):
    """K1-K3 (K4-K6) timed as the ring calls them: the sp^2 (query
    block, key block) pairs at their global offsets, blocks wholly in the
    future skipping their tiles in the kernel; ms a call, averaged over
    the pairs (CUDA events)."""
    import torch

    from ddl_tpu_torch.ops import flash_attention as fa

    Tb = q.shape[1] // sp

    def blk(t, i):
        return t[:, i * Tb:(i + 1) * Tb].contiguous()

    qs, ks, vs, ds = ([blk(t, i) for i in range(sp)] for t in (q, k, v, dout))
    seg = [None] * sp if ids is None else [blk(ids, i) for i in range(sp)]
    pairs = [(m, s) for m in range(sp) for s in range(sp)]
    fwd, dq, dkv = fa.KERNELS[3:] if packed else fa.KERNELS[:3]

    def ids_of(m, s):
        return (seg[m], seg[s]) if packed else ()

    rows = {}
    for m, s in pairs:
        out, lse = fwd(qs[m], ks[s], vs[s], *ids_of(m, s), m * Tb, s * Tb)
        delta = (ds[m].float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        rows[m, s] = (lse, delta, torch.zeros_like(lse))
    ms = {
        "fwd": _time_ms(lambda: [fwd(qs[m], ks[s], vs[s], *ids_of(m, s),
                                     m * Tb, s * Tb) for m, s in pairs],
                        reps=3, warmup=1) / len(pairs),
        "dq": _time_ms(lambda: [dq(qs[m], ks[s], vs[s], ds[m], *rows[m, s],
                                   *ids_of(m, s), m * Tb, s * Tb)
                                for m, s in pairs], reps=3, warmup=1) / len(pairs),
        "dkv": _time_ms(lambda: [dkv(qs[m], ks[s], vs[s], ds[m], *rows[m, s],
                                     *ids_of(m, s), m * Tb, s * Tb)
                                 for m, s in pairs], reps=3, warmup=1) / len(pairs),
    }
    return ms


def ring_kernel_checks(card, phase2_ms):
    """(a) The ring at Llama-3-8B attention width over sp = 4 positions of
    cuda:0, token case (K1-K3) and packed case (K4-K6, phase 2's document
    ids, documents straddling the cuts): output and q/k/v grads against
    the plain version over the whole T; sp^2 launches of each kernel on
    the wgmma route; a nonzero lse cotangent reaching the backward; the
    gap to one call over the whole T; each kernel's ms a call in the
    ring beside phase 2's."""
    import torch

    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.mesh import make_mesh
    from ddl_tpu_torch.parallel.ring_attention import ring_attention

    c = MESH
    sp, B, T, H, Hkv, D = c["sp"], c["B"], c["T"], c["H"], c["Hkv"], c["D"]
    rep = H // Hkv
    mesh = make_mesh({"sp": sp}, ["cuda:0"] * sp)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    ids_np, straddle = _ring_ids(B, T, sp)
    seen = []
    rows_fn = fa._bwd_rows

    def spy(dout, out, dlse):
        res = rows_fn(dout, out, dlse)
        seen.append(res[2].abs().max())
        return res

    faults, summary, ring_launches = [], {}, {}
    fa._bwd_rows = spy
    try:
        for packed in (False, True):
            tag = "[mesh-ring-packed]" if packed else "[mesh-ring]"
            q = _rand((B, T, H, D), torch.bfloat16, gen, "cuda")
            k = _rand((B, T, Hkv, D), torch.bfloat16, gen, "cuda")
            v = _rand((B, T, Hkv, D), torch.bfloat16, gen, "cuda")
            dout = _rand((B, T, H, D), torch.bfloat16, gen, "cuda")
            ids = torch.from_numpy(ids_np).cuda() if packed else None
            ts = [t.requires_grad_(True) for t in (q, k, v)]
            fa.reset_launch_counts()
            seen.clear()
            out = ring_attention(*ts, mesh, dp_axis=None, kv_repeat=rep,
                                 use_flash=True, segment_ids=ids)
            grads = torch.autograd.grad(out, ts, dout)
            out = out.detach()
            torch.cuda.synchronize()
            launches = {fn.__name__: [fn.launches, fn.sm90_launches]
                        for fn in fa.KERNELS}
            dlse_max = max(float(x) for x in seen)
            n_bwd = len(seen)
            want, wgrads = _plain_chunked(q, k, v, dout, ids, rep)
            fa.reset_launch_counts()
            single, _ = fa.flash_attention_with_lse(
                *ts, 0, 0, True, rep, segment_ids=ids)
            sgrads = torch.autograd.grad(single, ts, dout)
            single = single.detach()
            names = ("out", "dq", "dk", "dv")
            gap = dict(zip(names, [_rel(a, b) for a, b in
                                   zip((out,) + grads, (want,) + wgrads)]))
            single_gap = dict(zip(names, [_rel(a, b) for a, b in
                                          zip((single,) + sgrads,
                                              (want,) + wgrads)]))
            ring_single = dict(zip(names, [_rel(a, b) for a, b in
                                           zip((out,) + grads,
                                               (single,) + sgrads)]))
            ran = fa.KERNELS[3:] if packed else fa.KERNELS[:3]
            log(f"{tag} B={B} T={T} H={H} Hkv={Hkv} D={D} bf16 over sp={sp} "
                f"positions of cuda:0 ({T // sp} tokens a block)"
                + (f", {straddle} cuts inside a document" if packed else ""))
            log(f"{tag} ring vs plain (relative Frobenius) {gap}; one call "
                f"over the whole T vs plain {single_gap}; ring vs one call "
                f"{ring_single}")
            log(f"{tag} launches (total, wgmma) {launches}; backward calls "
                f"{n_bwd}, max|dlse| {dlse_max:.4e}")
            if max(gap.values()) > 2e-2:
                faults.append(f"{tag} ring vs plain {gap}")
            if not all(launches[fn.__name__] == [sp * sp, sp * sp] for fn in ran):
                faults.append(f"{tag} launches {launches}")
            if not dlse_max > 0:
                faults.append(f"{tag} no backward call got a nonzero dlse")
            ring_launches.update({fn.__name__: launches[fn.__name__][0]
                                  for fn in ran})
            ms = _ring_kernel_ms(q.detach(), k.detach(), v.detach(), dout,
                                 ids, sp, packed)
            for key, fn in zip(("fwd", "dq", "dkv"), ran):
                log(f"{tag} {fn.__name__}: {ms[key]:.4f} ms a call in the "
                    f"ring (the {sp * sp} block pairs' mean); phase 2, one "
                    f"call at B=4 T=2048: {phase2_ms.get(fn.__name__, float('nan')):.4f} "
                    f"ms ({card})")
            summary["packed" if packed else "token"] = {
                "gap": gap, "single_gap": single_gap, "ring_vs_single": ring_single,
                "launches": launches, "dlse_max": dlse_max,
                "ms_a_call": {fn.__name__: ms[key] for key, fn in
                              zip(("fwd", "dq", "dkv"), ran)}}
            del q, k, v, dout, ts, out, grads, want, wgrads, single, sgrads
            torch.cuda.empty_cache()
    finally:
        fa._bwd_rows = rows_fn
    if faults:
        raise PhaseFailed("[mesh] ring kernel checks failed: " + "; ".join(faults))
    return summary, ring_launches


def _token_file(tmpdir):
    """Phase 6's 4 M Zipf(1.2) token stream (written again if phase 6
    did not run in this process)."""
    import numpy as np

    path = os.path.join(tmpdir, "tokens.bin")
    if not os.path.exists(path):
        ranks = np.random.default_rng(SEED).zipf(1.2, TRAIN["n_tokens"]) - 1
        (ranks % VOCAB).astype(np.int32).tofile(path)
    return path


def _mesh_fit(tag, cfg, token_file, seq_len, rows, batch_size, mesh,
              batch_spec, card, train_config=None, n_epochs=None,
              checkpoint_dir=None, profile=False, **trainer_kw):
    """One full-width THREAD fit over a mesh of cuda:0 positions (or
    ``mesh=None``): a fresh Trainer from ``init_params(seed=0)``, the
    flash and K8 counts set to 0 just before the fit and read just
    after; with ``profile``, one more fit of the same Trainer under
    ``torch.profiler``.  Returns its summary; everything it allocated is
    dropped."""
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.ops import ici_fanout
    from ddl_tpu_torch.parallel.optimizer import state_bytes_per_replica
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    n_epochs = n_epochs or MESH["n_epochs"]
    trainer = Trainer(
        lambda p, b: llama.next_token_loss(p, b[0], cfg, mesh=mesh),
        adamw(1e-5), llama.init_params(cfg, seed=SEED, device="cuda"),
        device="cuda", metrics=Metrics(), train_config=train_config,
        mesh=mesh, param_specs=None if mesh is None else llama.param_specs(cfg),
        batch_spec=batch_spec, checkpoint_dir=checkpoint_dir,
        **trainer_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ici_fanout.reset_launch_counts()
    def run():
        return trainer.fit(
            TokenStreamProducer(token_file, seq_len, rows, seed=SEED),
            config=LoaderConfig(batch_size=batch_size, n_epochs=n_epochs,
                                n_producers=2, mode="thread",
                                window_stream=True))

    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = trainer.metrics
    windows = n_epochs - res.resumed_from_epoch
    steps = windows * rows // batch_size
    steady = m.timer("trainer.windows").total_s
    s = {
        "losses": list(res.losses), "resumed_from_epoch": res.resumed_from_epoch,
        "steps": steps, "step_ms": wall / max(steps, 1) * 1e3,
        "steady_step_ms": steady / max(steps, 1) * 1e3,
        "tokens_per_s": steps * batch_size * seq_len / wall,
        "steady_tokens_per_s": (steps * batch_size * seq_len / steady
                                if steady else 0.0),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "launches": {fn.__name__: [fn.launches, fn.sm90_launches]
                     for fn in fa.KERNELS},
        "k8": ici_fanout.fanout_shard.launches,
        "k7": ici_fanout.fanout_replicate.launches,
        "windows": m.counter("consumer.windows"),
        "ici": {k: m.counter(k) for k in ("ici.windows", "ici.fallbacks")},
        "moments_per_replica": state_bytes_per_replica(
            res.state.optimizer, moments_only=True),
        "restores": m.counter("resilience.ckpt_restores"),
    }
    log(f"{tag}: losses {s['losses']}; {steps} steps in {wall:.3f} s: "
        f"{s['step_ms']:.1f} ms/step, {s['tokens_per_s']:.0f} tokens/s "
        f"(steady {s['steady_step_ms']:.1f} ms/step, "
        f"{s['steady_tokens_per_s']:.0f} tokens/s); peak memory "
        f"{s['peak_bytes'] / 2**30:.2f} GiB ({card})")
    log(f"{tag}: launches {s['launches']}; K8 {s['k8']}, K7 {s['k7']}; "
        f"windows {s['windows']}, {s['ici']}; optimizer moments per replica "
        f"{s['moments_per_replica']} bytes")
    del res
    if profile:
        profile_run(run, tag)
    del trainer
    free_device_memory()
    return s


def mesh_sp_fit(tmpdir, card, profile=False):
    """(b) The sp fit: Llama-3-8B widths cut to 2 layers, one 8192-token
    row a step over sp = 4 positions of cuda:0 (``batch_spec = P(None,
    "sp")``: windows land by K8, ring attention in every layer), beside
    the same fit with ``mesh=None`` (K1-K3 take the 8192 tokens in one
    call) and the control (the ring with ``k_offset`` forced to
    ``q_offset``: the wrong causal mask)."""
    import dataclasses as dc

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.mesh import P, make_mesh

    c = MESH
    cfg = dc.replace(llama.LlamaConfig.llama3_8b(), n_layers=TRAIN["n_layers"])
    token_file = _token_file(tmpdir)
    mesh = make_mesh({"sp": c["sp"]}, ["cuda:0"] * c["sp"])
    spec = P(None, "sp")
    args = (cfg, token_file, c["T"], c["sp_rows"], c["B"])
    # One window first: the ring's first fit in a process pays its
    # first-use costs inside its steps.
    _mesh_fit("[mesh-sp] warm-up, one window", *args, mesh, spec, card,
              n_epochs=1)
    ring = _mesh_fit("[mesh-sp] ring over sp=4", *args, mesh, spec, card,
                     profile=profile)
    whole = _mesh_fit("[mesh-sp] mesh=None", *args, None, None, card,
                      profile=profile)
    orig = fa.flash_attention_with_lse

    def wrong_mask(*a, q_offset=0, k_offset=0, **kw):
        return orig(*a, q_offset=q_offset, k_offset=q_offset, **kw)

    fa.flash_attention_with_lse = wrong_mask
    try:
        control = _mesh_fit("[mesh-sp] control (k_offset = q_offset)", *args,
                            mesh, spec, card)
    finally:
        fa.flash_attention_with_lse = orig

    def gap(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    g, g_ctrl = gap(ring["losses"], whole["losses"]), gap(control["losses"],
                                                          whole["losses"])
    steps = ring["steps"]
    want = c["sp"] ** 2 * cfg.n_layers * steps
    log(f"[mesh-sp] loss gap ring vs one call {g:.4e}, control vs one call "
        f"{g_ctrl:.4e}; tolerance {SP_LOSS_TOL}; K1-K3 launches expected "
        f"sp^2 x {cfg.n_layers} layers x {steps} steps = {want} ({card})")
    faults = []
    if not g <= SP_LOSS_TOL < g_ctrl:
        faults.append(f"loss gap {g} / control {g_ctrl} against {SP_LOSS_TOL}")
    if not all(ring["launches"][fn.__name__] == [want, want]
               for fn in fa.KERNELS[:3]):
        faults.append(f"ring launches {ring['launches']}")
    if not (ring["k8"] == ring["windows"] == c["n_epochs"]
            and ring["ici"]["ici.fallbacks"] == 0):
        faults.append(f"ring fit K8 {ring['k8']} / windows {ring['windows']} "
                      f"/ {ring['ici']}")
    for s in (ring, whole, control):
        if not all(math.isfinite(x) for x in s["losses"]):
            faults.append(f"losses {s['losses']}")
    if faults:
        raise PhaseFailed("[mesh-sp] " + "; ".join(faults))
    return {"ring": ring, "whole": whole, "control": control, "gap": g,
            "control_gap": g_ctrl, "tol": SP_LOSS_TOL}


def mesh_dp_fits(tmpdir, card, profile=False):
    """(c) Phase 6's token cell over dp = 4 positions of cuda:0: optimizer
    sharding none, zero1, zero1 with int8 gradient communication, and
    with stochastic rounding too; then the zero1 fit stopped after 2
    windows (one async generation) and resumed by a fresh Trainer."""
    import dataclasses as dc
    import shutil

    from ddl_tpu_torch.config import TrainConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.optimizer import loss_parity

    tr, c = TRAIN, MESH
    cfg = dc.replace(llama.LlamaConfig.llama3_8b(), n_layers=tr["n_layers"])
    token_file = _token_file(tmpdir)
    mesh = make_mesh({"dp": c["dp"]}, ["cuda:0"] * c["dp"])
    args = (cfg, token_file, tr["seq_len"], tr["window_rows"], tr["batch_size"],
            mesh, P(("dp",)), card)
    _mesh_fit("[mesh-dp] warm-up, one window", *args, n_epochs=1)
    runs = {}
    for name, kw in (("none", {}), ("zero1", {"optimizer_sharding": "zero1"}),
                     ("zero1_int8", {"optimizer_sharding": "zero1",
                                     "grad_comm": "int8"}),
                     ("zero1_int8_sr", {"optimizer_sharding": "zero1",
                                        "grad_comm": "int8",
                                        "stochastic_rounding": True})):
        runs[name] = _mesh_fit(f"[mesh-dp] {name}", *args,
                               train_config=TrainConfig(**kw),
                               profile=profile and name != "zero1")
    faults = []
    ref = runs["none"]["losses"]
    if runs["zero1"]["losses"] != ref:
        faults.append(f"zero1 losses {runs['zero1']['losses']} != {ref}")
    parity = {}
    for name in ("zero1_int8", "zero1_int8_sr"):
        parity[name] = loss_parity(ref, runs[name]["losses"])
        log(f"[mesh-dp] {name}: loss_parity {parity[name]} ({card})")
        if not (parity[name]["parity"] and parity[name]["max_rel_drift"] > 0):
            faults.append(f"{name} parity {parity[name]}")
    none_b, z1_b = (runs[k]["moments_per_replica"] for k in ("none", "zero1"))
    log(f"[mesh-dp] optimizer moments per replica: none {none_b}, zero1 "
        f"{z1_b} bytes (ratio {none_b / z1_b:.4f})")
    if none_b != c["dp"] * z1_b:
        faults.append(f"moments per replica {none_b} vs zero1 {z1_b}")
    for name, s in runs.items():
        if not (s["k8"] == s["windows"] == c["n_epochs"]
                and s["ici"]["ici.fallbacks"] == 0):
            faults.append(f"{name}: K8 {s['k8']} / windows {s['windows']} "
                          f"/ {s['ici']}")
    # The resume: one generation after window 2, a fresh Trainer on it.
    ckpt = os.path.join(tmpdir, "mesh_ckpt")
    os.makedirs(ckpt, exist_ok=True)
    gen_bytes = 3 * 4 * llama.param_count(cfg) + 4
    du = shutil.disk_usage(ckpt)
    if du.free < 1.2 * gen_bytes:
        raise PhaseFailed(f"[mesh-dp] {du.free} bytes free under {ckpt}, a "
                          f"generation needs {gen_bytes}")
    z1 = TrainConfig(optimizer_sharding="zero1")
    first = _mesh_fit("[mesh-dp] zero1, 2 windows, one generation", *args,
                      train_config=z1, n_epochs=2, checkpoint_dir=ckpt,
                      checkpoint_every_epochs=2)
    second = _mesh_fit("[mesh-dp] zero1, resumed", *args, train_config=z1,
                       checkpoint_dir=ckpt)
    shutil.rmtree(ckpt, ignore_errors=True)
    joined = first["losses"] + second["losses"]
    log(f"[mesh-dp] zero1 stopped + resumed from epoch "
        f"{second['resumed_from_epoch']}: {joined} "
        f"{'==' if joined == runs['zero1']['losses'] else '!='} undisturbed")
    if not (joined == runs["zero1"]["losses"] and second["restores"] == 1
            and second["resumed_from_epoch"] == 2):
        faults.append(f"resume {joined} (restores {second['restores']}) vs "
                      f"{runs['zero1']['losses']}")
    if faults:
        raise PhaseFailed("[mesh-dp] " + "; ".join(faults))
    return {"runs": runs, "parity": parity, "resumed": second}


def mesh_collectives(card):
    """(d) The collectives on 4 positions of cuda:0: ``quantized_all_reduce``
    of 16 M fp32 values a position against the fp32 mean (the reference's
    bound, 0.02 of the peak), and ``DeviceGlobalShuffler`` over 8 rounds at
    phase 4's geometry (pools of 8192 x 256 fp32, half exchanged), both
    strategies, every pool byte-identical to a host oracle built from
    ``exchange_permutation``."""
    import numpy as np
    import torch

    from ddl_tpu_torch.parallel.collectives import (
        DeviceGlobalShuffler,
        quantized_all_reduce,
    )
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh, shard
    from ddl_tpu_torch.shuffle import (
        exchange_permutation,
        exchange_slices,
        inverse_permutation,
    )

    n = 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    xs = [torch.randn(1 << 24, generator=gen, device="cuda") for _ in range(n)]
    out = quantized_all_reduce(xs)
    ms = _time_ms(lambda: quantized_all_reduce(xs), reps=3, warmup=1)
    exact = torch.stack(xs).mean(0)
    err = float((out[0] - exact).abs().max())
    peak = float(exact.abs().max())
    agree = all(torch.equal(o, out[0]) for o in out)
    log(f"[mesh-coll] quantized_all_reduce of 4 x 16 M fp32: max |err| "
        f"{err:.4e} against the fp32 mean (bound 0.02 x peak = "
        f"{0.02 * peak:.4e}), positions agree {agree}; {ms:.3f} ms ({card})")
    faults = []
    if not (agree and err <= 0.02 * peak):
        faults.append(f"all-reduce err {err} / peak {peak}, agree {agree}")

    sh = SHUFFLE
    rows, cols = sh["rows"], sh["cols"]
    num_exchange = int(rows * sh["fraction"])
    mesh = make_mesh({"dp": n}, ["cuda:0"] * n)
    host0 = np.random.default_rng(SEED + 5).standard_normal(
        (n * rows, cols)).astype(np.float32)
    k = num_exchange - num_exchange % n
    for method in ("sendrecv_replace", "all_to_all"):
        dgs = DeviceGlobalShuffler(mesh, num_exchange=num_exchange,
                                   method=method, seed=SEED)
        win = shard(torch.from_numpy(host0).cuda(), NamedSharding(mesh, P("dp")))
        pools = host0.reshape(n, rows, cols).copy()
        t0 = time.perf_counter()
        same, moved = True, False
        for r in range(8):
            win = dgs.shuffle(win)
            new = pools.copy()
            if method == "all_to_all":
                sub = k // n
                for j in range(n):
                    for i in range(n):
                        new[j, i * sub:(i + 1) * sub] = pools[i, j * sub:(j + 1) * sub]
            else:
                p = exchange_permutation(n, SEED, r)
                pinv = inverse_permutation(p)
                la, lb = exchange_slices(num_exchange)
                for i in range(n):
                    new[p[i], la] = pools[i, la]
                    new[pinv[i], lb] = pools[i, lb]
            pools = new
            same &= win.numpy().tobytes() == pools.reshape(n * rows, cols).tobytes()
            # all_to_all is an involution: even rounds restore the pools.
            moved |= not np.array_equal(pools, host0.reshape(n, rows, cols))
        wall = time.perf_counter() - t0
        log(f"[mesh-coll] DeviceGlobalShuffler {method}: 8 rounds over 4 "
            f"positions, pools byte-identical to the host oracle: {same}, "
            f"moved {moved}; {wall:.3f} s with the host checks ({card})")
        if not (same and moved):
            faults.append(f"{method}: identical {same}, moved {moved}")
    if faults:
        raise PhaseFailed("[mesh-coll] " + "; ".join(faults))
    return {"all_reduce_err": err, "all_reduce_peak": peak, "all_reduce_ms": ms}


def phase_mesh(tmpdir, card, phase2_ms=None, profile=False):
    """Phase 11, the mesh path: (a) the ring kernels, (b) the sp fit, (c)
    the dp fits with the distributed optimizer, (d) the collectives;
    ``profile`` adds a ``torch.profiler`` breakdown of the sp fits and
    the dp fits.  Returns (K1-K6 ring launches, summary)."""
    t0 = time.perf_counter()
    ring, ring_launches = ring_kernel_checks(card, phase2_ms or {})
    free_device_memory()
    sp_fit = mesh_sp_fit(tmpdir, card, profile)
    # The path's own launches: K1-K3 from the measured ring fit.
    ring_launches.update({name: n for name, (n, _) in
                          sp_fit["ring"]["launches"].items()
                          if not name.endswith("_seg")})
    dp_fits = mesh_dp_fits(tmpdir, card, profile)
    coll = mesh_collectives(card)
    free_device_memory()
    log(f"[mesh] phase 11 took {time.perf_counter() - t0:.1f} s")
    return ring_launches, {"ring": ring, "sp_fit": sp_fit, "dp_fits": dp_fits,
                           "collectives": coll}


# ------------------------------------------------------------- phase 12 ---

#: Phase 12's geometry.  (a) Llama-3-8B widths cut to 4 layers, T = 2048,
#: global B = 4 in 2 microbatches, phase 6's token stream, 3 windows of 2
#: steps.  (b) two gloo processes sharing cuda:0, each a local batch of 2
#: rows (global B = 4), 2 layers, 2 windows of 2 steps; the packed and
#: core legs at a small width.
PIPE = dict(n_layers=4, n_micro=2, n_epochs=3, mh_layers=2, mh_epochs=2,
            mh_rows=4, mh_batch=2, mh_timeout_s=900)
#: The small model of the multihost packed leg: head_dim 128 (the wgmma
#: kernels' main head dim), Llama-3's vocabulary (the documents' EOT).
MH_SMALL = dict(d_model=512, n_layers=1, n_heads=4, n_kv_heads=2, d_ff=1024)
#: The pipelined fits' loss gate: the largest relative gap between a
#: pipelined fit's per-window losses and the ``mesh=None`` fit's from the
#: same weights stays under this, and the control (the two stages applied
#: in the wrong order) must exceed it.  Set from phase 12's first reading
#: (PERF.md; NVIDIA H100 80GB HBM3, 700 W): gpipe, 1f1b and the
#: fallback 2.6e-06, tp-resident 2.3e-05, control 4.4e-02.
PP_LOSS_TOL = 2e-4
#: The multihost fits' gate: the largest relative gap between the losses
#: of the two-process fit and a one-process run of the port over the same
#: global mesh and batches (the gloo sum and the smaller local batches
#: change the order of the additions).  Set from the first reading (as
#: above): dpsp 2.2e-05, ppdp 1.9e-05.
MH_LOSS_TOL = 2e-4


def _pp_fit(tag, loss_of, params_of, token_file, mesh, card, param_specs=None,
            batch_spec=None, n_epochs=None, heads=None):
    """One full-width THREAD fit of phase 12 (a): a fresh Trainer over
    ``mesh`` (or ``mesh=None``) from ``params_of()``, the loss
    ``loss_of(metrics)``; the flash, K7 and K8 counts and the head-count
    log ``heads`` set to 0 just before the fit and read just after."""
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.ops import ici_fanout
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    tr = TRAIN
    n_epochs = n_epochs or PIPE["n_epochs"]
    m = Metrics()
    trainer = Trainer(loss_of(m), adamw(1e-5), params_of(), device="cuda",
                      metrics=m, mesh=mesh, param_specs=param_specs,
                      batch_spec=batch_spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ici_fanout.reset_launch_counts()
    if heads is not None:
        heads.clear()
    t0 = time.perf_counter()
    res = trainer.fit(
        TokenStreamProducer(token_file, tr["seq_len"], tr["window_rows"],
                            seed=SEED),
        config=LoaderConfig(batch_size=tr["batch_size"], n_epochs=n_epochs,
                            n_producers=tr["n_producers"], mode="thread",
                            window_stream=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = n_epochs * tr["window_rows"] // tr["batch_size"]
    steady = m.timer("trainer.windows").total_s
    ticks, live = m.counter("pp.ticks"), m.counter("pp.live_ticks")
    s = {
        "losses": list(res.losses), "steps": steps,
        "step_ms": wall / steps * 1e3,
        "steady_step_ms": steady / steps * 1e3,
        "tokens_per_s": steps * tr["batch_size"] * tr["seq_len"] / wall,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "launches": {fn.__name__: [fn.launches, fn.sm90_launches]
                     for fn in fa.KERNELS},
        "k8": ici_fanout.fanout_shard.launches,
        "k7": ici_fanout.fanout_replicate.launches,
        "windows": m.counter("consumer.windows"),
        "ici": {k: m.counter(k) for k in ("ici.windows", "ici.fallbacks")},
        "pp_bubble": m.gauge("pp.bubble") if ticks else None,
        "idle_share": 1.0 - live / ticks if ticks else None,
        "heads": dict(heads) if heads is not None else None,
    }
    log(f"{tag}: losses {s['losses']}; {steps} steps in {wall:.3f} s: "
        f"{s['step_ms']:.1f} ms/step (steady {s['steady_step_ms']:.1f}), "
        f"{s['tokens_per_s']:.0f} tokens/s; peak memory "
        f"{s['peak_bytes'] / 2**30:.2f} GiB ({card})")
    log(f"{tag}: launches {s['launches']}; K8 {s['k8']}, K7 {s['k7']}; "
        f"windows {s['windows']}, {s['ici']}; idle ticks "
        f"{s['idle_share']} beside bubble_fraction {s['pp_bubble']}; query "
        f"heads a K1 call {s['heads']}")
    del res, trainer
    free_device_memory()
    return s


@contextlib.contextmanager
def _count_heads(heads):
    """Count the query heads of every flash-attention call (the module
    attribute the dispatcher calls; the kernels' counters are
    untouched)."""
    from ddl_tpu_torch.ops import flash_attention as fa

    orig = fa.flash_attention

    def counted(q, *a, **kw):
        heads[int(q.shape[2])] = heads.get(int(q.shape[2]), 0) + 1
        return orig(q, *a, **kw)

    fa.flash_attention = counted
    try:
        yield
    finally:
        fa.flash_attention = orig


def pipeline_fits(tmpdir, card):
    """(a) The pipelined fits at Llama-3-8B widths, 4 layers: gpipe on
    ``{"pp": 2, "dp": 2}``, 1f1b (2 chunks) on the same mesh, tp-resident
    stages on ``{"pp": 2, "tp": 2}``, the sequential fallback on
    ``{"dp": 2}`` with the same stacked weights, a ``mesh=None`` plain fit
    from the same weights and the wrong-stage-order control."""
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.pipeline import bubble_fraction

    c, tr = PIPE, TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=c["n_layers"])
    M = c["n_micro"]
    token_file = _token_file(tmpdir)
    log(f"[pipe] llama3_8b widths, {cfg.n_layers} layers, "
        f"{llama.param_count(cfg) / 1e9:.3f} B params, T {tr['seq_len']}, "
        f"global B {tr['batch_size']} in {M} microbatches, bf16")

    def staged(n_chunks=1, reverse=False):
        def make():
            st = llama.stage_params(llama.init_params(cfg, seed=SEED,
                                                      device="cuda"),
                                    2, n_chunks=n_chunks)
            if reverse:
                st["stages"] = {k: v.flip(0).contiguous()
                                for k, v in st["stages"].items()}
            return st
        return make

    def pp_loss(mesh, **kw):
        return lambda m: (lambda p, b: llama.next_token_loss_pp(
            p, b[0], cfg, mesh, M, metrics=m, **kw))

    heads = {}
    ppdp = make_mesh({"pp": 2, "dp": 2}, ["cuda:0"] * 4)
    pptp = make_mesh({"pp": 2, "tp": 2}, ["cuda:0"] * 4)
    dp2 = make_mesh({"dp": 2}, ["cuda:0"] * 2)
    specs = llama.pp_param_specs(cfg)
    spec = P(("dp",))
    _pp_fit("[pipe] warm-up, gpipe, one window", pp_loss(ppdp), staged(),
            token_file, ppdp, card, specs, spec, n_epochs=1)
    with _count_heads(heads):
        runs = {
            "gpipe": _pp_fit("[pipe] gpipe on pp=2 x dp=2", pp_loss(ppdp),
                             staged(), token_file, ppdp, card, specs, spec,
                             heads=heads),
            "1f1b": _pp_fit(
                "[pipe] 1f1b (2 chunks) on pp=2 x dp=2",
                pp_loss(ppdp, schedule="1f1b", n_chunks=2), staged(2),
                token_file, ppdp, card, llama.pp_param_specs(cfg, n_chunks=2),
                spec, heads=heads),
            "tp": _pp_fit("[pipe] tp-resident on pp=2 x tp=2", pp_loss(pptp),
                          staged(), token_file, pptp, card, specs, spec,
                          heads=heads),
            "fallback": _pp_fit("[pipe] sequential fallback on dp=2",
                                pp_loss(dp2), staged(), token_file, dp2, card,
                                specs, spec, heads=heads),
            "plain": _pp_fit(
                "[pipe] mesh=None plain forward",
                lambda m: (lambda p, b: llama.next_token_loss(p, b[0], cfg)),
                lambda: llama.init_params(cfg, seed=SEED, device="cuda"),
                token_file, None, card, heads=heads),
            "control": _pp_fit("[pipe] control: the stages in the wrong order",
                               pp_loss(ppdp), staged(reverse=True), token_file,
                               ppdp, card, specs, spec),
            # gpipe once more, last: the first measured fit's time beside
            # a later one's.
            "gpipe_again": _pp_fit("[pipe] gpipe on pp=2 x dp=2, again",
                                   pp_loss(ppdp), staged(), token_file, ppdp,
                                   card, specs, spec),
        }

    def gap(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    plain = runs["plain"]["losses"]
    gaps = {k: gap(runs[k]["losses"], plain) for k in runs if k != "plain"}
    sched = {k: gap(runs[k]["losses"], runs["gpipe"]["losses"])
             for k in ("1f1b", "tp", "fallback", "gpipe_again")}
    equal = {k: runs[k]["losses"] == runs["gpipe"]["losses"]
             for k in ("1f1b", "tp", "fallback", "gpipe_again")}
    log(f"[pipe] loss gaps to the mesh=None fit {gaps} (tolerance "
        f"{PP_LOSS_TOL}); to gpipe {sched}, bit-equal {equal} ({card})")
    steps = runs["gpipe"]["steps"]
    L = cfg.n_layers
    want = {"gpipe": M * L * steps, "1f1b": M * L * steps,
            "tp": M * L * 2 * steps, "fallback": M * L * steps,
            "plain": L * steps, "gpipe_again": M * L * steps}
    log(f"[pipe] K1-K3 launches expected: one per live (position, tick, "
        f"layer) = microbatches x layers x steps = {M} x {L} x {steps} = "
        f"{want['gpipe']} (x tp=2 for the tp-resident stages: "
        f"{want['tp']}; the plain fit {L} x {steps} = {want['plain']}); "
        f"remat off, no recompute")
    faults = []
    for k, s in runs.items():
        if not all(math.isfinite(x) for x in s["losses"]):
            faults.append(f"{k} losses {s['losses']}")
        if k in want and not all(s["launches"][fn.__name__] == [want[k], want[k]]
                                 for fn in fa.KERNELS[:3]):
            faults.append(f"{k} launches {s['launches']} != {want[k]}")
    if not max(gaps[k] for k in ("gpipe", "1f1b", "tp", "fallback")) \
            <= PP_LOSS_TOL < gaps["control"]:
        faults.append(f"loss gaps {gaps} against {PP_LOSS_TOL}")
    if not all(sched[k] <= 1e-6 for k in ("1f1b", "fallback", "gpipe_again")):
        faults.append(f"schedules' gaps {sched}")
    h = cfg.n_heads
    if runs["tp"]["heads"] != {h // 2: want["tp"]}:
        faults.append(f"tp-resident query heads {runs['tp']['heads']}")
    if runs["gpipe"]["heads"] != {h: want["gpipe"]}:
        faults.append(f"gpipe query heads {runs['gpipe']['heads']}")
    for k in ("gpipe", "1f1b", "fallback", "gpipe_again"):
        s = runs[k]
        if not (s["k8"] == s["windows"] == c["n_epochs"] and s["k7"] == 0
                and s["ici"]["ici.fallbacks"] == 0):
            faults.append(f"{k}: K8 {s['k8']} / K7 {s['k7']} / windows "
                          f"{s['windows']} / {s['ici']}")
    s = runs["tp"]  # no dp axis: the windows land replicated (K7)
    if not (s["k7"] == s["windows"] == c["n_epochs"] and s["k8"] == 0):
        faults.append(f"tp: K7 {s['k7']} / K8 {s['k8']} / windows {s['windows']}")
    for k, V in (("gpipe", None), ("1f1b", 2)):
        b = bubble_fraction(2, M, "gpipe" if V is None else "1f1b", V)
        if abs(runs[k]["idle_share"] - b) > 1e-12:
            faults.append(f"{k} idle share {runs[k]['idle_share']} vs {b}")
    if faults:
        raise PhaseFailed("[pipe] " + "; ".join(faults))
    return {"runs": runs, "gaps": gaps, "schedule_gaps": sched,
            "bit_equal": equal, "tol": PP_LOSS_TOL, "expected": want}


# -- (b) MULTIHOST: gloo processes sharing cuda:0 ----------------------------


class TaggedProducer:
    """The core and stream legs' rows: ``instance*1000 + producer*100 +
    row`` in every column (module level: pickled to the spawned
    producers)."""

    def __init__(self, instance_idx):
        self.instance_idx = instance_idx

    def on_init(self, producer_idx=0, **kw):
        from ddl_tpu_torch.datasetwrapper import DataProducerOnInitReturn

        self._idx = producer_idx
        return DataProducerOnInitReturn(nData=32, nValues=8, shape=(32, 8),
                                        splits=(7, 1))

    def post_init(self, my_ary, **kw):
        import numpy as np

        tags = self.instance_idx * 1000 + self._idx * 100 + np.arange(32)
        my_ary[:] = tags[:, None].astype(np.float32)

    def execute_function(self, my_ary, **kw):
        pass


def _row_mean_loss(p, b):
    """The core and ckpt legs' model: a mean over rows, so the mean of
    the processes' losses is the global batch's."""
    return ((((b[0] * 1e-3) @ p["w"]) - b[1][:, 0] * 1e-3) ** 2).mean()


#: The gloo legs a MULTIHOST step records (``mh.<leg>`` seconds,
#: ``mh.<leg>_bytes``): the all-reduce bucket; ZeRO-1's reduce-scatter
#: input and this process's part of its all-gather.
MH_LEGS = ("allreduce", "scatter", "gather")


def _mh_fit(tag, cfg, loss_of, params_of, producer, mesh, spec, out, rank,
            n_epochs, rows, batch, specs=None, train_config=None):
    """One MULTIHOST ``Trainer.fit`` of a child: PROCESS producers under
    ``mode="multihost"``, windows landed as this process's block of the
    global array, each local window recorded by the window hook; each
    gloo leg's ms and bytes a step, and the optimizer state this process
    allocated."""
    import numpy as np
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.ops import ici_fanout
    from ddl_tpu_torch.parallel.optimizer import _state_tensors
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.trainer import Trainer

    seen = []

    def hook(win):
        seen.append(win.detach().cpu().numpy().copy())
        return win

    m = Metrics()
    trainer = Trainer(loss_of(mesh), adamw(1e-5), params_of(), device="cuda",
                      metrics=m, mesh=mesh, param_specs=specs, batch_spec=spec,
                      train_config=train_config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ici_fanout.reset_launch_counts()
    dm = default_metrics()
    legs0 = {leg: (dm.timer(f"mh.{leg}").total_s, dm.counter(f"mh.{leg}_bytes"))
             for leg in MH_LEGS}
    t0 = time.perf_counter()
    res = trainer.fit(producer, config=LoaderConfig(
        batch_size=batch, n_epochs=n_epochs, n_producers=2, mode="multihost",
        window_stream=True), window_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = n_epochs * rows // batch
    s = {"losses": list(res.losses), "steps": steps,
         "step_ms": wall / steps * 1e3,
         "steady_step_ms": m.timer("trainer.windows").total_s / steps * 1e3,
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "state_bytes": sum(t.numel() * t.element_size() for t in
                            _state_tensors(res.state.optimizer) if t.dim() > 0),
         "state_bytes_per_replica": dm.gauge("opt.state_bytes_per_replica"),
         "launches": {fn.__name__: [fn.launches, fn.sm90_launches]
                      for fn in fa.KERNELS},
         # K7/K8 run only where the ICI tier lands a window (a one-axis
         # split; a dp x sp window takes the plain route).
         "k7": ici_fanout.fanout_replicate.launches,
         "k8": ici_fanout.fanout_shard.launches}
    for leg, (t_0, b_0) in legs0.items():
        s[f"{leg}_ms"] = (dm.timer(f"mh.{leg}").total_s - t_0) / steps * 1e3
        s[f"{leg}_bytes"] = (dm.counter(f"mh.{leg}_bytes") - b_0) / steps
    np.save(os.path.join(out, f"{tag}_{rank}.npy"), np.stack(seen))
    gloo = "; ".join(f"gloo {leg} {s[f'{leg}_ms']:.1f} ms and "
                     f"{s[f'{leg}_bytes']:.0f} bytes a step" for leg in MH_LEGS)
    log(f"[mh {rank}] {tag}: losses {s['losses']}; {wall / steps * 1e3:.1f} "
        f"ms/step (steady {s['steady_step_ms']:.1f}); {gloo}; moments "
        f"{s['state_bytes']} bytes in this process; peak "
        f"{s['peak_bytes'] / 2**30:.2f} GiB; launches {s['launches']}, K7 "
        f"{s['k7']}, K8 {s['k8']} ({_card_of(out)})")
    del res, trainer
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return s


def _eval_metrics(small):
    """The evaluate leg's metrics: the token stream's next-token loss
    (K1) and the packed documents' segment-masked loss (K4, whose mask
    counts differ between the processes)."""
    from ddl_tpu_torch.models import llama

    return {
        "tokens": lambda p, b: llama.next_token_loss(p, b[0], small),
        "packed": lambda p, b: llama.next_token_loss(p, b[0], small,
                                                     segment_ids=b[1]),
    }


def _mh_evaluate(small, out, rank):
    """The evaluate leg of a child: ``Trainer.evaluate(window_stream=
    True)`` over a mesh whose dp spans the processes, on the token stream
    and on the packed documents; each batch it saw is saved for the
    parent's one-process value."""
    import numpy as np
    import torch

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import PackedTokenProducer, TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    c, tr = PIPE, TRAIN
    metrics = _eval_metrics(small)
    trainer = Trainer(metrics["tokens"], adamw(1e-5),
                      llama.init_params(small, seed=SEED, device="cuda"),
                      device="cuda", metrics=Metrics(),
                      mesh=make_mesh({"dp": 2}, ["cuda:0"]),
                      param_specs=llama.param_specs(small),
                      batch_spec=P(("dp",)))
    state = trainer._init_fn(trainer._init_params)
    producers = {
        "tokens": TokenStreamProducer(os.path.join(out, "tokens.bin"),
                                      tr["seq_len"], c["mh_rows"], seed=SEED),
        "packed": PackedTokenProducer(os.path.join(out, "docs.bin"),
                                      tr["seq_len"], c["mh_rows"],
                                      delimiter=EOT, seed=SEED),
    }
    res = {}
    for name, producer in producers.items():
        seen = []

        def metric(p, b, fn=metrics[name]):
            seen.append(torch.cat(b, -1).cpu().numpy().copy())
            return fn(p, b)

        fa.reset_launch_counts()
        value = trainer.evaluate(producer, state, metric,
                                 batch_size=c["mh_batch"], n_producers=2,
                                 mode="multihost", window_stream=True,
                                 n_epochs=c["mh_epochs"])
        np.save(os.path.join(out, f"eval_{name}_{rank}.npy"), np.stack(seen))
        res[name] = {"value": value, "batches": len(seen),
                     "launches": {fn.__name__: fn.launches
                                  for fn in fa.KERNELS}}
    del trainer, state
    torch.cuda.empty_cache()
    return res


def _card_of(out):
    """The card's name and power limit, as the parent wrote them."""
    with open(os.path.join(out, "card.txt")) as f:
        return f.read().strip()


#: Phase 12 (b)'s ZeRO-1 legs over the processes, at dpsp's full width.
MH_ZERO1_LEGS = {"z1": dict(optimizer_sharding="zero1"),
                 "z1int8": dict(optimizer_sharding="zero1", grad_comm="int8")}
#: The zero1 checkpoint leg's steps, and the step it is interrupted at.
MH_CKPT = dict(steps=4, at=2)


def _mh_zero1_ckpt(small, out, rank):
    """The zero1 checkpoint round trip of a child at the small width:
    ZeRO-1 steps over ``{"dp": 2}`` (one position a process) run
    uninterrupted, and again interrupted at ``MH_CKPT["at"]``: the
    synchronous checkpoint and an async generation written (the moment
    slices gathered to rank 0), each restored into a fresh state on both
    ranks and run on.  Restored means bit-equal losses and params."""
    import torch

    from ddl_tpu_torch.checkpoint import restore_train_state, save_train_state
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.train import adamw, make_train_step, tree_leaves
    from ddl_tpu_torch.resilience import AsyncCheckpointer, restore_latest

    mesh = make_mesh({"dp": 2}, ["cuda:0"])
    init_fn, step_fn = make_train_step(
        lambda p, b: llama.next_token_loss(p, b[0], small, mesh=mesh),
        adamw(1e-5), mesh=mesh, param_specs=llama.param_specs(small),
        batch_spec=P(("dp",)), optimizer_sharding="zero1")
    gen = torch.Generator().manual_seed(100 + rank)
    batches = torch.randint(0, small.vocab, (MH_CKPT["steps"], PIPE["mh_batch"],
                                             TRAIN["seq_len"]), generator=gen,
                            dtype=torch.int32).cuda()
    params = llama.init_params(small, seed=SEED, device="cpu")

    def run(state, steps):
        losses = []
        for t in steps:
            state, loss = step_fn(state, (batches[t],))
            losses.append(float(loss))
        return state, losses

    def flat(state):
        return torch.cat([p.detach().reshape(-1) for p in tree_leaves(state.params)])

    state, full = run(init_fn(params), range(MH_CKPT["steps"]))
    want = flat(state)
    state, _ = run(init_fn(params), range(MH_CKPT["at"]))
    ckpt = os.path.join(out, "z1ckpt")
    t0 = time.perf_counter()
    save_train_state(state, ckpt)
    sync_s = time.perf_counter() - t0
    gens = AsyncCheckpointer(os.path.join(out, "z1gens"))
    t0 = time.perf_counter()
    gens.submit(state)
    gens.close()
    async_s = time.perf_counter() - t0
    del state
    res = {"full": full, "sync_s": sync_s, "async_s": async_s}
    for name, restore in (
            ("sync", lambda s: restore_train_state(ckpt, s)),
            ("async", lambda s: restore_latest(os.path.join(out, "z1gens"),
                                               s).state)):
        state = restore(init_fn(params))
        state, tail = run(state, range(MH_CKPT["at"], MH_CKPT["steps"]))
        res[name] = tail
        res[f"{name}_restored"] = (tail == full[MH_CKPT["at"]:]
                                   and bool(torch.equal(flat(state), want)))
        del state
    torch.cuda.empty_cache()
    return res


def multihost_child(rank, port, out):
    """One process of phase 12 (b): a gloo group of 2 on cuda:0; the legs
    core, stream, dpsp, z1, z1int8, ppdp, packed, i8, evaluate, ckpt and
    z1ckpt (``out`` holds the shared inputs and every record)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ddl_tpu_torch import DistributedDataLoader, Marker, distributed_dataloader
    from ddl_tpu_torch.config import TrainConfig
    from ddl_tpu_torch.ingest import make_global_array
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.collectives import (
        DeviceGlobalShuffler,
        process_allgather,
        release_host_buckets,
    )
    from ddl_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh
    from ddl_tpu_torch.parallel.train import adamw, make_train_step
    from ddl_tpu_torch.readers import PackedTokenProducer, TokenStreamProducer

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    c, tr = PIPE, TRAIN
    pos = ["cuda:0"] * 2
    report = {}

    # core: coverage, the dp step across processes, the shuffle.
    @distributed_dataloader(n_producers=2, mode="multihost")
    def core(env):
        assert (env.topology.n_instances, env.topology.instance_idx) == (2, rank)
        mesh = make_mesh({"dp": 4}, pos)
        sh = NamedSharding(mesh, P("dp"))
        loader = DistributedDataLoader(TaggedProducer(rank), batch_size=8,
                                       connection=env.connection, n_epochs=2,
                                       output="numpy", device="cuda")
        init_fn, step_fn = make_train_step(
            _row_mean_loss, lambda ps: torch.optim.SGD(ps, lr=1e-3),
            mesh=mesh, param_specs={"w": P(None)}, batch_spec=P(("dp",)))
        state = init_fn({"w": np.zeros(7, np.float32)})
        seen = set()
        for _ in range(2):
            for x, y in loader:
                gy = make_global_array(y, sh)
                state, loss = step_fn(state, (make_global_array(x, sh), gy))
                seen.update(int(t) for t in process_allgather(gy).reshape(-1))
                loader.mark(Marker.END_OF_BATCH)
            loader.mark(Marker.END_OF_EPOCH)
        window = make_global_array(
            (1000.0 * rank + np.arange(16, dtype=np.float32))[:, None]
            * np.ones((1, 4), np.float32), sh)
        before = process_allgather(window).cpu().numpy()
        after = process_allgather(
            DeviceGlobalShuffler(mesh, num_exchange=2, seed=3).shuffle(window)
        ).cpu().numpy()
        return {"instances": sorted({t // 1000 for t in seen}),
                "producers": len({(t // 1000, (t % 1000) // 100) for t in seen}),
                "rows_kept": sorted(before[:, 0].tolist())
                == sorted(after[:, 0].tolist()),
                "moved": not np.array_equal(before, after),
                "loss": float(loss)}

    report["core"] = core()
    log(f"[mh {rank}] core: {report['core']} ({_card_of(out)})")

    @distributed_dataloader(n_producers=2, mode="multihost")
    def stream(env):
        mesh = make_mesh({"dp": 4}, pos)
        loader = DistributedDataLoader(
            TaggedProducer(rank), batch_size=8, connection=env.connection,
            n_epochs=2, output="device", device="cuda",
            sharding=NamedSharding(mesh, P(None, "dp")))
        shapes, tags = set(), set()
        for win in loader.windows():
            shapes.add(tuple(win.shape))
            tags.update(int(t) for t in process_allgather(win)[..., -1]
                        .reshape(-1).cpu())
            loader.mark(Marker.END_OF_EPOCH)
        return {"shapes": sorted(shapes),
                "instances": sorted({t // 1000 for t in tags})}

    report["stream"] = stream()
    log(f"[mh {rank}] stream: {report['stream']} ({_card_of(out)})")

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=c["mh_layers"])
    tokens = os.path.join(out, "tokens.bin")

    def tok_producer():
        return TokenStreamProducer(tokens, tr["seq_len"], c["mh_rows"], seed=SEED)

    # The full-width weights start on the host: the Trainer keeps its
    # init tree for the whole fit, and two processes share the card.
    report["dpsp"] = _mh_fit(
        "dpsp", cfg, lambda mesh: (lambda p, b: llama.next_token_loss(
            p, b[0], cfg, mesh=mesh)),
        lambda: llama.init_params(cfg, seed=SEED, device="cpu"),
        tok_producer(), make_mesh({"dp": 2, "sp": 2}, pos), P(("dp",), "sp"),
        out, rank, c["mh_epochs"], c["mh_rows"], c["mh_batch"],
        llama.param_specs(cfg))
    # ZeRO-1 over the processes, fp32 and int8: dpsp's fit with the
    # sharded optimizer's reduce-scatter, owned update and all-gather.
    release_host_buckets()  # dpsp's all-reduce bucket
    for tag, tc in MH_ZERO1_LEGS.items():
        report[tag] = _mh_fit(
            tag, cfg, lambda mesh: (lambda p, b: llama.next_token_loss(
                p, b[0], cfg, mesh=mesh)),
            lambda: llama.init_params(cfg, seed=SEED, device="cpu"),
            tok_producer(), make_mesh({"dp": 2, "sp": 2}, pos),
            P(("dp",), "sp"), out, rank, c["mh_epochs"], c["mh_rows"],
            c["mh_batch"], llama.param_specs(cfg), TrainConfig(**tc))
    release_host_buckets()
    report["ppdp"] = _mh_fit(
        "ppdp", cfg, lambda mesh: (lambda p, b: llama.next_token_loss_pp(
            p, b[0], cfg, mesh, 2)),
        lambda: llama.stage_params(
            llama.init_params(cfg, seed=SEED, device="cpu"), 2),
        tok_producer(), make_mesh({"dp": 2, "pp": 2}, pos), P(("dp",)),
        out, rank, c["mh_epochs"], c["mh_rows"], c["mh_batch"],
        llama.pp_param_specs(cfg))
    small = dataclasses.replace(llama.LlamaConfig.llama3_8b(), **MH_SMALL)
    report["packed"] = _mh_fit(
        "packed", small, lambda mesh: (lambda p, b: llama.next_token_loss(
            p, b[0], small, mesh=mesh, segment_ids=b[1])),
        lambda: llama.init_params(small, seed=SEED, device="cuda"),
        PackedTokenProducer(os.path.join(out, "docs.bin"), tr["seq_len"],
                            c["mh_rows"], delimiter=EOT, seed=SEED),
        make_mesh({"dp": 2}, ["cuda:0"]), P(("dp",)), out, rank,
        c["mh_epochs"], c["mh_rows"], c["mh_batch"], llama.param_specs(small))
    # int8 gradient communication alone at the small width: the reduced
    # grads quantized after the all-reduce.
    report["i8"] = _mh_fit(
        "i8", small, lambda mesh: (lambda p, b: llama.next_token_loss(
            p, b[0], small, mesh=mesh)),
        lambda: llama.init_params(small, seed=SEED, device="cuda"),
        tok_producer(), make_mesh({"dp": 2}, ["cuda:0"]), P(("dp",)), out,
        rank, c["mh_epochs"], c["mh_rows"], c["mh_batch"],
        llama.param_specs(small), TrainConfig(grad_comm="int8"))
    report["evaluate"] = _mh_evaluate(small, out, rank)
    log(f"[mh {rank}] evaluate: {report['evaluate']} ({_card_of(out)})")
    report["z1ckpt"] = _mh_zero1_ckpt(small, out, rank)
    log(f"[mh {rank}] z1ckpt: {report['z1ckpt']} ({_card_of(out)})")

    # ckpt: rank 0 writes, every rank restores and fast-forwards.
    from ddl_tpu_torch.checkpoint import (
        LoaderCheckpoint,
        restore_train_state,
        save_train_state,
    )
    ckpt = os.path.join(out, "ckpt")

    def steps_over(mesh):
        return make_train_step(_row_mean_loss, adamw(1e-3), mesh=mesh,
                               param_specs={"w": P(None)},
                               batch_spec=P(("dp",)))

    @distributed_dataloader(n_producers=2, mode="multihost")
    def ckpt_first(env):
        mesh = make_mesh({"dp": 4}, pos)
        init_fn, step_fn = steps_over(mesh)
        state = init_fn({"w": np.zeros(7, np.float32)})
        loader = DistributedDataLoader(TaggedProducer(rank), batch_size=8,
                                       connection=env.connection, n_epochs=4,
                                       output="numpy", device="cuda")
        sh = NamedSharding(mesh, P("dp"))
        for _ in range(2):
            for x, y in loader:
                state, _ = step_fn(state, (make_global_array(x, sh),
                                           make_global_array(y, sh)))
                loader.mark(Marker.END_OF_BATCH)
            loader.mark(Marker.END_OF_EPOCH)
        save_train_state(state, ckpt)
        LoaderCheckpoint.capture(loader).save(
            os.path.join(ckpt, f"loader_{rank}.json"))
        return state.step, loader._target, state.params["w"].detach().clone()

    step0, target0, w0 = ckpt_first()

    @distributed_dataloader(n_producers=2, mode="multihost")
    def ckpt_resume(env):
        mesh = make_mesh({"dp": 4}, pos)
        init_fn, step_fn = steps_over(mesh)
        state = restore_train_state(ckpt, init_fn({"w": np.zeros(7, np.float32)}))
        ck = LoaderCheckpoint.load(os.path.join(ckpt, f"loader_{rank}.json"))
        loader = DistributedDataLoader(TaggedProducer(rank), batch_size=8,
                                       connection=env.connection, n_epochs=4,
                                       output="numpy", device="cuda")
        loader.fast_forward(ck.epoch)
        ck.apply(loader)
        ok = (state.step == step0 and loader._target == target0
              and bool(torch.equal(state.params["w"].detach(), w0)))
        sh = NamedSharding(mesh, P("dp"))
        n = 0
        for _ in range(2):
            for x, y in loader:
                state, _ = step_fn(state, (make_global_array(x, sh),
                                           make_global_array(y, sh)))
                n += 1
                loader.mark(Marker.END_OF_BATCH)
            loader.mark(Marker.END_OF_EPOCH)
        return {"restored": ok, "step": state.step, "expected": step0 + n}

    report["ckpt"] = ckpt_resume()
    log(f"[mh {rank}] ckpt: {report['ckpt']} ({_card_of(out)})")
    with open(os.path.join(out, f"report_{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    log(f"MULTIHOST OK process={rank}")


def _one_process_reference(cfg, loss, params, specs, spec, mesh, windows,
                           split=None, **step_kw):
    """The port's one-process run over the same global mesh and batches:
    a multistep a window over the two processes' local windows joined
    along the batch dim (rank 0's rows first, as the global array holds
    them).  ``split`` cuts each window's last dim into its columns (the
    packed windows' tokens and segment ids); ``step_kw`` are the
    distributed-optimizer knobs."""
    import numpy as np
    import torch

    from ddl_tpu_torch.parallel.train import adamw, make_multistep

    init_fn, multi = make_multistep(loss, adamw(1e-5), mesh=mesh,
                                    param_specs=specs, batch_spec=spec,
                                    n_steps=windows.shape[1], **step_kw)
    state = init_fn(params)
    losses = []
    for w in windows:
        w = torch.from_numpy(w).cuda()
        cols = (w,) if split is None else (w[..., :split], w[..., split:])
        state, ls = multi(state, cols, per_step=True)
        losses.append(float(ls.mean()))
    del state
    return losses


def _packed_counts(windows, seq_len):
    """Per window and step, the positions the packed loss keeps in a
    process's rows: every row's first T - 1 positions whose next token is
    in the same document."""
    seg = windows[..., seq_len:]
    return (seg[..., :-1] == seg[..., 1:]).sum(axis=(-2, -1))


def multihost_run(tmpdir, card):
    """(b) Two gloo processes on cuda:0 run the legs; then the port's
    one-process runs over the same global meshes and batches."""
    import numpy as np

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.mesh import P, make_mesh

    c = PIPE
    out = os.path.join(tmpdir, "mh")
    os.makedirs(out, exist_ok=True)
    os.link(_token_file(tmpdir), os.path.join(out, "tokens.bin"))
    with open(os.path.join(out, "card.txt"), "w") as f:
        f.write(card)
    documents(TRAIN["n_tokens"]).tofile(os.path.join(out, "docs.bin"))
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    logs = [open(os.path.join(out, f"child_{i}.log"), "w") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-child",
         str(i), str(port), out], stdout=logs[i], stderr=subprocess.STDOUT,
        cwd=ROOT) for i in range(2)]
    try:
        for p in procs:
            p.wait(timeout=c["mh_timeout_s"])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait(timeout=60)
    for f in logs:
        f.close()
    wall = time.perf_counter() - t0
    texts = [open(os.path.join(out, f"child_{i}.log")).read() for i in range(2)]
    for i, text in enumerate(texts):
        for line in text.splitlines():
            if line.startswith(f"[mh {i}]") or line.startswith("MULTIHOST"):
                log(line)
    if any(p.returncode != 0 for p in procs) or not all(
            f"MULTIHOST OK process={i}" in t for i, t in enumerate(texts)):
        for i, t in enumerate(texts):
            log(f"[mh] child {i} rc {procs[i].returncode}, last lines:\n"
                + "\n".join(t.splitlines()[-40:]))
        raise PhaseFailed("[mh] the multihost processes failed")
    log(f"[mh] two processes on cuda:0 ran every leg in {wall:.1f} s ({card})")
    reports = [json.load(open(os.path.join(out, f"report_{i}.json")))
               for i in range(2)]
    faults = []
    for i, r in enumerate(reports):
        core = r["core"]
        if not (core["instances"] == [0, 1] and core["producers"] == 4
                and core["rows_kept"] and core["moved"]):
            faults.append(f"core {i}: {core}")
        if r["stream"]["instances"] != [0, 1] or r["stream"]["shapes"] != [
                [4, 16, 8]]:
            faults.append(f"stream {i}: {r['stream']}")
        if not (r["ckpt"]["restored"] and r["ckpt"]["step"] == r["ckpt"]["expected"]):
            faults.append(f"ckpt {i}: {r['ckpt']}")
    for leg in ("dpsp", "ppdp", "packed"):
        if reports[0][leg]["losses"] != reports[1][leg]["losses"]:
            faults.append(f"{leg}: the processes report different losses")
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=c["mh_layers"])
    small = dataclasses.replace(llama.LlamaConfig.llama3_8b(), **MH_SMALL)
    T = TRAIN["seq_len"]
    # C4: the packed leg's processes keep different token counts.
    counts = [_packed_counts(np.load(os.path.join(out, f"packed_{i}.npy")), T)
              for i in range(2)]
    differ = int((counts[0] != counts[1]).sum())
    log(f"[mh] packed: kept positions per window and step, process 0 "
        f"{counts[0].tolist()}, process 1 {counts[1].tolist()}: they differ "
        f"in {differ} of {counts[0].size} steps")
    if not differ:
        faults.append("packed: the processes' mask counts never differ")
    gaps = {}
    for leg, model, axes, spec, specs, loss, params, split in (
        ("dpsp", cfg, {"dp": 2, "sp": 2}, P(("dp",), "sp"),
         llama.param_specs(cfg),
         lambda mesh: (lambda p, b: llama.next_token_loss(p, b[0], cfg,
                                                          mesh=mesh)),
         lambda: llama.init_params(cfg, seed=SEED, device="cpu"), None),
        ("ppdp", cfg, {"dp": 2, "pp": 2}, P(("dp",)), llama.pp_param_specs(cfg),
         # Microbatches of one row, as each process's 2 rows in 2.
         lambda mesh: (lambda p, b: llama.next_token_loss_pp(p, b[0], cfg,
                                                             mesh, 4)),
         lambda: llama.stage_params(
             llama.init_params(cfg, seed=SEED, device="cpu"), 2), None),
        ("packed", small, {"dp": 2}, P(("dp",)), llama.param_specs(small),
         lambda mesh: (lambda p, b: llama.next_token_loss(
             p, b[0], small, mesh=mesh, segment_ids=b[1])),
         lambda: llama.init_params(small, seed=SEED, device="cuda"), T),
    ):
        wins = np.concatenate([np.load(os.path.join(out, f"{leg}_{i}.npy"))
                               for i in range(2)], axis=2)
        mesh = make_mesh(axes, ["cuda:0"] * int(math.prod(axes.values())))
        fa.reset_launch_counts()
        ref = _one_process_reference(model, loss(mesh), params(), specs, spec,
                                     mesh, wins, split)
        free_device_memory()
        got = reports[0][leg]["losses"]
        gaps[leg] = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
        log(f"[mh] {leg}: two-process losses {got}, one-process {ref}: "
            f"largest relative gap {gaps[leg]:.3e} (tolerance {MH_LOSS_TOL}) "
            f"({card})")
        if not gaps[leg] <= MH_LOSS_TOL:
            faults.append(f"{leg} gap {gaps[leg]}")
    # C5: evaluate returns one value on every process, the one-process
    # value over the global batches.
    import torch

    params = llama.init_params(small, seed=SEED, device="cuda")
    for name, metric in _eval_metrics(small).items():
        vals = [r["evaluate"][name]["value"] for r in reports]
        joined = np.concatenate([np.load(os.path.join(out, f"eval_{name}_{i}.npy"))
                                 for i in range(2)], axis=1)
        with torch.no_grad():
            per_batch = []
            for rows in joined:
                t = torch.from_numpy(rows).cuda()
                cols = (t,) if name == "tokens" else (t[:, :T], t[:, T:])
                per_batch.append(float(metric(params, cols)))
        want = float(np.mean(per_batch))
        gaps[f"evaluate_{name}"] = gap = abs(vals[0] - want) / abs(want)
        log(f"[mh] evaluate ({name}): process values {vals}, one-process "
            f"value over the {len(per_batch)} global batches {want}: relative "
            f"gap {gap:.3e} (tolerance {MH_LOSS_TOL}) ({card})")
        if not (vals[0] == vals[1] and gap <= MH_LOSS_TOL):
            faults.append(f"evaluate {name}: {vals} vs {want}")
        # Each process: one forward call a layer and batch, K1 on the
        # token stream, K4 on the documents, no backward.
        ran = "flash_fwd" if name == "tokens" else "flash_fwd_seg"
        for r in reports:
            ev = r["evaluate"][name]
            want_l = {fn.__name__: (ev["batches"] * small.n_layers
                                    if fn.__name__ == ran else 0)
                      for fn in fa.KERNELS}
            if ev["launches"] != want_l:
                faults.append(f"evaluate {name} launches {ev['launches']} "
                              f"(want {want_l})")
    del params
    free_device_memory()
    launches = {}
    for leg in ("dpsp", "ppdp", "packed"):
        for name, (n, _) in reports[0][leg]["launches"].items():
            launches[name] = launches.get(name, 0) + sum(
                r[leg]["launches"][name][0] for r in reports)
    # A process's steps: the dpsp ring is sp^2 = 4 calls a layer a step, the
    # ppdp pipeline 2 microbatches a layer a step, the packed fit 1.
    steps = reports[0]["dpsp"]["steps"]
    L = cfg.n_layers
    want_dense = 2 * (4 * L * steps + 2 * L * steps)
    want_packed = 2 * MH_SMALL["n_layers"] * steps
    for i, fn in enumerate(fa.KERNELS):
        want = want_packed if fn.__name__.endswith("_seg") else want_dense
        if launches[fn.__name__] != want:
            faults.append(f"multihost launches {launches} (want {want} for "
                          f"{fn.__name__})")
            break
    log(f"[mh] K1-K6 launches over both processes {launches}: K1-K3 2 "
        f"processes x (sp^2 x {L} layers + 2 microbatches x {L} layers) x "
        f"{steps} steps = {want_dense}, K4-K6 2 x {MH_SMALL['n_layers']} x "
        f"{steps} = {want_packed}")
    zero1 = mh_zero1_gates(out, reports, cfg, small, card, faults)
    if faults:
        raise PhaseFailed("[mh] " + "; ".join(faults))
    return launches, {"wall_s": wall, "reports": reports, "gaps": gaps,
                      "tol": MH_LOSS_TOL, "zero1": zero1}


def mh_zero1_gates(out, reports, cfg, small, card, faults):
    """Phase 12 (b)'s ZeRO-1 and int8 gates over the children's reports:
    z1 bit-equal to dpsp (else within ``MH_LOSS_TOL``); z1int8 within
    ``PARITY_REL_TOL`` of z1's curve and within ``MH_LOSS_TOL`` of the
    port's one-process zero1 int8 run over the same global mesh and
    windows; each process's moments equal to the reference rule's count
    for one replica (``hbm_accounting``, the JAX package's rule); the int8
    gather's bytes over fp32's in 3.7-4.1; K1-K3 launches a leg equal to
    dpsp's; i8 within ``MH_LOSS_TOL`` of the one-process int8 run and
    inside ``loss_parity`` of the one-process fp32 run, with nonzero
    drift; the z1ckpt leg restored bit-equal on both ranks.  Appends to
    ``faults``; returns the legs' numbers (K1-K6 launches over both
    processes and every zero1 leg under ``"launches"``)."""
    import numpy as np

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.optimizer import (
        PARITY_REL_TOL,
        hbm_accounting,
        loss_parity,
    )

    res = {}
    z1, dpsp = reports[0]["z1"]["losses"], reports[0]["dpsp"]["losses"]
    res["z1_bit_equal"] = z1 == dpsp
    res["z1_gap"] = max(abs(a - b) / abs(b) for a, b in zip(z1, dpsp))
    if not (res["z1_bit_equal"] or res["z1_gap"] <= MH_LOSS_TOL):
        faults.append(f"z1 {z1} vs dpsp {dpsp}")
    for leg in ("z1", "z1int8", "i8"):
        if reports[0][leg]["losses"] != reports[1][leg]["losses"]:
            faults.append(f"{leg}: the processes report different losses")
    res["z1int8_parity"] = loss_parity(z1, reports[0]["z1int8"]["losses"])
    if not res["z1int8_parity"]["parity"]:
        faults.append(f"z1int8 parity {res['z1int8_parity']}")
    wins = np.concatenate([np.load(os.path.join(out, f"z1int8_{i}.npy"))
                           for i in range(2)], axis=2)
    mesh = make_mesh({"dp": 2, "sp": 2}, ["cuda:0"] * 4)
    fa.reset_launch_counts()
    ref = _one_process_reference(
        cfg, lambda p, b: llama.next_token_loss(p, b[0], cfg, mesh=mesh),
        llama.init_params(cfg, seed=SEED, device="cpu"), llama.param_specs(cfg),
        P(("dp",), "sp"), mesh, wins, **MH_ZERO1_LEGS["z1int8"])
    free_device_memory()
    got = reports[0]["z1int8"]["losses"]
    res["z1int8_gap"] = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    log(f"[mh] z1int8: two-process losses {got}, one-process zero1 int8 "
        f"{ref}: largest relative gap {res['z1int8_gap']:.3e} (tolerance "
        f"{MH_LOSS_TOL}); against z1 {res['z1int8_parity']} ({card})")
    if not res["z1int8_gap"] <= MH_LOSS_TOL:
        faults.append(f"z1int8 gap {res['z1int8_gap']}")
    want_state = hbm_accounting(llama.param_shapes(cfg), llama.param_specs(cfg),
                                {"dp": 2, "sp": 2}, "zero1").opt_state_bytes
    res["state_bytes"] = {leg: [r[leg]["state_bytes"] for r in reports]
                          for leg in ("dpsp", "z1", "z1int8")}
    res["state_bytes_rule"] = want_state
    for leg in MH_ZERO1_LEGS:
        if res["state_bytes"][leg] != [want_state, want_state]:
            faults.append(f"{leg} moments {res['state_bytes'][leg]} bytes a "
                          f"process, the rule {want_state}")
    ratio = [r["z1"]["gather_bytes"] / r["z1int8"]["gather_bytes"]
             for r in reports]
    res["gather_ratio"] = ratio
    if not all(3.7 <= x <= 4.1 for x in ratio):
        faults.append(f"fp32 / int8 gather bytes {ratio}")
    for r in reports:
        for leg in MH_ZERO1_LEGS:
            if not (r[leg]["scatter_bytes"] > 0 and r[leg]["gather_bytes"] > 0):
                faults.append(f"{leg} moved no scatter or gather bytes")
            if r[leg]["launches"] != r["dpsp"]["launches"]:
                faults.append(f"{leg} launches {r[leg]['launches']} vs dpsp "
                              f"{r['dpsp']['launches']}")
    for leg in ("dpsp", *MH_ZERO1_LEGS, "i8"):
        rows = [f"process {i}: {r[leg]['step_ms']:.1f} ms/step (steady "
                f"{r[leg]['steady_step_ms']:.1f}), " + ", ".join(
                    f"{g} {r[leg][f'{g}_ms']:.1f} ms / {r[leg][f'{g}_bytes']:.0f} B"
                    for g in MH_LEGS)
                + f", moments {r[leg]['state_bytes']} B, peak "
                f"{r[leg]['peak_bytes'] / 2**30:.2f} GiB"
                for i, r in enumerate(reports)]
        log(f"[mh] {leg} a step: " + "; ".join(rows) + f" ({card})")
    log(f"[mh] moments a process {res['state_bytes']}, the reference rule "
        f"for one replica {want_state}; fp32 / int8 gather bytes {ratio} "
        f"({card})")
    # int8 alone at the small width, against one-process runs.
    i8 = np.concatenate([np.load(os.path.join(out, f"i8_{i}.npy"))
                         for i in range(2)], axis=2)
    mesh = make_mesh({"dp": 2}, ["cuda:0"] * 2)

    def small_ref(**kw):
        return _one_process_reference(
            small, lambda p, b: llama.next_token_loss(p, b[0], small, mesh=mesh),
            llama.init_params(small, seed=SEED, device="cuda"),
            llama.param_specs(small), P(("dp",)), mesh, i8, **kw)

    ref_i8, ref_fp32 = small_ref(grad_comm="int8"), small_ref()
    free_device_memory()
    got = reports[0]["i8"]["losses"]
    res["i8_gap"] = max(abs(a - b) / abs(b) for a, b in zip(got, ref_i8))
    res["i8_parity"] = loss_parity(ref_fp32, got)
    log(f"[mh] i8: two-process losses {got}, one-process int8 {ref_i8} (gap "
        f"{res['i8_gap']:.3e}, tolerance {MH_LOSS_TOL}), one-process fp32 "
        f"{ref_fp32}: {res['i8_parity']} ({card})")
    if not (res["i8_gap"] <= MH_LOSS_TOL and res["i8_parity"]["parity"]
            and res["i8_parity"]["max_rel_drift"] > 0.0):
        faults.append(f"i8 gap {res['i8_gap']}, parity {res['i8_parity']}")
    ck = [r["z1ckpt"] for r in reports]
    res["z1ckpt"] = ck
    if not all(c["sync_restored"] and c["async_restored"] for c in ck):
        faults.append(f"z1ckpt {ck}")
    res["launches"] = {
        fn.__name__: sum(r[leg]["launches"][fn.__name__][0] for r in reports
                         for leg in MH_ZERO1_LEGS) for fn in fa.KERNELS}
    res["ici_launches"] = {leg: [(r[leg]["k7"], r[leg]["k8"]) for r in reports]
                           for leg in ("dpsp", *MH_ZERO1_LEGS, "i8")}
    log(f"[mh] K1-K6 launches of the zero1 legs over both processes "
        f"{res['launches']}; (K7, K8) a process and leg "
        f"{res['ici_launches']}; PARITY_REL_TOL {PARITY_REL_TOL} ({card})")
    return res


def shuffle_impl_ab(card):
    """(c) ``shuffle_impl="xla"`` beside ``"ring"`` at phase 4's geometry:
    the served streams byte-identical, K9 on the ring route only, one
    round's ms each."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ops import device_shuffle as dsh
    from ddl_tpu_torch.shuffle import (
        DeviceExchangeFabric, DeviceExchangeShuffler, exchange_permutation,
    )

    sh = SHUFFLE
    n = sh["n"]
    streams, launches, legs = {}, {}, {}
    for impl in ("ring", "xla"):
        fabric = DeviceExchangeFabric(devices=["cuda:0"] * n, impl=impl)
        dsh.reset_launch_counts()
        streams[impl], _, _ = drain_instances(
            lambda: DeviceExchangeShuffler.factory(fabric=fabric))
        torch.cuda.synchronize()
        launches[impl], legs[impl] = dsh.exchange_ring.launches, fabric.legs
    same = all(torch.equal(_bytes(streams["ring"][i]), _bytes(streams["xla"][i]))
               for i in range(n))
    half = int(sh["rows"] * sh["fraction"]) // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gin = torch.randn((n * 2 * half, sh["cols"]), generator=gen, device="cuda")
    p = exchange_permutation(n, SEED, 0)
    ms = {impl: _time_ms(lambda impl=impl: dsh.exchange_start(
        impl, gin, ["cuda:0"] * n, p), reps=20, warmup=3)
        for impl in ("ring", "xla")}
    equal_out = torch.equal(dsh.exchange_start("ring", gin, ["cuda:0"] * n, p),
                            dsh.exchange_start("xla", gin, ["cuda:0"] * n, p))
    log(f"[xla] streams byte-identical {same}; one round's outputs equal "
        f"{equal_out}; K9 launches ring {launches['ring']} (rounds "
        f"{legs['ring']}), xla {launches['xla']} (rounds {legs['xla']}); one "
        f"round {ms['ring']:.4f} ms ring, {ms['xla']:.4f} ms xla ({card})")
    if not (same and equal_out and launches["ring"] == legs["ring"] > 0
            and launches["xla"] == 0 and legs["xla"] > 0):
        raise PhaseFailed("[xla] the xla exchange route failed its checks")
    return {"same": same, "launches": launches, "rounds": legs, "round_ms": ms}


def phase_pipeline(tmpdir, card):
    """Phase 12, the pipeline and MULTIHOST: (a) the pipelined fits, (b)
    two gloo processes sharing cuda:0, (c) the xla exchange route.
    Returns (K1-K3 pipeline launches, K1-K6 multihost launches,
    summary)."""
    t0 = time.perf_counter()
    free_device_memory()
    pipe = pipeline_fits(tmpdir, card)
    pipe_launches = {name: n for name, (n, _) in
                     pipe["runs"]["gpipe"]["launches"].items()}
    mh_launches, mh = multihost_run(tmpdir, card)
    xla = shuffle_impl_ab(card)
    free_device_memory()
    log(f"[pipe] phase 12 took {time.perf_counter() - t0:.1f} s")
    return pipe_launches, mh_launches, {"pipeline": pipe, "multihost": mh,
                                        "xla": xla}


# ------------------------------------------------------------ phase 13 ---

#: Phase 13, observability: the ICI lane's windows (phase 5's geometry)
#: and the flight recorder's drain (phase 6's token stream).
OBS = dict(ici_epochs=3, fault_epochs=4)
#: The stage events every served window of a fit must have.
OBS_LIFECYCLE = ("producer.fill", "producer.commit", "consumer.acquire",
                 "ingest.transfer", "trainer.consume", "consumer.release")


def _obs_armed(slog, directory):
    """A factory of the armed context: ``slog`` and a flight recorder
    dumping into ``directory``, both exported, so PROCESS producers
    spawned inside arm their own at import."""
    from ddl_tpu_torch.obs import recorder, spans

    @contextlib.contextmanager
    def arm():
        with spans.tracing(slog, export=True), recorder.armed(
                directory=directory, export=True):
            yield

    return arm


def _served_windows(events):
    """The stages seen per window, for the windows the consumer served
    (their ``consumer.yield`` instants)."""
    stages = {}
    for e in events:
        if e[3] is not None:
            stages.setdefault((e[3], e[4]), set()).add(e[2])
    return {k: v for k, v in stages.items() if "consumer.yield" in v}


def obs_fits(tmpdir, card, phase6):
    """(a) Phase 6's token cell (same seed-0 weights, 3 windows of 2
    steps) disarmed and with span tracing and the flight recorder armed
    (exported: PROCESS producers arm themselves at import), in turns:
    THREAD disarmed, armed, armed, disarmed, then PROCESS armed,
    disarmed.  Gates: every fit's losses and K1-K3 launches bit-equal to
    phase 6's fit of its mode; every served window's stage events keyed
    on its trailer identity; in PROCESS mode the producers' lanes arrive
    through ObsReports, the merger adopts ``producer.<idx>.*`` and the
    Chrome trace has one flow per served window; ``north_star_report``'s
    window latency p99 >= p50 > 0; no flight dump in a clean fit.
    Reports ms/step armed and disarmed (wall and steady, each pair's
    spread), their ratios, events a window and the ObsReports' pickled
    bytes."""
    import pickle

    from ddl_tpu_torch.ingest import north_star_report
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.obs import ReportMerger, SpanLog, chrome_trace
    from ddl_tpu_torch.readers import TokenStreamProducer

    tr = TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    producer = TokenStreamProducer(_token_file(tmpdir), tr["seq_len"],
                                   tr["window_rows"], seed=SEED)

    def loss_fn(p, b):
        return llama.next_token_loss(p, b[0], cfg)

    faults, runs, sizes = [], [], []
    apply = ReportMerger.apply

    def measured_apply(self, report):
        sizes.append(len(pickle.dumps(report)))
        return apply(self, report)

    order = [("thread", False), ("thread", True), ("thread", True),
             ("thread", False), ("process", True), ("process", False)]
    for k, (mode, armed) in enumerate(order):
        tag = f"[obs] {'armed' if armed else 'disarmed'}"
        if not armed:
            s = _fit_mode(mode, producer, loss_fn, cfg, tag, card)
        else:
            slog = SpanLog()
            flight_dir = os.path.join(tmpdir, f"flight-{k}")
            ReportMerger.apply = measured_apply
            try:
                s = _fit_mode(mode, producer, loss_fn, cfg, tag, card,
                              around=_obs_armed(slog, flight_dir),
                              keep_metrics=True)
            finally:
                ReportMerger.apply = apply
        s["armed"] = armed
        runs.append(s)
        ref = phase6[mode]
        if not (s["losses"] == ref["losses"]
                and s["launches"] == ref["launches"]
                and s["sm90_launches"] == ref["sm90_launches"]):
            faults.append(f"{mode} {tag}: losses {s['losses']} launches "
                          f"{s['launches']} vs phase 6's {ref['losses']} "
                          f"{ref['launches']}")
        if not armed:
            continue
        m = s.pop("metrics")
        events = slog.events()
        served = _served_windows(events)
        missing = {k: sorted(set(OBS_LIFECYCLE) - v)
                   for k, v in served.items() if not set(OBS_LIFECYCLE) <= v}
        if len(served) != tr["n_epochs"] or missing:
            faults.append(f"{mode}: served windows {sorted(served)}, "
                          f"missing stages {missing}")
        report = north_star_report(m)
        p50, p99 = report["window_latency_p50"], report["window_latency_p99"]
        if not p99 >= p50 > 0:
            faults.append(f"{mode}: window latency p50 {p50} p99 {p99}")
        flows = [e for e in chrome_trace(events)["traceEvents"]
                 if e["ph"] == "s"]
        pids = {e[5] for e in events}
        producer_pids = {e[5] for e in events
                         if e[2] in ("producer.fill", "producer.commit")}
        s.update(events=len(events), served=len(served),
                 events_per_window=len(events) / max(1, len(served)),
                 flows=len(flows), pids=len(pids),
                 window_latency_p50=p50, window_latency_p99=p99,
                 reports_applied=m.counter("obs.reports_applied"),
                 adopted=m.adopted_prefixes(),
                 dumps=len(os.listdir(flight_dir))
                 if os.path.isdir(flight_dir) else 0)
        if mode == "process":
            if not (os.getpid() not in producer_pids and len(pids) >= 3
                    and s["adopted"] == ["producer.0.", "producer.1."]
                    and s["reports_applied"] >= 2
                    and len(flows) == len(served)):
                faults.append(f"process: pids {len(pids)}, producer lanes "
                              f"local {os.getpid() in producer_pids}, adopted "
                              f"{s['adopted']}, reports "
                              f"{s['reports_applied']}, flows {len(flows)}")
        elif producer_pids != {os.getpid()} or flows:
            faults.append(f"thread: producer pids {producer_pids}, flows "
                          f"{len(flows)}")
        if s["dumps"]:
            faults.append(f"{mode}: {s['dumps']} flight dumps in a clean fit")
        stages = {}
        for e in events:
            if e[1] is not None:
                stages[e[2]] = stages.get(e[2], 0.0) + (e[1] - e[0])
        log(f"[obs] {mode} armed: {len(events)} events over {len(served)} "
            f"served windows ({s['events_per_window']:.1f} a window), "
            f"{len(pids)} pids, {len(flows)} flows, reports applied "
            f"{s['reports_applied']:.0f}, adopted {s['adopted']}; window "
            f"latency p50 {p50 * 1e3:.3f} ms p99 {p99 * 1e3:.3f} ms; span "
            f"seconds by stage {json.dumps(stages)} ({card})")
    ratios = {}
    for mode in ("thread", "process"):
        arm = [r for r in runs if r["mode"] == mode and r["armed"]]
        dis = [r for r in runs if r["mode"] == mode and not r["armed"]]
        for key in ("step_ms", "steady_step_ms"):
            a = [r[key] for r in arm]
            d = [r[key] for r in dis]
            ratios[f"{mode}_{key}"] = ratio = (sum(a) / len(a)) / (sum(d) / len(d))
            log(f"[obs] {mode} {key.replace('_', ' ')}: armed {a}, disarmed "
                f"{d}: ratio of the means {ratio:.4f}; spread of the "
                f"disarmed {max(d) - min(d):.2f} ms ({card})")
    log(f"[obs] ObsReport pickled bytes {sizes} (the warm-up fits' reports "
        f"carry no spans) ({card})")
    if faults:
        raise PhaseFailed("[obs] fits failed their checks: "
                          + "; ".join(faults))
    keep = ("mode", "armed", "losses", "step_ms", "steady_step_ms",
            "first_window_s", "teardown_s", "events", "served",
            "events_per_window", "flows", "pids", "window_latency_p50",
            "window_latency_p99", "reports_applied", "adopted")
    return {"runs": [{k: r[k] for k in keep if k in r} for r in runs],
            "ratios": ratios, "report_bytes": sizes}


def obs_profile_and_ici(tmpdir, card):
    """(b) One armed window of the token cell inside ``profiling.trace``:
    the exported Chrome trace holds the ``ddl.window_wait`` and
    ``ddl.ingest_put_window`` ranges and the K1-K3 kernels, K1's events as
    many as its counter's launches.  Then phase 5's geometry drained onto
    ``{"dp": 4}`` with ``distribute="ici"`` under armed spans: one
    ``ici.fanout`` span and one K8 launch a window."""
    import numpy as np
    import torch

    from ddl_tpu_torch import profiling
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.obs import SpanLog, spans
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.ops import ici_fanout as fan
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import ArrayProducer, TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    tr, faults = TRAIN, []
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    producer = TokenStreamProducer(_token_file(tmpdir), tr["seq_len"],
                                   tr["window_rows"], seed=SEED)
    trainer = Trainer(lambda p, b: llama.next_token_loss(p, b[0], cfg),
                      adamw(1e-5),
                      llama.init_params(cfg, seed=SEED, device="cuda"),
                      device="cuda", metrics=Metrics())

    def fit():
        return trainer.fit(producer, config=LoaderConfig(
            batch_size=tr["batch_size"], n_epochs=1,
            n_producers=tr["n_producers"], mode="thread", window_stream=True))

    fit()  # warm-up: cuBLAS handles and allocator pools stay out of it
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    with spans.tracing(SpanLog()), profiling.trace(
            os.path.join(tmpdir, "profile")) as prof:
        fit()
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    counted = {fn.__name__: fn.sm90_launches for fn in fa.KERNELS}
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    in_trace = {
        "flash_fwd": sum("flash_fwd_sm90_kernel" in n for n in kernels),
        "flash_bwd_dq": sum("flash_bwd_dq_sm90_kernel" in n for n in kernels),
        "flash_bwd_dkv": sum("flash_bwd_dkv_sm90_kernel" in n
                             for n in kernels),
    }
    ranges = {r: names.count(r) for r in ("ddl.window_wait",
                                          "ddl.ingest_put_window",
                                          "ddl.window_acquire",
                                          "ddl.staging_transfer")}
    size = os.path.getsize(prof.trace_path)
    log(f"[obs] profiling.trace of one armed window: {len(events)} trace "
        f"events ({size} bytes, {traced_s:.2f} s with the export), "
        f"{len(kernels)} kernels; K1-K3 events {in_trace} against the "
        f"counters {counted}; host ranges {ranges} ({card})")
    if not (ranges["ddl.window_wait"] and ranges["ddl.ingest_put_window"]
            and all(in_trace[k] > 0 for k in in_trace)
            and in_trace["flash_fwd"] == counted["flash_fwd"]):
        faults.append(f"profile: ranges {ranges}, kernels {in_trace} vs "
                      f"{counted}")
    del trainer
    free_device_memory()

    g, n = ICI, OBS["ici_epochs"]
    data = np.random.default_rng(SEED).standard_normal(
        (g["n_rows"], g["cols"]), dtype=np.float32)
    host, _, _ = _ici_drain(ArrayProducer(data, window_size=g["window"],
                                          seed=SEED), g["batch_size"], n)
    fan.reset_launch_counts()
    slog = SpanLog()
    with spans.tracing(slog):
        checks, m, wall = _ici_drain(
            ArrayProducer(data, window_size=g["window"], seed=SEED),
            g["batch_size"], n, host, {"dp": 4}, (None, "dp"))
        torch.cuda.synchronize()
    fanout = [e for e in slog.events() if e[2] == "ici.fanout"]
    keys = {(e[3], e[4]) for e in fanout}
    served = _served_windows(slog.events())
    k8 = fan.fanout_shard.launches
    log(f"[obs] armed ICI drain, dp=4: {len(checks)} windows byte-equal "
        f"{all(checks)}, ici.fanout spans {len(fanout)} over windows "
        f"{sorted(keys)}, K8 launches {k8}, K7 {fan.fanout_replicate.launches}"
        f", span seconds {sum(e[1] - e[0] for e in fanout):.6f} ({card})")
    if not (all(checks) and len(checks) == n and len(fanout) == n
            and keys == set(served) and k8 == n
            and fan.fanout_replicate.launches == 0
            and m.counter("ici.fallbacks") == 0):
        faults.append(f"ici: checks {checks}, spans {len(fanout)} keys "
                      f"{sorted(keys)} served {sorted(served)}, K8 {k8}")
    if faults:
        raise PhaseFailed("[obs] " + "; ".join(faults))
    return {"trace_events": len(events), "trace_bytes": size,
            "kernels_in_trace": in_trace, "counted": counted,
            "ranges": ranges, "ici_spans": len(fanout), "ici_k8": k8}


def obs_flight(tmpdir, card):
    """(c) Phase 6's token stream drained onto cuda:0 (THREAD, 4 windows)
    with spans and the flight recorder armed and producer 1's second commit
    corrupted after its stamp (a ``FaultPlan``): exactly one dump names
    the quarantined window, ``python -m ddl_tpu_torch.obs dump`` prints
    it with exit code 0, and the served stream equals an undisturbed
    drain's."""
    import torch

    import ddl_tpu_torch
    from ddl_tpu_torch import faults as flt
    from ddl_tpu_torch.obs import recorder, spans
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.readers import TokenStreamProducer

    tr, n = TRAIN, OBS["fault_epochs"]

    def drain(metrics):
        @ddl_tpu_torch.distributed_dataloader(
            n_producers=tr["n_producers"], mode="thread", nslots=2)
        def run(env):
            loader = ddl_tpu_torch.DistributedDataLoader(
                TokenStreamProducer(_token_file(tmpdir), tr["seq_len"],
                                    tr["window_rows"], seed=SEED),
                batch_size=tr["batch_size"], connection=env.connection,
                n_epochs=n, output="device", device="cuda", metrics=metrics,
                timeout_s=120.0)
            wins = []
            for win in loader.windows():
                wins.append(win.cpu())
                loader.mark(ddl_tpu_torch.Marker.END_OF_EPOCH)
            return wins

        return run()

    clean = drain(Metrics())
    directory = os.path.join(tmpdir, "flight-fault")
    plan = flt.FaultPlan([flt.FaultSpec(
        "producer.commit", flt.FaultKind.RING_CORRUPTION, at=2,
        producer_idx=1, param=8)], seed=SEED)
    m = Metrics()
    with spans.tracing(), recorder.armed(directory=directory) as rec, \
            flt.armed(plan):
        got = drain(m)
    dumps = []
    for path in sorted(rec.dumped_paths):
        with open(path) as f:
            dumps.append((path, json.load(f)))
    named = [(p, d) for p, d in dumps if d["window"]["seq"] is not None]
    same = len(got) == len(clean) and all(torch.equal(a, b)
                                          for a, b in zip(got, clean))
    faults = []
    if len(named) != 1 or named[0][1]["reason"] != "integrity.corrupt_window" \
            or named[0][1]["window"] != {"producer_idx": 1, "seq": 1}:
        faults.append(f"dumps {[(d['reason'], d['window']) for _, d in dumps]}")
    if not (plan.fired and same and m.counter("integrity.replays") == 1):
        faults.append(f"fired {plan.fired}, stream equal {same}, replays "
                      f"{m.counter('integrity.replays')}")
    out = None
    if named:
        path = named[0][0]
        out = subprocess.run([sys.executable, "-m", "ddl_tpu_torch.obs",
                              "dump", path], capture_output=True, text=True,
                             cwd=ROOT, timeout=120)
        log(f"[obs] flight dump {os.path.basename(path)} "
            f"({os.path.getsize(path)} bytes, {len(named[0][1]['events'])} "
            f"ring events); python -m ddl_tpu_torch.obs dump -> rc "
            f"{out.returncode}:\n" + "\n".join(out.stdout.splitlines()[:12]))
        if out.returncode != 0 or "seq=1" not in out.stdout:
            faults.append(f"obs dump rc {out.returncode}: {out.stderr[-500:]}")
    log(f"[obs] corrupt window under an armed recorder: dumps "
        f"{[(d['reason'], d['window']) for _, d in dumps]}; stream equal to "
        f"the undisturbed drain {same}; replays "
        f"{m.counter('integrity.replays'):.0f} ({card})")
    if faults:
        raise PhaseFailed("[obs] flight recorder: " + "; ".join(faults))
    return {"dumps": [(d["reason"], d["window"]) for _, d in dumps],
            "dump_bytes": os.path.getsize(named[0][0]),
            "ring_events": len(named[0][1]["events"])}


def phase_obs(tmpdir, card, phase6):
    """Phase 13, observability: (a) the armed fits against the disarmed,
    (b) the profiler and the ICI lane, (c) the flight recorder."""
    t0 = time.perf_counter()
    free_device_memory()
    fits = obs_fits(tmpdir, card, phase6)
    free_device_memory()
    prof = obs_profile_and_ici(tmpdir, card)
    flight = obs_flight(tmpdir, card)
    free_device_memory()
    log(f"[obs] phase 13 took {time.perf_counter() - t0:.1f} s")
    return {"fits": fits, "profile": prof, "flight": flight}


# ------------------------------------------------------------ phase 14 ---

#: Phase 14's cells.  (a) The MoE at Mixtral-8x7B's published widths
#: (vocab 32000, d_model 4096, 32/8 heads, d_ff 14336, 8 experts, top-2)
#: cut to 2 layers, B = 2 rows of 2048 tokens (N = 4096 routed together,
#: C = 1280 at capacity_factor 1.25), 2 steps a window, 3 windows;
#: packed documents end in Mixtral's ``</s>`` (id 2).  (b) ViT-B/16 on
#: 224 x 224 x 3 images in 16 x 16 patches (196 tokens), 1000 classes,
#: B = 32, shards of 64 ``[pixels..., label]`` rows (one window, 2 steps),
#: 3 windows.  (c) The pointwise regressor on (pos, target, weight) rows,
#: batches of 4096 points, windows of 16384, 3 windows.
MOE = dict(n_layers=2, seq_len=2048, batch_size=2, window_rows=4, n_epochs=3,
           n_producers=2, n_tokens=4_000_000, eos=2, prompt=16, new_tokens=8)
VIT = dict(batch_size=32, window_rows=64, n_epochs=3, n_producers=2,
           seq_len=196, n_shards=4)
POINTS = dict(batch_size=4096, window_rows=16384, n_epochs=3, n_producers=2,
              seq_len=1, n_shards=4)
#: The dense-attention twins of the MoE paths, in fp32 (phase 3's
#: tolerances are fp32 ones; the flash side takes the FMA kernels).  One
#: step at full width from the seed-0 weights is phase 3's check: loss
#: within 1e-5 relative, every gradient within 1e-4.  The twin fits'
#: per-window losses within 1e-4: Adam's normalised update turns the
#: ~1e-7 differences of near-zero gradient components into steps of the
#: full learning rate, and at a binding capacity one flipped pick moves a
#: token across an expert's capacity (the packed twins sit 1.38e-5 apart
#: in their third window, PERF.md §6).
MOE_TWIN_RTOL = (1e-5, 1e-4)
MOE_TWIN_FIT_RTOL = 1e-4
#: The MoE prefill's logits against the no-cache forward, both in fp32
#: (one routing of the same prompt: ``moe.py:634-642``), absolute.
MOE_PREFILL_ATOL = 1e-3


def _vit_b16():
    import torch

    from ddl_tpu_torch.models import vit

    return vit.ViTConfig(image_size=224, patch_size=16, d_model=768,
                         n_layers=12, n_heads=12, d_ff=3072, n_classes=1000,
                         dtype=torch.bfloat16)


def vit_kernel_checks(gen):
    """(b) first: K1-K3 with ``causal=False`` at the ViT-B/16 fit's shape
    (B = 32, T = 196, H = Hkv = 12, D = 64, bf16, the wgmma kernels)
    against their plain versions, forward and backward, at phase 2's
    tolerances; then each timed with the tiles it loaded (no causal skip:
    every tile pair is live), the plain version's time, SDPA's non-causal
    time at this shape and the bound of the B·H·T² pairs."""
    import torch
    import torch.nn.functional as F

    from ddl_tpu_torch.ops import flash_attention as fa

    cfg = _vit_b16()
    B, T, H, D = VIT["batch_size"], cfg.n_patches, cfg.n_heads, cfg.head_dim
    ok, errs, _, _ = _case(f"vit non-causal bf16 B={B} T={T} H=Hkv={H} D={D}",
                           B, T, T, H, H, D, torch.bfloat16, 0, 0, False,
                           TOL_BF16, gen)
    if not ok:
        raise PhaseFailed("[vit] a non-causal kernel disagrees with its plain "
                          "version at the ViT-B/16 shape")
    dt = torch.bfloat16
    q, k, v, dout = (_rand((B, T, H, D), dt, gen, "cuda") for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, 0, 0, False)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dlse = torch.zeros_like(lse)
    zeros = torch.zeros(B, T, dtype=torch.int32)
    rule = H * int(fa.live_tiles(zeros, zeros, causal=False).sum())
    rule_dkv = H * int(fa.live_tiles_dkv(zeros, zeros, causal=False).sum())
    every = B * H * math.ceil(T / 128) ** 2
    if rule != every:
        raise PhaseFailed(f"[vit] live_tiles(causal=False) gives {rule} key "
                          f"tiles, every pair is {every}")
    ms, tiles = {}, {}
    ms["fwd"], tiles["fwd"] = _timed_tile_visits(fa.flash_fwd, q, k, v, 0, 0,
                                                 False, rule=rule)
    ms["dq"], tiles["dq"] = _timed_tile_visits(
        fa.flash_bwd_dq, q, k, v, dout, lse, delta, dlse, 0, 0, False,
        rule=rule)
    ms["dkv"], tiles["dkv"] = _timed_tile_visits(
        fa.flash_bwd_dkv, q, k, v, dout, lse, delta, dlse, 0, 0, False,
        rule=rule_dkv)
    plain_ms = {"fwd": _time_ms(lambda: fa.attention_plain(q, k, v, causal=False))}
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    o, _ = fa.attention_plain(qq, kk, vv, causal=False)
    plain_ms["dq"] = _time_ms(lambda: torch.autograd.grad(
        o, qq, dout, retain_graph=True))
    plain_ms["dkv"] = _time_ms(lambda: torch.autograd.grad(
        o, (kk, vv), dout, retain_graph=True))
    del o, qq, kk, vv
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    qs, ks_, vs = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    so = F.scaled_dot_product_attention(qs, ks_, vs)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
        so, (qs, ks_, vs), dout.transpose(1, 2), retain_graph=True))
    del so, qs, ks_, vs
    pairs = B * H * T * T
    n_q = B * T * H * D * 2
    rows = B * H * T * 4
    work = {"fwd": (4 * D * pairs, 4 * n_q + rows),
            "dq": (6 * D * pairs, 5 * n_q + 3 * rows),
            "dkv": (8 * D * pairs, 6 * n_q + 3 * rows)}
    abs_err = {"fwd": errs["out_abs"], "dq": errs["dq_abs"],
               "dkv": max(errs["dk_abs"], errs["dv_abs"])}
    out_rows = {}
    for key, name in (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq"),
                      ("dkv", "flash_bwd_dkv")):
        bound_ms, bound_by = _bound(*work[key])
        out_rows[name] = {
            "shape": f"B={B} T={T} H=Hkv={H} D={D} bf16 non-causal",
            "ms": ms[key], "plain_ms": plain_ms[key], "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": abs_err[key],
            "tiles_visited": tiles[key],
            "library_ms": library if key == "fwd" else None}
        log(f"[vit] {name} non-causal: {ms[key]:.4f} ms  plain "
            f"{plain_ms[key]:.3f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
            f"{'query' if key == 'dkv' else 'key'} tiles {tiles[key]}"
            + (f"  sdpa non-causal {library:.4f} ms" if key == "fwd" else ""))
    log(f"[vit] sdpa non-causal backward (dq, dk, dv together): "
        f"{sdpa_bwd:.4f} ms")
    return out_rows


class _DropCount:
    """Counts the einsum impl's picks and those past the capacity while
    armed (wraps ``moe._arrival``; the sums stay on the card until read)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.picks = self.dropped = None

    @contextlib.contextmanager
    def __call__(self):
        import torch

        from ddl_tpu_torch.models import moe

        orig = moe._arrival

        def counted(mask):
            pos = orig(mask)
            C = self.cfg.capacity(pos.shape[0])
            over = (pos >= C).sum()
            self.dropped = over if self.dropped is None else self.dropped + over
            self.picks = (pos.numel() if self.picks is None
                          else self.picks + pos.numel())
            return pos

        moe._arrival = counted
        try:
            yield
        finally:
            moe._arrival = orig
            torch.cuda.synchronize()

    def share(self) -> float:
        return 0.0 if not self.picks else float(self.dropped) / self.picks


def moe_layer_parts(cfg, n_tokens, card):
    """Where one MoE layer's MLP time goes at the fit's N (einsum impl,
    bf16, seed-0 weights of one layer), forward and backward of each part
    timed apart on the card's clock: the routing (router product,
    softmax, top-k, the slot-major arrival, the combine tensor), the
    one-hot dispatch and combine products, the three expert products,
    and the whole ``moe_mlp``."""
    import torch
    import torch.nn.functional as F

    from ddl_tpu_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    one = dataclasses.replace(cfg, n_layers=1)
    layer = {k: v.requires_grad_(True) for k, v in
             moe.init_params(one, seed=SEED, device="cuda")["layers"][0].items()}
    dt, E, D = cfg.dtype, cfg.n_experts, cfg.d_model
    C = cfg.capacity(n_tokens)
    x = _rand((n_tokens, D), dt, gen, "cuda").requires_grad_(True)

    def combine_of(x):
        probs, top_p, top_e = moe._router_topk(x, layer, cfg)
        mask = F.one_hot(top_e, E).float()
        pos = moe._arrival(mask).long()
        gates = top_p * (pos < C)
        slots = (pos[..., None] == torch.arange(C, device="cuda")).float()
        return torch.einsum("nke,nkc->nec", gates[..., None] * mask, slots)

    def routing():
        comb = combine_of(x)
        torch.autograd.grad(comb.sum(), (x, layer["w_router"]))

    combine = combine_of(x).detach().requires_grad_(True)
    dispatch = (combine > 0).to(dt)
    expert_out = _rand((E, C, D), dt, gen, "cuda").requires_grad_(True)
    g_out = _rand((n_tokens, D), dt, gen, "cuda")

    def dispatch_combine():
        ein = torch.einsum("nec,nd->ecd", dispatch, x)
        out = torch.einsum("nec,ecd->nd", combine.to(dt), expert_out)
        torch.autograd.grad((ein.float().sum(), out), (x, combine, expert_out),
                            (None, g_out))

    ein = _rand((E, C, D), dt, gen, "cuda").requires_grad_(True)
    g_ein = _rand((E, C, D), dt, gen, "cuda")

    def experts():
        gate = F.silu(torch.bmm(ein, layer["w_gate"].to(dt)))
        up = torch.bmm(ein, layer["w_up"].to(dt))
        out = torch.bmm(gate * up, layer["w_down"].to(dt))
        torch.autograd.grad(out, (ein, layer["w_gate"], layer["w_up"],
                                  layer["w_down"]), g_ein)

    def whole():
        out, aux = moe.moe_mlp(x, layer, cfg)
        torch.autograd.grad((out, aux), [x] + list(layer.values()),
                            (g_out, None), allow_unused=True)

    parts = {name: _time_ms(fn, reps=5) for name, fn in (
        ("routing", routing), ("dispatch_combine", dispatch_combine),
        ("experts", experts), ("moe_mlp", whole))}
    flops = 6 * 2 * E * C * D * cfg.d_ff  # the three products, fwd + bwd
    log(f"[moe-parts] one layer's MLP at N={n_tokens}, C={C}, forward + "
        f"backward: " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; the expert products at {flops / parts['experts'] / 1e9:.0f} "
        f"TFLOP/s ({card})")
    del layer, x, combine, dispatch, expert_out, ein
    free_device_memory()
    return parts


def moe_step_twins(params, cfg, batches, card):
    """Phase 3's check at full width: the fp32 loss and every gradient of
    one step from the seed-0 weights through the flash kernels (the FMA
    route) against the dense path, on a token batch (K1-K3) and a packed
    batch with ``segment_ids`` (K4-K6)."""
    import torch

    from ddl_tpu_torch.models import moe
    from ddl_tpu_torch.ops import flash_attention as fa

    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    out = {}
    for name, (tokens, seg) in batches.items():
        ref = None
        for impl in ("dense", "flash"):
            leaves = [t.to("cuda").requires_grad_(True) for t in _leaves(params)]
            fa.reset_launch_counts()
            loss = moe.next_token_loss(
                _rebuild(params, iter(leaves)), tokens,
                dataclasses.replace(f32, attn_impl=impl), segment_ids=seg)
            loss.backward()
            launches = [fn.launches for fn in fa.KERNELS]
            if ref is None:
                ref = (float(loss), [t.grad.cpu() for t in leaves], launches)
            else:
                worst = max(_rel(t.grad, g.to("cuda"))
                            for t, g in zip(leaves, ref[1]))
                gap = abs(float(loss) - ref[0]) / abs(ref[0])
            del leaves, loss
            free_device_memory()
        n = cfg.n_layers
        want = ([0, 0, 0, n, n, n] if seg is not None else [n, n, n, 0, 0, 0])
        ok = (gap <= MOE_TWIN_RTOL[0] and worst <= MOE_TWIN_RTOL[1]
              and launches == want and ref[2] == [0] * 6)
        log(f"[moe-{name}] fp32 one step, flash vs dense at full width: loss "
            f"gap {gap:.3e}, worst grad rel err {worst:.3e} | tol loss rel<="
            f"{MOE_TWIN_RTOL[0]} grad rel<={MOE_TWIN_RTOL[1]}; launches "
            f"{launches} (expected {want}) -> {'ok' if ok else 'FAIL'} ({card})")
        if not ok:
            raise PhaseFailed(f"[moe] the {name} step through the kernels "
                              "disagrees with the dense path")
        out[name] = {"loss_gap": gap, "grad_rel": worst}
    return out


def _host_params(init, cfg):
    """seed-0 weights built on the card, kept on the host: every fit of a
    family starts from the same tree, and the Trainer's own copy on the
    card is the only one there."""
    from ddl_tpu_torch.parallel.train import tree_map

    params = tree_map(lambda t: t.cpu(), init(cfg, seed=SEED, device="cuda"))
    free_device_memory()
    return params


def moe_fits(tmpdir, card):
    """(a) The MoE at Mixtral-8x7B's widths (2 layers): one layer's MLP
    timed by part; one fp32 step of each path against its dense twin
    (``moe_step_twins``); ``Trainer.fit`` over THREAD producers three
    ways — the einsum impl on a Zipf token stream (K1-K3, profiled), the
    einsum impl on packed documents with ``segment_ids`` (K4-K6), the
    ragged impl on the token stream (K1-K3) — each with finite, falling
    losses, one launch a layer a step of its kernels on the wgmma route,
    its peak memory and its share of dropped picks; the einsum and
    packed fits again in fp32 beside their ``attn_impl="dense"`` twins
    (per-window losses within ``MOE_TWIN_FIT_RTOL``, the flash side on
    the FMA kernels); then greedy decode of ``new_tokens`` and the
    prefill's logits against the no-cache forward."""
    import numpy as np
    import torch

    from ddl_tpu_torch.models import moe
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.readers import PackedTokenProducer, TokenStreamProducer

    mo = MOE
    cfg = dataclasses.replace(moe.MoeConfig.mixtral_8x7b(),
                              n_layers=mo["n_layers"])
    shapes = moe.param_shapes(cfg)
    n_params = sum(t.numel() for t in _leaves(shapes))
    per_layer = sum(t.numel() for t in _leaves(shapes["layers"][0]))
    experts = sum(shapes["layers"][0][k].numel()
                  for k in ("w_gate", "w_up", "w_down"))
    n_tok = mo["batch_size"] * mo["seq_len"]
    log(f"[moe] mixtral_8x7b widths, {cfg.n_layers} layers: {n_params / 1e9:.3f} "
        f"B params ({per_layer / 1e9:.3f} B a layer, {experts / 1e9:.3f} B of "
        f"it experts); B={mo['batch_size']} T={mo['seq_len']}: N={n_tok} "
        f"tokens routed together, capacity {cfg.capacity(n_tok)} a expert")
    token_file = os.path.join(tmpdir, "moe_tokens.bin")
    ranks = np.random.default_rng(SEED).zipf(1.2, mo["n_tokens"]) - 1
    (ranks % cfg.vocab).astype(np.int32).tofile(token_file)
    doc_file = os.path.join(tmpdir, "moe_docs.bin")
    documents(mo["n_tokens"], vocab=cfg.vocab, eot=mo["eos"]).tofile(doc_file)
    parts = moe_layer_parts(cfg, n_tok, card)
    params = _host_params(moe.init_params, cfg)
    B, T = mo["batch_size"], mo["seq_len"]
    first = np.fromfile(token_file, np.int32, B * T).reshape(B, T)
    first_doc = np.fromfile(doc_file, np.int32, B * T).reshape(B, T)
    step_twins = moe_step_twins(params, cfg, {
        "einsum": (torch.tensor(first, device="cuda"), None),
        "packed": (torch.tensor(first_doc, device="cuda"),
                   torch.tensor(seg_ids(first_doc, mo["eos"]), device="cuda"))},
        card)
    tokens = TokenStreamProducer(token_file, mo["seq_len"], mo["window_rows"],
                                 seed=SEED)
    docs = PackedTokenProducer(doc_file, mo["seq_len"], mo["window_rows"],
                               delimiter=mo["eos"], seed=SEED)
    steps = mo["n_epochs"] * mo["window_rows"] // mo["batch_size"]
    expected = cfg.n_layers * steps

    def fit(tag, c, producer, packed, **kw):
        if packed:
            def loss_fn(p, b):
                return moe.next_token_loss(p, b[0], c, segment_ids=b[1])
        else:
            def loss_fn(p, b):
                return moe.next_token_loss(p, b[0], c)
        return _fit_mode("thread", producer, loss_fn, c, tag, card,
                         init_params=params, train=mo, **kw)

    faults, runs = [], {}
    for name, c, producer, packed in (
            ("einsum", cfg, tokens, False),
            ("packed", cfg, docs, True),
            ("ragged", dataclasses.replace(cfg, moe_impl="ragged"), tokens,
             False)):
        drops = _DropCount(c)
        s = fit(f"[moe-{name}]", c, producer, packed, around=drops,
                profile=name == "einsum")
        s["dropped_share"] = drops.share()
        ran, idle = ((fa.KERNELS[3:], fa.KERNELS[:3]) if packed
                     else (fa.KERNELS[:3], fa.KERNELS[3:]))
        _fit_gates(s, ran, idle, expected, faults)
        if not s["losses"][-1] < s["losses"][0]:
            faults.append(f"{name}: losses do not fall {s['losses']}")
        log(f"[moe-{name}] launches {s['launches']} (expected {cfg.n_layers} "
            f"layers x {steps} steps = {expected} for "
            f"{[fn.__name__ for fn in ran]}), wgmma {s['sm90_launches']}; "
            f"dropped {s['dropped_share']:.3%} of the picks "
            f"({'dropless' if c.moe_impl == 'ragged' else 'einsum'}); peak "
            f"{s['peak_bytes'] / 2**30:.2f} GiB ({card})")
        runs[name] = s

    # The dense-attention twins, fp32 on both sides.
    twins = {}
    for name, producer, packed in (("einsum", tokens, False),
                                   ("packed", docs, True)):
        pair = {}
        for impl in ("flash", "dense"):
            c = dataclasses.replace(cfg, dtype=torch.float32, attn_impl=impl)
            pair[impl] = fit(f"[moe-{name}-fp32-{impl}]", c, producer, packed,
                             warmup=False)
        ran = fa.KERNELS[3:] if packed else fa.KERNELS[:3]
        want = {fn.__name__: expected if fn in ran else 0 for fn in fa.KERNELS}
        gap = max(abs(a - b) / abs(b) for a, b in zip(pair["flash"]["losses"],
                                                       pair["dense"]["losses"]))
        log(f"[moe-{name}] fp32 flash vs dense: losses {pair['flash']['losses']} "
            f"vs {pair['dense']['losses']}, max relative gap {gap:.3e} | tol "
            f"{MOE_TWIN_FIT_RTOL}; flash launches {pair['flash']['launches']} "
            f"(FMA route: wgmma {pair['flash']['sm90_launches']}), dense "
            f"{pair['dense']['launches']}")
        if not (gap <= MOE_TWIN_FIT_RTOL
                and pair["flash"]["launches"] == want
                and not any(pair["flash"]["sm90_launches"].values())
                and not any(pair["dense"]["launches"].values())):
            faults.append(f"{name} fp32 twins: gap {gap:.3e}, launches "
                          f"{pair['flash']['launches']} / "
                          f"{pair['dense']['launches']}")
        twins[name] = {"gap": gap, "flash_step_ms": pair["flash"]["step_ms"],
                       "dense_step_ms": pair["dense"]["step_ms"],
                       "peak_bytes": max(p["peak_bytes"] for p in pair.values())}
    decode = _moe_decode(params, cfg, token_file, faults, card)
    del params
    free_device_memory()
    if faults:
        raise PhaseFailed("[moe] " + "; ".join(faults))
    launches = {fn.__name__: (runs["packed"] if fn in fa.KERNELS[3:]
                              else runs["einsum"])["launches"][fn.__name__]
                + (runs["ragged"]["launches"][fn.__name__]
                   if fn in fa.KERNELS[:3] else 0)
                for fn in fa.KERNELS}
    return launches, {"runs": {k: {x: s[x] for x in (
        "losses", "step_ms", "steady_step_ms", "peak_bytes", "dropped_share",
        "tokens_per_s")} for k, s in runs.items()}, "twins": twins,
        "decode": decode, "layer_parts_ms": parts, "step_twins": step_twins}


def _moe_decode(params, cfg, token_file, faults, card):
    """Greedy decode of ``new_tokens`` after a ``prompt``-token prefix of
    the stream, twice (the same tokens); then the prefill's logits (one
    routing of the whole prompt, as the training forward routes it)
    against the no-cache forward of the prompt, both in fp32."""
    import numpy as np
    import torch

    from ddl_tpu_torch.models import moe
    from ddl_tpu_torch.parallel.train import tree_map

    mo = MOE
    dev = tree_map(lambda t: t.to("cuda"), params)
    prompt = torch.tensor(np.fromfile(token_file, np.int32, mo["prompt"])[None],
                          device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = moe.generate(dev, prompt, cfg, max_new_tokens=mo["new_tokens"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    again = moe.generate(dev, prompt, cfg, max_new_tokens=mo["new_tokens"])
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        cache = moe.init_cache(f32, 1, mo["prompt"], device="cuda")
        cached, _ = moe.forward_with_cache(dev, prompt, f32, cache, 0)
        full, _ = moe.forward(dev, prompt, f32)
    gap = float((cached - full).abs().max())
    ok = (tuple(out.shape) == (1, mo["prompt"] + mo["new_tokens"])
          and torch.equal(out, again) and torch.equal(out[:, :mo["prompt"]], prompt)
          and bool(((out >= 0) & (out < cfg.vocab)).all())
          and gap <= MOE_PREFILL_ATOL)
    log(f"[moe-decode] greedy {mo['new_tokens']} tokens after {mo['prompt']}: "
        f"{out[0, mo['prompt']:].tolist()} in {gen_s:.3f} s "
        f"({gen_s / mo['new_tokens'] * 1e3:.1f} ms a token, prefill "
        f"included; {card}); repeat equal {torch.equal(out, again)}; fp32 "
        f"prefill vs no-cache forward max |dlogit| {gap:.3e} | tol "
        f"{MOE_PREFILL_ATOL} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        faults.append(f"decode: tokens {out.tolist()}, prefill gap {gap:.3e}")
    del dev
    return {"tokens": out[0].tolist(), "seconds": gen_s, "prefill_gap": gap}


def _npy_shards(tmpdir, name, rows_of, n_shards):
    """``n_shards`` ``.npy`` shards ``<name>-<i>.npy`` of ``rows_of(i)``;
    returns their glob."""
    import numpy as np

    for i in range(n_shards):
        np.save(os.path.join(tmpdir, f"{name}-{i}.npy"), rows_of(i))
    return os.path.join(tmpdir, f"{name}-*.npy")


def _vit_shards(tmpdir, cfg):
    """The ViT fit's ``.npy`` shards of ``[pixels..., label]`` rows:
    labels Zipf(1.5) ranks of the classes, each image's brightness
    tracking its label.  Returns their glob (written once a directory)."""
    import numpy as np

    px = cfg.image_size ** 2 * cfg.n_channels
    pattern = os.path.join(tmpdir, "vit-*.npy")
    if glob.glob(pattern):
        return pattern

    def rows(i):
        rng = np.random.default_rng([SEED, i])
        labels = (rng.zipf(1.5, VIT["window_rows"]) - 1) % cfg.n_classes
        pixels = (0.5 * rng.random((VIT["window_rows"], px), dtype=np.float32)
                  + 0.5 * (labels[:, None] / cfg.n_classes)).astype(np.float32)
        return np.concatenate([pixels, labels[:, None].astype(np.float32)], 1)

    return _npy_shards(tmpdir, "vit", rows, VIT["n_shards"])


def vit_fit(tmpdir, card):
    """(b) ViT-B/16 through ``Trainer.fit`` with ``classification_loss``
    over ``.npy`` shards of ``[pixels..., label]`` rows (the layout
    ``WebDatasetProducer`` serves) read by ``FileShardProducer`` with the
    two columns as splits.  Labels are Zipf(1.5) ranks of the 1000
    classes and each image's brightness tracks its label, so the losses
    can fall within 6 steps; K1-K3 run non-causal, one launch a layer a
    step on the wgmma route."""
    import numpy as np

    from ddl_tpu_torch.models import vit
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import FileShardProducer

    cfg = _vit_b16()
    px = cfg.image_size ** 2 * cfg.n_channels
    pattern = _vit_shards(tmpdir, cfg)
    n_params = sum(t.numel() for t in _leaves(vit.param_shapes(cfg)))
    log(f"[vit] ViT-B/16 widths: {n_params / 1e6:.1f} M params, "
        f"{cfg.n_patches} patches of {cfg.patch_dim}, {cfg.n_classes} "
        f"classes; B={VIT['batch_size']}, shards of {VIT['window_rows']} rows "
        f"({VIT['window_rows'] * (px + 1) * 4 / 2**20:.1f} MiB)")
    producer = FileShardProducer(pattern, splits=(px, 1), seed=SEED)
    s = _fit_mode("thread", producer,
                  lambda p, b: vit.classification_loss(p, b, cfg), cfg,
                  "[vit]", card,
                  init_params=vit.init_params(cfg, seed=SEED, device="cuda"),
                  train=VIT, optimizer=adamw(1e-4))
    steps = VIT["n_epochs"] * VIT["window_rows"] // VIT["batch_size"]
    expected = cfg.n_layers * steps
    faults = []
    _fit_gates(s, fa.KERNELS[:3], fa.KERNELS[3:], expected, faults)
    if not s["losses"][-1] < s["losses"][0]:
        faults.append(f"losses do not fall {s['losses']}")
    log(f"[vit] launches {s['launches']} (expected {cfg.n_layers} layers x "
        f"{steps} steps = {expected} for K1-K3, non-causal), wgmma "
        f"{s['sm90_launches']}; {s['step_ms']:.1f} ms/step wall, "
        f"{s['steady_step_ms']:.1f} steady, {s['tokens_per_s'] / 196:.0f} "
        f"images/s; peak {s['peak_bytes'] / 2**30:.2f} GiB ({card})")
    if faults:
        raise PhaseFailed("[vit] " + "; ".join(faults))
    return s["launches"], {k: s[k] for k in (
        "losses", "step_ms", "steady_step_ms", "peak_bytes", "tokens_per_s")}


def pointnet_fit(tmpdir, card):
    """(c) The pointwise regressor through ``Trainer.fit`` on the
    reference harness's ``(pos, target, weight)`` columns (``.npy``
    shards: positions in [0, 1)^3, six smooth fields of them, weights in
    [0.5, 1)); no kernel runs, the losses must fall."""
    import numpy as np

    from ddl_tpu_torch.models import pointnet
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import FileShardProducer

    freqs = np.random.default_rng(SEED).standard_normal((3, 6)) * 2.0

    def rows(i):
        rng = np.random.default_rng([SEED, 100 + i])
        pos = rng.random((POINTS["window_rows"], 3))
        target = np.sin(pos @ freqs)
        weight = 0.5 + 0.5 * rng.random((POINTS["window_rows"], 1))
        return np.concatenate([pos, target, weight], 1).astype(np.float32)

    pattern = _npy_shards(tmpdir, "points", rows, POINTS["n_shards"])
    cfg = pointnet.PointNetConfig()
    s = _fit_mode("thread", FileShardProducer(pattern, splits=(3, 6, 1),
                                              seed=SEED),
                  lambda p, b: pointnet.weighted_mse_loss(p, b, cfg), cfg,
                  "[pointnet]", card,
                  init_params=pointnet.init_params(cfg, seed=SEED,
                                                   device="cuda"),
                  train=POINTS, optimizer=adamw(1e-3, weight_decay=0.0))
    faults = []
    _fit_gates(s, (), fa.KERNELS, 0, faults)
    if not s["losses"][-1] < s["losses"][0]:
        faults.append(f"losses do not fall {s['losses']}")
    if faults:
        raise PhaseFailed("[pointnet] " + "; ".join(faults))
    return {k: s[k] for k in ("losses", "step_ms", "steady_step_ms")}


def phase_families(tmpdir, card):
    """Phase 14: the other model families at their published widths —
    (b)'s non-causal kernel checks first, then (a) the MoE fits and
    decode, (b) the ViT-B/16 fit, (c) the PointNet fit.  Returns the
    kernel launches of the MoE fits and of the ViT fit, the non-causal
    rows and a summary."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    vit_rows = vit_kernel_checks(gen)
    free_device_memory()
    moe_launches, moe_summary = moe_fits(tmpdir, card)
    vit_launches, vit_summary = vit_fit(tmpdir, card)
    free_device_memory()
    pn_summary = pointnet_fit(tmpdir, card)
    free_device_memory()
    took = time.perf_counter() - t0
    log(f"[families] phase 14 took {took:.1f} s")
    return moe_launches, vit_launches, vit_rows, {
        "moe": moe_summary, "vit": vit_summary, "pointnet": pn_summary,
        "seconds": took}


# ------------------------------------------------------------ phase 15 ---

#: Phase 15, the cluster ladder: phase 6's token cell (``TRAIN``) over two
#: mock hosts (producer 1 on host 0 with the trainer, producer 2 on host
#: 1) and 4 shards, each a fixed window of the Zipf corpus.  Each leg
#: acts after window ``act_at``; the drain leg rejoins after
#: ``rejoin_at`` (its survivor needs the windows between to reach the
#: adopted shards); the expiry leg's host lease; the failover leg's HA
#: lease; the supervisors' and the watchdog's poll.
CLUSTER = dict(n_shards=4, windows=10, drain_windows=13, act_at=3,
               rejoin_at=10, lease_s=1.5, ha_lease_s=0.3, poll_s=0.05,
               chaos_timeout_s=180)
LADDER_LEGS = ("thread", "process", "lease", "drain", "failover")


class ShardTokenProducer:
    """The ladder's producer: shard ``s`` is the ``s``-th window of the
    token file (``rows`` x ``seq_len`` tokens).  It serves its host's
    shard ranges in a cycle and ``adopt_shards`` re-partitions them; with
    ``sequence`` it serves those shards in that order instead (the
    replay control).  Module level: pickled to spawned producers."""

    def __init__(self, token_file, seq_len, rows, ranges_by_producer=None,
                 sequence=None):
        self.token_file, self.seq_len, self.rows = token_file, seq_len, rows
        self.ranges_by_producer = dict(ranges_by_producer or {})
        self.sequence = list(sequence or ())
        self.ranges = ()

    def on_init(self, producer_idx=1, **kw):
        import numpy as np

        from ddl_tpu_torch.datasetwrapper import DataProducerOnInitReturn

        self._tokens = np.memmap(self.token_file, dtype=np.int32, mode="r")
        self.it = 0
        if not self.sequence:
            self.ranges = tuple(self.ranges_by_producer[producer_idx])
        return DataProducerOnInitReturn(
            nData=self.rows, nValues=self.seq_len,
            shape=(self.rows, self.seq_len), splits=(self.seq_len,),
            dtype=np.int32)

    def post_init(self, my_ary, **kw):
        my_ary[:] = 0

    def execute_function(self, my_ary, **kw):
        shards = self.sequence or [s for a, b in self.ranges
                                   for s in range(a, b)]
        shard = shards[self.it % len(shards)]
        n = self.rows * self.seq_len
        my_ary[:] = self._tokens[shard * n:(shard + 1) * n].reshape(
            self.rows, self.seq_len)
        self.it += 1

    def adopt_shards(self, ranges, **kw):
        self.ranges = tuple(tuple(r) for r in ranges)


def _ladder_act(leg, rec, elastic, ha, window):
    """The leg's action after ``window`` windows (its step done and
    marked); returns the fault plan it armed, if any."""
    from ddl_tpu_torch import faults
    from ddl_tpu_torch.faults import FaultKind, FaultPlan, FaultSpec

    c = CLUSTER
    if leg == "autoscale":
        if window in (AUTOSCALE["up_at"], AUTOSCALE["down_at"]):
            high = window == AUTOSCALE["up_at"]
            rec["signal"]["stall_fraction"] = 0.9 if high else 0.0
            rec["t_up" if high else "t_down"] = time.monotonic()
            rec["steps"].append(rec["scaler"].step())
        return None
    if leg == "drain" and window == c["rejoin_at"]:
        rec["t_rejoin"] = time.monotonic()
        elastic.rejoin_host(rec.pop("parked"))
        return None
    if window != c["act_at"]:
        return None
    rec["t_act"] = time.monotonic()
    if leg in ("thread", "process"):
        elastic.kill_host(1)
    elif leg == "drain":
        rec["parked"] = elastic.drain_host(1)
    elif leg == "lease":
        # Host 1's beats are lost from here on: the consumer waits at this
        # boundary while host 1's producer lives on, parked on its ring,
        # until the lease lapses into the view change.
        plan = FaultPlan([FaultSpec("cluster.heartbeat",
                                    FaultKind.HEARTBEAT_DROP, producer_idx=1,
                                    count=10 ** 9)])
        faults.arm(plan)
        elastic.supervisor.wait_for_epoch(1, timeout_s=c["lease_s"] + 30.0)
        return plan
    elif leg == "failover":
        # The leader dies at its next step; once the standby took over,
        # the promoted leader handles the host kill.
        plan = FaultPlan([FaultSpec("cluster.supervise",
                                    FaultKind.SUPERVISOR_CRASH)])
        faults.arm(plan)
        deadline = time.monotonic() + 30.0
        while ha.promotions < 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        rec["t_promoted"] = time.monotonic()
        # The HA step renews the lease after each sweep of the leader: the
        # crashed leader's last sweep set the deadline that lapsed.
        rec["lease_expiry"] = rec["sweeps"][-1] + ha.lease_s
        rec["crash_to_promotion_s"] = rec["t_promoted"] - rec["t_act"]
        faults.arm(None)
        rec["t_act"] = time.monotonic()
        elastic.kill_host(1)
        return plan
    return None


def _ladder_fit(leg, mode, cfg, host_params, token_file, shards, n_windows,
                journal=None, sequence=None):
    """One fit of phase 15: ``DistributedDataLoader(..., cluster=elastic)
    .windows()`` into the port's multistep over the two mock hosts, leg
    ``leg`` acting at the window boundary; or, with ``sequence``, the
    replay control: one producer serving that shard order, no cluster.
    The flash launch counts are set to 0 just before the stream and read
    just after.  Returns the fit's record."""
    import numpy as np
    import torch

    from ddl_tpu_torch import DistributedDataLoader, Marker, distributed_dataloader
    from ddl_tpu_torch import cluster as cl
    from ddl_tpu_torch import faults
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.ops import host_register
    from ddl_tpu_torch.parallel.train import adamw, make_multistep
    from ddl_tpu_torch.watchdog import Watchdog

    c, tr = CLUSTER, TRAIN
    m = Metrics()
    control = sequence is not None
    scale = leg == "autoscale"
    producer = ShardTokenProducer(
        token_file, tr["seq_len"], tr["window_rows"],
        ranges_by_producer=(AUTOSCALE["ranges"] if scale
                            else {1: ((0, 2),), 2: ((2, 4),)}),
        sequence=sequence)
    init_fn, multi = make_multistep(
        lambda p, b: llama.next_token_loss(p, b[0], cfg), adamw(1e-5),
        "cuda", n_steps=tr["window_rows"] // tr["batch_size"])
    rec = {"leg": leg, "mode": mode, "losses": [], "shards": [],
           "producers": [], "t_yield": [], "beats": {}, "changes": [],
           "sweeps": []}
    # THREAD producers count into the process-wide registry.
    adoptions0 = default_metrics().counter("producer.shard_adoptions")
    unlocked = []
    real_unlock = host_register.page_unlock

    def unlock(ring):
        unlocked.append(ring)
        real_unlock(ring)

    @distributed_dataloader(
        n_producers=1 if control else (3 if scale else 2), mode=mode)
    def run(env):
        sup = elastic = ha = wd = plan = None
        if not control:
            view = cl.ClusterView.bootstrap(
                [cl.HostInfo(0, loader_ranks=(1,), trainer_ranks=(0,)),
                 cl.HostInfo(1, loader_ranks=(2,))],
                n_shards=AUTOSCALE["n_shards"] if scale else c["n_shards"])
            kw = dict(lease_s=c["lease_s"] if leg == "lease" else 60.0,
                      poll_interval_s=c["poll_s"], metrics=m)
            sup = (cl.JournaledSupervisor(view, journal=journal, **kw)
                   if leg == "failover" else cl.ClusterSupervisor(view, **kw))
            # Every lease starts at registration; beats renew it.
            rec["beats"] = {h.host_id: time.monotonic() for h in view.hosts}
            beat = sup.leases.beat

            def timed_beat(host_id, now=None):
                rec["beats"][host_id] = time.monotonic()
                beat(host_id, now)

            sup.leases.beat = timed_beat
            sup.add_listener(lambda old, new, dead: rec["changes"].append(
                time.monotonic()))
            elastic = cl.ElasticCluster(sup, workers=env.workers, metrics=m)
            if scale:
                # Phase 16 (d): host 2 (producer 3, its own shards) stands
                # by outside the view; the policy acts on the first step
                # its injected signal crosses a threshold.
                from ddl_tpu_torch.serve import Autoscaler, AutoscalerPolicy

                rec["signal"] = {"stall_fraction": 0.0, "queue_depth": 0.0}
                rec["scaler"] = Autoscaler(
                    elastic, standby=[cl.HostInfo(2, loader_ranks=(3,))],
                    policy=AutoscalerPolicy(sustain_s=0.0, cooldown_s=0.0),
                    metrics=m, signal=lambda: dict(rec["signal"]))
                rec["steps"] = []
            if leg == "failover":
                sweep = sup.sweep

                def timed_sweep(now=None):
                    out = sweep(now)
                    rec["sweeps"].append(time.monotonic() if now is None
                                         else now)
                    return out

                sup.sweep = timed_sweep
                ha = cl.SupervisorHA(sup, elastic=elastic,
                                     lease_s=c["ha_lease_s"], standbys=1,
                                     metrics=m).start()
        loader = DistributedDataLoader(
            producer, batch_size=tr["batch_size"], connection=env.connection,
            n_epochs=n_windows, output="device", device="cuda", metrics=m,
            cluster=elastic)
        if not control:
            # The failover leg's HA tier sweeps whichever supervisor leads;
            # the others' watchdog sweeps theirs.
            wd = Watchdog(env.workers, poll_interval_s=c["poll_s"],
                          stall_budget_s=60.0, respawn=True, metrics=m,
                          cluster=None if leg == "failover" else sup).start()
        state = init_fn(host_params)
        try:
            fa.reset_launch_counts()
            for i, win in enumerate(loader.windows()):
                rec["t_yield"].append(time.monotonic())
                host = win.cpu().numpy().reshape(tr["window_rows"], -1)
                rec["shards"].append(next(
                    (s for s, ref in enumerate(shards)
                     if np.array_equal(host, ref)), -1))
                rec["producers"].append(loader.last_window_key()[0])
                state, losses = multi(state, (win,), per_step=True)
                rec["losses"].extend(float(x) for x in losses.tolist())
                loader.mark(Marker.END_OF_EPOCH)
                if not control:
                    plan = _ladder_act(leg, rec, elastic, ha, i + 1) or plan
            torch.cuda.synchronize()
            rec["launches"] = {fn.__name__: fn.launches for fn in fa.KERNELS}
            rec["sm90_launches"] = {fn.__name__: fn.sm90_launches
                                    for fn in fa.KERNELS}
        finally:
            faults.arm(None)
            if wd is not None:
                wd.stop()
            if ha is not None:
                ha.stop()
            loader.shutdown()  # a no-op after the last window's mark
        if sup is not None:
            leader = sup if ha is None else ha.leader
            rec["epoch"] = leader.view.epoch
            rec["lost"] = sorted(leader.lost_ranks())
        if ha is not None:
            rec["term"] = cl.replay_journal(journal).term
            rec["takeover_s"] = ha.last_takeover_s
        rec["plan_fired"] = bool(plan is not None and plan.fired)
        rec["rings"] = len(env.connection.rings)
        return env

    # The loader unlocks its rings at shutdown, at the last window's
    # mark: count every unlock of the run.
    host_register.page_unlock = unlock
    try:
        env = run()
    finally:
        host_register.page_unlock = real_unlock
    rec["exitcodes"] = list(env.workers.exitcodes)
    rec["registered"] = m.counter("ingest.registered_rings")
    rec["unlocked"] = len(unlocked)
    rec["counters"] = {k: m.counter(k) for k in (
        "cluster.view_changes", "cluster.host_losses", "cluster.host_drains",
        "cluster.rejoins", "cluster.heartbeats_dropped",
        "cluster.shard_adoptions", "cluster.promotions",
        "cluster.supervisor_crashes", "consumer.pool_updates",
        "serve.scale_ups", "serve.scale_downs",
        "watchdog.failures", "watchdog.respawns", "consumer.windows",
        "staging.alias_windows", "staging.alias_fallbacks",
        "staging.inline_fallbacks", "staging.pool_alias_drops",
        "integrity.corrupt_windows")}
    # A PROCESS producer's count reaches this registry in its ObsReports.
    rec["counters"]["producer.shard_adoptions"] = (
        m.counter("producer.0.producer.shard_adoptions") if mode == "process"
        else default_metrics().counter("producer.shard_adoptions")
        - adoptions0)
    return rec


def _steady_ms(t_yield, lo, hi, spw=None):
    """Mean ms/step over the yields ``lo .. hi`` (a window's steps lie
    between its yield and the next; ``spw`` steps a window, the token
    cell's by default)."""
    spw = spw or TRAIN["window_rows"] // TRAIN["batch_size"]
    gaps = [t_yield[i + 1] - t_yield[i] for i in range(lo, hi - 1)]
    return 1e3 * sum(gaps) / len(gaps) / spw if gaps else float("nan")


def _ladder_device_gates(rec, ctrl, cfg, faults):
    """K1-K3 once a layer a step on the wgmma route (the leg and its
    control); every window on the staged alias route; a PROCESS leg's
    rings registered and unregistered."""
    leg, c, n = rec["leg"], rec["counters"], len(rec["shards"])
    want = cfg.n_layers * n * TRAIN["window_rows"] // TRAIN["batch_size"]
    for r in (rec, ctrl):
        if not all(r["launches"][fn] == r["sm90_launches"][fn] == want
                   for fn in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
            faults.append(f"{r['leg']}: K1-K3 launches {r['launches']} / "
                          f"{r['sm90_launches']}, want {want} on wgmma")
    if not (c["staging.alias_windows"] == n
            and c["staging.alias_fallbacks"] == c["staging.inline_fallbacks"]
            == c["staging.pool_alias_drops"] == 0):
        faults.append(f"{leg}: staging counters {c}")
    # A PROCESS leg's shared-memory rings are page-locked at attach and
    # unlocked once each at teardown, the terminated producer's too.
    if leg == "process" and not (rec["registered"] == rec["rings"]
                                 == rec["unlocked"] == 2):
        faults.append(f"process: rings {rec['rings']}, registered "
                      f"{rec['registered']}, unlocked {rec['unlocked']}")


def _ladder_gates(rec, ctrl, faults):
    """Phase 15's stream, counter and loss gates for one leg against its
    replay control.  Appends to ``faults``."""
    c, leg = CLUSTER, rec["leg"]
    k, n = rec["counters"], len(rec["shards"])
    if -1 in rec["shards"] or sorted(set(rec["shards"])) != list(
            range(c["n_shards"])):
        faults.append(f"{leg}: shards served {rec['shards']}")
    split = c["act_at"]
    end = c["rejoin_at"] if leg == "drain" else n
    after = {s for s, p in zip(rec["shards"][split:end],
                               rec["producers"][split:end]) if p == 1}
    if not after & {2, 3}:
        faults.append(f"{leg}: producer 1 served {sorted(after)} after the "
                      f"change ({rec['shards']} from {rec['producers']})")
    if rec["losses"] != ctrl["losses"] or len(ctrl["shards"]) != n:
        faults.append(f"{leg}: losses {rec['losses']} != the replay "
                      f"control's {ctrl['losses']}")
    if not (k["consumer.windows"] == n and k["consumer.pool_updates"] >= 1
            and k["producer.shard_adoptions"] >= 1
            and k["cluster.shard_adoptions"] >= 1
            and k["watchdog.failures"] == k["watchdog.respawns"] == 0
            and k["integrity.corrupt_windows"] == 0):
        faults.append(f"{leg}: ladder counters {k}")
    if leg == "drain":
        back = rec["producers"][c["rejoin_at"]:]
        if not (k["cluster.host_drains"] == k["cluster.rejoins"] == 1
                and k["cluster.host_losses"] == 0 and 2 in back
                and rec["epoch"] == 2 and rec["lost"] == []):
            faults.append(f"drain: {k}, producers after the rejoin {back}, "
                          f"epoch {rec['epoch']}")
    elif not (k["cluster.view_changes"] == k["cluster.host_losses"] == 1
              and rec["epoch"] == 1 and rec["lost"] == [2]):
        faults.append(f"{leg}: view {k}, epoch {rec['epoch']}, lost "
                      f"{rec['lost']}")
    if leg == "lease":
        lapse = (rec["changes"][0] - rec["beats"][1] if rec["changes"]
                 else float("nan"))
        if not (rec["plan_fired"] and k["cluster.heartbeats_dropped"] >= 1
                and lapse >= c["lease_s"]):
            faults.append(f"lease: no lapsed lease (beat to change "
                          f"{lapse} s, {k})")
    if leg == "failover" and not (
            rec["term"] == 2 and rec["plan_fired"]
            and k["cluster.promotions"] == k["cluster.supervisor_crashes"]
            == 1):
        faults.append(f"failover: term {rec.get('term')}, {k}")
    if leg == "process" and not (rec["exitcodes"][0] == 0
                                 and rec["exitcodes"][1] != 0):
        faults.append(f"process: exit codes {rec['exitcodes']}")


def cluster_chaos_child(rank, port, out):
    """One process of phase 15 (f): the ``chaos`` leg of the port's
    MULTIHOST program (``tests/torch_multihost_prog.py``) in a gloo group
    of 2 on cuda:0; its report goes to ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_multihost_prog as prog

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)

    def record(name, **arrays):
        np.savez(os.path.join(out, f"{name}_{rank}.npz"), **arrays)

    report = prog.run_chaos_leg(rank, 2, record, device="cuda")
    with open(os.path.join(out, f"chaos_{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    log(f"CHAOS OK process={rank}")


def cluster_chaos(tmpdir, card):
    """(f) Two gloo processes on cuda:0 run the chaos leg.  Gates: every
    shard served in both; in process 1 one respawn and one host loss;
    no watchdog failure."""
    import socket

    out = os.path.join(tmpdir, "chaos")
    os.makedirs(out, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    logs = [open(os.path.join(out, f"child_{i}.log"), "w") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cluster-child",
         str(i), str(port), out], stdout=logs[i], stderr=subprocess.STDOUT,
        cwd=ROOT) for i in range(2)]
    try:
        for p in procs:
            p.wait(timeout=CLUSTER["chaos_timeout_s"])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait(timeout=60)
    for f in logs:
        f.close()
    wall = time.perf_counter() - t0
    texts = [open(os.path.join(out, f"child_{i}.log")).read()
             for i in range(2)]
    if any(p.returncode != 0 for p in procs) or not all(
            f"CHAOS OK process={i}" in t for i, t in enumerate(texts)):
        for i, t in enumerate(texts):
            log(f"[cluster] chaos child {i} rc {procs[i].returncode}, last "
                "lines:\n" + "\n".join(t.splitlines()[-40:]))
        raise PhaseFailed("[cluster] the chaos processes failed")
    reports = [json.load(open(os.path.join(out, f"chaos_{i}.json")))
               for i in range(2)]
    faults = []
    for i, r in enumerate(reports):
        log(f"[cluster] (f) process {i}: shards {r['shards']} x "
            f"{r['counts']}, view epoch {r['epoch']}, lost {r['lost']}, "
            f"respawns {r['watchdog.respawns']}, failures "
            f"{r['watchdog.failures']}, host losses "
            f"{r['cluster.host_losses']}; gloo all_reduce of a cuda tensor "
            f"{r['reduce_ms']:.3f} ms a window ({card})")
        if (r["shards"] != list(range(CLUSTER["n_shards"]))
                or r["watchdog.failures"] != 0):
            faults.append(f"process {i}: {r}")
    r1 = reports[1]
    if not (r1["watchdog.respawns"] == 1 and r1["cluster.host_losses"] == 1
            and r1["epoch"] == 1 and r1["lost"] == [2]):
        faults.append(f"process 1's rungs: {r1}")
    if faults:
        raise PhaseFailed("[cluster] (f) chaos: " + "; ".join(faults))
    log(f"[cluster] (f) two processes on cuda:0 in {wall:.1f} s ({card})")
    return {"wall_s": wall, "reports": reports}


def phase_cluster(tmpdir, card):
    """Phase 15, the cluster ladder: legs (a)-(e) on phase 6's token cell
    over two mock hosts, each against its replay control, then (f) the
    MULTIHOST chaos leg.  Returns the summary (``launches``: each flash
    kernel's launches summed over the five legs' fits, not the
    controls')."""
    import numpy as np

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.parallel.train import tree_map

    t0 = time.perf_counter()
    c, tr = CLUSTER, TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    token_file = _token_file(tmpdir)
    n = tr["window_rows"] * tr["seq_len"]
    tokens = np.fromfile(token_file, np.int32, count=c["n_shards"] * n)
    shards = [tokens[s * n:(s + 1) * n].reshape(tr["window_rows"], -1)
              for s in range(c["n_shards"])]
    # The seed-0 weights, kept on the host: every fit starts from them.
    host_params = tree_map(lambda t: t.detach().cpu(),
                           llama.init_params(cfg, seed=SEED, device="cuda"))
    free_device_memory()
    log(f"[cluster] {llama.param_count(cfg) / 1e9:.3f} B params, "
        f"{c['n_shards']} shards of {tr['window_rows']} x {tr['seq_len']} "
        f"tokens over two mock hosts ({card})")
    faults, summary = [], {"legs": {}, "launches": {}}
    for letter, leg in zip("abcde", LADDER_LEGS):
        n_windows = c["drain_windows"] if leg == "drain" else c["windows"]
        rec = _ladder_fit(leg, "process" if leg == "process" else "thread",
                          cfg, host_params, token_file, shards, n_windows,
                          journal=os.path.join(tmpdir, f"journal-{leg}.bin"))
        ctrl = _ladder_fit(f"{leg}-control", "thread", cfg, host_params,
                           token_file, shards, n_windows,
                           sequence=rec["shards"])
        free_device_memory()
        _ladder_gates(rec, ctrl, faults)
        _ladder_device_gates(rec, ctrl, cfg, faults)
        for name, n_launch in rec["launches"].items():
            summary["launches"][name] = (summary["launches"].get(name, 0)
                                         + n_launch)
        act = c["act_at"]
        ty = rec["t_yield"]
        # The window after the act may be one the departed host committed
        # before it (acquired ahead): the survivor's first comes after.
        first = next(i for i in range(act, len(ty))
                     if rec["producers"][i] == 1)
        out = {
            "shards": rec["shards"], "producers": rec["producers"],
            "losses": rec["losses"],
            "bit_equal_to_control": rec["losses"] == ctrl["losses"],
            "counters": rec["counters"], "epoch": rec["epoch"],
            "act_to_next_window_ms": 1e3 * (ty[act] - rec["t_act"]),
            "act_to_first_survivor_window_ms": 1e3 * (ty[first]
                                                      - rec["t_act"]),
            # One window before the act (window 0 holds the first step's
            # warm-up): held against the control's same window.
            "steady_ms_before": _steady_ms(ty, 1, act),
            "control_steady_ms_before": _steady_ms(ctrl["t_yield"], 1, act),
            "steady_ms_after": _steady_ms(
                ty, act + 1, c["rejoin_at"] if leg == "drain" else len(ty)),
            "control_steady_ms": _steady_ms(ctrl["t_yield"], 1,
                                            len(ctrl["t_yield"])),
        }
        if leg == "lease":
            out["beat_to_view_change_s"] = rec["changes"][0] - rec["beats"][1]
            out["change_to_next_window_ms"] = 1e3 * (ty[act]
                                                     - rec["changes"][0])
            log(f"[cluster] (c) lease: host 1's last beat to the view change "
                f"{out['beat_to_view_change_s']:.3f} s against lease_s "
                f"{c['lease_s']} (polls every {c['poll_s']} s); the change to "
                f"the next window {out['change_to_next_window_ms']:.1f} ms "
                f"({card})")
        if leg == "drain":
            out["rejoin_to_next_window_ms"] = 1e3 * (
                ty[c["rejoin_at"]] - rec["t_rejoin"])
        if leg == "failover":
            out["crash_to_promotion_s"] = rec["crash_to_promotion_s"]
            out["lease_overshoot_s"] = rec["t_promoted"] - rec["lease_expiry"]
            out["takeover_s"] = rec["takeover_s"]
            log(f"[cluster] (e) failover: the crash to the promoted leader "
                f"{out['crash_to_promotion_s'] * 1e3:.1f} ms wall, "
                f"{out['lease_overshoot_s'] * 1e3:.1f} ms past the lapse of "
                f"the {c['ha_lease_s']} s lease (the replay and rebuild "
                f"{rec['takeover_s'] * 1e3:.2f} ms), journal term "
                f"{rec['term']} ({card})")
        if leg == "process":
            out["exitcodes"] = rec["exitcodes"]
        log(f"[cluster] ({letter}) {leg}: shards {rec['shards']} from "
            f"producers {rec['producers']}; the act to the next window "
            f"{out['act_to_next_window_ms']:.1f} ms, to the first survivor "
            f"window {out['act_to_first_survivor_window_ms']:.1f} ms; steady "
            f"{out['steady_ms_before']:.1f} ms/step in the one window before "
            f"the change (the control's same window "
            f"{out['control_steady_ms_before']:.1f}), "
            f"{out['steady_ms_after']:.1f} after (the control "
            f"{out['control_steady_ms']:.1f} over all windows); losses "
            f"{'bit-equal to' if out['bit_equal_to_control'] else 'NOT'} "
            f"the replay control's ({card})")
        log(f"[cluster] ({letter}) {leg}: counters "
            f"{json.dumps(rec['counters'])}")
        summary["legs"][leg] = out
    if faults:
        raise PhaseFailed("[cluster] the ladder failed its checks: "
                          + "; ".join(faults))
    summary["chaos"] = cluster_chaos(tmpdir, card)
    summary["phase_s"] = time.perf_counter() - t0
    log(f"[cluster] phase 15 took {summary['phase_s']:.1f} s ({card})")
    return summary


# ------------------------------------------------------------ phase 16 ---

#: Phase 16, the serving fabric.  (a)-(c): job A is phase 6's token cell
#: (``TRAIN``, 2 steps a window), weight 2; job B phase 14's ViT-B/16 fit
#: (``VIT``), weight 1, its byte budget ``b_budget_share`` of its solo
#: control's served rate.  The leader dies after A's window
#: ``kill_after``; B's grant ``crash_at`` (its window 7) dies by JOB_CRASH.
SERVE = dict(a_windows=10, b_windows=10, kill_after=4, crash_at=7,
             a_weight=2.0, b_weight=1.0, b_budget_share=0.5, ha_lease_s=0.3,
             poll_s=0.05, promote_timeout_s=30.0, switch_timeout_s=60.0)
#: (d): the ladder's token cell over hosts 0 and 1 and a standby host 2
#: (producer 3) over 6 shards; the signal goes high after window
#: ``up_at`` and low after ``down_at``.  Each producer starts on the
#: ranges the view gives its host (host 2's once it joins).
AUTOSCALE = dict(n_shards=6, windows=12, up_at=3, down_at=7,
                 ranges={1: ((0, 3),), 2: ((3, 6),), 3: ((4, 6),)})


def _job_fit(tag, producer, loss_fn, host_params, geometry, n_windows,
             admission=None, hook=None, lookahead=1, config=None,
             metrics=None, optimizer=None, count=True):
    """One job of phases 16-17: ``DistributedDataLoader(...).windows()``
    into the port's multistep from ``host_params`` (phase 15's loop:
    ``Trainer.fit`` builds its loader inside, and neither package's has
    an admission seam), THREAD producers, one window an epoch.
    ``admission`` (a ``FabricJob``) is bound with ``bind(loader)``;
    ``hook(window, loader)`` runs after each window's steps; ``config``
    (a ``LoaderConfig``) goes to ``distributed_dataloader``.  With
    ``count`` the flash launch counts are set to 0 just before the stream
    and read just after.  An exception of the stream is recorded in
    ``rec["error"]``, not raised."""
    import torch

    from ddl_tpu_torch import DistributedDataLoader, Marker, distributed_dataloader
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.train import adamw, make_multistep
    from ddl_tpu_torch.trainer import _stream_splits, _window_cols

    g = geometry
    m = metrics if metrics is not None else Metrics()
    steps = g["window_rows"] // g["batch_size"]
    init_fn, multi = make_multistep(loss_fn, optimizer or adamw(1e-5), "cuda",
                                    n_steps=steps)
    rec = {"tag": tag, "losses": [], "t_yield": [], "keys": [],
           "error": None, "metrics": m, "steps_per_window": steps}

    @distributed_dataloader(n_producers=g["n_producers"], mode="thread",
                            config=config)
    def run(env):
        loader = DistributedDataLoader(
            producer, batch_size=g["batch_size"], connection=env.connection,
            n_epochs=n_windows, output="device", device="cuda", metrics=m)
        if admission is not None:
            admission.bind(loader)
        state = init_fn(host_params)
        splits = _stream_splits(loader)
        rec["t0"] = time.monotonic()
        try:
            if count:
                fa.reset_launch_counts()
            for i, win in enumerate(loader.windows(lookahead=lookahead)):
                rec["t_yield"].append(time.monotonic())
                rec["keys"].append(loader.last_window_key())
                state, losses = multi(state, _window_cols(win, splits),
                                      per_step=True)
                rec["losses"].extend(float(x) for x in losses.tolist())
                loader.mark(Marker.END_OF_EPOCH)
                if hook is not None:
                    hook(i + 1, loader)
            torch.cuda.synchronize()
            if count:
                rec["launches"] = {fn.__name__: fn.launches
                                   for fn in fa.KERNELS}
                rec["sm90_launches"] = {fn.__name__: fn.sm90_launches
                                        for fn in fa.KERNELS}
        except Exception as e:  # the phase gates the type
            rec["error"] = e
        finally:
            rec["t_end"] = time.monotonic()
            loader.shutdown()

    run()
    return rec


def _job_ms(rec):
    """A job record's steady ms/step (window 0 holds the warm-up)."""
    return _steady_ms(rec["t_yield"], 1, len(rec["t_yield"]),
                      rec["steps_per_window"])


class _FabricGate:
    """The switch between the jobs' fabric clients and the fabric that
    leads.  An RPC enters unless a switch is under way; a switch waits
    out the RPCs in flight (a blocked admit ends within its budget wait),
    so no decision reaches the dead authority after the journal its
    successor is rebuilt from was read."""

    def __init__(self):
        self._cv = threading.Condition()
        self._inflight = 0
        self._switching = False

    @contextlib.contextmanager
    def rpc(self):
        with self._cv:
            while self._switching:
                self._cv.wait(0.05)
            self._inflight += 1
        try:
            yield
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def switch(self, rebuild, timeout_s):
        deadline = time.monotonic() + timeout_s
        with self._cv:
            self._switching = True
            while self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._switching = False
                    self._cv.notify_all()
                    raise PhaseFailed("[serve] RPCs still in flight at the "
                                      "fabric switch")
                self._cv.wait(min(0.05, left))
        try:
            return rebuild()
        finally:
            with self._cv:
                self._switching = False
                self._cv.notify_all()


def _gated_client_class():
    """A loopback ``FabricClient`` whose every RPC passes a
    :class:`_FabricGate`; it keeps its last admission envelope (the one
    re-sent after the failover) and times its crash report."""
    from ddl_tpu_torch.serve.fabric import AdmitRequest, FabricClient

    class GatedClient(FabricClient):
        def __init__(self, fabric, client_id, gate, **kw):
            super().__init__(fabric, client_id, **kw)
            self.gate = gate
            self.last_admit = None
            self.crash_report_s = None

        def _rpc(self, payload):
            with self.gate.rpc():
                return super()._rpc(payload)

        def _raw_send(self, env):
            if isinstance(env.payload, AdmitRequest):
                self.last_admit = env
            super()._raw_send(env)

        def report_crash(self, job_id):
            t0 = time.perf_counter()
            super().report_crash(job_id)
            self.crash_report_s = time.perf_counter() - t0

    return GatedClient


def _same_ledger(rebuilt, journaled):
    """A rebuilt scheduler's export against the journaled snapshot it
    adopted: every field equal, the bucket stamps all shifted by one
    amount (``adopt_state`` ages them by its clock's gap since the
    export)."""
    ta, tb = rebuilt["tenants"], journaled["tenants"]
    rest = [k for k in journaled if k not in ("tenants", "now")]
    if set(ta) != set(tb) or any(rebuilt[k] != journaled[k] for k in rest):
        return False
    shifts = [ta[n]["stamp"] - tb[n]["stamp"] for n in ta]
    same = all(dict(ta[n], stamp=0) == dict(tb[n], stamp=0) for n in ta)
    return same and (max(shifts, default=0) - min(shifts, default=0)) < 1e-6


def _journal_audit(journal):
    """Per job, from the fabric's journaled decisions: granted admits,
    served and aborted notes, and the grants a crash released."""
    from ddl_tpu_torch.cluster import replay_journal

    audit = {}
    for r in replay_journal(journal).admissions:
        a = audit.setdefault(r["job"], dict(admits=0, served=0, aborted=0,
                                            crash_revoked=0))
        if not r["reply"]["ok"]:
            continue
        if r["op"] == "admit":
            a["admits"] += 1
        elif r["op"] in ("served", "aborted"):
            a[r["op"]] += 1
        elif r["op"] == "crash":
            a["crash_revoked"] += int(r["reply"]["value"]["revoked_inflight"])
    return audit


def serve_jobs(tmpdir, card):
    """(a)-(c): two jobs through one ``IngestFabric`` beside a journaled
    supervisor under ``SupervisorHA``, each against its solo control;
    the leader's crash and the fabric's rebuild mid-run; job B's crash."""
    import torch

    from ddl_tpu_torch import faults
    from ddl_tpu_torch.cluster import (
        ClusterView, HostInfo, JournaledSupervisor, SupervisorHA,
        replay_journal,
    )
    from ddl_tpu_torch.exceptions import JobCrashed
    from ddl_tpu_torch.faults import FaultKind, FaultPlan, FaultSpec
    from ddl_tpu_torch.models import llama, vit
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import FileShardProducer, TokenStreamProducer
    from ddl_tpu_torch.serve import IngestFabric, JobSpec

    S, tr = SERVE, TRAIN
    cfg_a = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                n_layers=tr["n_layers"])
    cfg_b = _vit_b16()
    px = cfg_b.image_size ** 2 * cfg_b.n_channels
    token_file = _token_file(tmpdir)
    vit_pattern = _vit_shards(tmpdir, cfg_b)
    host_a = _host_params(llama.init_params, cfg_a)
    host_b = _host_params(vit.init_params, cfg_b)

    def prod_a():
        return TokenStreamProducer(token_file, tr["seq_len"],
                                   tr["window_rows"], seed=SEED)

    def prod_b():
        return FileShardProducer(vit_pattern, splits=(px, 1), seed=SEED)

    def loss_a(p, b):
        return llama.next_token_loss(p, b[0], cfg_a)

    def loss_b(p, b):
        return vit.classification_loss(p, b, cfg_b)

    faults_ = []
    # The solo controls: the same fits from the same weights, alone, with
    # no fabric.
    solo_a = _job_fit("A solo", prod_a(), loss_a, host_a, tr, S["a_windows"])
    free_device_memory()
    solo_b = _job_fit("B solo", prod_b(), loss_b, host_b, VIT, S["b_windows"],
                      optimizer=adamw(1e-4))
    free_device_memory()
    for r in (solo_a, solo_b):
        if r["error"] is not None:
            raise PhaseFailed(f"[serve] {r['tag']}: {r['error']!r}")
    window_b = VIT["window_rows"] * (px + 1) * 4
    solo_b_rate = window_b * S["b_windows"] / (solo_b["t_end"] - solo_b["t0"])
    budget = S["b_budget_share"] * solo_b_rate
    log(f"[serve] solo controls: A {_job_ms(solo_a):.1f} ms/step steady, "
        f"B {_job_ms(solo_b):.1f} ms/step, B served "
        f"{solo_b_rate / 2**20:.1f} MiB/s -> B's budget "
        f"{budget / 2**20:.1f} MiB/s ({card})")

    # The fabric beside a journaled supervisor under the HA tier.
    journal = os.path.join(tmpdir, "serve-journal.bin")
    mc, mf = Metrics(), Metrics()
    view = ClusterView.bootstrap(
        [HostInfo(0, loader_ranks=(1,), trainer_ranks=(0,)),
         HostInfo(1, loader_ranks=(2,))], n_shards=4)
    sup = JournaledSupervisor(view, journal=journal, lease_s=60.0,
                              poll_interval_s=S["poll_s"], metrics=mc)
    ha = SupervisorHA(sup, lease_s=S["ha_lease_s"], standbys=1,
                      metrics=mc).start()
    fab = IngestFabric(journal=sup.journal, metrics=mf, snapshot_every=1)
    gate = _FabricGate()
    client_cls = _gated_client_class()
    ca = client_cls(fab, "host-a", gate, metrics=mf)
    cb = client_cls(fab, "host-b", gate, metrics=mf)
    job_a = ca.register_job(JobSpec("llama", weight=S["a_weight"]))
    t_reg_b = time.monotonic()
    job_b = cb.register_job(JobSpec("vit", weight=S["b_weight"],
                                    byte_budget_per_s=budget))
    pa, pb = prod_a(), prod_b()
    # Each job's producers stamp its integrity namespace.
    pa.seq_base, pb.seq_base = job_a.seq_base, job_b.seq_base
    plan = FaultPlan([FaultSpec("serve.fabric.grant", FaultKind.JOB_CRASH,
                                at=S["crash_at"], producer_idx=job_b.index)])
    fo = {}

    def failover(window, loader):
        """(b) after A's window ``kill_after``: the leader dies, the
        standby is promoted, the fabric is rebuilt from the journal and
        the clients rebound; then one pre-kill admission envelope is sent
        again."""
        if window != S["kill_after"]:
            return
        fo["t_kill"] = time.monotonic()
        with plan._lock:
            plan.specs.append(FaultSpec("cluster.supervise",
                                        FaultKind.SUPERVISOR_CRASH))
        deadline = time.monotonic() + S["promote_timeout_s"]
        while ha.promotions < 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        fo["t_promoted"] = time.monotonic()

        def rebuild():
            fo["dead"] = replay_journal(journal)
            t0 = time.perf_counter()
            fab2 = IngestFabric.from_journal(journal, metrics=mf,
                                             snapshot_every=1)
            fo["rebuild_ms"] = (time.perf_counter() - t0) * 1e3
            fo["t_rebuilt"] = time.monotonic()
            for c in (ca, cb):
                c.rebind(fab2)
                c.set_fence(fab2.term)
            fo["rebuilt"] = fab2.scheduler.export_state()
            # The re-sent envelope: client A's last admission before the
            # kill, under the successor's fence (a retry).
            env = dataclasses.replace(ca.last_admit, fence=fab2.term)
            now = time.monotonic()
            before = fab2.scheduler.export_state(now=now)
            reply, ack = fab2.handle("host-a", env)
            fo["resend"] = dict(
                dup=bool(ack.dup), reply=reply.to_dict(),
                journaled=next(r["reply"] for r in fo["dead"].admissions
                               if r["client"] == "host-a"
                               and r["seq"] == env.seq
                               and r["incarnation"] == env.incarnation),
                same_ledger=fab2.scheduler.export_state(now=now) == before)
            return fab2

        fo["fab2"] = gate.switch(rebuild, S["switch_timeout_s"])

    recs = {}

    def run_b():
        recs["b"] = _job_fit("B", pb, loss_b, host_b, VIT, S["b_windows"],
                             admission=job_b, optimizer=adamw(1e-4),
                             count=False)

    faults.arm(plan)
    try:
        fa.reset_launch_counts()
        tb = threading.Thread(target=run_b, name="serve-job-b")
        tb.start()
        rec_a = _job_fit("A", pa, loss_a, host_a, tr, S["a_windows"],
                         admission=job_a, hook=failover, count=False)
        tb.join(600)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in fa.KERNELS}
        sm90 = {fn.__name__: fn.sm90_launches for fn in fa.KERNELS}
    finally:
        faults.arm(None)
        ha.stop()
    if tb.is_alive():
        raise PhaseFailed("[serve] job B did not finish")
    rec_b = recs["b"]
    fab2 = fo.get("fab2")
    free_device_memory()

    # -- gates ----------------------------------------------------------
    nb = len(rec_b["t_yield"])
    if rec_a["error"] is not None:
        faults_.append(f"job A raised {rec_a['error']!r}")
    if not isinstance(rec_b["error"], JobCrashed):
        faults_.append(f"job B raised {rec_b['error']!r}, not JobCrashed")
    if rec_a["losses"] != solo_a["losses"]:
        faults_.append(f"A's losses {rec_a['losses']} != solo "
                       f"{solo_a['losses']}")
    spw_b = VIT["window_rows"] // VIT["batch_size"]
    if not (nb >= 1 and rec_b["losses"] == solo_b["losses"][:nb * spw_b]):
        faults_.append(f"B's {nb} windows' losses {rec_b['losses']} != "
                       f"solo's prefix")
    wall_b = rec_b["t_end"] - t_reg_b
    b_bytes = mf.counter("ingest.vit.bytes")
    # The token bucket starts one second full; a grant may overshoot it
    # by one window (charge-after).
    bound = budget * (wall_b + 1.0) + window_b
    if b_bytes > bound:
        faults_.append(f"B served {b_bytes:.0f} B > bound {bound:.0f}")
    audit = _journal_audit(journal)
    n_admits = sum(a["admits"] for a in audit.values())
    for job, a in audit.items():
        if a["admits"] != a["served"] + a["aborted"] + a["crash_revoked"]:
            faults_.append(f"{job}: grants without their note {a}")
    if not (mf.counter("serve.admissions") == n_admits
            and mf.counter("ingest.llama.windows") == S["a_windows"]
            == len(rec_a["t_yield"])
            and audit.get("llama", {}).get("served") == S["a_windows"]
            and mf.counter("ingest.vit.windows")
            == audit.get("vit", {}).get("served")):
        faults_.append(f"admissions {mf.counter('serve.admissions')} vs "
                       f"journal {audit}")
    if fab2 is None or ha.promotions != 1:
        faults_.append(f"failover: promotions {ha.promotions}, {fo}")
    else:
        if not _same_ledger(fo["rebuilt"], fo["dead"].scheduler_state):
            faults_.append("the rebuilt ledger differs from the journal's")
        rs = fo["resend"]
        if not (rs["dup"] and rs["reply"] == rs["journaled"]
                and rs["same_ledger"]):
            faults_.append(f"the re-sent envelope: {rs}")
    crash_revoked = audit.get("vit", {}).get("crash_revoked", 0)
    if not (mf.counter("fabric.job_crashes") == 1 and crash_revoked >= 1):
        faults_.append(f"crash: job_crashes "
                       f"{mf.counter('fabric.job_crashes')}, revoked "
                       f"{crash_revoked}")
    want = (cfg_a.n_layers * S["a_windows"] * tr["window_rows"]
            // tr["batch_size"] + cfg_b.n_layers * nb * spw_b)
    if not all(launches[n] == sm90[n] == want for n in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        faults_.append(f"K1-K3 launches {launches} / {sm90}, want {want}")
    if any(launches[fn.__name__] for fn in fa.KERNELS[3:]):
        faults_.append(f"K4-K6 launched {launches}")

    def wait_q(job, q):
        return mf.quantile(f"ingest.{job}.admission_wait", q)

    out = {
        "a_ms_solo": _job_ms(solo_a),
        "a_ms_with_b": _steady_ms(rec_a["t_yield"], 1, nb + 1),
        "a_ms_after_b": _steady_ms(rec_a["t_yield"], nb + 1,
                                   len(rec_a["t_yield"])),
        "b_ms_solo": _job_ms(solo_b), "b_ms_with_a": _job_ms(rec_b),
        "b_budget_bytes_per_s": budget, "b_served_bytes": b_bytes,
        "b_wall_s": wall_b, "b_served_rate": b_bytes / wall_b,
        "b_bound_bytes": bound, "b_windows_trained": nb,
        "admission_wait_p50_s": {j: wait_q(j, 0.5) for j in ("llama", "vit")},
        "admission_wait_p99_s": {j: wait_q(j, 0.99)
                                 for j in ("llama", "vit")},
        "crash_to_promotion_ms": 1e3 * (fo.get("t_promoted", float("nan"))
                                        - fo.get("t_kill", float("nan"))),
        "rebuild_ms": fo.get("rebuild_ms"),
        "kill_to_rebuilt_ms": 1e3 * (fo.get("t_rebuilt", float("nan"))
                                     - fo.get("t_kill", float("nan"))),
        "crash_report_ms": (cb.crash_report_s or float("nan")) * 1e3,
        "journal_audit": audit, "launches": launches,
        "fabric": {k: mf.counter(k) for k in (
            "serve.admissions", "serve.rounds", "fabric.admissions",
            "fabric.dup_replies", "fabric.fence_drops", "fabric.job_crashes",
            "fabric.rebuilds", "fabric.scheduler_snapshots")},
        "term": fab2.term if fab2 is not None else None,
    }
    log(f"[serve] (a) A alone {out['a_ms_solo']:.1f} ms/step, with B running "
        f"{out['a_ms_with_b']:.1f}, after B {out['a_ms_after_b']:.1f}; B alone "
        f"{out['b_ms_solo']:.1f}, with A {out['b_ms_with_a']:.1f} ({card})")
    log(f"[serve] (a) B served {b_bytes / 2**20:.1f} MiB in {wall_b:.3f} s = "
        f"{out['b_served_rate'] / 2**20:.1f} MiB/s against its budget "
        f"{budget / 2**20:.1f} MiB/s (bound {bound / 2**20:.1f} MiB); "
        f"admission wait p50/p99: A {wait_q('llama', 0.5) * 1e3:.3f}/"
        f"{wait_q('llama', 0.99) * 1e3:.3f} ms, B "
        f"{wait_q('vit', 0.5) * 1e3:.3f}/{wait_q('vit', 0.99) * 1e3:.3f} ms "
        f"({card})")
    log(f"[serve] (b) the leader's crash to the promoted standby "
        f"{out['crash_to_promotion_ms']:.1f} ms, the fabric's rebuild from "
        f"the journal {out['rebuild_ms']} ms, the kill to the rebuilt "
        f"fabric {out['kill_to_rebuilt_ms']:.1f} ms, term {out['term']}; "
        f"re-sent envelope {fo.get('resend')} ({card})")
    log(f"[serve] (c) B crashed after {nb} windows with "
        f"{type(rec_b['error']).__name__}; the crash to the revocation (the "
        f"crash report's RPC) {out['crash_report_ms']:.3f} ms; journal "
        f"{json.dumps(audit)} ({card})")
    log(f"[serve] K1-K3 launches {launches} (want {want} = A's 2 layers x "
        f"{S['a_windows'] * 2} steps + B's {cfg_b.n_layers} layers x "
        f"{nb * spw_b} steps), wgmma {sm90}")
    log(f"[serve] fabric counters {json.dumps(out['fabric'])}")
    return faults_, out


def serve_autoscale(tmpdir, card):
    """(d) the autoscaler over the ladder's token cell, against a replay
    control."""
    import numpy as np

    from ddl_tpu_torch.models import llama

    A, tr = AUTOSCALE, TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    token_file = _token_file(tmpdir)
    n = tr["window_rows"] * tr["seq_len"]
    tokens = np.fromfile(token_file, np.int32, count=A["n_shards"] * n)
    shards = [tokens[s * n:(s + 1) * n].reshape(tr["window_rows"], -1)
              for s in range(A["n_shards"])]
    host_params = _host_params(llama.init_params, cfg)
    rec = _ladder_fit("autoscale", "thread", cfg, host_params, token_file,
                      shards, A["windows"])
    ctrl = _ladder_fit("autoscale-control", "thread", cfg, host_params,
                       token_file, shards, A["windows"],
                       sequence=rec["shards"])
    free_device_memory()
    faults_, k = [], rec["counters"]
    if rec["steps"] != ["up", "down"]:
        faults_.append(f"autoscaler steps {rec['steps']}")
    if not (k["serve.scale_ups"] == k["serve.scale_downs"] == 1
            and k["watchdog.failures"] == 0
            and k["integrity.corrupt_windows"] == 0):
        faults_.append(f"autoscaler counters {k}")
    if -1 in rec["shards"] or sorted(set(rec["shards"])) != list(
            range(A["n_shards"])):
        faults_.append(f"shards served {rec['shards']}")
    joined = [i for i in range(A["up_at"], len(rec["producers"]))
              if rec["producers"][i] == 3]
    equal = rec["losses"] == ctrl["losses"]
    if not joined or not equal:
        faults_.append(f"producer 3 served windows {joined}; losses "
                       f"{'equal' if equal else 'NOT equal'} to the replay "
                       "control's")
    _ladder_device_gates(rec, ctrl, cfg, faults_)
    ty = rec["t_yield"]
    out = {
        "shards": rec["shards"], "producers": rec["producers"],
        "steps": rec["steps"], "counters": k, "launches": rec["launches"],
        "signal_to_new_host_window_ms": (1e3 * (ty[joined[0]] - rec["t_up"])
                                         if joined else float("nan")),
        "steady_ms": _steady_ms(ty, 1, len(ty)),
        "control_steady_ms": _steady_ms(ctrl["t_yield"], 1,
                                        len(ctrl["t_yield"])),
        "bit_equal_to_control": equal,
    }
    log(f"[serve] (d) autoscaler steps {rec['steps']}; shards "
        f"{rec['shards']} from producers {rec['producers']}; the signal to "
        f"the new host's first window "
        f"{out['signal_to_new_host_window_ms']:.1f} ms; steady "
        f"{out['steady_ms']:.1f} ms/step (control "
        f"{out['control_steady_ms']:.1f}); losses "
        f"{'bit-equal to' if equal else 'NOT'} the replay control's ({card})")
    log(f"[serve] (d) counters {json.dumps(k)}")
    return faults_, out


def phase_serve(tmpdir, card):
    """Phase 16, the serving fabric: (a)-(c) two concurrent jobs through
    one fabric, its failover and a job's crash; (d) the autoscaler.
    Returns the summary (``launches``: the flash launches of the two
    concurrent jobs and of (d)'s fit, not the controls')."""
    import torch

    # Two jobs' steps share cuda:0's default stream from two threads: a
    # fixed cuBLAS workspace keeps each handle's algorithm choice that of
    # the solo controls.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    faults_, jobs = serve_jobs(tmpdir, card)
    more, scale = serve_autoscale(tmpdir, card)
    faults_ += more
    if faults_:
        raise PhaseFailed("[serve] " + "; ".join(faults_))
    launches = {name: jobs["launches"][name] + scale["launches"][name]
                for name in jobs["launches"]}
    took = time.perf_counter() - t0
    log(f"[serve] phase 16 took {took:.1f} s ({card})")
    return {"jobs": jobs, "autoscale": scale, "launches": launches,
            "seconds": took}


# ------------------------------------------------------------ phase 17 ---

#: Phase 17, the self-tuning data plane.  (e) the token cell from a
#: mis-matched seed (``LoaderConfig(wire_dtype="raw", prefetch_depth=1)``)
#: for ``windows`` windows, calibrated and controlled, against the seed
#: as shipped; the window stream keeps ``prefetch_depth`` windows in
#: flight (``windows(lookahead=prefetch_depth - 1)``).  (f) phase 4's
#: global shuffle with the calibrator's link probe on a simulated link of
#: ``slow_link_bytes_per_s`` (the JAX package bench's autotune default,
#: ``DDL_BENCH_AUTOTUNE_LINK_MBPS`` = 16).
TUNE = dict(windows=8, slow_link_bytes_per_s=16 << 20,
            controller_cooldown_s=0.3)


def tune_fit(tmpdir, card, m):
    """(e) calibrate at boot, then a KnobController over the tuned fit,
    against the seed run as shipped."""
    import numpy as np
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.env import export_tune_knobs, export_wire_knobs
    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.tune import (
        Calibrator, ControllerPolicy, KnobController, staging_pool_knob,
        staging_queue_knob,
    )

    T, tr = TUNE, TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=tr["n_layers"])
    token_file = _token_file(tmpdir)
    host_params = _host_params(llama.init_params, cfg)
    seed = LoaderConfig(wire_dtype="raw", prefetch_depth=1,
                        batch_size=tr["batch_size"],
                        n_producers=tr["n_producers"], n_epochs=T["windows"],
                        window_stream=True)
    pinned = {}

    def card_copy(a, b, payload):
        """The link probe's transfer: the pinned host-to-card copy into
        cuda:0 (a page-locked buffer, one copy, a synchronize)."""
        src = pinned.get(payload.nbytes)
        if src is None:
            src = pinned[payload.nbytes] = torch.empty(
                payload.nbytes, dtype=torch.uint8, pin_memory=True)
        src.numpy()[:] = payload.view(np.uint8)
        src.to("cuda:0", non_blocking=True)
        torch.cuda.synchronize()

    cal = Calibrator(hosts=[0, 1], transfer=card_copy, metrics=m)
    t0 = time.perf_counter()
    tuned = cal.calibrate(seed)
    cal_s = time.perf_counter() - t0
    cfg_t = tuned.apply(seed)

    def loss_fn(p, b):
        return llama.next_token_loss(p, b[0], cfg)

    def producer():
        return TokenStreamProducer(token_file, tr["seq_len"],
                                   tr["window_rows"], seed=SEED)

    control = _job_fit("seed", producer(), loss_fn, host_params, tr,
                       T["windows"], config=seed,
                       lookahead=seed.prefetch_depth - 1)
    free_device_memory()
    ctl = {}

    def step(window, loader):
        if "ctrl" not in ctl:
            engine = loader._ingestor.engine()
            ctl["ctrl"] = KnobController(
                [staging_queue_knob(engine.executor),
                 staging_pool_knob(engine.pool)],
                policy=ControllerPolicy(
                    sustain_s=0.0, cooldown_s=T["controller_cooldown_s"]),
                metrics=m, poll_interval_s=1.0)
        ctl["ctrl"].step()

    fit = _job_fit("tuned", producer(), loss_fn, host_params, tr,
                   T["windows"], config=cfg_t, metrics=m, hook=step,
                   lookahead=cfg_t.prefetch_depth - 1)
    free_device_memory()
    # The fits' configs exported their wire and depth knobs: clear them,
    # or (f)'s exchange would take the exported raw wire.
    export_wire_knobs(LoaderConfig())
    export_tune_knobs(LoaderConfig())
    faults_ = []
    for r in (control, fit):
        if r["error"] is not None:
            faults_.append(f"(e) {r['tag']} raised {r['error']!r}")
    if "ctrl" not in ctl:
        raise PhaseFailed("[tune] (e) the tuned fit served no window: "
                          + "; ".join(faults_))
    decisions = list(tuned.decisions) + list(ctl["ctrl"].decisions)
    if fit["losses"] != control["losses"]:
        faults_.append(f"(e) tuned losses {fit['losses']} != the seed's "
                       f"{control['losses']}")
    wire = next(d for d in tuned.decisions if d.knob == "wire_dtype")
    if wire.cost_source != "measured" or wire.new != "raw":
        faults_.append(f"(e) the wire decision on the card's link: {wire} "
                       "(a lossy wire on a fast link is a failure)")
    want = cfg.n_layers * T["windows"] * tr["window_rows"] // tr["batch_size"]
    if not all(fit["launches"][n] == fit["sm90_launches"][n] == want
               for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        faults_.append(f"(e) K1-K3 launches {fit['launches']}")
    tol = ctl["ctrl"].policy.revert_tol
    for d in ctl["ctrl"].decisions:
        if d.reason.startswith("never-worse"):
            slower = d.signals["post_rate"] < d.signals["pre_rate"] * (1 - tol)
            log(f"[tune] (e) revert {d.knob} {d.old} -> {d.new}: post "
                f"{d.signals['post_rate']:.1f} < pre "
                f"{d.signals['pre_rate']:.1f} samples/s {slower}")
            if not slower:
                faults_.append(f"(e) a revert without a slower window: {d}")
    out = {"calibration_s": cal_s, "deadline_s": cal.deadline_s,
           "report": tuned.as_report(), "overlay": tuned.overlay,
           "controller": ctl["ctrl"].report(),
           "seed_ms": _job_ms(control), "tuned_ms": _job_ms(fit),
           "launches": fit["launches"],
           "bit_equal": fit["losses"] == control["losses"]}
    log(f"[tune] (e) calibration {cal_s * 1e3:.1f} ms against its "
        f"{cal.deadline_s} s deadline (deadline hit {tuned.deadline_hit}); "
        f"seed {out['seed_ms']:.1f} ms/step, tuned {out['tuned_ms']:.1f} "
        f"ms/step; losses {'bit-equal' if out['bit_equal'] else 'NOT equal'}"
        f" ({card})")
    return faults_, out, decisions


def tune_shuffle(tmpdir, card, m):
    """(f) the wire decision on a slow link: phase 4's drain started raw
    on the device fabric (K9), the calibrator's pick, then the exchange on
    the picked wire against a hand-set int8 control.  The device tier
    moves raw rows (both packages): int8 lanes take the host exchange."""
    import numpy as np
    import torch

    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.ops import device_shuffle as dsh
    from ddl_tpu_torch.shuffle import (
        DeviceExchangeFabric, DeviceExchangeShuffler, Rendezvous,
        ThreadExchangeShuffler,
    )
    from ddl_tpu_torch.tune import Calibrator

    T, sh = TUNE, SHUFFLE
    seed = LoaderConfig(wire_dtype="raw")
    fabric = DeviceExchangeFabric(devices=["cuda:0"] * sh["n"])
    dsh.reset_launch_counts()
    raw, raw_pushers, raw_s = drain_instances(
        lambda: DeviceExchangeShuffler.factory(fabric=fabric,
                                               wire_dtype=seed.wire_dtype))
    torch.cuda.synchronize()
    k9 = dsh.exchange_ring.launches

    def slow_link(a, b, payload):
        """The simulated link: a transfer takes its bytes over the rate."""
        time.sleep(payload.nbytes / T["slow_link_bytes_per_s"])

    # The wire microbenchmark samples the shuffle's own pool rows.
    pool = PoolProducer(0, sh["rows"], sh["cols"])
    pool.on_init()
    sample = np.empty((sh["rows"], sh["cols"]), np.float32)
    pool.post_init(sample)
    cal = Calibrator(hosts=[0, 1], transfer=slow_link, sample=sample[:256],
                     metrics=m)
    t0 = time.perf_counter()
    tuned = cal.calibrate(seed)
    cal_s = time.perf_counter() - t0
    pick = tuned.apply(seed).wire_dtype

    def lane_drain(wire_dtype):
        rdv = Rendezvous()
        return drain_instances(lambda: ThreadExchangeShuffler.factory(
            rdv, wire_dtype=wire_dtype))

    dsh.reset_launch_counts()
    got, got_pushers, got_s = lane_drain(pick)
    ctrl, _, ctrl_s = lane_drain("int8")
    k9_int8 = dsh.exchange_ring.launches
    faults_ = []
    d = next(d for d in tuned.decisions if d.knob == "wire_dtype")
    if not (pick == "int8" and d.new == "int8"
            and d.cost_source == "measured"):
        faults_.append(f"(f) the wire decision on the slow link: {d}")
    if not (k9 == fabric.legs > 0 and all(
            p.metrics.counter("shuffle.device_fallbacks") == 0
            for p in raw_pushers.values())):
        faults_.append(f"(f) the raw drain's K9 launches {k9}, fabric rounds "
                       f"{fabric.legs}")
    same = all(torch.equal(_bytes(got[i]), _bytes(ctrl[i]))
               for i in range(sh["n"]))
    encoded = sum(p.metrics.counter("wire.encoded_bytes")
                  for p in got_pushers.values())
    payload = sum(p.metrics.counter("wire.payload_bytes")
                  for p in got_pushers.values())
    if not (same and encoded > 0 and k9_int8 == 0):
        faults_.append(f"(f) int8 drains: byte-equal {same}, encoded bytes "
                       f"{encoded}, K9 launches {k9_int8}")
    out = {"calibration_s": cal_s, "report": tuned.as_report(), "pick": pick,
           "raw_drain_s": raw_s, "tuned_drain_s": got_s,
           "control_drain_s": ctrl_s, "k9_launches": k9,
           "fabric_rounds": fabric.legs,
           "encoded_over_payload": (encoded / payload if payload
                                    else float("nan")),
           "pools_byte_equal": same}
    log(f"[tune] (f) on a {T['slow_link_bytes_per_s'] / 2**20:.0f} MiB/s "
        f"simulated link the calibrator picks {pick} ({d.cost_source}; "
        f"{d.reason}) in {cal_s * 1e3:.1f} ms; the raw drain through the "
        f"device fabric {raw_s:.3f} s, K9 {k9} launches for {fabric.legs} "
        f"rounds; the int8 drains (the host exchange: the device tier moves "
        f"raw rows) {got_s:.3f} s tuned, {ctrl_s:.3f} s hand-set, pools "
        f"byte-equal {same}, encoded/payload "
        f"{out['encoded_over_payload']:.3f} ({card})")
    return faults_, out, list(tuned.decisions)


def phase_tune(tmpdir, card):
    """Phase 17, the self-tuning data plane, with the flight recorder
    armed: (e) a calibrated and controlled fit, (f) the wire decision on
    a slow link.  Returns the summary (``launches``: the tuned fit's
    flash launches; ``k9_launches``: the raw drain's)."""
    from ddl_tpu_torch.obs import recorder as flight
    from ddl_tpu_torch.observability import Metrics

    t0 = time.perf_counter()
    m = Metrics()
    rec = flight.FlightRecorder(capacity=1 << 18)
    with flight.armed(rec):
        faults_, fit, decisions = tune_fit(tmpdir, card, m)
        more, shuf, more_decisions = tune_shuffle(tmpdir, card, m)
    faults_ += more
    decisions += more_decisions
    events = [e for e in rec.events() if e[1] == "tune"]
    for d in decisions:
        log(f"[tune] decision {d.knob}: {d.old!r} -> {d.new!r} "
            f"({d.cost_source}: {d.reason})")
    if not (decisions and all(d.cost_source in ("measured", "declared",
                                                "default") for d in decisions)
            and any(d.cost_source == "measured" for d in decisions)
            and m.counter("tune.decisions") == len(events) == len(decisions)):
        faults_.append(f"provenance: {len(decisions)} decisions, "
                       f"tune.decisions {m.counter('tune.decisions')}, "
                       f"{len(events)} flight events")
    if faults_:
        raise PhaseFailed("[tune] " + "; ".join(faults_))
    took = time.perf_counter() - t0
    log(f"[tune] {len(decisions)} decisions, each in the flight recorder; "
        f"phase 17 took {took:.1f} s ({card})")
    return {"fit": fit, "shuffle": shuf, "launches": fit["launches"],
            "k9_launches": shuf["k9_launches"], "seconds": took,
            "decisions": [d.as_dict() for d in decisions]}


# ------------------------------------------------------------ phase 18 ---

#: Phase 18's sampled decode: phase 8's model (Llama-3-8B widths at
#: ``TRAIN["n_layers"]``), a prompt of ``prompt`` seeded tokens, the
#: sampling knobs of ``examples/generate_torch.py``'s nucleus call.
ENTRY = dict(prompt=16, new_tokens=16, temperature=0.8, top_k=8, top_p=0.9,
             seeds=(42, 43), eval_epochs=2, h2d_bytes=1 << 26)
#: The twins phase 18 (e) runs on the card: (script, arguments, the text
#: its last line must hold).
ENTRY_TWINS = (
    ("generate_torch.py", (), "OK"),
    ("run_ddl_torch.py", ("thread", "--output", "device"),
     "(device output): OK"),
    ("run_ddl_torch.py", ("process", "--output", "device"),
     "(device output): OK"),
    ("global_shuffle_torch.py", (), "PASS"),
)


def _launch_counts():
    """Every kernel wrapper's launch count, by its row name."""
    from ddl_tpu_torch.ops import device_shuffle as ds
    from ddl_tpu_torch.ops import flash_attention as fa
    from ddl_tpu_torch.ops import ici_fanout

    fns = fa.KERNELS + ici_fanout.KERNELS + (ds.exchange_ring,)
    return {fn.__name__: fn.launches for fn in fns}


def entry_decode(card):
    """(a) Sampled KV-cache decode at full width: greedy, then
    temperature + top-k + top-p under two seeded generators, then top_k=1;
    each sampled token held to the filtered support of the no-cache
    forward's logits at its step (through K1), the cached logits to the
    no-cache ones."""
    import numpy as np
    import torch

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.ops import flash_attention as fa

    e, tr = ENTRY, TRAIN
    P, new, T = e["prompt"], e["new_tokens"], e["temperature"]
    model = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                n_layers=tr["n_layers"])
    params = llama.init_params(model, seed=SEED, device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, model.vocab, (1, P), dtype=np.int64)).cuda()
    faults = []

    def gen(seed, **kw):
        g = torch.Generator("cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = llama.generate(params, prompt, model, max_new_tokens=new,
                             temperature=T, generator=g, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def cached_steps(seq):
        """The cached logits that picked each new token of ``seq``."""
        cache = llama.init_cache(model, 1, P + new, device="cuda")
        logits, cache = llama.forward_with_cache(
            params, seq[:, :P], model, cache, 0, last_only=True)
        steps = [logits[:, 0]]
        for pos in range(P, P + new - 1):
            step, cache = llama.forward_with_cache(
                params, seq[:, pos:pos + 1], model, cache, pos)
            steps.append(step[:, 0])
        return steps

    with torch.no_grad():
        # Warm-up: the first calls of the decode shapes and of the
        # sampling filter.
        llama.generate(params, prompt, model, max_new_tokens=2)
        gen(0, top_k=e["top_k"], top_p=e["top_p"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy = llama.generate(params, prompt, model, max_new_tokens=new)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
        knobs = dict(top_k=e["top_k"], top_p=e["top_p"])
        sampled, sampled_s = gen(e["seeds"][0], **knobs)
        other, _ = gen(e["seeds"][1], **knobs)
        top1, _ = gen(e["seeds"][0], top_k=1)

        # top_k=1 keeps only the largest logit, so it decodes as greedy
        # does.  The logits are bf16 products: where two tie at the
        # maximum, argmax takes the first and the sampler either, and the
        # sequences part there.  Each top_k=1 token must be a maximum of
        # the cached logits that picked it; up to the first tie on the
        # greedy path, the two sequences are equal.
        top1_steps = cached_steps(top1)
        not_max = [i for i, lg in enumerate(top1_steps)
                   if float(lg[0, int(top1[0, P + i])]) != float(lg.max())]
        greedy_steps = cached_steps(greedy)
        ties = [i for i, lg in enumerate(greedy_steps)
                if int((lg[0] == lg.max()).sum()) > 1]
        agree_to = ties[0] if ties else new
        top1_ok = not not_max and torch.equal(top1[:, :P + agree_to],
                                              greedy[:, :P + agree_to])
        del top1_steps, greedy_steps

        # The cached logits of the sampled sequence, step by step, and
        # the no-cache forward of each prefix (K1, counted alone).
        cached = cached_steps(sampled)
        k1 = fa.flash_fwd.launches
        full = [llama.forward(params, sampled[:, :P + i], model)[:, -1]
                for i in range(new)]
        torch.cuda.synchronize()
        k1 = fa.flash_fwd.launches - k1
        worst, outside = 0.0, []
        for i in range(new):
            worst = max(worst, float((cached[i] - full[i]).abs().max()))
            filt = llama._sample_filter(full[i].float() / T, e["top_k"],
                                        e["top_p"])[0]
            tok = int(sampled[0, P + i])
            if not torch.isfinite(filt[tok]):
                # In tempered units: how far below the support's smallest
                # logit the token sits.
                kept = filt[torch.isfinite(filt)]
                outside.append((i, tok, float(kept.min() - full[i][0, tok]
                                              .float() / T)))
    ms_tok = sampled_s / new * 1e3
    log(f"[entry] (a) decode at Llama-3-8B widths, {model.n_layers} layers, "
        f"a {P}-token prompt, {new} new tokens ({card}): greedy "
        f"{greedy_s / new * 1e3:.3f} ms a token, sampled (T={T}, top_k="
        f"{e['top_k']}, top_p={e['top_p']}) {ms_tok:.3f} ms a token")
    log(f"[entry] (a) sampled seed {e['seeds'][0]}: "
        f"{sampled[0, P:].tolist()}; seed {e['seeds'][1]}: "
        f"{other[0, P:].tolist()}")
    log(f"[entry] (a) top_k=1: {top1[0, P:].tolist()}; greedy: "
        f"{greedy[0, P:].tolist()}; steps where top_k=1 took no maximum of "
        f"its logits {not_max}; ties at the maximum on the greedy path at "
        f"steps {ties}; equal up to step {agree_to}: {top1_ok}")
    log(f"[entry] (a) cached vs no-cache logits max abs diff {worst:.4f} "
        f"(tol {BF16_LOGIT_ATOL}); tokens outside the no-cache forward's "
        f"filtered support {outside} (step, token, tempered gap; tol "
        f"{BF16_LOGIT_ATOL / T:.4f}); K1 launches over the {new} no-cache "
        f"forwards {k1} (expected {model.n_layers * new})")
    if worst > BF16_LOGIT_ATOL:
        faults.append(f"cached logits off by {worst}")
    if any(gap > BF16_LOGIT_ATOL / T for _, _, gap in outside):
        faults.append(f"sampled tokens outside the support: {outside}")
    if k1 != model.n_layers * new:
        faults.append(f"K1 launched {k1} times over the no-cache forwards")
    if not top1_ok:
        faults.append(f"top_k=1 sampling: no maximum at steps {not_max}, "
                      f"or differs from greedy before step {agree_to}")
    if torch.equal(sampled, other):
        faults.append("two generator seeds sampled the same tokens")
    if int(sampled.max()) >= model.vocab or int(sampled.min()) < 0:
        faults.append("a sampled token outside the vocab")
    del params, cached, full
    return faults, {"greedy_ms_per_token": greedy_s / new * 1e3,
                    "sampled_ms_per_token": ms_tok, "greedy_ties": ties,
                    "decode_max_abs": worst, "outside_support": outside,
                    "k1_no_cache": k1}


def entry_ingest(card):
    """(b) The host-to-card link, (c) ``DeviceIngestor.put`` out of a
    pinned ring slot, staged and inline."""
    import numpy as np
    import torch

    from ddl_tpu_torch.ingest import DeviceIngestor, measure_h2d_bandwidth
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.transport.ring import ThreadRing

    faults = []
    rate = measure_h2d_bandwidth(ENTRY["h2d_bytes"])
    log(f"[entry] (b) measure_h2d_bandwidth(): {rate:.6e} bytes/s for "
        f"{ENTRY['h2d_bytes']} bytes, pageable source, best of 3 ({card})")
    if not (math.isfinite(rate) and rate > 0):
        faults.append(f"h2d rate {rate}")
    rows, cols = 4096, 512
    # One slot for each mode: the two acquires take both.
    ring = ThreadRing(2, rows * cols * 4, pin_memory=True)
    put = {}
    for staged in (True, False):
        slot = ring.acquire_fill()
        win = ring.slot_view(slot)[:rows * cols * 4].view(np.float32).reshape(
            rows, cols)
        win[...] = np.random.default_rng(SEED + staged).standard_normal(
            (rows, cols), dtype=np.float32)
        host = (win[:, :3].copy(), win[:, 3:cols - 1].copy(),
                win[:, cols - 1:].copy())
        ing = DeviceIngestor(device="cuda", staged=staged, metrics=Metrics())
        t0 = time.perf_counter()
        out = ing.put((win[:, :3], win[:, 3:cols - 1], win[:, cols - 1:]))
        win[...] = -1.0  # the producer refills the slot at once
        torch.cuda.synchronize()
        put[staged] = time.perf_counter() - t0
        same = all(o.is_cuda and np.array_equal(o.cpu().numpy(), h)
                   for o, h in zip(out, host))
        ing.close()
        log(f"[entry] (c) put {'staged' if staged else 'inline'}: 3 columns "
            f"of a {rows} x {cols} fp32 slot, the slot overwritten at once: "
            f"equal to the host columns {same} ({put[staged] * 1e3:.3f} ms "
            f"to landed, {card})")
        if not same:
            faults.append(f"put (staged={staged}) changed with the slot")
    return faults, {"h2d_bytes_per_s": rate, "put_staged_ms": put[True] * 1e3,
                    "put_inline_ms": put[False] * 1e3}


def entry_mesh_evaluate(tmpdir, card):
    """(d) ``Trainer.evaluate`` over phase 11's dp mesh (4 positions of
    cuda:0) at full width: batches land sharded, the loss equals the same
    evaluate landed whole."""
    import torch

    from ddl_tpu_torch.models import llama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel import train as ptrain
    from ddl_tpu_torch.parallel.mesh import P, ShardedArray, make_mesh
    from ddl_tpu_torch.readers import TokenStreamProducer
    from ddl_tpu_torch.trainer import Trainer

    tr, dp = TRAIN, MESH["dp"]
    model = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                n_layers=tr["n_layers"])
    params = llama.init_params(model, seed=SEED, device="cuda")
    token_file = _token_file(tmpdir)
    mesh = make_mesh({"dp": dp}, ["cuda:0"] * dp)
    landed = []
    real_global = ptrain._global

    def spy(batch):
        landed.extend(batch if isinstance(batch, (tuple, list)) else (batch,))
        return real_global(batch)

    def run(on_mesh):
        kw = (dict(mesh=mesh, param_specs=llama.param_specs(model),
                   batch_spec=P(("dp",))) if on_mesh else {})
        m = mesh if on_mesh else None
        trainer = Trainer(
            lambda p, b: llama.next_token_loss(p, b[0], model, mesh=m),
            ptrain.adamw(1e-5), params, device="cuda", watchdog=False,
            metrics=Metrics(), **kw)
        t0 = time.perf_counter()
        got = trainer.evaluate(
            TokenStreamProducer(token_file, tr["seq_len"], tr["window_rows"],
                                seed=SEED + 7),
            trainer._init_fn(params),
            lambda p, b: llama.next_token_loss(p, b[0], model, mesh=m),
            batch_size=tr["batch_size"], n_producers=tr["n_producers"],
            window_stream=True, n_epochs=ENTRY["eval_epochs"])
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    whole, whole_s = run(False)
    ptrain._global = spy
    try:
        sharded, sharded_s = run(True)
    finally:
        ptrain._global = real_global
    rel = abs(sharded - whole) / abs(whole)
    split = [a for a in landed if isinstance(a, ShardedArray)]
    rows_ok = bool(split) and len(split) == len(landed) and all(
        len(a.shards) == dp
        and all(s.data.shape[1] * dp == a.shape[1] for s in a.shards)
        for a in split)
    log(f"[entry] (d) evaluate over {{'dp': {dp}}} positions of cuda:0, "
        f"{ENTRY['eval_epochs']} windows at Llama-3-8B widths: {sharded:.6f} "
        f"in {sharded_s:.3f} s; landed whole {whole:.6f} in {whole_s:.3f} s; "
        f"rel gap {rel:.3e} (tol 1e-5); {len(split)} of {len(landed)} windows "
        f"landed sharded, each position 1/{dp} of the rows: {rows_ok} ({card})")
    faults = []
    if not rel <= 1e-5:
        faults.append(f"mesh evaluate {sharded} vs whole {whole}")
    if not rows_ok:
        faults.append(f"mesh evaluate landed {len(split)} of {len(landed)} "
                      "windows sharded")
    del params
    return faults, {"eval_sharded": sharded, "eval_whole": whole,
                    "eval_rel_gap": rel, "eval_sharded_s": sharded_s}


def entry_twins(card):
    """(e) The example twins as a user runs them, on the card."""
    import importlib.util

    twins = list(ENTRY_TWINS)
    if importlib.util.find_spec("PIL") is None:
        log("[entry] (e) examples/train_vit_torch.py skipped: it decodes PNG "
            "shards through Pillow, which this machine lacks; it runs in "
            "the CPU tests (tests/test_torch_example_twins.py)")
    else:
        twins.append(("train_vit_torch.py", (), "PASS"))
    # All at once: each is a small run on one card, and most of its time
    # is the interpreter and torch starting.
    faults, took, procs = [], {}, []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for script, args, line in twins:
            out = open(os.path.join(tmp, f"{len(procs)}.out"), "w+")
            procs.append((script, args, line, out, subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "examples", script),
                 *args], stdout=out, stderr=subprocess.STDOUT, text=True,
                cwd=tmp)))
        done = {}
        while len(done) < len(procs):
            for i, p in enumerate(procs):
                if i not in done and (p[4].poll() is not None
                                      or time.perf_counter() - t0 > 300):
                    if p[4].poll() is None:
                        p[4].kill()
                    done[i] = (p[4].wait(), time.perf_counter() - t0)
            time.sleep(0.05)
        for i, (script, args, line, out, proc) in enumerate(procs):
            name = " ".join((script,) + args)
            rc, took[name] = done[i]
            out.seek(0)
            text = out.read()
            out.close()
            lines = [ln for ln in text.splitlines() if ln.strip()]
            last = lines[-1] if lines else ""
            log(f"[entry] (e) examples/{name}: exit {rc} in {took[name]:.1f} "
                f"s (all started together), last line {last!r}")
            for ln in lines[-4:-1]:
                log(f"[entry]     {ln}")
            if rc != 0 or line not in last:
                faults.append(f"{name} exited {rc}: {text[-800:]}")
    return faults, took


def phase_entry(tmpdir, card):
    """Phase 18, the port's entry points on the card: (a) sampled decode
    at full width, (b) the link rate, (c) ``DeviceIngestor.put``, (d) the
    mesh ``evaluate``, (e) the example twins.  Returns the summary
    (``launches``: every kernel's launches in (a)-(d))."""
    t0 = time.perf_counter()
    faults, summary, launches = [], {}, {}
    for part in (entry_decode, entry_ingest,
                 lambda c: entry_mesh_evaluate(tmpdir, c)):
        before = _launch_counts()
        f, s = part(card)
        for k, v in _launch_counts().items():
            launches[k] = launches.get(k, 0) + v - before[k]
        faults += f
        summary.update(s)
        free_device_memory()
    f, summary["twins_s"] = entry_twins(card)
    faults += f
    took = time.perf_counter() - t0
    summary.update(launches=launches, seconds=took)
    log(f"[entry] launches in (a)-(d): {launches}; phase 18 took {took:.1f} s "
        f"({card})")
    if faults:
        raise PhaseFailed("[entry] " + "; ".join(faults))
    return summary


def free_device_memory() -> None:
    """Drop what a finished fit left cached, so the next full-width fit
    (~43 GiB peak each) starts on an empty card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[mem] after freeing: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more of each fit, of the "
                    "device-fabric drain and of a dp=4 ICI drain with "
                    "torch.profiler")
    ap.add_argument("--multihost-child", nargs=3,
                    metavar=("RANK", "PORT", "DIR"), help=argparse.SUPPRESS)
    ap.add_argument("--cluster-child", nargs=3,
                    metavar=("RANK", "PORT", "DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import ddl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ddl_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    if args.multihost_child:  # one process of phase 12 (b)
        rank, port, out = args.multihost_child
        multihost_child(int(rank), int(port), out)
        return 0
    if args.cluster_child:  # one process of phase 15 (f)
        rank, port, out = args.cluster_child
        cluster_chaos_child(int(rank), int(port), out)
        return 0
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    try:
        card = phase_build()
        kernels = phase_kernels()
        free_device_memory()
        phase_model_check()
        shuffle_row, shuffle_summary = phase_shuffle(args.profile)
        free_device_memory()
        with tempfile.TemporaryDirectory() as tmp:
            ici_rows, ici_summary = phase_ici(tmp, args.profile)
            free_device_memory()
            launches, summary = phase_train(tmp, card, args.profile)
            packed_launches, packed_summary = phase_train(
                tmp, card, args.profile, packed=True)
            recovery_summary = phase_recovery(tmp, card)
            example_summary = phase_example(tmp, card)
            wire_summary = phase_wire(
                tmp, card, token_ref=recovery_summary["fits"].pop("clean"),
                packed_ref={
                    "losses": packed_summary["process"]["losses"],
                    "launches": packed_summary["process"]["launches"]})
            free_device_memory()
            files_summary = phase_files(tmp, card)
            free_device_memory()
            ring_launches, mesh_summary = phase_mesh(
                tmp, card, {row["name"]: row["ms"] for row in kernels},
                args.profile)
            free_device_memory()
            pipe_launches, mh_launches, pipe_summary = phase_pipeline(tmp, card)
            obs_summary = phase_obs(tmp, card, summary)
            moe_launches, vit_launches, vit_rows, families_summary = (
                phase_families(tmp, card))
            free_device_memory()
            cluster_summary = phase_cluster(tmp, card)
            cluster_launches = cluster_summary["launches"]
            free_device_memory()
            serve_summary = phase_serve(tmp, card)
            free_device_memory()
            tune_summary = phase_tune(tmp, card)
            free_device_memory()
            entry_summary = phase_entry(tmp, card)
        # Each kernel's launches come from the run of its own path; K1-K6
        # add those of the ring (phase 11) and of the two MULTIHOST
        # processes (phase 12 b), K1-K3 those of the gpipe fit (12 a).
        for row in kernels:
            row["launches"] = (packed_launches if row["name"].endswith("_seg")
                               else launches)[row["name"]]
            row["ring_launches"] = ring_launches[row["name"]]
            row["multihost_launches"] = mh_launches[row["name"]]
            # Phase 12 (b)'s ZeRO-1 legs (z1, z1int8) over both processes.
            row["zero1_launches"] = pipe_summary["multihost"]["zero1"][
                "launches"][row["name"]]
            if not row["name"].endswith("_seg"):
                row["pipeline_launches"] = pipe_launches[row["name"]]
            # Phase 14: the MoE fits' (einsum and ragged K1-K3, packed
            # K4-K6); the ViT-B/16 fit's and the non-causal timings.
            row["moe_launches"] = moe_launches[row["name"]]
            # Phase 15: the five ladder legs' fits (K1-K3).  Phase 16: the
            # two concurrent jobs and the autoscaler's fit; phase 17: the
            # tuned fit (K1-K3).
            if not row["name"].endswith("_seg"):
                row["cluster_launches"] = cluster_launches[row["name"]]
                row["serve_launches"] = serve_summary["launches"][row["name"]]
                row["tune_launches"] = tune_summary["launches"][row["name"]]
            if row["name"] in vit_rows:
                row["vit_launches"] = vit_launches[row["name"]]
                row["vit_noncausal"] = vit_rows[row["name"]]
        # Phase 17 (f): the raw drain's K9 launches.
        shuffle_row["tune_launches"] = tune_summary["k9_launches"]
        kernels.append(shuffle_row)
        kernels.extend(ici_rows)
        # Phase 18: the entry points' launches, (a) sampled decode and its
        # no-cache forwards (K1), (d) the mesh evaluate (K1, K8).
        for row in kernels:
            row["entry_launches"] = entry_summary["launches"].get(
                row["name"], 0)
        log(f"[summary-shuffle] {json.dumps(shuffle_summary)}")
        log(f"[summary-ici] {json.dumps(ici_summary)}")
        log(f"[summary] {json.dumps(summary)}")
        log(f"[summary-packed] {json.dumps(packed_summary)}")
        log(f"[summary-recovery] {json.dumps(recovery_summary)}")
        log(f"[summary-example] {json.dumps(example_summary)}")
        log(f"[summary-wire] {json.dumps(wire_summary)}")
        log(f"[summary-files] {json.dumps(files_summary)}")
        log(f"[summary-mesh] {json.dumps(mesh_summary)}")
        log(f"[summary-pipeline] {json.dumps(pipe_summary)}")
        log(f"[summary-obs] {json.dumps(obs_summary)}")
        log(f"[summary-families] {json.dumps(families_summary)}")
        log(f"[summary-cluster] {json.dumps(cluster_summary)}")
        log(f"[summary-serve] {json.dumps(serve_summary, default=repr)}")
        log(f"[summary-tune] {json.dumps(tune_summary, default=repr)}")
        log(f"[summary-entry] {json.dumps(entry_summary, default=repr)}")
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
