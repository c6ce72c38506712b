"""The port's lint and verify configuration, built in Python.

The reference tables (``[tool.ddl_lint]`` / ``[tool.ddl_verify]`` in
``pyproject.toml``) name the JAX package's functions, classes and
modules.  Here each list is mapped to its ``ddl_tpu_torch`` counterpart:
a name the port keeps stays as it is, a name the port spells otherwise
is replaced by the port's, and a name with no counterpart is dropped
with the reason beside it.  Nothing here is read from a file, so the
reference tables stay the JAX package's alone.
"""

from __future__ import annotations

from typing import Dict

from tools.ddl_lint.config import ALL_CODES, LintConfig
from tools.ddl_verify.config import ALL_PASSES, VerifyConfig

#: The port's package root, repo-relative.
PORT = "ddl_tpu_torch"

#: Reference checks whose subject cannot occur in torch code, each with
#: its reason.  The port's kernel boundary and fused step are held by
#: TDL001 / TDL020 (``tools/ddl_torch_check/checkers.py``) instead.
JAX_ONLY: Dict[str, str] = {
    "DDL001": "host sync inside a jax.jit/pmap/shard_map body: the port "
              "has no trace boundary; TDL001 holds its kernel boundary",
    "DDL002": "tracer leak from a traced function: only a JAX trace has "
              "tracers",
    "DDL003": "constant-seed jax.random.PRNGKey in a loop: the port "
              "seeds torch.Generator objects and numpy generators",
    "DDL010": "jax.jit constructed inside a loop: the port jits nothing",
    "DDL014": "jax.checkpoint/jax.remat without policy=: the port's "
              "remat policies are named in models/remat.py",
    "DDL017": "train-step jax.jit without donate_argnums: torch updates "
              "parameters and moments in place, there is nothing to "
              "donate",
}

#: The reference checks the port runs.
PORT_CODES = tuple(c for c in ALL_CODES if c not in JAX_ONLY)


def port_lint_config() -> LintConfig:
    """The reference checks over the port, with the port's names."""
    return LintConfig(
        enable=list(PORT_CODES),
        disable=[],
        hot_path_classes=["DistributedDataLoader", "DataPusher"],
        # _build_lock: dropped.  The port's build lock is ops/_build.py's
        # named lock "ops.build", a leaf of LOCK_ORDER (concurrency.py),
        # which VP001 holds across functions.
        lock_order=["_cond", "_lock", "_sweep_lock", "_spill_lock"],
        ingest_hot_path_functions=[
            "DeviceIngestor.put", "DeviceIngestor.put_batch",
            "PrefetchIterator.__next__", "TransferExecutor._run",
        ],
        producer_fill_functions=[
            "ArrayProducer._fill", "FileShardProducer._load_next",
            "WebDatasetProducer._fill", "TokenStreamProducer._fill",
            "PackedTokenProducer._fill", "TFRecordTokenProducer._fill",
        ],
        device_path_functions=[
            "IciDistributor.put", "IciDistributor.distribute",
            "IciDistributor._distribute_planned",
            # IciDistributor._onto_mesh: the port places the ring's
            # output on the mesh in these two module functions.
            "_finish_replicate", "_finish_shard",
            "fanout_replicate", "fanout_shard", "replicated_view",
            # _as_ring_input: the port's ring input is the block itself,
            # checked in place by this function.
            "_check_block",
            "fanout_start", "fanout_wait",
            "exchange_ring", "exchange_xla", "exchange_start", "exchange_wait",
        ],
        train_step_functions=["make_train_step", "make_multistep"],
        cluster_loop_functions=[
            # ClusterSupervisor.run: dropped, neither package defines it
            # (the loop is _run).
            "ClusterSupervisor._run", "ClusterSupervisor.wait_for_epoch",
            "probe_link_costs", "measure_assignment",
        ],
        serve_loop_functions=[
            "FairShareScheduler.admit",
            "FairShareScheduler._advance_round_if_stuck",
            "FairShareScheduler.revoke_inflight",
            "Autoscaler.step", "Autoscaler._run",
            "AdmissionController.report",
        ],
        fused_step_functions=[
            "Trainer._fused_stream_loop",
            "DistributedDataLoader.gate_release_on",
            "DistributedDataLoader._sweep_release_backlog",
            "IciDistributor._distribute_planned",
            "IciDistributor._track_in_flight",
            "exchange_start",
            # The fan-out's start half, as exchange_start: it must not
            # wait on the host.
            "fanout_start",
        ],
        wire_path_functions=[
            "DataPusher._encode_and_commit",
            "ThreadExchangeShuffler._encode_lane",
            "ThreadExchangeShuffler._decode_lane",
            "IciDistributor._distribute_planned",
            "CodecBackend.open", "pack_rows", "unpack_rows",
        ],
        checkpoint_write_functions=[
            "LoaderCheckpoint.save", "save_train_state", "_write_manifest",
            "AsyncCheckpointer._write_generation",
        ],
        control_send_functions=[
            "ElasticCluster._send_adoptions",
            "ElasticCluster._on_rank_respawned",
            "ConsumerConnection.request_replay",
        ],
        fabric_admission_functions=[
            "Tenant.admit", "Tenant.note_served", "Tenant.note_aborted",
            "Tenant.revoke_inflight", "Tenant.clear_revocations",
            "AdmissionController.register", "AdmissionController._release",
            "AdmissionController.revoke_inflight",
            "AdmissionController.clear_revocations",
            "IngestFabric._apply", "IngestFabric._crash",
            "IngestFabric.from_journal", "SupervisorHA.promote",
        ],
        obs_event_buffer_classes=["SpanLog", "FlightRecorder"],
        per_sample_hot_functions=[
            "ArrayProducer._fill", "FileShardProducer._load_next",
            "WebDatasetProducer._fill", "TokenStreamProducer._fill",
            "PackedTokenProducer._fill", "TFRecordTokenProducer._fill",
            "PrefetchIterator.__next__",
        ],
        tuned_knob_functions=[
            "DistributedDataLoader.prefetch", "PrefetchIterator.__init__",
            "StagingPool.__init__", "TransferExecutor.__init__",
            "Trainer.fit",
        ],
        lock_factory_modules=[f"{PORT}/concurrency.py"],
        # The port's tests build scratch locks and schedulers, as the
        # reference's do.
        per_path_ignores={"tests": ["DDL024", "DDL026"]},
    )


def port_verify_config() -> VerifyConfig:
    """The reference passes over the port.  VP003 runs as the port's
    variant (``envknobs.py``), which reads the ``DDL_TORCH_`` prefix."""
    return VerifyConfig(
        enable=list(ALL_PASSES),
        concurrency_module=f"{PORT}/concurrency.py",
        envspec_module=f"{PORT}/envspec.py",
        config_module=f"{PORT}/config.py",
        types_module=f"{PORT}/types.py",
        consumer_to_producer_dispatchers=["DataPusher._poll_control"],
        # The reference's DistributedDataLoader._drain_obs_once: the
        # port routes acks and reports in the connection's router, which
        # the loader's drain calls.
        producer_to_consumer_dispatchers=["ConsumerConnection.drain_acks"],
        blocking_allowed=["try_recv", "notify", "notify_all", "poll"],
        blocking_depth=3,
    )
