"""High-level Trainer: loader + train step in one call (port of
``ddl_tpu/trainer.py``: ``Trainer``, ``fit``, ``evaluate``, the fused and
synchronous window-stream loops, checkpoints and the preemption drain).

One object owns the run: the producer/consumer topology (the
``distributed_dataloader`` decorator, THREAD or PROCESS mode), the
one-device train step, the ``mark()`` protocol, the global-shuffle
pass-through, the watchdog around both loops (with elastic respawn when
asked), checkpoint/resume of both halves of a run (the train state and
the loader's logical clock) at window/epoch boundaries, and the
:class:`~ddl_tpu_torch.resilience.PreemptionGuard` drain.  The trainer
runs on ``device`` — the card unless the caller passes ``device="cpu"``.
Over a ``mesh`` of one device's positions (``mesh=``, ``param_specs=``,
``batch_spec=``) windows land sharded over ``P(None, *batch_spec)``
through the ingestor (the ICI tier on the card), are assembled into
global tensors for the step, and the ``TrainConfig``'s distributed-
optimizer knobs (ZeRO-1, int8 gradient communication) flow into every
step factory.  A ``pp`` mesh trains the stage layout
(``llama.stage_params`` / ``pp_param_specs``, a ``*_pp`` loss), and its
checkpoints keep that layout.  In MULTIHOST mode (a gloo group, a mesh
whose ``dp`` spans the processes) each process lands and trains on its
own rows, and the step crosses the group in one bucket (the global
batch's loss for a ``cross_entropy`` loss, ``parallel/train.py``);
``evaluate`` returns one global value on every process.  The window
stream records ``trainer.consume`` spans (:mod:`ddl_tpu_torch.obs`), and
its loop's work runs under ``ddl.`` ranges (:mod:`ddl_tpu_torch.profiling`):
the window wait (``ddl.window_wait``, timer ``trainer.window_wait``, with
the caller's ``window_hook`` under ``ddl.window_hook``), the steps'
dispatch (``ddl.step_dispatch``), the loss read-back
(``ddl.loss_readback``) and the window boundary (``ddl.boundary``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddl_tpu_torch import envspec
from ddl_tpu_torch.datasetwrapper import ProducerFunctionSkeleton
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.types import Marker
from ddl_tpu_torch.utils import done_event, resolve_device, value_ready

logger = logging.getLogger("ddl_tpu_torch")


def _loader_output(output: Optional[str]) -> str:
    """The loader's ``output`` for ``fit``/``evaluate``: None and the JAX
    package's ``"jax"`` both mean ``"device"``."""
    output = "device" if output in (None, "jax") else output
    if output not in ("device", "numpy", "torch"):
        raise ValueError(
            f"output must be device|jax|numpy|torch, got {output!r}")
    return output


def _hooked(stream: Any, window_hook: Callable[[Any], Any]) -> Any:
    """``stream`` with ``window_hook`` applied to each window, under the
    ``ddl.window_hook`` range."""
    from ddl_tpu_torch.profiling import annotate

    for win in stream:
        with annotate("ddl.window_hook"):
            win = window_hook(win)
        yield win


def _stream_splits(loader: Any) -> Tuple[int, ...]:
    """The single column-split tuple a window stream serves."""
    splits = set(loader.splits_per_producer)
    if len(splits) != 1:
        raise ValueError(
            "window_stream requires homogeneous column splits across "
            f"producers, got {sorted(splits)}"
        )
    (col_splits,) = splits
    return col_splits


def _window_cols(win: torch.Tensor, col_splits: Sequence[int]) -> Tuple[Any, ...]:
    """Split a (bpw, batch, *features) device window into column tensors
    along the first feature axis; one full-width column passes whole."""
    if len(col_splits) == 1 and col_splits[0] == win.shape[2]:
        return (win,)
    cols, off = [], 0
    for w in col_splits:
        cols.append(win[:, :, off : off + w])
        off += w
    return tuple(cols)


def _weighed(metric_fn: Callable[[Any, Any], Any], params: Any,
             batch: Any) -> Tuple[Any, Any]:
    """``(metric, weight)`` of one batch: the count of the one
    ``cross_entropy`` call the metric made (``losses.loss_weight``), else
    the batch's rows."""
    from ddl_tpu_torch.models.losses import loss_weight

    with loss_weight() as scope:
        value = metric_fn(params, batch)
    return value, scope.weight(float(batch[0].shape[0]))


@dataclasses.dataclass
class FitResult:
    state: Any  # final TrainState
    losses: List[float]  # per-epoch mean loss
    metrics: Metrics
    epochs_run: int = 0
    resumed_from_epoch: int = 0
    #: True when the run ended in a graceful preemption drain rather than
    #: completing its epochs: the caller should exit and let a restart
    #: resume.
    preempted: bool = False


class Trainer:
    """Owns one training run fed by the ddl_tpu_torch loader."""

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], Any],
        optimizer: Callable[..., Any],
        init_params: Any,
        device: Any = "cuda",
        metrics: Optional[Metrics] = None,
        accum_steps: Optional[int] = None,
        train_config: Any = None,
        watchdog: bool = True,
        watchdog_respawn: bool = False,
        stall_budget_s: float = 300.0,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_epochs: int = 1,
        checkpoint_async: Optional[bool] = None,
        checkpoint_keep: int = 3,
        preemption_guard: Any = None,
        mesh: Any = None,
        param_specs: Any = None,
        batch_spec: Any = None,
    ):
        """``loss_fn(params, batch) -> scalar`` over the loader's column
        tuple; ``optimizer(param_list) -> torch.optim.Optimizer`` (e.g.
        :func:`ddl_tpu_torch.parallel.train.adamw`); ``init_params`` the
        initial params tree (copied onto ``device`` at ``fit``).
        ``accum_steps`` (explicit wins over ``train_config``'s) averages
        grads over that many microbatches per update.

        ``watchdog`` runs a :class:`~ddl_tpu_torch.watchdog.Watchdog` over
        the producers during ``fit`` (``stall_budget_s`` without ring
        progress counts as a stall); ``watchdog_respawn`` replaces a dead
        producer in place instead of ending the run.

        ``checkpoint_dir`` turns on checkpoint/resume: every
        ``checkpoint_every_epochs`` windows (epochs on the batch path) the
        train state and the loader cursor are saved, and a ``fit`` on a
        directory holding a verified checkpoint resumes from it.
        ``checkpoint_async`` (default: the ``DDL_TORCH_CKPT_ASYNC`` gate,
        on) routes them through :class:`~ddl_tpu_torch.resilience.
        AsyncCheckpointer` (the step loop stalls for the device-to-host
        snapshot only; ``checkpoint_keep`` generations are kept);
        ``False`` keeps the synchronous :func:`~ddl_tpu_torch.checkpoint.
        save_train_state`.  ``preemption_guard`` (a :class:`~ddl_tpu_torch.
        resilience.PreemptionGuard`) is polled at every window/epoch
        boundary: on a notice the run drains — forced final checkpoint,
        the guard's rungs, clean producer shutdown — and ``fit`` returns
        with ``FitResult.preempted`` set.

        ``mesh`` (a :class:`~ddl_tpu_torch.parallel.mesh.Mesh` of one
        device's positions, e.g. ``make_mesh({"dp": 2, "sp": 2},
        ["cuda:0"] * 4)``) trains over it: ``param_specs`` (e.g.
        ``llama.param_specs(cfg)``) places the sharded optimizer state,
        ``batch_spec`` (default ``P(("dp",))``; ``P("dp", "sp")`` for
        sequence-parallel token batches) shards the landed windows, and
        the loss closes over the same mesh for its attention.  The mesh's
        device is the trainer's (``device`` must agree).
        ``train_config.optimizer_kwargs()`` (``optimizer_sharding``,
        ``grad_comm``, ``grad_comm_block``, ``stochastic_rounding``)
        flows into both step factories."""
        from ddl_tpu_torch.parallel.mesh import P, one_card
        from ddl_tpu_torch.parallel.train import make_train_step

        if train_config is not None:
            train_config.check_ported()
        if mesh is not None:
            mdev = one_card(mesh.device_list)
            if resolve_device(device).type != mdev.type:
                raise ValueError(f"device {device} differs from the mesh's {mdev}")
            device = mdev
        self.device = resolve_device(device)
        self.mesh = mesh
        self._param_specs = param_specs
        self._batch_spec = batch_spec if batch_spec is not None else P(("dp",))
        self._opt_kwargs = (train_config.optimizer_kwargs()
                            if train_config is not None else {})
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_epochs = max(1, checkpoint_every_epochs)
        if checkpoint_async is None:
            checkpoint_async = envspec.flag("DDL_TORCH_CKPT_ASYNC")
        self.checkpoint_async = bool(checkpoint_async)
        self.checkpoint_keep = max(1, int(checkpoint_keep))
        self._ckptr: Any = None  # lazy AsyncCheckpointer
        self._guard = preemption_guard
        self._restored_loader_ck: Any = None
        self._preempted = False
        self.watchdog_enabled = watchdog
        self.watchdog_respawn = watchdog_respawn
        self.stall_budget_s = stall_budget_s
        if accum_steps is None:
            accum_steps = (
                train_config.accum_steps if train_config is not None else 1
            )
        self.metrics = metrics or default_metrics()
        self._init_params = init_params
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._accum_steps = accum_steps
        self._init_fn, self._step_fn = make_train_step(
            loss_fn, optimizer, self.device, accum_steps=accum_steps,
            **self._mesh_kwargs(),
        )

    def _mesh_kwargs(self) -> dict:
        """The step factories' mesh and optimizer arguments."""
        if self.mesh is None:
            return dict(self._opt_kwargs)
        return dict(mesh=self.mesh, param_specs=self._param_specs,
                    batch_spec=self._batch_spec, **self._opt_kwargs)

    def _loader_sharding(self, window_stream: bool) -> dict:
        """The loader's ``sharding`` over the mesh: batches over
        ``batch_spec``, windows one axis deeper."""
        if self.mesh is None:
            return {}
        from ddl_tpu_torch.parallel.mesh import P, named

        spec = (P(*((None,) + tuple(self._batch_spec))) if window_stream
                else self._batch_spec)
        return {"sharding": named(self.mesh, spec)}

    def _loader_kwargs(self, output: str, window_stream: bool,
                       extra: Optional[dict] = None) -> dict:
        """The loader's keyword arguments beyond the common ones: the
        mesh sharding for device output (unless ``extra`` names one),
        then ``extra``."""
        kw = (dict(self._loader_sharding(window_stream))
              if output == "device" else {})
        kw.update(extra or {})
        return kw

    def _on_device(self, batch: Any, output: str) -> Any:
        """A served batch as the step's input: device batches as they
        are, host batches (numpy or CPU tensors, views of a ring slot)
        copied onto the trainer's device."""
        if output == "device":
            return batch
        return tuple(torch.tensor(np.asarray(c), device=self.device)
                     for c in batch)

    # -- checkpoint plumbing ----------------------------------------------

    def _loader_ckpt_path(self) -> str:
        assert self.checkpoint_dir is not None
        return os.path.join(self.checkpoint_dir, "loader.json")

    def _checkpointer(self) -> Any:
        """The lazily built per-trainer async checkpointer."""
        if self._ckptr is None:
            from ddl_tpu_torch.resilience import AsyncCheckpointer

            assert self.checkpoint_dir is not None
            self._ckptr = AsyncCheckpointer(
                self.checkpoint_dir, keep=self.checkpoint_keep,
                metrics=self.metrics,
            )
        return self._ckptr

    def _restore_or_init(self) -> Tuple[Any, int]:
        """Returns (train state, epoch to start from).

        Restore takes the verified source with the newest step: async
        generation files (integrity trailer checked, loader cursor inside
        the file) or synchronous ``step_*`` directories (manifest
        checked).  Unverifiable generations of either kind are
        quarantined and the previous verified one restores; exhaustion is
        a cold start, never a crash."""
        from ddl_tpu_torch.checkpoint import (
            LoaderCheckpoint,
            latest_verified_step,
            restore_train_state,
        )
        from ddl_tpu_torch.resilience import (
            latest_verified_generation,
            restore_latest,
        )

        state = self._init_fn(self._init_params)
        self._restored_loader_ck = None
        if self.checkpoint_dir is None:
            return state, 0
        with self.metrics.timed("resilience.restore"):
            gen = latest_verified_generation(
                self.checkpoint_dir, metrics=self.metrics
            )
            legacy_step = latest_verified_step(self.checkpoint_dir)
            if gen is not None and (legacy_step is None or gen[0] >= legacy_step):
                restored = restore_latest(
                    self.checkpoint_dir, like=state, metrics=self.metrics,
                    found=gen,
                )
                assert restored is not None  # gen verified just above
                self._restored_loader_ck = restored.loader
                start_epoch = (
                    restored.loader.epoch if restored.loader is not None else 0
                )
                logger.info(
                    "trainer: resumed step %d / epoch %d from generation "
                    "checkpoint %s", restored.state.step, start_epoch,
                    self.checkpoint_dir,
                )
                return restored.state, start_epoch
            if legacy_step is None:
                return state, 0
            state = restore_train_state(self.checkpoint_dir, like=state,
                                        step=legacy_step)
        start_epoch = 0
        if os.path.exists(self._loader_ckpt_path()):
            ck = LoaderCheckpoint.load(self._loader_ckpt_path())
            self._restored_loader_ck = ck
            start_epoch = ck.epoch
        logger.info("trainer: resumed step %d / epoch %d from %s",
                    state.step, start_epoch, self.checkpoint_dir)
        return state, start_epoch

    def _checkpoint(self, state: Any, loader: Any, force: bool = False,
                    timeout_s: float = 60.0) -> None:
        """Save the train state and the loader cursor.  Async: the stall is
        the snapshot; ``force`` (the drain's final checkpoint) waits until
        the bytes are durably on disk."""
        from ddl_tpu_torch.checkpoint import LoaderCheckpoint, save_train_state

        assert self.checkpoint_dir is not None
        ck = LoaderCheckpoint.capture(loader)
        if self.checkpoint_async:
            cp = self._checkpointer()
            if force:
                cp.checkpoint_now(state, ck, timeout_s=timeout_s)
            else:
                cp.submit(state, ck)
            return
        with self.metrics.timed("resilience.ckpt_sync"):
            save_train_state(state, self.checkpoint_dir)
            ck.save(self._loader_ckpt_path())

    def _finish_checkpoints(self) -> None:
        """Bounded flush of the async writer at the end of a fit (the last
        periodic generation must be durable before the process exits),
        then close it: its host staging (up to two copies of the train
        state) is released, and a later ``fit`` builds a fresh one."""
        if self._ckptr is None:
            return
        from ddl_tpu_torch.exceptions import CheckpointError

        ckptr, self._ckptr = self._ckptr, None
        try:
            ckptr.close(timeout_s=60.0)
        except CheckpointError:
            logger.exception(
                "trainer: async checkpoint flush at fit end failed — the "
                "newest generation may be missing on restart"
            )

    def _boundary(self, state: Any, loader: Any, epoch: int) -> bool:
        """The window/epoch-boundary hooks: the periodic checkpoint, then
        the preemption poll.  True when the run drained and must stop."""
        if (self.checkpoint_dir is not None
                and epoch % self.checkpoint_every_epochs == 0):
            self._checkpoint(state, loader)
        if self._guard is None or not self._guard.poll():
            return False
        self._preempt_drain(state, loader)
        return True

    def _preempt_drain(self, state: Any, loader: Any) -> None:
        """Run the guard's drain ladder: forced final checkpoint (state +
        fenced loader cursor, bounded by the remaining grace budget), the
        guard's own rungs, then a clean producer shutdown."""
        self._preempted = True

        def final_ckpt():
            if self.checkpoint_dir is not None:
                self._checkpoint(state, loader, force=True,
                                 timeout_s=max(1.0, self._guard.remaining()))

        self._guard.drain(final_checkpoint=final_ckpt, shutdown=loader.shutdown)

    # -- evaluation --------------------------------------------------------

    def evaluate(
        self,
        producer_function: ProducerFunctionSkeleton,
        state: Any,
        metric_fn: Callable[[Any, Any], Any],
        batch_size: int,
        n_producers: Optional[int] = None,
        mode: Optional[str] = None,
        output: Optional[str] = None,
        window_stream: bool = False,
        n_epochs: int = 1,
    ) -> float:
        """Metric pass over a (held-out) producer's windows on the
        trainer's device.

        Drains ``n_epochs`` epochs (one window each) computing
        ``metric_fn(params, batch) -> scalar`` per batch under
        ``torch.no_grad()`` and returns the sample-weighted mean; no
        optimizer step runs.  ``window_stream=True`` streams each window
        whole and evaluates its batches on the card; otherwise batches
        come through the prefetcher.  Every batch weighs the same.
        ``output`` is ``fit``'s: device batches (the default) land over
        the mesh as ``fit``'s do (``P(*batch_spec)``, windows one axis
        deeper) and reach ``metric_fn`` assembled; ``"numpy"`` /
        ``"torch"`` batches are copied to the device per batch.

        Over a mesh whose ``dp`` spans processes (MULTIHOST), each
        process evaluates its own rows of every global batch, and every
        process returns the same value: the mean over the global batches.
        A batch's global value is its processes' values weighted by the
        count of the ``cross_entropy`` call ``metric_fn`` made (the
        MULTIHOST step's rule, ``parallel/train.py``), else by their
        rows.  The sums and counts cross the group in one gloo call, so
        every process must serve the same number of batches."""
        from ddl_tpu_torch import DistributedDataLoader, distributed_dataloader
        from ddl_tpu_torch.parallel.train import _global

        output = _loader_output(output)
        if window_stream and output != "device":
            raise ValueError("window_stream requires output='device'")
        trainer = self

        @distributed_dataloader(n_producers=n_producers, mode=mode,
                                pin_memory=self.device.type == "cuda")
        def _run(env):
            loader = DistributedDataLoader(
                producer_function,
                batch_size=batch_size,
                connection=env.connection,
                n_epochs=n_epochs,
                output=output,
                device=trainer.device,
                metrics=trainer.metrics,
                **trainer._loader_kwargs(output, window_stream),
            )
            try:
                with torch.no_grad():
                    if window_stream:
                        vals = trainer._eval_windows(loader, state, metric_fn)
                    else:
                        vals = []
                        for _epoch in range(n_epochs):
                            it = (loader.prefetch() if output == "device"
                                  else loader)
                            for batch in it:
                                # Metrics stay on the device until the end.
                                batch = _global(
                                    trainer._on_device(batch, output))
                                vals.append(_weighed(metric_fn, state.params,
                                                     batch))
                                loader.mark(Marker.END_OF_BATCH)
                            loader.mark(Marker.END_OF_EPOCH)
                return trainer._eval_mean(vals)
            finally:
                loader.shutdown()

        return _run()

    def _eval_windows(self, loader: Any, state: Any,
                      metric_fn: Callable[[Any, Any], Any]) -> List[Any]:
        from ddl_tpu_torch.parallel.train import _global

        col_splits = _stream_splits(loader)
        vals: List[Any] = []
        for win in loader.windows():
            cols = _window_cols(_global(win), col_splits)
            vals.extend(_weighed(metric_fn, state.params,
                                 tuple(c[i] for c in cols))
                        for i in range(win.shape[0]))
            loader.mark(Marker.END_OF_EPOCH)
        return vals

    def _eval_mean(self, vals: List[Any]) -> float:
        """The mean over the batches of ``vals`` (``(value, weight)``
        pairs).  Over a process-spanning mesh each batch's value is the
        weighted mean of the processes' values: the sums and weights of
        every batch cross the group in ONE gloo ``all_reduce``."""
        if not vals:
            return float("nan")
        # One read-back of every batch's value (they stay on the card
        # until here), in float64 on the host.
        v = torch.stack([torch.as_tensor(v).detach().reshape(())
                         for v, _w in vals]).to("cpu", torch.float64)
        if self.mesh is None or not self.mesh.spans_processes:
            return float(v.mean())
        import torch.distributed as dist

        w = torch.stack([torch.as_tensor(w).detach().reshape(()).to(
            "cpu", torch.float64) for _v, w in vals])
        bucket = torch.cat([v * w, w])
        dist.all_reduce(bucket)
        n = len(vals)
        per_batch = bucket[:n] / torch.clamp(bucket[n:], min=1.0)
        return float(per_batch.mean())

    # -- window-stream epoch loop -----------------------------------------

    def _fit_windows(self, loader, state, start_epoch, n_epochs, epoch_losses,
                     stream_lookahead=1, fused=None,
                     window_hook=None) -> FitResult:
        """One multistep per streamed window.

        - **Fused** (:meth:`_fused_stream_loop`, default — the
          ``DDL_TORCH_FUSED`` gate): window N+1's copy is in flight while
          step N's kernels run, the slot release is gated on the
          consuming step's event, and the loss read-back is deferred by
          one window: it waits on the previous window's event, never on
          the steps just enqueued, so the host takes window N+1 while
          the card runs window N.
        - **Synchronous** (:meth:`_sync_stream_loop`, ``DDL_TORCH_FUSED=0``):
          the window lands, then the steps run, then the losses are read
          back.  Loss-identical to the fused loop.
        """
        from ddl_tpu_torch.parallel.train import make_multistep

        col_splits = _stream_splits(loader)
        if fused is None:
            from ddl_tpu_torch.parallel.ici import fused_enabled

            fused = fused_enabled()

        def multi_for(n_steps: int):
            _, fn = make_multistep(
                self._loss_fn, self._optimizer, self.device,
                n_steps=n_steps, accum_steps=self._accum_steps,
                **self._mesh_kwargs(),
            )
            return fn

        stream = loader.windows(lookahead=stream_lookahead)
        if self.mesh is not None:
            # Windows land sharded over the mesh positions; the step sees
            # them whole, as GSPMD hands the JAX package's step global
            # arrays (the rolled targets cross the shard cuts).
            stream = (w.assemble_local() for w in stream)
        if window_hook is not None:
            stream = _hooked(stream, window_hook)
        loop = self._fused_stream_loop if fused else self._sync_stream_loop
        state = loop(loader, stream, state, multi_for, col_splits,
                     epoch_losses, start_epoch)
        for i, mean in enumerate(epoch_losses):
            logger.info(
                "trainer: epoch %d/%d mean loss %.6f (windowed)",
                start_epoch + i + 1, n_epochs, mean,
            )
        return self._result(state, epoch_losses, start_epoch, n_epochs)

    def _result(self, state, epoch_losses, start_epoch, n_epochs) -> FitResult:
        return FitResult(
            state, epoch_losses, self.metrics,
            epochs_run=(len(epoch_losses) if self._preempted
                        else n_epochs - start_epoch),
            resumed_from_epoch=start_epoch,
            preempted=self._preempted,
        )

    def _fused_stream_loop(self, loader, stream, state, multi_for, col_splits,
                           epoch_losses, start_epoch):
        """The fused compute/ingest step: no host sync but the deferred
        loss read, which waits on the previous window's event.

        Per window: take it from the stream (its copy was started under
        the previous window's steps), enqueue its optimizer steps and, on
        the card, a non-blocking copy of their mean loss into a fresh
        page-locked scalar, record an event behind both and gate the
        window's slot release on it, then read back the PREVIOUS window's
        loss: wait on that window's event (never on the stream's tail)
        and read its scalar, so the card runs window k's steps while the
        host takes window k+1.  On the CPU there is no event and the read
        is the loss itself.  Time spent acquiring window k+1 while window
        k's steps still run accumulates into ``trainer.ingest_overlap`` (a
        lower bound on hidden ingest), and each such window counts in
        ``trainer.overlapped_windows``.
        """
        from ddl_tpu_torch.obs import spans as obs_spans
        from ddl_tpu_torch.profiling import annotate

        m = self.metrics
        pending = pending_done = None
        epoch = start_epoch
        _done = object()

        def read_back(loss, event):
            with annotate("ddl.loss_readback"):
                if event is not None:
                    event.synchronize()  # ddl-lint: disable=TDL020 - the deferred read waits only on the previous window's steps
                epoch_losses.append(float(loss))

        while True:
            t0 = time.perf_counter()
            with annotate("ddl.window_wait", m, timer="trainer.window_wait"):
                win = next(stream, _done)
            if pending_done is not None and not value_ready(pending_done, True):
                m.add_time("trainer.ingest_overlap", time.perf_counter() - t0)
                if win is not _done:
                    m.incr("trainer.overlapped_windows")
            if win is _done:
                break
            with annotate("ddl.step_dispatch"):
                if pending is None:
                    self._clock_start(m)
                span_t0 = obs_spans.t0()
                wkey = loader.last_window_key() or (None, None)
                state, losses = multi_for(win.shape[0])(
                    state, _window_cols(win, col_splits), per_step=True
                )
                self._clock_steps()
                # From the card, a non-blocking copy lands in page-locked
                # memory behind the steps, before the event that covers it;
                # on the CPU it is the loss itself.
                loss_mean = losses.mean().to("cpu", non_blocking=True)
                done = done_event(self.device)
                loader.gate_release_on(done)
                # The consume span is the host's dispatch of the window's
                # steps: the fused loop never waits on the card here.
                obs_spans.record("trainer.consume", *wkey, span_t0)
                m.incr("trainer.fused_windows")
            if pending is not None:
                read_back(pending, pending_done)
            pending, pending_done = loss_mean, done
            epoch += 1
            # A checkpoint's snapshot waits for the steps just enqueued;
            # a drain's final checkpoint loses no completed window.
            with annotate("ddl.boundary"):
                loader.mark(Marker.END_OF_EPOCH)
                if self._boundary(state, loader, epoch):
                    break
        if pending is not None:
            read_back(pending, pending_done)
        self._clock_finish(m)
        return state

    # -- start-up and steady state -------------------------------------------

    def _clock_start(self, m: Metrics) -> None:
        """At the first window handed to the steps: record
        ``trainer.first_window`` (``fit`` to here: producer start — spawn,
        in PROCESS mode — handshake, first fill and first copy) and mark
        where the steady state starts."""
        now = time.perf_counter()
        m.add_time("trainer.first_window", now - self._fit_t0)
        self._clock = [self._clock_mark(now)]

    def _clock_mark(self, now: Optional[float] = None) -> Any:
        """A timing event on the current stream (the card), else the host
        clock (the CPU, where every op is done when it returns)."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter() if now is None else now

    def _clock_steps(self) -> None:
        """After a window's steps are enqueued: where they end."""
        self._clock[1:] = [self._clock_mark()]

    def _clock_finish(self, m: Metrics) -> None:
        """Record ``trainer.windows``: from the first window handed to the
        steps to the end of the last window's steps, on the card's clock
        — every step of the stream, the steady state, without start-up or
        the loader's teardown.  Called once the last losses are read."""
        if len(self._clock) == 2:
            a, b = self._clock
            m.add_time("trainer.windows", a.elapsed_time(b) / 1e3
                       if self.device.type == "cuda" else b - a)

    def _sync_stream_loop(self, loader, stream, state, multi_for, col_splits,
                          epoch_losses, start_epoch):
        """The synchronous discipline (``DDL_TORCH_FUSED=0``): the window
        lands, THEN the steps run, THEN the losses are read back."""
        from ddl_tpu_torch.obs import spans as obs_spans
        from ddl_tpu_torch.profiling import annotate

        m = self.metrics
        epoch = start_epoch
        _done = object()
        while True:
            with annotate("ddl.window_wait", m, timer="trainer.window_wait"):
                win = next(stream, _done)
                if win is not _done and self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            if win is _done:
                break
            with annotate("ddl.step_dispatch"):
                if not epoch_losses:
                    self._clock_start(m)
                span_t0 = obs_spans.t0()
                wkey = loader.last_window_key() or (None, None)
                state, losses = multi_for(win.shape[0])(
                    state, _window_cols(win, col_splits), per_step=True
                )
                self._clock_steps()
            with annotate("ddl.loss_readback"):
                epoch_losses.append(float(losses.mean()))
            # The synchronous consume span covers the steps and the
            # blocking read-back.
            obs_spans.record("trainer.consume", *wkey, span_t0)
            epoch += 1
            with annotate("ddl.boundary"):
                loader.mark(Marker.END_OF_EPOCH)
                if self._boundary(state, loader, epoch):
                    break
        self._clock_finish(m)
        return state

    # -- the run -----------------------------------------------------------

    def fit(
        self,
        producer_function: ProducerFunctionSkeleton,
        batch_size: Optional[int] = None,
        n_epochs: Optional[int] = None,
        n_producers: Optional[int] = None,
        mode: Optional[str] = None,
        nslots: Optional[int] = None,
        prefetch_depth: Optional[int] = None,
        window_stream: Optional[bool] = None,
        stream_lookahead: int = 1,
        fused: Optional[bool] = None,
        config: Any = None,
        global_shuffle_fraction_exchange: Optional[float] = None,
        shuffler_factory: Any = None,
        window_hook: Any = None,
        output: Optional[str] = None,
        loader_kwargs: Optional[dict] = None,
    ) -> FitResult:
        """Run the whole producer/consumer training job.

        ``config`` (a :class:`ddl_tpu_torch.config.LoaderConfig`) supplies
        defaults for batch_size, n_epochs, n_producers, mode, nslots,
        output, window_stream, prefetch_depth, the exchange fraction, the
        exchange method and the ring timeout; explicit arguments win
        (``loader_kwargs`` over the config's exchange method and
        timeout).  ``loader_kwargs`` go to the
        :class:`DistributedDataLoader` as they are.

        ``output`` is the loader's: ``"device"`` (the default; ``"jax"``,
        the JAX package's name, means the same) lands batches on the
        trainer's device or mesh, ``"numpy"`` / ``"torch"`` serve host
        batches, which each step copies to the device.
        Checkpoint and watchdog knobs are Trainer constructor arguments.
        With a checkpoint in ``checkpoint_dir`` the run resumes where it
        stopped: ``FitResult.losses`` then holds this run's epochs only.  ``mode="process"`` spawns the producers (call
        ``fit`` under ``if __name__ == "__main__":``); their exit codes
        land in ``producer.exits_clean`` / ``producer.exits_failed``.

        ``window_stream=True`` drives the run off the window stream: each
        epoch-window crosses to the device as ONE copy straight out of
        the ring slot and all its batches run as one multistep, the next
        window's copy in flight meanwhile.  ``stream_lookahead`` deepens
        that pipeline; ``fused`` picks the loop (see ``_fit_windows``).
        ``window_hook`` (window-stream mode only) is applied to each device
        window before its steps and must keep its shape.  Otherwise each
        epoch iterates the current window batch by batch through the
        prefetcher.

        Global shuffle needs both knobs: the exchange fraction and a
        ``shuffler_factory`` (e.g. ``ThreadExchangeShuffler.factory(...)``,
        over a ``ShmRendezvous`` in PROCESS mode).
        """
        from ddl_tpu_torch import DistributedDataLoader, distributed_dataloader
        from ddl_tpu_torch.watchdog import Watchdog

        loader_kwargs = dict(loader_kwargs or {})
        if config is not None:
            config.check_ported()
            output = config.output if output is None else output
            loader_kwargs.setdefault("exchange_method", config.exchange_method)
            loader_kwargs.setdefault("timeout_s", config.ring_timeout_s)
            if global_shuffle_fraction_exchange is None:
                global_shuffle_fraction_exchange = (
                    config.global_shuffle_fraction_exchange)
            batch_size = config.batch_size if batch_size is None else batch_size
            n_epochs = config.n_epochs if n_epochs is None else n_epochs
            n_producers = (
                config.n_producers if n_producers is None else n_producers
            )
            mode = config.mode if mode is None else mode
            nslots = config.nslots if nslots is None else nslots
            if window_stream is None:
                window_stream = config.window_stream
            if prefetch_depth is None:
                prefetch_depth = config.prefetch_depth
        loader_kwargs.setdefault("timeout_s", 300.0)
        output = _loader_output(output)
        if window_stream and output != "device":
            raise ValueError("window_stream requires output='device'")
        if batch_size is None or n_epochs is None:
            raise ValueError(
                "batch_size and n_epochs are required (directly or via "
                "config=LoaderConfig(...))"
            )
        if prefetch_depth is None:
            prefetch_depth = envspec.get("DDL_TORCH_PREFETCH_DEPTH")
        if fused is not None and not window_stream:
            raise ValueError("fused requires window_stream=True")
        if window_hook is not None and not window_stream:
            raise ValueError("window_hook requires window_stream=True")
        global_shuffle_fraction_exchange = (
            global_shuffle_fraction_exchange or 0.0
        )
        if global_shuffle_fraction_exchange > 0 and shuffler_factory is None:
            raise ValueError(
                "global_shuffle_fraction_exchange > 0 requires a "
                "shuffler_factory (producers build no shuffler without one)"
            )
        trainer = self
        self._fit_t0 = time.perf_counter()
        self._clock: List[Any] = []
        envs: List[Any] = []

        # THREAD rings are page-locked at allocation; a PROCESS-mode
        # loader page-locks the shared-memory rings it attaches.
        @distributed_dataloader(
            n_producers=n_producers, mode=mode, nslots=nslots,
            pin_memory=self.device.type == "cuda",
            shuffler_factory=shuffler_factory, config=config,
        )
        def _main(env):
            envs.append(env)
            trainer._preempted = False
            state, start_epoch = trainer._restore_or_init()
            loader = DistributedDataLoader(
                producer_function,
                batch_size=batch_size,
                connection=env.connection,
                n_epochs=n_epochs,
                global_shuffle_fraction_exchange=(
                    global_shuffle_fraction_exchange),
                output=output,
                device=trainer.device,
                metrics=trainer.metrics,
                **trainer._loader_kwargs(output, bool(window_stream),
                                         loader_kwargs),
            )
            if start_epoch >= n_epochs:
                logger.info(
                    "trainer: checkpoint at epoch %d >= n_epochs %d — "
                    "nothing to do", start_epoch, n_epochs,
                )
                loader.shutdown()
                return FitResult(state, [], trainer.metrics,
                                 resumed_from_epoch=start_epoch)
            if start_epoch:
                from ddl_tpu_torch.checkpoint import LoaderCheckpoint

                # The cursor fenced to the restored state wins over the
                # loader.json mirror.  Producers regenerate their windows
                # from their seeds: skipping the consumed ones (one per
                # epoch) puts the stream where the checkpoint stopped.
                ck = trainer._restored_loader_ck
                if ck is None:
                    ck = LoaderCheckpoint.load(trainer._loader_ckpt_path())
                loader.fast_forward(ck.epoch)
                ck.apply(loader)
            wd = None
            if trainer.watchdog_enabled:
                # The trainer's registry: respawns and failures show in
                # this run's metrics.
                wd = Watchdog(
                    env.workers, stall_budget_s=trainer.stall_budget_s,
                    respawn=trainer.watchdog_respawn,
                    metrics=trainer.metrics,
                ).start()
            epoch_losses: List[float] = []
            try:
                if window_stream:
                    return trainer._fit_windows(
                        loader, state, start_epoch, n_epochs, epoch_losses,
                        stream_lookahead=stream_lookahead, fused=fused,
                        window_hook=window_hook,
                    )
                for epoch in range(start_epoch, n_epochs):
                    batch_losses: List[Any] = []
                    epoch_iter = (
                        loader.prefetch(prefetch_depth)
                        if output == "device" and prefetch_depth > 1
                        else loader
                    )
                    for batch in epoch_iter:
                        state, loss = trainer._step_fn(
                            state, trainer._on_device(batch, output))
                        # Keep losses on the device: a float() here would
                        # serialize loading against compute.
                        batch_losses.append(loss)
                        loader.mark(Marker.END_OF_BATCH)
                    loader.mark(Marker.END_OF_EPOCH)
                    vals = [float(x) for x in batch_losses]
                    epoch_losses.append(
                        sum(vals) / len(vals) if vals else float("nan")
                    )
                    logger.info(
                        "trainer: epoch %d/%d mean loss %.6f (%d batches)",
                        epoch + 1, n_epochs, epoch_losses[-1], len(vals),
                    )
                    # The batch path drains at the epoch boundary.
                    if trainer._boundary(state, loader, epoch + 1):
                        break
                return trainer._result(state, epoch_losses, start_epoch,
                                       n_epochs)
            finally:
                trainer._finish_checkpoints()
                if wd is not None:
                    wd.stop()
                loader.shutdown()

        result = _main()
        # The decorator has joined the workers by now.
        for code in envs[0].workers.exitcodes:
            self.metrics.incr("producer.exits_clean" if code == 0
                              else "producer.exits_failed")
        return result
