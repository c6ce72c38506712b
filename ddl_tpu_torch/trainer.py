"""High-level Trainer: loader + train step in one call (port of
``ddl_tpu/trainer.py``: ``Trainer``, ``fit``, ``_fit_windows`` and the
fused and synchronous window-stream loops).

One object owns the run: the producer/consumer topology (the
``distributed_dataloader`` decorator, THREAD or PROCESS mode), the
one-device train step, the ``mark()`` protocol, the global-shuffle
pass-through and the watchdog around both loops (with elastic respawn
when asked).  The trainer runs on ``device`` — the card unless the
caller passes ``device="cpu"``.  Checkpointing, preemption and
observability spans are later slices.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ddl_tpu_torch import envspec
from ddl_tpu_torch.datasetwrapper import ProducerFunctionSkeleton
from ddl_tpu_torch.observability import Metrics, metrics as default_metrics
from ddl_tpu_torch.types import Marker
from ddl_tpu_torch.utils import done_event, resolve_device, value_ready

logger = logging.getLogger("ddl_tpu_torch")


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


@dataclasses.dataclass
class FitResult:
    state: Any  # final TrainState
    losses: List[float]  # per-epoch mean loss
    metrics: Metrics


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
        producer in place instead of ending the run."""
        from ddl_tpu_torch.parallel.train import make_train_step

        self.device = resolve_device(device)
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
            loss_fn, optimizer, self.device, accum_steps=accum_steps
        )

    # -- window-stream epoch loop -----------------------------------------

    def _fit_windows(self, loader, state, n_epochs, epoch_losses,
                     stream_lookahead=1, fused=None,
                     window_hook=None) -> FitResult:
        """One multistep per streamed window.

        - **Fused** (:meth:`_fused_stream_loop`, default — the
          ``DDL_TORCH_FUSED`` gate): window N+1's copy is in flight while
          step N's kernels run, the slot release is gated on the
          consuming step's event, and the loss read-back is deferred by
          one window.
        - **Synchronous** (:meth:`_sync_stream_loop`, ``DDL_TORCH_FUSED=0``):
          the window lands, then the steps run, then the losses are read
          back.  Loss-identical to the fused loop.
        """
        from ddl_tpu_torch.parallel.train import make_multistep

        col_splits = _stream_splits(loader)
        if fused is None:
            fused = envspec.flag("DDL_TORCH_FUSED")

        def multi_for(n_steps: int):
            _, fn = make_multistep(
                self._loss_fn, self._optimizer, self.device,
                n_steps=n_steps, accum_steps=self._accum_steps,
            )
            return fn

        stream = loader.windows(lookahead=stream_lookahead)
        if window_hook is not None:
            stream = map(window_hook, stream)
        loop = self._fused_stream_loop if fused else self._sync_stream_loop
        state = loop(loader, stream, state, multi_for, col_splits, epoch_losses)
        for i, mean in enumerate(epoch_losses):
            logger.info(
                "trainer: epoch %d/%d mean loss %.6f (windowed)",
                i + 1, n_epochs, mean,
            )
        return FitResult(state, epoch_losses, self.metrics)

    def _fused_stream_loop(self, loader, stream, state, multi_for, col_splits,
                           epoch_losses):
        """The fused compute/ingest step: no host sync but the deferred
        ``float(pending)``.

        Per window: take it from the stream (its copy was started under
        the previous window's steps), enqueue its optimizer steps, gate
        its slot release on an event recorded behind them, then read back
        the PREVIOUS window's loss — a read that waits on steps already
        one window old.  Time spent acquiring window k+1 while window k's
        steps still run accumulates into ``trainer.ingest_overlap`` (a
        lower bound on hidden ingest).
        """
        m = self.metrics
        pending = pending_done = None
        _done = object()
        while True:
            t0 = time.perf_counter()
            with m.timed("trainer.window_wait"):
                win = next(stream, _done)
            if pending_done is not None and not value_ready(pending_done, True):
                m.add_time("trainer.ingest_overlap", time.perf_counter() - t0)
            if win is _done:
                break
            if pending is None:
                self._clock_start(m)
            state, losses = multi_for(win.shape[0])(
                state, _window_cols(win, col_splits), per_step=True
            )
            self._clock_steps()
            loss_mean = losses.mean()
            done = done_event(self.device)
            loader.gate_release_on(done)
            m.incr("trainer.fused_windows")
            if pending is not None:
                epoch_losses.append(float(pending))
            pending, pending_done = loss_mean, done
            loader.mark(Marker.END_OF_EPOCH)
        if pending is not None:
            epoch_losses.append(float(pending))
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
                          epoch_losses):
        """The synchronous discipline (``DDL_TORCH_FUSED=0``): the window
        lands, THEN the steps run, THEN the losses are read back."""
        _done = object()
        while True:
            with self.metrics.timed("trainer.window_wait"):
                win = next(stream, _done)
                if win is not _done and self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            if win is _done:
                break
            if not epoch_losses:
                self._clock_start(self.metrics)
            state, losses = multi_for(win.shape[0])(
                state, _window_cols(win, col_splits), per_step=True
            )
            self._clock_steps()
            epoch_losses.append(float(losses.mean()))
            loader.mark(Marker.END_OF_EPOCH)
        self._clock_finish(self.metrics)
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
    ) -> FitResult:
        """Run the whole producer/consumer training job.

        ``config`` (a :class:`ddl_tpu_torch.config.LoaderConfig`) supplies
        defaults for batch_size, n_epochs, n_producers, mode, nslots,
        window_stream, prefetch_depth and the ring timeout; explicit
        arguments win.  ``mode="process"`` spawns the producers (call
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

        timeout_s = 300.0
        if config is not None:
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
            timeout_s = config.ring_timeout_s
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
            shuffler_factory=shuffler_factory,
        )
        def _main(env):
            envs.append(env)
            state = trainer._init_fn(trainer._init_params)
            loader = DistributedDataLoader(
                producer_function,
                batch_size=batch_size,
                connection=env.connection,
                n_epochs=n_epochs,
                global_shuffle_fraction_exchange=(
                    global_shuffle_fraction_exchange),
                output="device",
                device=trainer.device,
                metrics=trainer.metrics,
                timeout_s=timeout_s,
            )
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
                        loader, state, n_epochs, epoch_losses,
                        stream_lookahead=stream_lookahead, fused=fused,
                        window_hook=window_hook,
                    )
                for epoch in range(n_epochs):
                    batch_losses: List[Any] = []
                    epoch_iter = (
                        loader.prefetch(prefetch_depth)
                        if prefetch_depth > 1
                        else loader
                    )
                    for batch in epoch_iter:
                        state, loss = trainer._step_fn(state, batch)
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
                return FitResult(state, epoch_losses, trainer.metrics)
            finally:
                if wd is not None:
                    wd.stop()
                loader.shutdown()

        result = _main()
        # The decorator has joined the workers by now.
        for code in envs[0].workers.exitcodes:
            self.metrics.incr("producer.exits_clean" if code == 0
                              else "producer.exits_failed")
        return result
