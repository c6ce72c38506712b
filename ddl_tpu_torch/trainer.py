"""High-level Trainer: loader + train step in one call (port of
``ddl_tpu/trainer.py``: ``Trainer``, ``fit``, ``_fit_windows`` and the
fused and synchronous window-stream loops).

One object owns the run: the producer/consumer topology (the
``distributed_dataloader`` decorator), the one-device train step and the
``mark()`` protocol.  The trainer runs on ``device`` — the card unless
the caller passes ``device="cpu"``.  Checkpointing, the watchdog,
preemption, global shuffle and observability spans are later slices.
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
    ):
        """``loss_fn(params, batch) -> scalar`` over the loader's column
        tuple; ``optimizer(param_list) -> torch.optim.Optimizer`` (e.g.
        :func:`ddl_tpu_torch.parallel.train.adamw`); ``init_params`` the
        initial params tree (copied onto ``device`` at ``fit``).
        ``accum_steps`` (explicit wins over ``train_config``'s) averages
        grads over that many microbatches per update."""
        from ddl_tpu_torch.parallel.train import make_train_step

        self.device = resolve_device(device)
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
                     stream_lookahead=1, fused=None) -> FitResult:
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
            state, losses = multi_for(win.shape[0])(
                state, _window_cols(win, col_splits), per_step=True
            )
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
        return state

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
            state, losses = multi_for(win.shape[0])(
                state, _window_cols(win, col_splits), per_step=True
            )
            epoch_losses.append(float(losses.mean()))
            loader.mark(Marker.END_OF_EPOCH)
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
    ) -> FitResult:
        """Run the whole producer/consumer training job.

        ``config`` (a :class:`ddl_tpu_torch.config.LoaderConfig`) supplies
        defaults for batch_size, n_epochs, n_producers, mode, nslots,
        window_stream, prefetch_depth and the ring timeout; explicit
        arguments win.

        ``window_stream=True`` drives the run off the window stream: each
        epoch-window crosses to the device as ONE copy straight out of
        the ring slot and all its batches run as one multistep, the next
        window's copy in flight meanwhile.  ``stream_lookahead`` deepens
        that pipeline; ``fused`` picks the loop (see ``_fit_windows``).
        Otherwise each epoch iterates the current window batch by batch
        through the prefetcher.
        """
        from ddl_tpu_torch import DistributedDataLoader, distributed_dataloader

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
        trainer = self

        @distributed_dataloader(
            n_producers=n_producers, mode=mode, nslots=nslots,
            pin_memory=self.device.type == "cuda",
        )
        def _main(env):
            state = trainer._init_fn(trainer._init_params)
            loader = DistributedDataLoader(
                producer_function,
                batch_size=batch_size,
                connection=env.connection,
                n_epochs=n_epochs,
                output="device",
                device=trainer.device,
                metrics=trainer.metrics,
                timeout_s=timeout_s,
            )
            epoch_losses: List[float] = []
            try:
                if window_stream:
                    return trainer._fit_windows(
                        loader, state, n_epochs, epoch_losses,
                        stream_lookahead=stream_lookahead, fused=fused,
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
                loader.shutdown()

        return _main()
