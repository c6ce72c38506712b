"""Runs the system under test, ``ddl_tpu_torch``, for one cell: the
configuration's model trained by ``Trainer.fit(..., window_stream=True)``
over the producers of the cell's traffic (its source's ``producer``, in
the mix's ``mode``), on the benchmark's weights.

Three pieces ride on the timed path through the port's public hooks:

- :class:`Judge` wraps the loss.  At the first steps it reads each loss,
  the first gradient as AdamW holds it after one step (its first moment
  over ``1 - b1``) and, at step ``judged + 1``, how far each leaf moved
  over the judged steps; afterwards it is one counter increment a step.
- :class:`WindowClock` is the fit's ``window_hook``.  It sums each
  consumed window's rows (the stream check), opens the measured window at
  the first window after the warm-up (a device synchronisation, then the
  host clock), records a CUDA event at every window, and closes the
  measured window at the first window boundary after ``seconds``
  (synchronised again).  With a trace it then profiles ``trace_windows``
  more windows.  It ends the fit through the public
  ``PreemptionGuard.notify()``; with no checkpoint directory the drain
  writes nothing.
- The optimizer factory keeps the AdamW it builds, for :class:`Judge`.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark import families, sources, trace, weights
from benchmark.reference import family as reference_family


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Judge:
    """Reads the judged steps off the loss the trainer calls."""

    def __init__(self, loss, judged: int, optimizers: List[Any],
                 initial: List[torch.Tensor]):
        self._loss = loss
        self.judged = judged
        self._optimizers = optimizers
        self._initial = initial
        self.calls = 0
        self.losses: List[torch.Tensor] = []
        self.grad_norms: Optional[torch.Tensor] = None
        self.delta_norms: Optional[torch.Tensor] = None

    def __call__(self, params, batch):
        self.calls += 1
        if self.calls <= self.judged + 1:
            self._read(params)
        out = self._loss(params, batch)
        if self.calls <= self.judged:
            self.losses.append(out.detach().float())
        return out

    @torch.no_grad()
    def _read(self, params) -> None:
        from ddl_tpu_torch.parallel.train import tree_leaves

        if self.calls == 2:
            opt = self._optimizers[-1]
            b1 = opt.param_groups[0]["betas"][0]
            norms = []
            for p in opt.param_groups[0]["params"]:
                m = opt.state.get(p, {}).get("exp_avg")
                norms.append(torch.zeros((), device=p.device) if m is None
                             else torch.linalg.vector_norm(m.float()) / (1 - b1))
            self.grad_norms = torch.stack(norms)
        if self.calls == self.judged + 1:
            self.delta_norms = torch.stack([
                torch.linalg.vector_norm(p.detach().float() - p0)
                for p, p0 in zip(tree_leaves(params), self._initial)])


class WindowClock:
    """The fit's window hook: stream sums, the measured window, the trace."""

    def __init__(self, device: torch.device, warmup: int, seconds: float,
                 trace_windows: int, tracer: Optional[trace.Tracer],
                 guard: Any, metrics: Any):
        self.device = device
        self.warmup = warmup
        self.seconds = seconds
        self.trace_windows = trace_windows
        self.tracer = tracer
        self.guard = guard
        self.metrics = metrics
        self.n = 0
        self.sums: List[torch.Tensor] = []
        self.events: List[Any] = []
        self.t_first = self.t_start = self.t_end = None
        self.measured = 0
        self.wait_s = 0.0
        self._wait0 = 0.0
        self.trace_path: Optional[str] = None
        self.traced_windows = 0
        self._trace_stop: Optional[int] = None

    def _event(self) -> Any:
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _wait_total(self) -> float:
        return self.metrics.timer("trainer.window_wait").total_s

    def __call__(self, win: torch.Tensor) -> torch.Tensor:
        k = self.n
        self.n += 1
        flat = win.reshape(-1, win.shape[-1])
        if flat.element_size() == 4 and flat.dtype != torch.int32:
            flat = flat.view(torch.int32)
        self.sums.append(flat.sum(dim=1, dtype=torch.int64))
        if k == 0:
            self.t_first = time.perf_counter()
        if k == self.warmup:
            _sync(self.device)
            self.t_start = time.perf_counter()
            self._wait0 = self._wait_total()
            self.events.append(self._event())
        elif k > self.warmup and self.t_end is None:
            self.events.append(self._event())
            if time.perf_counter() - self.t_start >= self.seconds:
                _sync(self.device)
                self.t_end = time.perf_counter()
                self.measured = k - self.warmup
                self.wait_s = self._wait_total() - self._wait0
                if self.tracer is None:
                    self.guard.notify("benchmark window closed")
                else:
                    self.tracer.start()
                    self._trace_stop = k + self.trace_windows
        elif self._trace_stop is not None and k == self._trace_stop:
            _sync(self.device)
            self.trace_path = self.tracer.stop()
            self.traced_windows = self.trace_windows
            self._trace_stop = None
            self.guard.notify("benchmark trace closed")
        return win

    def step_gaps_s(self) -> List[float]:
        """Seconds between consecutive windows of the measured window."""
        ev = self.events[:self.measured + 1]
        if self.device.type != "cuda":
            return [b - a for a, b in zip(ev, ev[1:])]
        return [a.elapsed_time(b) / 1e3 for a, b in zip(ev, ev[1:])]


@dataclasses.dataclass
class ProgramRun:
    """What the run of the program gives the harness (host values only)."""

    setup_s: float
    #: seconds from process start to each set-up phase's end
    setup_phases: Dict[str, float]
    window_s: float
    measured_windows: int
    window_gaps_s: List[float]
    wait_s: float
    windows_consumed: int
    row_sums: np.ndarray
    losses: List[float]
    grad_norms: List[float]
    delta_norms: List[float]
    memory_peak_bytes: int
    trace_path: Optional[str]
    traced_windows: int


def run(config: Dict[str, Any], traffic: Dict[str, Any],
        inputs: Dict[str, Any], seed: int, seconds: float, trace_on: bool,
        device: torch.device, scratch: str, t0: float,
        loss_wrapper: Any = None) -> ProgramRun:
    """One fit of the cell on the port; frees everything it made before
    returning.  ``loss_wrapper`` (tests) wraps the family's loss."""
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.resilience import PreemptionGuard
    from ddl_tpu_torch.trainer import Trainer

    marks = {"inputs": time.perf_counter() - t0}
    fam = families.load(config["family"])
    spw = int(traffic["steps_per_window"])
    judged = int(traffic["judged_steps"])
    warmup = math.ceil((judged + 1) / spw)
    specs = reference_family(config["family"]).leaf_specs(config)
    params, initial = weights.make(specs, seed, device)
    _sync(device)
    marks["weights"] = time.perf_counter() - t0
    pcfg = fam.program_config(config, traffic)
    loss = fam.loss_fn(pcfg, traffic)
    if loss_wrapper is not None:
        loss = loss_wrapper(loss)
    optimizers: List[Any] = []
    hp = config["optimizer"]
    make_adamw = adamw(hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                       weight_decay=hp["weight_decay"])

    def optimizer(leaves):
        opt = make_adamw(leaves)
        optimizers.append(opt)
        return opt

    judge = Judge(loss, judged, optimizers, initial)
    metrics = Metrics()
    guard = PreemptionGuard(deadline_s=600.0, metrics=metrics)
    clock = WindowClock(device, warmup, seconds, int(traffic["trace_windows"]),
                        trace.Tracer(scratch) if trace_on else None, guard,
                        metrics)
    trainer = Trainer(judge, optimizer, params, device=device, metrics=metrics,
                      preemption_guard=guard)
    marks["trainer"] = time.perf_counter() - t0
    res = trainer.fit(
        sources.load(traffic["source"]).producer(traffic, inputs, seed, config),
        batch_size=int(traffic["batch_size"]), n_epochs=1 << 40,
        n_producers=int(traffic["producers"]), mode=traffic["mode"],
        nslots=int(traffic["nslots"]), window_stream=True, window_hook=clock)
    _sync(device)
    if clock.t_end is None:
        raise RuntimeError(f"the fit ended after {clock.n} windows, before "
                           "the measured window closed")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    marks["first_window"] = clock.t_first - t0
    marks["warm_up"] = clock.t_start - t0
    out = ProgramRun(
        setup_s=clock.t_start - t0, setup_phases=marks,
        window_s=clock.t_end - clock.t_start,
        measured_windows=clock.measured, window_gaps_s=clock.step_gaps_s(),
        wait_s=clock.wait_s, windows_consumed=clock.n,
        row_sums=torch.stack(clock.sums).cpu().numpy(),
        losses=[float(x) for x in judge.losses],
        grad_norms=(judge.grad_norms.cpu().tolist()
                    if judge.grad_norms is not None else []),
        delta_norms=(judge.delta_norms.cpu().tolist()
                     if judge.delta_norms is not None else []),
        memory_peak_bytes=int(peak), trace_path=clock.trace_path,
        traced_windows=clock.traced_windows)
    del res, trainer, judge, clock, params, initial, optimizers
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out
