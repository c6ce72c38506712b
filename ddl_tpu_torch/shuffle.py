"""Global shuffle: cross-instance sample exchange (port of
``ddl_tpu/shuffle.py``: the in-process host tier and the device tier).

Between window refills, the k-th producer of every instance hands two
lanes of its pool to partner instances chosen by a *shared* permutation:
every peer derives the same permutation from a common seed
(:func:`exchange_permutation`, bit-identical to the JAX package's draw),
so no coordination round is needed.  Lane A travels forward along the
permutation, lane B backward.

- :class:`Rendezvous` + :class:`ThreadExchangeShuffler` — the host tier:
  an in-process board for THREAD-mode instances, with the peer-loss
  degradation ladder (a lost partner degrades the round to a seeded
  node-local shuffle; repeated losses disable the exchange), the
  reversible suspension rung and elastic ``rejoin``.
- :class:`ShmRendezvous` — the host tier across PROCESS-mode producers
  of one host: mailbox files on ``/dev/shm`` published by atomic rename,
  keyed by a session string every process shares (:func:`make_session`).
- :class:`DeviceExchangeFabric` + :class:`DeviceExchangeShuffler` — the
  device tier: the last arrival of a round lands all n lane blocks on the
  ring devices, runs the exchange kernel K9 once
  (``ddl_tpu_torch.ops.device_shuffle``) and hands the results back.
  Byte-identical to the host tier.  A failed device leg on a card ring
  raises out of every participant's round; on the plain version's CPU
  ring it latches every participant to the host exchange together.

Not in this slice: the exchange wire formats (``wire.py``: a
``wire_dtype`` other than raw, or any codec, raises) and the
fault-injection sites.
"""

from __future__ import annotations

import logging
import os
import re
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ddl_tpu_torch.concurrency import named_condition, named_lock
from ddl_tpu_torch.exceptions import DDLError, ShutdownRequested
from ddl_tpu_torch.observability import metrics as default_metrics
from ddl_tpu_torch.types import RunMode, Topology

logger = logging.getLogger("ddl_tpu_torch")

#: Permutation search bound (a typed error past it).
_MAX_TRIES = 1000

#: Valid exchange strategies.
EXCHANGE_METHODS = ("sendrecv_replace", "all_to_all")


def exchange_permutation(n: int, seed: int, round_: int) -> np.ndarray:
    """The shared partner permutation for one exchange round.

    Every same-index producer across instances calls this with identical
    arguments and gets the identical permutation.  Properties:
    ``p[i] != i`` (no self-sends) and, for n > 2, ``p[p[i]] != i`` (no
    2-cycles — a 2-cycle would swap the same rows straight back on the
    reverse lane).  n == 2 returns the swap; n == 1 the identity.
    """
    if n <= 1:
        return np.arange(n)
    if n == 2:
        return np.array([1, 0])
    rng = np.random.default_rng([seed & 0x7FFFFFFF, round_ & 0x7FFFFFFF])
    for _ in range(_MAX_TRIES):
        p = rng.permutation(n)
        if np.any(p == np.arange(n)):
            continue
        if np.any(p[p] == np.arange(n)):
            continue
        return p
    raise DDLError(
        f"no valid exchange permutation found for n={n} after {_MAX_TRIES} tries"
    )


def inverse_permutation(p: np.ndarray) -> np.ndarray:
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return inv


def exchange_slices(num_exchange: int) -> Tuple[slice, slice]:
    """The two row lanes of one exchange round: lane A (rows
    ``[0, half)``) travels forward along the permutation, lane B (rows
    ``[half, 2*half)``) backward.  An odd trailing row stays home."""
    half = num_exchange // 2
    return slice(0, half), slice(half, 2 * half)


class Rendezvous:
    """In-process exchange board: one mailbox per (producer, tag,
    destination) key, shared by all simulated instances.  Pass a fresh
    instance per run to ``ThreadExchangeShuffler.factory(rendezvous=...)``
    when wiring several instances in one process."""

    #: Reach of this fabric: same-process threads only.
    span = "thread"

    def __init__(self) -> None:
        self._lock = named_condition("shuffle.exchange.cond")
        self._boxes: Dict[Tuple[int, int, int], np.ndarray] = {}
        self._done: Dict[Tuple[int, int, int], np.ndarray] = {}

    def put(self, key: Tuple[int, int, int], rows: np.ndarray) -> None:
        with self._lock:
            self._boxes[key] = rows
            self._lock.notify_all()

    def take(self, key: Tuple[int, int, int], timeout_s: float = 60.0,
             should_abort: Optional[Callable[[], bool]] = None) -> np.ndarray:
        """Blocking take that polls ``should_abort`` (a peer tearing down
        may never post) and raises :class:`ShutdownRequested` then.

        Consumed boxes are RETAINED until :meth:`retire`: a respawned
        producer replaying its predecessor's round takes the same key
        again and sees the same rows.  The shuffler retires round r-1's
        keys when round r starts.
        """
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while key not in self._boxes:
                if key in self._done:  # replayed take
                    return self._done[key]
                if should_abort is not None and should_abort():
                    raise ShutdownRequested()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise DDLError(
                        f"exchange rendezvous timed out waiting for {key}"
                    )
                self._lock.wait(timeout=min(0.1, remaining))
            rows = self._boxes.pop(key)
            self._done[key] = rows
            return rows

    def discard(self, key: Tuple[int, int, int]) -> None:
        """Best-effort removal of a posted box (abort-path cleanup)."""
        with self._lock:
            self._boxes.pop(key, None)

    def retire(self, key: Tuple[int, int, int]) -> None:
        """Drop a consumed box (its round can no longer be replayed), and
        a live box under the same key — only a replayed re-put nobody
        will take."""
        with self._lock:
            self._done.pop(key, None)
            self._boxes.pop(key, None)


_default_rendezvous = Rendezvous()


#: Minimum age before a crashed run's session directory may be swept.
#: Age alone never sweeps: the minting process must be dead too.
STALE_SESSION_S = 3600.0

#: Prefix of every session directory (the sweep matches it).
_RDV_PREFIX = "ddl-rdv-"

#: Session names minted by :func:`make_session`: ``{prefix}-{pid}-{hex12}``;
#: the pid is the sweep's liveness signal.
_SESSION_RE = re.compile(
    rf"^{re.escape(_RDV_PREFIX)}.+-(\d+)-[0-9a-f]{{12}}$"
)


def _sweep_stale_sessions(root: str) -> None:
    """Best-effort removal of abandoned session directories under
    ``root`` (``/dev/shm`` is RAM: a killed run's mailboxes would stay
    until reboot).  A directory goes only when its name has
    :func:`make_session`'s shape, it is older than
    :data:`STALE_SESSION_S` and the process that minted it is dead."""
    import shutil

    cutoff = time.time() - STALE_SESSION_S
    try:
        entries = list(os.scandir(root))
    except OSError:
        return
    for ent in entries:
        m = _SESSION_RE.match(ent.name)
        if not m:
            continue
        try:
            if not ent.is_dir(follow_symlinks=False):
                continue
            if ent.stat(follow_symlinks=False).st_mtime >= cutoff:
                continue
            os.kill(int(m.group(1)), 0)  # raises if the minter is gone
        except ProcessLookupError:
            shutil.rmtree(ent.path, ignore_errors=True)
        except OSError:
            continue


#: Roots this process has swept (once per process and root).
_swept_roots: set = set()
_sweep_lock = named_lock("shuffle.sweep")


def make_session(prefix: str = "ddl") -> str:
    """A session name no crashed earlier run shares (its stale mailboxes
    would read as this run's round 0); the pid in it is the sweep's
    liveness signal."""
    return f"{prefix}-{os.getpid()}-{uuid.uuid4().hex[:12]}"


class ShmRendezvous:
    """Cross-process exchange board: one mailbox file per key in a
    session directory on ``/dev/shm`` (tmpfs).

    Every producer process of every instance on one host builds
    ``ShmRendezvous(session)`` with the same session string; the object
    carries only the session and the root, so it pickles across the spawn
    with the shuffler factory.  ``put`` writes the rows to a temporary
    file and renames it onto the key's name (atomic publish); ``take``
    polls for the name.  The file system orders the two, on any ISA, and
    each key has one writer and one reader by construction.

    Not host-spanning: ``/dev/shm`` belongs to one host.
    """

    span = "process"

    def __init__(self, session: str, root: str = "/dev/shm") -> None:
        self.session = session
        self.root = root
        # The directory is created lazily (first put): a handshake that
        # refuses the shuffler must not leave an empty session behind.

    @property
    def _dir(self) -> str:
        return os.path.join(self.root, f"{_RDV_PREFIX}{self.session}")

    def _path(self, key: Tuple[int, int, int]) -> str:
        return os.path.join(self._dir, f"p{key[0]}-t{key[1]}-d{key[2]}.npy")

    def put(self, key: Tuple[int, int, int], rows: np.ndarray) -> None:
        # The first mailbox this process creates under a root also sweeps
        # the sessions crashed runs left there.
        with _sweep_lock:
            if self.root not in _swept_roots:
                _swept_roots.add(self.root)
                _sweep_stale_sessions(self.root)
        os.makedirs(self._dir, exist_ok=True)
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, rows)
        os.rename(tmp, path)  # atomic publish

    def take(self, key: Tuple[int, int, int], timeout_s: float = 60.0,
             should_abort: Optional[Callable[[], bool]] = None) -> np.ndarray:
        """Blocking take with :meth:`Rendezvous.take`'s abort rule.

        A consumed mailbox is RETAINED as ``<name>.done`` (atomic
        rename) until :meth:`retire`: a respawned producer replaying its
        predecessor's round takes the same key again and reads the same
        rows."""
        path = self._path(key)
        done = f"{path}.done"
        # A retained copy can only exist before this take starts (one
        # reader per key), so it is probed once, not per spin.
        try:
            with open(done, "rb") as f:
                return np.load(f)
        except FileNotFoundError:
            pass
        deadline = time.monotonic() + timeout_s
        sleep_s = 0.0002
        while True:
            if should_abort is not None and should_abort():
                raise ShutdownRequested()
            try:
                with open(path, "rb") as f:
                    rows = np.load(f)
                os.replace(path, done)  # retained for a replay
                return rows
            except FileNotFoundError:
                pass
            if time.monotonic() > deadline:
                raise DDLError(
                    f"exchange rendezvous timed out waiting for {key} "
                    f"(session {self.session!r})"
                )
            time.sleep(sleep_s)
            sleep_s = min(sleep_s * 2, 0.05)

    def discard(self, key: Tuple[int, int, int]) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def retire(self, key: Tuple[int, int, int]) -> None:
        """Drop the retained ``.done`` copy (the round can no longer be
        replayed) and a live box under the same key — only a respawned
        partner's replayed re-put nobody will take."""
        for victim in (f"{self._path(key)}.done", self._path(key)):
            try:
                os.unlink(victim)
            except OSError:
                pass

    def cleanup(self) -> None:
        """Remove the whole session directory (after the run)."""
        import shutil

        shutil.rmtree(self._dir, ignore_errors=True)


def _check_wire(wire_dtype: Optional[str], codec: Optional[str]) -> None:
    if wire_dtype not in (None, "raw") or codec is not None:
        raise NotImplementedError(
            f"exchange wire {wire_dtype!r}/{codec!r}: encoded exchange "
            "lanes belong to the wire.py slice; this port moves raw rows"
        )


class ThreadExchangeShuffler:
    """Producer callback performing the cross-instance exchange
    in-process (registered by ``DataPusher`` when ``n_instances > 1`` and
    the consumer asked for a nonzero exchange fraction)."""

    #: Consecutive peer losses tolerated (each degrading one round to a
    #: node-local shuffle) before the exchange is disabled for the run.
    DEFAULT_MAX_PEER_LOSSES = 2

    def __init__(
        self,
        topology: Topology,
        producer_idx: int,
        num_exchange: int,
        exchange_method: str = "sendrecv_replace",
        rendezvous: Any = None,
        seed: int = 0,
        exchange_timeout_s: float = 60.0,
        degrade_on_peer_loss: bool = True,
        max_peer_losses: Optional[int] = None,
        wire_dtype: Optional[str] = None,
        codec: Optional[str] = None,
    ):
        if exchange_method not in EXCHANGE_METHODS:
            raise NotImplementedError(
                f"exchange_method {exchange_method!r}; valid: {EXCHANGE_METHODS}"
            )
        _check_wire(wire_dtype, codec)
        self.wire_dtype = "raw"
        self.codec = None
        self.topology = topology
        self.producer_idx = producer_idx
        self.num_exchange = num_exchange
        self.exchange_method = exchange_method
        self.seed = seed
        self.exchange_timeout_s = exchange_timeout_s
        #: True: a lost partner degrades the round to a node-local
        #: shuffle (loud warning + metric) instead of raising.
        self.degrade_on_peer_loss = degrade_on_peer_loss
        self.max_peer_losses = (
            self.DEFAULT_MAX_PEER_LOSSES
            if max_peer_losses is None
            else max_peer_losses
        )
        self.metrics = default_metrics()
        self._peer_losses = 0  # consecutive; reset by a healthy round
        self._degraded = False  # terminal: exchange disabled for the run
        # Reversible rung: every round shuffles node-locally until
        # resume_exchange().
        self._suspended = False
        self._rdv = rendezvous or _default_rendezvous
        self._round = 0
        # Outgoing keys of the last two rounds (swept at n == 2 only).
        self._sent: List[Tuple[int, Tuple[int, int, int]]] = []

    @property
    def span(self) -> str:
        """Reach of the underlying rendezvous fabric."""
        return getattr(self._rdv, "span", "thread")

    @property
    def supports_elastic_replay(self) -> bool:
        """True when the fabric retains consumed boxes for a replay
        (``retire`` marks it): a respawned producer may rejoin the
        exchange only behind this."""
        return hasattr(self._rdv, "retire")

    @property
    def exchange_round(self) -> int:
        """Completed exchange rounds."""
        return self._round

    @property
    def exchange_suspended(self) -> bool:
        return self._suspended

    def suspend_exchange(self) -> None:
        """Degrade every round to the seeded node-local shuffle until
        :meth:`resume_exchange`.  Idempotent; the round counter keeps
        advancing so the resume stays schedule-coherent."""
        if not self._suspended:
            self._suspended = True
            self.metrics.incr("shuffle.suspensions")
            logger.warning(
                "global shuffle: exchange SUSPENDED — shuffling "
                "node-locally until rejoin"
            )

    def resume_exchange(self) -> None:
        """Leave the suspension rung; the consecutive-loss ladder
        restarts clean."""
        if self._suspended:
            self._suspended = False
            self._peer_losses = 0
            self.metrics.incr("shuffle.resumes")
            logger.warning(
                "global shuffle: exchange RESUMED at round %d", self._round
            )

    def rejoin(self, round_: int) -> None:
        """Re-enter the exchange schedule at ``round_`` (elastic rejoin or
        checkpoint resume).  The permutation is a function of (seed,
        round) and consumed boxes are retained until the next round
        retires them, so replaying the round a dead predecessor was in
        reads the same rows whether or not it completed it."""
        self._round = int(round_)

    def _local_shuffle(self, my_ary: np.ndarray) -> None:
        """Node-local fallback: a deterministic in-place row permutation
        seeded by (seed, producer, round) — the producer's row multiset
        is kept exactly."""
        rng = np.random.default_rng(
            [self.seed & 0x7FFFFFFF, self.producer_idx, self._round]
        )
        rng.shuffle(my_ary)

    def _degrade_round(self, my_ary: np.ndarray, why: Exception) -> None:
        """Count the loss, shuffle locally, and after ``max_peer_losses``
        consecutive losses disable the exchange for the rest of the run."""
        self._peer_losses += 1
        self.metrics.incr("shuffle.degraded")
        logger.error(
            "global shuffle: exchange peer lost in round %d (%s) — "
            "degrading to node-local shuffle (loss %d/%d)",
            self._round, why, self._peer_losses, self.max_peer_losses,
        )
        if self._peer_losses >= self.max_peer_losses and not self._degraded:
            self._degraded = True
            logger.error(
                "global shuffle: %d consecutive peer losses — exchange "
                "DISABLED for the rest of the run", self._peer_losses,
            )
        self._local_shuffle(my_ary)

    def global_shuffle(self, my_ary: np.ndarray, should_abort: Any = None,
                       **kwargs: Any) -> None:
        n = self.topology.n_instances
        me = self.topology.instance_idx
        if n <= 1 or self.num_exchange < 2:
            return
        if self._degraded or self._suspended:
            if self._suspended:
                self.metrics.incr("shuffle.suspended_rounds")
            self._local_shuffle(my_ary)
            self._round += 1
            return
        p = exchange_permutation(n, self.seed + self.producer_idx, self._round)
        pinv = inverse_permutation(p)
        lane_a, lane_b = exchange_slices(self.num_exchange)
        tag = self._round * 2
        # Round r-1's replay window closes now.
        retire = getattr(self._rdv, "retire", None)
        if retire is not None and self._round > 0:
            retire((self.producer_idx, tag - 2, me))
            retire((self.producer_idx, tag - 1, me))
        # Sweep our outgoing boxes whose replay window has closed — only
        # safe at n == 2, where the partner is the same every round.
        if self._sent and n == 2:
            live = []
            for r, key in self._sent:
                if r <= self._round - 2:
                    self._rdv.discard(key)
                else:
                    live.append((r, key))
            self._sent = live
        # Lane A forward: i -> p[i]; lane B backward: i -> pinv[i].
        for lane, dest, t in (
            (lane_a, int(p[me]), tag),
            (lane_b, int(pinv[me]), tag + 1),
        ):
            put_key = (self.producer_idx, t, dest)
            self._rdv.put(put_key, my_ary[lane].copy())
            if n == 2:
                self._sent.append((self._round, put_key))
            try:
                my_ary[lane] = self._rdv.take(
                    (self.producer_idx, t, me),
                    timeout_s=self.exchange_timeout_s,
                    should_abort=should_abort,
                )
            except ShutdownRequested:
                # Retract our half so a later run on the same board
                # cannot pop this round's stale rows.
                self._rdv.discard(put_key)
                raise
            except DDLError as e:
                # The partner never showed: retract, then degrade.
                self._rdv.discard(put_key)
                if not self.degrade_on_peer_loss:
                    raise
                self._degrade_round(my_ary, e)
                self._round += 1
                return
        self._peer_losses = 0  # a healthy round resets the ladder
        self._round += 1

    @classmethod
    def factory(cls, rendezvous: Any = None, seed: int = 0,
                exchange_timeout_s: float = 60.0,
                degrade_on_peer_loss: bool = True,
                max_peer_losses: Optional[int] = None,
                wire_dtype: Optional[str] = None,
                codec: Optional[str] = None) -> "ExchangeShufflerFactory":
        return ExchangeShufflerFactory(
            rendezvous=rendezvous, seed=seed,
            exchange_timeout_s=exchange_timeout_s,
            degrade_on_peer_loss=degrade_on_peer_loss,
            max_peer_losses=max_peer_losses, wire_dtype=wire_dtype,
            codec=codec,
        )


class ExchangeShufflerFactory:
    """Picklable shuffler factory (the ``DataPusher(shuffler_factory=)``
    hook): a module-level class, not a closure, so it crosses the spawn
    boundary with the producer function.  Across processes its
    rendezvous must be a :class:`ShmRendezvous`: a :class:`Rendezvous`
    board cannot reach another process, and the producer's handshake
    refuses it."""

    def __init__(self, rendezvous: Any = None, seed: int = 0,
                 exchange_timeout_s: float = 60.0,
                 degrade_on_peer_loss: bool = True,
                 max_peer_losses: Optional[int] = None,
                 wire_dtype: Optional[str] = None,
                 codec: Optional[str] = None):
        _check_wire(wire_dtype, codec)
        self.rendezvous = rendezvous
        self.seed = seed
        self.exchange_timeout_s = exchange_timeout_s
        self.degrade_on_peer_loss = degrade_on_peer_loss
        self.max_peer_losses = max_peer_losses
        self.wire_dtype = wire_dtype
        self.codec = codec

    def _kwargs(self) -> Dict[str, Any]:
        return dict(
            rendezvous=self.rendezvous, seed=self.seed,
            exchange_timeout_s=self.exchange_timeout_s,
            degrade_on_peer_loss=self.degrade_on_peer_loss,
            max_peer_losses=self.max_peer_losses,
            wire_dtype=self.wire_dtype, codec=self.codec,
        )

    def __call__(self, topology: Topology, producer_idx: int,
                 num_exchange: int,
                 exchange_method: str = "sendrecv_replace",
                 ) -> ThreadExchangeShuffler:
        return ThreadExchangeShuffler(
            topology, producer_idx, num_exchange, exchange_method,
            **self._kwargs(),
        )


# -- device-side exchange tier (ddl_tpu_torch.ops.device_shuffle) ----------


class DeviceExchangeError(DDLError):
    """The device exchange leg failed (a build, launch or copy failure, an
    unplannable ring): every participant of the round sees it.  On a card
    ring it raises out of the round — the card is never traded for the
    host silently; on the CPU ring every participant latches the HOST
    exchange for the shuffler's life (``shuffle.device_fallbacks``).
    Distinct from a peer timeout, which degrades one round to the seeded
    node-local shuffle."""


class _DeviceRound:
    """One (producer_idx, round) exchange round on the fabric board."""

    __slots__ = ("n", "seed", "round_", "posts", "results", "error")

    def __init__(self, n: int, seed: int, round_: int) -> None:
        self.n = n
        self.seed = seed
        self.round_ = round_
        self.posts: Dict[int, np.ndarray] = {}
        self.results: Optional[Dict[int, np.ndarray]] = None
        self.error: Optional[BaseException] = None


def _resolve_devices(devices: Optional[Sequence[Any]]) -> Tuple[Any, ...]:
    """The ring devices: ``None`` means the distinct cards ``cuda:0..
    count-1``, and raises on a machine without one.  A ring over several
    distinct cards raises ``NotImplementedError`` (the multi-card slice);
    ``[cuda:k] * n`` is the one-card layout, ``["cpu"] * n`` the plain
    version's."""
    import torch

    from ddl_tpu_torch.parallel.mesh import one_card

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise DeviceExchangeError(
                "device exchange: no CUDA card; pass devices=['cpu'] * n "
                "for the plain version"
            )
    devices = tuple(torch.device(d) for d in devices)
    one_card(devices)  # raises on distinct cards / mixed types / none
    return devices


class DeviceExchangeFabric:
    """In-process coordination board for the device exchange.

    Every instance's k-th producer posts its lane block per round; the
    arrival that completes the set runs the DEVICE leg (land the blocks
    on the ring, one K9 launch, fetch the results) and publishes
    per-instance results — one kernel launch per round instead of ``2n``
    host mailbox hops.

    Reach: producers in THIS process.  The factory drops the fabric at
    the pickle boundary, so workers in other processes resolve the device
    tier off and run the host exchange — same bytes, by the shared-seed
    construction.  Round results are retained until round ``r + 2``
    starts, so a replayed take re-reads the same result.
    """

    span = "device"

    def __init__(self, devices: Optional[Sequence[Any]] = None) -> None:
        self._devices = _resolve_devices(devices)
        #: A card ring: a failed device leg raises out of the round
        #: instead of latching the host exchange.
        self.on_card = self._devices[0].type == "cuda"
        #: Device legs this fabric completed (one kernel launch each).
        self.legs = 0
        self._cond = named_condition("shuffle.device.cond")
        # (producer_idx, round) -> _DeviceRound; swept two rounds behind
        # the newest, so growth is bounded by 2 * n_producers.
        self._rounds: Dict[Tuple[int, int], _DeviceRound] = {}

    def _ring_devices(self, n: int) -> Tuple[Any, ...]:
        """The first ``n`` ring devices; fewer than ``n`` is unplannable."""
        if len(self._devices) < n:
            raise DDLError(
                f"device exchange unplannable: ring needs {n} devices "
                f"for {n} instances, have {len(self._devices)}"
            )
        return self._devices[:n]

    def exchange(self, *, producer_idx: int, round_: int,
                 instance_idx: int, n: int, block: np.ndarray, seed: int,
                 timeout_s: float = 60.0,
                 should_abort: Optional[Callable[[], bool]] = None,
                 ) -> np.ndarray:
        """Post this instance's lane block for ``round_`` and return the
        exchanged block.  Raises :class:`ShutdownRequested` (abort),
        :class:`DeviceExchangeError` (device leg failed), or
        :class:`DDLError` (a peer never posted — the caller degrades the
        round node-locally)."""
        key = (producer_idx, round_)
        with self._cond:
            self._sweep_rounds(producer_idx, round_)
            rnd = self._rounds.get(key)
            if rnd is None:
                rnd = _DeviceRound(n, seed, round_)
                self._rounds[key] = rnd
            if rnd.error is not None:
                raise DeviceExchangeError(str(rnd.error)) from rnd.error
            if rnd.results is not None:
                return rnd.results[instance_idx]  # replayed take
            rnd.posts[instance_idx] = block
            run_leg = len(rnd.posts) == n
            self._cond.notify_all()
        if run_leg:
            self._run_device_leg(rnd)
        deadline = time.monotonic() + timeout_s
        extended = False
        with self._cond:
            while rnd.results is None and rnd.error is None:
                if should_abort is not None and should_abort():
                    # Retract our half if the round has not filled.
                    if len(rnd.posts) < rnd.n:
                        rnd.posts.pop(instance_idx, None)
                    raise ShutdownRequested()
                if not extended and len(rnd.posts) == rnd.n:
                    # Every peer posted: the leg is running; the
                    # peer-loss clock no longer applies.
                    deadline = time.monotonic() + timeout_s
                    extended = True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if len(rnd.posts) == rnd.n:
                        raise DeviceExchangeError(
                            f"device exchange leg stalled at round "
                            f"{round_} (producer {producer_idx})"
                        )
                    rnd.posts.pop(instance_idx, None)
                    raise DDLError(
                        f"device exchange timed out waiting for peers "
                        f"at round {round_} (producer {producer_idx}: "
                        f"{len(rnd.posts)}/{rnd.n} posted)"
                    )
                self._cond.wait(timeout=min(0.1, remaining))
            if rnd.error is not None:
                raise DeviceExchangeError(str(rnd.error)) from rnd.error
            return rnd.results[instance_idx]

    def _sweep_rounds(self, producer_idx: int, round_: int) -> None:
        """Drop this producer's rounds older than ``round_ - 1``.  Caller
        holds the condition."""
        stale = [
            k for k in self._rounds
            if k[0] == producer_idx and k[1] < round_ - 1
        ]
        for k in stale:
            del self._rounds[k]

    def _run_device_leg(self, rnd: _DeviceRound) -> None:
        """The arrival that completed the round runs the leg.  ANY
        failure here is published to every participant, so they all
        raise (card ring) or latch the host exchange (CPU ring)
        together."""
        try:
            results = self._device_exchange(rnd)
        except (ShutdownRequested, KeyboardInterrupt):
            raise
        except Exception as e:  # published, not swallowed
            with self._cond:
                if rnd.results is None and rnd.error is None:
                    rnd.error = e
                self._cond.notify_all()
            return
        with self._cond:
            if rnd.error is None:
                rnd.results = results
                self.legs += 1
            self._cond.notify_all()

    def _device_exchange(self, rnd: _DeviceRound) -> Dict[int, np.ndarray]:
        from ddl_tpu_torch.ops import device_shuffle as _dsh

        n = rnd.n
        devices = self._ring_devices(n)
        blocks = []
        for i in range(n):
            if i not in rnd.posts:
                raise DDLError(
                    f"device exchange round {rnd.round_} missing "
                    f"instance {i}'s lanes"
                )
            b = rnd.posts[i]
            if b.shape != rnd.posts[0].shape or b.dtype != rnd.posts[0].dtype:
                raise DDLError(
                    f"device exchange round {rnd.round_}: instance {i} "
                    f"posted {b.shape}/{b.dtype}, expected "
                    f"{rnd.posts[0].shape}/{rnd.posts[0].dtype}"
                )
            blocks.append(b)
        p = exchange_permutation(n, rnd.seed, rnd.round_)
        routes = np.stack([p, inverse_permutation(p)])
        # Land, launch and hand back on one stream; the hand-back waits
        # for it, so a kernel fault surfaces HERE, inside this round.
        with _dsh.LANDING_LOCK:
            gin = _dsh.as_exchange_input(blocks, devices)
            out = _dsh.exchange_ring(gin, devices, routes)
            blocks_out = _dsh.exchange_output_blocks(out, devices)
        return {i: blocks_out[i] for i in range(n)}


class DeviceExchangeShuffler(ThreadExchangeShuffler):
    """The device-tier exchange shuffler: same contract, same bytes, one
    kernel launch per round instead of ``2n`` host mailbox hops.

    Inherits the whole degradation ladder of
    :class:`ThreadExchangeShuffler` (suspend/resume, peer-loss degrade,
    rejoin); the device tier wraps only the healthy round's transport.

    Resolution (at construction, not a fallback): the device tier engages
    only when the ``DDL_TORCH_DEVICE_SHUFFLE`` gate is not off, a fabric
    is present (the factory drops it at the pickle boundary), and the
    topology is THREAD (the fabric's reach).  The fourth rule of the JAX
    package, a raw wire, holds by construction: the port refuses any
    other wire.

    A device-leg failure (build, launch, copy, an unplannable ring) on a
    card ring raises :class:`DeviceExchangeError` out of every
    participant's round: the card is never traded for the host.  On the
    plain version's CPU ring every participant latches the host exchange
    for the shuffler's life (``shuffle.device_fallbacks``) and re-runs the
    SAME round over the host board with lanes unmutated, byte-identically.
    """

    def __init__(
        self,
        topology: Topology,
        producer_idx: int,
        num_exchange: int,
        exchange_method: str = "sendrecv_replace",
        rendezvous: Any = None,
        fabric: Optional[DeviceExchangeFabric] = None,
        device_shuffle: Optional[str] = None,
        **kwargs: Any,
    ):
        super().__init__(
            topology, producer_idx, num_exchange, exchange_method,
            rendezvous=rendezvous, **kwargs,
        )
        from ddl_tpu_torch import envspec

        gate = envspec.get("DDL_TORCH_DEVICE_SHUFFLE", device_shuffle)
        self._fabric = fabric
        self._device_latched = False  # terminal: host exchange for life
        why = None
        if str(gate).lower() in envspec.FALSY:
            why = "DDL_TORCH_DEVICE_SHUFFLE gate is off"
        elif fabric is None:
            why = "no fabric (crossed a pickle boundary, or none was given)"
        elif topology.mode is not RunMode.THREAD:
            why = (
                f"{topology.mode.value} topology: the in-process fabric "
                "cannot reach producers in other processes"
            )
        self._device_ok = why is None
        if why is not None and fabric is not None:
            logger.debug(
                "device shuffle resolved OFF for producer %d: %s",
                producer_idx, why,
            )

    @property
    def span(self) -> str:
        """``"device"`` while the device tier is engaged, else the host
        board's span."""
        if self.device_exchange_active:
            return "device"
        return super().span

    @property
    def device_exchange_active(self) -> bool:
        return self._device_ok and not self._device_latched

    def _latch_host(self, why: BaseException) -> None:
        self._device_latched = True
        self.metrics.incr("shuffle.device_fallbacks")
        logger.error(
            "device shuffle: exchange leg failed at round %d (%s) — "
            "latching the HOST exchange for the rest of the run",
            self._round, why,
        )

    def global_shuffle(self, my_ary: np.ndarray, should_abort: Any = None,
                       **kwargs: Any) -> None:
        n = self.topology.n_instances
        if n <= 1 or self.num_exchange < 2:
            return
        if not self.device_exchange_active or self._degraded or self._suspended:
            return super().global_shuffle(my_ary, should_abort, **kwargs)
        lane_a, _ = exchange_slices(self.num_exchange)
        half = lane_a.stop
        # Both lanes travel as one 2D block; trailing dims flatten into
        # columns and unflatten on return.
        block = np.ascontiguousarray(my_ary[: 2 * half].reshape(2 * half, -1))
        try:
            out = self._fabric.exchange(
                producer_idx=self.producer_idx,
                round_=self._round,
                instance_idx=self.topology.instance_idx,
                n=n,
                block=block,
                seed=self.seed + self.producer_idx,
                timeout_s=self.exchange_timeout_s,
                should_abort=should_abort,
            )
        except ShutdownRequested:
            raise
        except DeviceExchangeError as e:
            if self._fabric.on_card:
                raise
            # Latch, then re-run the SAME round over the host board —
            # lanes are unmutated, so the bytes equal a host-only run.
            self._latch_host(e)
            return super().global_shuffle(my_ary, should_abort, **kwargs)
        except DDLError as e:
            # A peer never posted: the host path's peer-loss rung.
            if not self.degrade_on_peer_loss:
                raise
            self._degrade_round(my_ary, e)
            self._round += 1
            return
        my_ary[: 2 * half] = out.reshape(my_ary[: 2 * half].shape)
        self.metrics.incr("shuffle.device_rounds")
        self._peer_losses = 0
        self._round += 1

    @classmethod
    def factory(cls, rendezvous: Any = None,
                fabric: Optional[DeviceExchangeFabric] = None,
                device_shuffle: Optional[str] = None,
                **kwargs: Any) -> "DeviceExchangeShufflerFactory":
        return DeviceExchangeShufflerFactory(
            rendezvous=rendezvous, fabric=fabric,
            device_shuffle=device_shuffle, **kwargs,
        )


class DeviceExchangeShufflerFactory(ExchangeShufflerFactory):
    """Picklable device-shuffler factory.

    Builds one :class:`DeviceExchangeFabric` (shared by every shuffler it
    makes in this process) unless given one.  The fabric is an
    in-process board, so :meth:`__getstate__` DROPS it: a worker in
    another process constructs with the device tier resolved off and runs
    the host exchange — same stream, and no ``shuffle.device_fallbacks``
    (resolution is not a fallback)."""

    def __init__(self, rendezvous: Any = None,
                 fabric: Optional[DeviceExchangeFabric] = None,
                 device_shuffle: Optional[str] = None, **kwargs: Any):
        super().__init__(rendezvous=rendezvous, **kwargs)
        self.fabric = fabric if fabric is not None else DeviceExchangeFabric()
        self.device_shuffle = device_shuffle

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state["fabric"] = None  # in-process reach only; see class doc
        return state

    def __call__(self, topology: Topology, producer_idx: int,
                 num_exchange: int,
                 exchange_method: str = "sendrecv_replace",
                 ) -> DeviceExchangeShuffler:
        return DeviceExchangeShuffler(
            topology, producer_idx, num_exchange, exchange_method,
            fabric=self.fabric, device_shuffle=self.device_shuffle,
            **self._kwargs(),
        )
