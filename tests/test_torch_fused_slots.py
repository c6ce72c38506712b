"""The fused two-slot landing: the port's ticket API and the distributor's
slot cycle against the JAX package's, on the CPU.

- ``fanout_wait(fanout_start(...))`` at slots 0 and 1 lands the blocks of
  the reference's ticket (its Pallas rings in interpret mode on the
  conftest's 8-device CPU mesh), byte for byte, for both modes, n = 2
  and 4, fp32 and bf16 (compared as 16-bit patterns); the tickets'
  fields agree.
- A slot outside ``[0, N_SLOTS)`` raises the reference's ``ValueError``
  in both packages before anything runs, on a one-position ring too.
- The reference's distributor cases (``tests/test_ici.py``: the slot
  cycle, one slot, the latch mid-fused) and its loader case under an
  ``ICI_DMA_FAIL`` at window 3 (``tests/test_faults.py``) give equal
  ``ici.windows`` / ``ici.fused_windows`` / ``ici.fallbacks`` and
  slot gauges in both packages.
- An exchange ticket at each slot gives the pools of ``exchange_plain``,
  of the port's and the reference's ``"xla"`` route, and of the host
  exchange; a fabric's rounds alternate slots.  (The reference's
  ``"ring"`` route is not run: its interpret mode is known-red on this
  JAX.)

The reference's kernels name ``pltpu.TPUCompilerParams``, which this JAX
spells ``pltpu.CompilerParams``; the fixture below lends the old name
for the test only.  The slot streams themselves run on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxSharding
from jax.sharding import PartitionSpec as JaxP

import ddl_tpu
import ddl_tpu_torch
from ddl_tpu import faults as jfaults
from ddl_tpu import shuffle as jsh
from ddl_tpu.observability import Metrics as JaxMetrics
from ddl_tpu.ops import device_shuffle as jdsh
from ddl_tpu.ops import ici_fanout as jfan
from ddl_tpu.parallel import ici as jici
from ddl_tpu_torch import faults as tfaults
from ddl_tpu_torch import shuffle as tsh
from ddl_tpu_torch.ingest import device_put
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.ops import device_shuffle as tdsh
from ddl_tpu_torch.ops import ici_fanout as tfan
from ddl_tpu_torch.parallel import ici as tici
from ddl_tpu_torch.parallel import mesh as tmesh

from torch_recovery_producers import PATTERN_SHAPE, PatternProducer, pattern


@pytest.fixture(autouse=True)
def _reference_compiler_params(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _block(rows, cols, dtype, seed):
    """The same block for both packages: (numpy for JAX, torch)."""
    x = np.random.default_rng(seed).standard_normal((rows, cols)).astype(
        np.float32)
    if dtype == "float32":
        return x, torch.from_numpy(x.copy())
    jx = x.astype(ml_dtypes.bfloat16)
    return jx, torch.from_numpy(jx.view(np.int16).copy()).view(torch.bfloat16)


def _bits(a):
    """Raw bit patterns of a numpy array or a CPU tensor (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    else:
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            a = a.view(np.int16)
    return a


# -- the fan-out tickets ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("slot", [0, 1])
@pytest.mark.parametrize("mode", ["replicate", "shard"])
def test_fanout_ticket_equals_reference(mode, slot, n, dtype):
    """8 rows over 2 or 4 positions, sourced on position ``slot``: every
    position holds the reference's block, position by position."""
    jdevs, tdevs = tuple(jax.devices()[:n]), ["cpu"] * n
    src = slot
    x, t = _block(8, 6, dtype, 100 * n + 10 * slot + len(mode))
    jt = jfan.fanout_start(mode, jax.device_put(x, jdevs[src]), jdevs, src,
                           slot=slot)
    before = {fn.__name__: fn.launches for fn in tfan.KERNELS}
    tt = tfan.fanout_start(mode, t, tdevs, src, slot=slot)
    assert {fn.__name__: fn.launches for fn in tfan.KERNELS} == before
    assert (tt.mode, tt.slot) == (jt.mode, jt.slot) == (mode, slot)
    assert tt.done is None  # CPU tensors land at once
    want = jfan.fanout_wait(jt, sync=True)
    got = tfan.fanout_wait(tt)
    assert got is tt.value
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_bits(got.tensor()), _bits(want))
    by_device = {s.device: s for s in want.addressable_shards}
    for s in got.shards:
        ref = by_device[jdevs[s.position]]
        assert s.index == ref.index
        np.testing.assert_array_equal(_bits(s.data), _bits(ref.data))


def test_fanout_start_rejects_an_unknown_mode_in_both_packages():
    x, t = _block(4, 2, "float32", 0)
    with pytest.raises(ValueError) as want:
        jfan.fanout_start("gather", jax.device_put(x, jax.devices()[0]),
                          tuple(jax.devices()[:2]))
    with pytest.raises(ValueError) as got:
        tfan.fanout_start("gather", t, ["cpu"] * 2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("slot", [2, -1])
def test_bad_slots_raise_before_anything_runs(slot, n, monkeypatch):
    """Every entry point with a slot refuses it, on a one-position ring
    too, with the reference's message; no plain version runs."""
    x, t = _block(4, 2, "float32", 1)
    jdevs, tdevs = tuple(jax.devices()[:n]), ["cpu"] * n
    jx = jax.device_put(x, jdevs[0])
    ran = []
    for name in ("replicate_plain", "shard_plain"):
        monkeypatch.setattr(tfan, name, lambda *a, _n=name: ran.append(_n))
    monkeypatch.setattr(tdsh, "exchange_plain", lambda *a: ran.append("x"))
    gin_j = np.zeros((n * 2, 2), np.float32)
    gin_t = torch.zeros((n * 2, 2))
    routes = np.stack([np.arange(n), np.arange(n)]).astype(np.int32)
    cases = [
        (lambda: jfan.fanout_start("replicate", jx, jdevs, slot=slot),
         lambda: tfan.fanout_start("replicate", t, tdevs, slot=slot)),
        (lambda: jfan.fanout_start("shard", jx, jdevs, slot=slot),
         lambda: tfan.fanout_start("shard", t, tdevs, slot=slot)),
        (lambda: jfan.fanout_replicate(jx, jdevs, slot=slot),
         lambda: tfan.fanout_replicate(t, tdevs, slot=slot)),
        (lambda: jfan.fanout_shard(jx, jdevs, slot=slot),
         lambda: tfan.fanout_shard(t, tdevs, slot=slot)),
        (lambda: jdsh.exchange_ring(gin_j, jdevs, routes, slot=slot),
         lambda: tdsh.exchange_ring(gin_t, tdevs, routes, slot=slot)),
        (lambda: jdsh.exchange_start("xla", gin_j, jdevs, range(n),
                                     slot=slot),
         lambda: tdsh.exchange_start("xla", gin_t, tdevs, range(n),
                                     slot=slot)),
        (lambda: jdsh.exchange_start("ring", gin_j, jdevs, range(n),
                                     slot=slot),
         lambda: tdsh.exchange_start("ring", gin_t, tdevs, range(n),
                                     slot=slot)),
    ]
    for ref, port in cases:
        with pytest.raises(ValueError, match="landing slot") as want:
            ref()
        with pytest.raises(ValueError, match="landing slot") as got:
            port()
        assert str(got.value) == str(want.value)
    assert ran == []


# -- the distributor's slot cycle (C10) ----------------------------------------


def _dp8_pair():
    jmesh = JaxMesh(np.array(jax.devices()[:8]), ("dp",))
    tmesh_ = tmesh.make_mesh({"dp": 8}, ["cpu"] * 8)
    return (JaxSharding(jmesh, JaxP("dp")),
            tmesh.NamedSharding(tmesh_, tmesh.P("dp")))


def _counts(m):
    return (m.counter("ici.windows"), m.counter("ici.fused_windows"),
            m.counter("ici.fallbacks"))


def _both(run):
    """``run(ici module, sharding, device_put, metrics, faults module)``
    on the reference and on the port: (reference's, port's) results."""
    jsh, tsh_ = _dp8_pair()
    want = run(jici, jsh, jax.device_put, JaxMetrics(), jfaults)
    got = run(tici, tsh_, device_put, Metrics(), tfaults)
    return want, got


def _value(x):
    return _bits(x.numpy() if isinstance(x, tmesh.ShardedArray) else x)


def test_distributor_cycles_slots_and_counts():
    """The reference's case: four windows at two slots count four fused
    windows, cycle the slot back to 0, and land every window."""
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)

    def run(ici, sh, put, m, _faults):
        dist = ici.IciDistributor(sh, metrics=m, n_slots=2)
        slots = []
        outs = []
        for k in range(4):
            slots.append(dist._slot)
            outs.append(_value(dist.put(x + k, put)))
        return slots, dist._slot, outs, _counts(m)

    want, got = _both(run)
    assert got[:2] == want[:2] == ([0, 1, 0, 1], 0)
    for k, (g, w) in enumerate(zip(got[2], want[2])):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, x + k)
    assert got[3] == want[3] == (4, 4, 0)


def test_single_slot_distributor_never_counts_fused():
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)

    def run(ici, sh, put, m, _faults):
        dist = ici.IciDistributor(sh, metrics=m, n_slots=1)
        dist.put(x, put)
        dist.put(x, put)
        return dist._slot, dist.plan(x.shape, x.dtype).n_slots, _counts(m)

    want, got = _both(run)
    assert got == want == (0, 1, (2, 0, 0))


def test_latch_mid_fused_never_strands_in_flight_window():
    """An ICI_DMA_FAIL on window 2 with window 1's slot used: window 1 is
    intact, windows 2 and 3 take the plain route, the latch clears the
    slot tracking, and the fault does not use up the slot."""
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)

    def run(ici, sh, put, m, faults):
        dist = ici.IciDistributor(sh, metrics=m, n_slots=2)
        plan = faults.FaultPlan([faults.FaultSpec(
            "ici.fanout", faults.FaultKind.ICI_DMA_FAIL, at=2)])
        with faults.armed(plan):
            outs = [_value(dist.put(x + k, put)) for k in range(3)]
        return (outs, dist.faulted, dist._slot, dist._in_flight,
                _counts(m) + (m.gauge("ici.slots_in_flight"),))

    want, got = _both(run)
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, x + k)
    assert got[1:] == want[1:] == (True, 1, [], (1, 1, 1, 0.0))


def test_loader_ici_fault_at_window_3_counts_two_fused_windows():
    """The reference's loader case (``tests/test_faults.py``): a THREAD
    loader onto dp=8 with ``distribute="ici"`` and an ``ICI_DMA_FAIL`` at
    window 3 serves the pattern stream byte for byte; exactly the two
    windows before the fault rode the fused tier."""
    n_epochs = 6

    def drain(pkg, sharding, faults, m, **kw):
        plan = faults.FaultPlan([faults.FaultSpec(
            "ici.fanout", faults.FaultKind.ICI_DMA_FAIL, at=3)])

        @pkg.distributed_dataloader(n_producers=1, mode="thread")
        def main(env):
            loader = pkg.DistributedDataLoader(
                PatternProducer(pkg.__name__), batch_size=PATTERN_SHAPE[0],
                connection=env.connection, n_epochs=n_epochs,
                timeout_s=60.0, metrics=m, sharding=sharding,
                distribute="ici", **kw)
            windows = []
            for win in loader.windows():
                host = win.numpy() if isinstance(win, tmesh.ShardedArray) \
                    else win
                windows.append(np.array(host).reshape(PATTERN_SHAPE))
                loader.mark(pkg.Marker.END_OF_EPOCH)
            assert not loader._release_backlog  # nothing stranded
            return windows, loader._ingestor._ici

        with faults.armed(plan):
            windows, dist = main()
        assert plan.fired and plan.fired[0][1] == "ici_dma_fail"
        return windows, dist.faulted, _counts(m) + (
            m.gauge("ici.slots_in_flight"),)

    jmesh = JaxMesh(np.array(jax.devices()[:8]), ("dp",))
    want = drain(ddl_tpu, JaxSharding(jmesh, JaxP(None, "dp")), jfaults,
                 JaxMetrics(), output="jax")
    tsh_ = tmesh.NamedSharding(tmesh.make_mesh({"dp": 8}, ["cpu"] * 8),
                               tmesh.P(None, "dp"))
    got = drain(ddl_tpu_torch, tsh_, tfaults, Metrics(), output="device",
                device="cpu")
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        assert g.tobytes() == w.tobytes() == pattern(k + 1).tobytes()
    assert len(got[0]) == len(want[0]) == n_epochs
    assert got[1:] == want[1:] == (True, (2, 2, 1, 0.0))


# -- the exchange tickets ------------------------------------------------------


@pytest.mark.parametrize("slot", [0, 1])
@pytest.mark.parametrize("n,half,cols,round_", [(2, 3, 4, 0), (4, 2, 5, 3)])
def test_exchange_ticket_equals_plain_and_xla(n, half, cols, round_, slot):
    rng = np.random.default_rng(10 * n + slot)
    blocks = [rng.standard_normal((2 * half, cols)).astype(np.float32)
              for _ in range(n)]
    p = tsh.exchange_permutation(n, 7, round_)
    assert np.array_equal(p, jsh.exchange_permutation(n, 7, round_))
    devs = ["cpu"] * n
    gin = tdsh.as_exchange_input(blocks, devs)
    routes = np.stack([p, tsh.inverse_permutation(p)])
    plain = tdsh.exchange_plain(gin, routes)
    jdevs = tuple(jax.devices()[:n])
    jt = jdsh.exchange_start("xla", jdsh.as_exchange_input(blocks, jdevs),
                             jdevs, p, slot=slot)
    want = np.asarray(jdsh.exchange_wait(jt, sync=True))
    for impl in ("ring", "xla"):
        ticket = tdsh.exchange_start(impl, gin, devs, p, slot=slot)
        assert (ticket.impl, ticket.slot, ticket.done) == (impl, slot, None)
        out = tdsh.exchange_wait(ticket, sync=True)
        assert out is ticket.value
        assert torch.equal(out, plain)
        np.testing.assert_array_equal(out.numpy(), want)
        got = tdsh.exchange_output_blocks(out, devs)
        for i in range(n):
            np.testing.assert_array_equal(got[i], want[i * 2 * half:
                                                      (i + 1) * 2 * half])
    assert (jt.impl, jt.slot) == ("xla", slot)


def test_fabric_rounds_alternate_slots_and_equal_the_host_exchange(
        monkeypatch):
    """A two-instance drain through a CPU ``DeviceExchangeFabric`` serves
    the host exchange's rows; its rounds take slots 0, 1, 0, ... and
    every ticket is waited on."""
    import test_torch_shuffle as ts

    rdv, rdv2 = tsh.Rendezvous(), tsh.Rendezvous()
    host = ts.drain("torch", lambda: tsh.ThreadExchangeShuffler.factory(
        rendezvous=rdv, seed=3), epochs=4)
    started, waited = [], []
    real_start, real_wait = tdsh.exchange_start, tdsh.exchange_wait

    def start(impl, gin, devices, perm, *, slot=0):
        ticket = real_start(impl, gin, devices, perm, slot=slot)
        started.append(ticket)
        return ticket

    def wait(ticket, sync=False):
        waited.append((ticket, sync))
        return real_wait(ticket, sync)

    monkeypatch.setattr(tdsh, "exchange_start", start)
    monkeypatch.setattr(tdsh, "exchange_wait", wait)
    fabric = tsh.DeviceExchangeFabric(devices=["cpu"] * 2)
    dev = ts.drain("torch", lambda: tsh.DeviceExchangeShuffler.factory(
        rendezvous=rdv2, fabric=fabric, seed=3), epochs=4)
    for i in range(2):
        assert dev[i][0].tobytes() == host[i][0].tobytes()
    assert fabric.legs == len(started) >= 2
    assert [t.slot for t in started] == [r % 2 for r in range(len(started))]
    assert waited == [(t, True) for t in started]
