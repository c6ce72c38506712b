"""ddl-lint over the port: ``python -m tools.ddl_torch_check lint``.

- **TDL001 / TDL020** (the port's CUDA host-sync checks): a violating
  fixture fires its code and nothing else, a clean one stays quiet
  (``float(pending)``, ``Event.query()``, ``value_ready``, a
  ``_raise_on`` wrapper), and every spelling fires on its own.
- **The reference checks the port runs**: one fixture each, written with
  the port's names (``Trainer._fused_stream_loop``, ``_finish_shard``,
  ``ConsumerConnection.drain_acks`` ...), fires its code through the
  port's config; the JAX-only checks are the ones left out.
- **The config**: every function and class it names exists in the port,
  so a rename cannot drop a function out of the gate unseen.
- **The gate**: the port's package lints clean.
- **Isolation**: the tool imports neither JAX, nor the JAX package, nor
  the port, and the port imports nothing of ``tools``.
"""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # tools.* import under any pytest cwd
    sys.path.insert(0, str(REPO))

from tools.ddl_lint import ALL_CODES  # noqa: E402
from tools.ddl_torch_check import (  # noqa: E402
    JAX_ONLY,
    PORT_CODES,
    TORCH_CODES,
    lint,
    port_lint_config,
    torch_checks,
)


def write(tmp_path, snippet, name="mod.py"):
    path = tmp_path / name
    path.write_text(textwrap.dedent(snippet))
    return path


def codes_of(tmp_path, snippet):
    return sorted(f.code for f in lint([str(write(tmp_path, snippet))]))


# -- TDL020 / TDL001 ---------------------------------------------------------

TDL020_VIOLATION = """
    import torch

    class Trainer:
        def _fused_stream_loop(self, loader, stream, state, multi_for):
            for win in stream:
                state, losses = multi_for(win.shape[0])(state, win)
                torch.cuda.current_stream(win.device).synchronize()
                self.host_losses.append(losses.cpu())
            return state
"""

TDL020_CLEAN = """
    import torch

    class Trainer:
        def _fused_stream_loop(self, loader, stream, state, multi_for):
            pending = pending_done = None
            for win in stream:
                if pending_done is not None and not value_ready(
                        pending_done, True):
                    self.overlap += 1        # non-blocking probe
                if pending_done is not None and pending_done.query():
                    self.ready += 1          # Event.query(): no wait
                state, losses = multi_for(win.shape[0])(state, win)
                done = done_event(self.device)
                loader.gate_release_on(done)
                rows = int(win.shape[0])     # host metadata
                nbytes = float(win.numel() * win.element_size())
                mask = losses.any(dim=0)     # stays on the card
                if pending is not None:
                    self.epoch_losses.append(float(pending))  # deferred
                pending, pending_done = losses.mean(), done
            if pending is not None:
                self.epoch_losses.append(float(pending))
            return state, rows, nbytes, mask

        def _sync_stream_loop(self, stream, state, step):
            for win in stream:
                torch.cuda.synchronize()     # not a fused step function

    class IciDistributor:
        def _distribute_planned(self, block):
            if self._first:
                torch.cuda.current_stream(block.device).synchronize()  # ddl-lint: disable=TDL020 - bring-up validation, once per geometry
            return block
"""

TDL001_VIOLATION = """
    import torch

    class _Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            out = x * 2
            if out.isnan().any():
                raise ValueError("nan")
            return out

        @staticmethod
        def backward(ctx, g):
            return g * 2

    def fanout(block, devices):
        rc = _lib().ddl_fanout(block.data_ptr(), len(devices))
        _check(rc, block)
        fanout.launches += 1
        return block

    def _check(rc, block):
        torch.cuda.current_stream(block.device).synchronize()

    fanout.launches = 0
    KERNELS = (fanout,)
"""

TDL001_CLEAN = """
    import torch

    def _raise_on(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")

    def _stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def fanout_shard(block, devices, causal=True):
        rows, cols = block.shape
        if rows % len(devices):
            raise ValueError("rows must divide by the ring")
        blocks = [torch.empty((rows // len(devices), cols), dtype=block.dtype,
                              device=block.device) for _ in devices]
        _raise_on(_lib().ddl_fanout_shard(
            block.data_ptr(), len(blocks), int(bool(causal)),
            _stream(block)), "fan-out shard")
        fanout_shard.launches += 1
        return blocks

    class _Flash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q):
            out = q * 1.0
            ctx.save_for_backward(out)
            return out

        @staticmethod
        def backward(ctx, dout):
            (out,) = ctx.saved_tensors
            dout = dout.contiguous()
            if dout.data_ptr() % 16:
                dout = dout.clone()
            return dout * out

    def attention_plain(q):
        return float(q.sum().item())   # the plain version: no boundary

    fanout_shard.launches = 0
    KERNELS = (fanout_shard,)
"""


def test_tdl020_violation_fires_only_tdl020(tmp_path):
    assert codes_of(tmp_path, TDL020_VIOLATION) == ["TDL020", "TDL020"]


def test_tdl020_clean_counterpart_is_quiet(tmp_path):
    assert codes_of(tmp_path, TDL020_CLEAN) == []


def test_tdl001_violation_fires_only_tdl001(tmp_path):
    findings = lint([str(write(tmp_path, TDL001_VIOLATION))])
    assert [f.code for f in findings] == ["TDL001", "TDL001"]
    assert "autograd _Scale.forward" in findings[0].message
    assert "in _check(), called from it" in findings[1].message


def test_tdl001_clean_counterpart_is_quiet(tmp_path):
    assert codes_of(tmp_path, TDL001_CLEAN) == []


#: Every spelling of a CUDA host sync the two checks name.
SPELLINGS = [
    "torch.cuda.synchronize()",
    "torch.cuda.current_stream(x.device).synchronize()",
    "done.synchronize()",
    "self._stream.synchronize()",
    "y = x.item()",
    "y = x.tolist()",
    "y = x.cpu()",
    "y = x.numpy()",
    "y = x.to('cpu')",
    "y = x.to(device='cpu')",
    "y = x.to(torch.device('cpu'))",
    "y = x.to('cpu', torch.float64)",
    "y = float(x.mean())",
    "y = int(x.sum())",
    "y = bool(x[0])",
    "y = x.nonzero()",
    "y = torch.nonzero(x)",
    "y = torch.masked_select(x, x > 0)",
    "y = torch.unique(x)",
    "y = torch.where(x > 0)",
    "y = torch.equal(x, x)",
    "if x.isnan().any(): pass",
    "while (x > 0).all(): break",
    "assert torch.all(x > 0)",
    "y = 1 if x.any() else 0",
]

#: Look-alikes that read nothing from the card.
NOT_SYNCS = [
    "y = float(pending)",
    "y = float(self.loss)",
    "y = int(x.shape[0])",
    "y = int(x.numel())",
    "y = int(bool(causal))",
    "y = done.query()",
    "y = value_ready(done, True)",
    "y = x.to('cuda', non_blocking=True)",
    "y = x.to('cpu', non_blocking=True)",
    "y = x.any(dim=0)",
    "y = torch.where(x > 0, x, 0)",
    "y = np.unique(routes)",
    "y = x.to(torch.float32)",
]


def _fused(line):
    return ("class Trainer:\n"
            "    def _fused_stream_loop(self, x, done, pending, causal):\n"
            f"        {line}\n")


def _wrapper(line):
    return ("def fanout(x, done, pending, causal):\n"
            f"    {line}\n"
            "    fanout.launches += 1\n"
            "KERNELS = (fanout,)\n")


@pytest.mark.parametrize("line", SPELLINGS)
@pytest.mark.parametrize("code,shape", [("TDL020", _fused),
                                        ("TDL001", _wrapper)])
def test_each_spelling_fires(tmp_path, code, shape, line):
    path = write(tmp_path, shape(line))
    found = torch_checks([str(path)], port_lint_config())
    assert [f.code for f in found] == [code], line


@pytest.mark.parametrize("line", NOT_SYNCS)
@pytest.mark.parametrize("shape", [_fused, _wrapper])
def test_look_alikes_stay_quiet(tmp_path, shape, line):
    path = write(tmp_path, shape(line))
    assert torch_checks([str(path)], port_lint_config()) == [], line


def test_suppression_needs_the_right_code(tmp_path):
    line = "torch.cuda.synchronize()  # ddl-lint: disable=TDL001 - wrong code"
    assert codes_of(tmp_path, _fused(line)) == ["TDL020"]
    line = "torch.cuda.synchronize()  # ddl-lint: disable=TDL020 - once"
    assert codes_of(tmp_path, _fused(line)) == []


# -- the reference checks, with the port's names -----------------------------

PORT_VIOLATIONS = {
    "DDL004": """
        import time

        def wait_for_ring(path):
            while True:              # no deadline, no shutdown check
                if _exists(path):
                    break
                time.sleep(0.01)
    """,
    "DDL005": """
        import time

        class DataPusher:
            def push_data(self):
                while not self._ring.poll_fill_ready():
                    time.sleep(0.001)   # dead time per window
    """,
    "DDL006": """
        from ddl_tpu_torch.concurrency import named_lock

        _sweep_lock = named_lock("shuffle.sweep")
        _spill_lock = named_lock("cache.store.spill")

        def sweep():
            with _spill_lock:
                with _sweep_lock:       # inverts the declared order
                    pass
    """,
    "DDL007": """
        class Watchdog:
            def _poll(self, ring):
                try:
                    ring.stats()
                except Exception:       # swallows ShutdownRequested
                    pass
    """,
    "DDL008": """
        import ctypes

        lib = ctypes.CDLL("libshm_ring.so")
        lib.ddlr_create.restype = ctypes.c_void_p
        lib.ddlr_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                    ctypes.c_uint64]
        h = lib.ddlr_create(b"/ring", 2, 64)
        n = lib.ddlr_nslots(h)          # undeclared: c_int by default
    """,
    "DDL009": """
        import enum

        class FaultKind(enum.Enum):
            PRODUCER_CRASH = "producer_crash"
            PRODUCER_HANG = "producer_hang"
            CONTROL_MSG_DUP = "control_msg_dup"

        class FaultPlan:
            def _act(self, spec):
                kind = spec.kind
                if kind is FaultKind.PRODUCER_CRASH:
                    raise RuntimeError("crash")
                elif kind is FaultKind.PRODUCER_HANG:
                    return
                # CONTROL_MSG_DUP silently dropped
    """,
    "DDL011": """
        import numpy as np

        class DeviceIngestor:
            def put_batch(self, batch, splits):
                staged = np.array(batch, copy=True)  # fresh per-batch copy
                return self._transfer(staged)
    """,
    "DDL012": """
        class Watchdog:
            def stop(self):
                self._stop.set()
                self._thread.join()     # parks forever on a stuck poll
    """,
    "DDL013": """
        class StagingPool:
            def __init__(self):
                self._free = {}

            def release(self, key, buf):
                self._free[key] = buf   # grows, never evicts
    """,
    "DDL015": """
        import numpy as np

        class TokenStreamProducer:
            def _fill(self, my_ary):
                rows = self._rows()
                perm = self._rng.permutation(len(rows))
                np.copyto(my_ary, rows[perm])   # fancy-index temp + copy
    """,
    "DDL016": """
        import numpy as np

        def _finish_shard(ring_out, plan, sharding):
            host = np.asarray(ring_out.shards[0].data)  # D2H per window
            return host
    """,
    "DDL018": """
        import time

        class ClusterSupervisor:
            def _run(self):
                while self._live:
                    self.sweep()        # no deadline, no lease expiry
                    time.sleep(0.5)
    """,
    "DDL019": """
        class FairShareScheduler:
            def admit(self, name, timeout_s):
                for t in self._tenants.values():
                    t.granted.wait(0.05)   # per-tenant wait fan-out
    """,
    "DDL020": """
        class Trainer:
            def _fused_stream_loop(self, loader, stream, state, multi_for):
                for win in stream:
                    state, losses = multi_for(win.shape[0])(state, win)
                    self.epoch_losses.append(float(losses.mean()))  # sync
                return state
    """,
    "DDL021": """
        class ThreadExchangeShuffler:
            def _encode_lane(self, rows):
                raw = decode_window(rows, None, rows.shape, "f4", "int8")
                return pack_rows(raw, "int8")   # decode-then-requantize
    """,
    "DDL022": """
        class AsyncCheckpointer:
            def _write_generation(self, path, blob):
                with open(path, "wb") as f:    # torn on a mid-write crash
                    f.write(blob)
    """,
    "DDL023": """
        import collections

        class SpanLog:
            def __init__(self):
                self._events = collections.deque()   # no maxlen

            def record(self, ev):
                self._events.append(ev)
    """,
    "DDL024": """
        import threading

        class StagingPool:
            def __init__(self):
                self._lock = threading.Lock()   # invisible to LOCK_ORDER
    """,
    "DDL025": """
        class ConsumerConnection:
            def request_replay(self, target, seq):
                self.send_control(target, ReplayRequest(seq=seq))  # raw
    """,
    "DDL026": """
        class Autoscaler:
            def step(self):
                self.controller.scheduler.note_served("t0", 1 << 20)
    """,
    "DDL027": """
        class Trainer:
            def fit(self, producer, *, prefetch_depth=8):   # pins the knob
                return producer
    """,
}

#: Codes a port fixture fires beside its own: the fused step's scalar
#: read-back is both the reference's DDL020 and the port's TDL020.
EXTRA = {"DDL020": ["TDL020"]}


def test_every_enabled_reference_check_has_a_port_fixture():
    assert sorted(PORT_VIOLATIONS) == sorted(PORT_CODES)
    assert sorted(PORT_CODES + tuple(JAX_ONLY)) == sorted(ALL_CODES)
    assert all(why for why in JAX_ONLY.values())
    assert TORCH_CODES == ("TDL001", "TDL020")


@pytest.mark.parametrize("code", sorted(PORT_VIOLATIONS))
def test_reference_check_fires_with_port_names(tmp_path, code):
    got = codes_of(tmp_path, PORT_VIOLATIONS[code])
    assert got == sorted([code] + EXTRA.get(code, [])), got


@pytest.mark.parametrize("code", sorted(JAX_ONLY))
def test_jax_only_checks_are_not_run(code):
    cfg = port_lint_config()
    assert code not in cfg.enabled_codes()


def _port_defs():
    names = set()
    for path in (REPO / "ddl_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                names.add(node.name)
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        names.add(f"{node.name}.{m.name}")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
    return names


_NAME_LISTS = [
    "hot_path_classes", "ingest_hot_path_functions",
    "producer_fill_functions", "device_path_functions",
    "train_step_functions", "cluster_loop_functions",
    "serve_loop_functions", "fused_step_functions", "wire_path_functions",
    "checkpoint_write_functions", "control_send_functions",
    "fabric_admission_functions", "obs_event_buffer_classes",
    "per_sample_hot_functions", "tuned_knob_functions",
]


@pytest.mark.parametrize("field", _NAME_LISTS)
def test_config_names_exist_in_the_port(field):
    defs = _port_defs()
    names = getattr(port_lint_config(), field)
    assert names
    assert [n for n in names if n not in defs] == []


def test_config_modules_exist_in_the_port():
    for mod in port_lint_config().lock_factory_modules:
        assert (REPO / mod).is_file(), mod


# -- the gate -----------------------------------------------------------------


def test_port_lints_clean():
    findings = lint()
    assert [f.render() for f in findings] == []


def test_cli_exit_codes(tmp_path):
    bad = write(tmp_path, TDL020_VIOLATION, "bad.py")
    good = write(tmp_path, TDL020_CLEAN, "good.py")

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "tools.ddl_torch_check", *args],
            capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
            env=dict(os.environ, PYTHONPATH=str(REPO)))

    out = run("lint", str(bad))
    assert out.returncode == 1
    assert re.search(r"bad\.py:\d+:\d+: TDL020 ", out.stdout)
    assert out.stdout.strip().endswith("ddl-lint: 2 finding(s)")
    assert run("lint", str(good)).returncode == 0
    assert run("lint", str(tmp_path / "missing")).returncode == 2


# -- isolation ------------------------------------------------------------------

_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import tools.ddl_torch_check as t
t.lint([sys.argv[2]])
t.verify([sys.argv[2]])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "ddl_tpu", "ddl_tpu_torch", "torch"))
print(json.dumps(bad))
"""


def test_tool_imports_neither_jax_nor_either_package(tmp_path):
    path = write(tmp_path, TDL020_VIOLATION)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE, str(REPO), str(path)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_imports_nothing_of_tools():
    pattern = re.compile(r"^\s*(import|from)\s+tools(\.|\s|$)", re.MULTILINE)
    hits = [p.relative_to(REPO).as_posix()
            for p in sorted((REPO / "ddl_tpu_torch").rglob("*.py"))
            if pattern.search(p.read_text())]
    assert hits == []
