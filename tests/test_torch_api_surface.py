"""The port's public surface against the JAX package's, module by module.

For every ``MANIFEST`` pair the reference module is read by AST: each
public module-level function, class, constant and annotated name, each
public method, class attribute and dataclass field of its public
classes, and each parameter of those functions and methods
(``__init__`` included).  Each must exist in the port module (imported,
so a re-export counts) with the same parameter name, unless
:data:`ALLOWLIST` names it with the reason the port differs on purpose.
An allowlist entry the port has since gained fails too, so the list
stays exact.

The rest holds the behaviours of the names this surface gained to the
reference on the same inputs: the loader's ``epoch`` and
``batches_per_window``, ``DeviceIngestor.put`` and its copy rule,
``measure_h2d_bandwidth``, ``CacheStore.get_or_load`` / ``stats`` and
``CacheWarmer.should_abort``, the envspec table and its export groups,
the staging defaults, the config presets, the types' properties, the
logging utilities, ``DeviceExchangeShuffler.factory(shuffle_impl=)``,
``param_spec_tree``, and ``Trainer.evaluate`` over a mesh, which lands
its batches sharded as ``fit`` does.
"""

import ast
import dataclasses
import importlib
import inspect
import logging
import os
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ddl_tpu_torch._manifest import MANIFEST

REPO = pathlib.Path(__file__).resolve().parent.parent

_JAX_ONLY_KEY = ("the PRNG key: the port's inits take seed= and its "
                 "sampling a torch.Generator (generator=)")
_INTERPRET = ("Pallas interpret mode: a CUDA kernel has none; on a CPU "
              "tensor every wrapper runs its plain version")
_BLOCKS = ("Pallas block sizes: the CUDA kernels fix their tiles per "
           "route (128 x 128 forward, 64 x 128 dK/dV)")
_DONATE = ("jit buffer donation: the torch step updates its params in "
           "place")
_OPTAX = ("optax-shaped state: the port steps a torch.optim optimizer, "
          "which holds its own state")
_REMAT = ("the port's selective policy keeps the attention output without "
          "a checkpoint_name tag (ddl_tpu_torch/models/remat.py)")
_QAR = ("a shard_map body's per-device value and axis: the port's "
        "quantized_all_reduce takes every position's contribution (xs)")

#: (reference file, qualified name, parameter or None) -> why the port
#: differs on purpose.
ALLOWLIST = {
    ("models/llama.py", "init_params", "key"): _JAX_ONLY_KEY,
    ("models/llama.py", "generate", "key"): _JAX_ONLY_KEY,
    ("models/moe.py", "init_params", "key"): _JAX_ONLY_KEY,
    ("models/moe.py", "generate", "key"): _JAX_ONLY_KEY,
    ("models/pointnet.py", "init_params", "key"): _JAX_ONLY_KEY,
    ("models/vit.py", "init_params", "key"): _JAX_ONLY_KEY,
    ("models/remat.py", "ATTN_OUT_NAME", None): _REMAT,
    ("models/remat.py", "tag_attn_out", None): _REMAT,
    ("ops/flash_attention.py", "flash_attention", "block_q"): _BLOCKS,
    ("ops/flash_attention.py", "flash_attention", "block_k"): _BLOCKS,
    ("ops/flash_attention.py", "flash_attention", "interpret"): _INTERPRET,
    ("ops/flash_attention.py", "flash_attention_with_lse", "block_q"):
        _BLOCKS,
    ("ops/flash_attention.py", "flash_attention_with_lse", "block_k"):
        _BLOCKS,
    ("ops/flash_attention.py", "flash_attention_with_lse", "interpret"):
        _INTERPRET,
    ("ops/ici_fanout.py", "interpret_default", None): _INTERPRET,
    ("ops/ici_fanout.py", "fanout_replicate", "interpret"): _INTERPRET,
    ("ops/ici_fanout.py", "fanout_shard", "interpret"): _INTERPRET,
    ("ops/ici_fanout.py", "fanout_replicate", "n_chunks"): (
        "the Pallas ring moves a block in DMA chunks; K7's grid copies "
        "whole rows, so there is no chunk count to pick"),
    ("ops/ici_fanout.py", "fanout_start", "n_chunks"): (
        "the Pallas ring moves a block in DMA chunks; K7's grid copies "
        "whole rows, so there is no chunk count to pick"),
    ("ops/ici_fanout.py", "fanout_start", "interpret"): _INTERPRET,
    ("ops/device_shuffle.py", "exchange_ring", "interpret"): _INTERPRET,
    ("ops/device_shuffle.py", "exchange_start", "interpret"): _INTERPRET,
    ("parallel/collectives.py", "quantized_all_reduce", "x"): _QAR,
    ("parallel/collectives.py", "quantized_all_reduce", "axis_name"): _QAR,
    ("parallel/collectives.py", "quantized_all_reduce", "axis_size"): _QAR,
    ("parallel/ici.py", "DistributionPlan.ring_devices", None): (
        "the plan's TPU device objects: the port's plan names mesh "
        "positions of one card"),
    ("parallel/ici.py", "IciDistributor.__init__", "interpret"): _INTERPRET,
    ("parallel/optimizer.py", "ShardedOptimizer.update", None): _OPTAX,
    ("parallel/optimizer.py", "state_bytes_per_replica", "state"): _OPTAX,
    ("parallel/train.py", "TrainState.opt_state", None): _OPTAX,
    ("parallel/train.py", "make_train_step", "donate"): _DONATE,
    ("parallel/train.py", "make_multistep", "donate"): _DONATE,
    ("shuffle.py", "DeviceExchangeFabric.__init__", "interpret"): _INTERPRET,
}


# -- the AST sweep --------------------------------------------------------------


def _public(name):
    return not name.startswith("_")


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def reference_surface(path):
    """``[(qualified name, parameters or None)]`` of a reference module."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out.append((node.name, _params(node)))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.append((node.name, None))
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if sub.name == "__init__" or _public(sub.name):
                        out.append((f"{node.name}.{sub.name}", _params(sub)))
                elif (isinstance(sub, ast.AnnAssign)
                      and isinstance(sub.target, ast.Name)
                      and _public(sub.target.id)):
                    out.append((f"{node.name}.{sub.target.id}", None))
                elif isinstance(sub, ast.Assign):
                    out.extend((f"{node.name}.{t.id}", None)
                               for t in sub.targets
                               if isinstance(t, ast.Name) and _public(t.id))
        elif isinstance(node, ast.Assign):
            out.extend((t.id, None) for t in node.targets
                       if isinstance(t, ast.Name) and _public(t.id))
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)
              and _public(node.target.id)):
            out.append((node.target.id, None))
    return out


_MISSING = object()


def _resolve(mod, qual):
    """The port's object for ``qual``, ``"field"`` for a dataclass field
    without a class attribute, or ``_MISSING``."""
    obj = mod
    for part in qual.split("."):
        if part == "__init__":
            return obj.__init__
        if hasattr(obj, part):
            obj = getattr(obj, part)
            continue
        fields = getattr(obj, "__dataclass_fields__", {})
        annotated = {k for c in getattr(obj, "__mro__", ())
                     for k in getattr(c, "__annotations__", {})}
        return "field" if part in fields or part in annotated else _MISSING
    return obj


def _pairs():
    return sorted((ref, port) for ref, port in MANIFEST.items()
                  if ref.endswith(".py") and port.startswith("ddl_tpu_torch/"))


def missing_in_port(ref, port):
    modname = port[:-3].replace("/", ".")
    if modname.endswith(".__init__"):
        modname = modname[: -len(".__init__")]
    mod = importlib.import_module(modname)
    missing = []
    for qual, params in reference_surface(REPO / "ddl_tpu" / ref):
        obj = _resolve(mod, qual)
        if obj is _MISSING:
            missing.append((ref, qual, None))
            continue
        if params is None or isinstance(obj, str):
            continue
        try:
            have = set(inspect.signature(obj).parameters)
        except (TypeError, ValueError):
            continue
        missing.extend((ref, qual, p) for p in params if p not in have)
    return missing


@pytest.mark.parametrize("ref,port", _pairs(), ids=[r for r, _ in _pairs()])
def test_port_module_has_the_reference_public_api(ref, port):
    missing = missing_in_port(ref, port)
    unexplained = [m for m in missing if m not in ALLOWLIST]
    assert unexplained == []
    stale = [k for k in ALLOWLIST if k[0] == ref and k not in missing]
    assert stale == []


def test_allowlist_entries_carry_a_reason():
    assert len(_pairs()) == 76  # every .py of the JAX package but _compat.py
    for key, reason in ALLOWLIST.items():
        assert (REPO / "ddl_tpu" / key[0]).is_file(), key
        assert isinstance(reason, str) and len(reason) > 30, key


def test_sweep_sees_a_name_the_port_lacks(tmp_path, monkeypatch):
    """The sweep reports a removed name and a removed parameter (its own
    control: an empty report is not a blind sweep)."""
    import ddl_tpu_torch.types as ttypes

    monkeypatch.delattr(ttypes, "WindowSpec")
    monkeypatch.delattr(ttypes.Topology, "world_size")
    missing = missing_in_port("types.py", "ddl_tpu_torch/types.py")
    assert ("types.py", "WindowSpec", None) in missing
    assert ("types.py", "Topology.world_size", None) in missing
    got = missing_in_port("trainer.py", "ddl_tpu_torch/trainer.py")
    assert got == []
    monkeypatch.setattr(
        __import__("ddl_tpu_torch.trainer").trainer.Trainer, "evaluate",
        lambda self, producer_function, state: 0.0)
    got = missing_in_port("trainer.py", "ddl_tpu_torch/trainer.py")
    assert ("trainer.py", "Trainer.evaluate", "output") in got


# -- the loader's epoch --------------------------------------------------------


def _drain_one_epoch(pkg, **loader_kw):
    class Rows(pkg.ProducerFunctionSkeleton):
        def on_init(self, producer_idx=0, **kw):
            self.idx = producer_idx
            return pkg.DataProducerOnInitReturn(
                nData=8 * (1 + producer_idx), nValues=3,
                shape=(8 * (1 + producer_idx), 3), splits=(3,),
                dtype=np.float32)

        def post_init(self, my_ary, **kw):
            my_ary[:] = self.idx

        def execute_function(self, my_ary, **kw):
            my_ary += 1

    @pkg.distributed_dataloader(n_producers=2, mode="thread")
    def main(env):
        loader = pkg.DistributedDataLoader(
            Rows(), batch_size=4, connection=env.connection, n_epochs=3,
            output="numpy", **loader_kw)
        seen = [(loader.epoch, loader.batches_per_window)]
        for _ in range(2):
            for _b in loader:
                loader.mark(pkg.Marker.END_OF_BATCH)
            loader.mark(pkg.Marker.END_OF_EPOCH)
            seen.append((loader.epoch, loader.batches_per_window))
        loader.shutdown()
        return seen

    return main()


def test_loader_epoch_and_batches_per_window_match():
    import ddl_tpu
    import ddl_tpu_torch

    want = _drain_one_epoch(ddl_tpu)
    got = _drain_one_epoch(ddl_tpu_torch, device="cpu")
    assert got == want
    assert [e for e, _ in got] == [0, 1, 2]


# -- DeviceIngestor.put and the link measurement ---------------------------------


@pytest.mark.parametrize("staged", [True, False])
def test_ingestor_put_values_and_copy_rule(staged):
    from ddl_tpu.ingest import DeviceIngestor as JaxIngestor
    from ddl_tpu_torch.ingest import DeviceIngestor
    from ddl_tpu_torch.observability import Metrics

    slot = np.random.default_rng(3).standard_normal((6, 5)).astype(np.float32)
    ints = np.arange(12, dtype=np.int32).reshape(6, 2)
    cols = (slot[:, :2], slot[:, 2:], ints)
    want = [np.asarray(c) for c in JaxIngestor(staged=staged).put(cols)]
    ing = DeviceIngestor(device="cpu", staged=staged, metrics=Metrics())
    got = ing.put(cols)
    # The slot is overwritten right after put: the results keep its
    # values (each column was copied out first).
    slot[...] = -7.0
    ints[...] = -7
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.numpy().tobytes() == w.tobytes()
    assert ing.metrics.counter("ingest.batches") == 1
    assert ing.metrics.counter("ingest.bytes") == 6 * 5 * 4 + 12 * 4
    if staged:
        assert ing.engine().pool is not None
    ing.close()


def test_measure_h2d_bandwidth_cpu_and_no_card():
    from ddl_tpu_torch.ingest import measure_h2d_bandwidth

    rate = measure_h2d_bandwidth(nbytes=1 << 20, device="cpu", trials=2)
    assert np.isfinite(rate) and rate > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            measure_h2d_bandwidth(nbytes=1 << 10)
    params = inspect.signature(measure_h2d_bandwidth).parameters
    assert (params["nbytes"].default, params["device"].default,
            params["trials"].default) == (1 << 26, None, 3)


# -- the shard cache ----------------------------------------------------------


def _cache_run(store_mod, Metrics, spill_dir):
    m = Metrics()
    store = store_mod.CacheStore(ram_budget_bytes=3 * 400, spill_dir=spill_dir,
                                 metrics=m)
    loads = []

    def loader(i):
        def load():
            loads.append(i)
            return np.full(100, i, np.float32)  # 400 bytes
        return load

    keys = [store_mod.CacheKey(f"src{i}", f"s{i}", "r") for i in range(5)]
    served = [store.get_or_load(keys[i], loader(i))
              for i in (0, 1, 0, 2, 3, 4, 0, 1)]
    counters = {k: m.counter(k) for k in
                ("cache.hits", "cache.misses", "cache.evictions",
                 "cache.spills", "cache.spill_hits")}
    return served, loads, counters, store.stats()


def test_cache_get_or_load_and_stats_match(tmp_path):
    from ddl_tpu.cache import store as jstore
    from ddl_tpu.observability import Metrics as JMetrics
    from ddl_tpu_torch.cache import store as tstore
    from ddl_tpu_torch.observability import Metrics

    want = _cache_run(jstore, JMetrics, str(tmp_path / "j"))
    got = _cache_run(tstore, Metrics, str(tmp_path / "t"))
    assert [a.tobytes() for a in got[0]] == [a.tobytes() for a in want[0]]
    assert got[1:] == want[1:]
    assert got[3]["entries"] == 3.0 and got[3]["spill_bytes"] > 0


def test_cache_warmer_should_abort(tmp_path):
    from ddl_tpu_torch.cache.store import CacheStore
    from ddl_tpu_torch.cache.warmer import CacheWarmer
    from ddl_tpu_torch.observability import Metrics

    warmer = CacheWarmer(CacheStore(metrics=Metrics()), [])
    assert warmer.should_abort() is False
    assert warmer.close()
    assert warmer.should_abort() is True


# -- envspec ------------------------------------------------------------------


def _rows(table, prefix):
    """The table's knob rows as (name without prefix, type, default,
    export mirror) — the doc column is each package's own text."""
    rows = []
    for line in table.splitlines():
        if not line.startswith("| `"):
            continue
        cells = [c.strip() for c in line.strip("|").split(" | ")]
        name = cells[0].strip("`")
        assert name.startswith(prefix), name
        rows.append((name[len(prefix):], cells[1], cells[2],
                     cells[3].replace("`_export_", "`export_")))
    return rows


def test_envspec_render_table_matches_the_reference():
    from ddl_tpu import envspec as jenv
    from ddl_tpu_torch import envspec as tenv

    want = _rows(jenv.render_table(), "DDL_TPU_")
    got = _rows(tenv.render_table(), "DDL_TORCH_")
    mapped = {v[len("DDL_TORCH_"):] for v in tenv.KNOB_MAP.values()
              if v.startswith("DDL_TORCH_")}
    # The output knob's default is each package's device value.
    want = [(n, t, "'device'" if n == "OUTPUT" else d, e)
            for n, t, d, e in want if n in mapped]
    assert got == want
    table = tenv.render_table()
    assert table.startswith("# Environment knobs\n")
    assert table.endswith(f"{len(tenv.REGISTRY)} registered knobs "
                          "(config-derived families included).\n")


@pytest.mark.parametrize("group", ["cluster", "cache", "wire", "shuffle"])
def test_envspec_export_groups_match_the_reference(group):
    from ddl_tpu import envspec as jenv
    from ddl_tpu_torch import envspec as tenv

    want = sorted(tenv.KNOB_MAP[k.name] for k in jenv.export_group(group))
    got = sorted(k.name for k in tenv.export_group(group))
    assert got == want and got


def test_envspec_validate_and_external():
    from ddl_tpu import envspec as jenv
    from ddl_tpu_torch import envspec as tenv

    jenv.validate()
    tenv.validate()
    ext = {k.name for k in tenv.REGISTRY.values() if k.external}
    want = {tenv.KNOB_MAP[k.name] for k in jenv.REGISTRY.values()
            if k.external and tenv.KNOB_MAP[k.name].startswith("DDL_TORCH_")}
    assert ext == want
    broken = dataclasses.replace(tenv.REGISTRY["DDL_TORCH_NSLOTS"], default=3)
    reg = dict(tenv.REGISTRY, DDL_TORCH_NSLOTS=broken)
    orig = tenv.REGISTRY
    tenv.REGISTRY = reg
    try:
        with pytest.raises(AssertionError, match="DDL_TORCH_NSLOTS default"):
            tenv.validate()
    finally:
        tenv.REGISTRY = orig


def test_staging_defaults_are_the_reference_values_and_knob_defaults():
    from ddl_tpu import staging as jstaging
    from ddl_tpu_torch import envspec as tenv
    from ddl_tpu_torch import staging as tstaging

    for name, knob in (("DEFAULT_POOL_CAP", "DDL_TORCH_STAGING_POOL_CAP"),
                       ("DEFAULT_QUEUE_DEPTH", "DDL_TORCH_STAGING_QUEUE"),
                       ("DEFAULT_MAX_RETRIES", "DDL_TORCH_STAGING_RETRIES")):
        assert getattr(tstaging, name) == getattr(jstaging, name)
        assert tenv.REGISTRY[knob].default == getattr(tstaging, name)


# -- configs, types and utils ---------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "llama_4b", "llama3_8b"])
def test_llama_presets_match_the_reference(preset):
    from ddl_tpu.models import llama as jllama
    from ddl_tpu_torch.models import llama as tllama

    want = getattr(jllama.LlamaConfig, preset)()
    got = getattr(tllama.LlamaConfig, preset)()
    for f in ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq", "rope_theta", "norm_eps", "attn_impl"):
        assert getattr(got, f) == getattr(want, f), f
    if preset == "llama_4b":
        n = sum(t.numel() for t in jax.tree.leaves(tllama.param_shapes(got)))
        assert 4.4e9 < n < 4.8e9


def test_types_properties_match_the_reference():
    import ddl_tpu.types as jt
    import ddl_tpu_torch.types as tt

    for kw in ({}, {"n_instances": 3, "instance_idx": 1, "n_producers": 4}):
        assert tt.Topology(**kw).world_size == jt.Topology(**kw).world_size
    assert tt.DDL_Env(tt.Topology(), None).is_consumer is True
    for shape, dtype, bs in (((64, 5), np.float32, 8), ((30, 2), np.int32, 4)):
        j = jt.WindowSpec(shape, np.dtype(dtype), (shape[1],), bs)
        t = tt.WindowSpec(shape, np.dtype(dtype), (shape[1],), bs)
        assert (t.nbytes, t.batches_per_window) == (
            j.nbytes, j.batches_per_window)


def test_env_flag_reads_the_torch_twin(monkeypatch):
    from ddl_tpu import utils as jutils
    from ddl_tpu_torch import envspec as tenv
    from ddl_tpu_torch import utils as tutils

    for val in ("0", "off", "FALSE", "no", "1", ""):
        monkeypatch.setenv("DDL_TPU_INTEGRITY", val)
        monkeypatch.setenv("DDL_TORCH_INTEGRITY", val)
        assert tutils.env_flag("DDL_TORCH_INTEGRITY") == jutils.env_flag(
            "DDL_TPU_INTEGRITY"), val
    assert tutils.env_flag("DDL_TORCH_INTEGRITY", override=False) is False
    with pytest.raises(tenv.UnknownKnobError):
        tutils.env_flag("DDL_TORCH_NOT_A_KNOB")
    assert tutils.logger.name == "ddl_tpu_torch"


def test_with_logging_and_for_all_methods(caplog):
    from ddl_tpu_torch import utils as tutils

    @tutils.for_all_methods(tutils.with_logging(tag="t."), exclude=("skip",))
    class Box:
        def add(self, a, b=1):
            return a + b

        def fail(self):
            raise KeyError("x")

        def skip(self):
            return "s"

        def __len__(self):
            return 2

    box = Box()
    with caplog.at_level(logging.INFO, logger="ddl_tpu_torch"):
        assert box.add(2) == 3
    assert caplog.records == []
    with caplog.at_level(logging.DEBUG, logger="ddl_tpu_torch"):
        assert box.add(2, b=5) == 7
        with pytest.raises(KeyError):
            box.fail()
        assert box.skip() == "s" and len(box) == 2
    msgs = [r.getMessage() for r in caplog.records]
    q = f"t.{Box.__qualname__}"
    assert msgs[0] == f"-> {q}.add args=(2,) kwargs={{'b': 5}}"
    assert msgs[1].startswith(f"<- {q}.add = 7 (")
    assert msgs[2] == f"-> {q}.fail args=() kwargs={{}}"
    assert msgs[3].startswith(f"!! {q}.fail raised KeyError('x') after ")
    assert len(msgs) == 4
    assert Box.add.__name__ == "add"


def test_device_shuffler_factory_takes_shuffle_impl(monkeypatch):
    from ddl_tpu_torch import shuffle as tshuffle

    built = []
    monkeypatch.setattr(
        tshuffle, "DeviceExchangeFabric",
        lambda devices=None, impl=None: built.append(impl)
        or types.SimpleNamespace(impl=impl))
    fac = tshuffle.DeviceExchangeShuffler.factory(shuffle_impl="xla", seed=4)
    assert built == ["xla"] and fac.fabric.impl == "xla"
    assert fac.seed == 4


def test_param_spec_tree_is_param_specs():
    from ddl_tpu_torch.parallel.mesh import P, make_mesh
    from ddl_tpu_torch.parallel.optimizer import Zero1Optimizer
    from ddl_tpu_torch.parallel.train import adamw, make_multistep
    from ddl_tpu_torch.parallel.train import make_train_step

    mesh = make_mesh({"dp": 2}, ["cpu"] * 2)
    specs = {"w": P("dp")}
    for make in (make_train_step, make_multistep):
        for kw in ({"param_specs": specs}, {"param_spec_tree": specs}):
            init, _ = make(lambda p, b: (p["w"] * b[0]).sum(), adamw(1e-2),
                           mesh=mesh, optimizer_sharding="zero1", **kw)
            state = init({"w": torch.ones(4)})
            assert isinstance(state.optimizer, Zero1Optimizer)
        with pytest.raises(ValueError, match="not both"):
            make(lambda p, b: 0, adamw(1e-2), mesh=mesh, param_specs=specs,
                 param_spec_tree=specs)


# -- Trainer.evaluate over a mesh ------------------------------------------------

SEQ, ROWS, BATCH = 16, 8, 4


@pytest.fixture(scope="module")
def llama_setup(tmp_path_factory):
    from ddl_tpu.models import llama as jllama

    cfg = dict(vocab=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
               d_ff=64, max_seq=SEQ)
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **cfg)
    path = os.path.join(tmp_path_factory.mktemp("tok"), "tokens.bin")
    np.random.default_rng(5).integers(0, 64, 8_000, dtype=np.int32).tofile(path)
    params = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(2)))
    return path, params, cfg, jcfg


@pytest.mark.parametrize("window_stream", [True, False])
def test_mesh_evaluate_matches_the_reference(llama_setup, window_stream,
                                             monkeypatch):
    from ddl_tpu.models import llama as jllama
    from ddl_tpu.parallel.mesh import make_mesh as jmake_mesh
    from ddl_tpu.readers import TokenStreamProducer as JaxTokens
    from ddl_tpu.trainer import Trainer as JaxTrainer
    from ddl_tpu_torch.models import llama as tllama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel import train as ttrain
    from ddl_tpu_torch.parallel.mesh import P, ShardedArray, make_mesh
    from ddl_tpu_torch.readers import TokenStreamProducer as TorchTokens
    from ddl_tpu_torch.trainer import Trainer

    path, params, cfg, jcfg = llama_setup
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **cfg)
    jmesh = jmake_mesh({"dp": 2}, devices=jax.local_devices()[:2])
    jtrainer = JaxTrainer(
        loss_fn=lambda p, b: jllama.next_token_loss(p, b[0], jcfg),
        optimizer=optax.adamw(1e-3), mesh=jmesh,
        param_specs=jllama.param_specs(jcfg),
        init_params=jax.tree.map(jnp.asarray, params),
        batch_spec=JP(("dp",)), watchdog=False,
    )
    want = jtrainer.evaluate(
        JaxTokens(path, SEQ, ROWS, seed=7),
        jtrainer._init_fn(jtrainer._init_params),
        lambda p, b: jllama.next_token_loss(p, b[0], jcfg),
        batch_size=BATCH, n_producers=2, n_epochs=2, output="jax",
        window_stream=window_stream,
    )

    mesh = make_mesh({"dp": 2}, ["cpu"] * 2)
    trainer = Trainer(
        lambda p, b: tllama.next_token_loss(p, b[0], tcfg, mesh=mesh),
        ttrain.adamw(1e-3), tllama.params_from_numpy(params, device="cpu"),
        device="cpu", mesh=mesh, param_specs=tllama.param_specs(tcfg),
        batch_spec=P(("dp",)), watchdog=False, metrics=Metrics(),
    )
    landed = []
    real_global = ttrain._global

    def spy(batch):
        leaves = batch if isinstance(batch, (tuple, list)) else (batch,)
        landed.extend(leaves)
        return real_global(batch)

    monkeypatch.setattr(ttrain, "_global", spy)
    got = trainer.evaluate(
        TorchTokens(path, SEQ, ROWS, seed=7),
        trainer._init_fn(trainer._init_params),
        lambda p, b: tllama.next_token_loss(p, b[0], tcfg, mesh=mesh),
        batch_size=BATCH, n_producers=2, n_epochs=2, output="device",
        window_stream=window_stream,
    )
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # Landed sharded over dp: each position holds 1/dp of the rows.
    assert landed and all(isinstance(a, ShardedArray) for a in landed)
    row_dim = 1 if window_stream else 0
    for a in landed:
        assert len(a.shards) == 2
        for s in a.shards:
            assert s.data.shape[row_dim] == a.shape[row_dim] // 2


def test_fit_output_numpy_matches_device_output(llama_setup):
    """``fit(output="numpy")`` serves host batches that each step copies
    to the device: the same losses as device output (``"jax"`` is the
    JAX package's name of it)."""
    from ddl_tpu_torch.config import LoaderConfig
    from ddl_tpu_torch.models import llama as tllama
    from ddl_tpu_torch.observability import Metrics
    from ddl_tpu_torch.parallel.train import adamw
    from ddl_tpu_torch.readers import TokenStreamProducer as TorchTokens
    from ddl_tpu_torch.trainer import Trainer

    path, params, cfg, _ = llama_setup
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **cfg)
    runs = []
    for output in ("device", "numpy", "torch", "jax"):
        trainer = Trainer(
            lambda p, b: tllama.next_token_loss(p, b[0], tcfg),
            adamw(1e-3), tllama.params_from_numpy(params, device="cpu"),
            device="cpu", watchdog=False, metrics=Metrics())
        runs.append(trainer.fit(
            TorchTokens(path, SEQ, ROWS), batch_size=BATCH, n_epochs=2,
            n_producers=2, mode="thread", output=output, prefetch_depth=1,
        ).losses)
    assert runs[1] == runs[0] and runs[2] == runs[0] and runs[3] == runs[0]
    with pytest.raises(ValueError, match="window_stream requires"):
        Trainer(lambda p, b: 0, adamw(1e-3), {"w": torch.ones(1)},
                device="cpu").fit(TorchTokens(path, SEQ, ROWS),
                                  batch_size=BATCH, n_epochs=1,
                                  output="numpy", window_stream=True)
