"""The port's checkpoints against the JAX package's.

- The reference's ``TestAsyncCheckpointer`` and
  ``TestLegacyCheckpointVerification`` cases (``tests/test_resilience.py``)
  against the port: round trip, keep-K, backpressure, the forced
  checkpoint, truncation, renamed and corrupted generations, cold starts,
  writer failures, geometry changes, the manifest-verified synchronous
  path and the atomic write.  The reference's chaos-site case waits for
  ``faults.py``; a hand-truncated generation covers its fallback here.
- ``LoaderCheckpoint`` JSON equals the reference's byte for byte, with
  and without a cache manifest; a manifest either package wrote is
  adopted by the other, and one that cannot be adopted resumes cold.
- A generation serialized by both packages from the same tiny Llama train
  state (params and AdamW moments at step 3, in the reference's leaf
  order, which the test derives from ``jax.tree_util``) is byte-identical,
  and each package restores the other's with equal values.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl_tpu import checkpoint as jckpt
from ddl_tpu.models import llama as jllama
from ddl_tpu.parallel.train import TrainState as JaxTrainState
from ddl_tpu.resilience import ckpt as jres
from ddl_tpu_torch import checkpoint as tckpt
from ddl_tpu_torch.exceptions import CheckpointError
from ddl_tpu_torch.models import llama as tllama
from ddl_tpu_torch.observability import Metrics
from ddl_tpu_torch.parallel.train import adamw, make_train_step, tree_leaves
from ddl_tpu_torch.resilience import (
    AsyncCheckpointer,
    latest_verified_generation,
    list_generations,
    restore_latest,
    serialize_generation,
)
from ddl_tpu_torch.resilience.ckpt import train_state_leaves

JCFG = jllama.LlamaConfig(vocab=48, d_model=16, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=32, max_seq=16, dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab=48, d_model=16, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=32, max_seq=16,
                          dtype=torch.float32)
LR = 1e-3


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(JCFG, jax.random.key(4)))


def _state(np_params, step=0, cfg=TCFG):
    init, _ = make_train_step(
        lambda p, b: tllama.next_token_loss(p, b[0], cfg), adamw(LR), "cpu")
    st = init(tllama.params_from_numpy(np_params, device="cpu"))
    return dataclasses.replace(st, step=step)


def _stepped(np_params, step=3):
    """A port state whose AdamW moments are not zero (one real step)."""
    init, step_fn = make_train_step(
        lambda p, b: tllama.next_token_loss(p, b[0], TCFG), adamw(LR), "cpu")
    st = init(tllama.params_from_numpy(np_params, device="cpu"))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 48, (2, 16)).astype(np.int32))
    st, _ = step_fn(st, (tokens,))
    return dataclasses.replace(st, step=step)


def _leaves_np(state):
    """Copies of the state's leaves, in the generation's order."""
    return [np.array(leaf.detach().numpy() if isinstance(leaf, torch.Tensor)
                     else leaf) for leaf in train_state_leaves(state)]


def _same_state(a, b):
    return all(np.array_equal(x, y) for x, y in
               zip(_leaves_np(a), _leaves_np(b))) and a.step == b.step


# -- AsyncCheckpointer --------------------------------------------------------


def test_submit_flush_restore_roundtrip(tmp_path, np_params):
    m = Metrics()
    cp = AsyncCheckpointer(str(tmp_path), metrics=m)
    st = _stepped(np_params, step=7)
    cursor = tckpt.LoaderCheckpoint(epoch=3, target=1, shuffle_round=2)
    assert cp.submit(st, cursor)
    cp.flush()
    restored = restore_latest(str(tmp_path), like=_state(np_params), metrics=m)
    assert restored is not None and restored.step == 7
    assert restored.state.step == 7
    assert _same_state(restored.state, st)
    assert (restored.loader.epoch, restored.loader.target,
            restored.loader.shuffle_round) == (3, 1, 2)
    assert tckpt.LoaderCheckpoint.load(str(tmp_path / "loader.json")).epoch == 3
    assert m.timer("resilience.ckpt_submit").count == 1
    assert m.counter("resilience.ckpts") == 1
    assert m.gauge("resilience.ckpt_bytes") == os.path.getsize(
        list_generations(str(tmp_path))[0][1])
    cp.close()


def test_keep_k_retention(tmp_path, np_params):
    cp = AsyncCheckpointer(str(tmp_path), keep=2)
    st = _state(np_params)
    for step in (1, 2, 3, 4, 5):
        cp.submit(dataclasses.replace(st, step=step), block=True)
    cp.flush()
    cp.close()
    assert [s for s, _ in list_generations(str(tmp_path))] == [4, 5]


def test_backpressure_skips_periodic_checkpoint(tmp_path, np_params):
    m = Metrics()
    cp = AsyncCheckpointer(str(tmp_path), metrics=m)
    st = _state(np_params)
    outcomes = [cp.submit(dataclasses.replace(st, step=s)) for s in range(1, 6)]
    cp.flush()
    cp.close()
    assert outcomes[0] and cp._n_sets <= 2
    assert m.counter("resilience.ckpt_skipped") == outcomes.count(False)


def test_checkpoint_now_is_durable(tmp_path, np_params):
    m = Metrics()
    cp = AsyncCheckpointer(str(tmp_path), metrics=m)
    cp.checkpoint_now(_state(np_params, step=9))
    found = latest_verified_generation(str(tmp_path))
    assert found is not None and found[0] == 9
    assert m.counter("resilience.final_ckpts") == 1
    cp.close()


def _two_generations(tmp_path, np_params):
    cp = AsyncCheckpointer(str(tmp_path))
    st = _state(np_params)
    cp.submit(dataclasses.replace(st, step=1))
    cp.submit(dataclasses.replace(st, step=2))
    cp.flush()
    cp.close()
    return dict(list_generations(str(tmp_path)))


@pytest.mark.parametrize("cut", ["half", "tail_byte", "trailer"])
def test_truncated_generation_falls_back(tmp_path, np_params, cut):
    """A torn tail (the reference's truncation) and hand-truncated files
    standing in for its chaos-site corruption: the newest generation
    quarantines and the previous one restores."""
    gens = _two_generations(tmp_path, np_params)
    size = os.path.getsize(gens[2])
    new_size = {"half": size // 2, "tail_byte": size - 1, "trailer": size - 32}[cut]
    with open(gens[2], "r+b") as f:
        f.truncate(new_size)
    m = Metrics()
    restored = restore_latest(str(tmp_path), like=_state(np_params), metrics=m)
    assert restored is not None and restored.step == 1
    assert m.counter("resilience.ckpt_quarantined") == 1
    assert any(n.endswith(".quarantined") for n in os.listdir(tmp_path))


def test_renamed_generation_fails_seq_check(tmp_path, np_params):
    cp = AsyncCheckpointer(str(tmp_path))
    cp.submit(_state(np_params, step=3))
    cp.flush()
    cp.close()
    (_, path3), = list_generations(str(tmp_path))
    shutil.copy(path3, str(tmp_path / "gen_0000000009.ckpt"))
    m = Metrics()
    restored = restore_latest(str(tmp_path), like=_state(np_params), metrics=m)
    assert restored is not None and restored.step == 3
    assert m.counter("resilience.ckpt_quarantined") == 1


def test_exhaustion_is_loud_cold_start(tmp_path, np_params):
    cp = AsyncCheckpointer(str(tmp_path))
    cp.submit(_state(np_params, step=1))
    cp.flush()
    cp.close()
    (_, path), = list_generations(str(tmp_path))
    with open(path, "r+b") as f:
        f.seek(40)
        f.write(b"\xff" * 8)
    m = Metrics()
    assert restore_latest(str(tmp_path), like=_state(np_params), metrics=m) is None
    assert m.counter("resilience.ckpt_cold_starts") == 1
    assert m.counter("resilience.ckpt_quarantined") == 1


def test_empty_dir_is_first_run_not_incident(tmp_path, np_params):
    m = Metrics()
    assert restore_latest(str(tmp_path), like=_state(np_params), metrics=m) is None
    assert m.counter("resilience.ckpt_cold_starts") == 0


def test_writer_failure_surfaces_in_flush(tmp_path, np_params):
    blocker = tmp_path / "as_file"
    blocker.write_text("not a directory")
    cp = AsyncCheckpointer(str(blocker / "sub"), metrics=Metrics())
    cp.submit(_state(np_params, step=1))
    with pytest.raises(CheckpointError, match="write failed"):
        cp.flush(timeout_s=10.0)


def test_geometry_change_is_typed_error(tmp_path, np_params):
    cp = AsyncCheckpointer(str(tmp_path))
    cp.checkpoint_now(_state(np_params, step=1))
    cp.close()
    other = dataclasses.replace(TCFG, d_ff=24)
    like = _state(jax.tree.map(np.asarray, jllama.init_params(
        dataclasses.replace(JCFG, d_ff=24), jax.random.key(0))), cfg=other)
    with pytest.raises(CheckpointError, match="geometry"):
        restore_latest(str(tmp_path), like=like)


def test_submit_ends_before_the_next_step_updates_in_place(tmp_path, np_params):
    """The snapshot is taken when submit returns: an in-place update
    right after it does not reach the written generation."""
    st = _stepped(np_params, step=5)
    want = _leaves_np(st)
    cp = AsyncCheckpointer(str(tmp_path))
    cp.submit(st)
    with torch.no_grad():
        for p in tree_leaves(st.params):
            p.add_(1.0)
    cp.flush()
    cp.close()
    restored = restore_latest(str(tmp_path), like=_state(np_params))
    assert all(np.array_equal(a, b)
               for a, b in zip(_leaves_np(restored.state), want))


# -- the synchronous, manifest-verified path ---------------------------------


def test_truncated_newest_resumes_from_previous(tmp_path, np_params):
    import json

    st = _stepped(np_params)
    tckpt.save_train_state(dataclasses.replace(st, step=1), str(tmp_path))
    tckpt.save_train_state(dataclasses.replace(st, step=2), str(tmp_path))
    step2 = tmp_path / "step_2"
    with open(step2 / tckpt.MANIFEST_NAME) as f:
        entries = json.load(f)["files"]
    victim = max(entries, key=lambda rel: entries[rel]["size"])
    vpath = step2 / victim
    with open(vpath, "r+b") as f:
        f.truncate(max(0, os.path.getsize(vpath) // 2))
    assert tckpt.latest_verified_step(str(tmp_path)) == 1
    restored = tckpt.restore_train_state(str(tmp_path), like=_state(np_params))
    assert restored.step == 1
    assert _same_state(restored, dataclasses.replace(st, step=1))
    assert any(n.startswith("step_2.quarantined") for n in os.listdir(tmp_path))


def test_save_writes_manifest_and_verifies(tmp_path, np_params):
    tckpt.save_train_state(_state(np_params, step=4), str(tmp_path))
    step_dir = tmp_path / "step_4"
    assert (step_dir / tckpt.MANIFEST_NAME).exists()
    assert tckpt.verify_step_dir(str(step_dir)) is None


def test_same_step_overwrite_replaces_whole(tmp_path, np_params):
    tckpt.save_train_state(_state(np_params, step=4), str(tmp_path))
    st = _stepped(np_params, step=4)
    tckpt.save_train_state(st, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_4"]
    assert _same_state(tckpt.restore_train_state(
        str(tmp_path), like=_state(np_params)), st)


def test_tmp_orphan_never_matches(tmp_path):
    (tmp_path / "step_9.tmp.1234").mkdir(parents=True)
    assert tckpt.latest_verified_step(str(tmp_path)) is None


def test_legacy_dir_without_manifest_stays_restorable(tmp_path, np_params):
    tckpt.save_train_state(_state(np_params, step=3), str(tmp_path))
    os.unlink(tmp_path / "step_3" / tckpt.MANIFEST_NAME)
    assert tckpt.latest_verified_step(str(tmp_path)) == 3


def test_atomic_file_write_survives_interrupted_rename(tmp_path, monkeypatch):
    target = tmp_path / "loader.json"
    tckpt.atomic_file_write(str(target), b'{"epoch": 1}')
    real_replace = os.replace

    def boom(src, dst):
        raise OSError("simulated crash at rename")

    monkeypatch.setattr(tckpt.os, "replace", boom)
    with pytest.raises(OSError):
        tckpt.atomic_file_write(str(target), b'{"epoch": 2}')
    monkeypatch.setattr(tckpt.os, "replace", real_replace)
    assert b'"epoch": 1' in target.read_bytes()


# -- byte identity with the JAX package --------------------------------------


def test_loader_checkpoint_json_is_the_references(tmp_path):
    kw = dict(epoch=3, target=1, batches_in_window=2, shuffle_round=5,
              cluster_epoch=4)
    jckpt.LoaderCheckpoint(**kw).save(str(tmp_path / "j.json"))
    tckpt.LoaderCheckpoint(**kw).save(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert tckpt.LoaderCheckpoint.load(str(tmp_path / "j.json")) == \
        tckpt.LoaderCheckpoint(**kw)
    assert [f.name for f in dataclasses.fields(tckpt.LoaderCheckpoint)] == [
        f.name for f in dataclasses.fields(jckpt.LoaderCheckpoint)]


class _Loader:
    _epoch = _target = _batches_in_window = 0


def test_loader_checkpoint_refuses_a_cache_it_cannot_adopt(tmp_path,
                                                           monkeypatch):
    """A manifest that cannot be adopted (a vanished spill dir, another
    key schema, no checkpoint file) resumes with a cold cache, as in the
    reference: the loader's position is applied, nothing raises and no
    spill dir is exported."""
    from ddl_tpu import cache as jcache
    from ddl_tpu_torch import cache as tcache

    for var in ("DDL_TPU_CACHE_SPILL_DIR", "DDL_TORCH_CACHE_SPILL_DIR"):
        monkeypatch.setenv(var, "")  # recorded, so restored after the test
        monkeypatch.delenv(var)
    (tmp_path / "spill").mkdir()
    cases = [(str(tmp_path / "gone"), 1), (str(tmp_path / "spill"), 2)]
    for spill, schema in cases:
        for mod, cache in ((jckpt, jcache), (tckpt, tcache)):
            cache.reset_default_store()
            loader = _Loader()
            mod.LoaderCheckpoint(epoch=4, cache_spill_dir=spill,
                                 cache_key_schema=schema).apply(loader)
            assert loader._epoch == 4
    assert "DDL_TORCH_CACHE_SPILL_DIR" not in os.environ
    assert "DDL_TPU_CACHE_SPILL_DIR" not in os.environ
    missing = str(tmp_path / "loader.json")
    assert tckpt.adopt_cache_manifest(missing) is False
    assert jckpt.adopt_cache_manifest(missing) is False


@pytest.mark.parametrize("codec", [None, "zlib"])
def test_loader_checkpoint_with_a_cache_manifest_is_the_references(
        tmp_path, codec, monkeypatch):
    """``capture(cache=)`` names the store's spill dir and key schema in a
    file byte-identical to the reference's, and each package adopts the
    other's manifest."""
    from ddl_tpu import cache as jcache
    from ddl_tpu_torch import cache as tcache

    spill = str(tmp_path / "spill")
    jstore = jcache.CacheStore(spill_dir=spill, codec=codec)
    tstore = tcache.CacheStore(spill_dir=spill, codec=codec,
                               metrics=Metrics())
    loader = _Loader()
    loader._epoch, loader._target = 2, 1
    jckpt.LoaderCheckpoint.capture(loader, cache=jstore).save(
        str(tmp_path / "j.json"))
    tckpt.LoaderCheckpoint.capture(loader, cache=tstore).save(
        str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    ck = tckpt.LoaderCheckpoint.load(str(tmp_path / "j.json"))
    assert ck.cache_spill_dir == spill
    assert ck.cache_key_schema == tcache.KEY_SCHEMA_VERSION
    for var in ("DDL_TPU_CACHE_SPILL_DIR", "DDL_TORCH_CACHE_SPILL_DIR"):
        monkeypatch.setenv(var, "")  # recorded, so restored after the test
        monkeypatch.delenv(var)
    tcache.reset_default_store()
    jcache.reset_default_store()
    try:
        assert tckpt.adopt_cache_manifest(str(tmp_path / "j.json"))
        assert jckpt.adopt_cache_manifest(str(tmp_path / "t.json"))
        assert os.environ["DDL_TORCH_CACHE_SPILL_DIR"] == spill
        assert os.environ["DDL_TPU_CACHE_SPILL_DIR"] == spill
    finally:
        tcache.reset_default_store()
        jcache.reset_default_store()


def _jax_state(np_params, port_state):
    """The reference's TrainState holding the port state's values: params,
    optax.adamw's count/mu/nu, and the step."""
    params = jax.tree.map(jnp.asarray, np_params)
    opt_state = optax.adamw(LR).init(params)
    # Derive the reference's leaf order from jax.tree_util, then fill it
    # with the port's leaves in the order the port claims is the same.
    treedef = jax.tree_util.tree_structure(
        {"params": params, "opt_state": opt_state})
    leaves = [jnp.asarray(a) for a in _leaves_np(port_state)]
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    return JaxTrainState(params=tree["params"], opt_state=tree["opt_state"],
                         step=port_state.step)


def test_reference_leaf_order_is_count_mu_nu_params(np_params):
    st = _stepped(np_params)
    jst = _jax_state(np_params, st)
    count, mu, nu = jst.opt_state[0]
    assert int(count) == 1
    jleaves = jax.tree_util.tree_leaves(
        {"params": jst.params, "opt_state": jst.opt_state})
    want = ([count] + jax.tree_util.tree_leaves(mu)
            + jax.tree_util.tree_leaves(nu) + jax.tree_util.tree_leaves(jst.params))
    assert len(jleaves) == len(want)
    assert all(a is b for a, b in zip(jleaves, want))
    # The params leaf the port puts first is the reference's first.
    np.testing.assert_array_equal(np.asarray(jst.params["embed"]),
                                  st.params["embed"].detach().numpy())
    np.testing.assert_array_equal(
        np.asarray(jst.params["layers"][0]["attn_norm"]),
        st.params["layers"][0]["attn_norm"].detach().numpy())
    np.testing.assert_array_equal(
        np.asarray(mu["layers"][1]["wq"]),
        st.optimizer.state[st.params["layers"][1]["wq"]]["exp_avg"].numpy())


def test_generation_blobs_are_byte_identical_and_cross_restore(tmp_path,
                                                              np_params):
    st = _stepped(np_params, step=3)
    jst = _jax_state(np_params, st)
    cursor = dict(epoch=2, target=1, batches_in_window=0, shuffle_round=0)
    jblob = jres.serialize_generation(
        3, [np.asarray(x) for x in jres._leaves(jst)],
        dataclasses.asdict(jckpt.LoaderCheckpoint(**cursor)))
    tblob = serialize_generation(
        3, _leaves_np(st), dataclasses.asdict(tckpt.LoaderCheckpoint(**cursor)))
    assert tblob.tobytes() == jblob.tobytes()

    # The writers' files too, then each package restores the other's.
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jcp = jres.AsyncCheckpointer(str(jdir))
    jcp.checkpoint_now(jst, jckpt.LoaderCheckpoint(**cursor))
    jcp.close()
    tcp = AsyncCheckpointer(str(tdir))
    tcp.checkpoint_now(st, tckpt.LoaderCheckpoint(**cursor))
    tcp.close()
    (_, jpath), = jres.list_generations(str(jdir))
    (_, tpath), = list_generations(str(tdir))
    assert open(jpath, "rb").read() == open(tpath, "rb").read() == \
        tblob.tobytes()

    mine = restore_latest(str(jdir), like=_state(np_params))
    assert mine.step == 3 and mine.loader.epoch == 2
    assert _same_state(mine.state, st)
    zero = _jax_state(np_params, _state(np_params))
    theirs = jres.restore_latest(str(tdir), like=zero)
    assert theirs.step == 3 and theirs.loader.epoch == 2
    for a, b in zip(jax.tree_util.tree_leaves(
            {"params": theirs.state.params, "opt_state": theirs.state.opt_state}),
            _leaves_np(st)):
        np.testing.assert_array_equal(np.asarray(a), b)
