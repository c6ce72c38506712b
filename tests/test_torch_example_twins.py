"""The port's twins of the JAX package's examples (``examples/*_torch.py``)
run on the CPU and agree with their references.

Each twin is spawned as a user runs it (``--device cpu``) and must exit
0 with its pass line.  Beside that: ``run_ddl_torch``'s producer fills
windows byte-equal to the reference example's ``DataProducer`` for the
same ``Params`` and seeds, and its THREAD drain serves the reference
loader's batches; ``global_shuffle_torch``'s two instances serve the
reference example's windows byte for byte; ``generate_torch``'s greedy
tokens, from weights carried from a JAX init, equal
``ddl_tpu.models.llama.generate``'s.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"


def _load(name, monkeypatch):
    """Import ``examples/<name>.py`` as a module (the reference examples
    import their ``_common`` platform pin from beside them)."""
    monkeypatch.syspath_prepend(str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    # Registered while it runs: its dataclasses resolve their annotations
    # through sys.modules.
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,args,line", [
    ("generate_torch.py", ["--device", "cpu"], "OK"),
    ("run_ddl_torch.py", ["--device", "cpu"], "(numpy output): OK"),
    ("run_ddl_torch.py", ["process", "--device", "cpu"], "(numpy output): OK"),
    ("run_ddl_torch.py", ["--output", "device", "--device", "cpu"],
     "(device output): OK"),
    ("global_shuffle_torch.py", [], "PASS"),
    ("train_vit_torch.py", ["--device", "cpu"], "PASS - final loss"),
], ids=["generate", "run_ddl-thread", "run_ddl-process", "run_ddl-device",
        "global_shuffle", "train_vit"])
def test_twin_exits_zero_with_its_pass_line(script, args, line, tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / script), *args], capture_output=True,
        text=True, timeout=240, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    last = [ln for ln in proc.stdout.splitlines() if ln.strip()][-1]
    assert line in last, proc.stdout[-2000:]


@pytest.mark.parametrize("script", ["generate_torch.py", "run_ddl_torch.py",
                                    "train_vit_torch.py"])
def test_twin_refuses_the_cpu_unless_asked(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / script)], capture_output=True,
        text=True, timeout=120, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode != 0
    assert "pass device='cpu'" in proc.stderr


# -- run_ddl ----------------------------------------------------------------------


def test_run_ddl_producer_fills_match_the_reference(monkeypatch):
    ref = _load("run_ddl", monkeypatch)
    twin = _load("run_ddl_torch", monkeypatch)
    for instance_idx, producer_idx in ((0, 1), (0, 2), (3, 1)):
        kw = dict(producer_idx=producer_idx, n_producers=2,
                  instance_idx=instance_idx, n_instances=4)
        rp, tp = ref.DataProducer(ref.Params()), twin.DataProducer(twin.Params())
        ri, ti = rp.on_init(**kw), tp.on_init(**kw)
        assert (ri.nData, ri.nValues, tuple(ri.shape), tuple(ri.splits)) == (
            ti.nData, ti.nValues, tuple(ti.shape), tuple(ti.splits))
        ra = np.empty(ri.shape, np.float32)
        ta = np.empty(ti.shape, np.float32)
        rp.post_init(ra)
        tp.post_init(ta)
        assert ra.tobytes() == ta.tobytes()
        for _ in range(3):
            rp.execute_function(ra)
            tp.execute_function(ta)
            assert ra.tobytes() == ta.tobytes()


def _drain(pkg, example, params):
    @pkg.distributed_dataloader(n_producers=2, mode="thread")
    def main(env):
        loader = pkg.DistributedDataLoader(
            example.DataProducer(params), batch_size=params.batch_size,
            connection=env.connection, n_epochs=params.nepoch,
            output="numpy")
        out = []
        for _ in range(params.nepoch):
            for batch in loader:
                out.append(b"".join(np.ascontiguousarray(c).tobytes()
                                    for c in batch))
                loader.mark(pkg.Marker.END_OF_BATCH)
            loader.mark(pkg.Marker.END_OF_EPOCH)
        loader.shutdown()
        return out

    return main()


def test_run_ddl_stream_matches_the_reference(monkeypatch):
    import ddl_tpu
    import ddl_tpu_torch

    ref = _load("run_ddl", monkeypatch)
    twin = _load("run_ddl_torch", monkeypatch)
    want = _drain(ddl_tpu, ref, ref.Params(nepoch=3, n_data=256))
    got = _drain(ddl_tpu_torch, twin, twin.Params(nepoch=3, n_data=256))
    assert len(got) == len(want) == 3 * 256 // 32
    assert got == want


# -- global_shuffle ---------------------------------------------------------------


def _reference_instance(ref, instance_idx, rendezvous, served):
    """The reference example's ``run_instance``, recording every served
    ``x`` batch (its own records only the origins)."""
    topo = ref.Topology(n_instances=2, instance_idx=instance_idx,
                        n_producers=1, mode=ref.RunMode.THREAD)
    consumer_end, producer_end = ref.ThreadChannel.pair()
    pconn = ref.ProducerConnection(producer_end, 1, cross_process=False)
    threading.Thread(target=lambda: ref.DataPusher(
        pconn, topo, 1,
        shuffler_factory=ref.ThreadExchangeShuffler.factory(rendezvous),
    ).push_data(), daemon=True).start()
    loader = ref.DistributedDataLoader(
        ref.InstanceTagged(instance_idx), batch_size=ref.BATCH,
        connection=ref.ConsumerConnection([consumer_end]),
        n_epochs=ref.N_EPOCHS, output="numpy",
        global_shuffle_fraction_exchange=ref.EXCHANGE_FRACTION)
    for _ in range(ref.N_EPOCHS):
        for x, _y in loader:
            served.append(np.array(x))
            loader.mark(ref.Marker.END_OF_BATCH)
        loader.mark(ref.Marker.END_OF_EPOCH)


def _pair(run):
    served = {0: [], 1: []}
    threads = [threading.Thread(target=run, args=(i, served[i]), daemon=True)
               for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return served


def test_global_shuffle_windows_match_the_reference(monkeypatch):
    ref = _load("global_shuffle", monkeypatch)
    twin = _load("global_shuffle_torch", monkeypatch)
    rrdv, trdv = ref.Rendezvous(), twin.Rendezvous()
    want = _pair(lambda i, out: _reference_instance(ref, i, rrdv, out))
    results = {}
    got = _pair(lambda i, out: twin.run_instance(i, trdv, results, served=out))
    n = ref.N_EPOCHS * ref.N_DATA // ref.BATCH
    for i in (0, 1):
        assert len(got[i]) == len(want[i]) == n
        assert [g.tobytes() for g in got[i]] == [w.tobytes() for w in want[i]]
        assert results[i] == [{0, 1}] * ref.N_EPOCHS


# -- generate ---------------------------------------------------------------------


def test_generate_greedy_matches_the_reference_from_carried_weights(
        monkeypatch):
    from ddl_tpu.models import llama as jllama
    from ddl_tpu_torch.models import llama as tllama

    twin = _load("generate_torch", monkeypatch)
    cfg = twin.model_config()
    jcfg = jllama.LlamaConfig(
        vocab=cfg.vocab, d_model=cfg.d_model, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        max_seq=cfg.max_seq, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tokens = twin.pattern_tokens()
    prompt = tokens[:4, :twin.PROMPT]
    want = np.asarray(jllama.generate(jparams, jnp.asarray(prompt), jcfg,
                                      max_new_tokens=twin.NEW))
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    greedy, sampled, nucleus = twin.generate_three(
        params, torch.from_numpy(prompt), cfg)
    assert greedy.numpy().tolist() == want.tolist()
    for out in (sampled, nucleus):
        assert tuple(out.shape) == (4, twin.PROMPT + twin.NEW)
        assert torch.equal(out[:, :twin.PROMPT], torch.from_numpy(prompt))
        assert int(out.min()) >= 0 and int(out.max()) < twin.VOCAB
