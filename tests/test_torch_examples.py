"""The port's twin of ``examples/train_llama.py`` runs on the CPU at its
laptop scale: layered configs, a THREAD-mode window-stream fit over a
dp mesh whose loss falls, and a greedy KV-cache continuation inside the
vocab (the example's own PASS rule, exit code 0) — also with the
reference docstring's ZeRO-1 and int8 runs through the
``DDL_TORCH_TRAIN_*`` twins."""

import importlib.util
import pathlib
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent


def _example():
    path = REPO / "examples" / "train_llama_torch.py"
    spec = importlib.util.spec_from_file_location("train_llama_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_twin_example_passes_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("DDL_TORCH_N_PRODUCERS", "3")
    assert _example().main("thread", device="cpu") == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "generated continuation:" in out
    assert (tmp_path / "ddl_tpu_torch_tokens.bin").exists()


def _losses(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("epoch losses:"))
    return line.split(":", 1)[1]


def test_twin_example_zero1_and_int8_runs(tmp_path, monkeypatch, capsys):
    """``DDL_TORCH_TRAIN_OPTIMIZER_SHARDING=zero1`` (inert at dp=1: the
    same losses) and ``..._GRAD_COMM=int8`` (the wire format engaged: the
    losses move, the example still passes)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("DDL_TORCH_N_PRODUCERS", "2")
    runs = []
    for env in ({}, {"DDL_TORCH_TRAIN_OPTIMIZER_SHARDING": "zero1"},
                {"DDL_TORCH_TRAIN_OPTIMIZER_SHARDING": "zero1",
                 "DDL_TORCH_TRAIN_GRAD_COMM": "int8"}):
        for k in ("DDL_TORCH_TRAIN_OPTIMIZER_SHARDING",
                  "DDL_TORCH_TRAIN_GRAD_COMM"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert _example().main("thread", device="cpu") == 0
        out = capsys.readouterr().out
        assert "PASS" in out
        runs.append(_losses(out))
    assert runs[1] == runs[0]
    assert runs[2] != runs[0]


def _pp_example():
    path = REPO / "examples" / "train_llama_pp_torch.py"
    spec = importlib.util.spec_from_file_location("train_llama_pp_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pp_twin_example_passes_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The twin of ``examples/train_llama_pp.py`` (the reference's
    ``tests/test_examples.py`` runs its ``pp_tp`` and ``pp_1f1b`` layouts):
    both train a falling loss over 8 positions of the CPU, the 1f1b
    run at its smaller bubble."""
    import sys

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.syspath_prepend(str(REPO / "examples"))
    monkeypatch.delitem(sys.modules, "train_llama_torch", raising=False)
    mod = _pp_example()
    for layout, bubble in (("pp_tp", "0.200"), ("pp_1f1b", "0.111")):
        assert mod.main(layout, device="cpu") == 0
        out = capsys.readouterr().out
        assert "OK" in out and f"bubble={bubble}" in out, out
