"""The port's twin of ``examples/train_llama.py`` runs on the CPU at its
laptop scale: layered configs, a THREAD-mode window-stream fit whose
loss falls, and a greedy KV-cache continuation inside the vocab (the
example's own PASS rule, exit code 0)."""

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
