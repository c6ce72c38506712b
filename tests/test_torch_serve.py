"""The port's multi-tenant ingest service (``ddl_tpu_torch.serve``: the
fair-share scheduler, the admission controller, the autoscaler) against
the JAX package's, the twins of ``tests/test_serve.py``.

Every case of ``tests/torch_serve_cases.py`` (the reference suite's
cases, written once against a package root, plus seeded-trace cases)
runs against both packages in turn, asserting what the reference suite
asserts; what each case returns — grant orders, exported ledgers,
autoscaler decisions, served windows — must be equal across the two.
The scheduler and autoscaler units run on fake clocks; the e2e cases
drive each package's own THREAD loaders.
"""

import pathlib

import pytest

from torch_twins import ROOTS, collect, load, run_twin

_PATH = pathlib.Path(__file__).with_name("torch_serve_cases.py")
MODS = [load(_PATH, root) for root in ROOTS]
CASES = collect(MODS[1])


def test_both_packages_collect_the_same_cases():
    assert [c[0] for c in collect(MODS[0])] == [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_twin(case, tmp_path, monkeypatch):
    run_twin(MODS, case, tmp_path, monkeypatch)
