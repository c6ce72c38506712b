"""The port's self-tuning data plane (``ddl_tpu_torch.tune``: the
calibrator, the knob controller, the knob seams) against the JAX
package's, the twins of ``tests/test_tune.py``.

Every case of ``tests/torch_tune_cases.py`` runs against both packages in
turn, asserting what the reference suite asserts; what each case returns
— ``Decision`` records (knob, old, new, ``cost_source``, reason), overlays,
knob values, served bytes — must be equal across the two.  Link costs and
signals are injected, and the controller runs on a fake clock: the int8
flip on a slow link, the parity guard, the never-worse revert and the
drift replan decide the same in both.  The distribution decision is held
to the reference's record; the port carries it to ``distribute=``
(``TunedConfig.distribute``) instead of an env knob.
"""

import pathlib

import pytest

from torch_twins import ROOTS, collect, load, run_twin

_PATH = pathlib.Path(__file__).with_name("torch_tune_cases.py")
MODS = [load(_PATH, root) for root in ROOTS]
CASES = collect(MODS[1])


def test_both_packages_collect_the_same_cases():
    assert [c[0] for c in collect(MODS[0])] == [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_twin(case, tmp_path, monkeypatch):
    run_twin(MODS, case, tmp_path, monkeypatch)
