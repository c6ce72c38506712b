"""The port's multi-job ingest fabric (``ddl_tpu_torch.serve.fabric`` and
``serve.jobs``) against the JAX package's, the twins of
``tests/test_fabric.py``.

Every case of ``tests/torch_fabric_cases.py`` runs against both packages
in turn, asserting what the reference suite asserts; what each case
returns — grant orders, exported ledgers and registries, fired faults,
replies — must be equal across the two.  The chaos matrix (a dropped
admission absorbed exactly once, a crashed job's grants revoked), the
seam (dedup, fencing, typed errors), the admission-order property on
seeded traces (across a journal failover too), the isolation seams, and
two cases of the port's own: a journal either package writes rebuilds
the same fabric in the other, and ``JobCacheView`` accounts for every
access of its shared store.  The admission-order property also runs
over ``hypothesis``-generated jobs and demand traces.
"""

import pathlib
import random

import pytest
from hypothesis import given, settings, strategies as st

from torch_twins import ROOTS, collect, load, run_twin

_PATH = pathlib.Path(__file__).with_name("torch_fabric_cases.py")
MODS = [load(_PATH, root) for root in ROOTS]
CASES = collect(MODS[1])


def test_both_packages_collect_the_same_cases():
    assert [c[0] for c in collect(MODS[0])] == [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_twin(case, tmp_path, monkeypatch):
    run_twin(MODS, case, tmp_path, monkeypatch)


# -- the admission-order property over generated traces ---------------------


@settings(max_examples=12, deadline=None)
@given(specs=st.lists(st.tuples(st.floats(0.5, 4.0),
                                st.sampled_from([0.0, 1.0, 2.0, 4.0]),
                                st.sampled_from([0, 1, 2])),
                      min_size=2, max_size=4),
       trace=st.lists(st.tuples(st.floats(0.05, 0.6),
                                st.integers(0, 2 ** 31)),
                      min_size=4, max_size=20))
def test_generated_traces_grant_alike_in_both_packages(specs, trace):
    """Generated jobs (weight, budget in windows a second, slot cap) and
    demand traces (clock step, probe order): the port's fabric grants in
    the order the JAX package's fabric does, with equal ledgers after
    every step, and its own order equals its in-process scheduler's."""
    runs = []
    for mod in MODS:
        jobs = [mod.JobSpec(f"j{k}", weight=w,
                            byte_budget_per_s=b * mod.WINDOW,
                            slot_budget=s)
                for k, (w, b, s) in enumerate(specs)]
        fab_clock, ref_clock = mod.FakeClock(), mod.FakeClock()
        fab, _client, handles, _ = mod.make_fabric(clock=fab_clock,
                                                   jobs=jobs)
        ref_sched, ref_admitters = mod.make_reference(jobs, ref_clock)
        sides = ({h.job_id: h for h in handles}, ref_admitters)
        grants, ledgers = ([], []), []
        for dt, seed in trace:
            order = sorted(sides[0])
            random.Random(seed).shuffle(order)
            for side, (admitters, clock) in enumerate(
                    zip(sides, (fab_clock, ref_clock))):
                clock.t += dt
                for name in order:
                    try:
                        admitters[name].admit(0.0)
                    except (mod.StallTimeoutError, mod.WindowsRevoked):
                        continue
                    admitters[name].note_served(mod.WINDOW)
                    grants[side].append(name)
            ledgers.append(fab.scheduler.export_state(now=fab_clock()))
            assert ledgers[-1] == ref_sched.export_state(now=ref_clock())
        assert grants[0] == grants[1] == fab.admission_log
        runs.append((grants[0], ledgers))
    assert runs[1] == runs[0]
