"""ddl-verify over the port: ``python -m tools.ddl_torch_check verify``.

- **The gate**: VP001-VP004 report nothing over ``ddl_tpu_torch/``.
- **VP003 under ``DDL_TORCH_``**: a fixture tree laid out as the port
  is, where a registered ``DDL_TORCH_`` knob that nothing reads fires
  the port's VP003 and its read counterpart stays clean; the reference
  pass, with its ``DDL_TPU_`` prefix, would call every such knob dead.
  A spawn-boundary mirror (``export_<group>_knobs``) missing a member
  fires too.
- **VP004 against the port's dispatchers**: ``ConsumerConnection.
  drain_acks`` must carry an arm per ``PRODUCER_TO_CONSUMER_CONTROL``
  type, ``DataPusher._poll_control`` one per
  ``CONSUMER_TO_PRODUCER_CONTROL`` type.
- **Registry isolation**: running both commands leaves the reference
  registries and the reference VP003's prefix as they were.
"""

import dataclasses
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # tools.* import under any pytest cwd
    sys.path.insert(0, str(REPO))

from tools.ddl_lint import ALL_CODES  # noqa: E402
from tools.ddl_lint.checkers import REGISTRY  # noqa: E402
from tools.ddl_torch_check import lint, port_verify_config, verify  # noqa: E402
from tools.ddl_verify.config import ALL_PASSES  # noqa: E402
from tools.ddl_verify.passes import PASS_REGISTRY, envknobs  # noqa: E402
from tools.ddl_verify.runner import run_paths as reference_verify  # noqa: E402


def port_tree(tmp_path, files):
    """A fixture tree under ``<tmp>/ddl_tpu_torch/``, the port's layout,
    so the port config's module paths find it."""
    root = tmp_path / "ddl_tpu_torch"
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


def only(code):
    return dataclasses.replace(port_verify_config(), enable=[code])


def test_port_verifies_clean():
    findings = verify()
    assert [f.render() for f in findings] == []


def test_default_config_names_the_port():
    cfg = port_verify_config()
    assert cfg.enabled_passes() == list(ALL_PASSES)
    for mod in (cfg.concurrency_module, cfg.envspec_module,
                cfg.config_module, cfg.types_module):
        assert mod.startswith("ddl_tpu_torch/") and (REPO / mod).is_file()
    assert cfg.producer_to_consumer_dispatchers == [
        "ConsumerConnection.drain_acks"]


# -- VP003 --------------------------------------------------------------------

_ENVSPEC = """
    from dataclasses import dataclass

    @dataclass(frozen=True)
    class Knob:
        name: str
        type: str
        default: object
        doc: str
        export: object = None

    _EXPLICIT = [
        Knob("DDL_TORCH_FORCE_PY_RING", "bool", False, "Python ring."),
        Knob("DDL_TORCH_STAGED", "bool", True, "Staged ingest."),
        Knob("DDL_TORCH_WIRE_DTYPE", "str", None, "Slot wire.",
             export="wire"),
    ]
"""

_CONFIG = """
    import dataclasses

    @dataclasses.dataclass
    class LoaderConfig:
        _ENV_PREFIX = "DDL_TORCH_"
        batch_size: int = 0
"""

_ENV = """
    import os

    def export_wire_knobs(config):
        os.environ["DDL_TORCH_WIRE_DTYPE"] = str(config.wire_dtype)
"""


def _reader(*names):
    return "from ddl_tpu_torch import envspec\n\n" + "".join(
        f"x{i} = envspec.flag({n!r})\n" for i, n in enumerate(names))


def test_vp003_dead_torch_knob_fires(tmp_path):
    root = port_tree(tmp_path, {
        "envspec.py": _ENVSPEC, "config.py": _CONFIG, "env.py": _ENV,
        "shm_ring.py": _reader("DDL_TORCH_FORCE_PY_RING"),
    })
    findings = verify([root], config=only("VP003"))
    assert [f.code for f in findings] == ["VP003"]
    assert "DDL_TORCH_STAGED is registered but never read" in findings[0].message


def test_vp003_read_torch_knobs_are_clean(tmp_path):
    root = port_tree(tmp_path, {
        "envspec.py": _ENVSPEC, "config.py": _CONFIG, "env.py": _ENV,
        "shm_ring.py": _reader("DDL_TORCH_FORCE_PY_RING",
                               "DDL_TORCH_STAGED"),
    })
    assert verify([root], config=only("VP003")) == []
    # The reference pass reads only DDL_TPU_ names: every registered
    # knob of the port looks dead to it.
    ref = reference_verify([root], config=only("VP003"))
    assert sum("never read" in f.message for f in ref) == 3


def test_vp003_raw_environ_read_of_a_torch_knob_fires(tmp_path):
    root = port_tree(tmp_path, {
        "envspec.py": _ENVSPEC, "config.py": _CONFIG, "env.py": _ENV,
        "shm_ring.py": _reader("DDL_TORCH_FORCE_PY_RING")
        + "import os\ny = os.environ.get('DDL_TORCH_STAGED')\n",
    })
    findings = verify([root], config=only("VP003"))
    assert [f.code for f in findings] == ["VP003"]
    assert "bypasses the envspec registry" in findings[0].message


def test_vp003_export_mirror_missing_a_member_fires(tmp_path):
    envspec = _ENVSPEC.replace(
        'Knob("DDL_TORCH_STAGED", "bool", True, "Staged ingest."),',
        'Knob("DDL_TORCH_STAGED", "bool", True, "Staged ingest.",\n'
        '             export="wire"),')
    root = port_tree(tmp_path, {
        "envspec.py": envspec, "config.py": _CONFIG, "env.py": _ENV,
        "shm_ring.py": _reader("DDL_TORCH_FORCE_PY_RING",
                               "DDL_TORCH_STAGED"),
    })
    findings = verify([root], config=only("VP003"))
    assert [f.code for f in findings] == ["VP003"]
    assert "export_wire_knobs" in findings[0].message
    assert "DDL_TORCH_STAGED" in findings[0].message


# -- VP004 --------------------------------------------------------------------

_TYPES = """
    class ObsReport:
        pass

    class ControlAck:
        pass

    class ReplayRequest:
        pass

    CONSUMER_TO_PRODUCER_CONTROL = (ReplayRequest,)
    PRODUCER_TO_CONSUMER_CONTROL = (ObsReport, ControlAck)
"""

_PUSHER = """
    class DataPusher:
        def _poll_control(self, msg):
            if isinstance(msg, ReplayRequest):
                return 1
            return None
"""


def _router(*arms):
    body = "".join(f"            if isinstance(msg, {a}):\n"
                   f"                return {i}\n" for i, a in enumerate(arms))
    return ("class ConsumerConnection:\n"
            "    def drain_acks(self):\n"
            "        for msg in self._inbox:\n" + body)


def test_vp004_router_missing_an_arm_fires(tmp_path):
    root = port_tree(tmp_path, {
        "types.py": _TYPES, "datapusher.py": _PUSHER,
        "transport/connection.py": _router("ControlAck"),
    })
    findings = verify([root], config=only("VP004"))
    assert [f.code for f in findings] == ["VP004"]
    assert "ConsumerConnection.drain_acks" in findings[0].message
    assert "ObsReport" in findings[0].message
    assert findings[0].path.endswith("ddl_tpu_torch/transport/connection.py")


def test_vp004_exhaustive_router_is_clean(tmp_path):
    root = port_tree(tmp_path, {
        "types.py": _TYPES, "datapusher.py": _PUSHER,
        "transport/connection.py": _router("ControlAck", "ObsReport"),
    })
    assert verify([root], config=only("VP004")) == []


# -- registry isolation -------------------------------------------------------


def test_running_both_commands_leaves_the_reference_registries(tmp_path):
    root = port_tree(tmp_path, {
        "envspec.py": _ENVSPEC, "config.py": _CONFIG, "env.py": _ENV,
        "types.py": _TYPES, "datapusher.py": _PUSHER,
        "transport/connection.py": _router("ControlAck"),
        "trainer.py": """
            import torch

            class Trainer:
                def _fused_stream_loop(self, stream):
                    for win in stream:
                        torch.cuda.synchronize()
        """,
    })
    assert {f.code for f in lint([root])} == {"TDL020"}
    assert {f.code for f in verify([root])} >= {"VP003", "VP004"}
    assert set(REGISTRY) == set(ALL_CODES)
    assert set(PASS_REGISTRY) == set(ALL_PASSES)
    assert envknobs.PREFIX == "DDL_TPU_"
