"""What the harness's modules load: never JAX or the JAX package (their
top-level names compared whole), and the references nothing of the
port."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r"""
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

HARNESS = ["benchmark.run", "benchmark.calibrate", "benchmark.program",
           "benchmark.generate", "benchmark.trace", "benchmark.compare",
           "benchmark.metrics", "benchmark.families.llama",
           "benchmark.families.vit", "benchmark.reference.llama",
           "benchmark.reference.vit", "benchmark.reference.stream",
           "benchmark.sources.token_stream", "benchmark.sources.image_shards"]


def _top_level(*modules):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE, *modules], cwd=ROOT,
                         env=env, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _top_level(*HARNESS)
    assert not loaded & {"jax", "jaxlib", "flax", "ddl_tpu"}, loaded


def test_reference_loads_nothing_of_the_port():
    loaded = _top_level("benchmark.reference", "benchmark.reference.llama",
                        "benchmark.reference.vit", "benchmark.reference.stream",
                        "benchmark.reference.common",
                        "benchmark.sources.token_stream",
                        "benchmark.sources.image_shards")
    assert not loaded & {"ddl_tpu_torch", "ddl_tpu", "jax", "jaxlib"}, loaded


def test_metric_readers_load():
    from benchmark import metrics

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metrics.reader(m["name"]).read), m["name"]


def test_forbidden_check_compares_whole_names():
    import ddl_tpu_torch  # noqa: F401 -- begins with "ddl_tpu", is not it

    from benchmark import run

    assert run.forbidden_modules() == []
