"""The traffic generator is a function of the seed, and the regenerated
stream is what the port's producers serve."""

import tempfile

import numpy as np
import pytest
import torch

from benchmark import generate, sources
from benchmark.reference import stream
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _files(kind, seed):
    spec = tiny.spec(kind)
    d = tempfile.mkdtemp(prefix="bench-test-")
    return spec, generate.write_inputs(spec["traffic"], spec["config"], seed,
                                       d, CPU)


@pytest.mark.parametrize("kind", ["tokens", "images"])
def test_same_seed_same_bytes(kind):
    a = [_files(kind, 2 ** 31 + 5)[1] for _ in range(2)]
    b = _files(kind, 2 ** 31 + 6)[1]
    if kind == "tokens":
        read = lambda i: np.fromfile(i["token_file"], np.int32)  # noqa: E731
    else:
        read = lambda i: np.load(i["shard_pattern"].replace("*", "000"))  # noqa: E731
    assert np.array_equal(read(a[0]), read(a[1]))
    assert not np.array_equal(read(a[0]), read(b))


def test_tokens_in_vocab_and_skewed():
    spec, inputs = _files("tokens", 7)
    ids = np.fromfile(inputs["token_file"], np.int32)
    assert len(ids) == spec["traffic"]["n_tokens"]
    assert ids.min() >= 0 and ids.max() < spec["config"]["vocab_size"]
    counts = np.bincount(ids, minlength=spec["config"]["vocab_size"])
    assert counts[0] > counts[1] > counts[10] > 0  # Zipf: rank 1 first


def test_image_rows():
    spec, inputs = _files("images", 9)
    cfg, traffic = spec["config"], spec["traffic"]
    shard = np.load(inputs["shard_pattern"].replace("*", "001"))
    px = cfg["image_size"] ** 2 * cfg["num_channels"]
    assert shard.shape == (traffic["rows_per_shard"], px + 1)
    assert shard.dtype == np.float32
    labels = shard[:, -1]
    assert (labels == np.round(labels)).all()
    assert labels.min() >= 0 and labels.max() < cfg["num_labels"]


def _served(producer, n_producers, n_windows, shape):
    """Windows a port producer serves: its start-up fill, then one fill a
    published window."""
    out = []
    for p in range(1, n_producers + 1):
        import copy

        fn = copy.deepcopy(producer)
        fn.on_init(producer_idx=p, n_producers=n_producers)
        ary = np.zeros(shape, dtype=fn._tokens.dtype if hasattr(fn, "_tokens")
                       else np.float32)
        fn.post_init(ary)
        wins = []
        for _ in range(n_windows):
            fn.execute_function(ary)
            wins.append(ary.copy())
        out.append(wins)
    return [out[k % n_producers][k // n_producers]
            for k in range(n_windows * n_producers)]


@pytest.mark.parametrize("kind", ["tokens", "images"])
def test_regenerated_stream_is_the_producers(kind):
    seed = 2 ** 31 + 11
    spec, inputs = _files(kind, seed)
    cfg, traffic = spec["config"], spec["traffic"]
    P = traffic["producers"]
    prod = sources.load(traffic["source"]).producer(traffic, inputs, seed, cfg)
    if kind == "tokens":
        shape = (traffic["batch_size"] * traffic["steps_per_window"],
                 traffic["seq_len"])
    else:
        px = cfg["image_size"] ** 2 * cfg["num_channels"]
        shape = (traffic["rows_per_shard"], px + 1)
    served = _served(prod, P, 3, shape)
    sums, whole = stream.expected(inputs, traffic, seed, len(served),
                                  len(served))
    for k, win in enumerate(served):
        assert np.array_equal(whole[k], win), k
        assert np.array_equal(sums[k], stream.row_sums(win)), k
