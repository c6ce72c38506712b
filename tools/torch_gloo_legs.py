"""Time the gloo collectives a MULTIHOST step can use, between two local
processes: ``all_reduce`` of a bucket (the replicated step's
``process_mean``), ``reduce_scatter_tensor`` of it, ``all_to_all_single``
plus the sum of the received chunks (the ZeRO-1 scatter leg,
``parallel.optimizer._reduce_scatter``), and ``all_gather_into_tensor`` of
a half-sized chunk (the ZeRO-1 gather leg).  A reduce-scatter that moves a
reduce-scatter's bytes takes about half an all-reduce's time; one built on
an all-reduce takes at least an all-reduce's.

Usage: ``python tools/torch_gloo_legs.py [--mb 512] [--reps 5] [--pinned]``
(``--pinned`` stages in page-locked memory, which needs a card).  Prints
one JSON object: each collective's seconds per repetition, the first
(warm-up) included, and the bucket's bytes.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _child(rank: int, port: int, mb: int, reps: int, pinned: bool) -> None:
    import warnings

    import torch
    import torch.distributed as dist

    warnings.filterwarnings("ignore", category=FutureWarning)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    n = mb * (1 << 20) // 4
    bucket = torch.randn(n).pin_memory() if pinned else torch.randn(n)
    half = torch.empty(n // 2, pin_memory=pinned)
    full = torch.empty(n, pin_memory=pinned)

    def a2a_sum():
        dist.all_to_all_single(full, bucket)
        torch.add(full[:n // 2], full[n // 2:], out=half)

    legs = {
        "all_reduce": lambda: dist.all_reduce(bucket),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(half, bucket),
        "all_to_all_single+sum": a2a_sum,
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(full, half),
    }
    out = {name: [] for name in legs}
    for _ in range(reps):
        for name, fn in legs.items():
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            dist.barrier()
            out[name].append(round(time.perf_counter() - t0, 4))
    if rank == 0:
        print(json.dumps({"bucket_bytes": 4 * n, "pinned": pinned,
                          "seconds": out}), flush=True)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=int, default=512, help="bucket size (MiB)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--pinned", action="store_true")
    ap.add_argument("--child", nargs=2, type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child[0], args.child[1], args.mb, args.reps, args.pinned)
        return 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, os.path.abspath(__file__), "--mb", str(args.mb),
           "--reps", str(args.reps)] + (["--pinned"] if args.pinned else [])
    procs = [subprocess.Popen(cmd + ["--child", str(r), str(port)])
             for r in range(2)]
    rcs = [p.wait(timeout=600) for p in procs]
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
