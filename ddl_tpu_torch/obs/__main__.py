"""``python -m ddl_tpu_torch.obs`` — post-mortem tooling for obs
artifacts (port of ``ddl_tpu/obs/__main__.py``; the two read each
other's flight records).

Subcommands:

``dump <flight-record.json> [--metrics N] [--windows N]``
    Pretty-print a flight-recorder artifact: header (reason, faulted
    window, time, pid), a per-window stage waterfall reconstructed from
    the recorded span events, and the last-N metric deltas.

``trace <flight-record.json> -o out.json``
    Re-export the span events inside a flight record as a
    Chrome/Perfetto trace (open it in the Perfetto UI).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


def _load(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        record = json.load(f)
    version = int(record.get("version", -1))
    from ddl_tpu_torch.obs.recorder import DUMP_VERSION

    if version > DUMP_VERSION:
        raise SystemExit(
            f"{path}: flight-record version {version} is newer than "
            f"this tool understands ({DUMP_VERSION})"
        )
    return record


def _bar(frac: float, width: int = 28) -> str:
    n = max(0, min(width, round(frac * width)))
    return "#" * n + "." * (width - n)


def _span_events(record: Dict[str, Any]) -> List[tuple]:
    """Recorder entries -> (t, stage, dur, producer_idx, seq)."""
    out = []
    for ev in record.get("events", []):
        t, kind, name, value, pidx, seq = ev
        if kind == "span":
            out.append((t, name, float(value), pidx, seq))
    return out


def cmd_dump(args: argparse.Namespace) -> int:
    record = _load(args.path)
    win = record.get("window", {})
    print(f"flight record  {args.path}")
    print(f"  reason       {record.get('reason')}")
    print(f"  time         {record.get('time')}   pid {record.get('pid')}")
    print(
        "  window       producer_idx="
        f"{win.get('producer_idx')} seq={win.get('seq')}"
    )
    dropped = record.get("events_dropped", 0)
    print(
        f"  ring         {len(record.get('events', []))} events"
        + (f" ({dropped} older dropped)" if dropped else "")
    )

    spans = _span_events(record)
    if spans:
        print("\nper-window stage waterfall (most recent "
              f"{args.windows} windows):")
        by_window: Dict[tuple, List[tuple]] = {}
        order: List[tuple] = []
        for t, stage, dur, pidx, seq in spans:
            key = (pidx, seq)
            if key not in by_window:
                by_window[key] = []
                order.append(key)
            by_window[key].append((t, stage, dur))
        for key in order[-args.windows:]:
            pidx, seq = key
            evs = sorted(by_window[key])
            t_base = evs[0][0]
            total = max(
                (t - t_base) + d for t, _s, d in evs
            ) or 1e-9
            print(f"  window p{pidx}/s{seq}  "
                  f"({total * 1e3:.2f} ms first-event -> last-end)")
            for t, stage, dur in evs:
                off = t - t_base
                print(
                    f"    {stage:<22} +{off * 1e3:8.2f} ms  "
                    f"{dur * 1e3:8.2f} ms  |{_bar(dur / total)}|"
                )
    else:
        print("\n(no span events in the ring — spans were not armed)")

    deltas = [
        ev for ev in record.get("events", []) if ev[1] != "span"
    ][-args.metrics:]
    if deltas:
        print(f"\nlast {len(deltas)} metric deltas:")
        t_end = record["events"][-1][0]
        for t, kind, name, value, _p, _s in deltas:
            print(
                f"  {t - t_end:9.3f}s  {kind:<8} {name:<40} {value:g}"
            )

    snap = record.get("metrics", {})
    if snap:
        interesting = sorted(
            k for k in snap
            if any(
                k.startswith(p)
                for p in (
                    "integrity.", "watchdog.", "wire.", "shuffle.",
                    "obs.", "resilience.",
                )
            )
            and snap[k]
        )
        if interesting:
            print("\nnonzero robustness counters at dump time:")
            for k in interesting:
                print(f"  {k:<44} {snap[k]:g}")
    return 0


def cmd_trace(args: argparse.Namespace) -> int:
    record = _load(args.path)
    events = [
        (t, t + dur, stage, pidx, seq, record.get("pid", 0))
        for t, stage, dur, pidx, seq in _span_events(record)
    ]
    if not events:
        print("no span events in the record", file=sys.stderr)
        return 1
    from ddl_tpu_torch.obs.spans import write_chrome_trace

    write_chrome_trace(events, args.out)
    print(f"wrote {args.out} ({len(events)} events) — load in Perfetto")
    return 0


def main(argv: Any = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m ddl_tpu_torch.obs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_dump = sub.add_parser("dump", help="pretty-print a flight record")
    p_dump.add_argument("path")
    p_dump.add_argument("--metrics", type=int, default=20,
                        help="metric deltas to show (default 20)")
    p_dump.add_argument("--windows", type=int, default=8,
                        help="recent windows to waterfall (default 8)")
    p_dump.set_defaults(fn=cmd_dump)
    p_trace = sub.add_parser(
        "trace", help="re-export a record's spans as a Chrome trace"
    )
    p_trace.add_argument("path")
    p_trace.add_argument("-o", "--out", default="flight-trace.json")
    p_trace.set_defaults(fn=cmd_trace)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
