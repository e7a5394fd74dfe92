"""Device time per XLA program from a jax.profiler trace.

Usage: python tests/tools/trace_device_time.py TRACE_DIR

TRACE_DIR is what ``SNIPER_PROFILE=TRACE_DIR`` wrote (``--stats`` runs of
the CLI).  Reads the newest ``*.xplane.pb`` under it and prints one JSON
object per device plane (``/device:GPU:N``):

* ``lines`` — event count of each timeline of the plane;
* ``modules`` — per XLA program (the "XLA Modules" timeline): executions,
  total device seconds and mean milliseconds per execution;
* ``kernels_by_module`` — per XLA program named in the kernels' own
  ``hlo_module`` stat (GPU traces have no "XLA Modules" timeline):
  kernel launches and their summed device seconds;
* ``memcpy_s`` — summed duration of the copy events;
* ``span_s`` / ``busy_s`` — first-to-last event on the plane, and the
  union of the intervals in which any kernel or copy ran (every
  timeline except the module and op summaries), so
  ``1 - busy_s / span_s`` is the device's idle share over the traced
  span.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

SUMMARY_LINES = ("XLA Modules", "XLA Ops", "Steps")


def _union_s(intervals: list[tuple[int, int]]) -> float:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def _stats(ev) -> dict:
    try:
        return {str(k): v for k, v in ev.stats}
    except (TypeError, ValueError):
        return {}


def summarize(xplane: Path) -> list[dict]:
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(str(xplane)).planes:
        if not plane.name.startswith("/device:"):
            continue
        lines, modules, by_mod = {}, {}, {}
        kernels, copy_ns, lo, hi = [], 0, None, None
        for line in plane.lines:
            events = list(line.events)
            lines[line.name] = len(events)
            for ev in events:
                s, e = int(ev.start_ns), int(ev.end_ns)
                lo = s if lo is None else min(lo, s)
                hi = e if hi is None else max(hi, e)
                if line.name == "XLA Modules":
                    m = modules.setdefault(ev.name, [0, 0])
                    m[0] += 1
                    m[1] += e - s
                elif line.name not in SUMMARY_LINES:
                    kernels.append((s, e))
                    st = _stats(ev)
                    if "memcpy_details" in st or "Memcpy" in ev.name:
                        copy_ns += e - s
                    elif st.get("hlo_module"):
                        m = by_mod.setdefault(str(st["hlo_module"]), [0, 0])
                        m[0] += 1
                        m[1] += e - s
        out.append({
            "plane": plane.name,
            "lines": lines,
            "modules": {
                k: {"count": c, "total_s": ns / 1e9,
                    "mean_ms": ns / c / 1e6}
                for k, (c, ns) in sorted(modules.items(),
                                         key=lambda kv: -kv[1][1])
            },
            "kernels_by_module": {
                k: {"kernels": c, "total_s": ns / 1e9}
                for k, (c, ns) in sorted(by_mod.items(),
                                         key=lambda kv: -kv[1][1])
            },
            "memcpy_s": copy_ns / 1e9,
            "span_s": (hi - lo) / 1e9 if lo is not None else 0.0,
            "busy_s": _union_s(kernels),
        })
    return out


def main(argv: list[str]) -> int:
    found = sorted(Path(argv[0]).glob("plugins/profile/*/*.xplane.pb"),
                   key=lambda p: p.stat().st_mtime)
    if not found:
        print(f"no *.xplane.pb under {argv[0]}", file=sys.stderr)
        return 1
    for plane in summarize(found[-1]):
        print(json.dumps(plane))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
