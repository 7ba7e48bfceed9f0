#!/usr/bin/env python
"""Device time per query stage from a JAX profiler trace.

    python tools/stage_times.py TRACE_DIR

Reads the newest ``*.xplane.pb`` under TRACE_DIR (written by
``jax.profiler.trace``), takes the GPU device planes, and sums the
durations of their kernel events by query stage. A kernel belongs to the
innermost stage of ``metacache_tpu.ops.stage.STAGES`` named in its scope
path (``jax.named_scope``): in the event's metadata, or in the op_name of
its HLO instruction when XLA dumped the optimized modules as text into
TRACE_DIR/hlo (``--xla_dump_to``). Kernels outside every stage count as
"other". Run with XLA's command buffers off
(``--xla_gpu_enable_command_buffer=``): a kernel inside one is recorded
without its instruction. Also prints the window, the device's busy time
(the union of kernel intervals), its idle share and the costliest
kernels. ``chip_smoke.py --trace`` records such a trace.
"""
from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from metacache_tpu.ops.stage import STAGES  # noqa: E402

_STAGE_RE = re.compile(r"(?:^|/)(%s)(?=/|$)" % "|".join(STAGES))


def newest_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def stage_of(texts) -> str:
    """Innermost stage named in any of the scope-path strings."""
    best, best_pos = "other", -1
    for t in texts:
        for m in _STAGE_RE.finditer(t):
            if m.start(1) > best_pos:
                best, best_pos = m.group(1), m.start(1)
    return best


_MODULE_RE = re.compile(r"^HloModule ([\w.\-]+)")
_INSTR_RE = re.compile(
    r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?metadata=\{[^}]*op_name="([^"]*)"')


def hlo_op_names(hlo_dir: str) -> dict:
    """{(module, instruction): op_name} from XLA's optimized-HLO text
    dumps (``*after_optimizations.txt``) under hlo_dir."""
    names = {}
    for path in glob.glob(os.path.join(hlo_dir, "*after_optimizations.txt")):
        module = None
        with open(path) as f:
            for line in f:
                if module is None:
                    m = _MODULE_RE.match(line)
                    module = m.group(1) if m else None
                    continue
                m = _INSTR_RE.match(line)
                if m:
                    names[(module, m.group(1))] = m.group(2)
    return names


def _event_texts(ev, op_names):
    yield ev.name
    stats = dict(ev.stats)
    for val in stats.values():
        if isinstance(val, str):
            yield val
    yield op_names.get((stats.get("hlo_module"), stats.get("hlo_op")), "")


def device_lines(pd):
    """(plane, line) pairs holding the GPU's kernel events: the stream
    lines of each /device:GPU plane (not its module/step summaries)."""
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                yield plane, line


def union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def stage_times(path: str, top: int = 20, op_names=None) -> dict:
    """-> {"window_ns", "busy_ns", "idle_share", "stages": {name: ns},
    "top": [(kernel label, ns)] of the `top` costliest kernels} summed
    over every GPU of the trace; op_names as from hlo_op_names."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    op_names = op_names or {}
    per_stage = {s: 0 for s in STAGES + ("other",)}
    per_kernel = collections.Counter()
    busy = 0
    window = 0
    for plane in {p.name: p for p, _ in device_lines(pd)}.values():
        ivs = []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stage = stage_of(_event_texts(ev, op_names))
                per_stage[stage] += ev.duration_ns
                stats = dict(ev.stats)
                per_kernel[f"{stage} {ev.name} "
                           f"{stats.get('hlo_module', '')}"] += \
                    ev.duration_ns
                ivs.append((ev.start_ns, ev.end_ns))
        if ivs:
            busy += union_ns(ivs)
            window += max(e for _, e in ivs) - min(s for s, _ in ivs)
    return {"window_ns": window, "busy_ns": busy,
            "idle_share": 1 - busy / window if window else None,
            "stages": per_stage, "top": per_kernel.most_common(top)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    args = ap.parse_args(argv)
    path = newest_xplane(args.trace_dir)
    r = stage_times(path, op_names=hlo_op_names(
        os.path.join(args.trace_dir, "hlo")))
    print(f"trace {path}")
    print(f"window {r['window_ns'] / 1e6:.3f} ms, busy "
          f"{r['busy_ns'] / 1e6:.3f} ms, idle share {r['idle_share']}")
    for s, ns in r["stages"].items():
        print(f"  {s:14s} {ns / 1e6:10.3f} ms")
    for label, ns in r["top"]:
        print(f"  {ns / 1e6:10.3f} ms  {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
