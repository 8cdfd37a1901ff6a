"""A ``torch.profiler`` stretch of frames, reduced to what the per-layer
readers take: device events, the harness's spans and the host's ops.

Busy time is the union of the kernel, memset and memcpy intervals inside
the traced frames, the method of the repository's ``profile_steps.py``.
Each idle gap of the device is labelled by what the host was doing at
its midpoint: the innermost harness span (``bench.entry``: inside the
program's call; ``bench.read_count``: reading the count back;
``bench.sync``: the synchronize; ``bench.drop``: freeing the answer)
and the innermost host op open then (``python`` when none was).
"""

import collections
import json
import os
import re
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
SPANS = ("bench.frame", "bench.entry", "bench.read_count", "bench.sync",
         "bench.drop")


def kernel_pattern(names):
    """A regex that finds any of the kernel ``names`` in a demangled
    device event name."""
    alts = "|".join(re.escape(n) for n in names)
    return re.compile(rf"(?<![A-Za-z0-9_])(?:{alts})(?=[<(])")


def load_kernel_names(path):
    return [ln.strip() for ln in Path(path).read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]


def base_name(event):
    """A device event's name without return type, namespaces in
    parentheses, template arguments or argument list."""
    name = event["name"].removeprefix("void ")
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:80]


class Trace:
    """The traced frames: ``device`` events, ``busy_s``, ``window_s``
    (first frame's start to last frame's end), ``frames``, and the idle
    gaps with their labels."""

    def __init__(self, events, frames, kernels):
        self.frames = frames
        self.kernels = kernels
        frame_spans = [e for e in events if e.get("ph") == "X"
                       and e.get("name") == "bench.frame"]
        self.t0 = min(e["ts"] for e in frame_spans)
        self.t1 = max(e["ts"] + e["dur"] for e in frame_spans)
        self.window_s = (self.t1 - self.t0) / 1e6
        self.device = [e for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS
                       and self.t0 <= e["ts"] < self.t1]
        tids = {(e["pid"], e["tid"]) for e in frame_spans}
        self.host = [e for e in events if e.get("ph") == "X"
                     and (e.get("pid"), e.get("tid")) in tids
                     and (e.get("cat") == "cpu_op" or e["name"] in SPANS)]
        self.launcher = {e["args"]["External id"]: e["name"]
                         for e in self.host if e.get("cat") == "cpu_op"
                         and "External id" in e.get("args", {})}
        self.busy = self._merge()
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6

    def _merge(self):
        merged = []
        for s, e in sorted((ev["ts"], min(ev["ts"] + ev["dur"], self.t1))
                           for ev in self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def is_kernel(self, event):
        return event["cat"] == "kernel" and bool(
            self.kernels.search(event["name"]))

    def gaps(self):
        """(start, seconds) of each idle stretch inside the window."""
        out, t = [], self.t0
        for s, e in self.busy:
            if s > t:
                out.append((t, (s - t) / 1e6))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, (self.t1 - t) / 1e6))
        return out

    def gap_labels(self):
        """Idle seconds by what the host was doing, largest first."""
        ops = sorted(self.host, key=lambda e: (e["ts"], -e["dur"]))
        totals = collections.Counter()
        stack, i = [], 0
        for start, secs in sorted(self.gaps()):
            t = start + secs * 5e5
            while i < len(ops) and ops[i]["ts"] <= t:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] <= ops[i]["ts"]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
                stack.pop()
            span = next((e["name"] for e in reversed(stack)
                         if e["name"] in SPANS), "outside frames")
            op = stack[-1]["name"] if stack and stack[-1]["name"] not in SPANS \
                else "python"
            totals[f"{span.removeprefix('bench.')}: {op}"] += secs
        return totals.most_common()

    def op_name(self, event):
        """A device event's name: the kernel's, and for any other event
        the host op that launched it too (``aten::sort: ...``)."""
        name = base_name(event)
        op = self.launcher.get(event.get("args", {}).get("External id"))
        return name if op is None or self.is_kernel(event) \
            else f"{op}: {name}"

    def top_ops(self):
        """Device seconds by op name, largest first."""
        totals = collections.Counter()
        for e in self.device:
            totals[self.op_name(e)] += e["dur"] / 1e6
        return totals.most_common()


def profile(run_frame, frames, kernels):
    """Run ``run_frame(k, span)`` for k < ``frames`` under the profiler;
    ``span(name)`` opens a harness span. Returns a :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for k in range(frames):
            with record_function("bench.frame"):
                run_frame(k, record_function)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, frames, kernels)
