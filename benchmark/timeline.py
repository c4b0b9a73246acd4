"""Reading torch.profiler's chrome trace of a measured window.

The arithmetic is `ds2i_torch/tools/pass_timeline.py`'s: the device's
busy time is the union of its kernel, copy and set intervals; what the
host was doing is the benchmark's own spans (`record_function` around
the public calls prepare, dispatch and collect). Times are microseconds
in the trace and seconds in what this module returns.
"""

import json

SPANS = ("prepare", "dispatch", "sync", "collect")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals):
    """Total length covered by (start, end) intervals, and the covered
    runs, merged and in order."""
    total, runs = 0.0, []
    for s, e in sorted(intervals):
        if runs and s <= runs[-1][1]:
            if e > runs[-1][1]:
                total += e - runs[-1][1]
                runs[-1][1] = e
        else:
            total += e - s
            runs.append([s, e])
    return total, runs


def analyse(path):
    """{window_s, busy_s, kernels: {name: (launches, seconds)}, gaps:
    [(host span, seconds)]: the device's idle time by what the host was
    doing}. Device work that starts within the "window" span counts, and
    is cut at its end."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    win = [e for e in ann if e["name"] == "window"]
    if len(win) != 1:
        raise RuntimeError(f"{len(win)} window spans in the trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1]
    kernels = {}
    for e in device:
        if e.get("cat") == "kernel":
            n, s = kernels.get(e["name"], (0, 0.0))
            kernels[e["name"]] = (n + 1, s + e["dur"] * 1e-6)
    busy, runs = union([(e["ts"], min(e["ts"] + e["dur"], w1)) for e in device])
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ann if e["name"] in SPANS)
    # each idle stretch, split by the host span it overlaps ("client"
    # where the host was in none: drawing the next batch, the harness)
    gaps, at, si = [], w0, 0
    for s, e in runs + [[w1, w1]]:
        if s > at:
            while si < len(spans) and spans[si][1] <= at:
                si += 1
            covered, sj = 0.0, si
            while sj < len(spans) and spans[sj][0] < s:
                part = min(spans[sj][1], s) - max(spans[sj][0], at)
                if part > 0:
                    gaps.append((spans[sj][2], part * 1e-6))
                    covered += part
                sj += 1
            gaps.append(("client", (s - at - covered) * 1e-6))
        at = max(at, e)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6, "kernels": kernels, "gaps": gaps}


def breakdown(a, top=10):
    """The device operations that took the most time, by kernel name, and
    the idle time by what the host was doing, each at most `top`."""
    ops = sorted(((name, s) for name, (_, s) in a["kernels"].items()), key=lambda x: -x[1])
    idle = {}
    for name, s in a["gaps"]:
        idle[name] = idle.get(name, 0.0) + s
    return {"device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda x: -x[1])[:top]]}
