"""The profiler window of a traced run, and what is read from it.

The window is recorded by the PyTorch profiler through CUPTI (kineto), CUDA
activity only: every kernel, copy and set on the device, and every CUDA
runtime or driver call on the host with its thread. Host operators are not
recorded: at Makona width an HMC proposal makes about 400,000 of them,
whose recording and reading would outlast a run. The profiler is driven
through its low-level calls, so that stopping it returns the raw events
and skips the Python-side tree that `profile.__exit__` would build.
`Trace` reduces the events to what the per-layer readers in `metrics/`
need.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

# runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemcpyPeer")


class Profiler:
    """start() and stop() -> the raw kineto events of the window."""

    def __init__(self, cuda: bool):
        from torch.autograd import profiler as tap

        self._prof = tap.profile(use_device="cuda" if cuda else None,
                                 use_cpu=not cuda, use_kineto=True)

    def start(self):
        from torch.autograd import _enable_profiler, _prepare_profiler

        cfg = self._prof.config()
        acts = self._prof.kineto_activities
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts)

    @staticmethod
    def stop():
        from torch.autograd import _disable_profiler

        return _disable_profiler().events()


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The window's events, reduced. Times are nanoseconds on the
    profiler's clock; every duration returned is in seconds. The window
    runs from the first host call to the end of the last device operation.
    The main thread is the one that made the first call (the step
    loop's)."""

    def __init__(self, events):
        self.device_ops = []  # (name, start, end, correlation id)
        calls = []  # (start, end, name, thread, correlation id)
        for ev in events:
            start = ev.start_ns()
            end = start + ev.duration_ns()
            if "CUDA" in str(ev.device_type()):
                self.device_ops.append((ev.name(), start, end,
                                        ev.correlation_id()))
            else:
                calls.append((start, end, ev.name(), ev.start_thread_id(),
                              ev.correlation_id()))
        if not calls:
            raise ValueError("the trace holds no host call")
        calls.sort()
        self.main_thread = calls[0][3]
        self.syncs = sorted(c[0] for c in calls if c[2] in SYNC_CALLS)
        self.main_calls = [c for c in calls if c[3] == self.main_thread]
        self.start = calls[0][0]
        self.end = max([c[1] for c in calls]
                       + [e for _, _, e, _ in self.device_ops])
        self.window_s = (self.end - self.start) * 1e-9
        self.busy = _union([(max(s, self.start), min(e, self.end))
                            for _, s, e, _ in self.device_ops
                            if min(e, self.end) > max(s, self.start)])
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-9
        self.call_start = {c[4]: c[0] for c in calls}

    def kernel_time(self, names) -> tuple:
        """(instances, device seconds) of the device operations whose name
        contains one of `names`."""
        hits = [e - s for n, s, e, _ in self.device_ops
                if any(k in n for k in names)]
        return len(hits), sum(hits) * 1e-9

    def syncs_within(self, spans) -> int:
        """Synchronising runtime calls that began inside one of `spans`
        ([start, end) on the profiler's clock)."""
        return sum(bisect.bisect_left(self.syncs, e)
                   - bisect.bisect_left(self.syncs, s) for s, e in spans)

    def launched_within(self, spans) -> float:
        """Device seconds of the operations whose launching call began
        inside one of `spans` ([start, end) on the profiler's clock)."""
        spans = sorted(spans)
        starts = [a for a, _ in spans]
        total = 0
        for _, s, e, corr in self.device_ops:
            t = self.call_start.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < spans[i][1]:
                total += e - s
        return total * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the step loop's thread was doing when each gap began: the CUDA
        call it was in, or else host code (Python, operators) up to its
        next call, named."""
        by_name = defaultdict(int)
        for n, s, e, _ in self.device_ops:
            by_name[n[:160]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = defaultdict(int)
        edges = [self.start] + [t for span in self.busy for t in span]
        edges.append(self.end)
        starts = [c[0] for c in self.main_calls]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and self.main_calls[i][1] > a:
                label = f"in {self.main_calls[i][2]}"
            elif i + 1 < len(self.main_calls):
                label = f"host code, then {self.main_calls[i + 1][2]}"
            else:
                label = "host code"
            gaps[label[:160]] += b - a
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t * 1e-9] for n, t in ops],
                "idle_gaps": [[n, t * 1e-9] for n, t in idle]}
