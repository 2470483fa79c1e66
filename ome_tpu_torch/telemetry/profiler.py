"""On-demand torch.profiler capture behind `POST /debug/profile`.

Port of ome_tpu/telemetry/profiler.py (which wraps jax.profiler). When
a replica serves slow, grab an N-second device trace from the LIVE
process (no restart, no redeploy) and open it in Perfetto or
`chrome://tracing`. The endpoint is guarded twice — it only exists
when the operator launched with `--profile-dir`, and captures are
serialized (a second concurrent request gets 409 instead of corrupting
the active trace).

On a card the capture runs `torch.profiler.profile` with CUDA activity
for `seconds` on the calling (HTTP handler) thread. CUDA activity is
recorded for the whole process through CUPTI, so the trace holds the
kernels the scheduler thread launches in the window; CPU-side operator
events would cover only the sleeping handler thread and are not
recorded. The Chrome trace lands in `out_dir` as
`trace-<pid>-<n>.json`. A process's first capture also pays
torch.profiler's start, which imports torch._dynamo (seconds on a
card's machine): its window opens that much after the request. A capture either writes its trace or raises:
one that meets another active torch.profiler session of this process
(`session()`, which the port's other profiling paths enter too, or a
session the profiler itself refuses) raises ProfileInProgress.

Off the card the capture is the reference's structured no-op: the
endpoint answers `captured: false` and the platform name rather than
tracing the CPU plain versions nobody asked to profile.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

MAX_SECONDS = 60.0

_capture_lock = threading.Lock()
_traces = itertools.count()


class ProfileInProgress(RuntimeError):
    """Another capture is running; the caller should retry later."""


@contextlib.contextmanager
def session(activities=None):
    """An exclusive torch.profiler session of this process: yields the
    running `torch.profiler.profile`; raises ProfileInProgress while
    another session (a capture, or any other caller of `session`) is
    active, or when torch refuses to start one."""
    from torch.profiler import ProfilerActivity, profile
    if not _capture_lock.acquire(blocking=False):
        raise ProfileInProgress("a profile capture is already running")
    try:
        prof = profile(activities=activities or [ProfilerActivity.CUDA])
        try:
            prof.__enter__()
        except RuntimeError as e:  # torch's own "already enabled"
            raise ProfileInProgress(str(e)) from e
        try:
            yield prof
        finally:
            prof.__exit__(None, None, None)
    finally:
        _capture_lock.release()


def capture(out_dir: str, seconds: float = 1.0, ledger=None) -> dict:
    """Blocking N-second device trace into `out_dir`.

    Returns a summary dict (the HTTP response body). When the engine
    carries a program cost ledger (perf/ledger.py), its per-program
    summary rides along under "programs" — the trace shows WHERE time
    went, the ledger says what each program SHOULD cost. Raises
    ProfileInProgress when a capture is already active, ValueError for
    an unusable duration.
    """
    seconds = float(seconds)
    if not (0 < seconds <= MAX_SECONDS):
        raise ValueError(
            f"seconds must be in (0, {MAX_SECONDS:g}], got {seconds}")
    if not torch.cuda.is_available():
        result = {"captured": False, "platform": "cpu",
                  "note": "profiler capture is a no-op off the card"}
        if ledger is not None:
            result["programs"] = ledger.summary()
        return result
    t0 = time.monotonic()
    with session() as prof:
        time.sleep(seconds)
    took = time.monotonic() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"trace-{os.getpid()}-{next(_traces)}.json")
    prof.export_chrome_trace(path)
    result = {"captured": True, "platform": "gpu", "dir": out_dir,
              "trace": path, "seconds": round(took, 3)}
    if ledger is not None:
        result["programs"] = ledger.summary()
    return result
