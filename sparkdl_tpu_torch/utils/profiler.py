"""A rank's profile: a ``torch.profiler`` window written as a Chrome
trace, and named regions that join such a trace to the gang timeline.

Counterpart of ``sparkdl_tpu/utils/profiler.py``, whose traces are JAX
profiler (xprof) directories; here each :func:`trace` window is one
Chrome trace (``<log_dir>/trace-<pid>-<n>.json``, readable in Perfetto
or ``chrome://tracing``), with CUDA activity when the process has a
card. Profile a whole HorovodRunner job with the module setting
:data:`PROFILE_DIR` (the JAX module's ``SPARKDL_TPU_PROFILE``; no
environment variable is read): the driver ships it to every rank, whose
bootstrap runs ``main`` under :func:`maybe_trace_worker`, each rank
writing under ``<PROFILE_DIR>/rank-<r>``. The on-demand captures of
:mod:`sparkdl_tpu_torch.observe.capture` are a different thing: a
window the driver asks of a running rank.
"""

import contextlib
import itertools
import os

# where each rank of a gang writes its trace (None: no trace)
PROFILE_DIR = None

_seq = itertools.count()


@contextlib.contextmanager
def trace(log_dir):
    """A ``torch.profiler`` window over the block, its Chrome trace
    written under ``log_dir`` when the block ends; yields ``log_dir``.
    CPU activity always, CUDA activity when a card is available."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_seq)}.json")
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def maybe_trace_worker(rank):
    """Trace this rank under ``<PROFILE_DIR>/rank-<rank>`` when
    :data:`PROFILE_DIR` is set; yields the directory, or None."""
    if not PROFILE_DIR:
        yield None
        return
    with trace(os.path.join(PROFILE_DIR, f"rank-{rank}")) as d:
        yield d


@contextlib.contextmanager
def annotate(name):
    """A region under the same name in both timelines: the
    ``torch.profiler`` trace (``record_function``) of a :func:`trace`
    window, and the gang timeline (an ``observe.span`` of
    ``cat="xprof"``, the JAX package's category), merged across ranks
    into the run dir's ``timeline.json``. The name joins the two: find
    the region on the gang timeline, then the same name in that rank's
    trace. Each side does nothing outside its window or with telemetry
    off, so ``annotate`` can stay in the code."""
    import torch

    from sparkdl_tpu_torch import observe

    with torch.profiler.record_function(name):
        with observe.span(name, cat="xprof"):
            yield
