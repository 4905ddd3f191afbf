"""The settings registry: every module setting of the port, registered
once — settings are data, not code.

Counterpart of ``sparkdl_tpu/utils/knobs.py``. The JAX package reads ~90
``SPARKDL_TPU_*`` environment variables; the port reads none (ROADMAP
C3): each knob is a module setting, read at call time
(``observe.alerts.CHECK_S = 2.0``). This registry is their single
catalog: the setting's dotted path (:attr:`Knob.name`), the JAX knob it
stands for (:attr:`Knob.env`; None for a setting of the port alone),
type, default, owning subsystem, a one-liner, and whether it is
**tunable**: a performance setting the
:mod:`sparkdl_tpu_torch.perf.autotune` search may vary per card, as
opposed to wiring, test plumbing or fault injection. The autotuner
derives its space from :func:`tunable_knobs`.

Every JAX knob is either the ``env`` of one registered setting or in
:data:`UNMAPPED` with the reason the port has no counterpart
(``tests/test_torch_knobs.py`` holds both registries against each
other).

Tunable settings carry two more fields the search reads:

- ``trial_values``: the candidate values a short trial may measure
  (small on purpose; an operator widens it with ``--values``).
- ``component``: the step-time attribution component (or serving stat)
  that must be *material* for the setting to matter; the pruner drops
  it when a report shows that component negligible. None: never
  pruned.

``default`` is the setting's value as the module defines it, a Python
value (the JAX registry keeps strings of the environment's spelling).
"""

import dataclasses
import importlib

__all__ = [
    "Knob",
    "KNOBS",
    "UNMAPPED",
    "all_knobs",
    "by_env",
    "get",
    "is_registered",
    "owner",
    "parse_value",
    "read",
    "registered_names",
    "tunable_knobs",
]

_PKG = "sparkdl_tpu_torch"


@dataclasses.dataclass(frozen=True)
class Knob:
    """One registered module setting."""

    name: str            # dotted path: "sparkdl_tpu_torch.observe.FLUSH_S"
    type: str            # int | float | bool | str | enum | path | list | tuple
    default: object = None
    subsystem: str = "misc"
    help: str = ""
    tunable: bool = False
    trial_values: tuple = ()
    benches: tuple = ()  # trial harnesses that honor it: serve|train|gbdt
    component: str = None  # attribution component gating its relevance
    env: str = None      # the JAX knob it stands for


def _build():
    def k(name, type_, default=None, subsystem="misc", help_="", *,
          env=None, tunable=False, trial_values=(), benches=(),
          component=None):
        return Knob(name=f"{_PKG}.{name}", type=type_, default=default,
                    subsystem=subsystem, help=help_, tunable=tunable,
                    trial_values=tuple(trial_values),
                    benches=tuple(benches), component=component,
                    env=env and f"SPARKDL_TPU_{env}")

    knobs = [
        # -- tunable performance settings (the autotune search space) --
        k("perf.trial.LOSS_CHUNK", "int", 512, "train",
          "vocab-chunk size of the chunked LM loss in the train trial's "
          "step", env="LOSS_CHUNK", tunable=True,
          trial_values=(256, 512, 1024), benches=("train",)),
        k("parallel.ring_attention.OVERLAP", "bool", True, "parallel",
          "hop schedule of a ring attention or pipeline called with "
          "overlap=None", env="OVERLAP", tunable=True,
          trial_values=(False, True), component="collective"),
        k("models.speculative.DEFAULT_K", "int", 4, "serving",
          "speculative-decode draft length when the caller passes no k",
          env="SPEC_DRAFT_K", tunable=True, trial_values=(2, 4, 8)),
        k("perf.trial.SERVE_PAGE_SIZE", "int", 64, "serving",
          "serve trial's KV page size: 0 = dense slot cache, > 0 = the "
          "paged pool", env="KV_PAGE_SIZE", tunable=True,
          trial_values=(0, 64), benches=("serve",)),
        k("perf.trial.SERVE_DECODE_CHUNK", "int", 16, "serving",
          "serve trial's decode chunk (engine steps between scheduler "
          "turns)", env="SERVE_DECODE_CHUNK", tunable=True,
          trial_values=(4, 8, 16), benches=("serve",)),
        k("perf.trial.SERVE_REPLICAS", "int", 1, "serving",
          "serve trial's FleetFrontend replicas", env="SERVE_REPLICAS",
          tunable=True, trial_values=(1, 2), benches=("serve",)),
        k("perf.trial.SERVE_MAX_QUEUE", "int", None, "serving",
          "serve trial's fleet admission bound (None: 4x total slots)",
          env="SERVE_MAX_QUEUE", tunable=True, trial_values=(16, 64),
          benches=("serve",), component="queue_wait"),
        k("perf.trial.SERVE_QUANT", "enum", "int8", "serving",
          "serve trial's weights: '' (bf16) | int8 | int4 weight-only",
          env="SERVE_QUANT", tunable=True, trial_values=("", "int8"),
          benches=("serve",)),
        k("perf.trial.GBDT_MAX_BINS", "int", 256, "gbdt",
          "gbdt trial's histogram bin count (max_bin of its estimator)",
          env="GBDT_MAX_BINS", tunable=True, trial_values=(64, 128, 256),
          benches=("gbdt",)),

        # -- perf platform --------------------------------------------
        k("perf.profile.PROFILE", "path", None, "perf",
          "autotuned profile the launcher pre-flight applies: a profile "
          "JSON or a directory of per-card profiles (None: off)",
          env="PERF_PROFILE"),
        k("observe.perf.HISTORY_PATH", "path", None, "perf",
          "the regression ledger (history.jsonl; None: none)",
          env="PERF_HISTORY"),

        # -- the GBDT estimators --------------------------------------
        k("xgboost.DEVICE", "str", None, "gbdt",
          "the estimators' device: None (the card, or a gang rank's "
          "bound device) or 'cpu'"),
        k("xgboost.xgboost.STRICT_SLOTS", "bool", False, "gbdt",
          "num_workers beyond the task slots fails instead of an "
          "oversubscribed local gang", env="XGB_STRICT_SLOTS"),
        k("xgboost.xgboost.VAL_GATHER_WARN_BYTES", "int", 256 << 20,
          "gbdt", "partition-resident fit: warn when gathering the "
          "validation rows to every worker passes this many bytes",
          env="VAL_GATHER_WARN_BYTES"),

        # -- gang wiring (launcher) ------------------------------------
        k("horovod.launcher.HOSTS", "str", None, "gang",
          "hosts x slots topology spec", env="HOSTS"),
        k("horovod.launcher.NUM_SLOTS", "int", None, "gang",
          "task-slot override (bypasses counting the cards)",
          env="NUM_SLOTS"),
        k("horovod.launcher.SLOT_DIR", "path", None, "gang",
          "slot claim-file registry dir", env="SLOT_DIR"),
        k("horovod.launcher.SLOT_WAIT_TIMEOUT_S", "float", 600.0, "gang",
          "wait for busy slots before giving up (s)",
          env="SLOT_WAIT_TIMEOUT"),
        k("horovod.launcher.START_TIMEOUT_S", "float", 300.0, "gang",
          "gang rendezvous deadline (s)", env="START_TIMEOUT"),
        k("horovod.launcher.JOB_TIMEOUT_S", "float", None, "gang",
          "whole-gang deadline (s; None: no limit)"),
        k("horovod.launcher.ABORT_GRACE_S", "float", 30.0, "gang",
          "grace before killing survivors of a dead rank (s)",
          env="ABORT_GRACE"),
        k("horovod.launcher._DUMP_GRACE_S", "float", 10.0, "gang",
          "wait for stalled ranks' stack dumps before the kill (s)",
          env="DUMP_GRACE"),
        k("horovod.launcher.WORKER_DEVICE", "str", None, "gang",
          "the workers' device: None (a card a rank) or 'cpu'",
          env="WORKER_PLATFORM"),
        k("horovod.launcher.REMOTE_SHELL", "str", None, "gang",
          "remote-exec command override ('none' disables)",
          env="REMOTE_SHELL"),
        k("horovod.launcher.REMOTE_PYTHON", "path", None, "gang",
          "python on task nodes", env="REMOTE_PYTHON"),
        k("horovod.control_plane.MAX_RESULT_TOTAL", "int", 4 << 30,
          "gang", "cap on rank 0's cloudpickled result (bytes)",
          env="MAX_RESULT_BYTES"),

        # -- supervision / elasticity ----------------------------------
        k("horovod.supervisor.RetryPolicy.max_retries", "int", 0,
          "supervisor", "relaunch budget for transient failures "
          "(supervisor.policy's field)", env="GANG_MAX_RETRIES"),
        k("horovod.supervisor.RetryPolicy.backoff_base", "float", 1.0,
          "supervisor", "backoff base (s)", env="GANG_BACKOFF_BASE"),
        k("horovod.supervisor.RetryPolicy.backoff_factor", "float", 2.0,
          "supervisor", "backoff growth factor",
          env="GANG_BACKOFF_FACTOR"),
        k("horovod.supervisor.RetryPolicy.backoff_max", "float", 60.0,
          "supervisor", "backoff cap (s)", env="GANG_BACKOFF_MAX"),
        k("horovod.supervisor.RetryPolicy.jitter", "float", 0.5,
          "supervisor", "jitter fraction on top of each delay",
          env="GANG_BACKOFF_JITTER"),
        k("horovod.supervisor.RetryPolicy.resume_dir", "path", None,
          "supervisor", "TrainCheckpointer root for resume-step "
          "discovery", env="GANG_RESUME_DIR"),
        k("horovod.supervisor.RetryPolicy.extra_patterns", "tuple", (),
          "supervisor", "extra transient traceback signatures",
          env="TRANSIENT_PATTERNS"),
        k("horovod.supervisor.RetryPolicy.relaunch_np", "int", None,
          "supervisor", "elastic relaunch target np (reshard pre-flight "
          "gated)", env="GANG_RELAUNCH_NP"),
        k("horovod.elastic.ENABLED", "bool", False, "supervisor",
          "the capacity-watching elastic controller", env="ELASTIC"),
        k("horovod.elastic.PROBE", "enum", "auto", "supervisor",
          "capacity probe: auto | setting | file | devices | slots",
          env="ELASTIC_PROBE"),
        k("horovod.elastic.CAPACITY", "int", None, "supervisor",
          "capacity override in cards", env="ELASTIC_CAPACITY"),
        k("horovod.elastic.CAPACITY_FILE", "path", None, "supervisor",
          "file re-read every poll whose content is the capacity",
          env="ELASTIC_CAPACITY_FILE"),
        k("horovod.elastic.CHECK_S", "float", 2.0, "supervisor",
          "capacity poll cadence (s)", env="ELASTIC_CHECK_S"),
        k("horovod.elastic.DEBOUNCE_S", "float", 10.0, "supervisor",
          "surplus capacity must hold this long before a grow is "
          "planned", env="ELASTIC_DEBOUNCE_S", tunable=True,
          trial_values=(5.0, 10.0, 30.0)),
        k("horovod.elastic.MARGIN", "float", 0.8, "supervisor",
          "ledger gate: a grow must keep this fraction of the per-card "
          "throughput", env="ELASTIC_MARGIN", tunable=True,
          trial_values=(0.7, 0.8, 0.9)),
        k("horovod.elastic.CKPT_WAIT_S", "float", 60.0, "supervisor",
          "max wait for a step boundary after a resize decision",
          env="ELASTIC_CKPT_WAIT_S"),
        k("horovod.elastic.MAX_NP", "int", None, "supervisor",
          "hard cap on the elastic grow target", env="ELASTIC_MAX_NP"),
        k("horovod.elastic.MIN_NP", "int", 1, "supervisor",
          "floor the arbiter may not shrink training below",
          env="ELASTIC_MIN_NP"),
        k("horovod.elastic.ARBITER", "bool", False, "supervisor",
          "the train/serve card-budget arbiter", env="ELASTIC_ARBITER"),
        k("horovod.elastic.ARBITER_RULES", "tuple",
          ("queue_depth_growth", "server_ttft"), "supervisor",
          "alert rules whose firings count as serving demand",
          env="ELASTIC_ARBITER_RULES"),
        k("horovod.elastic.ARBITER_CHIPS", "int", 1, "supervisor",
          "cards yielded per arbiter demand", env="ELASTIC_ARBITER_CHIPS"),
        k("horovod.elastic.ARBITER_CLEAR_S", "float", 30.0, "supervisor",
          "quiet period before training reclaims yielded cards",
          env="ELASTIC_ARBITER_CLEAR_S"),

        # -- the input pipeline ----------------------------------------
        # not tunable: no trial harness of the port reads its batches
        # through prefetch_to_device (the JAX knob's is the cpu-proxy
        # bench's input pipeline)
        k("utils.data.PREFETCH_DEPTH", "int", None, "data",
          "host-side producer queue bound of prefetch_to_device (None: "
          "its size; deeper read-ahead for spiky producers)",
          env="PREFETCH_DEPTH", component="data_wait"),

        # -- the runtime's own lints -----------------------------------
        k("analysis.preflight.ENABLED", "bool", False, "analysis",
          "launcher pre-flight: lint main's captures, refuse the launch "
          "on ERROR", env="PREFLIGHT_LINT"),
        k("analysis.preflight.FIX", "bool", False, "analysis",
          "launcher pre-flight (with ENABLED): run the verified fix engine "
          "over every registered step and replace it with the fixed one",
          env="PREFLIGHT_FIX"),
        k("utils.locksan.ENABLED", "bool", False, "analysis",
          "instrument threading.Lock/RLock at boot (the lock-order "
          "sanitizer)", env="CONCUR_SAN"),
        k("utils.locksan.HOLD_WARN_S", "float", 1.0, "analysis",
          "sanitizer long-hold threshold (s)", env="CONCUR_HOLD_WARN_S"),
        k("utils.locksan.REPORT", "path", None, "analysis",
          "sanitizer report path (None: the telemetry dir's "
          "concur_report.json, else no file)", env="CONCUR_REPORT"),
        k("utils.locksan.STACK_DEPTH", "int", 12, "analysis",
          "frames kept per recorded acquisition stack",
          env="CONCUR_STACK_DEPTH"),

        # -- observability ---------------------------------------------
        k("observe.TELEMETRY_DIR", "path", None, "observe",
          "opt-in telemetry root (run-* dirs)", env="TELEMETRY_DIR"),
        k("observe.FLUSH_S", "float", 5.0, "observe",
          "periodic telemetry flush interval", env="TELEMETRY_FLUSH_S"),
        k("observe.health.HEARTBEAT_S", "float", 10.0, "observe",
          "worker heartbeat period", env="HEARTBEAT_S"),
        k("observe.health.STALL_S", "float", 300.0, "observe",
          "per-rank stall threshold for the hang detector",
          env="STALL_S"),
        k("models.fleet.DEFAULT_HANG_S", "float", 60.0, "observe",
          "a fleet replica's no-progress window (hang_seconds=None)",
          env="SERVE_HANG_S"),
        k("observe.serving.WRITE_S", "float", 30.0, "observe",
          "serving telemetry write period", env="SERVING_WRITE_S"),
        k("observe.serving.MAX_EVENTS", "int", 100_000, "observe",
          "serving span-tree event cap", env="SERVING_TRACE_EVENTS"),
        k("observe.flightrec.EVENTS", "int", 256, "observe",
          "flight-recorder ring capacity", env="FLIGHTREC_EVENTS"),
        k("utils.profiler.PROFILE_DIR", "path", None, "observe",
          "torch.profiler traces of every rank's main", env="PROFILE"),
        k("observe.forensics.ON_ALERT", "bool", False, "observe",
          "perf-alert firings trigger a forensic capture on the rank",
          env="PROFILE_ON_ALERT"),
        k("observe.capture.STEPS", "int", 20, "observe",
          "train steps one forensic capture window spans",
          env="PROFILE_STEPS"),
        k("observe.forensics.COOLDOWN_S", "float", 300.0, "observe",
          "per-(rule, rank) cooldown between alert-triggered captures",
          env="PROFILE_COOLDOWN_S"),
        k("observe.capture.AT_STEP", "int", None, "observe",
          "capture one window when the rank reaches this step",
          env="PROFILE_AT_STEP"),
        k("observe.mem.SAMPLE_S", "float", 2.0, "observe",
          "memory sampler cadence (s)", env="MEM_SAMPLE_S"),
        k("observe.mem.TOP_BUFFERS", "int", 8, "observe",
          "rows of the largest-live-buffer table", env="MEM_TOP_BUFFERS"),
        k("observe.mem.SAMPLES", "int", 64, "observe",
          "in-process memory sample tail length", env="MEM_SAMPLES"),
        k("observe.statusz.PORT", "int", None, "observe",
          "driver-side live status HTTP port (None: no thread, no "
          "socket)", env="STATUSZ_PORT"),
        k("observe.alerts.ENABLED", "bool", False, "observe",
          "the streaming SLO alert engine", env="ALERTS"),
        k("observe.alerts.WINDOW_S", "float", 60.0, "observe",
          "rolling window for live attribution and alert rules (s)",
          env="ALERT_WINDOW_S"),
        k("observe.alerts.CHECK_S", "float", 5.0, "observe",
          "alert rule evaluation cadence (s)", env="ALERT_CHECK_S"),
        k("observe.alerts.STEP_FACTOR", "float", 2.0, "observe",
          "step-time regression fires at median > factor x baseline",
          env="ALERT_STEP_FACTOR"),
        k("observe.alerts.STEP_BASELINE_S", "float", None, "observe",
          "explicit step-time baseline (s)", env="ALERT_STEP_BASELINE_S"),
        k("observe.alerts.MIN_STEPS", "int", 5, "observe",
          "minimum windowed steps before step/overlap rules judge",
          env="ALERT_MIN_STEPS"),
        k("observe.alerts.MFU_MIN", "float", None, "observe",
          "mfu_drop alert floor (dormant unless set)",
          env="ALERT_MFU_MIN"),
        k("observe.alerts.OVERLAP_MIN", "float", None, "observe",
          "overlap_drop alert floor (dormant unless set)",
          env="ALERT_OVERLAP_MIN"),
        k("observe.alerts.QUEUE_GROWTH", "float", None, "observe",
          "queue_depth_growth alert rate floor per second",
          env="ALERT_QUEUE_GROWTH"),
        k("observe.alerts.HBM_FRAC", "float", 0.9, "observe",
          "hbm_high_water alert fraction of the card's memory",
          env="ALERT_HBM_FRAC"),
        k("observe.alerts.HEARTBEAT_GAP_FRAC", "float", 0.5, "observe",
          "heartbeat_gap warns at this fraction of the stall window",
          env="ALERT_HEARTBEAT_GAP_FRAC"),
        k("observe.alerts.TTFT_P99_S", "float", None, "observe",
          "server_ttft alert bound (s)", env="ALERT_TTFT_P99_S"),
        k("observe.alerts.HBM_LEAK_BYTES_PER_STEP", "float", None,
          "observe", "hbm_leak alert bound",
          env="ALERT_HBM_LEAK_BYTES_PER_STEP"),
        k("observe.alerts.RSS_GROWTH_BYTES_PER_STEP", "float", None,
          "observe", "host_rss_growth alert bound",
          env="ALERT_RSS_GROWTH_BYTES_PER_STEP"),

        # -- fault injection (test-only family) ------------------------
        k("utils.chaos.KILL_RANK", "int", None, "chaos",
          "rank to kill at the configured step", env="CHAOS_KILL_RANK"),
        k("utils.chaos.KILL_STEP", "int", None, "chaos",
          "step at which the victim dies", env="CHAOS_KILL_STEP"),
        k("utils.chaos.KILL_PHASE", "str", None, "chaos",
          "boot|step kill phase", env="CHAOS_KILL_PHASE"),
        k("utils.chaos.KILL_SIGNAL", "int", None, "chaos",
          "signal delivered to the victim", env="CHAOS_KILL_SIGNAL"),
        k("utils.chaos.STALL_STEP", "int", None, "chaos",
          "step at which the victim stalls", env="CHAOS_STALL_STEP"),
        k("utils.chaos.STALL_STEP_RANK", "int", None, "chaos",
          "rank that stalls", env="CHAOS_STALL_STEP_RANK"),
        k("utils.chaos.RENDEZVOUS_STALL_S", "float", None, "chaos",
          "rendezvous stall injection", env="CHAOS_RENDEZVOUS_STALL_S"),
        k("utils.chaos.RENDEZVOUS_STALL_RANK", "int", None, "chaos",
          "rank whose rendezvous stalls",
          env="CHAOS_RENDEZVOUS_STALL_RANK"),
        k("utils.chaos.CP_DROP", "list", None, "chaos",
          "control frames to drop", env="CHAOS_CP_DROP"),
        k("utils.chaos.CP_DELAY_S", "float", None, "chaos",
          "control-frame delay injection", env="CHAOS_CP_DELAY_S"),
        k("utils.chaos.MUTE_HEARTBEAT", "bool", None, "chaos",
          "suppress a rank's heartbeats", env="CHAOS_MUTE_HEARTBEAT"),
        k("utils.chaos.ONCE_FILE", "path", None, "chaos",
          "fire-once latch file for injections", env="CHAOS_ONCE_FILE"),
        k("utils.chaos.LEAK_BYTES_PER_STEP", "int", None, "chaos",
          "host bytes deliberately leaked per step",
          env="CHAOS_LEAK_BYTES_PER_STEP"),
        k("utils.chaos.LEAK_RANK", "int", None, "chaos",
          "rank that leaks (None: every rank)", env="CHAOS_LEAK_RANK"),
    ]
    reg = {}
    for knob in knobs:
        if knob.name in reg:
            raise ValueError(f"duplicate setting registration: {knob.name}")
        reg[knob.name] = knob
    return reg


KNOBS = _build()

_BENCH = ("a knob of the JAX package's bench harnesses (bench.py, "
          "benchmarks/); the port has no bench harness yet")
_COMPILE = ("the XLA executable cache (parallel/compile.py) has no "
            "PyTorch counterpart")

# Every JAX knob with no port setting, and why.
UNMAPPED = {f"SPARKDL_TPU_{name}": reason for name, reason in {
    "BENCH_NO_DONATE": "selects bench.py's undonated control step; torch "
                       "has no buffer donation and the port no bench.py",
    "PEAK_FLOPS": "the port's peaks are observe.perf.PEAK_TABLE's rows "
                  "(h100, cpu), with no override",
    "PEAK_BYTES_PER_S": "the port's peaks are observe.perf.PEAK_TABLE's "
                        "rows, with no override",
    "PEAK_ICI_BYTES_PER_S": "the port's peaks are observe.perf."
                            "PEAK_TABLE's rows, with no override",
    "HBM_BYTES": "the card's memory comes from torch.cuda, with no "
                 "override",
    "BENCH_TINY": _BENCH, "BENCH_PLATFORM": _BENCH,
    "BENCH_CPU_PROXY": _BENCH, "BENCH_PROBE_TIMEOUT": _BENCH,
    "BENCH_PROBE_PAUSE": _BENCH, "BENCH_PROBE_PAUSES": _BENCH,
    "BENCH_RUN_TIMEOUT": _BENCH, "BENCH_CACHE_MAX_AGE": _BENCH,
    "BENCH_STALE_AGE": _BENCH, "BENCH_PYTEST_STALE_AGE": _BENCH,
    "BENCH_PROMOTED": _BENCH, "VARIANTS_FULL": _BENCH, "WORKLOAD": _BENCH,
    "SERVE_SMOKE_TTFT_P99_S": _BENCH,
    "SERVE_SMOKE_INTER_TOKEN_P99_S": _BENCH,
    "COLOCATION_TTFT_P99_S": _BENCH,
    "BENCH_CAPTURE": _BENCH, "BENCH_CAPTURE_DIR": _BENCH,
    "RANK": "torch.distributed's RANK, set by the launcher a worker",
    "SIZE": "torch.distributed's WORLD_SIZE, set by the launcher",
    "LOCAL_RANK": "torch.distributed's LOCAL_RANK, set by the launcher",
    "LOCAL_SIZE": "torch.distributed's LOCAL_WORLD_SIZE, set by the "
                  "launcher",
    "COORDINATOR": "the rendezvous is a TCPStore on port 0 "
                   "(MASTER_ADDR / MASTER_PORT)",
    "COORDINATOR_PORT": "the rendezvous store takes any free port",
    "CONTROL_ADDR": "the launcher's control-plane address variable "
                    "(control_plane.CONTROL_ADDR_ENV), wiring",
    "CONTROL_SECRET": "the secret reaches a worker on its standard input",
    "PAYLOAD": "the payload reaches a worker on its standard input",
    "JOB_DIR": "the job dir is a worker's --job-dir argument",
    "FORCE_PLATFORM": "the device reaches a worker as its --device "
                      "argument",
    "MAX_RESTARTS": "legacy alias of GANG_MAX_RETRIES: "
                    "RetryPolicy.max_retries",
    "RESTART_ATTEMPT": "the restart context is a worker's --attempt",
    "RESUME_STEP": "the restart context is a worker's --resume-step",
    "RESHARD_SOURCE_AXES": "the restart context is a worker's "
                           "--source-axes",
    "RESHARD_TARGET_AXES": "the restart context is a worker's "
                           "--target-axes",
    "RESHARD_GROUPED": "a resharded restore places leaf by leaf "
                       "(utils/checkpoint.py)",
    "TRACE_DIR": "legacy alias; utils.profiler.PROFILE_DIR",
    "NATIVE_LOGS": "native/ is not ported: the Python LogRing stands "
                   "for the native control-plane ring",
    "COMPILE_CACHE_DIR": _COMPILE, "COMPILE_CACHE_MAX_AOT": _COMPILE,
    "COMPILE_CACHE_MIN_COMPILE_S": _COMPILE,
    "COMPILE_CACHE_MIN_BYTES": _COMPILE,
    "FLASH_BLOCK": "a TPU tile: the Hopper flash kernels' tiles are "
                   "fixed in csrc/flash_attention.cu (flash_block "
                   "raises)",
    "FLASH_BLOCK_Q": "a TPU tile: the Hopper flash kernels' tiles are "
                     "fixed (block_q raises)",
    "FLASH_BLOCK_KV": "a TPU tile: the Hopper flash kernels' tiles are "
                      "fixed (block_kv raises)",
    "PAGED_PAGES_PER_BLOCK": "a TPU tile: the Hopper paged-decode kernel "
                             "splits over pages by its own plan",
    "KERNEL_QUANT_MATMUL": "the port launches its CUDA kernel on every "
                           "CUDA tensor: there is no fallback to select",
    "TORCH_DLPACK": "the port's torch tensors need no jax bridge; "
                    "utils/interop.py is ported",
}.items()}


def all_knobs():
    """Every registered setting, name-sorted."""
    return [KNOBS[n] for n in sorted(KNOBS)]


def get(name):
    """The registered :class:`Knob`, or None."""
    return KNOBS.get(name)


def by_env(env):
    """The setting that stands for the JAX knob ``env``, or None."""
    for knob in KNOBS.values():
        if knob.env == env:
            return knob
    return None


def registered_names():
    """The registered settings' dotted names."""
    return frozenset(KNOBS)


def is_registered(name):
    return name in KNOBS


def tunable_knobs(bench=None):
    """The autotune search space: tunable settings, optionally
    restricted to those a trial harness (``serve`` | ``train`` |
    ``gbdt``) honors."""
    out = [kb for kb in all_knobs() if kb.tunable]
    if bench is not None:
        out = [kb for kb in out if bench in kb.benches]
    return out


def owner(path):
    """The object a dotted ``path`` of this package names: the longest
    importable module prefix, then attributes (``...supervisor.
    RetryPolicy``)."""
    parts = path.split(".")
    if parts[0] != _PKG:
        raise KeyError(f"{path!r} is not a {_PKG} path")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise KeyError(path)


def read(name):
    """The setting's current value. Unregistered names raise — reading
    through the registry is how call sites stay on the catalog."""
    kb = KNOBS.get(name)
    if kb is None:
        raise KeyError(f"unregistered setting {name!r}; add it to "
                       "sparkdl_tpu_torch.utils.knobs.KNOBS")
    module, attr = name.rsplit(".", 1)
    return getattr(owner(module), attr)


def parse_value(kb, raw):
    """A command-line spelling of a value of ``kb`` (``--values``):
    ``none`` is None, a bool takes 0/1/true/false, numbers their type."""
    if not isinstance(raw, str):
        return raw
    if raw.strip().lower() == "none":
        return None
    if kb.type == "int":
        return int(raw)
    if kb.type == "float":
        return float(raw)
    if kb.type == "bool":
        low = raw.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"{kb.name}: {raw!r} is not a bool")
    return raw
