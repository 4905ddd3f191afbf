"""``sparkdl_tpu_torch.perf``: the closed loop from measurement to
settings.

Counterpart of ``sparkdl_tpu/perf``:

- :mod:`sparkdl_tpu_torch.perf.autotune` — the search driver. Derives
  its space from the :mod:`sparkdl_tpu_torch.utils.knobs` registry,
  runs short measured trials (:mod:`sparkdl_tpu_torch.perf.trial`, the
  ``serve`` and ``train`` harnesses) in bounded subprocesses, judges
  every candidate with ``observe.compare``'s rep-sample medians and IQR
  thresholds, and prunes the space with step-time attribution.
- :mod:`sparkdl_tpu_torch.perf.profile` — the per-card profile the
  winner is emitted as (schema ``sparkdl_tpu.perf.profile/1``, keyed
  ``h100``), and the launcher pre-flight that applies it to every rank
  of every supervised attempt, under the operator.

CLI: ``python -m sparkdl_tpu_torch.perf.autotune --bench serve``.
"""

from sparkdl_tpu_torch.perf.profile import (  # noqa: F401
    PROFILE_SCHEMA,
    ProfileError,
    load_profile,
    preflight_settings,
    save_profile,
)
