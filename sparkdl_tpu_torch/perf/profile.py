"""Autotuned performance profiles: schema, storage, and the launcher
pre-flight that applies them.

Counterpart of ``sparkdl_tpu/perf/profile.py``. A profile is the
autotuner's emitted winner — a small JSON document (schema
``sparkdl_tpu.perf.profile/1``, the JAX record layout) mapping
registered *tunable* settings (:mod:`sparkdl_tpu_torch.utils.knobs`,
by their dotted names) to values, keyed by the card kind it was
measured on and stamped with the host fingerprint and git sha:

.. code-block:: json

    {"schema": "sparkdl_tpu.perf.profile/1",
     "device_kind": "h100",
     "host": "host/x86_64/cpu8", "git_sha": "1b268b0",
     "created": "2026-10-18T00:00:00Z", "bench": "serve",
     "status": "verified",
     "knobs": {"sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK": 8},
     "evidence": {"...": "trial + verification compare reports"}}

The values are JSON values of the setting's type (the JAX profile keeps
environment strings). A directory of profiles holds one per (card kind,
bench) under ``<dir>/<kind>/<bench>.json``: benches tune disjoint
settings, so a kind composes its profiles. The card kind is
:func:`strict_device_kind`: ``h100``, the key of
``observe.perf.PEAK_TABLE``, for the card the launch runs on; an unknown
card is None, and then no profile applies.

:data:`PROFILE` (the JAX package's ``SPARKDL_TPU_PERF_PROFILE``) is the
switch: None (the default) applies nothing — there is no default
profile directory, as ``observe.perf.HISTORY_PATH`` has no default
ledger; a file is exactly that profile; a directory is looked up by the
launch's card kind. The launcher's pre-flight (:func:`preflight_settings`,
called inside the function the supervisor retries) merges the profile's
settings into what every rank receives **under the operator**: a setting
the operator already moved off its registered default in the driver is
never overridden. A relaunched attempt gets the profile again.

Proof-or-degrade: the autotuner emits ``status: "verified"`` only after
a fresh winner-vs-default verification passes the ``observe.compare``
gate; a ``degraded`` profile records the candidate and the failing
report, and the pre-flight applies **nothing** from it and logs why.
Unknown or non-tunable names in a profile are skipped loudly: a profile
is not a path to set arbitrary settings.
"""

import glob
import json
import logging
import os
import sys
import time

logger = logging.getLogger("sparkdl.perf")

PROFILE_SCHEMA = "sparkdl_tpu.perf.profile/1"

STATUS_VERIFIED = "verified"
STATUS_DEGRADED = "degraded"

# the switch (the JAX package's SPARKDL_TPU_PERF_PROFILE), read at call
# time: None (off), a profile JSON, or a directory of <kind>/<bench>.json
PROFILE = None


class ProfileError(ValueError):
    """A profile document violates the schema contract."""


def strict_device_kind(raw):
    """The profile key of a card or platform name (``"NVIDIA H100 80GB
    HBM3"`` -> ``"h100"``, ``"cpu"``), or None when it cannot be named
    with confidence: never a guess."""
    from sparkdl_tpu_torch.observe.perf import normalize_device_kind

    return normalize_device_kind(raw) if raw else None


def profile_path(device_kind, bench, root):
    """Home of one (card kind, bench) profile under ``root``:
    ``<root>/<kind>/<bench>.json``. The kind must resolve strictly;
    keying a profile by a guessed kind would misfile it."""
    kind = strict_device_kind(device_kind)
    if kind is None:
        raise ProfileError(
            f"cannot key a profile by device kind {device_kind!r} "
            "(unknown kind — profiles are measurements, not guesses)")
    return os.path.join(root, kind, f"{bench}.json")


def make_profile(knobs_map, *, device_kind, bench, status,
                 evidence=None, candidate_knobs=None):
    """Build one schema-versioned profile doc. ``knobs_map`` must name
    registered TUNABLE settings only (the apply side checks again, but a
    malformed profile should fail at emit time, where the autotuner can
    see it)."""
    from sparkdl_tpu_torch.observe import perf as operf
    from sparkdl_tpu_torch.utils import knobs as knob_reg

    if status not in (STATUS_VERIFIED, STATUS_DEGRADED):
        raise ProfileError(f"unknown profile status {status!r}")
    for name in knobs_map:
        kb = knob_reg.get(name)
        if kb is None or not kb.tunable:
            raise ProfileError(
                f"profile knob {name!r} is not a registered tunable "
                "setting (sparkdl_tpu_torch/utils/knobs.py)")
    doc = {
        "schema": PROFILE_SCHEMA,
        "device_kind": device_kind,
        "host": operf.host_fingerprint(),
        "git_sha": operf.git_sha(),
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "bench": bench,
        "status": status,
        "knobs": dict(knobs_map),
    }
    if candidate_knobs:
        # the degraded case: what the search picked before the
        # verification trial refused it — kept for the postmortem
        doc["candidate_knobs"] = dict(candidate_knobs)
    if evidence:
        doc["evidence"] = evidence
    return doc


def save_profile(doc, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_profile(path):
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise ProfileError(f"unreadable profile {path}: {e}")
    if not isinstance(doc, dict) or doc.get("schema") != PROFILE_SCHEMA:
        raise ProfileError(
            f"{path} is not a {PROFILE_SCHEMA} document (schema="
            f"{doc.get('schema') if isinstance(doc, dict) else None!r})")
    if not isinstance(doc.get("knobs"), dict):
        raise ProfileError(f"{path} has no knobs map")
    return doc


def _card_name_without_context():
    """The first card's name from ``nvidia-smi``, which reads it without
    a CUDA context in this process; None when it cannot say."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    return lines[0].strip() if lines else None


def resolve_launch_device_kind():
    """The card kind a launch is about to run on, without creating a
    CUDA context in the driver: ``launcher.WORKER_DEVICE = "cpu"`` is
    ``cpu``; a driver whose CUDA context exists names its current card;
    a driver with cards but no context asks ``nvidia-smi``; no card at
    all is ``cpu`` (a gloo gang). Anything that cannot be named with
    confidence is None."""
    import torch

    from sparkdl_tpu_torch.horovod import launcher

    if launcher.WORKER_DEVICE == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    if torch.cuda.is_initialized():
        return strict_device_kind(
            torch.cuda.get_device_name(torch.cuda.current_device()))
    return strict_device_kind(_card_name_without_context())


def find_profiles(spec=None):
    """Every profile applicable to this launch, in deterministic
    (bench-name) order: ``[(doc, path), ...]`` (empty when none apply).
    ``spec`` defaults to :data:`PROFILE`. A spec that names neither a
    file nor a directory raises — an operator who pinned a profile must
    never silently run without it; a malformed file that ``spec`` names
    raises; one rotten profile in a directory is skipped with a warning
    and does not stop the kind's others."""
    spec = PROFILE if spec is None else spec
    if spec is None or str(spec).strip().lower() in ("", "0", "off",
                                                     "none"):
        return []
    spec = str(spec)
    if os.path.isfile(spec):
        return [(load_profile(spec), spec)]
    if not os.path.isdir(spec):
        raise ProfileError(
            f"perf.profile.PROFILE={spec} is neither a profile file nor a "
            "profile directory")
    kind = resolve_launch_device_kind()
    if kind is None:
        return []
    paths = sorted(glob.glob(os.path.join(spec, kind, "*.json")))
    flat = os.path.join(spec, f"{kind}.json")
    if os.path.isfile(flat):
        paths.append(flat)
    out = []
    for p in paths:
        try:
            out.append((load_profile(p), p))
        except ProfileError as e:
            logger.warning("perf profile %s ignored: %s", p, e)
    return out


def profile_settings_delta(doc, current=None):
    """The settings a profile contributes UNDER the operator: only
    registered tunable settings, only where the setting still holds its
    registered default (``current``: ``{name: value}`` to read instead
    of the live settings), and nothing at all from a degraded
    profile."""
    from sparkdl_tpu_torch.utils import knobs as knob_reg

    if doc.get("status") != STATUS_VERIFIED:
        logger.warning(
            "perf profile (bench=%s, device_kind=%s) is %s — "
            "verification regressed vs defaults; running on defaults",
            doc.get("bench"), doc.get("device_kind"), doc.get("status"))
        return {}
    delta = {}
    for name, value in sorted(doc.get("knobs", {}).items()):
        kb = knob_reg.get(name)
        if kb is None or not kb.tunable:
            logger.warning(
                "perf profile names %r, which is not a registered "
                "tunable setting — skipped (a profile is not a path to "
                "set arbitrary settings)", name)
            continue
        now = (knob_reg.read(name) if current is None
               else current.get(name, kb.default))
        if now != kb.default:
            # the operator moved it off its default: the last word
            continue
        delta[name] = value
    return delta


def preflight_settings(spec=None):
    """The launcher pre-flight: resolve and apply every profile for this
    launch (a setting two profiles both name keeps the first and logs
    the conflict). Returns ``{"module.NAME": value}`` (dotted names of
    :mod:`~sparkdl_tpu_torch.utils.knobs`) to merge into what every rank
    receives; empty when nothing applies. Logs one line per applying
    profile, and says so when the profile was measured on another host.
    Never raises: a broken profile must not take down a launch (it logs
    and degrades to defaults)."""
    from sparkdl_tpu_torch.observe import perf as operf

    delta = {}
    try:
        for doc, path in find_profiles(spec):
            one = profile_settings_delta(doc)
            for name in sorted(set(one) & set(delta)):
                logger.warning(
                    "perf profile %s also names %s (=%r); keeping the "
                    "earlier profile's %r", path, name, one[name],
                    delta[name])
                one.pop(name)
            if one:
                cross = (doc.get("host")
                         and doc.get("host") != operf.host_fingerprint())
                logger.info(
                    "perf profile %s (bench=%s, device_kind=%s%s): "
                    "applying %s", path, doc.get("bench"),
                    doc.get("device_kind"),
                    " — measured on a DIFFERENT host, advisory numbers"
                    if cross else "",
                    ", ".join(f"{k}={v!r}" for k, v in sorted(one.items())))
            delta.update(one)
        return delta
    except ProfileError as e:
        logger.warning("perf profile ignored: %s", e)
        return delta
    except Exception:  # noqa: BLE001 - never takes a launch down
        logger.warning("perf profile pre-flight failed; launching on "
                       "defaults", exc_info=True)
        return delta


def main(argv=None):
    """``python -m sparkdl_tpu_torch.perf.profile [PATH] [--profile
    SPEC]``: validate PATH, or show what a launch would apply under
    SPEC (a profile file or directory) — the operator's dry run of the
    pre-flight."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.perf.profile",
        description="Inspect/validate autotuned perf profiles.")
    ap.add_argument("path", nargs="?", help="profile JSON to validate")
    ap.add_argument("--profile", default=None,
                    help="resolve like the launcher pre-flight under this "
                    "profile file or directory")
    args = ap.parse_args(argv)
    if args.path:
        print(json.dumps(load_profile(args.path), indent=2, sort_keys=True))
        return 0
    found = find_profiles(args.profile)
    if not found:
        print("no profile applies (card kind: "
              f"{resolve_launch_device_kind()!r})")
        return 1
    for doc, path in found:
        print(f"profile: {path} (bench={doc.get('bench')}, "
              f"status={doc.get('status')})")
    print(json.dumps({"would_apply": preflight_settings(args.profile)},
                     indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
