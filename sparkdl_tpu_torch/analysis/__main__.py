"""CLI: ``python -m sparkdl_tpu_torch.analysis``.

Counterpart of ``sparkdl_tpu/analysis/__main__.py``, its AST modes only
(the jaxpr and HLO modes, ``--graft``, ``--comms`` and ``--fix``, read
XLA programs and are not ported). Modes compose in one invocation; the
exit status is 1 when any finding is an error (with ``--concur``, a
warning not waived too), so a gate can key off it.

- positional paths: the pickling-contract lint
  (:mod:`~sparkdl_tpu_torch.analysis.selflint`) over ``.py`` files and
  directories;
- ``--self``: the same lint over the port's own surface
  (``sparkdl_tpu_torch/`` and ``chip_smoke.py``);
- ``--concur``: the concurrency lint
  (:mod:`~sparkdl_tpu_torch.analysis.concur`) over ``sparkdl_tpu_torch/``
  — or over the positional paths when given — minus the waiver baseline
  (``--baseline PATH``, ``none`` for no waivers; default the committed
  ``concur_baseline.json``); ``--out PATH`` writes every finding,
  waived ones flagged, as JSON.
- ``--list-rules``: the rule catalog.
"""

import argparse
import json
import sys

from sparkdl_tpu_torch.analysis.core import Finding, Severity


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.analysis",
        description="AST lints of the port's runtime: the pickling "
                    "contract and the concurrency rules.")
    parser.add_argument(
        "paths", nargs="*",
        help=".py files or directories (the pickling-contract lint, or "
             "with --concur the concurrency lint)")
    parser.add_argument("--self", dest="self_lint", action="store_true",
                        help="lint the port's package and chip_smoke.py")
    parser.add_argument("--concur", action="store_true",
                        help="the concurrency lint, the baseline's "
                             "waivers subtracted")
    parser.add_argument("--baseline", metavar="PATH", default=None,
                        help="waiver baseline for --concur (default: the "
                             "committed concur_baseline.json; 'none': no "
                             "waivers)")
    parser.add_argument("--out", metavar="PATH", default=None,
                        help="write every --concur finding (waived ones "
                             "flagged) as JSON to PATH")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        from sparkdl_tpu_torch.analysis.core import rule_catalog

        for rule_id, (severities, doc) in rule_catalog().items():
            print(f"{rule_id:32s} {'/'.join(severities) or '-':16s} {doc}")
        return 0

    from sparkdl_tpu_torch.analysis import concur, selflint

    # with --concur the positional paths feed the concurrency lint; the
    # pickling-contract lint still runs through --self
    targets = [] if args.concur else list(args.paths)
    if args.self_lint:
        targets.extend(selflint.self_targets())
    if not targets and not args.concur:
        parser.error("nothing to lint: give paths, --self or --concur")
    findings = selflint.lint_paths(targets) if targets else []
    n_waived = n_stale = 0
    if args.concur:
        raw = concur.lint_paths(list(args.paths) or
                                concur.self_runtime_targets())
        waivers = ([] if args.baseline == "none"
                   else concur.load_baseline(args.baseline))
        kept, waived, stale = concur.apply_baseline(raw, waivers)
        n_waived, n_stale = len(waived), len(stale)
        findings.extend(kept)
        for w in stale:
            findings.append(Finding(
                rule_id=w.get("rule", "concur-baseline"),
                severity=Severity.INFO, op=w.get("op", ""),
                location=w.get("path", ""),
                message=("stale waiver (no matching finding) — remove it "
                         f"from concur_baseline.json: {w.get('reason', '')}"),
            ))
        if args.out:
            waived_ids = {id(f) for f in waived}
            with open(args.out, "w") as f:
                json.dump({"schema": concur.REPORT_SCHEMA,
                           "findings": [dict(x.to_dict(),
                                             waived=id(x) in waived_ids)
                                        for x in raw],
                           "stale_waivers": stale}, f, indent=2)

    findings.sort(key=lambda f: -int(f.severity))
    for f in findings:
        print(f)
    n_err = sum(f.severity == Severity.ERROR for f in findings)
    n_warn = sum(f.severity == Severity.WARNING for f in findings)
    print(f"-- {len(findings)} finding(s): {n_err} error(s), "
          f"{n_warn} warning(s)")
    if args.concur:
        print(f"-- concur: {n_waived} finding(s) waived via baseline, "
              f"{n_stale} stale waiver(s)")
        for line in concur.render_suggestions(findings):
            print(line)
    # the gate: any error, and with --concur any warning not waived
    fail_at = Severity.WARNING if args.concur else Severity.ERROR
    return int(any(f.severity >= fail_at for f in findings))


if __name__ == "__main__":
    sys.exit(main())
