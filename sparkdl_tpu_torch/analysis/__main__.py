"""CLI: ``python -m sparkdl_tpu_torch.analysis``.

Counterpart of ``sparkdl_tpu/analysis/__main__.py``. Modes compose in
one invocation; the exit status is 1 when any finding is an error (with
``--concur``, a warning not waived too), so a gate can key off it. The
graph passes lint a PyTorch step from Python (``analysis.lint_fn``,
``analysis.register_preflight``) or the port's own multi-rank program
here (``--graft``).

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
- ``--graft N``: build the port's dp+tp+sp+pp+ep LoRA step for an
  N-rank mesh (:func:`sparkdl_tpu_torch.graft_entry.build_multichip_step`,
  tiny, on the CPU) and trace it as every rank of the mesh on ``meta``
  tensors, in this process (no spawn, no card memory), then run every
  graph pass over the traces;
- ``--comms`` (with ``--graft``): also price its collectives
  (:func:`~sparkdl_tpu_torch.analysis.comms.comms_report`);
  ``--comms-out PATH`` writes the report (and implies ``--comms``);
- ``--fix`` (with ``--graft``): run the verified fix engine
  (:mod:`~sparkdl_tpu_torch.analysis.fixes`) over the program, each fix
  with its four proofs, and key the exit status off the findings left
  after the fixes; ``--dry-run`` proves the same without handing the
  fixed program on; ``--fixit-out PATH`` writes the
  ``fixit_report/1`` JSON (and implies ``--fix``);
- ``--format json``: the findings (and, with ``--comms`` or ``--fix``,
  the reports) as one JSON document;
- ``--list-rules``: the rule catalog (the graph passes' rules and every
  other rule), each fixable rule marked ``[fixable: <action>]``;
  ``--list-passes``: the graph passes alone.
"""

import argparse
import json
import sys

from sparkdl_tpu_torch.analysis.core import Finding, Severity


def _graft_context(n_devices):
    """The context of the port's multi-rank program, traced as every rank
    of its mesh, and the program itself."""
    import torch

    from sparkdl_tpu_torch.analysis import _context_for
    from sparkdl_tpu_torch.graft_entry import build_multichip_step

    # built at its tiny size on the CPU, traced on meta as the card's
    # program: bf16 and the flash kernels
    step, params, opt_state, batch, mesh, shardings = build_multichip_step(
        n_devices, device="cpu", dtype=torch.bfloat16, attention="flash")
    name = f"build_multichip_step({n_devices})"
    # one context (one trace of each rank) feeds the passes, the comms
    # budget AND the fix engine's before-side
    ctx = _context_for(step, (batch,), params=params, shardings=shardings,
                       mesh=mesh, name=name,
                       options={"n_devices": n_devices})
    graft = {"step": step, "params": params, "opt_state": opt_state,
             "batch": batch, "mesh": mesh, "shardings": shardings,
             "name": name}
    return ctx, graft


def _graft_findings(n_devices, with_comms=False, fix=False, dry_run=False):
    from sparkdl_tpu_torch.analysis import run_passes

    ctx, graft = _graft_context(n_devices)
    findings = run_passes(ctx)
    fixit_report = None
    if fix:
        from sparkdl_tpu_torch.analysis.fixes import fix_program

        result = fix_program(
            graft["step"], (graft["batch"],), params=graft["params"],
            shardings=graft["shardings"], mesh=graft["mesh"],
            name=graft["name"], options=dict(ctx.options),
            apply=not dry_run, ctx=ctx, findings=findings)
        fixit_report = result.report
        # with --fix the verdict previews the repaired program: a finding
        # a VERIFIED fix removes is no launch blocker
        findings = result.findings_after
        if not dry_run:
            ctx = result.ctx
    report = None
    if with_comms:
        from sparkdl_tpu_torch.analysis.comms import comms_report

        report = comms_report(ctx.trace, n_devices=n_devices,
                              name=graft["name"])
    return findings, report, fixit_report


def _render_comms(report):
    t = report["totals"]
    lines = [
        f"comms budget [{report['name']}] — {t['count']} collective(s), "
        f"{t['wire_bytes_per_device'] / 2**20:.2f} MiB a device on the "
        f"wire, ~{t['predicted_s'] * 1e3:.3f} ms a step predicted on "
        f"{report['device_kind']} "
        f"(interconnect {report['ici_bytes_per_sec']:.2e} B/s, ring "
        "assumption)"
    ]
    for kind, agg in sorted(t["by_kind"].items()):
        lines.append(
            f"  {kind:20s} x{agg['count']:<3d} "
            f"{agg['wire_bytes_per_device'] / 2**20:9.2f} MiB  "
            f"~{agg['predicted_s'] * 1e3:8.3f} ms")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.analysis",
        description="Lints of the port: the pickling contract and the "
                    "concurrency rules over its source; the rule and "
                    "graph-pass catalogs.")
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
    parser.add_argument("--list-passes", action="store_true",
                        help="print the graph passes and exit")
    parser.add_argument("--graft", type=int, metavar="N", default=None,
                        help="graph-lint the port's N-rank multichip "
                             "program (traced on meta, in this process)")
    parser.add_argument("--comms", action="store_true",
                        help="with --graft: also price its collectives "
                             "(bytes on the wire, predicted seconds)")
    parser.add_argument("--comms-out", metavar="PATH", default=None,
                        help="write the comms report JSON to PATH; "
                             "implies --comms")
    parser.add_argument("--fix", action="store_true",
                        help="with --graft: run the verified fix engine "
                             "and key the exit status off the findings "
                             "left after its fixes")
    parser.add_argument("--dry-run", action="store_true",
                        help="with --fix: the full fixit report, every "
                             "fix proven, the program handed on unfixed")
    parser.add_argument("--fixit-out", metavar="PATH", default=None,
                        help="write the fixit report JSON to PATH; "
                             "implies --fix")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    args = parser.parse_args(argv)

    if args.list_rules or args.list_passes:
        from sparkdl_tpu_torch.analysis.core import all_passes, rule_catalog
        from sparkdl_tpu_torch.analysis.fixes import FIX_ACTIONS

        table = (rule_catalog() if args.list_rules else
                 {r: (p.severities, p.doc) for r, p in all_passes().items()})
        for rule_id, (severities, doc) in table.items():
            mark = ""
            if args.list_rules and rule_id in FIX_ACTIONS:
                mark = f" [fixable: {FIX_ACTIONS[rule_id][0]}]"
            print(f"{rule_id:32s} {'/'.join(severities) or '-':16s} "
                  f"{doc}{mark}")
        return 0
    want_comms = args.comms or args.comms_out is not None
    want_fix = args.fix or args.fixit_out is not None
    if want_comms and args.graft is None:
        parser.error("--comms needs --graft N (the budget is priced from "
                     "a traced program)")
    if want_fix and args.graft is None:
        parser.error("--fix needs --graft N (fixes apply to a built "
                     "program, not source files)")
    if args.dry_run and not want_fix:
        parser.error("--dry-run only modifies --fix")

    from sparkdl_tpu_torch.analysis import concur, selflint

    # with --concur the positional paths feed the concurrency lint; the
    # pickling-contract lint still runs through --self
    targets = [] if args.concur else list(args.paths)
    if args.self_lint:
        targets.extend(selflint.self_targets())
    if not targets and not args.concur and args.graft is None:
        parser.error("nothing to lint: give paths, --self, --concur or "
                     "--graft N")
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

    comms_reports, fixit_reports = [], []
    if args.graft is not None:
        graft_findings, report, fixit_report = _graft_findings(
            args.graft, with_comms=want_comms, fix=want_fix,
            dry_run=args.dry_run)
        findings.extend(graft_findings)
        if report is not None:
            comms_reports.append(report)
        if fixit_report is not None:
            fixit_reports.append(fixit_report)
    if args.comms_out and comms_reports:
        from sparkdl_tpu_torch.analysis.comms import write_report

        write_report(comms_reports, args.comms_out)
    if args.fixit_out and fixit_reports:
        with open(args.fixit_out, "w") as f:
            json.dump({"reports": fixit_reports}, f, indent=2)

    findings.sort(key=lambda f: -int(f.severity))
    if args.format == "json":
        doc = [f.to_dict() for f in findings]
        if want_comms or want_fix:
            doc = {"findings": doc}
            if want_comms:
                doc["comms_reports"] = comms_reports
            if want_fix:
                doc["fixit_report"] = (fixit_reports[0]
                                       if len(fixit_reports) == 1
                                       else fixit_reports)
        print(json.dumps(doc, indent=2))
    else:
        for f in findings:
            print(f)
        n_err = sum(f.severity == Severity.ERROR for f in findings)
        n_warn = sum(f.severity == Severity.WARNING for f in findings)
        print(f"-- {len(findings)} finding(s): {n_err} error(s), "
              f"{n_warn} warning(s)" + (" (after --fix)" if want_fix
                                        else ""))
        if args.concur:
            print(f"-- concur: {n_waived} finding(s) waived via baseline, "
                  f"{n_stale} stale waiver(s)")
            for line in concur.render_suggestions(findings):
                print(line)
        if fixit_reports:
            from sparkdl_tpu_torch.analysis.fixes import render_fixit_text

            for rep in fixit_reports:
                print(render_fixit_text(rep))
        for report in comms_reports:
            print(_render_comms(report))
    # the gate: any error, and with --concur any warning not waived
    fail_at = Severity.WARNING if args.concur else Severity.ERROR
    return int(any(f.severity >= fail_at for f in findings))


if __name__ == "__main__":
    sys.exit(main())
