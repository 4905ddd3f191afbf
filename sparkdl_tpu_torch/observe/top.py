"""``python -m sparkdl_tpu_torch.observe.top URL``: a refresh-loop
terminal view of a live gang's ``/statusz``.

Counterpart of ``sparkdl_tpu/observe/top.py``: point it at the address
the launcher logs (``statusz live at http://127.0.0.1:PORT/statusz``)
and watch each rank's step, beat age, median step, MFU and card memory,
the rolling attribution window, the alerts that fired, the profile
captures, and each registered fleet's replica table. Standard library
only (urllib, an ANSI clear). :func:`render` is the JAX module's frame,
but for the line of a gang whose alerts are off, which names the port's
switch.

``--once`` renders one frame and exits; ``--interval`` sets the refresh
period. Exit code 0 on a clean watch, 2 when the endpoint was never
reachable.
"""

import argparse
import json
import sys
import time
import urllib.error
import urllib.request


def fetch_status(url, timeout=5.0):
    """GET the /statusz JSON. Accepts a bare host:port, a server base
    URL, or the full /statusz URL."""
    if "://" not in url:
        url = f"http://{url}"
    if not url.rstrip("/").endswith("/statusz"):
        url = url.rstrip("/") + "/statusz"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))


def _fmt_bytes(n):
    if not isinstance(n, (int, float)):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return (f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}{unit}")
        n /= 1024.0
    return f"{n:.1f}TiB"


def _fmt(v, spec="{}"):
    return spec.format(v) if isinstance(v, (int, float)) else "-"


def render(doc):
    """One frame of the dashboard from a /statusz document. Pure
    string building — the unit the tests pin."""
    lines = []
    gang = doc.get("gang") or {}
    sup = doc.get("supervisor") or {}
    lines.append(
        "sparkdl-tpu gang status — "
        f"{gang.get('num_workers', '?')} worker(s), "
        f"attempt(s) {int(sup.get('attempts_total') or 0)}, "
        f"restart(s) {int(sup.get('restarts_total') or 0)}, "
        f"up {doc.get('uptime_s', 0):.0f}s")
    verdict = gang.get("hang_verdict")
    if verdict:
        lines.append(f"!! HANG VERDICT: {verdict}")

    ranks = doc.get("ranks") or {}
    perf = (doc.get("perf") or {}).get("per_rank") or {}
    window_s = (doc.get("perf") or {}).get("window_s")
    if ranks:
        lines.append("")
        lines.append(f"{'rank':>4} {'state':<12} {'step':>8} "
                     f"{'beat':>7} {'med step':>10} {'mfu':>7} "
                     f"{'hbm':>10}  last collective")
        for rank_s in sorted(ranks, key=lambda r: (len(r), r)):
            info = ranks[rank_s]
            p = perf.get(rank_s) or {}
            hbm = info.get("hbm") or {}
            used = hbm.get("in_use", hbm.get(
                "peak", hbm.get("live_buffers")))
            beat = info.get("beat_age_s")
            lines.append(
                f"{rank_s:>4} {info.get('state', '?'):<12} "
                f"{_fmt(info.get('step'), '{}'):>8} "
                f"{_fmt(beat, '{:.1f}s'):>7} "
                f"{_fmt(p.get('median_step_s'), '{:.4f}s'):>10} "
                f"{_fmt(p.get('mfu'), '{:.3f}'):>7} "
                f"{_fmt_bytes(used):>10}  "
                f"{info.get('collective') or '-'}")
    if perf and window_s is not None:
        effs = [p.get("overlap_efficiency") for p in perf.values()
                if isinstance(p.get("overlap_efficiency"),
                              (int, float))]
        if effs:
            lines.append(
                f"overlap efficiency (last {window_s:.0f}s window): "
                + ", ".join(f"{e * 100:.0f}%" for e in effs))

    alerts = doc.get("alerts") or {}
    fired = alerts.get("fired") or []
    if not alerts.get("enabled"):
        lines.append("")
        lines.append("alerts: disabled (set alerts.ENABLED = True)")
    elif not fired:
        lines.append("")
        lines.append(
            f"alerts: none fired ({len(alerts.get('rules') or [])} "
            "rule(s) armed)")
    else:
        from sparkdl_tpu_torch.observe.alerts import format_alert_line

        lines.append("")
        lines.append(f"alerts: {len(fired)} fired")
        for a in fired:
            lines.append("  " + format_alert_line(a))

    captures = doc.get("captures") or {}
    inflight = captures.get("in_flight") or []
    done = captures.get("completed") or []
    if inflight or done:
        lines.append("")
        head = (f"profile captures: {len(inflight)} in flight, "
                f"{len(done)} completed")
        if captures.get("on_alert"):
            head += (f" (on-alert armed, cooldown "
                     f"{_fmt(captures.get('cooldown_s'), '{:.0f}s')})")
        lines.append(head)
        for c in inflight:
            lines.append(
                f"  rank {c.get('rank')} capturing "
                f"[{c.get('rule') or c.get('reason')}] ...")
        for c in done:
            line = (f"  rank {c.get('rank')} "
                    f"[{c.get('rule') or c.get('reason')}]: "
                    f"{_fmt(c.get('steps_captured'), '{}')} step(s)")
            if c.get("report"):
                line += f" -> {c['report']}"
            if c.get("trace_dir"):
                # a directory (xprof) gets its slash, a trace file none
                line += f" + {c['trace_dir']}" + (
                    "" if c["trace_dir"].endswith(".json") else "/")
            lines.append(line)

    for fleet in doc.get("fleet") or []:
        lines.append("")
        lines.append(
            f"fleet @ {':'.join(str(p) for p in fleet.get('address', []))}"
            f" — depth {fleet.get('queue_depth')}/"
            f"{fleet.get('max_queue')}, "
            f"{fleet.get('restarts', 0)} restart(s)")
        lines.append(f"{'replica':>8} {'alive':>6} {'queued':>7} "
                     f"{'inflight':>9}  restart cause")
        for rep in fleet.get("replicas", []):
            lines.append(
                f"{rep.get('replica'):>8} "
                f"{str(bool(rep.get('alive'))).lower():>6} "
                f"{_fmt(rep.get('queued'), '{}'):>7} "
                f"{_fmt(rep.get('inflight'), '{}'):>9}  "
                f"{rep.get('restart_cause') or '-'}")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.observe.top",
        description="Terminal refresh-loop view of a live gang's "
                    "/statusz endpoint.",
    )
    parser.add_argument("url", help="statusz address (host:port, base "
                        "URL, or the full /statusz URL)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh period in seconds (default 2)")
    parser.add_argument("--once", action="store_true",
                        help="render one frame and exit")
    args = parser.parse_args(argv)

    seen_one = False
    try:
        while True:
            try:
                doc = fetch_status(args.url)
            except (urllib.error.URLError, OSError, ValueError) as e:
                if args.once or not seen_one:
                    print(f"observe.top: {args.url} unreachable ({e})",
                          file=sys.stderr)
                    return 2
                # a gang that finished mid-watch is a clean exit
                print("observe.top: endpoint gone (gang finished?)")
                return 0
            seen_one = True
            frame = render(doc)
            if args.once:
                print(frame)
                return 0
            # ANSI clear + home keeps the view in place like top(1)
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
