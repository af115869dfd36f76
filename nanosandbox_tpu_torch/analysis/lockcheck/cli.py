"""CLI: ``python -m nanosandbox_tpu_torch.analysis lockcheck [options] <paths>``.

Flag-for-flag compatible with the host-sync CLI (same exit codes: 0
clean, 1 findings, 2 usage error; same --format/--out/--select/
--list-rules/--changed-only/--base/--strict-suppressions) plus one
extra input: ``--lock-order=FILE``, the committed tier ordering the
lock-order-inversion rule enforces (default: the package's own
``analysis/lock_order.json``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m nanosandbox_tpu_torch.analysis lockcheck",
        description="lockcheck: concurrency static analysis for the "
                    "serving host layer (shared-write guards, lock "
                    "ordering, blocking-under-lock, asyncio blocking, "
                    "leaked acquires).")
    ap.add_argument("paths", nargs="*", default=["nanosandbox_tpu_torch"],
                    help="files or directories to lint "
                         "(default: nanosandbox_tpu_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the report to FILE (JSON when "
                         "--format=json; CI uploads this as an artifact)")
    ap.add_argument("--select", default=None, metavar="RULES",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("--changed-only", action="store_true",
                    help="lint only files changed vs --base (from "
                         "`git diff --name-only`) — the fast pre-commit "
                         "run; CI keeps the full tree")
    ap.add_argument("--base", default="HEAD", metavar="REF",
                    help="git ref --changed-only diffs against "
                         "(default: HEAD)")
    ap.add_argument("--strict-suppressions", action="store_true",
                    help="a reasoned suppression that no longer matches "
                         "any finding becomes a finding itself (rot "
                         "gate)")
    ap.add_argument("--lock-order", default=None, metavar="FILE",
                    help="committed lock ordering JSON for the "
                         "lock-order-inversion rule (default: "
                         "the package's analysis/lock_order.json)")
    args = ap.parse_args(argv)

    from nanosandbox_tpu_torch.analysis.lockcheck.core import (
        DEFAULT_LOCK_ORDER, all_rules, analyze_paths, load_lock_order,
        render_json, render_text)

    if args.list_rules:
        for rid, rule in sorted(all_rules().items()):
            print(f"{rid}: {rule.doc}")
        return 0

    lock_order = None
    order_path = args.lock_order
    if order_path is None and Path(DEFAULT_LOCK_ORDER).exists():
        order_path = DEFAULT_LOCK_ORDER
    if order_path is not None:
        try:
            lock_order = load_lock_order(order_path)
        except (OSError, ValueError) as e:
            print(f"lockcheck: bad --lock-order file {order_path}: {e}",
                  file=sys.stderr)
            return 2

    paths = args.paths
    if args.changed_only:
        from nanosandbox_tpu_torch.analysis.__main__ import changed_only_paths
        try:
            paths = changed_only_paths(args.paths, args.base)
        except RuntimeError as e:
            print(f"lockcheck: {e}", file=sys.stderr)
            return 2
        if not paths:
            print(f"lockcheck: no changed Python files vs {args.base} "
                  f"under {args.paths!r} — nothing to lint")
            return 0

    select = ([r.strip() for r in args.select.split(",") if r.strip()]
              if args.select else None)
    try:
        report = analyze_paths(paths, select=select,
                               strict_suppressions=args.strict_suppressions,
                               lock_order=lock_order)
    except ValueError as e:
        print(f"lockcheck: {e}", file=sys.stderr)
        return 2
    if report["summary"]["files_scanned"] == 0:
        print(f"lockcheck: no Python files under {paths!r}",
              file=sys.stderr)
        return 2

    rendered = (render_json(report) if args.format == "json"
                else render_text(report))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(rendered + "\n")
        print(render_text(report))
    else:
        print(rendered)
    return 1 if report["summary"]["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
