"""CLI: ``python -m nanosandbox_tpu_torch.analysis [lockcheck] <paths>``.

Two tools, one entry point, both pure ``ast`` (no torch import):

  * torchlint (default) — the host-sync rule over the port's hot set
    (analysis/rules_sync.py): no device readback in the functions that
    replay CUDA graphs or drive the training step, outside the blessed
    ``utils.tracecheck.host_sync``. Exit status is the gate: 0 clean, 1
    findings, 2 usage error. The JSON report (``--format=json``,
    optionally ``--out=FILE``) is schema-versioned.
  * ``lockcheck`` subcommand — the concurrency analyzer for the serving
    host layer (``python -m nanosandbox_tpu_torch.analysis lockcheck
    --help``); same flags and exit codes plus the committed lock-ordering
    file ``analysis/lock_order.json``.

The JAX package's other jaxlint rules and its shardcheck check traced
XLA programs; the port compiles none and has no counterpart of them.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def changed_only_paths(paths, base: str, cwd=None):
    """Resolve the lint set from ``git diff --name-only <base>`` —
    staged + unstaged changes vs the base commit, the fast pre-commit
    path (CI keeps the full run). Returns the changed .py files that
    live under one of ``paths``. Untracked files are invisible to
    ``git diff``; ``git add`` them first (as a pre-commit run has)."""
    from pathlib import Path

    proc = subprocess.run(
        ["git", "diff", "--name-only", base],
        capture_output=True, text=True, cwd=cwd)
    if proc.returncode != 0:
        raise RuntimeError(
            f"git diff --name-only {base} failed: "
            f"{proc.stderr.strip() or 'not a git checkout?'}")
    # git prints REPO-ROOT-relative paths regardless of where it ran;
    # resolving them against the cwd would silently drop every changed
    # file when invoked from a subdirectory.
    top = subprocess.run(["git", "rev-parse", "--show-toplevel"],
                         capture_output=True, text=True, cwd=cwd)
    if top.returncode != 0:
        raise RuntimeError("git rev-parse --show-toplevel failed: "
                           f"{top.stderr.strip()}")
    root_dir = Path(top.stdout.strip())
    base_dir = Path(cwd) if cwd else Path.cwd()
    roots = [(base_dir / p).resolve() for p in paths]
    missing = [str(p) for p, r in zip(paths, roots) if not r.exists()]
    if missing:
        # A root that resolves to nothing (e.g. the default
        # 'nanosandbox_tpu_torch' run from a subdirectory) must fail loudly
        # like the plain run does — not degrade into an empty changed
        # set and a green exit.
        raise RuntimeError(
            f"path(s) {missing} do not exist relative to {base_dir}")
    out = []
    for line in proc.stdout.splitlines():
        f = root_dir / line.strip()
        if not f.suffix == ".py" or not f.exists():
            continue           # deleted files have nothing to lint
        r = f.resolve()
        if any(r == root or root in r.parents for root in roots):
            out.append(str(f))
    return out


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if argv and argv[0] == "lockcheck":
        from nanosandbox_tpu_torch.analysis.lockcheck.cli import main as lc_main

        return lc_main(argv[1:])

    ap = argparse.ArgumentParser(
        prog="python -m nanosandbox_tpu_torch.analysis",
        description="torchlint: the host-sync rule over the functions "
                    "that replay CUDA graphs or drive the training step. "
                    "For the concurrency analyzer run the `lockcheck` "
                    "subcommand.")
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
    args = ap.parse_args(argv)

    from nanosandbox_tpu_torch.analysis.core import (all_rules, analyze_paths,
                                               render_json, render_text)

    if args.list_rules:
        for rid, rule in sorted(all_rules().items()):
            print(f"{rid}: {rule.doc}")
        return 0

    paths = args.paths
    if args.changed_only:
        try:
            paths = changed_only_paths(args.paths, args.base)
        except RuntimeError as e:
            print(f"torchlint: {e}", file=sys.stderr)
            return 2
        if not paths:
            print(f"torchlint: no changed Python files vs {args.base} "
                  f"under {args.paths!r} — nothing to lint")
            return 0

    select = ([r.strip() for r in args.select.split(",") if r.strip()]
              if args.select else None)
    try:
        report = analyze_paths(paths, select=select,
                               strict_suppressions=args.strict_suppressions)
    except ValueError as e:
        print(f"torchlint: {e}", file=sys.stderr)
        return 2
    if report["summary"]["files_scanned"] == 0:
        print(f"torchlint: no Python files under {paths!r}",
              file=sys.stderr)
        return 2

    rendered = (render_json(report) if args.format == "json"
                else render_text(report))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(rendered + "\n")
        # The log still gets the human-readable summary.
        print(render_text(report))
    else:
        print(rendered)
    return 1 if report["summary"]["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
