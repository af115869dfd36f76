"""The port's static analysis against the JAX package's, on the CPU.

* lockcheck: the port's copy gives the JAX lockcheck's findings (rule,
  line, message) and suppressed count on every bad and good fixture of
  tests/test_lockcheck.py, on its suppression cases (reasoned, standalone,
  bare, typo'd, in a string, another tool's tag, unused under
  --strict-suppressions) and on the JAX package's own serve/ tree (its
  suppressions stripped, under budgets/lock_order.json); the port's tree is clean under
  --strict-suppressions with its own lock-order file; a torch readback
  under a lock is flagged; the CLI runs with torch unimportable.
* host-sync (torchlint): each readback form is flagged in a hot function
  and not outside one or through tracecheck.host_sync; the port's tree is
  clean.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from nanosandbox_tpu.analysis.lockcheck import core as jlock
from nanosandbox_tpu_torch.analysis import analyze_paths as lint_paths
from nanosandbox_tpu_torch.analysis import analyze_source as lint_source
from nanosandbox_tpu_torch.analysis.lockcheck import core as tlock
from test_lockcheck import FIXTURES

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nanosandbox_tpu_torch"
JAX_ORDER = str(REPO / "budgets" / "lock_order.json")

BLOCKING = FIXTURES["blocking-under-lock"][0]
SLEEP = "            time.sleep(0.1)"
DISABLE = "# lockcheck: disable=blocking-under-lock"
# Suppression cases of tests/test_lockcheck.py, as sources.
SUPPRESSED = {
    "reasoned": BLOCKING.replace(SLEEP, f"{SLEEP}  {DISABLE} -- rig"),
    "standalone": BLOCKING.replace(
        SLEEP, f"            {DISABLE} -- rig\n            # prose\n{SLEEP}"),
    "past-code": BLOCKING.replace(
        "        with self._lock:",
        f"        {DISABLE} -- audits with\n        with self._lock:"),
    "bare": BLOCKING.replace(SLEEP, f"{SLEEP}  {DISABLE}"),
    "typo": BLOCKING.replace(SLEEP, f"{SLEEP}  {DISABLE}s -- typo"),
    "in-string": BLOCKING.replace(
        SLEEP, f"            s = '{DISABLE} -- x'\n{SLEEP}"),
    "other-tool": BLOCKING.replace(
        SLEEP, f"{SLEEP}  # jaxlint: disable=host-sync -- wrong tool"),
    "unused": "x = 1  # lockcheck: disable=leaked-acquire -- stale\n",
}

CASES = ([(rule, twin) for rule in sorted(FIXTURES)
          for twin in ("bad", "good")]
         + [(name, "suppression") for name in sorted(SUPPRESSED)]
         + [("jax-serve-tree", None)])


def _sources(case):
    rule, twin = case
    if twin == "suppression":
        return [("mod.py", SUPPRESSED[rule])], None
    if twin is not None:
        return [("mod.py", FIXTURES[rule][twin == "good"])], None
    # The JAX tree with its reasoned disables neutralised, so the raw
    # findings are compared, not two clean reports.
    return ([(str(f), f.read_text().replace("lockcheck: disable",
                                            "lockcheck- disable"))
             for f in sorted((REPO / "nanosandbox_tpu" / "serve")
                             .glob("*.py"))], JAX_ORDER)


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{r}-{t}" if t else r for r, t in CASES])
def test_lockcheck_findings_equal_jax(case):
    sources, order = _sources(case)
    jorder = jlock.load_lock_order(order) if order else None
    torder = tlock.load_lock_order(order) if order else None
    total = 0
    for path, src in sources:
        ref, jsup = jlock.analyze_source(src, path, lock_order=jorder,
                                         strict_suppressions=True)
        got, tsup = tlock.analyze_source(src, path, lock_order=torder,
                                         strict_suppressions=True)
        key = [(f.line, f.rule, f.message.replace("nanosandbox_tpu_torch",
                                                  "nanosandbox_tpu"))
               for f in got]
        assert key == [(f.line, f.rule, f.message) for f in ref], path
        assert tsup == jsup
        total += len(ref)
    if case[1] in ("bad", None):
        assert total > 0            # the comparison saw findings


def test_port_tree_is_lockcheck_clean():
    report = tlock.analyze_paths(
        [str(PORT)], strict_suppressions=True,
        lock_order=tlock.load_lock_order(tlock.DEFAULT_LOCK_ORDER))
    msgs = [f"{f['file']}:{f['line']} {f['rule']}: {f['message']}"
            for f in report["findings"]]
    assert not msgs, "\n".join(msgs)
    assert report["summary"]["files_scanned"] > 40
    assert report["unused_suppressions"] == []


def test_report_metrics_export():
    from nanosandbox_tpu_torch.analysis.lockcheck import export_report_metrics
    from nanosandbox_tpu_torch.obs import MetricRegistry, render_prometheus

    reg = MetricRegistry()
    export_report_metrics({"summary": {"files_scanned": 3, "suppressed": 2,
                                       "findings": 0, "by_rule": {}}}, reg)
    page = render_prometheus(reg)
    assert 'lockcheck_findings_total{rule="none"} 0' in page
    assert "lockcheck_files_scanned 3" in page


def test_torch_readback_under_a_lock_is_flagged():
    src = """
import threading

import torch


class Cache:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def refresh(self, t):
        with self._lock:
            self.value = t.item()
        with self._lock:
            torch.cuda.synchronize()
"""
    got, _ = tlock.analyze_source(src, "mod.py")
    assert [(f.line, f.rule) for f in got] == [
        (14, "blocking-under-lock"), (16, "blocking-under-lock")]
    assert "device readback" in got[0].message


def test_cli_runs_without_torch_importable():
    code = ("import sys; sys.modules['torch'] = None\n"
            "from nanosandbox_tpu_torch.analysis.__main__ import main\n"
            "raise SystemExit(main(['lockcheck', '--strict-suppressions',"
            " 'nanosandbox_tpu_torch']) or main(['--strict-suppressions',"
            " 'nanosandbox_tpu_torch']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lockcheck: 0 finding(s)" in proc.stdout
    assert "torchlint: 0 finding(s)" in proc.stdout


# ------------------------------------------------------------ host-sync

HOT = """
import torch

from nanosandbox_tpu_torch.utils import tracecheck


class Eng:
    def __init__(self):
        self._tok = torch.zeros(4)
        self._graph = None

    def step(self):
        self._dispatch()
        return {body}

    def _dispatch(self):
        self._graph.replay()

    def setup(self):
        return self._tok.tolist()
"""

BAD = {
    "item": "self._tok.sum().item()",
    "tolist": "self._tok.tolist()",
    "cpu": "self._tok.cpu()",
    "numpy": "self._tok.numpy()",
    "cuda-sync": "torch.cuda.synchronize()",
    "event-sync": "self._graph.synchronize()",
    "float": "float(self._tok[0])",
    "int": "int(self._tok.sum())",
    "bool": "bool(self._tok.any())",
    "print": "print(self._tok)",
}


@pytest.mark.parametrize("form", sorted(BAD))
def test_host_sync_rule_flags_readbacks_in_the_hot_set(form):
    got, _ = lint_source(HOT.format(body=BAD[form]), "mod.py")
    assert [(f.line, f.rule) for f in got] == [(14, "host-sync")], got
    good = [HOT.format(body="tracecheck.host_sync('x', self._tok)"),
            HOT.format(body=BAD[form] + "  # torchlint: disable=host-sync"
                       " -- the test's deliberate readback"),
            HOT.format(body="len(self._tok.shape)")]
    for src in good:
        assert lint_source(src, "mod.py") == ([], int("disable" in src))


def test_port_tree_is_host_sync_clean():
    report = lint_paths([str(PORT)], strict_suppressions=True)
    msgs = [f"{f['file']}:{f['line']} {f['message']}"
            for f in report["findings"]]
    assert not msgs, "\n".join(msgs)
    assert report["unused_suppressions"] == []
