"""The port's runtime analysis on the CPU: schedcheck and tracecheck.

* schedcheck has teeth: a planted lock-order inversion and a crashed
  traffic thread are recorded as violations;
* the fuzz loops run clean over the port's serve host: the router (3
  seeds), and a tiny CPU EngineLoop, a 2-replica Fleet and a DisaggPair
  (2 seeds each), under the port's own lock-order file;
* instrumentation leaves an engine's program counts, budgets and sync
  ledger delta unchanged on the same workload;
* tracecheck: an engine's capture budgets are its max_programs(), one
  per graph it would capture; frozen, a capture raises
  CompileBudgetExceeded and is not counted; the kernel libraries' one
  load a process, counted only once the build succeeded; host_sync
  counts by name and reads a 0-d tensor as a float and any other as a
  host tensor;
* the schedcheck CLI's engine target runs on the device it is given.
"""

import threading

import pytest
import torch

from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.gpt import GPT
from nanosandbox_tpu_torch.ops import _build
from nanosandbox_tpu_torch.serve.disagg import DisaggPair
from nanosandbox_tpu_torch.serve.drafters import NGramDrafter
from nanosandbox_tpu_torch.serve.engine import Engine
from nanosandbox_tpu_torch.serve.fleet import Fleet
from nanosandbox_tpu_torch.serve.http import EngineLoop
from nanosandbox_tpu_torch.utils import schedcheck, tracecheck
from nanosandbox_tpu_torch.utils.schedcheck import (SchedCheck,
                                                    _InstrumentedLock,
                                                    _run_threads)
from nanosandbox_tpu_torch.utils.tracecheck import CompileBudgetExceeded

KW = dict(num_slots=2, max_len=64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return GPT(GPTConfig(n_layer=2, n_head=2, n_embd=32, block_size=64,
                         vocab_size=50, compute_dtype="float32"),
               generator=torch.Generator().manual_seed(0)).eval()


def _order():
    return schedcheck.load_order()


def test_planted_inversion_and_crash_are_caught():
    check = SchedCheck(seed=0, order={"A._l": 0, "B._l": 1})
    a = _InstrumentedLock(threading.Lock(), "A._l", check)
    b = _InstrumentedLock(threading.Lock(), "B._l", check)
    with b:
        with a:
            pass
    assert [v.kind for v in check.violations] == ["order"]
    with pytest.raises(AssertionError, match="inverts the committed"):
        check.assert_clean()
    check = SchedCheck(seed=0)

    def boom():
        raise ValueError("planted")

    _run_threads(check, [("boom", boom), ("calm", lambda: None)])
    assert [(v.kind, v.thread) for v in check.violations] == [
        ("crash", "boom")]


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_router_clean(seed):
    check = schedcheck.fuzz_router(seed, order=_order())
    check.assert_clean()
    assert check.acquires > 0


def test_fuzz_engine_loop_fleet_and_pair_clean(model):
    loop = EngineLoop(Engine(model, paged=True, **KW))
    loop.start()
    try:
        for seed in range(2):
            schedcheck.fuzz_engine_loop(loop, seed, reader_iters=20,
                                        order=_order()).assert_clean()
    finally:
        loop.stop()
        loop.join(30)
    fleet = Fleet(model, n_replicas=2, **KW)
    pair = DisaggPair(model, paged=True, num_slots=4, max_len=64,
                      device="cpu")
    for seed in range(2):
        schedcheck.fuzz_fleet(fleet, seed, reader_iters=20,
                              order=_order()).assert_clean()
        schedcheck.fuzz_disagg(pair, seed, reader_iters=20,
                               order=_order()).assert_clean()


def test_instrumentation_changes_no_count(model):
    def run(instrument):
        mark = tracecheck.sync_counts()
        eng = Engine(model, paged=True, **KW)
        if instrument:
            schedcheck.instrument_engine(eng,
                                         SchedCheck(seed=0, order=_order()))
        rids = [eng.submit([1 + i, 2], 5) for i in range(4)]
        done = {r.rid: r.tokens for r in eng.drain()}
        return ([done[r] for r in rids], eng.program_counts(),
                eng.max_programs(), eng.tracecheck.budgets(),
                tracecheck.sync_delta(mark))

    plain = run(False)
    assert plain[4]["decode-readback"] > 0
    assert run(True) == plain


def test_capture_budgets_are_max_programs_and_freeze(model):
    for eng, kinds in ((Engine(model, paged=True, **KW), ("decode",)),
                       (Engine(model, paged=True, spec=NGramDrafter(k=2),
                               **KW), ("decode", "verify"))):
        # On the CPU the bodies run eagerly: a budget of 0 for every kind
        # of graph the card would capture, and nothing captured.
        assert eng.max_programs() == dict.fromkeys(kinds, 0)
        assert eng.tracecheck.budgets() == eng.max_programs()
        assert eng.tracecheck.counts() == dict.fromkeys(kinds, 0)
        # What the card would capture: a graph per (rung, filtered), and
        # the greedy and the sampled verify.
        want = {"decode": 2 * len(eng.scan_rungs), "verify": 2}
        assert {k: len(v) for k, v in eng._program_bodies().items()} == {
            k: want[k] for k in kinds}
        assert eng.program_counts()["graph_captures"] == 0
    reg = eng.tracecheck
    reg.register("decode", 1)
    with reg.frozen():
        with pytest.raises(CompileBudgetExceeded, match="frozen"):
            reg.bump("decode")
    assert reg.counts()["decode"] == 0          # the rejected one
    assert reg.bump("decode") == 1
    with pytest.raises(CompileBudgetExceeded, match="budget 1"):
        reg.bump("decode")
    assert eng.program_counts()["graph_captures"] == 1
    assert tracecheck.global_registry().budgets()[_build.BUDGET_NAME] == 1


def test_failed_library_build_leaves_no_count(monkeypatch, tmp_path):
    """The kernel libraries' load is counted once it has succeeded: a
    failed build leaves no count, and a retry raises the build's own
    error again, not the budget's."""
    def no_nvcc():
        raise RuntimeError("no nvcc in this test")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda src: str(tmp_path / "absent.so"))
    monkeypatch.setattr(_build, "_lib", None)
    reg = tracecheck.global_registry()
    before = reg.counts().get(_build.BUDGET_NAME, 0)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no nvcc in this test"):
            _build.library()
    assert reg.counts().get(_build.BUDGET_NAME, 0) == before
    with reg.frozen():
        with pytest.raises(CompileBudgetExceeded, match="frozen"):
            _build.library()                 # refused before the build


def test_schedcheck_cli_engine_target_device(monkeypatch, capsys):
    """--target=engine runs on --device: an explicit cpu fuzzes the tiny
    engine there; the default (auto) wants the card and raises without
    one, as every entry point of the port does."""
    assert schedcheck.main(["--target=engine", "--device=cpu",
                            "--seeds=1"]) == 0
    assert "0 seed(s) with violations" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        schedcheck.main(["--target=engine", "--seeds=1"])


def test_host_sync_ledger():
    mark = tracecheck.sync_counts()
    assert tracecheck.host_sync("t-scalar", torch.tensor(2.5)) == 2.5
    host = tracecheck.host_sync("t-rows", torch.arange(3))
    assert host.device.type == "cpu" and host.tolist() == [0, 1, 2]
    assert tracecheck.host_sync("t-rows") is None
    assert tracecheck.sync_delta(mark) == {"t-scalar": 1, "t-rows": 2}
    assert tracecheck.sync_count("t-rows") >= 2
