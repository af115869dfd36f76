"""torchlint and lockcheck: static analysis of the port's host code.

The port's counterpart of the JAX package's analysis/ (jaxlint and
lockcheck), pure ``ast`` + stdlib, so it runs on a bare Python:
``python -m nanosandbox_tpu_torch.analysis [lockcheck] <paths>``.

Rules:

  host-sync   .item()/.tolist()/.cpu()/.numpy()/synchronize() and
              float()/int()/bool()/print() of a tensor in the hot set:
              the functions that replay a CUDA graph (``.replay()``) or
              drive the training step (``train_step``), closed over the
              private helpers they call (analysis/hotscope.py).

The concurrency surface has its own pass, ``lockcheck`` (the JAX
package's, with the port's lock-order file ``analysis/lock_order.json``
and torch's device readbacks among its blocking calls); its runtime
witness is ``nanosandbox_tpu_torch.utils.schedcheck``.

Suppress a deliberate violation with a REASONED comment (the reason is
mandatory; a bare disable is itself a finding)::

    toks = out.tolist()  # torchlint: disable=host-sync -- counted above

The runtime half of the same contract is
``nanosandbox_tpu_torch.utils.tracecheck`` (capture budgets and the
blessed ``host_sync`` readback, which this linter recognises).

Not ported: jaxlint's tracer-leak, nonstatic-shape, donation-misuse,
impure-trace and sharding rules, and shardcheck. They check traced XLA
programs, and the port compiles none.
"""

from nanosandbox_tpu_torch.analysis.core import (Finding, Rule, all_rules,
                                                 analyze_paths,
                                                 analyze_source, render_json,
                                                 render_text)

__all__ = ["Finding", "Rule", "all_rules", "analyze_paths",
           "analyze_source", "render_json", "render_text"]
