"""mxlint's runtime half: what of ``mxnet_tpu/analysis/`` the port has.

Counterpart of ``mxnet_tpu/analysis/``. Ported:

- ``compile_verify`` — the runtime compile/transfer verifier behind
  ``MXNET_JIT_VERIFY``: per-callable compile budgets with arg-signature
  diffs on unexpected recompiles, plus the hot-region D2H byte ledger.

Not ported (each raises ``ImportError`` as a submodule of this
package): the lock tracer ``engine_verify`` (``MXNET_ENGINE_VERIFY``)
with ``lock_lint`` and the interleaving explorer ``schedule``, the
static passes ``graph_lint`` (``Symbol.lint``), ``ast_lint``,
``jit_lint`` (and so the cross-check of observed D2H sites against its
sanctioned ones), ``proto_lint``, ``telemetry_lint``, the simulators
``protosim`` and ``datasim``, ``findings`` and the ``mxlint`` CLI.
"""
from __future__ import annotations

from .compile_verify import (JitVerifyError, check_budgets, d2h_region,
                             declare_budget, expecting_violations,
                             note_d2h, summary)

__all__ = ["compile_verify", "JitVerifyError", "check_budgets",
           "d2h_region", "declare_budget", "expecting_violations",
           "note_d2h", "summary", "NOT_PORTED"]

#: the JAX package's analysis modules this package does not carry
NOT_PORTED = ("ast_lint", "cli", "datasim", "engine_verify", "findings",
              "graph_lint", "jit_lint", "lock_lint", "proto_lint",
              "protosim", "schedule", "telemetry_lint")
