"""opslint for the port — static analysis of ``src/repro_torch``.

An AST-based rule engine that mechanically checks the invariants the
port otherwise holds by convention, review and the card's dynamic
checks.  It is the reference's ``repro.analysis_static`` with the same
modules, flags, exit codes, output formats and suppression syntax; the
trace and donation rules are translated from JAX's semantics to torch's:

* **sync-freedom** (``TRC001``/``TRC002``) — no host syncs (``.item()``,
  ``.cpu()``, ``int(tensor)``, ``nonzero``, boolean-mask loads, ...)
  and no Python branch on a tensor's value inside functions reachable
  from a ``# opslint: steady [static=a,b]`` marker (the engine's
  executable bodies and ``Model.decode_step``), propagated through a
  conservative intra-package call graph with per-call-site taint.
  Tensor fields (``A.rpt``, ``lease.i32``) are device values; tensor
  metadata (``.shape``, ``.numel()``) is static; branches taken only for
  CPU tensors (the kernel wrappers' plain versions) are not followed.
* **donation discipline** (``DON001``) — a buffer passed to a function
  marked ``# opslint: donates=<param>[ if <kwarg>]`` is consumed
  (``exclusive_sum_in_place``, ``bin_rows_into``, ``decode_step(...,
  donate=True)``); any later read of that binding sees the rewritten
  buffer.
* **lock order / races** (``LCK001``/``LCK002``) — the reference's rules
  unchanged: lock-ordering cycles, and writes to fields annotated
  ``# guarded-by: <lock>`` outside a ``with`` of that lock.
* **host-int width** (``INT001``) — int32 host values (numpy and, added
  here, ``.numpy()`` / ``.int()`` / ``.to(torch.int32)``) flowing
  unwidened into capacity/flop/byte accumulators.
* **kernel budget** (``KRN001``/``KRN002``) — the reference's rules
  unchanged, over the port's copies of the ladder constants.

It imports neither torch nor JAX, nor anything of the package it
analyses or of the reference.

CLI::

    python -m repro_torch.analysis_static src/repro_torch --fail-on-new \
        --baseline opslint_torch_baseline.json --format json

Findings carry ``file:line``, a rule id, and a fix hint.  A checked-in
baseline makes CI fail only on *new* findings; false positives are
suppressed inline with ``# opslint: disable=<rule> -- reason``.
"""

from .core import (  # noqa: F401
    Finding,
    Project,
    SourceFile,
    load_baseline,
    load_project,
    save_baseline,
)
from .engine import ALL_RULES, diff_against_baseline, run_paths, run_project  # noqa: F401

__all__ = [
    "Finding",
    "Project",
    "SourceFile",
    "ALL_RULES",
    "run_paths",
    "run_project",
    "load_project",
    "load_baseline",
    "save_baseline",
    "diff_against_baseline",
]
