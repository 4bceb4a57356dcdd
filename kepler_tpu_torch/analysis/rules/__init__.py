"""keplint domain rules: the attribution-stack invariants, as AST checks.

Each rule encodes one invariant the attribution formula depends on (see
``docs/developer/static-analysis.md`` for the catalog — generated from
this registry by ``hack/gen_lint_docs.py``). Scoping is declarative
where it can be: files opt into clock discipline with ``# keplint:
monotonic-only``, hot functions are marked ``# keplint: hot-loop``, and
lock contracts are annotated at the attribute (``# keplint:
guarded-by=_lock``) and function (``# keplint: requires-lock=_lock``)
level — so the rules need no hardcoded knowledge of which module does
what, and fixture tests exercise them hermetically.

The package splits one module per rule family; importing it populates
the registry. KTL101-110 and KTL114 run per file; KTL111-113 are
:class:`~kepler_tpu_torch.analysis.engine.ProjectRule` families over the
whole-program :class:`~kepler_tpu_torch.analysis.project.ProjectContext`
(call graph, thread roles, lock summaries, taint propagation);
KTL120-123 are :class:`~kepler_tpu_torch.analysis.engine.DeviceRule`
families over recorded runs of the device programs
(:mod:`kepler_tpu_torch.analysis.device`, opt-in via ``--device-tier``);
KTL130-132 are :class:`~kepler_tpu_torch.analysis.engine.ProtocolRule`
families over exhaustively explored protocol state spaces
(:mod:`kepler_tpu_torch.analysis.protocol`, opt-in via ``--protocol-tier``),
with KTL133 as their per-file marker-discipline fence.
"""

from __future__ import annotations

# importing the modules registers the rules (ids keep the catalog order)
from kepler_tpu_torch.analysis.rules import clocks  # noqa: F401  KTL101
from kepler_tpu_torch.analysis.rules import deltas  # noqa: F401  KTL102
from kepler_tpu_torch.analysis.rules import snapshots  # noqa: F401  KTL103
from kepler_tpu_torch.analysis.rules import config  # noqa: F401  KTL104
from kepler_tpu_torch.analysis.rules import metrics  # noqa: F401  KTL105
from kepler_tpu_torch.analysis.rules import hotloop  # noqa: F401  KTL106
from kepler_tpu_torch.analysis.rules import purity  # noqa: F401  KTL107
from kepler_tpu_torch.analysis.rules import locks  # noqa: F401  KTL108+111
from kepler_tpu_torch.analysis.rules import spans  # noqa: F401  KTL109
from kepler_tpu_torch.analysis.rules import donate  # noqa: F401  KTL110
from kepler_tpu_torch.analysis.rules import taint  # noqa: F401  KTL112
from kepler_tpu_torch.analysis.rules import roles  # noqa: F401  KTL113
from kepler_tpu_torch.analysis.rules import layout  # noqa: F401  KTL114
from kepler_tpu_torch.analysis import device as _device  # noqa: F401  KTL120-123
from kepler_tpu_torch.analysis import protocol as _protocol  # noqa: F401  KTL130-132
from kepler_tpu_torch.analysis.rules import protocol  # noqa: F401  KTL133
