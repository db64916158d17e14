"""``repro_torch.spec`` — speculative decoding (counterpart of
``repro.spec``).

Draft -> batched verify -> cache rollback: a draft model proposes K greedy
tokens per slot; the target scores all K (+1 bonus) in one wide
teacher-forced forward against its live decode cache
(``repro_torch.models.verify_step``); rejected suffixes are rolled back by
per-slot ``lengths`` truncation (``repro_torch.models.rollback_cache``,
``KVCache`` and ``QuantKVCache`` alike).  Greedy acceptance is lossless by
construction: the emitted stream is the target's own greedy continuation.

Pieces:
  * ``SpecConfig`` / ``resolve_draft_config`` — the policy (config.py):
    draft arch (or self-draft), draft-side int8 quantization, lookahead K;
  * ``DraftWorker`` — the draft model's mirrored slot-cache lifecycle
    (draft.py);
  * ``make_spec_verify`` — the verify/accept/rollback round (verify.py),
    wired into ``ServeEngine(spec=...)``.
"""

from .config import ROLLBACK_FAMILIES, SpecConfig, resolve_draft_config  # noqa: F401
from .draft import DraftWorker  # noqa: F401
from .verify import make_spec_verify  # noqa: F401
