"""Step builders of the port (counterpart of ``repro.distributed.step``).

The port runs on one card, so the reference's sharding rules, hints and
gradient compression are not ported yet (ROADMAP.md A.7).
"""

from repro_torch.distributed.step import (
    from_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    train_state,
)

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step", "train_state",
           "from_train_state"]
