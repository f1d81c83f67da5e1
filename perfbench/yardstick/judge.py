"""How far the served tokens lie below the reference's best.

For every compared position: the reference's logits (fp32, from its final
hidden state and the unembedding) give ``gap = max(logits) - logits[served]``,
0 where the program served the reference's own choice. The numbers that
decide ``correct``:

* ``widest_gap``: the largest gap of all compared positions;
* ``mean_gap``: the mean gap of all compared positions;
* ``mismatch_share``: the share of positions whose served token is not the
  reference's choice;
* ``worst_request_gap``: the largest mean gap of one request (a prompt, or
  the tokens one decode stream was served), so that a fault in one slot of
  a batch shows beside the many sound ones.

The precision control's readings are the same numbers for the tokens that
the lower-precision reference puts first at each position.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from yardstick import plain

__all__ = ["gaps", "numbers"]


def gaps(hidden: torch.Tensor, unembed: torch.Tensor, served: Optional[torch.Tensor] = None,
         lowp_hidden: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """hidden (B, S, d) fp32; served (B, S) ids. Returns per position the gap
    of ``served`` and, with ``lowp_hidden``, of the control's first choice."""
    d = hidden.shape[-1]
    u = unembed.float()
    h = hidden.reshape(-1, d)
    hl = None if lowp_hidden is None else lowp_hidden.reshape(-1, d)
    tok = None if served is None else served.reshape(-1)
    rows = max(1, plain.ELEMS // u.shape[0])
    out: Dict[str, list] = {"served": [], "control": []}
    for r0 in range(0, h.shape[0], rows):
        ref = h[r0 : r0 + rows] @ u.t()
        best = ref.max(dim=-1).values
        if tok is not None:
            out["served"].append(best - ref.gather(1, tok[r0 : r0 + rows, None])[:, 0])
        if hl is not None:
            first = plain.mm(hl[r0 : r0 + rows], u.t(), lowp=True).argmax(dim=-1)
            out["control"].append(best - ref.gather(1, first[:, None])[:, 0])
    return {k: torch.cat(v) for k, v in out.items() if v}


def numbers(requests: List[torch.Tensor]) -> Dict[str, float]:
    """The numbers over the gaps of each compared request (one 1-D tensor a
    request)."""
    g = torch.cat(requests).double()
    worst = max(float(r.double().mean()) for r in requests)
    return {"widest_gap": float(g.max()), "mean_gap": float(g.mean()),
            "mismatch_share": float((g > 0).double().mean()), "worst_request_gap": worst}
