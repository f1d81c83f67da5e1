"""The one traffic generator: it reads a mix's parameters from
``perfbench/traffic/<mix>.json`` and makes its requests from ``--seed``.

Two kinds of mix:

* ``"prefill"``: a closed loop of one client sending one prompt a call. The
  prompt lengths cycle through ``lengths``, each cycle in a new order
  shuffled by the seed, so every seed sends the same set of sizes. Token
  ids are uniform over the vocabulary, drawn on the device from the seed
  into one pool of ``pool_tokens`` ids that the prompts take in turn (and
  wrap around).
* ``"decode"``: ``streams`` requests decoded greedily in lockstep against a
  cache of ``cache_len`` positions. Each stream starts from one token drawn
  from the seed at position 0; a stream that fills the cache ends, and a new
  one starts in its place (all of them at once: they move in lockstep).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["PrefillTraffic", "DecodeTraffic", "make_traffic"]


class PrefillTraffic:
    def __init__(self, spec: Dict[str, Any], seed: int, vocab: int, device: torch.device):
        self.lengths: List[int] = [int(n) for n in spec["lengths"]]
        self._rng = np.random.default_rng(int(seed))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        size = max(int(spec.get("pool_tokens", 1 << 21)), max(self.lengths))
        self.pool = torch.randint(0, vocab, (size,), generator=gen, device=device)
        self._order: List[int] = []
        self._offset = 0

    @property
    def at_cycle_start(self) -> bool:
        return not self._order

    def next(self) -> Tuple[int, int]:
        """The next prompt: (length, offset of its ids in the pool)."""
        if not self._order:
            self._order = [int(n) for n in self._rng.permutation(self.lengths)]
        length = self._order.pop(0)
        if self._offset + length > self.pool.numel():
            self._offset = 0
        off = self._offset
        self._offset += length
        return length, off

    def tokens(self, length: int, offset: int) -> torch.Tensor:
        """(1, length) ids."""
        return self.pool[offset : offset + length].view(1, length)


class DecodeTraffic:
    def __init__(self, spec: Dict[str, Any], seed: int, vocab: int, device: torch.device):
        self.streams = int(spec["streams"])
        self.cache_len = int(spec["cache_len"])
        self.vocab = vocab
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(int(seed))
        self.device = device

    def first_tokens(self) -> torch.Tensor:
        """(streams, 1) ids that new requests start from."""
        return torch.randint(0, self.vocab, (self.streams, 1), generator=self._gen,
                             device=self.device)


def make_traffic(spec: Dict[str, Any], seed: int, vocab: int, device: torch.device):
    kinds = {"prefill": PrefillTraffic, "decode": DecodeTraffic}
    if spec.get("kind") not in kinds:
        raise ValueError(f"unknown traffic kind {spec.get('kind')!r}; known: {sorted(kinds)}")
    return kinds[spec["kind"]](spec, seed, vocab, device)
