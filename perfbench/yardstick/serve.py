"""The measured window: the program serving one traffic mix, and the check of
what it served.

* Prefill (closed loop): a request is one ``forward`` over its prompt and
  the argmax of its logits at every position (the prompt's greedy next
  tokens; the last one is its first output token), ending when that first
  token reaches the host. Its time to first token runs from a CUDA event
  recorded before the call to one recorded after the argmax (the device's
  clock; the host's start-up of the call is inside it, since the stream is
  idle when the request starts).
* Decode (lockstep): a step is one ``decode_step`` for every stream, the
  argmax of its logits, and the new tokens reaching the host, as a server
  streams them. The time between tokens is the time between the CUDA events
  that close consecutive steps.

The window lasts ``seconds`` on the host's clock and ends at the first
request or step boundary after that; every request or step in it counts.
With a tracer, one more slice runs after that under the profiler (a whole
cycle of the prefill mix's lengths, or ``trace_steps`` decode steps), and the
window ends with it.

After the window the answers are checked against the configuration's plain
reference (:mod:`yardstick.judge`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from yardstick import judge, plain
from yardstick.model import Shape

__all__ = ["PrefillDriver", "DecodeDriver", "make_driver"]


class Clock:
    """Stamps on the device's clock (CUDA events) on a card, the host's on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def stamp(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class _Driver:
    """What the two kinds of traffic share: set-up, the traced slice's
    launch counts, and the check of :meth:`compared`'s answers."""

    def __init__(self, program, weights, traffic, shape: Shape, spec: Dict[str, Any], seed: int,
                 device: torch.device):
        self.program, self.weights, self.traffic = program, weights, traffic
        self.shape, self.spec, self.seed, self.device = shape, spec, int(seed), device
        self.clock = Clock(device)
        self.window_s = 0.0
        self.launches: Dict[str, int] = {}

    def _traced(self, tracer, before: Dict[str, int]) -> None:
        tracer.mark_end(time.perf_counter())
        after = self.program.launches()
        self.launches = {k: after[k] - before[k] for k in after}

    def check(self, reference, control: bool = False) -> Dict[str, Any]:
        """The served tokens' gaps under the reference; with ``control``, also
        the gaps of the lower-precision reference's first choices. Keeps the
        copies each expert kept in each MoE layer of the compared answers
        (``self.routing``: one list of (groups, experts) counts an answer set)."""
        gaps: Dict[str, List[torch.Tensor]] = {"served": [], "control": []}
        self.routing = []
        sets = 0
        for toks, served, groups in self.compared():
            with plain.record_routing() as routing:
                h = reference.final_hidden(self.shape, self.weights, toks, groups=groups)
            self.routing.append(routing)
            low = None
            if control:
                low = reference.final_hidden(self.shape, self.weights, toks, groups=groups,
                                             lowp=True)
            for k, v in judge.gaps(h, _unembed(self.weights), served=served,
                                   lowp_hidden=low).items():
                gaps[k] += list(v.view(toks.shape[0], -1))  # one row a request
            sets += toks.shape[0]
        out = {"numbers": judge.numbers(gaps["served"]),
               "positions": sum(int(g.numel()) for g in gaps["served"]), "requests": sets}
        if control:
            out["control"] = judge.numbers(gaps["control"])
        return out


class PrefillDriver(_Driver):
    kind = "prefill"

    def warm_up(self) -> None:
        """One request of every length the mix sends."""
        for n in sorted(set(self.traffic.lengths)):
            self._request(n, 0)
        _sync(self.device)
        self.requests: List[Dict[str, Any]] = []

    def _request(self, length: int, offset: int) -> Dict[str, Any]:
        toks = self.traffic.tokens(length, offset)
        t0 = self.clock.stamp()
        logits = self.program.forward(self.weights, toks, self.device)
        pred = logits.argmax(dim=-1)
        t1 = self.clock.stamp()
        pred[:, -1].tolist()  # the first token reaches the host
        del logits
        return {"length": length, "offset": offset, "pred": pred, "t": (t0, t1)}

    def run(self, seconds: float, tracer=None) -> None:
        reqs = self.requests
        cycle = len(self.traffic.lengths)
        state, first, before = None, 0, {}
        t0 = time.perf_counter()
        while True:
            if state is None and tracer is not None and time.perf_counter() - t0 >= seconds \
                    and self.traffic.at_cycle_start:
                state, first, before = "on", len(reqs), self.program.launches()
                tracer.start(time.perf_counter())
            reqs.append(self._request(*self.traffic.next()))
            if state == "on" and len(reqs) - first == cycle:
                self._traced(tracer, before)
                state = "done"
            if time.perf_counter() - t0 >= seconds and (tracer is None or state == "done"):
                break
        self.window_s = time.perf_counter() - t0
        self.traced_requests = reqs[first:] if state == "done" else []
        self.traced = [r["length"] for r in self.traced_requests]

    def end_to_end(self) -> Dict[str, float]:
        tokens = sum(r["length"] for r in self.requests)
        ttft = [self.clock.ms(*r["t"]) for r in self.requests]
        return {"prefill_tok_s": tokens / self.window_s,
                "ttft_p95_ms": float(np.percentile(ttft, 95))}

    def attempted(self) -> int:
        return len(self.requests)

    def free(self) -> None:
        """Nothing of the program's state outlives a request."""

    def compared(self):
        """One finished request of each length, compared at every position:
        (inputs, served tokens, the MoE's groups). After a traced slice, the
        slice's requests (a whole cycle of the lengths); otherwise a request of
        each length drawn from the seed."""
        picks = self.traced_requests
        if not picks:
            rng = np.random.default_rng([self.seed, 7])
            picks = []
            for n in sorted(set(r["length"] for r in self.requests)):
                pool = [r for r in self.requests if r["length"] == n]
                picks.append(pool[int(rng.integers(len(pool)))])
        for r in picks:
            yield self.traffic.tokens(r["length"], r["offset"]), r["pred"], "batch"

    def traced_routing(self) -> Optional[List[List[Tuple[int, int]]]]:
        """For each traced prompt and MoE layer, as the reference routed it:
        (copies the experts kept, experts that kept any); None without a
        traced slice."""
        if not self.traced_requests:
            return None
        return [[_kept(c[0]) for c in routing] for routing in self.routing]


class DecodeDriver(_Driver):
    kind = "decode"

    def warm_up(self) -> None:
        """One step (every step has the same shapes), then a clean cache."""
        t = self.traffic
        self.cache = self.program.init_cache(t.streams, t.cache_len, self.device)
        self.hist = torch.empty((t.streams, t.cache_len + 1), dtype=torch.long, device=self.device)
        self.hist[:, :1] = t.first_tokens()
        self._step(0, None)
        self._reset()
        _sync(self.device)

    def _reset(self) -> None:
        for leaf in _leaves(self.cache):
            leaf.zero_()

    def _step(self, index: int, stamps: Optional[list]) -> None:
        logits = self.program.decode_step(self.weights, self.cache, self.hist[:, index : index + 1],
                                          index, self.device)
        nxt = logits[:, -1].argmax(dim=-1)
        self.hist[:, index + 1] = nxt
        if stamps is not None:
            stamps.append(self.clock.stamp())
        nxt.tolist()  # the step's tokens reach the host

    def run(self, seconds: float, tracer=None) -> None:
        t = self.traffic
        trace_steps = int(self.spec.get("trace_steps", 16))
        self.stamps = [self.clock.stamp()]
        self.finished: Optional[torch.Tensor] = None
        self.keys: List[int] = []  # cached positions each step attends
        index, state, first, before = 0, None, 0, {}
        t0 = time.perf_counter()
        while True:
            if state is None and tracer is not None and time.perf_counter() - t0 >= seconds:
                state, first, before = "on", len(self.keys), self.program.launches()
                tracer.start(time.perf_counter())
            self._step(index, self.stamps)
            index += 1
            self.keys.append(index)
            if index == t.cache_len:  # every stream's cache is full: new requests in their place
                self.finished = self.hist.clone()
                self._reset()
                self.hist[:, :1] = t.first_tokens()
                index = 0
            if state == "on" and len(self.keys) - first == trace_steps:
                self._traced(tracer, before)
                state = "done"
            if time.perf_counter() - t0 >= seconds and (tracer is None or state == "done"):
                break
        self.window_s = time.perf_counter() - t0
        self.index = index
        self.traced = self.keys[first:] if state == "done" else []

    def end_to_end(self) -> Dict[str, float]:
        itl = [self.clock.ms(a, b) for a, b in zip(self.stamps, self.stamps[1:])]
        return {"decode_tok_s": len(self.keys) * self.traffic.streams / self.window_s,
                "itl_p95_ms": float(np.percentile(itl, 95))}

    def attempted(self) -> int:
        """Tokens asked for: every stream at every step."""
        return len(self.keys) * self.traffic.streams

    def free(self) -> None:
        del self.cache

    def compared(self):
        """Every token the window served: to the requests in progress, and to
        the ones that finished last (if any filled the cache)."""
        if self.index:
            yield self.hist[:, : self.index], self.hist[:, 1 : self.index + 1], "position"
        if self.finished is not None:
            yield self.finished[:, :-1], self.finished[:, 1:], "position"

    def traced_routing(self) -> Optional[List[List[Tuple[int, int]]]]:
        """For each traced step and MoE layer, as the reference routed it:
        (copies the experts kept, experts that kept any). None without a
        traced slice, or where new requests started inside it."""
        keys = self.traced
        if not keys or any(b != a + 1 for a, b in zip(keys, keys[1:])):
            return None
        routing = self.routing[0]  # the requests that the slice served, compared first
        return [[_kept(layer[k - 1]) for layer in routing] for k in keys]


def _kept(counts: torch.Tensor) -> Tuple[int, int]:
    """(copies kept, experts that kept any) from one group's per-expert counts."""
    return int(counts.sum()), int((counts > 0).sum())


def _unembed(weights) -> torch.Tensor:
    return weights["unembed"] if "unembed" in weights else weights["embed"]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def make_driver(kind: str, *args, **kwargs):
    drivers = {"prefill": PrefillDriver, "decode": DecodeDriver}
    return drivers[kind](*args, **kwargs)
