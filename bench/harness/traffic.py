"""The one traffic generator: a mix file's parameters in, requests out.

A mix (``mixes/<name>.json``) gives:

* ``clients``: closed-loop clients, each sending its next request when the
  last one has its final token (no think time);
* ``shared``: ``{"count", "length", "zipf", "block"}`` documents that
  requests start with, or null: none, every prompt its own.  Document
  ``k`` (``k`` = 0 the most asked) is the start of a share ``1 / (k + 1)
  ** zipf`` of the requests (``zipf`` 0: all alike): in every run of
  ``block`` requests it is asked that share of ``block`` times, rounded
  by largest remainders;
* ``prompt``: the length of the part of each prompt after its document
  (the whole prompt without documents), ``answer``: the tokens to generate;
  each a distribution ``{"dist": "uniform" | "log_uniform", "min", "max"}``
  or ``{"dist": "log_normal", "median", "sigma", "min", "max"}`` (a heavy
  tail, clipped to ``[min, max]``);
* ``strata``: the lengths are the distribution's quantiles at the centres
  of ``strata`` equal strata, and every run of ``strata`` requests takes
  each of them once.  The documents' lengths are the quantiles of ``count``
  strata.

The order in which lengths and documents come is shuffled once, the same
for every seed: a window of a few heavy-tailed requests would otherwise see
a different share of the work under each seed.  So every seed offers the
same work; the seed draws the tokens, uniform over the vocabulary, and the
same seed gives the same documents and requests.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The lengths at the centres of ``n`` equal strata of ``spec``."""
    lo, hi = spec["min"], spec["max"]
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif spec["dist"] == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif spec["dist"] == "log_normal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


TAGS = {"doc": 2, "prompt": 3, "answer": 4, "pick": 5, "tail": 6}


def asks(n: int, zipf: float, block: int) -> np.ndarray:
    """How often each of ``n`` documents is asked in ``block`` requests:
    shares ``1 / (k + 1) ** zipf``, rounded by largest remainders."""
    w = 1.0 / np.arange(1, n + 1) ** zipf
    exact = block * w / w.sum()
    out = np.floor(exact).astype(np.int64)
    out[np.argsort(out - exact, kind="stable")[:block - out.sum()]] += 1
    return out


@dataclasses.dataclass
class Item:
    """One request: its document (-1: none), the tokens after it and how
    many tokens to generate."""
    index: int
    doc: int
    tail: np.ndarray
    max_new: int


class Traffic:
    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab = mix, vocab
        self.seed = seed % 2 ** 64
        self.strata = int(mix["strata"])
        self._prompt = quantiles(mix["prompt"], self.strata)
        self._answer = quantiles(mix["answer"], self.strata)
        shared = mix.get("shared")
        self.docs: list[np.ndarray] = []
        if shared:
            n = int(shared["count"])
            lens = np.random.default_rng(0).permutation(quantiles(shared["length"], n))
            self.docs = [self._rng("doc", i).integers(0, vocab, int(k), dtype=np.int32)
                         for i, k in enumerate(lens)]
            self._doc_block = int(shared.get("block", n))
            self._asks = np.repeat(np.arange(n), asks(n, float(shared.get("zipf", 0.0)),
                                                      self._doc_block))
        self._blocks: dict[tuple, np.ndarray] = {}

    def _rng(self, *tag) -> np.random.Generator:
        return np.random.default_rng([self.seed, TAGS[tag[0]], *tag[1:]])

    def _order(self, what: str, block: int, n: int) -> np.ndarray:
        """The order of block ``block``'s ``n`` strata: not the seed's."""
        key = (what, block)
        if key not in self._blocks:
            self._blocks[key] = np.random.default_rng([TAGS[what], block]).permutation(n)
        return self._blocks[key]

    def item(self, i: int) -> Item:
        """The ``i``-th request the clients send, in the order they send."""
        b, j = divmod(i, self.strata)
        n_prompt = int(self._prompt[self._order("prompt", b, self.strata)[j]])
        max_new = int(self._answer[self._order("answer", b, self.strata)[j]])
        doc = -1
        if self.docs:
            db, dj = divmod(i, self._doc_block)
            doc = int(self._asks[self._order("pick", db, self._doc_block)[dj]])
        tail = self._rng("tail", i).integers(0, self.vocab, n_prompt, dtype=np.int32)
        return Item(i, doc, tail, max_new)

    def prompt(self, item: Item) -> np.ndarray:
        if item.doc < 0:
            return item.tail
        return np.concatenate([self.docs[item.doc], item.tail])

    def shared_len(self, item: Item) -> int:
        """Tokens of ``item``'s prompt that its document shares."""
        return 0 if item.doc < 0 else len(self.docs[item.doc])

    @property
    def max_prompt(self) -> int:
        longest = max((len(d) for d in self.docs), default=0)
        return longest + int(self._prompt.max())

    @property
    def max_answer(self) -> int:
        return int(self._answer.max())
