"""The traffic generator: deterministic in the seed, lengths in range, and
every seed the same work in another order."""

import json
from collections import Counter

import numpy as np
import pytest

from bench.harness.traffic import Traffic, asks, quantiles
from conftest import ROOT

MIXES = sorted((ROOT / "bench" / "mixes").glob("*.json"))


def _mix(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    seed = 2 ** 31 + 987_654_321
    a, b = Traffic(_mix(path), 151_936, seed), Traffic(_mix(path), 151_936, seed)
    for i in (0, 1, 63, 64, 200):
        x, y = a.item(i), b.item(i)
        assert (x.doc, x.max_new) == (y.doc, y.max_new)
        assert np.array_equal(a.prompt(x), b.prompt(y))
    other = Traffic(_mix(path), 151_936, seed + 1)
    assert not np.array_equal(a.prompt(a.item(0)), other.prompt(other.item(0)))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_lengths_in_range_and_ids_in_vocab(path):
    mix = _mix(path)
    t = Traffic(mix, 1000, 5)
    for i in range(300):
        it = t.item(i)
        assert mix["prompt"]["min"] <= len(it.tail) <= mix["prompt"]["max"]
        assert mix["answer"]["min"] <= it.max_new <= mix["answer"]["max"]
        p = t.prompt(it)
        assert p.min() >= 0 and p.max() < 1000
        assert len(p) <= t.max_prompt
    for d in t.docs:
        assert mix["shared"]["length"]["min"] <= len(d) <= mix["shared"]["length"]["max"]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_seed_offers_the_same_work(path):
    """The same lengths and documents in the same order; other tokens."""
    mix = _mix(path)
    runs = []
    for seed in (1, 2 ** 32 + 7):
        t = Traffic(mix, 1000, seed)
        items = [t.item(i) for i in range(2 * mix["strata"])]
        runs.append(([(len(x.tail), x.max_new, x.doc) for x in items],
                     [len(d) for d in t.docs], items[0].tail))
    assert runs[0][:2] == runs[1][:2]
    assert not np.array_equal(runs[0][2], runs[1][2])


def test_quantiles():
    assert list(quantiles({"dist": "uniform", "min": 0, "max": 10}, 5)) == [1, 3, 5, 7, 9]
    q = quantiles({"dist": "log_uniform", "min": 2048, "max": 6144}, 32)
    assert q[0] >= 2048 and q[-1] <= 6144 and np.all(np.diff(q) > 0)


def test_log_normal_has_its_median_and_a_tail():
    spec = {"dist": "log_normal", "median": 128, "sigma": 0.8, "min": 8, "max": 1024}
    q = quantiles(spec, 64)
    assert np.median(q) == pytest.approx(128, rel=0.02)
    assert q.mean() > 1.3 * np.median(q) and q.max() > 6 * np.median(q)
    assert q.min() >= 8 and q.max() <= 1024


def test_documents_are_asked_by_zipf():
    a = asks(32, 1.0, 128)
    assert a.sum() == 128 and a[0] == 32 and a[1] == 16 and np.all(np.diff(a) <= 0)
    assert list(asks(4, 0.0, 8)) == [2, 2, 2, 2]
    mix = {"shared": {"count": 4, "zipf": 1.0, "block": 25,
                      "length": {"dist": "uniform", "min": 10, "max": 20}},
           "prompt": {"dist": "uniform", "min": 1, "max": 2},
           "answer": {"dist": "uniform", "min": 1, "max": 2}, "strata": 5}
    t = Traffic(mix, 100, 3)
    assert Counter(t.item(i).doc for i in range(25)) == dict(enumerate(asks(4, 1.0, 25)))
