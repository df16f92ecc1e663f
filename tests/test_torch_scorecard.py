"""The port's scorecard (``tensordiffeq_tpu_torch/zoo/scorecard.py``) held
to the JAX package's.

* a capped ``run_scorecard`` on two entries (the scalar ``burgers`` and the
  2-component ``schrodinger``, every arm, ``budget_cap=3``, on the CPU):
  the document, each entry block and each arm block have the keys and
  JSON types of the JAX package's ``SCORECARD.json``; the engine is
  ``fused-minimax-plain``; the FLOPs per step and their basis equal the
  baseline's exactly (the same analytic count); every eval fired;
* ``diff_scorecards`` of ``SCORECARD.json`` against that capped card is
  ``ok`` (capped: gates skipped, no engine downgrade);
* the diff matrix of ``tests/test_zoo.py``: a lost gate and an engine
  downgrade regress, a subset run skips, a capped run skips the gates
  (but not the engine), and the port's verdicts equal the JAX package's;
* ``ARMS``, ``SCHEMA_VERSION`` and ``cadences`` equal the JAX package's.
"""

import json
import os

import pytest
import torch

from tensordiffeq_tpu import zoo as jzoo
from tensordiffeq_tpu_torch import zoo

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("burgers", "schrodinger")


@pytest.fixture(scope="module")
def baseline():
    with open(os.path.join(REPO, "SCORECARD.json")) as fh:
        return zoo.scorecard_of(json.load(fh))


@pytest.fixture(scope="module")
def card():
    return zoo.run_scorecard(ENTRIES, "micro", budget_cap=3, device="cpu")


def _kind(v):
    """The JSON type of a value (ints and floats are one number kind)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return bool
    if isinstance(v, (int, float)):
        return float
    return type(v)


def _same_shape(got: dict, want: dict, where: str, optional=()):
    assert set(got) - set(optional) == set(want) - set(optional), where
    for k, v in want.items():
        if k in got and v is not None and got[k] is not None:
            assert _kind(got[k]) == _kind(v), (where, k, got[k], v)


def test_constants_equal_the_jax_packages():
    assert zoo.SCHEMA_VERSION == jzoo.SCHEMA_VERSION
    assert zoo.ARMS == jzoo.ARMS
    from tensordiffeq_tpu.zoo.scorecard import cadences as jcad
    from tensordiffeq_tpu_torch.zoo.scorecard import cadences
    for adam in (0, 1, 3, 50, 200, 799, 1000, 10_000):
        assert cadences(adam) == jcad(adam)


def test_capped_card_has_the_baselines_schema(card, baseline):
    _same_shape(card, baseline, "card", optional=("budget_cap",))
    assert card["budget_cap"] == 3 and card["size"] == "micro"
    assert list(card["entries"]) == list(ENTRIES)
    for eid, e in card["entries"].items():
        base = baseline["entries"][eid]
        _same_shape(e, base, eid, optional=("budget_capped",))
        assert "budget_capped" in e
        assert e["engine"] == "fused-minimax-plain"
        assert e["budget"] == {"adam": 3, "lbfgs": 3}
        assert set(e["arms"]) == set(zoo.ARMS)
        for arm, a in e["arms"].items():
            _same_shape(a, base["arms"][arm], f"{eid}/{arm}")
            assert a["rel_l2_final"] is not None  # the eval really fired
            assert a["flops_basis"] == base["arms"][arm]["flops_basis"] \
                == "analytic-minimax"
            assert a["flops_per_step"] == base["arms"][arm]["flops_per_step"]
            assert a["redraws"] == 0  # capped below the redraw cadence
    assert card["entries"]["schrodinger"]["n_components"] == 2


def test_baseline_diff_against_a_capped_card_is_ok(card, baseline):
    v = zoo.diff_scorecards(baseline, card)
    assert v["ok"] and v["budget_capped"], v
    assert v["regressions"] == []
    assert set(v["skipped"]) == set(baseline["entries"]) - set(ENTRIES)
    assert v["compared"] == len(ENTRIES)


def _card(gated=True, engine="fused-minimax-xla", cap=None):
    card = {"schema": 1, "size": "micro", "arms": list(zoo.ARMS),
            "entries": {"burgers": {
                "system": False, "engine": engine,
                "gate": {"kind": "rel_l2", "value": 0.2},
                "budget": {"adam": 100, "lbfgs": 50},
                "arms": {"fixed": {"gated": gated, "steps_to_gate": 50,
                                   "rel_l2_final": 0.1}}}}}
    if cap is not None:
        card["budget_cap"] = cap
    return card


def _subset():
    current = _card()
    current["entries"] = {}
    return current


DIFFS = {
    "gate-lost": (_card(gated=True), _card(gated=False)),
    "same": (_card(), _card()),
    "never-gated": (_card(gated=False), _card(gated=False)),
    "engine-downgrade": (_card(), _card(engine="generic")),
    "port-engine": (_card(), _card(engine="fused-minimax-cuda")),
    "subset": (_card(), _subset()),
    "capped": (_card(gated=True), _card(gated=False, cap=25)),
    "capped-downgrade": (_card(), _card(engine="generic", cap=25)),
}


@pytest.mark.parametrize("case", list(DIFFS))
def test_diff_matrix_matches_the_jax_packages(case):
    base, cur = DIFFS[case]
    v = zoo.diff_scorecards(base, cur)
    assert v == jzoo.diff_scorecards(base, cur)
    kinds = [r["kind"] for r in v["regressions"]]
    want = {"gate-lost": ["gate-lost"], "engine-downgrade":
            ["engine-downgrade"], "capped-downgrade": ["engine-downgrade"]}
    assert kinds == want.get(case, [])
    assert v["ok"] == (not kinds)
    if case == "subset":
        assert v["skipped"] == ["burgers"]
    if case.startswith("capped"):
        assert v["budget_capped"]


def test_scorecard_of_unwraps_a_payload(baseline):
    assert zoo.scorecard_of({"scorecard": baseline}) is baseline
    with pytest.raises(ValueError, match="not a zoo scorecard"):
        zoo.scorecard_of({"value": 1})
