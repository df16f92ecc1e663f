"""The convergence-gated scorecard: race the adaptive arms per entry.

Counterpart of the JAX package's ``zoo/scorecard.py``, with the same JSON
schema, so :func:`diff_scorecards` holds a card of the port against the JAX
package's ``SCORECARD.json``.  For each zoo entry this harness trains THREE
arms at the entry's
declared budget — ``fixed`` (one LHS draw, reference behavior),
``pool`` (device-resident pool->top-k redraw, :mod:`..ops.resampling`),
``ascent`` (the PACMANN gradient-ascent mover, arXiv:2411.19632) — under
telemetry, and records per arm: did it reach the entry's declared gate
AND HOLD it through the end of the budget (``gated`` — a transient dip
does not count: an untrained near-zero network trivially satisfies many
PDE interiors, so residual gates would otherwise pass at init), from
which cumulative optimizer step it held (``steps_to_gate``), the
final rel-L2 (or held-out RMS residual for residual-only entries), the
loss engine adopted, the steady-state per-redraw stall (p50), and the
priced FLOPs basis (``"analytic-minimax"`` on the minimax step).
:func:`run_scorecard` assembles the scorecard document
(``scripts/torch_zoo_scorecard.py`` runs it on the card);
:func:`diff_scorecards` compares it against a baseline.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from ..helpers import find_L2_error
from ..telemetry import MetricsRegistry, TrainingTelemetry
from ..telemetry.runlog import log_event
from .registry import ZooEntry, build_solver, engine_label, get

__all__ = ["ARMS", "SCHEMA_VERSION", "diff_scorecards", "race_entry",
           "run_scorecard", "scorecard_of"]

SCHEMA_VERSION = 1

#: arm name -> the extra ``fit()`` kwargs that select it (the JAX
#: package's measured config: 3 ascent steps, a 0.3 coverage floor)
ARMS: Dict[str, Dict] = {
    "fixed": {},
    "pool": {"resample_seed": 1},
    "ascent": {"resample_seed": 1, "resample_mode": "ascent",
               "resample_ascent_steps": 3, "resample_uniform": 0.3},
}


def cadences(adam: int) -> tuple:
    """(eval_every, resample_every) derived deterministically from the
    effective Adam budget, so a declared budget implies the whole race
    config (reproducible baseline) and a capped CI run still fires at
    least one eval inside its shrunken window."""
    adam = max(adam, 1)
    return (min(max(50, adam // 8), adam),
            min(max(100, adam // 4), adam))


def _held_out_points(domain, n_per_dim: int = 8) -> np.ndarray:
    """Uniform validation grid over the domain box (residual-only
    entries gate on RMS residual over THIS grid, not the training set)."""
    axes = [np.linspace(*domain.bounds(v), n_per_dim) for v in domain.vars]
    return np.stack(np.meshgrid(*axes, indexing="ij"),
                    -1).reshape(-1, len(axes)).astype(np.float32)


def _residual_rms(f) -> float:
    parts = f if isinstance(f, tuple) else (f,)
    sq = [np.asarray(p, np.float64) ** 2 for p in parts]
    return float(np.sqrt(np.mean(np.concatenate(
        [s.reshape(-1) for s in sq]))))


def race_entry(entry: ZooEntry, size: str = "micro", *,
               arms: Sequence[str] = tuple(ARMS),
               registry: Optional[MetricsRegistry] = None,
               on_arm: Optional[Callable] = None,
               budget_cap: Optional[int] = None,
               verbose: bool = False, device="cuda",
               on_fit: Optional[Callable] = None) -> Dict:
    """Race the selected arms for one entry; returns its scorecard block.

    ``registry`` receives the ``zoo.*`` instruments (per-arm gating and
    accuracy); each arm trains under its OWN fresh registry so the
    ``resample.*`` stall/redraw numbers never mix across arms.
    ``budget_cap`` caps each optimizer phase (the fast/CI knob — capped
    runs measure the contract, not the gate).  ``on_arm(entry_result)``
    fires after each completed arm for partial-salvage streaming.
    ``device``: the solvers' (the card by default).  ``on_fit(arm, solver,
    telemetry, trajectory)`` fires after each arm's ``fit``, before its
    block is assembled, with the ``(step, metric)`` evaluations (a harness
    reads the solver's timings and counters there).
    """
    from ..telemetry import default_registry

    spec = entry.spec(size)
    adam = spec.budget.adam if budget_cap is None \
        else min(spec.budget.adam, budget_cap)
    lbfgs = spec.budget.lbfgs if budget_cap is None \
        else min(spec.budget.lbfgs, budget_cap)
    eval_every, resample_every = cadences(adam)
    ref = entry.reference(spec) if entry.reference is not None else None
    gate = entry.gate(size)
    top_reg = registry if registry is not None else default_registry()

    result = {
        "title": entry.title, "equation": entry.equation,
        "n_components": entry.n_components, "system": entry.system,
        "tags": list(entry.tags),
        "reference": "exact" if ref is not None else "residual-only",
        "budget": {"adam": adam, "lbfgs": lbfgs},
        "gate": {"kind": "rel_l2" if ref is not None else "residual",
                 "value": gate},
        "engine": None,
        "arms": {},
    }
    if budget_cap is not None and (adam < spec.budget.adam
                                   or lbfgs < spec.budget.lbfgs):
        result["budget_capped"] = (
            f"declared {spec.budget.adam}+{spec.budget.lbfgs} capped at "
            f"{budget_cap}/phase; gates measured against the declared "
            "budget do not apply")

    for arm in arms:
        solver = build_solver(entry, size, spec=spec, verbose=verbose,
                              device=device)
        if result["engine"] is None:
            result["engine"] = engine_label(solver)
        held_out = None if ref is not None \
            else _held_out_points(solver.domain)
        reg = MetricsRegistry()
        tele = TrainingTelemetry(logger=None, registry=reg, log_every=0,
                                 grad_norm=False,
                                 raise_on_divergence=False)
        traj = []

        def eval_fn(phase, step, params):
            if ref is not None:
                pred = solver._apply_eval(params, ref.X)
                metric = float(find_L2_error(ref.compare(pred), ref.u))
            else:
                metric = _residual_rms(
                    solver._residual_eval(params, held_out))
            traj.append((step + (adam if phase != "adam" else 0), metric))

        fit_kw = dict(ARMS[arm])
        if arm != "fixed":
            fit_kw["resample_every"] = resample_every
        t0 = time.time()
        solver.fit(tf_iter=adam, newton_iter=lbfgs, eval_fn=eval_fn,
                   eval_every=eval_every, telemetry=tele, **fit_kw)
        wall = time.time() - t0
        if on_fit is not None:
            on_fit(arm, solver, tele, traj)

        # reach-and-hold gating: the step from which every remaining eval
        # sat at/below the gate (None if the last eval was above it)
        held_from = None
        for total, metric in traj:
            if metric <= gate:
                held_from = total if held_from is None else held_from
            else:
                held_from = None
        final = traj[-1][1] if traj else None

        snap = reg.as_dict()
        stall = snap["histograms"].get("resample.stall_s")
        cost = getattr(tele, "_cost", None)
        arm_out = {
            "gated": held_from is not None,
            "steps_to_gate": held_from,
            ("rel_l2_final" if ref is not None else "residual_final"):
                (round(final, 6) if final is not None else None),
            "wall_s": round(wall, 1),
            "redraws": snap["counters"].get("resample.redraws", 0),
            "stall_p50_s": (round(float(stall["p50"]), 5)
                            if stall and stall.get("p50") is not None
                            else None),
            "flops_per_step": (getattr(cost, "flops_per_step", None)),
            "flops_basis": getattr(cost, "basis", None),
        }
        result["arms"][arm] = arm_out

        scope = top_reg.scope(entry=entry.id, arm=arm)
        scope.counter("zoo.arms").inc()
        if held_from is not None:
            scope.counter("zoo.gated").inc()
            scope.gauge("zoo.steps_to_gate").set(held_from)
        if final is not None:
            scope.gauge("zoo.rel_l2_final" if ref is not None
                        else "zoo.residual_final").set(final)
        top_reg.histogram("zoo.race_wall_s", entry=entry.id).observe(wall)

        log_event("zoo", f"{entry.id}/{arm}: gated={arm_out['gated']} "
                         f"steps_to_gate={arm_out['steps_to_gate']} "
                         f"final={final} wall={arm_out['wall_s']}s "
                         f"engine={result['engine']}",
                  verbose=verbose)
        if on_arm is not None:
            on_arm(result)
    return result


def run_scorecard(entry_ids: Optional[Iterable[str]] = None,
                  size: str = "micro", *,
                  registry: Optional[MetricsRegistry] = None,
                  on_entry: Optional[Callable] = None,
                  budget_cap: Optional[int] = None,
                  verbose: bool = False, device="cuda") -> Dict:
    """Race every selected entry (default: the whole registry) and
    assemble the scorecard document.  ``on_entry(scorecard)`` fires after
    each completed entry with the scorecard-so-far (partial-salvage
    streaming)."""
    from .registry import ids as all_ids

    selected = list(entry_ids) if entry_ids else list(all_ids())
    card = {"schema": SCHEMA_VERSION, "size": size,
            "arms": list(ARMS), "entries": {}}
    if budget_cap is not None:
        card["budget_cap"] = budget_cap
    for eid in selected:
        entry = get(eid)
        card["entries"][eid] = race_entry(
            entry, size, registry=registry, budget_cap=budget_cap,
            verbose=verbose, device=device)
        if on_entry is not None:
            on_entry(card)
    return card


def scorecard_of(doc: Dict) -> Dict:
    """Accept either a bare scorecard document or a payload wrapping one
    (``payload["scorecard"]``, the JAX package's ``bench.py --zoo``)."""
    if "entries" in doc and "schema" in doc:
        return doc
    card = doc.get("scorecard")
    if not (isinstance(card, dict) and "entries" in card):
        raise ValueError(
            "not a zoo scorecard: expected a document with "
            "schema/entries or a bench payload with a 'scorecard' key")
    return card


def diff_scorecards(baseline: Dict, current: Dict) -> Dict:
    """The diff: hold the current scorecard to the baseline's gated
    claims.  A regression is an entry-arm that the baseline gated but
    the current run does not (``gate-lost``), or an entry whose adopted
    engine fell off the fused minimax fast path (``engine-downgrade``).
    Entries/arms present in the baseline but absent from the current run
    are ``skipped`` (subset runs are legal), never regressions; a capped
    current run (``budget_cap``) skips gate comparison entirely.
    Returns a verdict dict; the caller maps ``ok`` to the exit code.
    """
    baseline, current = scorecard_of(baseline), scorecard_of(current)
    regressions, skipped, added = [], [], []
    capped = "budget_cap" in current
    for eid, base_e in baseline.get("entries", {}).items():
        cur_e = current.get("entries", {}).get(eid)
        if cur_e is None:
            skipped.append(eid)
            continue
        base_engine = base_e.get("engine") or ""
        cur_engine = cur_e.get("engine") or ""
        if (base_engine.startswith("fused-minimax")
                and not cur_engine.startswith("fused-minimax")):
            regressions.append(
                {"entry": eid, "kind": "engine-downgrade",
                 "baseline": base_engine, "current": cur_engine})
        if capped:
            continue
        for arm, base_a in base_e.get("arms", {}).items():
            cur_a = cur_e.get("arms", {}).get(arm)
            if cur_a is None:
                skipped.append(f"{eid}/{arm}")
                continue
            if base_a.get("gated") and not cur_a.get("gated"):
                metric = ("rel_l2_final" if "rel_l2_final" in base_a
                          else "residual_final")
                regressions.append(
                    {"entry": eid, "arm": arm, "kind": "gate-lost",
                     "gate": base_e.get("gate"),
                     "baseline": base_a.get(metric),
                     "current": cur_a.get(metric)})
    for eid in current.get("entries", {}):
        if eid not in baseline.get("entries", {}):
            added.append(eid)
    return {"ok": not regressions, "regressions": regressions,
            "skipped": sorted(skipped), "added": sorted(added),
            "compared": len(baseline.get("entries", {}))
            - len([s for s in skipped if "/" not in s]),
            "budget_capped": capped}
