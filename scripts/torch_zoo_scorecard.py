"""The port's zoo scorecard on the card, diffed against the JAX package's
``SCORECARD.json``.

Races every zoo entry's three arms (fixed, pool, ascent) with
``tensordiffeq_tpu_torch.zoo.run_scorecard`` at ``--size`` (``micro``: the
size of the baseline, uncapped: 27 races at the declared budgets), on the
card, and writes the scorecard JSON to ``--out`` (default
``runs/torch_zoo/scorecard.<size>.json``, git-ignored).  Then prints
``diff_scorecards(SCORECARD.json, card)``, and per entry and arm the
port's final metric beside the baseline's.

An ``engine-downgrade`` (an entry off the fused minimax step) fails the
script (exit 1).  A ``gate-lost`` is reported, not gated: the port draws its
initial weights from a ``torch.Generator``, so its trajectories are not the
JAX package's, and the baseline was calibrated on the JAX package's CPU.

    python scripts/torch_zoo_scorecard.py [--size micro] [--cap N]
        [--entries burgers,schrodinger] [--out PATH]

The last line is the verdict as one JSON object; the line before it the
card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="micro")
    ap.add_argument("--cap", type=int, default=None,
                    help="cap each optimizer phase (a capped card skips "
                    "the gate comparison)")
    ap.add_argument("--entries", default=None,
                    help="comma-separated entry ids (default: all)")
    ap.add_argument("--baseline", default=os.path.join(REPO,
                                                      "SCORECARD.json"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", flush=True)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tensordiffeq_tpu_torch import zoo

    card = card_line()
    print(card, flush=True)
    out = args.out or os.path.join(REPO, "runs", "torch_zoo",
                                   f"scorecard.{args.size}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    ids = args.entries.split(",") if args.entries else None
    t0 = time.time()

    def on_entry(sc):
        eid = list(sc["entries"])[-1]
        e = sc["entries"][eid]
        arms = ", ".join(
            f"{a} {r.get('rel_l2_final', r.get('residual_final'))} "
            f"(gated {r['gated']}, {r['wall_s']} s, redraws {r['redraws']})"
            for a, r in e["arms"].items())
        print(f"[scorecard {eid}] engine {e['engine']}: {arms}; "
              f"{time.time() - t0:.0f} s so far", flush=True)
        with open(out, "w") as fh:  # the card so far
            json.dump(dict(sc, device=card), fh, indent=1)

    sc = zoo.run_scorecard(ids, args.size, budget_cap=args.cap,
                           on_entry=on_entry)
    with open(out, "w") as fh:
        json.dump(dict(sc, device=card), fh, indent=1)
    with open(args.baseline) as fh:
        base = zoo.scorecard_of(json.load(fh))
    verdict = zoo.diff_scorecards(base, sc)
    for eid, e in sc["entries"].items():
        b = base["entries"].get(eid, {})
        for arm, r in e["arms"].items():
            ba = b.get("arms", {}).get(arm, {})
            key = "rel_l2_final" if "rel_l2_final" in r else "residual_final"
            print(f"[diff {eid}/{arm}] port {key} {r[key]} gated "
                  f"{r['gated']} (steps {r['steps_to_gate']}, "
                  f"{r['wall_s']} s) | baseline {ba.get(key)} gated "
                  f"{ba.get('gated')} (steps {ba.get('steps_to_gate')}, "
                  f"{ba.get('wall_s')} s on the JAX package's CPU); gate "
                  f"{e['gate']['value']}", flush=True)
    downgrades = [r for r in verdict["regressions"]
                  if r["kind"] == "engine-downgrade"]
    gate_lost = [r for r in verdict["regressions"] if r["kind"] == "gate-lost"]
    cells = [(eid, a) for eid, e in sc["entries"].items() for a in e["arms"]]
    gated = sum(sc["entries"][eid]["arms"][a]["gated"] for eid, a in cells)
    print(card, flush=True)
    print(json.dumps({"ok": not downgrades, "scorecard": out,
                      "wall_s": round(time.time() - t0, 1),
                      "cells": len(cells), "gated": int(gated),
                      "engine_downgrade": downgrades,
                      "gate_lost": gate_lost,
                      "skipped": verdict["skipped"],
                      "budget_capped": verdict["budget_capped"]}),
          flush=True)
    if downgrades:
        sys.exit(1)


if __name__ == "__main__":
    main()
