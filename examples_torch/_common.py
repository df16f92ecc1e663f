"""Shared CLI plumbing for the PyTorch port's example scripts.

Every example accepts ``--quick`` (tiny iteration counts and small nets,
for smoke tests), ``--plot PATH`` (save figures under PATH) and
``--device`` (``cuda`` by default: the scripts run on the card and raise
``CudaUnavailableError`` without one; ``--device cpu`` runs them on the
CPU).  The full-size defaults are the configurations of the JAX package's
``examples/``, resolved from the port's zoo where the JAX script resolves
them from its own.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def example_args(description: str, flags=(), **extra):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--quick", action="store_true",
                    help="tiny config for smoke testing")
    ap.add_argument("--plot", default=None, metavar="PATH",
                    help="save diagnostic plots under this directory")
    ap.add_argument("--device", default="cuda",
                    help="where to train: 'cuda' (the default) or 'cpu'")
    for flag in flags:
        ap.add_argument(f"--{flag}", action="store_true")
    for name, (default, help_) in extra.items():
        ap.add_argument(f"--{name}", type=type(default), default=default,
                        help=help_)
    return ap.parse_args()


def scaled(args, full: int, quick: int) -> int:
    return quick if args.quick else full


def zoo_spec(entry, quick: bool, quick_budget=(200, 100), **overrides):
    """An example's operating point from its zoo entry: the declared
    ``full`` size, or for ``--quick`` the declared ``micro`` problem at
    smoke iteration counts; non-zero ``overrides`` (``n_f=``, ``widths=``,
    ``budget=``) are CLI scale knobs on top."""
    import dataclasses

    from tensordiffeq_tpu_torch.zoo import Budget

    spec = entry.spec("micro" if quick else "full")
    if quick:
        spec = dataclasses.replace(spec, budget=Budget(*quick_budget))
    clean = {k: v for k, v in overrides.items() if v}
    if clean:
        spec = dataclasses.replace(spec, **clean)
    return spec


def fit_resumable(solver, tf_iter: int, newton_iter: int = 0,
                  quick: bool = False, **fit_kw):
    """``solver.fit`` with optional cross-run resume: with ``TDQ_CKPT``
    naming a directory (and not ``quick``), the state checkpoints there at
    chunk boundaries and a rerun of the same example resumes where a
    killed run stopped; a completed run removes the checkpoint.  Without
    it this is exactly ``solver.fit``."""
    import shutil

    ck = None if quick else os.environ.get("TDQ_CKPT")
    if not ck:
        return solver.fit(tf_iter=tf_iter, newton_iter=newton_iter, **fit_kw)
    done = n_done = 0
    if os.path.exists(os.path.join(ck, "tdq_meta.json")) \
            or os.path.exists(os.path.join(ck + ".old", "tdq_meta.json")):
        try:
            solver.restore_checkpoint(ck)
            done = min(len(solver.losses), tf_iter)
            n_done = min(getattr(solver, "newton_done", 0), newton_iter)
            print(f"[tdq] resumed from {ck}: {done} Adam epochs, "
                  f"{n_done} L-BFGS iters", flush=True)
        except Exception as e:
            print(f"[tdq] checkpoint in {ck} not restorable "
                  f"({type(e).__name__}: {e}); starting fresh", flush=True)
    out = solver.fit(tf_iter=tf_iter - done,
                     newton_iter=newton_iter - n_done,
                     checkpoint_dir=ck,
                     checkpoint_every=max(200, tf_iter // 10), **fit_kw)
    for d in (ck, ck + ".old", ck + ".tmp"):
        shutil.rmtree(d, ignore_errors=True)
    return out
