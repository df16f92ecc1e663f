"""Write the port's checkpoint fixture: a solver's full checkpoint, its
``save()`` model file, and what the solver gives after them.

Run from the root of a checkout (the fixture records the checkout's
layouts)::

    JAX_PLATFORMS=cpu python scripts/torch_ckpt_fixture.py --out DIR

On the CPU: the small Burgers SA solver of ``tests/test_torch_checkpoint.py``
(``make_solver``) trains 10 Adam epochs and writes ``DIR/ck`` (the
checkpoint) and ``DIR/model.tdq`` (``save``); ``DIR/expected.npz`` holds its
parameters, its ``update_loss()`` total, and the losses of 5 more Adam epochs
and 3 L-BFGS iterations after it.  ``tests/test_torch_network_options.py``
restores the fixture written by an earlier layout into the current code and
holds every number to it bit for bit.
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_checkpoint import make_solver  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    out = ap.parse_args().out
    os.makedirs(out, exist_ok=True)
    torch.manual_seed(0)
    s = make_solver()
    s.fit(tf_iter=10, chunk=5)
    s.save_checkpoint(os.path.join(out, "ck"))
    s.save(os.path.join(out, "model.tdq"))
    params = [t.detach().numpy().copy() for pair in s.net.layers()
              for t in pair]
    total = float(s.update_loss()[0])
    s.fit(tf_iter=5, chunk=5, newton_iter=3)
    after = [r["Total Loss"] for r in s.losses[10:]]
    np.savez(os.path.join(out, "expected.npz"),
             total=np.float64(total), after=np.asarray(after, np.float64),
             **{f"p{i}": p for i, p in enumerate(params)})
    print(f"fixture in {out}: {len(params)} arrays, total {total!r}, "
          f"{len(after)} further losses")


if __name__ == "__main__":
    main()
