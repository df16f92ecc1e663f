"""ms per Adam step of the two training paths of one checkout, on one
NVIDIA GPU: ``chip_smoke.py``'s phases 6 and 7 alone.

    python3 scripts/torch_ab_paths.py <checkout>

``<checkout>`` is the root of a checkout (this one, or another commit
unpacked with ``git archive`` into a git-ignored directory such as
``_compare/``); its package and its ``chip_smoke.py`` are imported, its
kernels built into its own ``_build/``.  To compare two commits on one
card, run each in its own process in turns, parent, change, change,
parent::

    for t in _compare/parent _compare/change _compare/change _compare/parent
    do python3 scripts/torch_ab_paths.py $t; done

Prints ``[slice ...]`` lines as the smoke does and one ``[ab <checkout>]``
line with the ms/step of the minimax and unfused paths (200 steps each,
the graph's warm-up and capture included).
"""

from __future__ import annotations

import os
import sys


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ct.build()
    out = {tag: cs.phase_slice(cs.TF_ITER, minimax=m)["ms_step"]
           for tag, m in (("minimax", None), ("unfused", False))}
    print(f"[ab {sys.argv[1]}] ms/step {out} ({cs.card_line()})",
          flush=True)


if __name__ == "__main__":
    main()
