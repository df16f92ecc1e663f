"""Progress reporting with a tqdm-free fallback (the JAX package's
``training/progress.py``): the Adam, L-BFGS and discovery loops show one
bar under ``verbose``, advanced once per chunk."""

from __future__ import annotations


class _PlainBar:
    """Minimal stand-in for ``tqdm.trange`` when tqdm is unavailable:
    accepts the same calls, prints a line every update."""

    def __init__(self, total: int, desc: str = ""):
        self.total = total
        self.desc = desc
        self.n = 0
        self._postfix = ""

    def update(self, n: int = 1):
        self.n += n
        print(f"{self.desc}: {self.n}/{self.total} {self._postfix}", flush=True)

    def set_postfix(self, **kwargs):
        self._postfix = " ".join(f"{k}={v}" for k, v in kwargs.items())

    def close(self):
        pass


def progress_bar(total: int, desc: str = ""):
    """A ``tqdm`` bar over ``total`` steps, or :class:`_PlainBar` where
    tqdm is not installed."""
    try:
        from tqdm.auto import trange
        return trange(total, desc=desc)
    except Exception:  # no tqdm
        return _PlainBar(total, desc)
