"""The surrogate factory over ``torch.distributed`` (``SurrogateFactory(
dist=...)``) on the CPU: two gloo processes (``tests/torch_dist_harness.py``,
one spawn for the module) each own two of a 4-member family's members and
train them with no collective inside the step.

* the world-2 family's history (gathered at each chunk boundary, the same
  on both ranks) and each member's parameters equal the world-1 family's;
* the world-2 checkpoint (sharded by member block) restores into a
  world-1 factory, whose state then equals the ranks' blocks bit for bit
  and which trains on as the world-1 family does.
"""

import inspect

import numpy as np
import pytest
import torch

import test_torch_factory as base
from torch_dist_harness import start

torch.set_num_threads(1)
THETAS = [0.001, 0.005, 0.01, 0.02]
STEPS = 10

# test_torch_factory.py's problem for the ranks, which import nothing of JAX
# or of the test files
PROBLEM = "\n".join(
    ["import tensordiffeq_tpu_torch as tdqt",
     "from tensordiffeq_tpu_torch.factory import SurrogateFactory",
     f"N_F, LAYERS = {base.N_F}, {base.LAYERS}",
     "SA_KW = dict(Adaptive_type=1, dict_adaptive={'residual': [True], "
     "'BCs': [False] * 3}, init_weights={'residual': [np.ones((N_F, 1))], "
     "'BCs': [None] * 3})"]
    + [inspect.getsource(f) for f in (base.make_domain, base.make_bcs,
                                      base.f_model_for, base.make_factory)])
make_factory = base.make_factory

WORKER = PROBLEM + '''
fac = make_factory(THETAS, dist=True)
assert fac._members == [2 * RANK, 2 * RANK + 1], fac._members
fac.fit(tf_iter=STEPS, chunk=5)
fac.save_checkpoint(os.path.join(os.path.dirname(OUT), "ck"))
RESULT["hist"] = [r["Total Loss"].tolist() for r in fac.losses]
RESULT["alive"] = [r["Alive"].tolist() for r in fac.losses]
RESULT["params"] = [p.detach().numpy().tolist() for p in fac.params]
RESULT["members"] = fac._members
'''.replace("THETAS", repr(THETAS)).replace("STEPS", str(STEPS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("factory_dist")
    pending = start(WORKER, str(work), world=2, timeout_s=90.0)
    w1 = make_factory(THETAS)
    w1.fit(tf_iter=STEPS, chunk=5)
    return pending.wait(), w1, work


def test_world_2_family_equals_world_1(runs):
    ranks, w1, _ = runs
    want = [r["Total Loss"].tolist() for r in w1.losses]
    for r in ranks:
        assert r["hist"] == want
        assert all(a == [1.0] * len(THETAS) for a in r["alive"])
    for r in ranks:
        for got, full in zip(r["params"], w1.params):
            np.testing.assert_array_equal(
                np.asarray(got, np.float32),
                full.detach().numpy()[r["members"]])


def test_world_2_checkpoint_restores_at_world_1(runs):
    ranks, w1, work = runs
    fac = make_factory(THETAS)
    fac.restore_checkpoint(str(work / "ck"))
    for r in ranks:
        for got, live in zip(r["params"], fac.params):
            np.testing.assert_array_equal(
                live.detach().numpy()[r["members"]],
                np.asarray(got, np.float32))
    assert len(fac.losses) == STEPS
    # it trains on as the uninterrupted world-1 family does
    for f in (fac, w1):
        f.fit(tf_iter=4, chunk=2)
    assert [r["Total Loss"].tolist() for r in fac.losses] == \
        [r["Total Loss"].tolist() for r in w1.losses]
    assert np.isfinite(fac.member_losses()).all()
