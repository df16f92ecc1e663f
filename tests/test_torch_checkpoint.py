"""Checkpoint and resume in the port (``tensordiffeq_tpu_torch/checkpoint.py``
and the solver's state methods), on the CPU.

The single-process cases of ``tests/test_checkpoint.py`` (round trip,
resume, restore before compile, a mismatched configuration, the raw API,
self-describing save/load, transfer learning, an architecture mismatch, a
mid-run resume, the credit for L-BFGS progress) and the protocol cases of
``tests/test_resilience.py`` (the previous generation kept, a corrupt or
torn generation falling back, every generation corrupt, a solver restore
over a torn current generation).  Within the port a resume is bit for bit:
the same float32 operations on the same state.
"""

import json
import os

import numpy as np
import pytest
import torch

from tensordiffeq_tpu_torch import (CollocationSolverND, DomainND, IC,
                                    NotPortedError, dirichletBC, grad)
from tensordiffeq_tpu_torch.checkpoint import (CheckpointCorrupted,
                                               TemplateMismatch,
                                               checkpoint_exists,
                                               resolve_checkpoint_dir,
                                               restore_checkpoint,
                                               save_checkpoint,
                                               verify_checkpoint)

torch.set_num_threads(1)


def make_solver(n_f=128, lr=0.005, seed=0):
    domain = DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 16)
    domain.add("t", [0.0, 1.0], 8)
    domain.generate_collocation_points(n_f, seed=0)
    bcs = [IC(domain, [lambda x: -np.sin(np.pi * x)], var=[["x"]]),
           dirichletBC(domain, val=0.0, var="x", target="upper"),
           dirichletBC(domain, val=0.0, var="x", target="lower")]

    def f_model(u, x, t):
        u_x, u_t = grad(u, "x"), grad(u, "t")
        return u_t(x, t) + u(x, t) * u_x(x, t) - 0.01 * grad(u_x, "x")(x, t)

    s = CollocationSolverND(verbose=False, seed=seed, device="cpu")
    s.compile([2, 8, 8, 1], f_model, domain, bcs, Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [True, False, False]},
              init_weights={"residual": [np.random.RandomState(0).rand(n_f, 1)],
                            "BCs": [np.random.RandomState(1).rand(16, 1),
                                    None, None]},
              lr=lr)
    return s


def leaves(s):
    return [t.detach().numpy().copy() for pair in s.net.layers()
            for t in pair]


def total_losses(s):
    return [r["Total Loss"] for r in s.losses]


def test_roundtrip_params_lambdas_opt_state(tmp_path):
    s = make_solver()
    s.fit(tf_iter=10, chunk=5)
    s.save_checkpoint(str(tmp_path / "ck"))

    s2 = make_solver(seed=1)  # another init, overwritten by the restore
    s2.restore_checkpoint(str(tmp_path / "ck"))
    np.testing.assert_array_equal(s2.lambdas["residual"][0].detach(),
                                  s.lambdas["residual"][0].detach())
    np.testing.assert_array_equal(s2.lambdas["BCs"][0].detach(),
                                  s.lambdas["BCs"][0].detach())
    for a, b in zip(leaves(s), leaves(s2)):
        np.testing.assert_array_equal(a, b)
    assert s2._opt is not None
    for o1, o2 in zip(s._opt, s2._opt):
        for p1, p2 in zip(o1.param_groups[0]["params"],
                          o2.param_groups[0]["params"]):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(o1.state[p1][k], o2.state[p2][k])
    assert total_losses(s2) == total_losses(s)
    assert s2.min_loss == s.min_loss and s2.best_epoch == s.best_epoch
    assert float(s2.update_loss()[0].detach()) == \
        float(s.update_loss()[0].detach())
    with pytest.raises(NotPortedError, match="ROADMAP"):
        s.save_checkpoint(str(tmp_path / "sh"), sharded=True)


def test_resume_continues_not_restarts(tmp_path):
    s_full = make_solver()
    s_full.fit(tf_iter=20, chunk=10)

    s_a = make_solver()
    s_a.fit(tf_iter=10, chunk=10)
    s_a.save_checkpoint(str(tmp_path / "ck"))
    s_b = make_solver(seed=1)
    s_b.restore_checkpoint(str(tmp_path / "ck"))
    s_b.fit(tf_iter=10, chunk=10)
    for a, b in zip(leaves(s_full), leaves(s_b)):
        np.testing.assert_array_equal(a, b)
    assert total_losses(s_b) == total_losses(s_full)


def test_restore_requires_compile(tmp_path):
    s = make_solver()
    s.save_checkpoint(str(tmp_path / "ck"))
    s2 = CollocationSolverND(verbose=False, device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        s2.restore_checkpoint(str(tmp_path / "ck"))


def test_mismatched_config_rejected(tmp_path):
    s = make_solver()
    s.fit(tf_iter=5, chunk=5)
    s.save_checkpoint(str(tmp_path / "ck"))
    s2 = make_solver(n_f=64)  # another λ length
    with pytest.raises(TemplateMismatch):
        s2.restore_checkpoint(str(tmp_path / "ck"))


def test_raw_api_roundtrip(tmp_path):
    state = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
             "nested": {"b": np.float32(3.5), "none": None,
                        "t": [torch.ones(2, dtype=torch.float64)]}}
    save_checkpoint(str(tmp_path / "raw"), state, meta={"note": "hi"})
    assert checkpoint_exists(str(tmp_path / "raw"))
    verify_checkpoint(str(tmp_path / "raw"))
    out, meta = restore_checkpoint(str(tmp_path / "raw"), state)
    np.testing.assert_array_equal(out["a"], state["a"])
    assert out["nested"]["b"] == np.float32(3.5)
    assert out["nested"]["none"] is None
    assert out["nested"]["t"][0].dtype == np.float64
    assert meta["note"] == "hi"
    with open(os.path.join(str(tmp_path / "raw"), "tdq_meta.json")) as fh:
        info = json.load(fh)
    assert {"backend", "meta", "leaf_shapes", "save_id", "checksum"} \
        <= set(info)
    assert info["checksum"]["algo"] == "sha256"
    with pytest.raises(TemplateMismatch):
        restore_checkpoint(str(tmp_path / "raw"),
                           {**state, "a": np.zeros((3, 2), np.float32)})
    with pytest.raises(NotPortedError, match="ROADMAP"):
        save_checkpoint(str(tmp_path / "sh"), state, sharded=True)
    with pytest.raises(TypeError):
        save_checkpoint(str(tmp_path / "obj"), {"o": np.array([{}])})


def test_self_describing_save_load(tmp_path):
    s = make_solver()
    s.fit(tf_iter=5, chunk=5)
    s.save(str(tmp_path / "model.tdq"))
    with open(tmp_path / "model.tdq", "rb") as fh:
        assert fh.read(4) == b"TDQM"

    s2 = CollocationSolverND(verbose=False, device="cpu")
    s2.load_model(str(tmp_path / "model.tdq"))  # no compile, no layer_sizes
    assert s2.layer_sizes == [2, 8, 8, 1]
    X = np.random.RandomState(0).rand(7, 2).astype(np.float32)
    u2, f2 = s2.predict(X)
    u1, _ = s.predict(X)
    np.testing.assert_array_equal(u2, u1)
    assert f2 is None  # no f_model yet: the solution network only


def test_transfer_learn_without_restating_architecture(tmp_path):
    s = make_solver()
    s.fit(tf_iter=5, chunk=5)
    s.save(str(tmp_path / "model.tdq"))

    s2 = CollocationSolverND(verbose=False, device="cpu")
    with pytest.raises(ValueError, match="load_model"):
        s2.compile(None, s.f_model, s.domain, s.bcs)
    s2.load_model(str(tmp_path / "model.tdq"))
    s2.compile(None, s.f_model, s.domain, s.bcs, Adaptive_type=1,
               dict_adaptive={"residual": [True], "BCs": [True, False, False]},
               init_weights={"residual": [np.random.RandomState(0).rand(128, 1)],
                             "BCs": [np.random.RandomState(1).rand(16, 1),
                                     None, None]},
               lr=0.0005)
    for a, b in zip(leaves(s), leaves(s2)):
        np.testing.assert_array_equal(a, b)  # params carried over
    s2.fit(tf_iter=5, chunk=5)
    assert np.isfinite(s2.losses[-1]["Total Loss"])


def test_saved_arch_mismatch_rejected(tmp_path):
    s = make_solver()
    s.save(str(tmp_path / "model.tdq"))
    s2 = CollocationSolverND(verbose=False, device="cpu")
    s2.compile([2, 4, 1], s.f_model, s.domain, s.bcs)
    with pytest.raises(ValueError, match="layer_sizes"):
        s2.load_model(str(tmp_path / "model.tdq"))


def test_midrun_checkpoint_resume_matches_uninterrupted(tmp_path):
    """``fit(checkpoint_dir=, checkpoint_every=)`` saves the live state at
    chunk boundaries; a fresh solver restored from it replays the
    uninterrupted run bit for bit."""
    ck = str(tmp_path / "midck")
    ctrl = make_solver()
    ctrl.fit(tf_iter=90, chunk=15)

    a = make_solver()  # "killed" at epoch 60; checkpoints every 30
    a.fit(tf_iter=60, chunk=15, checkpoint_dir=ck, checkpoint_every=30)
    b = make_solver()
    b.restore_checkpoint(ck)
    assert len(b.losses) == 60
    b.fit(tf_iter=30, chunk=15)
    assert total_losses(b) == total_losses(ctrl)
    for x, y in zip(leaves(b), leaves(ctrl)):
        np.testing.assert_array_equal(x, y)
    # λ kept ascending through the resume
    assert not np.allclose(b.lambdas["residual"][0].detach(),
                           a.lambdas["residual"][0].detach())


def test_midrun_checkpoint_credits_lbfgs_progress(tmp_path):
    """Mid-L-BFGS checkpoints record the absolute ``newton_done`` and the
    current iterate, across several kill/resume windows."""
    ck = str(tmp_path / "nck")
    a = make_solver()
    a.fit(tf_iter=30, chunk=15, newton_iter=60, checkpoint_dir=ck,
          checkpoint_every=30)
    assert a.newton_done == 60

    b = make_solver()
    b.restore_checkpoint(ck)
    assert b.newton_done == 60  # absolute, from the checkpoint
    # the history as it stood at the save: the refinement's own history
    # joins it when the leg returns, its progress rides in newton_done
    assert len(b.losses) == 30
    for x, y in zip(leaves(a), leaves(b)):  # the iterate at the save
        np.testing.assert_array_equal(x, y)
    b.fit(tf_iter=0, newton_iter=40, checkpoint_dir=ck, checkpoint_every=20)
    assert b.newton_done == 100
    # the skipped Adam phase does not poison the best-model selection
    assert b.best_model["overall"] is not None
    c = make_solver()
    c.restore_checkpoint(ck)
    assert c.newton_done == 100 and len(c.losses) == 30


# --------------------------------------------------------------------------- #
# the crash-safety protocol
# --------------------------------------------------------------------------- #
def _raw_state(v: float):
    return {"a": np.full((4, 4), v, np.float32),
            "b": np.arange(3, dtype=np.float32)}


def _corrupt_payload(gen_dir):
    """Garble the largest payload file of one generation."""
    victim = max((os.path.join(r, f) for r, _, fs in os.walk(gen_dir)
                  for f in fs if f != "tdq_meta.json"),
                 key=os.path.getsize)
    with open(victim, "r+b") as fh:
        fh.seek(0)
        fh.write(b"\xde\xad\xbe\xef")


def _tear_payload(gen_dir):
    """What a write cut short leaves: the payload truncated to half."""
    victim = max((os.path.join(r, f) for r, _, fs in os.walk(gen_dir)
                  for f in fs if f != "tdq_meta.json"),
                 key=os.path.getsize)
    with open(victim, "r+b") as fh:
        fh.truncate(max(os.path.getsize(victim) // 2, 1))


def test_checkpoint_keeps_previous_generation(tmp_path):
    p = str(tmp_path / "ck")
    save_checkpoint(p, _raw_state(1.0), meta={"gen": 1})
    save_checkpoint(p, _raw_state(2.0), meta={"gen": 2})
    assert os.path.exists(os.path.join(p + ".old", "tdq_meta.json"))
    assert not os.path.exists(p + ".tmp")
    out, meta = restore_checkpoint(p, _raw_state(0.0))
    assert meta["gen"] == 2 and out["a"][0, 0] == 2.0


def test_checksum_detects_corruption_and_falls_back(tmp_path):
    p = str(tmp_path / "ck")
    save_checkpoint(p, _raw_state(1.0), meta={"gen": 1})
    save_checkpoint(p, _raw_state(2.0), meta={"gen": 2})
    _corrupt_payload(p)
    with pytest.raises(ValueError, match="checksum"):
        verify_checkpoint(p)
    out, meta = restore_checkpoint(p, _raw_state(0.0))  # falls back intact
    assert meta["gen"] == 1 and out["a"][0, 0] == 1.0


def test_torn_checkpoint_falls_back(tmp_path):
    p = str(tmp_path / "ck")
    save_checkpoint(p, _raw_state(1.0), meta={"gen": 1})
    save_checkpoint(p, _raw_state(2.0), meta={"gen": 2})
    _tear_payload(p)
    out, meta = restore_checkpoint(p, _raw_state(0.0))
    assert meta["gen"] == 1 and out["a"][0, 0] == 1.0
    # a save killed between its two renames leaves only .old
    os.rename(p, str(tmp_path / "gone"))
    assert resolve_checkpoint_dir(p) == os.path.abspath(p) + ".old"
    assert checkpoint_exists(p)
    assert restore_checkpoint(p, _raw_state(0.0))[1]["gen"] == 1


def test_all_generations_corrupt_raises_structured(tmp_path):
    p = str(tmp_path / "ck")
    save_checkpoint(p, _raw_state(1.0), meta={"gen": 1})
    save_checkpoint(p, _raw_state(2.0), meta={"gen": 2})
    for d in (p, p + ".old"):
        _corrupt_payload(d)
    with pytest.raises(CheckpointCorrupted) as ei:
        restore_checkpoint(p, _raw_state(0.0))
    assert len(ei.value.failures) == 2


def test_solver_restore_survives_torn_current_generation(tmp_path):
    ck = str(tmp_path / "ck")
    s = make_solver()
    s.fit(tf_iter=10, chunk=5, checkpoint_dir=ck,
          checkpoint_every=5)  # two generations: epoch 5 (.old) + epoch 10
    _tear_payload(ck)
    s2 = make_solver(seed=1)
    s2.restore_checkpoint(ck)  # falls back to the epoch-5 generation
    assert len(s2.losses) == 5
    s2.fit(tf_iter=5, chunk=5)  # and it trains on
    assert np.isfinite(s2.losses[-1]["Total Loss"])
