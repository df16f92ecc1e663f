"""The port's example scripts (``examples_torch/``) stay runnable.

The scripts that ``tests/test_examples.py`` runs for the JAX package run
here in-process with ``--quick --device cpu`` (each asserts what it
demonstrates: the fleet's three among them — the factory's artifact batch
fleet-served, two tenants served in a fresh process with tenant "b"'s
residual from the lowered tape, and the closed drift → retrain → hot-swap
loop); every one of the nineteen answers ``--help`` (its imports resolve
and its flags parse).  On the card, ``chip_smoke.py`` phase 20 runs all
nineteen with ``--quick``.
"""

import os
import runpy
import sys

import pytest
import torch

torch.set_num_threads(1)
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "examples_torch")
SCRIPTS = sorted(f for f in os.listdir(EXAMPLES)
                 if f.endswith(".py") and not f.startswith("_"))


def run_example(name, *argv):
    old_argv, old_path = sys.argv, list(sys.path)
    sys.argv = [name, *argv]
    sys.path.insert(0, EXAMPLES)
    try:
        return runpy.run_path(os.path.join(EXAMPLES, name),
                              run_name="__main__")
    finally:
        sys.argv, sys.path = old_argv, old_path
        # the scripts import their siblings by name: a later script must
        # load its own copy
        for mod in ("_common", "ac_baseline"):
            sys.modules.pop(mod, None)


def quick(name, *argv):
    return run_example(name, "--quick", "--device", "cpu", *argv)


def test_sixteen_scripts():
    # the sixteen of the earlier slices and the fleet's three: every script
    # of the JAX package's examples/ has its port
    assert len(SCRIPTS) == 19
    assert {"ac_factory.py", "ac_fleet.py", "ac_closedloop.py"} \
        <= set(SCRIPTS)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_answers_help(name, capsys):
    with pytest.raises(SystemExit) as exc:
        run_example(name, "--help")
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--quick" in out and "--device" in out


def test_poisson_example_runs():
    quick("steady_state_poisson.py")


def test_discovery_example_runs():
    # the comma-list --lr_vars exercises the per-coefficient rate parse
    quick("ac_discovery.py", "--no-sa", "--lr_vars", "2e-5,0.01")


def test_checkpoint_transfer_example_runs():
    quick("transfer_learn.py")


def test_inference_example_restores_and_evaluates(tmp_path):
    quick("ac_inference.py", "--plot", str(tmp_path))
    assert (tmp_path / "ac_inference_weights.png").exists()


def test_kdv_example_runs():
    quick("kdv.py")


def test_ac_dist_sa_example_runs():
    """World 1 with no process group: ``dist=True`` with SA weights split
    alongside their points, and the distributed L-BFGS tail."""
    quick("ac_dist.py", "--sa")


def test_schrodinger_example_runs():
    quick("schrodinger.py")


def test_ac_sa_periodic_net_example_runs():
    quick("ac_sa.py", "--periodic-net")


def test_ac_factory_example_runs():
    """The family trained as one step, two members held to matched-seed
    solo solvers, the artifact batch fleet-served bit for bit the members'
    engines, the residual from the lowered tape."""
    quick("ac_factory.py")


def test_ac_fleet_example_runs():
    """Two tenants exported and fleet-served in a fresh subprocess: zero
    request-time captures, tenant b's rate limit shed, tenant b's residual
    served with no f_model from the tape."""
    quick("ac_fleet.py")


def test_ac_closedloop_example_runs():
    """Drift injected in place trips the monitor; the retrain warm-started
    from the served parameters swaps the healthy members and rolls the
    torn one back bit for bit; zero request-time captures."""
    quick("ac_closedloop.py")
