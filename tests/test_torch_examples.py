"""The port's example scripts (``examples_torch/``) stay runnable.

The eight scripts that ``tests/test_examples.py`` runs for the JAX package
run here in-process with ``--quick --device cpu`` (each asserts what it
demonstrates); every one of the sixteen answers ``--help`` (its imports
resolve and its flags parse).  On the card, ``chip_smoke.py`` phase 20 runs
all sixteen with ``--quick``.
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
    assert len(SCRIPTS) == 16
    assert not {"ac_factory.py", "ac_fleet.py", "ac_closedloop.py"} \
        & set(SCRIPTS)


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
