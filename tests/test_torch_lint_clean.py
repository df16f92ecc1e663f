"""The port's lint gate: ``tensordiffeq_tpu_torch`` and ``chip_smoke.py``
lint clean, every allow carries a reason and is used, and the dispatch
audit finds no host hop and no unkeyed read in any registered hot step;
planted faults are flagged; the CLI's exit codes.

The whole-tree analysis and the audit run once per module (fixtures) and
the tests read them; the CLI is driven in process (``main(argv)``), with
no subprocess, so the module stays within a few seconds past the import
of torch.
"""

import textwrap
import types

import pytest
import torch

from tensordiffeq_tpu_torch.analysis import dispatch_audit as da
from tensordiffeq_tpu_torch.analysis import run_analysis
from tensordiffeq_tpu_torch.analysis.__main__ import main
from tensordiffeq_tpu_torch.analysis.rules import RULES_BY_ID

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def full_run():
    return run_analysis()


@pytest.fixture(scope="module")
def audits():
    return {r.name: r for r in da.audit_all()}


def test_port_lints_clean_with_all_rules(full_run):
    findings, modules = full_run
    assert {m.rel for m in modules} >= {
        "chip_smoke.py", "tensordiffeq_tpu_torch/training/fit.py",
        "tensordiffeq_tpu_torch/analysis/rules.py"}
    assert not findings, "\n".join(f.format() for f in findings)


def test_every_allow_carries_a_reason_and_is_used(full_run):
    _, modules = full_run
    sups = [(m.rel, s) for m in modules for s in m.suppressions]
    assert sups, "the port's reasoned allows must be visible"
    assert all(s.reason for _, s in sups)
    assert all(s.used for _, s in sups)
    assert all(s.rule in RULES_BY_ID for _, s in sups)


def test_the_registry_holds_the_jax_audits_programs_and_the_ports():
    assert list(da.HOT_PROGRAMS) == [
        "fused-minimax-step", "fused-minimax-system-step",
        "device-resampler", "ascent-resampler", "serving-u",
        "serving-residual", "vmapped-factory-step", "lbfgs-evaluator",
        "lbfgs-fixed-step", "discovery-step", "tape-residual"]


@pytest.mark.parametrize("name", list(da.HOT_PROGRAMS))
def test_hot_step_has_no_host_hop_and_no_unkeyed_read(audits, name):
    report = audits[name]
    assert report.ok, f"{name}: {report.summary()}"
    assert report.ops > 0
    # the steps StepGraph holds are keyed; the redraws run on a side
    # stream, outside any graph
    assert (report.keyed is None) == name.endswith("resampler")


# --------------------------------------------------------------------- #
# planted faults
# --------------------------------------------------------------------- #

def _buffers():
    x = torch.linspace(0.0, 1.0, 8)
    return x, torch.zeros(8), torch.zeros(())


def test_planted_item_in_a_step_is_flagged():
    x, out, _ = _buffers()

    def step():
        out.copy_(x * float(x.sum().item()))

    rep = da.audit_step("planted item", da.HotStep(step, lambda: [x, out]))
    assert rep.syncs == ["item"]
    assert not rep.ok and not rep.unkeyed


def test_planted_cpu_in_a_helper_the_ast_cannot_see(tmp_path):
    """The AST rule reads the step's own body only; the audit runs the
    helper."""
    from tensordiffeq_tpu_torch.analysis.engine import run_rules
    from tensordiffeq_tpu_torch.analysis.rules import HostSyncRule
    src = textwrap.dedent("""
        from .training.graphs import StepGraph

        def helper(t):
            return t.cpu() * 2.0

        class Step:
            def __init__(self, x, out):
                self.x, self.out = x, out
                self.graph = StepGraph(self._step, self._keyed, "cpu", "s")

            def _keyed(self):
                return [self.x, self.out]

            def _step(self):
                self.out.copy_(helper(self.x))
    """)
    p = tmp_path / "tensordiffeq_tpu_torch" / "planted.py"
    p.parent.mkdir()
    p.write_text(src)
    findings, _ = run_rules([HostSyncRule()], repo_root=str(tmp_path),
                            files=[str(p)])
    assert findings == []  # the AST cannot see it
    x, out, _ = _buffers()

    def helper(t):
        return t.cpu() * 2.0

    def step():
        out.copy_(helper(x))

    rep = da.audit_step("planted cpu", da.HotStep(step, lambda: [x, out]))
    assert rep.transfers == [".cpu()"] and not rep.ok


def test_planted_read_missing_from_keyed_is_flagged():
    """A buffer the Python side can rebind (an object's attribute), read by
    the step and missing from ``keyed()``, is flagged; one the step's
    closure holds cannot be rebound by the caller and needs no key."""
    x, out, scale = _buffers()
    held = types.SimpleNamespace(scale=scale)

    def step():
        out.copy_(x * held.scale)

    keyed = da.audit_step("keyed", da.HotStep(step,
                                              lambda: [x, out, held.scale]))
    assert keyed.ok and keyed.keyed == 3
    rep = da.audit_step("unkeyed", da.HotStep(step, lambda: [x, out]))
    assert rep.unkeyed == ["mul reads [] float32"] and not rep.ok

    def closed():
        out.copy_(x * scale)

    assert da.audit_step("closure", da.HotStep(closed, lambda: [x, out])).ok


def test_planted_host_data_and_nonzero_are_flagged():
    x, out, _ = _buffers()

    def step():
        out.copy_(x + torch.tensor(1.0))
        out[torch.nonzero(x > 0.5)] = 0.0

    rep = da.audit_step("planted", da.HotStep(step, lambda: [x, out]))
    assert "torch.tensor(host data)" in rep.transfers
    assert "nonzero" in rep.syncs


def test_the_cpu_adams_step_count_reads_are_set_aside_not_hidden():
    """torch's non-capturable Adam (the CPU's) reads its step count on the
    host; the audit counts those reads apart (the card's Adam is
    capturable) and still flags any other read in the same step."""
    p = torch.nn.Parameter(torch.ones(4))
    opt = torch.optim.Adam([p], lr=0.1)

    def step():
        opt.zero_grad(set_to_none=True)
        (p * p).sum().backward()
        opt.step()

    rep = da.audit_step("adam", da.HotStep(step, lambda: [p] + [
        v for st in opt.state.values() for v in st.values()]))
    assert rep.ok and rep.cpu_only == 1

    def leaky():
        step()
        p.sum().item()

    rep = da.audit_step("adam+item", da.HotStep(leaky, None))
    assert rep.syncs == ["item"] and rep.cpu_only == 1


# --------------------------------------------------------------------- #
# the CLI, in process
# --------------------------------------------------------------------- #

def test_cli_list_rules_names_every_rule_and_the_jax_mapping(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULES_BY_ID:
        assert rid in out
    assert "donated-buffer-reuse" in out and "dispatch audit" in out
    assert "prng-key-reuse" in out and "explicit-generator" in out


def test_cli_exit_codes(tmp_path, capsys, monkeypatch, full_run, audits):
    import tensordiffeq_tpu_torch.analysis.__main__ as cli
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        from tensordiffeq_tpu_torch.training.graphs import StepGraph

        def build(x):
            def step():
                return x.item()
            return StepGraph(step, list, "cpu", "s")
    """))
    assert main([str(bad)]) == 1
    assert "host-sync-in-hot-path" in capsys.readouterr().out
    good = tmp_path / "good.py"
    good.write_text("import torch\nX = torch.zeros(3)\n")
    assert main([str(good)]) == 0
    assert capsys.readouterr().out.strip() == ""
    assert main(["--select", "definitely-not-a-rule"]) == 2
    # the whole tree, clean and silent; with --audit one ok line per step
    # (the module's runs, handed to the CLI)
    monkeypatch.setattr(cli, "run_analysis", lambda **kw: full_run)
    assert main([]) == 0
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(da, "audit_all", lambda: list(audits.values()))
    assert main(["--audit"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(da.HOT_PROGRAMS) == 11
    assert all(line.startswith("dispatch-audit ") and ": ok (" in line
               for line in out)
