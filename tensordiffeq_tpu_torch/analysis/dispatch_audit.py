"""What a captured step runs: "no host hop inside a step" as a checked
property, not a PERF.md claim.

The counterpart of the JAX package's ``analysis/jaxpr_audit.py``.  The AST
rules catch host syncs a human *wrote*; this pass runs the registered hot
steps — each the function handed to :class:`~..training.graphs.StepGraph`
(or, for the redraws, the function the fit loop dispatches on its side
stream) — at micro sizes on the CPU under two recording modes at once: a
``torch.overrides.TorchFunctionMode`` (the Python-level calls: ``.item()``,
``.tolist()``, ``.numpy()``, ``.cpu()``, ``torch.tensor`` of host data)
and a ``TorchDispatchMode`` (every ATen operator, the backward's included:
``_local_scalar_dense``, ``nonzero``, copies across devices, and every
storage an operator reads).  Its :class:`AuditReport` lists

* ``syncs`` — host reads of device values (``item``/``__bool__``/
  ``__float__``/``__int__`` through ``_local_scalar_dense``, ``tolist``,
  ``numpy``, and the data-dependent shapes: ``nonzero``, ``masked_select``,
  ``unique``);
* ``transfers`` — copies to another device (``.cpu()``, ``_to_copy`` or
  ``copy_`` across devices) and host data brought into the step
  (``torch.tensor``/``as_tensor``/``from_numpy`` of non-tensors);
* ``unkeyed`` — storages the step reads that existed before the call (so
  they outlive it) but are absent from the step's ``StepGraph.keyed()``:
  a graph replays on the storage it captured, so if the Python side
  rebinds such a buffer the replay reads the stale one, and
  :meth:`~..training.graphs.StepGraph.check`, which compares only the
  keyed storages, cannot notice.  This is the port's form of the JAX
  rule ``donated-buffer-reuse``.

Set aside, and counted apart as ``cpu_only``: the step-count reads of
``torch.optim.Adam`` on the CPU (``torch.optim.optimizer._get_value``).
:func:`~..training.fit.adam` makes the optimizer ``capturable`` on a CUDA
device, where the counts live on the card and the captured step reads
none; the CPU's non-capturable flavor reads each on the host.  The card's
own count of a chunk's syncs (:func:`chunk_syncs`) holds the captured step
to zero.

Blind spot: the Python-level calls inside an autograd Function's
``backward`` (which the engine runs with the function mode popped) are
seen only as the operators they dispatch; the AST rule
``host-sync-in-hot-path`` covers those bodies.

On the card, :func:`audit_graph` reads what a captured CUDA graph holds
(``CUDAGraph.enable_debug_mode`` + ``debug_dump``): its kernel nodes by
kernel, memcpy nodes by direction and host nodes; :func:`chunk_syncs` and
:func:`lbfgs_syncs` count a chunk's synchronising calls under
``torch.cuda.set_sync_debug_mode``.

torch is imported inside the functions: importing this module (or the
rest of :mod:`tensordiffeq_tpu_torch.analysis`) stays stdlib-only.
"""

from __future__ import annotations

import collections
import os
import re
import sys
import tempfile
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

#: Python-level scalar reads: each dispatches ``_local_scalar_dense``
SCALAR_READS = {"item", "__bool__", "__float__", "__int__", "__index__"}
#: Python-level host reads that dispatch nothing on the CPU
HOST_READS = {"tolist", "numpy"}
#: operators whose output shape depends on the data: a host read
DYNAMIC_SHAPE_OPS = {"nonzero", "masked_select", "_unique2", "unique_dim",
                     "unique_consecutive"}
#: factory functions that bring host data into a step
HOST_DATA = {"tensor", "as_tensor", "from_numpy"}
#: the eager runs before a capture (training/graphs.py::WARMUP_RUNS)
WARMUP_RUNS = 3


@dataclass
class AuditReport:
    """One hot step's verdict."""
    name: str
    syncs: list = field(default_factory=list)
    transfers: list = field(default_factory=list)
    unkeyed: list = field(default_factory=list)
    ops: int = 0            # operators dispatched in the recorded call
    keyed: Optional[int] = None  # keyed storages; None: no graph holds it
    cpu_only: int = 0       # the CPU Adam's step-count reads (set aside)

    @property
    def ok(self) -> bool:
        return not (self.syncs or self.transfers or self.unkeyed)

    def summary(self) -> str:
        held = "not captured" if self.keyed is None \
            else f"{self.keyed} keyed storages"
        if self.cpu_only:
            held += (f"; {self.cpu_only} step-count reads of the CPU's "
                     "non-capturable Adam set aside")
        if self.ok:
            return (f"{self.ops} ops, 0 syncs, 0 transfers, 0 unkeyed "
                    f"reads; {held}")
        parts = []
        if self.syncs:
            parts.append(f"syncs: {_tally(self.syncs)}")
        if self.transfers:
            parts.append(f"transfers: {_tally(self.transfers)}")
        if self.unkeyed:
            parts.append(f"unkeyed: {self.unkeyed}")
        return "; ".join(parts)


def _tally(items) -> dict:
    return dict(collections.Counter(items))


def _storage(t):
    """``(data_ptr, nbytes)`` of a tensor's storage; ``(None, 0)`` for a
    tensor with none (a functorch wrapper under ``vmap``/``jvp``, whose
    operators reach the mode again on the tensors it wraps)."""
    try:
        st = t.untyped_storage()
        return st.data_ptr(), st.nbytes()
    except (RuntimeError, NotImplementedError):
        return None, 0


def _cpu_adam_read() -> bool:
    """Is the scalar read in progress the CPU Adam's step-count read
    (``torch.optim.optimizer._get_value``)?"""
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_code
        if code.co_name == "_get_value" and code.co_filename.replace(
                os.sep, "/").endswith("torch/optim/optimizer.py"):
            return True
        frame = frame.f_back
    return False


def record(fn: Callable, report: AuditReport):
    """Run ``fn()`` once under the two recording modes, adding what it does
    to ``report``; returns the set of storages it read that existed before
    the call, ``{data_ptr: description}``."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    external: dict = {}
    fresh: set = set()
    scalar = [None]  # the Python-level scalar read in progress

    def tensors(tree):
        return [a for a in tree_flatten(tree)[0]
                if isinstance(a, torch.Tensor)]

    class Functions(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            if name in SCALAR_READS:
                prev, scalar[0] = scalar[0], name
                try:
                    return func(*args, **kwargs)
                finally:
                    scalar[0] = prev
            if name in HOST_READS:
                report.syncs.append(name)
            elif name == "cpu":
                report.transfers.append(".cpu()")
            elif name in HOST_DATA and func is getattr(torch, name) \
                    and args and not isinstance(args[0], torch.Tensor):
                report.transfers.append(f"torch.{name}(host data)")
            return func(*args, **kwargs)

    class Operators(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            report.ops += 1
            name = func.overloadpacket.__name__
            ins = tensors((args, kwargs))
            if name == "_local_scalar_dense":
                if ins[0].device.type == "cpu" and _cpu_adam_read():
                    report.cpu_only += 1
                else:
                    report.syncs.append(scalar[0] or "item")
            elif name in DYNAMIC_SHAPE_OPS:
                report.syncs.append(name)
            elif name == "_to_copy" and kwargs.get("device") is not None \
                    and torch.device(kwargs["device"]) != ins[0].device:
                report.transfers.append(
                    f"{ins[0].device.type}->"
                    f"{torch.device(kwargs['device']).type}")
            elif name == "copy_" and len(ins) > 1 \
                    and ins[0].device != ins[1].device:
                report.transfers.append(
                    f"{ins[1].device.type}->{ins[0].device.type}")
            if name not in ("lift_fresh", "lift_fresh_copy"):
                for t in ins:
                    ptr, nbytes = _storage(t)
                    if nbytes and ptr not in fresh and ptr not in external:
                        external[ptr] = (f"{name} reads {list(t.shape)} "
                                         f"{str(t.dtype).replace('torch.', '')}")
            out = func(*args, **kwargs)
            for t in tensors(out):
                ptr, _ = _storage(t)
                if ptr is not None and ptr not in external:
                    fresh.add(ptr)
            return out

    with Functions(), Operators():
        fn()
    return external


@dataclass
class HotStep:
    """A registered hot step: ``fn`` (the function handed to StepGraph, or
    the redraw the fit loop dispatches), ``keyed`` (StepGraph's; ``None``
    where no graph holds the step) and ``reset`` (run before each call,
    outside the recording: what the caller does between calls, such as
    rewinding the history row)."""
    fn: Callable
    keyed: Optional[Callable] = None
    reset: Optional[Callable] = None
    hold: tuple = ()  # objects kept alive while the step is audited


def closure_storages(fn: Callable) -> set:
    """The storages of the tensors held in the closure cells of the
    functions ``fn`` reaches: its own, and those of the functions its
    bound object, its cells and the port's objects they hold carry, each
    cell followed into the tuples, lists and dicts it holds.  Only the
    function that owns a cell can rebind it (``nonlocal``), never the
    caller, so a replay reads the storage its capture read: such a read
    needs no key (the BC meshes and targets, observations and constants a
    loss closes over).  A tensor held as an object's attribute is not
    counted: the Python side can rebind it."""
    import functools
    import types
    import weakref

    import torch

    out: set = set()
    seen: set = set()
    todo = [(fn, False)]
    while todo:
        obj, held = todo.pop()
        if isinstance(obj, weakref.ref):
            obj, held = obj(), False
        if obj is None or (id(obj), held) in seen:
            continue
        seen.add((id(obj), held))
        if isinstance(obj, torch.Tensor):
            if held:
                out.add(_storage(obj)[0])
        elif isinstance(obj, (list, tuple, set, frozenset)):
            todo += [(o, held) for o in obj]
        elif isinstance(obj, dict):
            todo += [(o, held) for o in obj.values()]
        elif isinstance(obj, types.FunctionType):
            for cell in obj.__closure__ or ():
                try:
                    todo.append((cell.cell_contents, True))
                except ValueError:  # a cell not yet bound
                    pass
            todo += [(o, False) for o in vars(obj).values()]
        elif isinstance(obj, types.MethodType):
            todo += [(obj.__func__, False), (obj.__self__, False)]
        elif isinstance(obj, functools.partial):
            todo += [(obj.func, False), (obj.args, True),
                     (obj.keywords, True)]
        elif type(obj).__module__.startswith(__package__.split(".")[0]) \
                and hasattr(obj, "__dict__"):
            todo += [(o, False) for o in vars(obj).values()]
    out.discard(None)
    return out


def audit_step(name: str, step: HotStep) -> AuditReport:
    """The step's warm-up calls (eager, as StepGraph's), then one recorded
    call, judged against ``keyed()`` read after it (as StepGraph keys a
    graph after its capture) and the storages its closures hold
    (:func:`closure_storages`)."""
    for _ in range(WARMUP_RUNS):
        if step.reset is not None:
            step.reset()
        step.fn()
    if step.reset is not None:
        step.reset()
    report = AuditReport(name)
    external = record(step.fn, report)
    if step.keyed is not None:
        keyed = {_storage(t)[0] for t in step.keyed()}
        report.keyed = len(keyed)
        fixed = closure_storages(step.fn)
        report.unkeyed = sorted(desc for ptr, desc in external.items()
                                if ptr not in keyed and ptr not in fixed)
    return report


# --------------------------------------------------------------------- #
# the hot-step registry (micro sizes, on the CPU)
# --------------------------------------------------------------------- #

N_F = 64
WIDTHS = [8, 8]
BUCKET = 32


def _domain(n_f: int = N_F):
    import tensordiffeq_tpu_torch as tdqt
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 16)
    domain.add("t", [0.0, 1.0], 5)
    domain.generate_collocation_points(n_f, seed=0)
    return domain


def _ac_residual(u, x, t, eps=0.0001):
    """Allen-Cahn: the slice's residual."""
    from ..ops.derivatives import grad
    uv = u(x, t)
    return (grad(u, "t")(x, t) - eps * grad(grad(u, "x"), "x")(x, t)
            + 5.0 * uv ** 3 - 5.0 * uv)


def _pair_residual(u, x, t):
    """A Schrödinger-type coupled pair: E = 2."""
    from ..ops.derivatives import grad
    f_u = grad(u[0], "t")(x, t) + 0.5 * grad(grad(u[1], "x"), "x")(x, t)
    f_v = grad(u[1], "t")(x, t) - 0.5 * grad(grad(u[0], "x"), "x")(x, t)
    return f_u, f_v


def _sa_kw(n_eq: int, n_f: int = N_F) -> dict:
    import numpy as np
    rng = np.random.RandomState(0)
    return dict(Adaptive_type=1,
                dict_adaptive={"residual": [True] * n_eq, "BCs": [False]},
                init_weights={"residual": [rng.rand(n_f, 1)
                                           for _ in range(n_eq)],
                              "BCs": [None]})


def _solver(system: bool = False):
    """A micro SA solver on the fused minimax step (its plain flavor on
    the CPU), one Adam step taken."""
    import numpy as np

    import tensordiffeq_tpu_torch as tdqt
    domain = _domain()
    n_eq = 2 if system else 1
    ic = [lambda x: x ** 2 * np.cos(np.pi * x)] * n_eq
    bcs = [tdqt.IC(domain, ic, var=[["x"]] * n_eq)]
    s = tdqt.CollocationSolverND(verbose=False, device="cpu")
    s.compile([2, *WIDTHS, n_eq], _pair_residual if system else _ac_residual,
              domain, bcs, minimax=True, **_sa_kw(n_eq))
    s.fit(tf_iter=1, chunk=1)
    return s


def _adam_step(step, owner) -> HotStep:
    """An :class:`~..training.fit.AdamStep` (or its member-axis family
    step) as fit_adam runs it: the history row rewound between calls."""
    return HotStep(step.graph.fn, step.graph.keyed,
                   reset=lambda: step.row.zero_(), hold=(owner, step))


def _minimax_step(system: bool):
    def build():
        s = _solver(system)
        return _adam_step(s._adam, s)
    return build


def _resampler(kind: str):
    def build():
        from ..ops import resampling as rs
        s = _solver()
        xl = s.domain.xlimits
        if kind == "pool":
            r = rs.DeviceResampler(s._residual, xl, N_F, pool_factor=2,
                                   seed=0)
        else:
            r = rs.AscentResampler(s._residual, xl, N_F, n_steps=2,
                                   fresh_frac=0.25, seed=0,
                                   score_grad_fn=s._minimax_score_grad_fn())
        return HotStep(lambda: r.redraw(s._adam.params, s.X_f, 1),
                       hold=(s, r))
    return build


def _rung(engine, kind: str) -> HotStep:
    import numpy as np
    X = np.random.RandomState(0).rand(BUCKET, 2).astype(np.float32)
    engine.op_for(kind)(X)
    rung = engine._rungs[(engine.kind_key(kind), BUCKET)]
    return HotStep(rung.graph.fn, rung.graph.keyed, hold=(engine, rung))


def _serving(kind: str):
    def build():
        sur = _solver().export_surrogate()
        return _rung(sur.engine(min_bucket=BUCKET, max_bucket=BUCKET), kind)
    return build


def _tape_residual():
    """The fleet rung served from the artifact's lowered tape: a surrogate
    with no f_model, the residual from K1's table and the tape."""
    from ..fleet.warmstart import _lower, _tape_program
    from ..serving import Surrogate
    sur = _solver().export_surrogate()
    bare = Surrogate(sur.net, sur.params, sur.varnames, sur.n_out)
    eng = bare.engine(min_bucket=BUCKET, max_bucket=BUCKET)
    eng.install_program("residual", BUCKET, _tape_program(bare, _lower(sur)))
    return _rung(eng, "residual")


def _factory_step():
    import tensordiffeq_tpu_torch as tdqt
    from ..factory import SurrogateFactory

    def f(u, x, t, th):
        return _ac_residual(u, x, t, eps=th)

    domain = _domain()
    bcs = [tdqt.IC(domain, [lambda x: x ** 2], var=[["x"]])]
    fac = SurrogateFactory([2, *WIDTHS, 1], f, domain, bcs,
                           thetas=[0.01, 0.05], minimax=True, verbose=False,
                           device="cpu", **_sa_kw(1))
    fac.fit(tf_iter=1, chunk=1)
    return _adam_step(fac._step, fac)


def _lbfgs(fixed: bool):
    def build():
        import torch

        from ..training import lbfgs as lb
        s = _solver()
        params = s.net.params()
        fun = lb.lbfgs_objective(s.loss_fn, s.lambdas, s.X_f,
                                 lb.layer_shapes(params))
        x = lb.flatten_layers(params)
        ev = lb._Evaluator(fun, x)
        if not fixed:
            ev.aim(x, torch.full_like(x, 1e-3))
            return HotStep(ev.graph.fn, ev.graph.keyed,
                           reset=lambda: ev.s.fill_(0.5), hold=(s, ev, fun))
        ev.aim(x)
        memory = lb._Memory(x, 5)
        it = lb._FixedStep(ev, memory, lb._Best(x), 0.8, rows=1)
        return HotStep(it.graph.fn, it.graph.keyed,
                       reset=lambda: it.row.zero_(), hold=(s, it, fun))
    return build


def _discovery_step():
    import numpy as np

    import tensordiffeq_tpu_torch as tdqt

    def f(u, var, x, t):
        return _ac_residual(u, x, t) + 0.0 * var[0] + 0.0 * var[1]

    rng = np.random.RandomState(0)
    X = (rng.rand(N_F, 2) * [2.0, 1.0] - [1.0, 0.0]).astype(np.float32)
    u = np.sin(np.pi * X[:, :1]).astype(np.float32)
    m = tdqt.DiscoveryModel(device="cpu")
    m.compile([2, *WIDTHS, 1], f, [X[:, :1], X[:, 1:]], u, var=[0.0, 0.0],
              col_weights=rng.rand(N_F, 1), varnames=["x", "t"],
              verbose=False)
    m.fit(tf_iter=1, chunk=1)
    step = m._step_obj
    return HotStep(step.graph.fn, step.graph.keyed,
                   reset=lambda: step.row.zero_(), hold=(m, step))


#: name -> builder of a :class:`HotStep` (the JAX audit's seven names,
#: then the port's own graphs)
HOT_PROGRAMS = {
    "fused-minimax-step": _minimax_step(False),
    "fused-minimax-system-step": _minimax_step(True),
    "device-resampler": _resampler("pool"),
    "ascent-resampler": _resampler("ascent"),
    "serving-u": _serving("u"),
    "serving-residual": _serving("residual"),
    "vmapped-factory-step": _factory_step,
    "lbfgs-evaluator": _lbfgs(False),
    "lbfgs-fixed-step": _lbfgs(True),
    "discovery-step": _discovery_step,
    "tape-residual": _tape_residual,
}


def audit(name: str) -> AuditReport:
    """Build one registered hot step at micro size on the CPU and audit
    it (module docstring)."""
    return audit_step(name, HOT_PROGRAMS[name]())


def audit_all():
    return [audit(name) for name in HOT_PROGRAMS]


# --------------------------------------------------------------------- #
# on the card: what a captured graph holds, and a chunk's syncs
# --------------------------------------------------------------------- #

#: a kernel wrapper's main kernel, by the wrapper's counter key
KERNEL_NODES = {"k1": re.compile(r"taylor_fwd(?:_wg)?_kernel"),
                "k2": re.compile(r"taylor_bwd(?:_wg)?_kernel"),
                "k3": re.compile(r"minimax_(?:step|wg)_kernel")}
#: the counter keys of the wrappers that launch each main kernel: K3 over
#: a member axis (``k3f``) launches K3's wgmma kernel once per launch
NODE_KEYS = {"k1": ("k1",), "k2": ("k2",), "k3": ("k3", "k3f")}
_LABEL = re.compile(r'label="(.*)"', re.S)


class GraphAuditError(RuntimeError):
    """The card audit could not read the graph (no debug mode, or no
    dump): it never passes for want of evidence."""

    trace_id = None


@dataclass
class GraphReport:
    """What one captured CUDA graph holds."""
    name: str
    nodes: int = 0
    kinds: dict = field(default_factory=dict)    # node type -> count
    kernels: dict = field(default_factory=dict)  # kernel name -> count
    memcpy: dict = field(default_factory=dict)   # direction -> count
    host: int = 0
    launches: dict = field(default_factory=dict)  # counter key -> per replay
    captured: dict = field(default_factory=dict)  # the same, the twin's

    def kernel_nodes(self, key: str) -> int:
        """The nodes of the main kernel of the wrapper counted as ``key``."""
        pat = KERNEL_NODES[key]
        return sum(n for k, n in self.kernels.items() if pat.search(k))

    def node_launches(self, key: str) -> int:
        """The launches per replay of the wrappers that launch ``key``'s
        main kernel (:data:`NODE_KEYS`)."""
        return sum(self.launches.get(k, 0) for k in NODE_KEYS[key])

    @property
    def ok(self) -> bool:
        """No copy across the host boundary, no host node, the twin's
        launches those of the graph that replays, and each main kernel's
        nodes equal to its wrappers' launches per replay."""
        return (not any(d != "DtoD" for d in self.memcpy) and not self.host
                and self.captured == self.launches
                and all(self.kernel_nodes(k) == self.node_launches(k)
                        for k in KERNEL_NODES))

    def by_name(self) -> dict:
        """Kernel nodes by the kernel's short name (:func:`short_name`)."""
        out = collections.Counter()
        for k, n in self.kernels.items():
            out[short_name(k)] += n
        return dict(out)

    def line(self) -> str:
        """Nodes, the wrappers' kernels by name, the rest by count, memcpy
        nodes by direction, host nodes and the launches per replay."""
        names = self.by_name()
        ours = {k: n for k, n in names.items() if k in PORT_KERNELS}
        rest = sum(n for k, n in names.items() if k not in PORT_KERNELS)
        return (f"{self.nodes} nodes {self.kinds}; kernels {ours} + "
                f"{rest} library/ATen in {len(names) - len(ours)} kinds; "
                f"memcpy {self.memcpy}; host {self.host}; launches "
                f"{self.launches}")


#: the port's own kernels (csrc/), by name
PORT_KERNELS = {"minimax_step_kernel", "taylor_fwd_kernel",
                "taylor_fwd_wg_kernel", "taylor_bwd_kernel",
                "reduce_partials", "round_weights", "prep_wg_weights",
                "taylor_bwd_wg_kernel", "minimax_wg_kernel",
                "prep_wb_weights"}


def short_name(mangled: str) -> str:
    """The innermost name of an Itanium-mangled kernel symbol
    (``_ZN2at6native29vectorized_elementwise_kernel...`` ->
    ``vectorized_elementwise_kernel``); the text itself when it is not
    mangled."""
    m = re.match(r"_Z(N?)", mangled)
    if m is None:
        return mangled
    i, last = m.end(), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        last, i = mangled[j:j + n], j + n
    return last


def parse_dot(text: str, name: str = "graph") -> GraphReport:
    """Read ``cudaGraphDebugDotPrint``'s verbose DOT: each node's type (the
    label's first word: KERNEL, MEMCPY, MEMSET, HOST, ...), a kernel node's
    function, a memcpy node's direction."""
    report = GraphReport(name)
    kinds = collections.Counter()
    for block in re.findall(r'\[([^\[\]]*label="[^"]*"[^\[\]]*)\]', text,
                            re.S):
        m = _LABEL.search(block)
        if m is None:
            continue
        label = m.group(1).replace("\\n", "\n").replace("\\l", "\n")
        words = re.findall(r"[A-Z][A-Z_]{2,}", label)
        if not words:
            continue
        kind = words[0]
        kinds[kind] += 1
        if kind == "KERNEL":
            report.kernels[_kernel_name(label)] = \
                report.kernels.get(_kernel_name(label), 0) + 1
        elif kind.startswith("MEMCPY"):
            d = _direction(label)
            report.memcpy[d] = report.memcpy.get(d, 0) + 1
        elif kind == "HOST":
            report.host += 1
    report.kinds = dict(kinds)
    report.nodes = sum(kinds.values())
    return report


def _kernel_name(label: str) -> str:
    """A kernel node's function: the third field of its ``{ID | n (topoId:
    m) | <function>\\<\\<\\<grid,block,smem\\>\\>\\>}`` row."""
    m = re.search(r"\{ID\s*\|[^|]*\|\s*([^|}]+)", label)
    if m is None:
        return "?"
    return re.split(r"\\?<\\?<\\?<", m.group(1))[0].strip()


def _direction(label: str) -> str:
    """A memcpy node's direction, its label's ``kind`` field: ``HtoD``,
    ``DtoH``, ``DtoD`` or ``HtoH`` (``{kind | DtoH (DEVICE to HOST
    PINNED)}``); ``unknown`` when the field is missing."""
    m = re.search(r"kind\s*\|\s*(\w+)", label)
    return m.group(1) if m else "unknown"


def audit_graph(step_graph) -> GraphReport:
    """Capture ``step_graph``'s step once more, as a debug-mode twin built
    through StepGraph's ``make_graph`` hook, dump it and read it
    (:func:`parse_dot`).  The twin takes no warm-up (the step's own graph
    was warmed up and captured) and is never replayed.  A capture runs
    nothing on the card, but the step's Python runs: outputs it rebinds
    (a serving rung's ``out``, an L-BFGS evaluator's ``value``) now lie in
    the twin's pool, freed on return, so the audited graph is dropped and
    the step's next call warms it up and captures it anew, as after a
    keyed tensor's rebinding (:meth:`StepGraph.check`).  ``launches`` is
    the audited graph's ``StepGraph.launches``, what its replays count;
    ``captured`` the twin's, which must be the same.  Raises
    :class:`GraphAuditError` where the step holds no graph, or debug mode
    or the dump is missing."""
    import torch

    from ..training import graphs

    if not step_graph.cuda:
        raise GraphAuditError("the graph audit reads a CUDA graph: "
                              f"{step_graph.name} is on {step_graph.device}")
    if step_graph.graph is None:
        raise GraphAuditError(f"{step_graph.name} holds no captured graph")
    if not hasattr(torch.cuda.CUDAGraph, "enable_debug_mode") \
            or not hasattr(torch.cuda.CUDAGraph, "debug_dump"):
        raise GraphAuditError("this torch has no CUDAGraph debug mode")

    class DebugGraph(graphs.CudaGraph):
        """The step's graph, kept after its capture and in debug mode, so
        ``debug_dump`` can print it."""

        def __init__(self, stream, pool=None):
            super().__init__(stream, pool)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            self.graph.enable_debug_mode()

    twin = graphs.StepGraph(step_graph.fn, step_graph.keyed,
                            step_graph.device, step_graph.name + " (audit)",
                            make_graph=DebugGraph)
    twin.warm = graphs.WARMUP_RUNS
    twin._capture()
    graphs.captures.pop()  # the audit's own capture is not the program's
    step_graph.graph, step_graph.held, step_graph.warm = None, (), 0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        twin.graph.graph.debug_dump(path)
        if not os.path.exists(path) or not os.path.getsize(path):
            raise GraphAuditError(f"debug_dump wrote nothing for "
                                  f"{step_graph.name}")
        with open(path) as fh:
            text = fh.read()
    report = parse_dot(text, step_graph.name)
    if not report.nodes:
        raise GraphAuditError(f"no graph node read from the dump of "
                              f"{step_graph.name}")
    keys = {c: k for k, c in _counters().items()}
    report.launches = {keys[c]: n for c, n in step_graph.launches
                       if c in keys}
    report.captured = {keys[c]: n for c, n in twin.launches if c in keys}
    return report


def _counters() -> dict:
    """The f32 kernel wrappers by counter key."""
    from ..ops import cuda_minimax as cm
    from ..ops import cuda_taylor as ct
    return {"k1": ct.k1_forward, "k2": ct.k2_backward, "k3": cm.k3_minimax,
            "k3f": cm.k3_minimax_family}


#: what PyTorch's sync debug mode says at each synchronising call
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(fn: Callable) -> int:
    """``fn()``'s synchronising calls, as ``torch.cuda.set_sync_debug_mode
    ("warn")`` reports them."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def chunk_syncs(step, n: int = 50) -> int:
    """The syncs of one chunk of ``n`` steps of a warmed-up, captured
    :class:`~..training.fit.AdamStep`, as ``fit_adam`` runs it: ``n``
    replays, then the chunk's history read.  Declared: 1 (the read)."""
    step.begin(n)
    step.row.zero_()
    step.graph.check()

    def chunk():
        for _ in range(n):
            step.graph()
        step.read(n)

    return count_syncs(chunk)


def lbfgs_syncs(solver, iters: int = 10) -> tuple:
    """``(syncs, declared)`` of ``iters`` line-search L-BFGS iterations of
    ``solver`` in one chunk: the syncs counted, and the host reads the
    loop declares (``lbfgs_minimize.host_syncs``)."""
    import torch

    from ..training import lbfgs as lb
    params = solver.net.params()
    fun = lb.lbfgs_objective(solver.loss_fn, solver.lambdas, solver.X_f,
                             lb.layer_shapes(params))
    x0 = lb.flatten_layers(params)
    with lb.matmul_precision(solver.precision):
        lb.lbfgs_minimize(fun, x0, maxiter=2, chunk=2)  # the captures
        torch.cuda.synchronize()
        before = lb.lbfgs_minimize.host_syncs
        n = count_syncs(lambda: lb.lbfgs_minimize(fun, x0, maxiter=iters,
                                                  chunk=iters))
    return n, lb.lbfgs_minimize.host_syncs - before
