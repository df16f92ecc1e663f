"""Lower a residual ``f_model`` to the pointwise op tape the fused minimax
kernel K3 interprets.

The JAX package's Pallas minimax kernel traced the user's Python
``f_model`` into the kernel body (``ops/pallas_minimax.py:202-206``).  A
kernel written by hand and built once cannot, so the ``f_model`` is lowered
once, at compile, to a small program that one generic kernel epilogue runs
for every ``f_model`` (``csrc/minimax_step.cu``), as K1/K2 run a channel
schedule compiled on the host.

Lowering traces the batched ``f_model`` with
``torch.fx.experimental.proxy_tensor.make_fx`` (fake tensors) as a function
of its table columns (``C·n_out`` tensors of ``[N]``, one per channel and
output) and its coordinates (``d`` tensors of ``[N]``), so the graph holds
only pointwise aten ops, never a select or slice of a ``[N, K]`` table.  A
whitelist of ops becomes integer op codes with an f32 constant pool:
``add``, ``sub``, ``rsub``, ``mul``, ``div``, ``neg``, ``pow`` by a scalar,
``reciprocal``, ``sin``, ``cos``, ``exp``, ``tanh``, ``log``, ``sqrt``, and
shape-only ops that keep one value per point.  Anything else raises
:class:`MinimaxLoweringError`: a reduction over the points, indexing across
points, a constant that is not a scalar, control flow on values, or a tape
beyond the kernel's caps (``MAX_TAPE_*`` and ``MAX_EQUATIONS`` in
:mod:`.cuda_taylor`).

The reverse tape is not traced: :meth:`ResidualTape.reverse` applies each
op's adjoint rule, the same rules the kernel's epilogue applies.
:meth:`ResidualTape.forward` and :meth:`ResidualTape.reverse` are the plain
version of that epilogue; the CPU tests run them in float64 against
autograd of the ``f_model``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from .cuda_taylor import (MAX_EQUATIONS, MAX_TAPE_CONSTS, MAX_TAPE_INPUTS,
                          MAX_TAPE_OPS)
from .fused import SymbolicUFn
from .taylor import canonical

# op codes, in the order of csrc/minimax_step.cu's OP_* defines
OPS = ("const", "add", "sub", "mul", "div", "neg", "pow", "sin", "cos",
       "exp", "tanh", "log", "sqrt", "recip")
OP = {name: code for code, name in enumerate(OPS)}
_UNARY = {"sin": torch.sin, "cos": torch.cos, "exp": torch.exp,
          "tanh": torch.tanh, "log": torch.log, "sqrt": torch.sqrt,
          "recip": torch.reciprocal}
_N_TRACE = 7  # points of the fake trace
# float operations per point of each op, forward and in the reverse tape
# (a transcendental counts as one, as the tanh chain's tanh does in
# cuda_taylor.flop_count; pow by 2 or 3 is one or two multiplies)
_FWD_FLOPS = {"const": 0, "sin": 1, "cos": 1, "exp": 1, "tanh": 1, "log": 1,
              "sqrt": 1, "recip": 1, "add": 1, "sub": 1, "mul": 1, "div": 1,
              "neg": 1}
_REV_FLOPS = {"const": 0, "add": 2, "sub": 2, "mul": 4, "div": 5, "neg": 1,
              "pow": 4, "sin": 3, "cos": 3, "exp": 2, "tanh": 4, "log": 2,
              "sqrt": 3, "recip": 3}


class MinimaxLoweringError(ValueError):
    """The ``f_model`` cannot be lowered to the residual tape that the
    fused minimax kernel interprets."""

    trace_id = None


@dataclass(frozen=True)
class ResidualTape:
    """A pointwise program: registers ``0 .. n_in-1`` hold the inputs, op
    ``k`` writes register ``n_in + k``, and ``outputs[e]`` is the register
    of equation ``e``.

    ``src[i]`` names input ``i``: table column ``c·n_out + o`` (channel
    ``c`` in the plan's channel order, output ``o``) when below
    ``n_table = C·n_out``, else coordinate ``src[i] - n_table``.  Each op
    is ``(code, a, b)``: registers ``a, b`` for binary ops, register ``a``
    for unary ones, ``(a, const index)`` for ``pow``, ``(const index, 0)``
    for ``const``."""
    src: tuple
    ops: tuple
    consts: tuple
    outputs: tuple
    n_table: int

    @property
    def n_in(self) -> int:
        return len(self.src)

    @property
    def n_eq(self) -> int:
        return len(self.outputs)

    def encode(self) -> tuple[list, list]:
        """``(ints, floats)`` in the kernel's layout: ``[n_in, n_ops, n_eq,
        src[MAX_TAPE_INPUTS], ops[MAX_TAPE_OPS·3], outputs[MAX_EQUATIONS]]``
        and ``consts[MAX_TAPE_CONSTS]``, zero-padded."""
        ints = [self.n_in, len(self.ops), self.n_eq]
        ints += list(self.src) + [0] * (MAX_TAPE_INPUTS - self.n_in)
        for op in self.ops:
            ints += list(op)
        ints += [0] * (3 * (MAX_TAPE_OPS - len(self.ops)))
        ints += list(self.outputs) + [0] * (MAX_EQUATIONS - self.n_eq)
        floats = list(self.consts) + [0.0] * (MAX_TAPE_CONSTS
                                              - len(self.consts))
        return ints, floats

    def flops(self) -> tuple[int, int]:
        """Float operations per point of the tape ``(forward, reverse)``."""
        fwd = rev = 0
        for code, _, b in self.ops:
            name = OPS[code]
            if name == "pow":
                fwd += {2.0: 1, 3.0: 2}.get(self.consts[b], 1)
            else:
                fwd += _FWD_FLOPS[name]
            rev += _REV_FLOPS[name]
        return fwd, rev

    def forward(self, columns: Sequence, coords: Sequence) -> list:
        """Every register's value: ``columns`` are the ``n_table`` table
        columns (``[N]`` each, in ``src`` numbering), ``coords`` the ``d``
        coordinates.  The equations are ``[regs[r] for r in outputs]``."""
        regs = [columns[s] if s < self.n_table else coords[s - self.n_table]
                for s in self.src]
        for code, a, b in self.ops:
            name = OPS[code]
            if name == "const":
                like = regs[0] if regs else columns[0]
                v = torch.full_like(like, self.consts[a])
            elif name == "add":
                v = regs[a] + regs[b]
            elif name == "sub":
                v = regs[a] - regs[b]
            elif name == "mul":
                v = regs[a] * regs[b]
            elif name == "div":
                v = regs[a] / regs[b]
            elif name == "neg":
                v = -regs[a]
            elif name == "pow":
                v = torch.pow(regs[a], self.consts[b])
            else:
                v = _UNARY[name](regs[a])
            regs.append(v)
        return regs

    def reverse(self, regs: list, seeds: Sequence) -> tuple[dict, dict]:
        """The adjoint sweep: from ``seeds[e]``, the cotangent of equation
        ``e``, to ``({table column: cotangent}, {coordinate: cotangent})``
        for the inputs the tape reads."""
        g = [torch.zeros_like(r) for r in regs]
        for r, s in zip(self.outputs, seeds):
            g[r] = g[r] + s
        for k in range(len(self.ops) - 1, -1, -1):
            code, a, b = self.ops[k]
            name, o = OPS[code], self.n_in + k
            go = g[o]
            if name == "const":
                continue
            if name == "add":
                g[a] = g[a] + go
                g[b] = g[b] + go
            elif name == "sub":
                g[a] = g[a] + go
                g[b] = g[b] - go
            elif name == "mul":
                ra, rb = regs[a], regs[b]
                g[a] = g[a] + go * rb
                g[b] = g[b] + go * ra
            elif name == "div":
                g[a] = g[a] + go / regs[b]
                g[b] = g[b] - go * regs[o] / regs[b]
            elif name == "neg":
                g[a] = g[a] - go
            elif name == "pow":
                c = self.consts[b]
                if c != 0:
                    g[a] = g[a] + go * c * torch.pow(regs[a], c - 1)
            elif name == "sin":
                g[a] = g[a] + go * torch.cos(regs[a])
            elif name == "cos":
                g[a] = g[a] - go * torch.sin(regs[a])
            elif name == "exp":
                g[a] = g[a] + go * regs[o]
            elif name == "tanh":
                g[a] = g[a] + go * (1 - regs[o] * regs[o])
            elif name == "log":
                g[a] = g[a] + go / regs[a]
            elif name == "sqrt":
                g[a] = g[a] + go * 0.5 / regs[o]
            else:  # recip
                g[a] = g[a] - go * regs[o] * regs[o]
        table, coord = {}, {}
        for i, s in enumerate(self.src):
            if s < self.n_table:
                table[s] = g[i]
            else:
                coord[s - self.n_table] = g[i]
        return table, coord


class _ColumnEngine:
    """Serves ``u`` lookups from separate ``[N]`` columns (a plain
    ``[N, K]`` table would put select ops into the trace)."""

    def __init__(self, tokens: tuple, columns: Sequence, pos: dict,
                 n_out: int):
        self.tokens = tokens
        self.columns = columns
        self.pos = pos
        self.n_out = n_out

    def lookup(self, multi_index, component, coords, n_out):
        if len(coords) != len(self.tokens) or any(
                c is not t for c, t in zip(coords, self.tokens)):
            raise MinimaxLoweringError(
                "u was evaluated at transformed or reordered coordinates")
        mi = canonical(multi_index)
        if mi not in self.pos:
            raise MinimaxLoweringError(
                f"u requests derivative {mi}, which the table lacks")
        base = self.pos[mi] * self.n_out
        if component is None and n_out > 1:
            return torch.stack([self.columns[base + o]
                                for o in range(n_out)], 1)
        return self.columns[base + (0 if component is None else component)]


_aten = torch.ops.aten
_BINARY = {
    _aten.add.Tensor: "add", _aten.add.Scalar: "add",
    _aten.sub.Tensor: "sub", _aten.sub.Scalar: "sub",
    _aten.rsub.Tensor: "rsub", _aten.rsub.Scalar: "rsub",
    _aten.mul.Tensor: "mul", _aten.mul.Scalar: "mul",
    _aten.div.Tensor: "div", _aten.div.Scalar: "div",
}
_UNARY_ATEN = {
    _aten.neg.default: "neg", _aten.sin.default: "sin",
    _aten.cos.default: "cos", _aten.exp.default: "exp",
    _aten.tanh.default: "tanh", _aten.log.default: "log",
    _aten.sqrt.default: "sqrt", _aten.reciprocal.default: "recip",
}
# ops that only reshape or copy: one value per point in, the same out
_SAME = {_aten.view.default, _aten._unsafe_view.default,
         _aten.reshape.default, _aten.clone.default, _aten.alias.default,
         _aten.detach.default, _aten.lift_fresh_copy.default,
         _aten.squeeze.default, _aten.squeeze.dim, _aten.squeeze.dims,
         _aten.unsqueeze.default, _aten._to_copy.default}
_POINTWISE_NAMES = ("add, sub, rsub, mul, div, neg, pow by a scalar, "
                    "reciprocal, sin, cos, exp, tanh, log, sqrt")


def _numel(node) -> int:
    val = node.meta.get("val")
    return int(val.numel()) if isinstance(val, torch.Tensor) else -1


class _Lowerer:
    def __init__(self):
        self.src, self.ops, self.consts, self.env = [], [], [], {}
        self._const_reg = {}

    def pooled(self, value) -> int:
        """Index of ``value`` in the constant pool (added once)."""
        v = float(value)
        if v not in self.consts:
            self.consts.append(v)
        return self.consts.index(v)

    def const(self, value) -> int:
        """The register holding constant ``value`` (one per value)."""
        v = float(value)
        if v not in self._const_reg:
            self._const_reg[v] = self.emit("const", self.pooled(v), 0)
        return self._const_reg[v]

    def emit(self, name: str, a: int, b: int) -> int:
        self.ops.append((OP[name], a, b))
        return len(self.src) + len(self.ops) - 1

    def reg(self, x) -> int:
        if isinstance(x, torch.fx.Node):
            return self.env[x]
        if isinstance(x, (bool, int, float)):
            return self.const(x)
        raise MinimaxLoweringError(f"operand {x!r} is not a number or a "
                                   "value per point")

    def node(self, node):
        t, args, kw = node.target, node.args, dict(node.kwargs)
        if t in _SAME:
            if t is _aten._to_copy.default and kw.pop(
                    "dtype", torch.float32) != torch.float32:
                raise MinimaxLoweringError("the residual changes dtype")
            src = args[0]
            if _numel(node) != _numel(src):
                raise MinimaxLoweringError(
                    f"{t} changes the number of values per point")
            self.env[node] = self.env[src]
            return
        if t in _BINARY:
            alpha = kw.pop("alpha", 1)
            if kw:
                raise MinimaxLoweringError(f"{t} with {sorted(kw)}")
            a, b = self.reg(args[0]), self.reg(args[1])
            name = _BINARY[t]
            if name == "rsub":  # rsub(a, b) = b - alpha * a
                name, a, b = "sub", b, a
                if alpha != 1:
                    b = self.emit("mul", b, self.const(alpha))
            elif alpha != 1:
                b = self.emit("mul", b, self.const(alpha))
            self.env[node] = self.emit(name, a, b)
            return
        if t in _UNARY_ATEN and not kw:
            self.env[node] = self.emit(_UNARY_ATEN[t], self.reg(args[0]), 0)
            return
        if t is _aten.pow.Tensor_Scalar and isinstance(args[1], (int, float)):
            self.env[node] = self.emit("pow", self.reg(args[0]),
                                       self.pooled(args[1]))
            return
        per_point = any(isinstance(a, torch.fx.Node)
                        and _numel(a) == _N_TRACE for a in args)
        if per_point and _numel(node) != _N_TRACE:
            raise MinimaxLoweringError(
                f"the residual reduces or indexes across points ({t}); the "
                "fused minimax step evaluates it one point at a time")
        raise MinimaxLoweringError(
            f"the residual uses {t}, which the minimax tape does not lower "
            f"(it takes {_POINTWISE_NAMES})")


def lower_residual(f_model: Callable, varnames: Sequence[str], n_out: int,
                   channels: Sequence[tuple]) -> ResidualTape:
    """Lower the batched ``f_model`` to a :class:`ResidualTape` whose table
    columns follow ``channels`` (the kernel plan's channel order, primal
    first).  Raises :class:`MinimaxLoweringError` when it cannot."""
    from torch.fx.experimental.proxy_tensor import make_fx

    ndim, C = len(varnames), len(channels)
    n_table = C * n_out
    pos = {canonical(mi): c for c, mi in enumerate(channels)}

    def batched(*args):
        columns, coords = args[:n_table], tuple(args[n_table:])
        u = SymbolicUFn(_ColumnEngine(coords, columns, pos, n_out),
                        varnames, n_out)
        out = f_model(u, *coords)
        parts = out if isinstance(out, tuple) else (out,)
        return tuple(torch.reshape(p, (-1,)) for p in parts)

    example = [torch.zeros(_N_TRACE) for _ in range(n_table + ndim)]
    try:
        gm = make_fx(batched, tracing_mode="fake")(*example)
    except MinimaxLoweringError:
        raise
    except Exception as e:  # control flow on values, a non-tensor result
        raise MinimaxLoweringError(
            f"tracing the residual failed ({type(e).__name__}: {e}); the "
            "fused minimax step needs an f_model built from pointwise "
            "tensor ops, without control flow on values") from e
    gm.graph.eliminate_dead_code()

    low = _Lowerer()
    nodes = list(gm.graph.nodes)
    placeholders = [n for n in nodes if n.op == "placeholder"]
    for i, node in enumerate(placeholders):
        if node.users:
            low.env[node] = len(low.src)
            low.src.append(i)
    outputs = []
    for node in nodes:
        if node.op == "get_attr":
            val = getattr(gm, node.target)
            if not isinstance(val, torch.Tensor) or val.numel() != 1:
                raise MinimaxLoweringError(
                    "the residual holds a constant tensor that is not a "
                    "scalar")
            low.env[node] = low.const(float(val.reshape(())))
        elif node.op == "call_function":
            low.node(node)
        elif node.op == "output":
            for res in node.args[0]:
                if _numel(res) != _N_TRACE:
                    raise MinimaxLoweringError(
                        "a residual equation is not one value per point")
                outputs.append(low.reg(res))
        elif node.op != "placeholder":
            raise MinimaxLoweringError(f"unexpected graph node {node.op}")

    for n, cap, what in ((len(low.src), MAX_TAPE_INPUTS, "inputs"),
                         (len(low.ops), MAX_TAPE_OPS, "ops"),
                         (len(low.consts), MAX_TAPE_CONSTS, "constants"),
                         (len(outputs), MAX_EQUATIONS, "equations")):
        if n > cap:
            raise MinimaxLoweringError(
                f"the residual tape needs {n} {what}; the kernel holds at "
                f"most {cap}")
    return ResidualTape(src=tuple(low.src), ops=tuple(low.ops),
                        consts=tuple(low.consts), outputs=tuple(outputs),
                        n_table=n_table)
