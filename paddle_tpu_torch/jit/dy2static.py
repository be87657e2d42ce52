"""AST dygraph-to-static conversion (counterpart of
paddle_tpu/jit/dy2static.py).

The reference stages data-dependent Python control flow two ways: an AST
transformer (python/paddle/jit/dy2static/, e.g. ifelse_transformer.py /
loop_transformer.py rewriting `if`/`while` into cond/while_loop ops) and
a bytecode translator (sot/opcode_translator/executor/opcode_executor.py).
paddle_tpu's rendering, kept here statement for statement, is
source-level: `ast_transform` rewrites

    if <tensor-valued test>: ...      ->  _jst.convert_ifelse(...)
    while <tensor-valued test>: ...   ->  _jst.convert_while(...)

and the convert_* helpers dispatch AT RUNTIME: a concrete predicate (a
python value, or a Tensor over a real torch tensor) keeps exact Python
semantics, and a traced one (a fake tensor of ``make_fx`` or
``torch.export``) becomes torch's ``cond`` / ``while_loop`` higher-order
operators, the counterparts of the reference's ``lax.cond`` /
``lax.while_loop``. The operators are called below torch.cond's own
entry point, which would compile the branches with dynamo (which cannot
trace the port's Tensor and op registry); tensors a branch reads from
the enclosing function's scope are passed to the operator as operands,
so the trace records them as inputs and not as constants.

Conversion contract (the reference's):
  * `if`/`while` bodies containing `return`, or `break`/`continue` bound
    to an enclosing loop, are left as plain Python — under
    full_graph=True tracing they still produce the loud staging error.
  * variables assigned in only ONE branch of a tensor-predicate `if`
    cannot be threaded through `cond` (both branches must yield the
    same carry structure) — detected at runtime with a clear error.
  * non-Tensor loop carries must be loop-invariant under a traced
    `while` (the operator needs a fixed carry structure).
  * a branch reads enclosing tensors through its closure; a tensor held
    only inside a container (a list of tensors) is not lifted.

``graph_break_transform`` (to_static(full_graph=False)) keeps the
reference's split into staged regions and eager statements. The port
compiles nothing: every region runs eagerly through the op registry, and
a probe (a fake-tensor trace, once per input signature) counts it as
staged, or as eager when its helpers branch on tensor values, as the
reference's does.
"""
from __future__ import annotations

import ast
import contextlib
import inspect
import textwrap
from typing import Callable, Optional

import torch
from torch._higher_order_ops.cond import cond_op
from torch._higher_order_ops.while_loop import while_loop_op

from ..core.tensor import Tensor
from ..kernels import tracing

__all__ = ["UNDEF", "pack", "convert_ifelse", "convert_while",
           "ast_transform", "StagedRegion", "graph_break_transform"]


class _Undefined:
    """Placeholder for a name unbound at the convert-point. Mirrors plain
    Python's behavior at USE time: any operation on it raises
    UnboundLocalError (repr stays safe for debugging)."""
    __slots__ = ("name",)

    def __init__(self, name="<var>"):
        object.__setattr__(self, "name", name)

    def __repr__(self):
        return f"<undefined {object.__getattribute__(self, 'name')}>"

    def _raise(self, *a, **k):
        raise UnboundLocalError(
            "dy2static: local variable "
            f"{object.__getattribute__(self, 'name')!r} referenced "
            "before assignment (it was bound in only one conditional "
            "path)")

    __bool__ = __iter__ = __len__ = __call__ = _raise
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _raise
    __truediv__ = __rtruediv__ = __eq__ = __ne__ = __lt__ = __gt__ = _raise
    __le__ = __ge__ = __getitem__ = __array__ = __float__ = __int__ = _raise

    def __getattr__(self, item):
        self._raise()

    def __hash__(self):
        return object.__hash__(self)


UNDEF = _Undefined()


def pack(*getters):
    """Snapshot possibly-unbound locals: each getter is `lambda: name`;
    an unbound name raises NameError and packs as an _Undefined that
    raises UnboundLocalError on use."""
    out = []
    for g in getters:
        try:
            out.append(g())
        except NameError as e:
            name = str(e).split("'")[1] if "'" in str(e) else "<var>"
            out.append(_Undefined(name))
    return tuple(out)


def _pred_value(cond):
    return cond._data if isinstance(cond, Tensor) else cond


def _flatten_vars(vs):
    arrs, statics, spec = [], [], []
    for v in vs:
        if isinstance(v, Tensor):
            spec.append("t")
            arrs.append(v._data)
        elif isinstance(v, torch.Tensor):
            spec.append("a")
            arrs.append(v)
        else:
            spec.append("s")
            statics.append(v)
    return arrs, statics, spec


def _static_differs(a, b):
    """Structure check for non-Tensor carries; must not trip on numpy
    arrays (ambiguous truth value) or _Undefined (raising __eq__)."""
    if a is b:
        return False
    if isinstance(a, _Undefined) and isinstance(b, _Undefined):
        return False
    if isinstance(a, _Undefined) or isinstance(b, _Undefined):
        return True
    import numpy as np
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        try:
            return not np.array_equal(a, b)
        except Exception:
            return True
    try:
        return bool(a != b)
    except Exception:
        return True


def _rebuild(spec, arrs, statics):
    out, ia, istat = [], 0, 0
    for k in spec:
        if k == "t":
            out.append(Tensor._wrap(arrs[ia]))
            ia += 1
        elif k == "a":
            out.append(arrs[ia])
            ia += 1
        else:
            out.append(statics[istat])
            istat += 1
    return tuple(out)


def _free_tensors(*fns):
    """The closure cells of `fns` that hold a traced tensor (a Tensor
    over one, or one itself), and those torch tensors: what the branch
    or loop functions read from the enclosing scope."""
    cells, tensors, seen = [], [], set()
    for fn in fns:
        for cell in fn.__closure__ or ():
            if id(cell) in seen:
                continue
            seen.add(id(cell))
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            t = v._data if isinstance(v, Tensor) else v
            if tracing(t):
                cells.append((cell, v))
                tensors.append(t)
    return cells, tensors


@contextlib.contextmanager
def _rebound(cells, tensors):
    """The cells bound to the operator's own operands while a branch or
    loop function is traced, put back after."""
    for (cell, v), t in zip(cells, tensors):
        cell.cell_contents = Tensor._wrap(t) if isinstance(v, Tensor) else t
    try:
        yield
    finally:
        for cell, v in cells:
            cell.cell_contents = v


def _fresh(outs, ins):
    """The operators take no output that is one of their operands: an
    operand passed through unchanged is copied."""
    ids = {id(x) for x in ins}
    return tuple(o.clone() if id(o) in ids else o for o in outs)


def convert_ifelse(cond, true_fn, false_fn, vars, names=()):
    """Runtime `if` dispatch (ref: dy2static convert_operators
    convert_ifelse). Concrete predicate -> plain Python; traced
    predicate -> torch's cond over the Tensor carries."""
    pred = _pred_value(cond)
    if not tracing(pred):
        return true_fn(*vars) if bool(pred) else false_fn(*vars)
    # UNDEF inputs ride as statics: a variable assigned in BOTH branches
    # never reads its (meaningless) carry-in. One-sided assignment shows
    # up as an output-structure mismatch below.
    arrs, statics, spec = _flatten_vars(vars)
    cells, free = _free_tensors(true_fn, false_fn)
    n = len(arrs)
    recorded = {}

    def _mk(fn, tag):
        def g(*a):
            with _rebound(cells, a[n:]):
                out = fn(*_rebuild(spec, list(a[:n]), statics))
            oarrs, ostat, ospec = _flatten_vars(out)
            recorded[tag] = (ostat, ospec)
            return _fresh(oarrs, a)
        return g

    try:
        outs = cond_op(pred.reshape(()).to(torch.bool), _mk(true_fn, "t"),
                       _mk(false_fn, "f"), tuple(arrs) + tuple(free))
    except Exception as e:
        one_sided = [n for n, (a, b) in zip(
            names, zip(recorded.get("t", ((), ()))[1],
                       recorded.get("f", ((), ()))[1])) if a != b] \
            if recorded.get("t") and recorded.get("f") else list(names)
        raise RuntimeError(
            "to_static: the two branches of a traced `if` produced "
            f"different variable structures (check {one_sided}) — a "
            "variable assigned in only one branch cannot stage through "
            "cond. Initialize it before the `if`. Underlying: "
            f"{e}") from e
    tstat, tspec = recorded["t"]
    fstat, fspec = recorded["f"]
    if tspec != fspec or any(_static_differs(a, b)
                             for a, b in zip(tstat, fstat)):
        raise RuntimeError(
            "to_static: the two branches of a traced `if` produced "
            "different non-Tensor values or structures "
            f"({tspec}/{tstat} vs {fspec}/{fstat}) — only Tensor "
            "carries may differ between branches under cond. A "
            "variable assigned in only one branch must be initialized "
            "before the `if`.")
    return _rebuild(tspec, list(outs), tstat)


def convert_while(cond_fn, body_fn, vars, names=()):
    """Runtime `while` dispatch. Concrete predicate -> Python loop
    (eager); traced -> torch's while_loop with the Tensor carries."""
    c = _pred_value(cond_fn(*vars))
    if not tracing(c):
        while bool(c):
            vars = body_fn(*vars)
            c = _pred_value(cond_fn(*vars))
        return tuple(vars)
    arrs, statics, spec = _flatten_vars(vars)
    cells, free = _free_tensors(cond_fn, body_fn)
    n = len(arrs)

    def cf(*a):
        with _rebound(cells, a[n:]):
            r = _pred_value(cond_fn(*_rebuild(spec, list(a[:n]), statics)))
        return r.reshape(()).to(torch.bool)

    def bf(*a):
        with _rebound(cells, a[n:]):
            out = body_fn(*_rebuild(spec, list(a[:n]), statics))
        oarrs, ostat, ospec = _flatten_vars(out)
        if ospec != spec or any(_static_differs(x, y)
                                for x, y in zip(ostat, statics)):
            raise RuntimeError(
                "to_static: a traced `while` body changed a non-Tensor "
                "loop variable (the loop needs a fixed carry structure). "
                "Initialize loop variables as Tensors before the loop "
                "and keep python values loop-invariant.")
        return _fresh(oarrs, a)

    outs = while_loop_op(cf, bf, tuple(arrs), tuple(free))
    return _rebuild(spec, list(outs), statics)


# ======================= AST transformation =======================

_SKIP_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.Lambda, ast.ListComp, ast.SetComp, ast.DictComp,
                ast.GeneratorExp)


def _assigned_names(body):
    """Names bound by a statement list, not descending into new scopes."""
    names = []

    def walk(node):
        if isinstance(node, _SKIP_SCOPES):
            # the def's NAME binds in this scope
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.append(node.name)
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.append(node.id)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                names.append(bound)
        for child in ast.iter_child_nodes(node):
            walk(child)

    for stmt in body:
        walk(stmt)
    seen, out = set(), []
    for n in names:
        if n not in seen and not n.startswith("__jst_"):
            seen.add(n)
            out.append(n)
    return out


def _escapes_control_flow(body):
    """True if the statements contain a `return`, a `global`/`nonlocal`
    declaration (rewriting the assignment into a branch-function local
    would silently drop the outer binding — ADVICE r2), or a
    `break`/`continue` bound to an ENCLOSING loop (i.e. not inside a
    nested loop here)."""
    found = False

    def walk(node, in_loop):
        nonlocal found
        if found or isinstance(node, _SKIP_SCOPES):
            return
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom,
                             ast.Await, ast.Global, ast.Nonlocal)):
            found = True
            return
        if isinstance(node, (ast.Break, ast.Continue)) and not in_loop:
            found = True
            return
        inner = in_loop or isinstance(node, (ast.For, ast.While,
                                             ast.AsyncFor))
        for child in ast.iter_child_nodes(node):
            walk(child, inner)

    for stmt in body:
        walk(stmt, False)
    return found


def _stmt(src):
    """Parse one statement from template source (version-correct AST
    field defaults come from the parser, not hand-built nodes)."""
    return ast.parse(textwrap.dedent(src)).body[0]


def _fndef(name, params, body, tail_return=None):
    f = _stmt(f"def {name}({', '.join(params)}):\n    pass")
    f.body = list(body)
    if tail_return is not None:
        f.body.append(_stmt(f"return ({', '.join(tail_return)},)"
                            if tail_return else "return ()"))
    if not f.body:
        f.body = [ast.Pass()]
    return f


def _pack_stmt(var_name, names):
    getters = ", ".join(f"lambda: {n}" for n in names)
    return _stmt(f"{var_name} = _jst.pack({getters})")


def _call_stmt(names, helper, call_args):
    call = f"_jst.{helper}({', '.join(call_args)})"
    if names:
        return _stmt(f"({', '.join(names)},) = {call}")
    return _stmt(call)


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self.count = 0
        self.converted = 0

    # new scopes keep their own control flow untouched only at THEIR
    # level — but we do transform nested defs' bodies too (they may be
    # helper closures called under trace)
    def visit_If(self, node):
        self.generic_visit(node)
        if _escapes_control_flow(node.body) or _escapes_control_flow(
                node.orelse):
            return node
        n = self.count
        self.count += 1
        names = sorted(set(_assigned_names(node.body))
                       | set(_assigned_names(node.orelse)))
        in_var = f"__jst_in_{n}"
        tfn = _fndef(f"__jst_true_{n}", names, node.body,
                     tail_return=names)
        ffn = _fndef(f"__jst_false_{n}", names, node.orelse,
                     tail_return=names)
        out = _call_stmt(names, "convert_ifelse", [
            ast.unparse(node.test), tfn.name, ffn.name, in_var,
            repr(tuple(names))])
        self.converted += 1
        return [_pack_stmt(in_var, names), tfn, ffn, out]

    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _escapes_control_flow(node.body):
            return node
        n = self.count
        self.count += 1
        names = sorted(set(_assigned_names(node.body)))
        in_var = f"__jst_in_{n}"
        cfn = _fndef(f"__jst_cond_{n}", names,
                     [_stmt(f"return {ast.unparse(node.test)}")])
        bfn = _fndef(f"__jst_body_{n}", names, node.body,
                     tail_return=names)
        out = _call_stmt(names, "convert_while", [
            cfn.name, bfn.name, in_var, repr(tuple(names))])
        self.converted += 1
        return [_pack_stmt(in_var, names), cfn, bfn, out]


def ast_transform(fn: Callable) -> Optional[Callable]:
    """Rewrite fn's `if`/`while` statements into convert_* calls.
    Returns the converted function, or None when conversion is not
    possible (no source) or not needed (no control flow converted)."""
    if inspect.ismethod(fn):
        converted = ast_transform(fn.__func__)
        return None if converted is None else converted.__get__(
            fn.__self__)
    if hasattr(fn, "__wrapped__"):
        # functools-wrapped: getsource returns the INNER def; recompiling
        # it would silently drop the wrapper's behavior. Bail to tracing.
        return None
    if "__class__" in fn.__code__.co_freevars:
        # zero-arg super() needs the compiler-provided __class__ cell,
        # which a module-level re-exec cannot recreate. Bail to tracing.
        return None
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return None
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    fdef.decorator_list = []
    tr = _ControlFlowTransformer()
    tr.visit(tree)
    if tr.converted == 0:
        return None
    ast.fix_missing_locations(tree)
    glb = dict(fn.__globals__)
    import sys
    glb["_jst"] = sys.modules[__name__]
    # re-executed source loses real closure cells; snapshot their values
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                glb[name] = cell.cell_contents
            except ValueError:
                return None  # unfilled cell (e.g. recursive def): bail
    loc: dict = {}
    try:
        code = compile(tree, filename=f"<dy2static {fn.__qualname__}>",
                       mode="exec")
        exec(code, glb, loc)
    except Exception:
        return None
    new_fn = loc.get(fdef.name)
    if new_fn is None:
        return None
    new_fn.__defaults__ = fn.__defaults__
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    new_fn.__wrapped_dy2static__ = fn
    return new_fn


# ======================= SOT-style graph-break fallback =======================
# full_graph=False contract (ref: the reference's SOT bytecode translator,
# python/paddle/jit/sot/translate.py:31 and
# sot/opcode_translator/executor/opcode_executor.py:1457): instead of
# erroring on unsupported control flow, keep the MAXIMAL supported
# regions and run the unsupported statements eagerly between them. The
# split is at the AST level, as paddle_tpu's: maximal runs of simple
# statements become regions (probed per signature, run through the op
# registry so grads flow); compound statements (data-dependent if/while,
# loops, try, returns) execute eagerly, where Tensor predicates are
# concrete and ordinary Python semantics (return-in-branch etc.) apply.

_SIMPLE_STMTS = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr)


def _reads_before_store(stmts):
    """Names loaded before being stored within `stmts` (region inputs)."""
    stored: set = set()
    reads: list = []

    def walk(node):
        if isinstance(node, _SKIP_SCOPES):
            return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                if node.id not in stored and node.id not in reads:
                    reads.append(node.id)
            else:
                stored.add(node.id)
            return
        # rhs before lhs for assignments
        if isinstance(node, ast.Assign):
            walk(node.value)
            for t in node.targets:
                walk(t)
            return
        if isinstance(node, (ast.AugAssign,)):
            # aug reads AND stores the target
            walk(node.value)
            tgt = node.target
            if isinstance(tgt, ast.Name):
                if tgt.id not in stored and tgt.id not in reads:
                    reads.append(tgt.id)
                stored.add(tgt.id)
            else:
                walk(tgt)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                walk(node.value)
            walk(node.target)
            return
        for child in ast.iter_child_nodes(node):
            walk(child)

    for s in stmts:
        walk(s)
    return reads


class StagedRegion:
    """One region of a graph-broken function.

    Wraps the extracted region function. On its first call with an
    input signature (the shapes and dtypes of its tensor inputs, the
    types of the others) it probes the region with a fake-tensor trace:
    a region that traces is counted as staged, one whose helpers branch
    on tensor VALUES (or read them on the host) as eager, as a SOT graph
    break inside a call is. Both run eagerly, statement by statement
    through the op registry, with torch autograd recording them: the
    port compiles no region (the reference dispatches a staged one as
    one traced XLA op)."""

    def __init__(self, raw_fn, name):
        self.raw_fn = raw_fn
        self.name = name
        self._probed: dict = {}
        self.staged_calls = 0
        self.eager_calls = 0

    @staticmethod
    def _signature(vals):
        sig = []
        for v in vals:
            t = v._data if isinstance(v, Tensor) else v
            if isinstance(t, torch.Tensor):
                sig.append(("T", tuple(t.shape), str(t.dtype),
                            str(t.device)))
            else:
                sig.append(("S", type(v).__name__))
        return tuple(sig)

    def _stageable(self, vals):
        """Trace the region once on fake tensors of its inputs' shapes;
        any failure is a graph break inside it."""
        from torch.fx.experimental.proxy_tensor import make_fx

        pos = [i for i, v in enumerate(vals)
               if isinstance(v, (Tensor, torch.Tensor))]

        def probe(*arrays):
            iv = list(vals)
            for i, a in zip(pos, arrays):
                iv[i] = Tensor._wrap(a) if isinstance(vals[i], Tensor) else a
            out = self.raw_fn(*iv)
            return [o._data if isinstance(o, Tensor) else o for o in out
                    if isinstance(o, (Tensor, torch.Tensor))]

        arrays = [vals[i]._data if isinstance(vals[i], Tensor) else vals[i]
                  for i in pos]
        try:
            with torch.no_grad():
                make_fx(probe, tracing_mode="fake",
                        _allow_non_fake_inputs=True)(
                            *[a.detach() for a in arrays])
            return True
        except Exception:
            # any trace failure (a tensor's value read on the host, a
            # branch on it) is a graph break: the eager run reproduces a
            # genuine bug with a clearer traceback
            return False

    def __call__(self, *vals):
        if any(tracing(v._data if isinstance(v, Tensor) else v)
               for v in vals):
            # already under a trace (an export of the function)
            return self.raw_fn(*vals)
        sig = self._signature(vals)
        stageable = self._probed.get(sig)
        if stageable is None:
            stageable = self._probed[sig] = self._stageable(vals)
        if stageable:
            self.staged_calls += 1
        else:
            self.eager_calls += 1
        return self.raw_fn(*vals)


def graph_break_transform(fn: Callable):
    """Split fn's top-level body into staged regions + eager statements.
    Returns (rewritten_fn, [StagedRegion, ...]) or None when the source
    is unavailable / nothing is worth staging."""
    if inspect.ismethod(fn):
        r = graph_break_transform(fn.__func__)
        if r is None:
            return None
        new_fn, regions = r
        return new_fn.__get__(fn.__self__), regions
    if hasattr(fn, "__wrapped__"):
        return None
    if "__class__" in fn.__code__.co_freevars:
        return None
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return None
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        return None
    fdef.decorator_list = []

    arg_names = [a.arg for a in (fdef.args.posonlyargs + fdef.args.args
                                 + fdef.args.kwonlyargs)]
    if fdef.args.vararg:
        arg_names.append(fdef.args.vararg.arg)
    if fdef.args.kwarg:
        arg_names.append(fdef.args.kwarg.arg)

    def _stageable_stmt(stmt):
        """A region statement must bind only plain Names: mutations of
        attributes/subscripts (self.cache = ..., x[i] = ...) executed
        under the region's jit trace would store TRACERS into live
        objects — they run eagerly instead. Non-docstring bare Exprs
        (e.g. list.append(tensor)) can mutate state the same way."""
        if not isinstance(stmt, _SIMPLE_STMTS):
            return False
        if any(isinstance(n, (ast.Yield, ast.YieldFrom, ast.Await,
                              ast.NamedExpr, ast.Lambda, ast.ListComp,
                              ast.SetComp, ast.DictComp,
                              ast.GeneratorExp))
               for n in ast.walk(stmt)):
            # comprehensions/lambdas open scopes _reads_before_store does
            # not analyze — their free variables would be missed as
            # region inputs; run such statements eagerly instead
            return False
        if isinstance(stmt, ast.Expr):
            return isinstance(stmt.value, ast.Constant)  # docstring only
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in targets:
            for n in ast.walk(t):
                # ast.walk also yields ctx markers (Store/Load)
                if isinstance(n, (ast.Name, ast.Tuple, ast.List,
                                  ast.Starred, ast.Store, ast.Load)):
                    continue
                return False  # Attribute / Subscript target
        return True

    # group maximal runs of simple statements
    groups = []  # (is_region, [stmts])
    cur: list = []
    for stmt in fdef.body:
        simple = _stageable_stmt(stmt)
        if simple:
            cur.append(stmt)
        else:
            if cur:
                groups.append((True, cur))
                cur = []
            groups.append((False, [stmt]))
    if cur:
        groups.append((True, cur))
    n_regions = sum(1 for is_r, _ in groups if is_r)
    if n_regions == 0:
        return None

    bound_so_far = set(arg_names)
    new_body = []
    region_defs = []
    k = 0
    for is_region, stmts in groups:
        if not is_region:
            new_body.extend(stmts)
            bound_so_far |= set(_assigned_names(stmts))
            continue
        reads = [n for n in _reads_before_store(stmts) if n in bound_so_far]
        outs = _assigned_names(stmts)
        rname = f"__jsr_fn_{k}"
        region_defs.append(_fndef(rname, reads, stmts, tail_return=outs))
        call = f"__jsr_staged_{k}({', '.join(reads)})"
        if outs:
            new_body.append(_stmt(f"({', '.join(outs)},) = {call}"))
        else:
            new_body.append(_stmt(call))
        bound_so_far |= set(outs)
        k += 1

    # region defs hoist to module level: StagedRegion wraps the compiled
    # object once, not a fresh local per call
    fdef.body = new_body
    tree.body = region_defs + [fdef]
    ast.fix_missing_locations(tree)

    glb = dict(fn.__globals__)
    import sys
    glb["_jst"] = sys.modules[__name__]
    closure_cells = {}
    if fn.__closure__:
        closure_cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
        for name, cell in closure_cells.items():
            try:
                glb[name] = cell.cell_contents
            except ValueError:
                return None
    loc: dict = {}
    try:
        code = compile(tree, filename=f"<graph_break {fn.__qualname__}>",
                       mode="exec")
        exec(code, glb, loc)
    except Exception:
        return None
    regions = []
    for i in range(k):
        raw = loc.get(f"__jsr_fn_{i}")
        if raw is None:
            return None
        staged = StagedRegion(raw, f"sot_region_{fn.__name__}_{i}")
        glb[f"__jsr_staged_{i}"] = staged
        regions.append(staged)
    new_fn = loc.get(fdef.name)
    if new_fn is None:
        return None
    # region defs were exec'd with `glb` as globals; the rewritten fn also
    # needs __jsr_staged_* visible — both live in glb, and exec(code, glb,
    # loc) gives module-level defs access to glb at call time only if they
    # were compiled with glb as their __globals__; they were (exec globals)
    new_fn.__defaults__ = fn.__defaults__
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    if closure_cells:
        # free variables must track later REBINDING in the enclosing scope
        # (plain eager re-reads cells per call): refresh the exec-globals
        # snapshot from the live cells on every invocation, and probe the
        # regions again when a cell's VALUE changed (a probe's trace
        # takes captured non-tensor values as constants)
        inner = new_fn
        import functools
        last_seen = {}

        @functools.wraps(inner)
        def new_fn(*a, **kw):
            dirty = False
            for _name, _cell in closure_cells.items():
                try:
                    v = _cell.cell_contents
                except ValueError:
                    continue
                if _name not in last_seen or _static_differs(
                        last_seen[_name], v):
                    dirty = dirty or (_name in last_seen)
                    last_seen[_name] = v
                    glb[_name] = v
            if dirty:
                for r in regions:
                    r._probed.clear()
            return inner(*a, **kw)

    new_fn.__graph_break_regions__ = regions
    return new_fn, regions
