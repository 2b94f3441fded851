"""Scripting: a sandboxed expression language (a trimmed copy of the JAX
package's `script/__init__.py`).

Scripts are a restricted Python-expression subset compiled through the `ast`
module with a strict whitelist: names, numeric literals, arithmetic,
comparisons, boolean ops, ternaries, whitelisted math functions,
`doc['field'].value` access, `_score`, and script params. No attribute
access beyond the whitelist, no calls except whitelisted functions, no
subscripts except on `doc`/params — so a user script cannot escape.

Three evaluators share one AST walk:

- `CompiledScript.__call__`: per doc, in Python (the reference semantics,
  including its errors);
- `ColumnVectorizer`: the vectorizable subset as numpy column math over a
  whole segment (the host tier);
- `torch_vectorizer_cls()`: the same walk emitting torch ops over [Q, Dpad]
  float32 tensors on the launch's device (the device tier, which the
  function_score script family runs inside its dense launch).

Update scripts (`UpdateScript`, `compile_update_script`) run in statement
mode over a mutable `ctx` (`ctx._source`, `ctx.op`, `ctx._ttl`, ...): the
same whitelist plus assignments, `if` and literal containers, with every
attribute chain rooted at `ctx`, no dunder attribute, no call outside the
whitelist and no rebinding of `ctx` or of a builtin. Named scripts live in
this package's own process-wide registry (`_named`), which `compile_script`
resolves a source through; a node's `ScriptService` puts and removes its
own entries there. The script-file watcher that feeds it from a directory
comes with the sidecars' slice.
"""

from __future__ import annotations

import ast
import math
import operator

import numpy as np

from ..common.errors import ScriptError

_ALLOWED_FUNCS = {
    "abs": abs, "min": min, "max": max, "round": round,
    "sqrt": math.sqrt, "log": math.log, "log10": math.log10, "exp": math.exp,
    "pow": pow, "floor": math.floor, "ceil": math.ceil,
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
}

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.IfExp,
    ast.Name, ast.Load, ast.Constant, ast.Subscript, ast.Attribute, ast.Call,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd, ast.Not, ast.And, ast.Or,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.In, ast.NotIn,
)

_ALLOWED_ATTRS = {"value", "values", "empty"}


class CompiledScript:
    def __init__(self, source: str, params: dict):
        self.source = source
        self.params = dict(params or {})
        try:
            self.tree = ast.parse(source, mode="eval")
        except SyntaxError as e:
            raise ScriptError(f"script compile error: {e}") from None
        self._validate(self.tree)
        self._code = compile(self.tree, "<script>", "eval")

    def _validate(self, tree: ast.AST):
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ScriptError(
                    f"disallowed construct [{type(node).__name__}] in script [{self.source}]"
                )
            if isinstance(node, ast.Attribute) and node.attr not in _ALLOWED_ATTRS:
                raise ScriptError(f"disallowed attribute [{node.attr}]")
            if isinstance(node, ast.Call):
                if not isinstance(node.func, ast.Name) or node.func.id not in _ALLOWED_FUNCS:
                    raise ScriptError("only whitelisted functions may be called")

    def __call__(self, doc, _score: float = 0.0, **extra):
        env = {"doc": doc, "_score": _score, **_ALLOWED_FUNCS, **self.params, **extra}
        try:
            return eval(self._code, {"__builtins__": {}}, env)  # noqa: S307 — sandboxed AST
        except ScriptError:
            raise
        except Exception as e:  # noqa: BLE001
            raise ScriptError(f"script runtime error: {e}") from None


class ColumnVectorizer:
    """Lower a sandboxed expression to column math: the whole segment in a
    few numpy ops instead of one Python eval per doc.

    Supported subset: arithmetic/comparison/boolean ops, IfExp, whitelisted
    calls, params, _score, and doc['field'].value / .empty over numeric
    columns. vectorize() returns None when the tree goes outside the subset —
    callers fall back to the per-doc path, so behavior never changes, only
    speed."""

    _FUNCS = {
        "abs": np.abs, "sqrt": np.sqrt, "log": np.log, "log10": np.log10,
        "exp": np.exp, "floor": np.floor, "ceil": np.ceil,
        "sin": np.sin, "cos": np.cos, "tan": np.tan, "round": np.round,
        "pow": np.power, "min": np.minimum, "max": np.maximum,
    }
    _BINOPS = {
        ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.multiply,
        ast.Div: np.divide, ast.FloorDiv: np.floor_divide, ast.Mod: np.mod,
        ast.Pow: np.power,
    }
    _CMPOPS = {
        ast.Eq: np.equal, ast.NotEq: np.not_equal, ast.Lt: np.less,
        ast.LtE: np.less_equal, ast.Gt: np.greater, ast.GtE: np.greater_equal,
    }
    # array primitives as class attrs so the torch twin swaps in its own ops
    # and reuses the exact same AST walk (one lowering, two backends)
    _where = staticmethod(np.where)
    _isnan = staticmethod(np.isnan)
    _negative = staticmethod(np.negative)
    _logical_not = staticmethod(np.logical_not)

    def __init__(self, script: "CompiledScript", columns, scores):
        """columns: field name -> float[D] (NaN = missing); scores: float[D]."""
        self.script = script
        self.columns = columns
        self.scores = scores
        self.used_fields: set[str] = set()

    def vectorize(self):
        try:
            with np.errstate(all="ignore"):  # domain errors surface as NaN/inf,
                # which the caller routes to the per-doc path (where they raise
                # ScriptError exactly as before)
                return self._visit(self.script.tree.body)
        except Exception:  # noqa: BLE001 — ANY lowering trouble (numpy arity
            # mismatches, unexpected dtypes, subset gaps) means per-doc fallback,
            # never a changed or crashed search
            return None

    def _visit(self, node):
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float,
                                                                      bool)):
            return node.value
        if isinstance(node, ast.Name):
            # params FIRST — the per-doc env is {doc, _score, **funcs, **params},
            # so params shadow _score and the builtins; mirror that
            if node.id in self.script.params:
                v = self.script.params[node.id]
                if isinstance(v, (int, float, bool)):
                    return v
                raise _NotVectorizable
            if node.id == "_score":
                return self.scores
            raise _NotVectorizable
        if isinstance(node, ast.BinOp) and type(node.op) in self._BINOPS:
            return self._BINOPS[type(node.op)](self._visit(node.left),
                                               self._visit(node.right))
        if isinstance(node, ast.UnaryOp):
            v = self._visit(node.operand)
            if isinstance(node.op, ast.USub):
                return self._negative(v)
            if isinstance(node.op, ast.UAdd):
                return v
            if isinstance(node.op, ast.Not):
                return self._logical_not(v)
            raise _NotVectorizable
        if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and type(node.ops[0]) in self._CMPOPS:
            return self._CMPOPS[type(node.ops[0])](self._visit(node.left),
                                                   self._visit(node.comparators[0]))
        if isinstance(node, ast.BoolOp):
            # Python and/or return VALUES, not booleans: a and b == b if a else a
            vals = [self._visit(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                truthy = out != 0
                out = self._where(truthy, v, out) if isinstance(node.op, ast.And) \
                    else self._where(truthy, out, v)
            return out
        if isinstance(node, ast.IfExp):
            return self._where(self._visit(node.test), self._visit(node.body),
                               self._visit(node.orelse))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in self._FUNCS and not node.keywords \
                and node.func.id not in self.script.params:  # params shadow funcs
            args = [self._visit(a) for a in node.args]
            fn = self._FUNCS[node.func.id]
            if node.func.id in ("min", "max"):
                out = args[0]
                for a in args[1:]:
                    out = fn(out, a)
                return out
            return fn(*args)
        if isinstance(node, ast.Attribute) and node.attr in ("value", "empty") \
                and isinstance(node.value, ast.Subscript):
            sub = node.value
            if isinstance(sub.value, ast.Name) and sub.value.id == "doc" \
                    and isinstance(sub.slice, ast.Constant):
                col = self.columns(str(sub.slice.value))
                if col is None:
                    raise _NotVectorizable
                self.used_fields.add(str(sub.slice.value))
                return self._isnan(col) if node.attr == "empty" else col
        raise _NotVectorizable


class _NotVectorizable(Exception):
    pass


_torch_vectorizer_cls = None


def torch_vectorizer_cls():
    """The torch twin of ColumnVectorizer — the same AST walk, torch ops.

    The walk emits the script as torch ops on the device of `_score` (the
    dense [Q, Dpad] float32 sub-scores) with doc columns bound to float32
    rows on that device. It follows the JAX package's device tier
    (`jax_vectorizer_cls`): float32 throughout, and an operation on two
    Python numbers is computed on the device in float32 (int32 for two
    integers), as `jax.numpy` computes it, not in Python's float64. Numbers
    become tensors with `torch.full`, never with a host→device copy, so the
    walk never synchronises. Built on first use (torch is imported here, not
    when the module is)."""
    global _torch_vectorizer_cls
    if _torch_vectorizer_cls is None:
        import torch

        def lift(x, device):
            if isinstance(x, torch.Tensor):
                return x
            if isinstance(x, bool):
                return torch.full((), x, dtype=torch.bool, device=device)
            if isinstance(x, int):
                return torch.full((), x, dtype=torch.int32, device=device)
            return torch.full((), x, dtype=torch.float32, device=device)

        def tensor_op(fn, n_lifted, device):
            """fn on tensors: when every argument is a Python number the
            first `n_lifted` become tensors (else torch's own scalar
            handling keeps them weakly typed, as jax.numpy does);
            `n_lifted=-1` lifts every number argument."""
            def op(*args):
                if n_lifted < 0 or not any(isinstance(a, torch.Tensor) for a in args):
                    k = len(args) if n_lifted < 0 else n_lifted
                    args = tuple(lift(a, device) if i < k else a
                                 for i, a in enumerate(args))
                return fn(*args)
            return op

        # (torch function, arguments lifted) per name of the base class's
        # op tables; each vectorizer binds them to its device
        funcs = {"abs": (torch.abs, -1), "sqrt": (torch.sqrt, -1),
                 "log": (torch.log, -1), "log10": (torch.log10, -1),
                 "exp": (torch.exp, -1), "floor": (torch.floor, -1),
                 "ceil": (torch.ceil, -1), "sin": (torch.sin, -1),
                 "cos": (torch.cos, -1), "tan": (torch.tan, -1),
                 "round": (torch.round, -1), "pow": (torch.pow, 1),
                 "min": (torch.minimum, -1), "max": (torch.maximum, -1)}
        binops = {ast.Add: (operator.add, 1), ast.Sub: (operator.sub, 1),
                  ast.Mult: (operator.mul, 1), ast.Div: (torch.true_divide, -1),
                  ast.FloorDiv: (torch.floor_divide, -1),
                  ast.Mod: (torch.remainder, 1), ast.Pow: (torch.pow, 1)}
        cmpops = {ast.Eq: (operator.eq, 1), ast.NotEq: (operator.ne, 1),
                  ast.Lt: (operator.lt, 1), ast.LtE: (operator.le, 1),
                  ast.Gt: (operator.gt, 1), ast.GtE: (operator.ge, 1)}

        class TorchVectorizer(ColumnVectorizer):
            def __init__(self, script, columns, scores):
                super().__init__(script, columns, scores)
                dev = self.device = scores.device
                self._FUNCS = {k: tensor_op(f, n, dev) for k, (f, n) in funcs.items()}
                self._BINOPS = {k: tensor_op(f, n, dev) for k, (f, n) in binops.items()}
                self._CMPOPS = {k: tensor_op(f, n, dev) for k, (f, n) in cmpops.items()}

            def _where(self, cond, a, b):
                cond = lift(cond, self.device)
                if cond.dtype != torch.bool:
                    cond = cond != 0
                return torch.where(cond, lift(a, self.device), lift(b, self.device))

            def _isnan(self, x):
                return torch.isnan(x)

            def _negative(self, x):
                return torch.neg(lift(x, self.device))

            def _logical_not(self, x):
                return torch.logical_not(lift(x, self.device))

            def vectorize(self):
                # no exception swallowing: the caller classified the script
                # vectorizable before launching, so a failure here is a fault
                # to surface, never a silently different program
                return self._visit(self.script.tree.body)

        _torch_vectorizer_cls = TorchVectorizer
    return _torch_vectorizer_cls


def script_uses_score(script: "CompiledScript") -> bool:
    """True if the script reads `_score` (params shadow it, mirroring the eval
    env construction in CompiledScript.__call__)."""
    if "_score" in script.params:
        return False
    return any(isinstance(n, ast.Name) and n.id == "_score"
               for n in ast.walk(script.tree))


def script_vector_info(script: "CompiledScript") -> tuple[bool, tuple]:
    """(vectorizable, used_fields) — probed once with dummy 2-element columns and
    cached on the CompiledScript (compile_script caches those, so classification
    at lower time and execution share one probe). The subsets of ColumnVectorizer
    and the torch twin are identical by construction (same walk, parallel op
    tables)."""
    info = getattr(script, "_vector_info", None)
    if info is None:
        probe = ColumnVectorizer(script, lambda f: np.zeros(2), np.zeros(2))
        ok = probe.vectorize() is not None
        info = (ok, tuple(sorted(probe.used_fields)))
        script._vector_info = info
    return info


def script_vectorizable(script: "CompiledScript") -> bool:
    return script_vector_info(script)[0]


SUPPORTED_LANGS = {None, "mvel", "expression", "native", "python"}


def check_lang(lang):
    """An unknown `lang` rejects the request."""
    if lang not in SUPPORTED_LANGS:
        raise ScriptError(f"script_lang not supported [{lang}]")


class _AttrDict:
    """Attribute access over a plain dict, so mvel-shaped update scripts
    (`ctx._source.foo = ...`) run unmodified."""

    __slots__ = ("_d",)

    def __init__(self, d: dict):
        object.__setattr__(self, "_d", d)

    def __getattr__(self, k):
        try:
            v = self._d[k]
        except KeyError:
            raise AttributeError(k) from None
        return _AttrDict(v) if isinstance(v, dict) else v

    def __setattr__(self, k, v):
        self._d[k] = v

    def __getitem__(self, k):
        v = self._d[k]
        return _AttrDict(v) if isinstance(v, dict) else v

    def __setitem__(self, k, v):
        self._d[k] = v

    def __contains__(self, k):
        return k in self._d


_STMT_NODES = _ALLOWED_NODES + (
    ast.Module, ast.Assign, ast.AugAssign, ast.Expr, ast.If, ast.Store,
    ast.List, ast.Dict, ast.Tuple,
)


class UpdateScript:
    """A statement-mode script over a mutable `ctx` (an update script sets
    `ctx._source`, `ctx.op`, `ctx._ttl`, `ctx._timestamp`)."""

    def __init__(self, source: str, params: dict):
        self.source = source
        self.params = dict(params or {})
        try:
            self.tree = ast.parse(source, mode="exec")
        except SyntaxError as e:
            raise ScriptError(f"script compile error: {e}") from None
        for node in ast.walk(self.tree):
            if not isinstance(node, _STMT_NODES):
                raise ScriptError(
                    f"disallowed construct [{type(node).__name__}] in script "
                    f"[{self.source}]")
            if isinstance(node, ast.Attribute):
                # attribute chains are rooted at `ctx` (an _AttrDict) and never
                # reach a dunder: no `().__class__...` escape
                if node.attr.startswith("__"):
                    raise ScriptError(f"disallowed attribute [{node.attr}]")
                base = node
                while isinstance(base, (ast.Attribute, ast.Subscript)):
                    base = base.value
                if not (isinstance(base, ast.Name) and base.id == "ctx"):
                    raise ScriptError(
                        "attribute access is only allowed on ctx.*")
            if isinstance(node, ast.Call):
                if not isinstance(node.func, ast.Name) or \
                        node.func.id not in _ALLOWED_FUNCS:
                    raise ScriptError("only whitelisted functions may be called")
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else \
                    [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in (
                            *_ALLOWED_FUNCS, "ctx"):
                        raise ScriptError(
                            f"cannot rebind builtin name [{t.id}]")
        self._code = compile(self.tree, "<update-script>", "exec")

    def run(self, ctx: dict, **extra):
        env = {"ctx": _AttrDict(ctx), **_ALLOWED_FUNCS, **self.params, **extra}
        try:
            exec(self._code, {"__builtins__": {}}, env)  # noqa: S102 — sandboxed AST
        except ScriptError:
            raise
        except Exception as e:  # noqa: BLE001
            raise ScriptError(f"script runtime error: {e}") from None
        return ctx


def compile_update_script(source: str, params: dict | None = None,
                          lang=None) -> UpdateScript:
    check_lang(lang)
    return UpdateScript(source, params or {})


_cache: dict[tuple, CompiledScript] = {}

# named scripts: name -> {owner (a ScriptService's id): source}, the
# newest owner's source winning, so one in-process node removing its
# script never drops another's of the same name
_named: dict[str, dict[int, str]] = {}


def _resolve_named(name: str) -> str | None:
    owners = _named.get(name)
    if owners:
        return next(reversed(owners.values()))
    return None


def compile_script(source: str, params: dict | None = None,
                   lang=None) -> CompiledScript:
    check_lang(lang)
    source = _resolve_named(source) or source
    key = (source, tuple(sorted((params or {}).items())))
    try:
        cs = _cache.get(key)
    except TypeError:  # unhashable params
        return CompiledScript(source, params or {})
    if cs is None:
        cs = CompiledScript(source, params or {})
        _cache[key] = cs
    return cs


class ScriptService:
    """A node's named scripts in the process registry (`_named`), and the
    compile of a source or a name."""

    def __init__(self):
        self._sid = id(self)

    def put(self, name: str, source: str):
        owners = _named.setdefault(name, {})
        owners.pop(self._sid, None)  # a re-put makes this owner the newest
        owners[self._sid] = source

    def remove(self, name: str):
        owners = _named.get(name)
        if owners is not None:
            owners.pop(self._sid, None)
            if not owners:
                _named.pop(name, None)

    def compile(self, source_or_name: str, params: dict | None = None) -> CompiledScript:
        return compile_script(source_or_name, params)
