"""KRN001 — ctypes bindings against the ``extern "C"`` declarations;
KRN002 — a custom op without its fake or FLOP formula.

Each kernel of the port has two descriptions of one interface that
nothing type-checks against each other: the ``extern "C"`` function in
``kernels/csrc/<name>.cu``, and the ``argtypes`` / ``restype`` the
wrapper in ``kernels/<name>.py`` gives its ctypes binding (built by list
arithmetic such as ``[p] * 11 + [i] * 9 + [f, i]``).  A wrong count or
width passes every CPU test — those run the plain versions — and
corrupts memory on the card only: the port's counterpart of a wrong
Pallas index_map that interpret mode runs happily.  KRN001 parses the
``extern "C"`` declarations of ``csrc/*.cu`` and checks, in
``src/repro_torch/kernels/``, each statically visible
``lib.<fn>.argtypes = <list expr>`` (list arithmetic folded over local
aliases such as ``p, i, f = ctypes.c_void_p, ctypes.c_int,
ctypes.c_float``) and ``.restype = ...``: the function is exported, the
parameter count matches, each width matches (pointer and
``cudaStream_t`` <-> ``c_void_p``, ``int`` <-> ``c_int``, ``int64_t`` /
``long long`` <-> ``c_int64`` / ``c_longlong``, ``float`` <->
``c_float``), and the return type matches.  Each statically visible
call ``_lib().<fn>(...)`` / ``lib.<fn>(...)`` passes ``len(argtypes)``
arguments.  Bindings that are not statically visible (a ``getattr``
loop) are skipped — no false positives on dynamic code — and
``chip_smoke.py`` checks the live bindings of the built libraries
against the same parse on the card (``parse_exports`` / ``ctype_kind``).

KRN002: every ``torch.library.custom_op`` in ``kernels/`` has, in its
module, a ``register_fake`` and a ``register_flop_formula(torch.ops.
<its name>)``.  Without the fake a dry-run cannot trace the op on fake
tensors; without the formula ``FlopCounterMode`` silently counts
nothing for the kernel, and the dry-run's FLOPs and roofline drift from
the real step (the JAX package's PAL002 guards the same drift for a
Pallas ``cost_estimate``).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       const_int, dotted_name, register)

SCOPES = ("src/repro_torch/kernels/",)
CSRC = "src/repro_torch/kernels/csrc"

# C spellings (qualifiers dropped, whitespace collapsed) -> width kind
_C_KINDS = {
    "void": "void", "bool": "bool", "_Bool": "bool",
    "int": "i32", "signed": "i32", "signed int": "i32", "int32_t": "i32",
    "cudaError_t": "i32",
    "unsigned": "u32", "unsigned int": "u32", "uint32_t": "u32",
    "long": "i64", "long int": "i64", "long long": "i64",
    "long long int": "i64", "signed long": "i64", "signed long long": "i64",
    "int64_t": "i64", "ssize_t": "i64", "ptrdiff_t": "i64",
    "intptr_t": "i64",
    "unsigned long": "u64", "unsigned long int": "u64",
    "unsigned long long": "u64", "unsigned long long int": "u64",
    "uint64_t": "u64", "size_t": "u64", "uintptr_t": "u64",
    "float": "f32", "double": "f64",
    "char": "i8", "signed char": "i8", "int8_t": "i8",
    "unsigned char": "u8", "uint8_t": "u8",
    "short": "i16", "short int": "i16", "int16_t": "i16",
    "unsigned short": "u16", "uint16_t": "u16",
}
_C_POINTERS = {"cudaStream_t", "cudaEvent_t"}
# words that end a type, never name a parameter
_C_WORDS = {w for spelling in _C_KINDS for w in spelling.split()} \
    | _C_POINTERS
_C_QUALIFIERS = {"const", "volatile", "struct", "restrict", "__restrict__",
                 "static", "inline", "extern", "__host__", "__device__",
                 "__forceinline__", "__noinline__"}

# ctypes type names (what ``type.__name__`` says on an LP64 host) -> kind
_CTYPES_KINDS = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_wchar_p": "ptr",
    "c_int": "i32", "c_int32": "i32", "c_uint": "u32", "c_uint32": "u32",
    "c_long": "i64", "c_int64": "i64", "c_longlong": "i64",
    "c_ssize_t": "i64", "c_ulong": "u64", "c_uint64": "u64",
    "c_ulonglong": "u64", "c_size_t": "u64",
    "c_float": "f32", "c_double": "f64", "c_bool": "bool",
    "c_byte": "i8", "c_int8": "i8", "c_char": "i8",
    "c_ubyte": "u8", "c_uint8": "u8",
    "c_short": "i16", "c_int16": "i16", "c_ushort": "u16", "c_uint16": "u16",
}
_KIND_WORDS = {"ptr": "pointer", "void": "void", "bool": "bool",
               "f32": "32-bit float", "f64": "64-bit float"}


def kind_word(kind: Optional[str]) -> str:
    if kind in _KIND_WORDS:
        return _KIND_WORDS[kind]
    if kind and kind[0] in "iu":
        return (f"{kind[1:]}-bit {'unsigned ' if kind[0] == 'u' else ''}"
                f"int")
    return "unknown"


def c_kind(ctype: str) -> Optional[str]:
    """Width kind of a C type ('const void*' -> 'ptr', 'int64_t' ->
    'i64'), or None for a type this parser does not know."""
    if "*" in ctype or "[" in ctype:
        return "ptr"
    words = [w for w in ctype.split() if w not in _C_QUALIFIERS]
    if len(words) == 1 and words[0] in _C_POINTERS:
        return "ptr"
    return _C_KINDS.get(" ".join(words))


def ctype_kind(name: Optional[str]) -> Optional[str]:
    """Width kind of a ctypes type by its name (``None`` for a restype of
    None: 'void'; ``LP_*``: a ``POINTER(...)``), or None if unknown."""
    if name is None:
        return "void"
    if name.startswith("LP_"):
        return "ptr"
    return _CTYPES_KINDS.get(name)


@dataclass(frozen=True)
class CFunction:
    """One ``extern "C"`` function of a kernel source."""
    name: str
    source: str                    # csrc file name, e.g. "quantize.cu"
    line: int
    ret: str                       # C spelling of the return type
    params: Tuple[str, ...]        # C spelling of each parameter

    @property
    def ret_kind(self) -> Optional[str]:
        return c_kind(self.ret)

    @property
    def param_kinds(self) -> Tuple[Optional[str], ...]:
        return tuple(c_kind(_param_type(p)) for p in self.params)


def _param_type(param: str) -> str:
    """'const void* q' -> 'const void*'; 'int B' -> 'int'; 'int' -> 'int';
    'float x[4]' -> 'float*'."""
    m = re.match(r"^(.*?)\b([A-Za-z_]\w*)\s*(\[[^\]]*\])?$", param.strip())
    if not m or not m.group(1).strip() or m.group(2) in _C_WORDS:
        return param.strip()           # no parameter name to drop
    return m.group(1).strip() + ("*" if m.group(3) else "")


_CHAR_RE = re.compile(r"'(\\.[^'\n]{0,3}|[^'\\\n])'")


def _blank_comments_and_strings(text: str) -> str:
    """The source with comments and string / char literals blanked
    (newlines and offsets kept); the literal ``"C"`` is kept, so
    ``extern "C"`` survives."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
        elif c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            j = min(j + 1, n)
            if text[i:j] == '"C"':
                i = j
                continue
            for k in range(i + 1, j - 1):
                if out[k] != "\n":
                    out[k] = " "
            i = j
            continue
        elif c == "'" and _CHAR_RE.match(text, i):
            j = _CHAR_RE.match(text, i).end()
        else:
            i += 1
            continue
        for k in range(i, j):
            if out[k] != "\n":
                out[k] = " "
        i = j
    return "".join(out)


def _match_brace(text: str, open_at: int) -> int:
    depth = 0
    for k in range(open_at, len(text)):
        if text[k] == "{":
            depth += 1
        elif text[k] == "}":
            depth -= 1
            if depth == 0:
                return k
    return len(text) - 1


def _depth0(text: str) -> str:
    """``text`` with everything inside braces blanked (offsets kept)."""
    out, depth = list(text), 0
    for k, ch in enumerate(text):
        if ch == "}":
            depth -= 1
        if depth > 0 and ch != "\n":
            out[k] = " "
        if ch == "{":
            depth += 1
    return "".join(out)


_FUNC_RE = re.compile(
    r"(?:^|(?<=[;{}]))\s*(?P<ret>[A-Za-z_][\w\s\*&]*?)\s*\b(?P<name>"
    r"[A-Za-z_]\w*)\s*\((?P<params>[^(){};]*)\)\s*(?=[{;])")


def parse_exports(text: str, source: str = "<csrc>") -> Dict[str, CFunction]:
    """The functions declared or defined ``extern "C"`` in one CUDA
    source: inside ``extern "C" { ... }`` blocks (at their top level) or
    as single ``extern "C" <declaration>``s."""
    clean = _blank_comments_and_strings(text)
    # preprocessor lines are no declarations
    clean = re.sub(r"(?m)^[ \t]*#.*$", lambda m: " " * len(m.group()), clean)
    out: Dict[str, CFunction] = {}
    for m in re.finditer(r'\bextern\s*"C"\s*', clean):
        start = m.end()
        if start < len(clean) and clean[start] == "{":
            end = _match_brace(clean, start)
            region, base = _depth0(clean[start + 1:end]), start + 1
        else:
            stop = min([k for k in (clean.find(";", start),
                                    clean.find("{", start)) if k >= 0]
                       or [len(clean)])
            region, base = clean[start:stop] + ";", start
        for f in _FUNC_RE.finditer(region):
            words = f.group("ret").split()
            params = [p.strip() for p in f.group("params").split(",")
                      if p.strip()]
            if params == ["void"]:
                params = []
            line = clean.count("\n", 0, base + f.start("name")) + 1
            out[f.group("name")] = CFunction(
                f.group("name"), source, line,
                " ".join(w for w in words if w not in _C_QUALIFIERS
                         or w == "const"),
                tuple(params))
    return out


def load_exports(csrc_dir: Path) -> Dict[str, CFunction]:
    """``parse_exports`` over every ``*.cu`` of ``csrc_dir``: function
    name -> its declaration (names are unique across the sources, as
    one process loads every library)."""
    out: Dict[str, CFunction] = {}
    for path in sorted(Path(csrc_dir).glob("*.cu")):
        out.update(parse_exports(path.read_text(), path.name))
    return out


# ---------------------------------------------------------------------------
# the Python side: which expressions are a kernel library
# ---------------------------------------------------------------------------

def _is_build_load(ctx: ModuleContext, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    full = ctx.resolve(node.func) or ""
    return full == "build.load" or full.endswith("kernels.build.load")


def library_sources(ctx: ModuleContext) -> Set[str]:
    """The csrc names this module loads (``build.load("quantize")``)."""
    return {n.args[0].value for n in ast.walk(ctx.tree)
            if _is_build_load(ctx, n) and n.args
            and isinstance(n.args[0], ast.Constant)
            and isinstance(n.args[0].value, str)}


def library_getters(ctx: ModuleContext) -> Set[str]:
    """Module-level functions that return a loaded library (``_lib``)."""
    out = set()
    for fn in ctx.tree.body:
        if isinstance(fn, ast.FunctionDef) and any(
                _is_build_load(ctx, n) for n in ast.walk(fn)):
            out.add(fn.name)
    return out


def _bindings(scope: ast.AST, is_lib) -> Set[str]:
    """Names bound to a library expression anywhere in ``scope``
    (``lib = _lib()``; ``lib, code = _lib(), ...``)."""
    names = set()
    for node in ast.walk(scope):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and is_lib(node.value):
                names.add(t.id)
            elif isinstance(t, ast.Tuple) and isinstance(node.value,
                                                         ast.Tuple):
                for tt, vv in zip(t.elts, node.value.elts):
                    if isinstance(tt, ast.Name) and is_lib(vv):
                        names.add(tt.id)
    return names


class Libraries:
    """Tells, per function, which expressions are a kernel library."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.getters = library_getters(ctx)
        self._local: Dict[int, Set[str]] = {}

    def _direct(self, node: ast.AST) -> bool:
        return (_is_build_load(self.ctx, node)
                or (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in self.getters))

    def is_lib(self, node: ast.AST, scope: Optional[ast.AST]) -> bool:
        if self._direct(node):
            return True
        if isinstance(node, ast.Name) and scope is not None:
            key = id(scope)
            if key not in self._local:
                self._local[key] = _bindings(scope, self._direct)
            return node.id in self._local[key]
        return False


def scopes(tree: ast.Module) -> Iterator[Tuple[ast.AST, Optional[ast.AST]]]:
    """(node, innermost enclosing function or None) for every node."""
    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            inner = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            yield child, fn
            yield from walk(child, inner)
    yield from walk(tree, None)


def custom_ops(ctx: ModuleContext) -> Dict[str, Tuple[str, ast.FunctionDef]]:
    """Function name -> ("ns::op", def) for each ``torch.library.
    custom_op`` defined in the module."""
    out = {}
    for fn in ctx.functions():
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) \
                    and (ctx.resolve(dec.func) or "").endswith(
                        "library.custom_op") \
                    and dec.args and isinstance(dec.args[0], ast.Constant) \
                    and isinstance(dec.args[0].value, str):
                out[fn.name] = (dec.args[0].value, fn)
    return out


def registered(ctx: ModuleContext, what: str) -> Set[str]:
    """Op names ("ns::op") given a ``register_fake`` / ``register_autograd``
    in the module: ``@_op.register_fake``, ``_op.register_autograd(...)``
    or ``torch.library.register_fake("ns::op", ...)``."""
    ops = custom_ops(ctx)
    out = set()
    for node in ast.walk(ctx.tree):
        target = node.func if isinstance(node, ast.Call) else node
        if not isinstance(target, ast.Attribute) or target.attr != what:
            continue
        if isinstance(target.value, ast.Name) and target.value.id in ops:
            out.add(ops[target.value.id][0])
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and (ctx.resolve(target) or "").endswith(f"library.{what}"):
            out.add(node.args[0].value)
    return out


def op_of(dotted: Optional[str]) -> Optional[str]:
    """'torch.ops.ns.op[.default]' -> 'ns::op', else None."""
    parts = (dotted or "").split(".")
    if len(parts) in (4, 5) and parts[:2] == ["torch", "ops"] \
            and parts[4:] in ([], ["default"]):
        return f"{parts[2]}::{parts[3]}"
    return None


# ---------------------------------------------------------------------------
# KRN001
# ---------------------------------------------------------------------------

def _alias_kinds(ctx: ModuleContext, scope: Optional[ast.AST]
                 ) -> Dict[str, str]:
    """Names bound to ctypes types (``p, i = ctypes.c_void_p,
    ctypes.c_int``) at module level and in ``scope``."""
    env: Dict[str, str] = {}
    stmts = list(ctx.tree.body) + (list(ast.walk(scope))
                                   if scope is not None else [])
    for node in stmts:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t, v = node.targets[0], node.value
        pairs = (zip(t.elts, v.elts)
                 if isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple)
                 else [(t, v)])
        for tt, vv in pairs:
            if isinstance(tt, ast.Name):
                k = _elem_kind(ctx, vv, {})
                if k is not None:
                    env[tt.id] = k
    return env


def _elem_kind(ctx: ModuleContext, node: ast.AST,
               env: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Constant) and node.value is None:
        return "void"
    if isinstance(node, ast.Name) and node.id in env:
        return env[node.id]
    if isinstance(node, ast.Call) \
            and (ctx.resolve(node.func) or "") == "ctypes.POINTER":
        return "ptr"
    full = ctx.resolve(node) or ""
    if full.startswith("ctypes."):
        return ctype_kind(full.split(".", 1)[1])
    return None


def _fold_list(ctx: ModuleContext, node: ast.AST, env: Dict[str, str],
               ints: Dict[str, int]) -> Optional[List[Optional[str]]]:
    """An argtypes expression folded to a list of kinds (None for an entry
    of unknown width), or None when the list is not statically visible."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_elem_kind(ctx, el, env) for el in node.elts]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a = _fold_list(ctx, node.left, env, ints)
        b = _fold_list(ctx, node.right, env, ints)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for lst, num in ((node.left, node.right), (node.right, node.left)):
            items = _fold_list(ctx, lst, env, ints)
            n = const_int(num, ints)
            if items is not None and n is not None:
                return items * n
    return None


def _local_ints(ctx: ModuleContext, scope: Optional[ast.AST]
                ) -> Dict[str, int]:
    env = dict(ctx.module_ints)
    if scope is not None:
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                v = const_int(node.value, env)
                if v is not None:
                    env[node.targets[0].id] = v
    return env


@register
class Krn001(Rule):
    rule_id = "KRN001"
    title = "ctypes binding disagrees with the kernel's extern \"C\" declaration"
    motivation = ("every kernel of the port is bound twice — its extern "
                  "\"C\" declaration in csrc/*.cu and the argtypes list "
                  "arithmetic in its wrapper (17 exports over 5 sources); "
                  "the CPU tests run the plain versions, so a wrong count "
                  "or width corrupts memory on the card only")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.rel.startswith(SCOPES):
            return
        csrc = ctx.root / CSRC
        if not csrc.is_dir():
            return
        libs = Libraries(ctx)
        exports = load_exports(csrc)
        sources = {f"{s}.cu" for s in library_sources(ctx)}
        argtypes: Dict[str, int] = {}
        restyped: Set[str] = set()
        bound: List[Tuple[str, ast.AST, Optional[ast.AST]]] = []
        # bindings first (their lengths decide the calls' arity)
        for node, fn in scopes(ctx.tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not (isinstance(t, ast.Attribute)
                    and t.attr in ("argtypes", "restype")
                    and isinstance(t.value, ast.Attribute)
                    and libs.is_lib(t.value.value, fn)):
                continue
            name = t.value.attr
            decl = exports.get(name)
            if decl is None or (sources and decl.source not in sources):
                where = (" or ".join(sorted(sources)) if sources
                         else "any csrc/*.cu")
                yield self.finding(
                    ctx, node,
                    f"`{name}` is bound but {where} declares no extern "
                    f"\"C\" function of that name")
                continue
            env = _alias_kinds(ctx, fn)
            if t.attr == "restype":
                restyped.add(name)
                kind = _elem_kind(ctx, node.value, env)
                if kind is not None and decl.ret_kind is not None \
                        and kind != decl.ret_kind:
                    yield self.finding(
                        ctx, node,
                        f"restype of `{name}` is {kind_word(kind)}; "
                        f"csrc/{decl.source}:{decl.line} returns "
                        f"`{decl.ret}` ({kind_word(decl.ret_kind)})")
                continue
            kinds = _fold_list(ctx, node.value, env, _local_ints(ctx, fn))
            if kinds is None:
                continue                 # not statically visible
            argtypes[name] = len(kinds)
            bound.append((name, node, fn))
            want = decl.param_kinds
            if len(kinds) != len(want):
                yield self.finding(
                    ctx, node,
                    f"argtypes of `{name}` has {len(kinds)} entries; "
                    f"csrc/{decl.source}:{decl.line} declares "
                    f"{len(want)} parameters")
                continue
            for i, (got, exp) in enumerate(zip(kinds, want)):
                if got is not None and exp is not None and got != exp:
                    yield self.finding(
                        ctx, node,
                        f"argtypes[{i}] of `{name}` is {kind_word(got)}; "
                        f"csrc/{decl.source}:{decl.line} declares "
                        f"`{decl.params[i]}` ({kind_word(exp)})")
        for name, node, _ in bound:
            decl = exports[name]
            if name not in restyped and decl.ret_kind not in ("i32", "void",
                                                              None):
                yield self.finding(
                    ctx, node,
                    f"`{name}` has argtypes but no restype: ctypes reads a "
                    f"c_int, csrc/{decl.source}:{decl.line} returns "
                    f"`{decl.ret}`")
        # the calls
        for node, fn in scopes(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and libs.is_lib(node.func.value, fn)):
                continue
            name = node.func.attr
            if any(isinstance(a, ast.Starred) for a in node.args) \
                    or node.keywords:
                continue
            if name in argtypes:
                n, what = argtypes[name], "its argtypes has"
            elif name in exports:
                n, what = (len(exports[name].params),
                           f"csrc/{exports[name].source}:"
                           f"{exports[name].line} declares")
            else:
                continue
            if len(node.args) != n:
                yield self.finding(
                    ctx, node,
                    f"`{name}(...)` is called with {len(node.args)} "
                    f"arguments; {what} {n}")


# ---------------------------------------------------------------------------
# KRN002
# ---------------------------------------------------------------------------

@register
class Krn002(Rule):
    rule_id = "KRN002"
    title = "custom op without register_fake or register_flop_formula"
    motivation = ("the dry-run traces the kernels' custom ops on fake "
                  "tensors and counts FLOPs by their formulas; a missing "
                  "fake breaks the trace, a missing formula silently "
                  "counts nothing for the kernel (the JAX package's "
                  "cost-estimate drift, PAL002)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.rel.startswith(SCOPES):
            return
        ops = custom_ops(ctx)
        if not ops:
            return
        fakes = registered(ctx, "register_fake")
        flops = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and node.args \
                    and (dotted_name(node.func) or "").endswith(
                        "register_flop_formula"):
                op = op_of(dotted_name(node.args[0]))
                if op:
                    flops.add(op)
        for fname, (op, fn) in sorted(ops.items()):
            if op not in fakes:
                yield self.finding(
                    ctx, fn,
                    f"custom op `{op}` has no register_fake in its module: "
                    f"a dry-run cannot trace it on fake tensors")
            if op not in flops:
                yield self.finding(
                    ctx, fn,
                    f"custom op `{op}` has no "
                    f"register_flop_formula(torch.ops.{op.replace('::', '.')})"
                    f" in its module: FlopCounterMode counts nothing for "
                    f"the kernel")
