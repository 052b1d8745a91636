"""Analyzer core: rule registry, module context, suppressions, the run.

Everything is stdlib ``ast`` — rules get a parsed module plus shared
helpers (import resolution to fully-qualified dotted names, constant
folding for shape arithmetic, enclosing-symbol lookup) and yield
``Finding``s.  Suppression is per line
(``# repro-torch-lint: disable=RULE``); grandfathered findings live in a
checked-in baseline (see baseline.py) so the gate fails only on NEW
violations.

The helpers are the JAX package's (``repro.analysis.core``), copied: the
port imports nothing of ``repro``, and ``tests/test_torch_analysis.py``
holds the copies to the originals on every file of ``src/`` and
``tests/``.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

# what is scanned when no explicit paths are given (relative to root): the
# port, its examples, its card script and its own tests — the rest of
# tests/ holds the JAX package's tests, which are ``repro.analysis``'s
DEFAULT_PATHS = ("src/repro_torch", "examples_torch", "chip_smoke.py",
                 "tests/test_torch_*.py", "tests/_torch_*.py")

# rule settings a caller may override through ``config`` (none yet: the
# port has no VMEM budget or other knob)
DEFAULT_CONFIG: Dict[str, object] = {}

_SUPPRESS_RE = re.compile(r"#\s*repro-torch-lint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location.  ``symbol`` (the
    enclosing def/class qualname) anchors baseline entries, so they
    survive line drift."""
    rule: str
    path: str          # root-relative posix path
    line: int
    col: int
    message: str
    symbol: str = "<module>"

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.symbol}] {self.message}")


class Rule:
    """Base class; subclasses register with ``@register`` and implement
    ``check(ctx) -> iterable[Finding]``."""
    rule_id: str = ""
    title: str = ""
    motivation: str = ""     # the event that made the invariant real

    def check(self, ctx: "ModuleContext") -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "ModuleContext", node: ast.AST,
                message: str) -> Finding:
        return Finding(self.rule_id, ctx.rel, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message,
                       ctx.symbol_at(getattr(node, "lineno", 1)))


RULES: Dict[str, Rule] = {}


def register(cls):
    assert cls.rule_id and cls.rule_id not in RULES, cls
    RULES[cls.rule_id] = cls()
    return cls


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'np.random.rand' for a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class ImportMap:
    """Local name -> fully-qualified dotted module/object name."""

    def __init__(self, tree: ast.Module):
        self.names: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.names[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                for a in node.names:
                    self.names[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve(self, dotted: Optional[str]) -> Optional[str]:
        """Expand the first segment through the import table:
        'np.random.rand' -> 'numpy.random.rand'."""
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        full = self.names.get(head, head)
        return f"{full}.{rest}" if rest else full


def const_int(node: ast.AST, env: Dict[str, int]) -> Optional[int]:
    """Fold an int expression over literals + ``env`` names, or None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = const_int(node.operand, env)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        lhs, rhs = const_int(node.left, env), const_int(node.right, env)
        if lhs is None or rhs is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return lhs + rhs
            if isinstance(node.op, ast.Sub):
                return lhs - rhs
            if isinstance(node.op, ast.Mult):
                return lhs * rhs
            if isinstance(node.op, ast.FloorDiv):
                return lhs // rhs
            if isinstance(node.op, ast.Mod):
                return lhs % rhs
            if isinstance(node.op, ast.Pow):
                return lhs ** rhs
        except (ZeroDivisionError, OverflowError):
            return None
    return None


def const_int_tuple(node: ast.AST,
                    env: Dict[str, int]) -> Optional[Tuple[int, ...]]:
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    out = []
    for el in node.elts:
        v = const_int(el, env)
        if v is None:
            return None
        out.append(v)
    return tuple(out)


def int_env(tree: ast.Module) -> Dict[str, int]:
    """Module-level ``NAME = <int literal>`` constants (last wins)."""
    env: Dict[str, int] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            v = const_int(stmt.value, env)
            if v is not None:
                env[stmt.targets[0].id] = v
    return env


# ---------------------------------------------------------------------------
# module context
# ---------------------------------------------------------------------------

class ModuleContext:
    """One parsed source file plus the helpers every rule needs.
    ``root`` is the checkout the file belongs to (rules that read other
    files of it, KRN001's ``csrc/``, look there; default: this
    package's own checkout)."""

    def __init__(self, text: str, rel: str, config: Optional[dict] = None,
                 root: Optional[Path] = None):
        self.text = text
        self.rel = rel.replace("\\", "/")
        self.root = Path(root) if root else repo_root()
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        self.config = dict(DEFAULT_CONFIG, **(config or {}))
        self.imports = ImportMap(self.tree)
        self.module_ints = int_env(self.tree)
        # (start, end, qualname) intervals for enclosing-symbol lookup
        self._symbols: List[Tuple[int, int, str]] = []
        self._collect_symbols(self.tree, [])
        self.suppressed: Dict[int, set] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.suppressed[i] = {
                    r.strip().upper() for r in m.group(1).split(",")
                    if r.strip()}

    def _collect_symbols(self, node: ast.AST, stack: List[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = ".".join(stack + [child.name])
                end = getattr(child, "end_lineno", child.lineno)
                self._symbols.append((child.lineno, end, qual))
                self._collect_symbols(child, stack + [child.name])
            else:
                self._collect_symbols(child, stack)

    def symbol_at(self, line: int) -> str:
        best, best_span = "<module>", None
        for lo, hi, qual in self._symbols:
            if lo <= line <= hi:
                span = hi - lo
                if best_span is None or span <= best_span:
                    best, best_span = qual, span
        return best

    def is_suppressed(self, f: Finding) -> bool:
        rules = self.suppressed.get(f.line)
        return bool(rules) and (f.rule.upper() in rules or "ALL" in rules)

    def resolve(self, node: ast.AST) -> Optional[str]:
        return self.imports.resolve(dotted_name(node))

    def functions(self) -> Iterator[ast.FunctionDef]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


# ---------------------------------------------------------------------------
# the run over files
# ---------------------------------------------------------------------------

@dataclass
class Report:
    root: str
    files_scanned: int = 0
    findings: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    parse_errors: List[str] = field(default_factory=list)

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


def _load_rules(only: Optional[Sequence[str]] = None) -> List[Rule]:
    import repro_torch.analysis.rules  # noqa: F401  (registers on import)
    if not only:
        return [RULES[k] for k in sorted(RULES)]
    want = {o.strip().upper() for o in only if o.strip()}
    unknown = want - set(RULES)
    if unknown:
        raise ValueError(
            f"unknown rule(s) {sorted(unknown)}; known: {sorted(RULES)}")
    return [RULES[k] for k in sorted(want)]


def analyze_source(text: str, rel: str, *,
                   only: Optional[Sequence[str]] = None,
                   config: Optional[dict] = None,
                   count_suppressed: Optional[List[int]] = None,
                   root: Optional[Path] = None) -> List[Finding]:
    """Run the (selected) rules over one in-memory source file.  ``rel``
    decides path-scoped rules (e.g. DET001 only fires under
    src/repro_torch/{core,serve,models,kernels}); ``root`` is the
    checkout whose other files (``csrc/``) a rule may read."""
    ctx = ModuleContext(text, rel, config, root)
    out: List[Finding] = []
    n_sup = 0
    for rule in _load_rules(only):
        for f in rule.check(ctx):
            if ctx.is_suppressed(f):
                n_sup += 1
            else:
                out.append(f)
    if count_suppressed is not None:
        count_suppressed.append(n_sup)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def repo_root() -> Path:
    """The repo this package ships in (src/repro_torch/analysis -> repo)."""
    return Path(__file__).resolve().parents[3]


def iter_py_files(root: Path,
                  paths: Optional[Sequence[str]] = None) -> Iterator[Path]:
    """The ``.py`` files under ``paths`` (files, directories or glob
    patterns relative to ``root``), each once, in a stable order."""
    seen = set()
    for rel in (paths or DEFAULT_PATHS):
        if any(ch in rel for ch in "*?["):
            bases = sorted(root.glob(rel))
        else:
            bases = [root / rel]
        for base in bases:
            base = base.resolve()
            if base.is_file() and base.suffix == ".py":
                found = [base]
            elif base.is_dir():
                found = [p for p in sorted(base.rglob("*.py"))
                         if not any(part.startswith(".")
                                    or part == "__pycache__"
                                    for part in p.relative_to(root).parts)]
            else:
                found = []
            for p in found:
                if p not in seen:
                    seen.add(p)
                    yield p


def run_analysis(root: Optional[Path] = None, *,
                 paths: Optional[Sequence[str]] = None,
                 only: Optional[Sequence[str]] = None,
                 config: Optional[dict] = None) -> Report:
    root = (Path(root) if root else repo_root()).resolve()
    report = Report(root=str(root))
    for path in iter_py_files(root, paths):
        rel = path.relative_to(root).as_posix()
        try:
            text = path.read_text()
            sup: List[int] = []
            found = analyze_source(text, rel, only=only, config=config,
                                   count_suppressed=sup, root=root)
        except (SyntaxError, UnicodeDecodeError) as e:
            report.parse_errors.append(f"{rel}: {e}")
            continue
        report.files_scanned += 1
        report.findings.extend(found)
        report.suppressed += sup[0] if sup else 0
    report.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return report
