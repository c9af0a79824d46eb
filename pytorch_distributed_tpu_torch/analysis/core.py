"""graftlint core: findings, the rule registry, suppressions, module model.

Port of ``pytorch_distributed_tpu/analysis/core.py``. The analyzer is pure
stdlib ``ast``: it never imports the code it checks, so it runs in
seconds over the whole tree and needs neither torch nor a card. Rules receive a
:class:`Module` (parsed tree + import map + parent links + suppression
table) and yield :class:`Finding` objects; the engine handles per-line
suppression (``# graftlint: disable=rule``), justification enforcement,
and baseline subtraction.

Two passes, as in the reference. What the torch rules need across files
is which functions return a tensor on the card: a module-level function
whose every ``return`` is card-resident (a tensor op, a ``.to(device)``,
a module call; see ``astutil.Provenance``). The first pass
(:func:`build_project_index`) records those per module, so that in
another file ``from m import attend`` / ``out = attend(q, k, v)`` gives
``out`` card provenance and ``out.item()`` in a step loop is caught. The
reference's index held ``jax.jit`` bindings' donation and static-argument
contracts instead; the port has no jit.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import (
    Dict, Iterable, Iterator, List, Optional, Sequence, Set, Type,
)

__all__ = [
    "Finding",
    "Rule",
    "Module",
    "ProjectIndex",
    "module_name_for_path",
    "build_project_index",
    "register",
    "all_rules",
    "get_rules",
    "analyze_source",
    "analyze_paths",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: a rule firing at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    symbol: str = ""  # enclosing function/class qualname ("" at module scope)

    def fingerprint(self) -> str:
        """Line-insensitive identity: baselines survive unrelated edits."""
        return f"{self.rule}::{self.path}::{self.symbol}::{self.message}"

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        sym = f" [in {self.symbol}]" if self.symbol else ""
        return f"{loc}: {self.rule}: {self.message}{sym}"


class Rule:
    """Base class: subclass, set ``name``/``description``, implement
    ``check``. Register with the ``@register`` decorator."""

    name: str = ""
    description: str = ""

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}

    def check(self, module: "Module") -> Iterator[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    if not cls.name:
        raise ValueError(f"rule class {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def all_rules() -> Dict[str, Type[Rule]]:
    # import-for-effect: rule modules self-register
    from pytorch_distributed_tpu_torch.analysis import rules as _rules  # noqa: F401

    return dict(_REGISTRY)


def get_rules(config: Optional[dict] = None) -> List[Rule]:
    """Instantiate the enabled rule set for ``config`` (see config.py)."""
    config = config or {}
    registry = all_rules()
    enabled = config.get("enable") or sorted(registry)
    disabled = set(config.get("disable") or ())
    unknown = [r for r in list(enabled) + list(disabled) if r not in registry]
    if unknown:
        raise ValueError(
            f"unknown rule(s) {unknown} — known: {sorted(registry)}"
        )
    return [
        registry[name](config) for name in enabled if name not in disabled
    ]


# -- suppressions ----------------------------------------------------------
_DIRECTIVE = re.compile(
    # rule list: comma-separated names; must not eat the ` -- reason`
    # separator (rule names never contain spaces)
    r"#\s*graftlint:\s*(disable(?:-next-line)?)"
    r"(?:=([\w\-]+(?:\s*,\s*[\w\-]+)*))?"
    r"(?:\s+--\s*(\S.*))?"
)


@dataclasses.dataclass
class Suppression:
    """One parsed directive.

    Same-line form::

        x = t.item()  # graftlint: disable=host-sync-in-hot-loop -- why

    Next-line form (directive on its own line, covers the line below)::

        # graftlint: disable-next-line=rule-a,rule-b -- why

    ``disable`` with no ``=rules`` disables every rule on that line.
    """

    line: int            # line the directive applies to
    directive_line: int  # line the comment sits on
    rules: Optional[frozenset]  # None = all rules
    justified: bool

    def covers(self, finding: Finding) -> bool:
        return self.rules is None or finding.rule in self.rules


def _parse_suppressions(source: str) -> Dict[int, Suppression]:
    # real COMMENT tokens only: a directive spelled out inside a
    # docstring (e.g. usage examples) is documentation, not a directive
    try:
        comments = [
            (tok.start[0], tok.string)
            for tok in tokenize.generate_tokens(io.StringIO(source).readline)
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # unparseable for the tokenizer (analyze_source reports the
        # syntax error separately): fall back to raw line scanning
        comments = list(enumerate(source.splitlines(), start=1))
    out: Dict[int, Suppression] = {}
    for i, text in comments:
        m = _DIRECTIVE.search(text)
        if not m:
            continue
        kind, rules_s, reason = m.groups()
        rules = None
        if rules_s:
            rules = frozenset(
                r.strip() for r in rules_s.split(",") if r.strip()
            )
        target = i + 1 if kind == "disable-next-line" else i
        out[target] = Suppression(
            line=target, directive_line=i, rules=rules,
            justified=bool(reason),
        )
    return out


# -- cross-file index ------------------------------------------------------
def module_name_for_path(path: str) -> str:
    """Dotted module name for a repo-relative ``.py`` path. Purely
    lexical (``a/b/c.py`` -> ``a.b.c``, ``a/b/__init__.py`` -> ``a.b``):
    correct whenever analysis runs from the repo root, which is how the
    CLI and the tests invoke it."""
    name = path.replace(os.sep, "/").strip("/")
    if name.endswith(".py"):
        name = name[:-3]
    name = name.replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


class ProjectIndex:
    """Cross-file table of card-returning functions, built in
    ``analyze_paths``' first pass: dotted module name -> the names of its
    module-level functions whose every ``return`` is card-resident.

    This is what lets the host-sync rule see THROUGH imports:
    ``def attend(q, k, v): return F.scaled_dot_product_attention(q, k,
    v)`` in one file and ``from m import attend`` + ``attend(...).item()``
    in a step loop of another is the per-step sync the per-module pass is
    blind to."""

    def __init__(self):
        self._modules: Dict[str, Set[str]] = {}

    def add_module(self, module_name: str, names: Iterable[str]) -> None:
        self._modules[module_name] = set(names)

    def get(self, module_name: str, name: str) -> bool:
        return name in self._modules.get(module_name, ())

    def table(self, module_name: str) -> Set[str]:
        return self._modules.get(module_name, set())

    def __len__(self) -> int:
        return sum(len(t) for t in self._modules.values())


# -- module model ----------------------------------------------------------
class Module:
    """A parsed source file plus the cross-rule shared indexes.

    ``project`` (set by ``analyze_paths``, None for single-file analysis)
    is the :class:`ProjectIndex` over every file in the run: rules use it
    to resolve imported card-returning functions."""

    def __init__(self, path: str, source: str, tree: ast.AST,
                 project: Optional[ProjectIndex] = None):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.project = project
        self.suppressions = _parse_suppressions(source)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.imports = self._collect_imports(tree, path)

    @staticmethod
    def _collect_imports(tree: ast.AST, path: str = "") -> Dict[str, str]:
        """alias -> fully dotted module/object path.

        Relative imports (``from .mod import f``, ``from ..pkg import
        g``) are expanded against the module's own package, derived
        lexically from ``path`` (the convention of
        :func:`module_name_for_path`), so they land on the absolute dotted
        names the cross-file :class:`ProjectIndex` is keyed by. A relative
        import that climbs past the analyzed root stays unresolved
        (dropped) rather than guessed."""
        parts = module_name_for_path(path).split(".") if path else []
        is_pkg = path.replace(os.sep, "/").endswith("__init__.py")
        pkg_parts = parts if is_pkg else parts[:-1]
        imports: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    up = node.level - 1
                    if up > len(pkg_parts):
                        continue
                    base = pkg_parts[: len(pkg_parts) - up]
                    module = ".".join(
                        base + ([node.module] if node.module else [])
                    )
                    if not module:
                        continue
                elif node.module:
                    module = node.module
                else:
                    continue
                for a in node.names:
                    imports[a.asname or a.name] = f"{module}.{a.name}"
        return imports

    # -- name resolution ---------------------------------------------------
    def dotted(self, node: ast.AST) -> Optional[str]:
        """``a.b.c`` for a Name/Attribute chain, else None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return None

    _CANON = (
        ("torch.nn.functional.", "F."),
        ("torch.distributed.", "dist."),
        ("numpy.", "np."),
    )

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path with the leading alias mapped through the import
        table, canonicalized (torch.nn.functional -> F, torch.distributed
        -> dist, numpy -> np) so rules match one spelling."""
        dotted = self.dotted(node)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        full = self.imports.get(head, head)
        qual = f"{full}.{rest}" if rest else full
        for prefix, canon in self._CANON:
            if qual.startswith(prefix):
                qual = canon + qual[len(prefix):]
            elif qual == prefix[:-1]:
                qual = canon[:-1]
        return qual

    # -- scope helpers -----------------------------------------------------
    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first chain of enclosing function defs."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def symbol_for(self, node: ast.AST) -> str:
        parts = []
        cur = self.parents.get(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            parts.append(node.name)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts))

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=rule,
            path=self.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            symbol=self.symbol_for(node),
        )


# -- analysis entry points -------------------------------------------------
@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    suppressed: List[Finding]
    files: int

    @property
    def clean(self) -> bool:
        return not self.findings


def analyze_source(
    path: str, source: str, rules: Sequence[Rule],
    require_justification: bool = True,
    project: Optional[ProjectIndex] = None,
) -> AnalysisResult:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return AnalysisResult(
            findings=[Finding(
                rule="parse-error", path=path, line=e.lineno or 1,
                col=(e.offset or 0) + 1, message=f"syntax error: {e.msg}",
            )],
            suppressed=[], files=1,
        )
    module = Module(path, source, tree, project=project)
    raw: List[Finding] = []
    for rule in rules:
        raw.extend(rule.check(module))

    findings: List[Finding] = []
    suppressed: List[Finding] = []
    used: set = set()
    for f in raw:
        sup = module.suppressions.get(f.line)
        if sup is not None and sup.covers(f):
            suppressed.append(f)
            used.add(sup.directive_line)
        else:
            findings.append(f)

    if require_justification:
        run_names = {r.name for r in rules}
        for sup in module.suppressions.values():
            if sup.directive_line in used:
                if not sup.justified:
                    findings.append(Finding(
                        rule="unjustified-suppression", path=path,
                        line=sup.directive_line, col=1,
                        message=(
                            "suppression without justification — append "
                            "'-- <why this is safe>' to the directive"
                        ),
                    ))
            elif sup.rules is None or sup.rules & run_names:
                # only when the named rules actually ran: a partial
                # --rules invocation must not flag directives for the
                # rules it skipped
                findings.append(Finding(
                    rule="unused-suppression", path=path,
                    line=sup.directive_line, col=1,
                    message=(
                        "suppression matches no finding — remove the "
                        "stale directive"
                    ),
                ))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return AnalysisResult(findings=findings, suppressed=suppressed, files=1)


def _iter_py_files(paths: Iterable[str], excludes: Sequence[str]) -> Iterator[str]:
    norm_excludes = [e.strip("/").replace("\\", "/") for e in excludes]

    def excluded(rel: str) -> bool:
        rel = rel.replace(os.sep, "/")
        return any(
            rel == e or rel.startswith(e + "/") or f"/{e}/" in f"/{rel}/"
            for e in norm_excludes
        )

    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py") and not excluded(os.path.normpath(p)):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if not d.startswith(".") and d != "__pycache__"
                    and not excluded(os.path.relpath(os.path.join(root, d)))
                )
                for name in sorted(files):
                    full = os.path.join(root, name)
                    if name.endswith(".py") and not excluded(
                        os.path.relpath(full)
                    ):
                        yield full


def build_project_index(
    sources: Sequence[tuple],
) -> ProjectIndex:
    """First pass over ``[(rel_path, source), ...]``: index every file's
    module-level card-returning functions so the rule pass resolves them
    through imports. Unparseable files are simply absent (the rule pass
    reports their syntax error)."""
    # function-local import: astutil imports this module at toplevel
    from pytorch_distributed_tpu_torch.analysis import astutil

    project = ProjectIndex()
    for rel, source in sources:
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError:
            continue
        module = Module(rel, source, tree)
        project.add_module(
            module_name_for_path(rel), astutil.device_functions(module)
        )
    return project


def analyze_paths(
    paths: Sequence[str], rules: Sequence[Rule],
    excludes: Sequence[str] = (),
    require_justification: bool = True,
    only_files: Optional[Sequence[str]] = None,
) -> AnalysisResult:
    """Analyze every ``.py`` file under ``paths``.

    ``only_files`` (absolute paths) restricts the RULE pass to those
    files (the ``--changed-only`` pre-commit mode), while the cross-file
    :class:`ProjectIndex` is still built over everything discovered, so
    card-returning functions imported from *unchanged* files keep
    resolving."""
    only = (
        None if only_files is None
        else {os.path.abspath(p) for p in only_files}
    )
    sources = []
    for path in _iter_py_files(paths, excludes):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        rel = os.path.relpath(path).replace(os.sep, "/")
        sources.append((rel, source, os.path.abspath(path)))
    project = build_project_index([(r, s) for r, s, _ in sources])
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    files = 0
    for rel, source, abspath in sources:
        if only is not None and abspath not in only:
            continue
        res = analyze_source(
            rel, source, rules,
            require_justification=require_justification, project=project,
        )
        findings.extend(res.findings)
        suppressed.extend(res.suppressed)
        files += 1
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return AnalysisResult(
        findings=findings, suppressed=suppressed, files=files
    )
