#!/usr/bin/env python
"""Self-contained lint gate (no third-party linters required).

Checks every tracked Python file for:
- syntax errors (compile)
- unused imports (AST, module level and function level)
- bare ``except:`` clauses
- tabs in indentation and trailing whitespace
- lines longer than 99 characters

Mirrors the reference's pylama gate (Makefile:20-23) with the rules that
matter for this codebase.  Exit code 1 on any finding.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

MAX_LINE = 99
ROOTS = ["triflow_jax", "tests", "examples", "tools", "bench.py",
         "__graft_entry__.py"]
# names imported for side effects or re-export
ALLOW_UNUSED = {"annotations"}


class ImportTracker(ast.NodeVisitor):
    def __init__(self):
        self.imported = {}  # name -> (lineno, shown)
        self.used = set()

    def visit_Import(self, node):
        for alias in node.names:
            name = alias.asname or alias.name.split(".")[0]
            self.imported[name] = (node.lineno, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        for alias in node.names:
            if alias.name == "*":
                continue
            name = alias.asname or alias.name
            self.imported[name] = (node.lineno, alias.name)
        self.generic_visit(node)

    def visit_Name(self, node):
        self.used.add(node.id)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        # track the base name of dotted access
        base = node
        while isinstance(base, ast.Attribute):
            base = base.value
        if isinstance(base, ast.Name):
            self.used.add(base.id)
        self.generic_visit(node)


def lint_file(path: Path):
    findings = []
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as err:
        return [f"{path}:{err.lineno}: syntax error: {err.msg}"]

    # __init__.py re-export modules keep everything; names listed in
    # __all__ are exports, not unused
    if path.name != "__init__.py":
        exported = set()
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in node.targets)
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                exported = {
                    c.value for c in node.value.elts
                    if isinstance(c, ast.Constant)
                }
        tracker = ImportTracker()
        tracker.visit(tree)
        for name, (lineno, shown) in sorted(tracker.imported.items()):
            if name in ALLOW_UNUSED or name.startswith("_"):
                continue
            if name not in tracker.used and name not in exported:
                findings.append(
                    f"{path}:{lineno}: unused import '{shown}'")

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            findings.append(f"{path}:{node.lineno}: bare 'except:'")

    for i, line in enumerate(src.splitlines(), 1):
        stripped = line.rstrip("\n")
        if stripped != stripped.rstrip():
            findings.append(f"{path}:{i}: trailing whitespace")
        if "\t" in stripped:
            findings.append(f"{path}:{i}: tab character")
        if len(stripped) > MAX_LINE:
            findings.append(
                f"{path}:{i}: line too long ({len(stripped)} > {MAX_LINE})")
    return findings


def main():
    repo = Path(__file__).resolve().parent.parent
    files = []
    for root in ROOTS:
        p = repo / root
        if p.is_file():
            files.append(p)
        elif p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
    findings = []
    for f in files:
        findings.extend(lint_file(f))
    for line in findings:
        print(line)
    print(f"lint: {len(files)} files, {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
