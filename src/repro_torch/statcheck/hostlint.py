"""AST lint of the port's host/device split — stdlib-only, no torch import
(port of ``repro.statcheck.hostlint``).

The serve engine's throughput rests on a discipline no type checker sees:
the REQUEST-shaped side (page allocator, prefix index, scheduler, engine
core, lifecycle, faults) is pure host Python and NumPy, and the
DEVICE-shaped side (the backends' model calls) runs on the card. A stray
``torch`` op in the allocator turns O(1) bookkeeping into a device
dispatch (and a sync, if anything reads it back); a
``torch.cuda.synchronize()`` or a per-iteration ``.item()`` in the serve
loop serializes the steps the engine queues back to back, and a CUDA
graph cannot hold either. These are one-line mistakes that survive every
unit test.

Four rules, suppressible per line with ``# statcheck: allow(<rule>)``
(``// statcheck: allow(<rule>)`` in CUDA):

- ``host-torch`` — ``torch`` imported or used in the host-side serve
  modules (``HOST_MODULES``).
- ``host-assert`` — a bare ``assert`` in a host-side serve module: it
  vanishes under ``python -O``, so an accounting violation would corrupt
  state silently; failures are typed (``serve/lifecycle.py``).
- ``host-sync`` — ``torch.cuda.synchronize()`` anywhere in the serve
  modules (``SERVE_MODULES``), and ``.cpu()`` / ``.numpy()`` / ``.item()``
  / ``.tolist()`` on device state (``self._cache``-rooted expressions, or
  names like ``logits``) inside a ``for`` / ``while`` body: a hidden
  per-iteration device-to-host sync.
- ``page-table-clamp`` (the reference's ``blockspec-bounds``) — in the
  kernel modules (``KERNEL_MODULES``), a function that reads a page table
  (a subscript of, or a ``gather`` / ``index_select`` on, a
  ``page_table``) calls a clamp (``clamp``, ``minimum``, ``maximum``,
  ``clip``): an unclamped lookup faults on a stale table instead of
  reading a page of the pool. In the CUDA sources (``CUDA_MODULES``) the
  check is textual: every ``page_table[`` read bounds its index with
  ``min(``, and its page is clamped (``min(max(``) in the statement or
  range-checked (``page >= 0 &&``) within the next two lines.

This module imports nothing beyond the stdlib, so it runs where torch is
not installed (``scripts/run_statcheck_torch.py --lint-only``).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, List, Optional, Set, Tuple

__all__ = ["LintFinding", "lint_file", "lint_cuda", "lint_tree",
           "HOST_MODULES", "SERVE_MODULES", "KERNEL_MODULES", "CUDA_MODULES"]

_SERVE = os.path.join("src", "repro_torch", "serve")
_KERNELS = os.path.join("src", "repro_torch", "kernels")

# modules that must never touch torch: request/page/schedule bookkeeping
HOST_MODULES = tuple(os.path.join(_SERVE, f"{m}.py") for m in (
    "pages", "prefix", "scheduler", "engine", "lifecycle", "faults"))
# modules where the host-sync rule applies (device code allowed)
SERVE_MODULES = (os.path.join(_SERVE, "backend.py"),
                 os.path.join(_SERVE, "sampling.py")) + HOST_MODULES
# modules whose page-table reads are audited
KERNEL_MODULES = tuple(os.path.join(_KERNELS, f"{m}.py") for m in (
    "flash_decode", "flashbias_attn", "ssd_scan", "ops", "io_stub", "ref"))
CUDA_MODULES = (os.path.join("src", "repro_torch", "csrc",
                             "flash_decode.cu"),)

_ALLOW_RE = re.compile(r"(?:#|//)\s*statcheck:\s*allow\(([\w-]+)\)")

# names whose read-back inside a loop is a per-iteration device->host sync
# (heuristic: device-state roots used by the backends)
_DEVICE_ROOTS = ("_cache", "logits", "emissions", "_last_tok")
_READ_BACKS = ("cpu", "numpy", "item", "tolist")
_CLAMPS = ("clamp", "clamp_", "minimum", "maximum", "clip")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.path}:{self.line}: {self.message}"


def _suppressed(source_lines: List[str], line: int, rule: str) -> bool:
    if 1 <= line <= len(source_lines):
        m = _ALLOW_RE.search(source_lines[line - 1])
        if m and m.group(1) == rule:
            return True
    return False


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for nested Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _root(node: ast.AST) -> str:
    """The name a chain of attributes, calls and subscripts starts from
    (``page_table`` for ``page_table.long().gather``), '' otherwise."""
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else ""


def _is_torch(module: str) -> bool:
    return module == "torch" or module.startswith("torch.")


def _torch_aliases(tree: ast.Module) -> Set[str]:
    """Local names bound to torch or a torch submodule by imports."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _is_torch(alias.name):
                    names.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _is_torch(node.module):
            for alias in node.names:
                names.add(alias.asname or alias.name)
    return names


def _check_host_torch(tree: ast.Module, path: str,
                      lines: List[str]) -> List[LintFinding]:
    findings = []
    aliases = _torch_aliases(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""] if node.level == 0 else [])
            for mod in mods:
                if _is_torch(mod) and not _suppressed(lines, node.lineno,
                                                      "host-torch"):
                    findings.append(LintFinding(
                        "host-torch", path, node.lineno,
                        f"host-side module imports '{mod}': allocator and "
                        f"scheduler arithmetic stays Python/NumPy"))
        elif isinstance(node, ast.Name) and node.id in aliases \
                and isinstance(node.ctx, ast.Load) \
                and not _suppressed(lines, node.lineno, "host-torch"):
            findings.append(LintFinding(
                "host-torch", path, node.lineno,
                f"host-side module uses torch-bound name '{node.id}': a "
                f"device dispatch in bookkeeping code"))
    return findings


def _check_host_assert(tree: ast.Module, path: str,
                       lines: List[str]) -> List[LintFinding]:
    """Bare ``assert`` in host serve modules: gone under ``python -O``."""
    return [LintFinding(
        "host-assert", path, node.lineno,
        "bare assert in host serve code: raise a typed serve.lifecycle "
        "error instead (asserts vanish under python -O)")
        for node in ast.walk(tree)
        if isinstance(node, ast.Assert)
        and not _suppressed(lines, node.lineno, "host-assert")]


def _loop_spans(tree: ast.Module) -> List[Tuple[int, int]]:
    return [(node.lineno, getattr(node, "end_lineno", node.lineno))
            for node in ast.walk(tree)
            if isinstance(node, (ast.For, ast.While))]


def _in_spans(line: int, spans: List[Tuple[int, int]]) -> bool:
    return any(lo <= line <= hi for lo, hi in spans)


def _check_host_sync(tree: ast.Module, path: str,
                     lines: List[str]) -> List[LintFinding]:
    findings = []
    spans = _loop_spans(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or _suppressed(lines, node.lineno, "host-sync"):
            continue
        callee = _dotted(node.func)
        if callee.endswith("cuda.synchronize"):
            findings.append(LintFinding(
                "host-sync", path, node.lineno,
                "torch.cuda.synchronize in serve code serializes the "
                "queued steps (benchmarks time; engines don't)"))
            continue
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in _READ_BACKS):
            continue
        receiver = ast.unparse(node.func.value)
        if any(root in receiver for root in _DEVICE_ROOTS) \
                and _in_spans(node.lineno, spans):
            findings.append(LintFinding(
                "host-sync", path, node.lineno,
                f".{node.func.attr}() on device state inside a loop: a "
                f"device->host sync per iteration"))
    return findings


def _reads_page_table(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) \
                and _dotted(node.value).split(".")[-1] == "page_table":
            return True
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in ("gather", "index_select") \
                and _root(node.func.value) == "page_table":
            return True
    return False


def _has_clamp(fn: ast.AST) -> bool:
    return any(isinstance(node, ast.Call)
               and _dotted(node.func).split(".")[-1] in _CLAMPS
               or isinstance(node, ast.Call)
               and isinstance(node.func, ast.Attribute)
               and node.func.attr in _CLAMPS
               for node in ast.walk(fn))


def _check_page_table_clamp(tree: ast.Module, path: str,
                            lines: List[str]) -> List[LintFinding]:
    """Innermost functions that read a page table must clamp."""
    findings = []
    fns = [n for n in ast.walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.Lambda))]
    for fn in fns:
        inner = [n for n in ast.walk(fn) if n is not fn
                 and isinstance(n, (ast.FunctionDef, ast.Lambda))]
        if any(_reads_page_table(n) for n in inner):
            continue                      # judged at the inner function
        if not _reads_page_table(fn) or _has_clamp(fn) \
                or _suppressed(lines, fn.lineno, "page-table-clamp"):
            continue
        findings.append(LintFinding(
            "page-table-clamp", path, fn.lineno,
            f"'{getattr(fn, 'name', '<lambda>')}' reads a page table "
            f"without a clamp (clamp / minimum / maximum / clip): a stale "
            f"table would index out of the pool"))
    return findings


def _bracketed(code: str, start: int) -> Optional[str]:
    """The text inside the bracket opening at ``code[start]``."""
    depth = 0
    for i in range(start, len(code)):
        depth += {"[": 1, "]": -1}.get(code[i], 0)
        if depth == 0:
            return code[start + 1:i]
    return None


def lint_cuda(path: str) -> List[LintFinding]:
    """The textual ``page-table-clamp`` check of one CUDA source."""
    with open(path) as f:
        lines = f.read().splitlines()
    code = [line.split("//")[0] for line in lines]
    findings = []
    for i, line in enumerate(code):
        for m in re.finditer(r"page_table\[", line):
            if _suppressed(lines, i + 1, "page-table-clamp"):
                continue
            index = _bracketed(line, m.end() - 1)
            if index is None or "min(" not in index:
                findings.append(LintFinding(
                    "page-table-clamp", path, i + 1,
                    "page_table read whose block index is not bounded by "
                    "min(): a length past the table reads past its row"))
                continue
            start = i            # the statement: back to the last ';{}'
            while start > 0 and not code[start - 1].rstrip().endswith(
                    (";", "{", "}")):
                start -= 1
            end = i
            while end < len(code) - 1 and not code[end].rstrip().endswith(
                    (";", "{", "}")):
                end += 1
            stmt = " ".join(code[start:end + 1])
            head = stmt[:stmt.index("page_table[")]
            var = re.findall(r"(\w+)\s*=(?!=)", head)
            after = " ".join(code[end + 1:end + 3])
            ok = "min(max(" in head or (var and re.search(
                rf"min\(max\({var[-1]}\b|\b{var[-1]} >= 0 &&", after))
            if not ok:
                findings.append(LintFinding(
                    "page-table-clamp", path, i + 1,
                    "page_table read whose page is neither clamped "
                    "(min(max(...))) nor range-checked (page >= 0 && ...) "
                    "before use: a stale entry indexes out of the pool"))
    return findings


def lint_file(path: str, *, host: bool = False, serve: bool = False,
              kernel: bool = False) -> List[LintFinding]:
    with open(path) as f:
        source = f.read()
    tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    findings: List[LintFinding] = []
    if host:
        findings += _check_host_torch(tree, path, lines)
        findings += _check_host_assert(tree, path, lines)
    if serve:
        findings += _check_host_sync(tree, path, lines)
    if kernel:
        findings += _check_page_table_clamp(tree, path, lines)
    return findings


def lint_tree(root: str,
              host_modules: Iterable[str] = HOST_MODULES,
              serve_modules: Iterable[str] = SERVE_MODULES,
              kernel_modules: Iterable[str] = KERNEL_MODULES,
              cuda_modules: Iterable[str] = CUDA_MODULES,
              ) -> List[LintFinding]:
    """Run every rule over its module set, rooted at ``root`` (the repo
    checkout). Missing files are skipped."""
    host = {os.path.join(root, m) for m in host_modules}
    serve = {os.path.join(root, m) for m in serve_modules}
    kernel = {os.path.join(root, m) for m in kernel_modules}
    findings: List[LintFinding] = []
    for path in sorted(host | serve | kernel):
        if os.path.exists(path):
            findings += lint_file(path, host=path in host,
                                  serve=path in serve,
                                  kernel=path in kernel)
    for m in cuda_modules:
        path = os.path.join(root, m)
        if os.path.exists(path):
            findings += lint_cuda(path)
    return findings
