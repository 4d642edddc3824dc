"""Shared plumbing for the analyzers: findings, sources, suppressions.

Conventions enforced here and reused by every tool:

- A finding is pinned to (path, line) and carries a short ``code``; formatting
  is uniform so CI output greps the same way across analyzers.
- Inline suppressions are ``# <tool>: ok <reason>`` on the offending line.
  The reason is mandatory -- a bare ``# locklint: ok`` does *not* suppress, it
  converts the finding into a ``bad-suppression`` so unexplained exceptions
  can never land silently.
- Guarded-field declarations are ``# guarded by: <lock-attr>`` trailing the
  assignment (works for both ``self.x = ...`` in ``__init__`` and dataclass
  field lines), or a class-level ``_GUARDED = {"field": "_lock"}`` mapping.
"""

from __future__ import annotations

import ast
import io
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence


@dataclass
class Finding:
    tool: str
    path: str
    line: int
    code: str
    message: str
    suppressed: bool = False
    reason: str = ""

    def format(self) -> str:
        tag = f"  [suppressed: {self.reason}]" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.tool}/{self.code}: {self.message}{tag}"

    def to_json(self) -> dict:
        return {
            "tool": self.tool, "path": self.path, "line": self.line,
            "code": self.code, "message": self.message,
            "suppressed": self.suppressed, "reason": self.reason,
        }


@dataclass
class SourceFile:
    """A parsed module plus its comment map (line -> comment text sans '#')."""

    path: str
    text: str
    tree: ast.Module
    comments: Dict[int, str] = field(default_factory=dict)

    @classmethod
    def load(cls, path) -> "SourceFile":
        p = Path(path)
        text = p.read_text()
        return cls.from_text(str(p), text)

    @classmethod
    def from_text(cls, path: str, text: str) -> "SourceFile":
        tree = ast.parse(text, filename=path)
        return cls(path=path, text=text, tree=tree, comments=parse_comments(text))

    def comment_at(self, line: int) -> str:
        return self.comments.get(line, "")


def parse_comments(text: str) -> Dict[int, str]:
    """Map line number -> comment text, via tokenize so '#' inside strings
    never counts as a comment."""
    comments: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                comments[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenError:  # unterminated block at EOF etc. -- best effort
        pass
    return comments


def suppression_reason(src: SourceFile, line: int, tool: str) -> Optional[str]:
    """Return the suppression reason on ``line`` for ``tool``, or None.

    An empty reason returns "" (caller must treat that as *not* suppressed and
    raise a bad-suppression finding instead).
    """
    comment = src.comment_at(line)
    marker = f"{tool}:"
    if not comment.startswith(marker):
        return None
    rest = comment[len(marker):].strip()
    if rest == "ok":
        return ""
    if rest.startswith("ok "):
        return rest[3:].strip()
    return None


def apply_suppression(src: SourceFile, finding: Finding) -> Finding:
    """Mark ``finding`` suppressed if its line carries a reasoned suppression;
    downgrade a reasonless suppression to a loud ``bad-suppression``."""
    reason = suppression_reason(src, finding.line, finding.tool)
    if reason is None:
        return finding
    if not reason:
        finding.code = "bad-suppression"
        finding.message += " (suppression comment present but missing a reason)"
        return finding
    finding.suppressed = True
    finding.reason = reason
    return finding


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on parsed trees
        return "<expr>"


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def guarded_decl(comment: str) -> Optional[str]:
    """Parse a ``# guarded by: <lock-attr>`` trailing comment."""
    marker = "guarded by:"
    if comment.startswith(marker):
        attr = comment[len(marker):].strip().split()[0] if comment[len(marker):].strip() else ""
        return attr or None
    return None


def load_sources(paths: Sequence[str]) -> List[SourceFile]:
    return [SourceFile.load(p) for p in paths]


def unsuppressed(findings: Sequence[Finding]) -> List[Finding]:
    return [f for f in findings if not f.suppressed]


def render_report(findings: Sequence[Finding], *, show_suppressed: bool = False) -> str:
    lines = [f.format() for f in findings if show_suppressed or not f.suppressed]
    return "\n".join(lines)
