"""Tokenizer for the Stan subset: the port's own copy of
``exmc_tpu/stan/lexer.py`` (pure Python; the same tokens).

Produces (kind, value, line) tuples. Block comments are stripped before
tokenizing (reference stan.ex:86-92); line comments (// and #) here."""

import re

TOKEN_SPEC = [
    ("WS", r"[ \t\r]+"),
    ("NEWLINE", r"\n"),
    ("LINE_COMMENT", r"//[^\n]*|#[^\n]*"),
    ("NUMBER", r"\d+\.\d+([eE][+-]?\d+)?|\d+([eE][+-]?\d+)?"),
    ("IDENT", r"[A-Za-z_][A-Za-z0-9_]*"),
    ("TILDE", r"~"),
    ("LBRACE", r"\{"),
    ("RBRACE", r"\}"),
    ("LBRACKET", r"\["),
    ("RBRACKET", r"\]"),
    ("LPAREN", r"\("),
    ("RPAREN", r"\)"),
    ("LANGLE", r"<"),
    ("RANGLE", r">"),
    ("COMMA", r","),
    ("SEMI", r";"),
    ("PLUSEQ", r"\+="),
    ("EQUALS", r"="),
    ("PLUS", r"\+"),
    ("MINUS", r"-"),
    ("STAR", r"\*"),
    ("SLASH", r"/"),
    ("PIPE", r"\|"),
    ("COLON", r":"),
]

KEYWORDS = {
    "data", "parameters", "model", "real", "int", "vector", "simplex",
    "lower", "upper", "transformed", "for", "in", "target", "matrix",
    "functions", "return", "ordered", "positive_ordered",
    "cholesky_factor_corr", "sum_to_zero_vector",
    "generated", "quantities",
}

_MASTER = re.compile("|".join(f"(?P<{k}>{v})" for k, v in TOKEN_SPEC))
_BLOCK_COMMENT = re.compile(r"/\*.*?\*/", re.DOTALL)


class StanSyntaxError(ValueError):
    def __init__(self, message, line=None, source_line=None):
        self.line = line
        self.source_line = source_line
        ctx = f" (line {line}: {source_line.strip()})" if source_line else (
            f" (line {line})" if line else ""
        )
        super().__init__(message + ctx)


def strip_block_comments(code: str) -> str:
    """Replace /* ... */ with equivalent newlines to keep line numbers."""
    def repl(m):
        return "\n" * m.group(0).count("\n")

    return _BLOCK_COMMENT.sub(repl, code)


def tokenize(code: str):
    code = strip_block_comments(code)
    tokens = []
    line = 1
    pos = 0
    while pos < len(code):
        m = _MASTER.match(code, pos)
        if m is None:
            raise StanSyntaxError(
                f"unexpected character {code[pos]!r}", line=line
            )
        kind = m.lastgroup
        text = m.group(0)
        pos = m.end()
        if kind == "NEWLINE":
            line += 1
            continue
        if kind in ("WS", "LINE_COMMENT"):
            continue
        if kind == "IDENT" and text in KEYWORDS:
            tokens.append((text.upper(), text, line))
        elif kind == "NUMBER":
            tokens.append(("NUMBER", float(text), line))
        else:
            tokens.append((kind, text, line))
    tokens.append(("EOF", None, line))
    return tokens
