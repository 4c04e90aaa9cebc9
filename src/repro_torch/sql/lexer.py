"""SQL tokenizer with line/column tracking.

Produces a flat token list for the recursive-descent parser.  Comments
(``-- ...`` and ``/* ... */``) are skipped; optimizer hints (``/*+ ... */``)
become ``HINT`` tokens so the parser can attach them to the preceding
predicate or the enclosing SELECT.  All errors are :class:`SqlError` with the
1-based line and column of the offending character.
"""
from __future__ import annotations

import dataclasses

__all__ = ["SqlError", "Token", "tokenize", "KEYWORDS"]


class SqlError(Exception):
    """A lexing/parsing/binding error, carrying source position.

    ``str(e)`` renders ``message (line L, col C)`` so test suites and users
    can pinpoint the offending token without re-deriving offsets.
    """

    def __init__(self, message: str, line: int | None = None,
                 col: int | None = None):
        self.message = message
        self.line = line
        self.col = col
        where = f" (line {line}, col {col})" if line is not None else ""
        super().__init__(f"{message}{where}")


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str       # KEYWORD | NAME | NUMBER | STRING | OP | PARAM | HINT | EOF
    value: str
    line: int
    col: int


KEYWORDS = frozenset("""
    select from where group by having order asc desc limit as and or not in
    exists between like case when then else end is null distinct join inner
    left outer on with interval year month day date cast sum count min max
    avg extract substring declare default int float true false
""".split())

_MULTI_OPS = ("<>", "<=", ">=", "!=", "||")
_SINGLE_OPS = "+-*/%(),.<>=:;"


def tokenize(text: str) -> list[Token]:
    toks: list[Token] = []
    i, line, col = 0, 1, 1
    n = len(text)

    def err(msg: str) -> SqlError:
        return SqlError(msg, line, col)

    while i < n:
        ch = text[i]
        if ch == "\n":
            i += 1
            line += 1
            col = 1
            continue
        if ch in " \t\r":
            i += 1
            col += 1
            continue
        if text.startswith("--", i):
            j = text.find("\n", i)
            i = n if j < 0 else j
            continue
        if text.startswith("/*", i):
            is_hint = text.startswith("/*+", i)
            j = text.find("*/", i)
            if j < 0:
                raise err("unterminated comment")
            if is_hint:
                toks.append(Token("HINT", text[i + 3:j].strip(), line, col))
            skipped = text[i:j + 2]
            nl = skipped.count("\n")
            if nl:
                line += nl
                col = len(skipped) - skipped.rfind("\n")
            else:
                col += len(skipped)
            i = j + 2
            continue
        if ch == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise err("unterminated string literal")
                if text[j] == "'":
                    if j + 1 < n and text[j + 1] == "'":   # '' escape
                        buf.append("'")
                        j += 2
                        continue
                    break
                if text[j] == "\n":
                    raise err("newline in string literal")
                buf.append(text[j])
                j += 1
            toks.append(Token("STRING", "".join(buf), line, col))
            col += j + 1 - i
            i = j + 1
            continue
        if ch.isdigit() or (ch == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (text[j].isdigit() or (text[j] == "." and not seen_dot)):
                if text[j] == ".":
                    # "1." followed by non-digit is NUMBER then OP "."
                    if j + 1 >= n or not text[j + 1].isdigit():
                        break
                    seen_dot = True
                j += 1
            # scientific notation: 1e-12, 2.5E+3, 1e6 (exponent digits required)
            if j < n and text[j] in "eE":
                k = j + 1
                if k < n and text[k] in "+-":
                    k += 1
                if k < n and text[k].isdigit():
                    while k < n and text[k].isdigit():
                        k += 1
                    j = k
            toks.append(Token("NUMBER", text[i:j], line, col))
            col += j - i
            i = j
            continue
        if ch.isalpha() or ch == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            kind = "KEYWORD" if word.lower() in KEYWORDS else "NAME"
            toks.append(Token(kind, word.lower() if kind == "KEYWORD" else word,
                              line, col))
            col += j - i
            i = j
            continue
        if ch == ":" and i + 1 < n and (text[i + 1].isalpha() or text[i + 1] == "_"):
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            toks.append(Token("PARAM", text[i + 1:j], line, col))
            col += j - i
            i = j
            continue
        two = text[i:i + 2]
        if two in _MULTI_OPS:
            toks.append(Token("OP", two, line, col))
            i += 2
            col += 2
            continue
        if ch in _SINGLE_OPS:
            toks.append(Token("OP", ch, line, col))
            i += 1
            col += 1
            continue
        raise err(f"unexpected character {ch!r}")

    toks.append(Token("EOF", "", line, col))
    return toks
