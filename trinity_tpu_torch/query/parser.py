# Copy of trinity_tpu/query/parser.py; only its imports name the port.
"""Query parser: tokenizer + precedence-climbing parser.

Faithful re-implementation of the reference's recursive-descent parser
(queries.cpp:396-538): ``parse_subexpr(limit)`` loops while the next
operator's priority is *below* ``limit`` and recurses with that priority —
reproducing the reference's exact (unconventional) associativity where
OR (prio 7) binds tighter than AND (prio 8) inside a right operand:
``a AND b OR c`` parses as ``a AND (b OR c)`` and ``a OR b AND c`` as
``(a OR b) AND c``. Operator surface (queries.cpp:174-222):

- keywords ``AND`` (-> STRICT_AND), ``OR``, ``NOT`` when followed by a
  separator, unless the corresponding *AsToken flag is set;
- ``|``/``||`` -> OR; ``+tok`` -> STRICT_AND; ``-tok`` -> NOT;
- adjacency -> implicit AND;
- ``"..."`` -> phrase (<= MaxPhraseSize terms, extra silently dropped,
  queries.cpp:70-118); ``( )`` groups; ``<expr>`` -> ConstTrueExpr and
  ``[a,b,c]`` -> MatchSome(min=1) when the respective flags are on
  (queries.cpp:403-452);
- parse-time dedup: ``apple AND apple`` -> rep=2 (queries.cpp:509-515).

The token parser is pluggable like the reference's ``token_parser`` hook
(queries.h:247); the default mirrors default_token_parser_impl
(queries.cpp:2098+): acronym collapse (``I.B.M`` -> ``IBM``), alnum runs,
post-token dash skipping ("san francisco-based").
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from trinity_tpu_torch.limits import MAX_PHRASE_SIZE, MAX_TERM_LENGTH
from trinity_tpu_torch.query.ast import (
    BinOp,
    ConstFalse,
    ConstTrueExpr,
    Dummy,
    MatchSome,
    Node,
    Op,
    Phrase,
    Term,
    Token,
    UnaryOp,
    node_to_str,
)

UNARY_OPERATOR_PRIO = 100  # queries.h:7


class ParserFlags(enum.IntFlag):
    NONE = 0
    OR_AS_TOKEN = 1
    NOT_AS_TOKEN = 2
    AND_AS_TOKEN = 4
    PARSE_CONST_TRUE_EXPR = 8
    PARSE_MATCH_SOME_EXPR = 16


def _op_prio(op: Op) -> int:
    # queries.cpp:11-27
    if op in (Op.STRICT_AND, Op.AND, Op.NOT):
        return 8
    if op is Op.OR:
        return 7
    return 0


# --------------------------------------------------------------- tokenizer
def default_token_parser(content: str, in_phrase: bool) -> Tuple[int, str]:
    """Returns (chars consumed, token text); token may be empty while chars
    were consumed (skip). Mirrors default_token_parser_impl semantics for the
    common cases (queries.cpp:2098+)."""
    n = len(content)
    if n == 0:
        return 0, ""
    # acronym: X.Y.Z... -> XYZ
    if (
        n > 4
        and content[0].isalpha()
        and content[1] == "."
        and content[2].isalnum()
        and content[3] == "."
        and content[4].isalpha()
    ):
        out = [content[0], content[2]]
        i = 4
        while i < n:
            j = i
            while j < n and content[j].isalpha():
                j += 1
            out.extend(content[i:j])
            i = j
            if i < n and content[i] == ".":
                i += 1
            else:
                break
        return i, "".join(out)
    if not content[0].isalnum():
        return 1, ""
    i = 0
    while i < n and content[i].isalnum():
        i += 1
    return i, content[:i]


TokenParser = Callable[[str, bool], Tuple[int, str]]


# ------------------------------------------------------------------ parser
@dataclass
class _Ctx:
    content: str
    pos: int = 0
    flags: ParserFlags = ParserFlags.NONE
    token_parser: TokenParser = default_token_parser
    group_term: List[str] = field(default_factory=list)
    distinct_tokens: List[str] = field(default_factory=list)

    @property
    def rest(self) -> str:
        return self.content[self.pos :]

    def skip_ws(self):
        while self.pos < len(self.content) and self.content[self.pos].isspace():
            self.pos += 1

    def strip_prefix(self, s: str) -> bool:
        if self.content.startswith(s, self.pos):
            self.pos += len(s)
            return True
        return False

    def track_term(self, t: str) -> str:
        # string interning analog (queries.cpp:543-555)
        if t not in self.distinct_tokens:
            self.distinct_tokens.append(t)
        return t

    def fail_node(self) -> Node:
        return Dummy()


_SEPARATORS = set(" \t-+(.)")


def _try_strip_keyword(ctx: _Ctx, kw: str) -> int:
    """try_strip_token (queries.cpp:153-172): keyword must be followed by a
    separator or end. Returns consumed length (keyword + 1 separator skip as
    in parse_operator_impl) or 0."""
    if not ctx.content.startswith(kw, ctx.pos):
        return 0
    after = ctx.pos + len(kw)
    if after < len(ctx.content) and ctx.content[after] not in _SEPARATORS:
        return 0
    # parse_operator_impl then requires a following non-alnum char which it
    # consumes (queries.cpp:220-223); at end-of-input the operator is void.
    if after >= len(ctx.content):
        return 0
    if ctx.content[after].isalnum():
        return 0
    return len(kw) + 1


def _parse_operator(ctx: _Ctx) -> Tuple[Op, int]:
    """parse_operator_impl (queries.cpp:174-222). Returns (op, consumed)."""
    ctx.skip_ws()
    s = ctx.rest
    if not (ctx.flags & ParserFlags.AND_AS_TOKEN):
        if n := _try_strip_keyword(ctx, "AND"):
            return Op.STRICT_AND, n
    if not (ctx.flags & ParserFlags.OR_AS_TOKEN):
        if n := _try_strip_keyword(ctx, "OR"):
            return Op.OR, n
    if not (ctx.flags & ParserFlags.NOT_AS_TOKEN):
        if n := _try_strip_keyword(ctx, "NOT"):
            return Op.NOT, n
    if not s:
        return Op.NONE, 0
    f = s[0]
    if f == "|":
        i = 0
        while i < len(s) and s[i] == "|":
            i += 1
        return Op.OR, i
    if f == "+":
        if len(s) > 1 and not s[1].isspace() and s[1] != "+":
            return Op.STRICT_AND, 1
    if f == "-":
        if len(s) > 1 and (s[1] == '"' or s[1].isalnum()):
            return Op.NOT, 1
        return Op.AND, 1
    if ctx.group_term and f in ctx.group_term[-1]:
        return Op.NONE, 0
    return Op.AND, 0


def _parse_term(ctx: _Ctx, in_phrase: bool) -> Optional[str]:
    """parse_term (queries.cpp:29-68): skip non-token content, honor group
    terminators, strip trailing dashes."""
    while True:
        consumed, tok = ctx.token_parser(ctx.rest, in_phrase)
        if tok:
            ctx.pos += consumed
            while ctx.pos < len(ctx.content) and ctx.content[ctx.pos] == "-":
                ctx.pos += 1
            if len(tok) > MAX_TERM_LENGTH:
                return None
            return tok
        if consumed:
            ctx.pos += consumed
            continue
        if ctx.pos >= len(ctx.content) or (
            ctx.group_term and ctx.content[ctx.pos] in ctx.group_term[-1]
        ):
            return None
        ctx.pos += 1


def _parse_phrase_or_token(ctx: _Ctx) -> Optional[Node]:
    """queries.cpp:70-150."""
    ctx.skip_ws()
    if ctx.strip_prefix('"'):
        terms: List[Term] = []
        while True:
            ctx.skip_ws()
            if ctx.pos >= len(ctx.content) or ctx.strip_prefix('"'):
                break
            tok = _parse_term(ctx, True)
            if tok is not None:
                if len(terms) < MAX_PHRASE_SIZE:  # extras silently ignored
                    terms.append(Term(ctx.track_term(tok)))
            elif ctx.pos < len(ctx.content) and ctx.content[ctx.pos] != '"':
                ctx.pos += 1
        if not terms:
            return None
        return Phrase(terms=terms, is_phrase=True)
    tok = _parse_term(ctx, False)
    if tok is None:
        return None
    return Token(ctx.track_term(tok))


def _parse_unary(ctx: _Ctx) -> Node:
    """parse_unary (queries.cpp:396-487)."""
    ctx.skip_ws()
    if ctx.flags & ParserFlags.PARSE_CONST_TRUE_EXPR and ctx.strip_prefix("<"):
        ctx.group_term.append(">")
        e = _parse_expr(ctx) or ctx.fail_node()
        ctx.skip_ws()
        if not ctx.strip_prefix(">"):
            if not isinstance(e, Dummy):
                e = ctx.fail_node()
        else:
            ctx.group_term.pop()
        return ConstTrueExpr(e)
    if ctx.flags & ParserFlags.PARSE_MATCH_SOME_EXPR and ctx.strip_prefix("["):
        nodes: List[Node] = []
        ctx.group_term.append("],")
        while True:
            ctx.skip_ws()
            e = _parse_expr(ctx)
            ctx.skip_ws()
            if ctx.strip_prefix("]"):
                if e is not None:
                    nodes.append(e)
                ctx.group_term.pop()
                break
            if ctx.strip_prefix(","):
                nodes.append(e or ctx.fail_node())
            else:
                ctx.group_term.pop()
                return ctx.fail_node()
        # `]/k` suffix sets min (k-of-n). The reference parser hardcodes
        # min=1 (queries.cpp:450 make_match_some(..., 1)) and exposes k
        # only programmatically (queries.h:141-156 make_match_some); this
        # text form matches ast.node_to_str's round-trip format.
        k = 1
        if ctx.strip_prefix("/"):
            digits = ""
            while ctx.pos < len(ctx.content) and ctx.content[ctx.pos].isdigit():
                digits += ctx.content[ctx.pos]
                ctx.pos += 1
            if digits:
                k = max(1, min(int(digits), len(nodes)))
        return MatchSome(nodes=nodes, min=k)
    if ctx.strip_prefix("("):
        ctx.group_term.append(")")
        e = _parse_expr(ctx) or ctx.fail_node()
        ctx.skip_ws()
        if not ctx.strip_prefix(")"):
            if not isinstance(e, Dummy):
                e = ctx.fail_node()
        else:
            ctx.group_term.pop()
        return e
    op, consumed = _parse_operator(ctx)
    if op not in (Op.NONE, Op.AND):
        ctx.pos += consumed
        ctx.skip_ws()
        expr = _parse_phrase_or_token(ctx) or ctx.fail_node()
        return UnaryOp(op, expr)
    n = _parse_phrase_or_token(ctx)
    return n if n is not None else ctx.fail_node()


def _unary_same_type(a: Node, b: Node) -> bool:
    return (
        isinstance(a, Phrase)
        and isinstance(b, Phrase)
        and a.is_phrase == b.is_phrase
        and a.same(b)
    )


def _parse_subexpr(ctx: _Ctx, limit: int) -> Node:
    """parse_subexpr (queries.cpp:489-538) — note the `prio < limit` loop."""
    cur = _parse_unary(ctx)
    while True:
        op, consumed = _parse_operator(ctx)
        if op is Op.NONE:
            break
        prio = _op_prio(op)
        if prio >= limit:
            break
        ctx.pos += consumed
        ctx.skip_ws()
        v = _parse_subexpr(ctx, prio)
        if op is Op.AND and _unary_same_type(cur, v):
            cur.rep += v.rep  # [apple AND apple] -> rep=2
        elif (
            op is Op.AND
            and isinstance(cur, BinOp)
            and cur.op is Op.AND
            and _unary_same_type(cur.rhs, v)
        ):
            cur.rhs.rep += v.rep
        else:
            cur = BinOp(op, cur, v)
    return cur


def _parse_expr(ctx: _Ctx) -> Optional[Node]:
    ctx.skip_ws()
    if ctx.pos >= len(ctx.content):
        return None
    return _parse_subexpr(ctx, UNARY_OPERATOR_PRIO)


@dataclass
class Query:
    """A parsed query: root AST + metadata (queries.h:500+ `query`)."""

    root: Optional[Node]
    tokens_count: int = 0  # assigned by normalize

    def __bool__(self) -> bool:
        return self.root is not None

    def __str__(self) -> str:
        return node_to_str(self.root) if self.root else "<empty>"

    def normalize(self) -> "Query":
        from trinity_tpu_torch.query.normalize import normalize_root

        self.root, self.tokens_count = normalize_root(self.root)
        return self

    def leader_nodes(self):
        """query::leader_nodes analog (queries.cpp:1464-1497, 1787)."""
        from trinity_tpu_torch.query.introspect import leader_nodes

        return leader_nodes(self.root)

    def subexpressions_offsets(self):
        """query::subexpressions_offsets analog (queries.cpp:1923-1989);
        tokens_count plays final_index (both are normalize()'s counter)."""
        from trinity_tpu_torch.query.introspect import subexpressions_offsets

        return subexpressions_offsets(self.root, self.tokens_count)

    def subexpressions_count(self) -> int:
        from trinity_tpu_torch.query.introspect import subexpressions_count

        return subexpressions_count(self.root, self.tokens_count)


def parse_query(
    text: str,
    flags: ParserFlags = ParserFlags.PARSE_CONST_TRUE_EXPR
    | ParserFlags.PARSE_MATCH_SOME_EXPR,
    token_parser: TokenParser = default_token_parser,
    normalize: bool = True,
) -> Query:
    """query::parse analog (queries.h:540-583, queries.cpp:558-570)."""
    ctx = _Ctx(content=text, flags=flags, token_parser=token_parser)
    root = _parse_expr(ctx)
    q = Query(root=root)
    if normalize and root is not None:
        q.normalize()
    return q
