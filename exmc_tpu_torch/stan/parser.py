"""Recursive-descent parser for the Stan subset: the port's own copy of
``exmc_tpu/stan/parser.py`` (pure Python; the same AST)
(reference src/exmc_stan_parser.yrl grammar; round 2 EXCEEDS the
reference's stated limits, stan.ex:31-36 — ``target +=``, for loops,
transformed data/parameters, matrix type, indexing, _lpdf calls).

AST shape (reference stan/ast.ex):
    {"data": [decl...], "parameters": [decl...],
     "transformed_data": [assign...], "transformed_parameters": [assign...],
     "model": [stmt...]}
decl   = {"name", "type" ("real"|"int"|"vector"|"simplex"|"matrix"),
          "size" (int|str|None), "size2", "lower", "upper"}
assign = decl + {"expr": expr}
stmt   = sampling: {"kind": "sampling", "target": str|("index",name,expr),
                    "dist": str, "args": [expr...], "line"}
         target:   {"kind": "target", "expr": expr, "line"}
         for:      {"kind": "for", "var", "lo", "hi", "body": [stmt...],
                    "line"}
expr   = number | str | ("binop", op, l, r) | ("neg", x)
         | ("call", fn, [arg_expr...]) | ("index", name, expr)
         | ("lpdf", dist, value_expr, [arg_expr...])
fn_def = {"name", "params": [str...], "body": expr, "line"}
         (functions block; single-return expression functions, inlined)
"""

from exmc_tpu_torch.stan.lexer import StanSyntaxError, tokenize


class Parser:
    def __init__(self, tokens, source_lines=None):
        self.tokens = tokens
        self.pos = 0
        self.source_lines = source_lines or []

    def peek(self):
        return self.tokens[self.pos]

    def next(self):
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def error(self, msg, line=None):
        if line is None:
            line = self.peek()[2]
        src = (
            self.source_lines[line - 1]
            if 0 < line <= len(self.source_lines)
            else None
        )
        raise StanSyntaxError(msg, line=line, source_line=src)

    def expect(self, kind):
        tok = self.next()
        if tok[0] != kind:
            self.error(f"expected {kind}, got {tok[1]!r}", line=tok[2])
        return tok

    def parse_program(self):
        ast = {"data": [], "parameters": [], "model": [],
               "transformed_data": [], "transformed_parameters": [],
               "functions": [], "generated_quantities": []}
        while self.peek()[0] != "EOF":
            kind, _, line = self.peek()
            if kind == "FUNCTIONS":
                self.next()
                ast["functions"] = self.parse_functions_block()
            elif kind == "DATA":
                self.next()
                ast["data"] = self.parse_decl_block()
            elif kind == "PARAMETERS":
                self.next()
                # stanc rejects integer parameters (HMC needs a
                # continuous support) — so do we
                ast["parameters"] = self.parse_decl_block(allow_int=False)
            elif kind == "TRANSFORMED":
                self.next()
                sub = self.next()
                if sub[0] == "DATA":
                    ast["transformed_data"] = self.parse_assign_block()
                elif sub[0] == "PARAMETERS":
                    ast["transformed_parameters"] = self.parse_assign_block()
                else:
                    self.error("expected 'data' or 'parameters' after "
                               "'transformed'", line=sub[2])
            elif kind == "MODEL":
                self.next()
                ast["model"] = self.parse_model_block()
            elif kind == "GENERATED":
                self.next()
                sub = self.next()
                if sub[0] != "QUANTITIES":
                    self.error("expected 'quantities' after 'generated'",
                               line=sub[2])
                ast["generated_quantities"] = self.parse_assign_block()
            else:
                self.error(f"expected a block keyword, got {self.peek()[1]!r}")
        return ast

    def parse_functions_block(self):
        """functions { real f(real a, vector b) { ... return expr; } }

        Pure EXPRESSION functions: zero or more ``type name = expr;``
        local declarations followed by one ``return``; calls inline at
        compile time (macro expansion — the TPU-native lowering keeps
        one fused graph, no call nodes; locals become nested
        substitutions and XLA's CSE dedupes any reuse). Assignments
        after declaration, if/while control flow, and other statements
        are rejected with a clear error — a data-dependent while in a
        logp has no reverse-mode gradient under XLA, so it is excluded
        by design, not omission (docs/MIGRATION.md)."""
        self.expect("LBRACE")
        fns = []
        types = ("REAL", "INT", "VECTOR", "MATRIX")
        while self.peek()[0] != "RBRACE":
            ret = self.next()
            if ret[0] not in types:
                self.error(f"expected a return type, got {ret[1]!r}",
                           line=ret[2])
            name = self.expect("IDENT")
            self.expect("LPAREN")
            params = []
            if self.peek()[0] != "RPAREN":
                while True:
                    ptype = self.next()
                    if ptype[0] not in types:
                        self.error(
                            f"expected a parameter type, got {ptype[1]!r}",
                            line=ptype[2])
                    params.append(self.expect("IDENT")[1])
                    if self.peek()[0] == "COMMA":
                        self.next()
                        continue
                    break
            self.expect("RPAREN")
            self.expect("LBRACE")
            locals_ = []
            seen = set(params)
            while True:
                tok = self.next()
                if tok[0] == "RETURN":
                    break
                if tok[0] in types:
                    # optional size brackets: vector[N] tmp = ...;
                    # the initializer defines the shape under macro
                    # expansion, so sizes parse and drop
                    if self.peek()[0] == "LBRACKET":
                        self.next()
                        self._parse_size()
                        while self.peek()[0] == "COMMA":
                            self.next()
                            self._parse_size()
                        self.expect("RBRACKET")
                    lname = self.expect("IDENT")
                    if lname[1] in seen:
                        self.error(
                            f"duplicate local/parameter name {lname[1]!r}",
                            line=lname[2])
                    seen.add(lname[1])
                    self.expect("EQUALS")
                    lexpr = self.parse_expr()
                    self.expect("SEMI")
                    locals_.append((lname[1], lexpr))
                    continue
                self.error(
                    "function bodies are 'type name = expr;' locals "
                    "followed by a single 'return <expr>;' (assignment "
                    "after declaration and if/while statements are not "
                    "supported)", line=tok[2])
            body = self.parse_expr()
            self.expect("SEMI")
            end = self.next()
            if end[0] != "RBRACE":
                self.error(
                    "function bodies end at the single 'return <expr>;' "
                    "(multiple statements after return are not "
                    "supported)", line=end[2])
            fns.append({"name": name[1], "params": params,
                        "locals": locals_, "body": body,
                        "line": name[2]})
        self.expect("RBRACE")
        return fns

    def parse_assign_block(self):
        """transformed data/parameters: 'type[size] name = expr;' rows."""
        self.expect("LBRACE")
        rows = []
        while self.peek()[0] != "RBRACE":
            decl = self.parse_decl(assign=True)
            rows.append(decl)
        self.expect("RBRACE")
        return rows

    def parse_decl_block(self, allow_int=True):
        self.expect("LBRACE")
        decls = []
        while self.peek()[0] != "RBRACE":
            decls.append(self.parse_decl(allow_int=allow_int))
        self.expect("RBRACE")
        return decls

    def _parse_size(self):
        tok = self.next()
        if tok[0] == "NUMBER":
            return int(tok[1])
        if tok[0] == "IDENT":
            return tok[1]
        self.error("expected a size", line=tok[2])

    def parse_decl(self, assign=False, allow_int=True):
        kind, text, line = self.next()
        array_size = None
        is_int = False
        if kind == "IDENT" and text == "array":
            # modern Stan (2.26+) container syntax: array[N] int y;
            # 1-d arrays of scalars lower onto the vector path (the
            # same representation the legacy programs reach via
            # vector[N]; int-ness is a constraint Stan enforces on
            # DATA, which arrives as a concrete tensor here anyway)
            self.expect("LBRACKET")
            array_size = self._parse_size()
            if self.peek()[0] == "COMMA":
                self.error("only 1-d array[...] declarations are "
                           "supported", line=line)
            self.expect("RBRACKET")
            kind, text, line = self.next()
            if kind not in ("INT", "REAL"):
                self.error(
                    f"array element type must be int or real, got "
                    f"{text!r}", line=line)
            is_int = kind == "INT"
            kind, text = "VECTOR", "vector"
        is_int = is_int or kind == "INT"
        if is_int and not allow_int:
            self.error(
                "int is not a valid parameter type (Stan rejects "
                "integer parameters; HMC needs continuous support)",
                line=line)
        if kind not in ("REAL", "INT", "VECTOR", "SIMPLEX", "MATRIX",
                        "ORDERED", "POSITIVE_ORDERED",
                        "CHOLESKY_FACTOR_CORR", "SUM_TO_ZERO_VECTOR"):
            self.error(f"expected a type, got {text!r}", line=line)
        decl = {"type": text, "size": None, "size2": None, "lower": None,
                "upper": None, "offset": None, "multiplier": None,
                "line": line}
        # Stan puts constraints BEFORE the size bracket for container
        # types (vector<lower=0>[N]); the legacy after-bracket position
        # (vector[N]<lower=0>) is also accepted
        if self.peek()[0] == "LANGLE":
            self._parse_constraints(decl)
        if array_size is not None:
            decl["size"] = array_size
        elif kind in ("VECTOR", "SIMPLEX", "ORDERED", "POSITIVE_ORDERED",
                      "CHOLESKY_FACTOR_CORR", "SUM_TO_ZERO_VECTOR"):
            self.expect("LBRACKET")
            decl["size"] = self._parse_size()
            self.expect("RBRACKET")
        elif kind == "MATRIX":
            self.expect("LBRACKET")
            decl["size"] = self._parse_size()
            self.expect("COMMA")
            decl["size2"] = self._parse_size()
            self.expect("RBRACKET")
        if self.peek()[0] == "LANGLE":
            self._parse_constraints(decl)
        name = self.expect("IDENT")
        decl["name"] = name[1]
        if assign:
            self.expect("EQUALS")
            decl["expr"] = self.parse_expr()
        self.expect("SEMI")
        return decl

    def _parse_constraints(self, decl):
        self.expect("LANGLE")
        while True:
            bound_tok = self.next()
            if bound_tok[0] in ("LOWER", "UPPER"):
                key = bound_tok[1]
            elif (bound_tok[0] == "IDENT"
                  and bound_tok[1] in ("offset", "multiplier")):
                # offset/multiplier are contextual keywords (Stan
                # allows them as ordinary variable names elsewhere)
                key = bound_tok[1]
            else:
                self.error("expected lower/upper/offset/multiplier",
                           line=bound_tok[2])
            self.expect("EQUALS")
            neg = False
            if self.peek()[0] == "MINUS":
                self.next()
                neg = True
            val_tok = self.next()
            if val_tok[0] == "NUMBER":
                val = -float(val_tok[1]) if neg else float(val_tok[1])
            elif val_tok[0] == "IDENT" and not neg:
                # name-referencing value: for bounds a data scalar
                # (<lower=min_y>, resolved eagerly by the frontend);
                # for offset/multiplier also a PARAMETER (the Stan
                # manual's non-centering idiom), resolved to a node
                # reference at lowering time
                val = val_tok[1]
            else:
                self.error("expected a number or name", line=val_tok[2])
            decl[key] = val
            if self.peek()[0] == "COMMA":
                self.next()
                continue
            break
        self.expect("RANGLE")

    def parse_model_block(self):
        self.expect("LBRACE")
        stmts = []
        while self.peek()[0] != "RBRACE":
            stmts.append(self.parse_statement())
        self.expect("RBRACE")
        return stmts

    def parse_statement(self):
        kind, _, line = self.peek()
        if kind == "TARGET":
            self.next()
            self.expect("PLUSEQ")
            expr = self.parse_expr()
            self.expect("SEMI")
            return {"kind": "target", "expr": expr, "line": line}
        if kind == "FOR":
            return self.parse_for()
        return self.parse_sampling_stmt()

    def parse_for(self):
        _, _, line = self.expect("FOR")
        self.expect("LPAREN")
        var = self.expect("IDENT")[1]
        self.expect("IN")
        lo = self.parse_expr()
        self.expect("COLON")
        hi = self.parse_expr()
        self.expect("RPAREN")
        body = []
        if self.peek()[0] == "LBRACE":
            self.next()
            while self.peek()[0] != "RBRACE":
                body.append(self.parse_statement())
            self.expect("RBRACE")
        else:
            body.append(self.parse_statement())
        return {"kind": "for", "var": var, "lo": lo, "hi": hi, "body": body,
                "line": line}

    def parse_sampling_stmt(self):
        target_tok = self.expect("IDENT")
        target = target_tok[1]
        if self.peek()[0] == "LBRACKET":
            self.next()
            idx = self.parse_expr()
            self.expect("RBRACKET")
            target = ("index", target, idx)
        self.expect("TILDE")
        dist = self.expect("IDENT")
        self.expect("LPAREN")
        args = []
        if self.peek()[0] != "RPAREN":
            while True:
                args.append(self.parse_expr())
                if self.peek()[0] == "COMMA":
                    self.next()
                    continue
                break
        self.expect("RPAREN")
        self.expect("SEMI")
        return {
            "kind": "sampling",
            "target": target,
            "dist": dist[1],
            "args": args,
            "line": target_tok[2],
        }

    # -- expression grammar (EXTENSION beyond the reference, whose
    # frontend rejects arithmetic in dist args — stan.ex:31-36) --
    # expr   := term (('+'|'-') term)*
    # term   := factor (('*'|'/') factor)*
    # factor := NUMBER | IDENT | IDENT '(' [expr {',' expr}] ')'
    #           | '(' expr ')' | '-' factor
    # AST: number | str (variable) | ("binop", op, l, r)
    #      | ("call", fn, [args]) | ("neg", x)

    def parse_expr(self):
        left = self.parse_term()
        while self.peek()[0] in ("PLUS", "MINUS"):
            op = self.next()[0]
            right = self.parse_term()
            left = ("binop", "add" if op == "PLUS" else "sub", left, right)
        return self._fold(left)

    def parse_term(self):
        left = self.parse_factor()
        while self.peek()[0] in ("STAR", "SLASH"):
            op = self.next()[0]
            right = self.parse_factor()
            left = ("binop", "mul" if op == "STAR" else "div", left, right)
        return left

    def parse_factor(self):
        tok = self.next()
        if tok[0] == "NUMBER":
            return tok[1]
        if tok[0] == "MINUS":
            inner = self.parse_factor()
            if isinstance(inner, float):
                return -inner
            return ("neg", inner)
        if tok[0] == "IDENT":
            if self.peek()[0] == "LPAREN":
                self.next()
                if self.peek()[0] == "RPAREN":  # nullary call f()
                    self.next()
                    return ("call", tok[1], [])
                arg = self.parse_expr()
                if self.peek()[0] == "PIPE":
                    # <dist>_lpdf(value | args) density-increment call
                    self.next()
                    args = [self.parse_expr()]
                    while self.peek()[0] == "COMMA":
                        self.next()
                        args.append(self.parse_expr())
                    self.expect("RPAREN")
                    name = tok[1]
                    for suffix in ("_lpdf", "_lpmf"):
                        if name.endswith(suffix):
                            name = name[: -len(suffix)]
                            break
                    else:
                        self.error(
                            f"'|' is only valid inside _lpdf/_lpmf calls, "
                            f"got {tok[1]!r}", line=tok[2],
                        )
                    return ("lpdf", name, arg, args)
                call_args = [arg]
                while self.peek()[0] == "COMMA":
                    self.next()
                    call_args.append(self.parse_expr())
                self.expect("RPAREN")
                return ("call", tok[1], call_args)
            if self.peek()[0] == "LBRACKET":
                self.next()
                idx = self.parse_expr()
                self.expect("RBRACKET")
                return ("index", tok[1], idx)
            return tok[1]
        if tok[0] == "LPAREN":
            inner = self.parse_expr()
            self.expect("RPAREN")
            return inner
        self.error(f"expected an expression, got {tok[1]!r}", line=tok[2])

    @staticmethod
    def _fold(node):
        """Constant-fold pure-number subtrees."""
        if not isinstance(node, tuple):
            return node
        if node[0] == "binop":
            l, r = Parser._fold(node[2]), Parser._fold(node[3])
            if isinstance(l, float) and isinstance(r, float):
                import operator

                if node[1] == "div" and r == 0.0:
                    # don't fold: defer to runtime float semantics (inf)
                    return (node[0], node[1], l, r)
                ops = {"add": operator.add, "sub": operator.sub,
                       "mul": operator.mul, "div": operator.truediv}
                return ops[node[1]](l, r)
            return (node[0], node[1], l, r)
        if node[0] == "neg":
            x = Parser._fold(node[1])
            return -x if isinstance(x, float) else ("neg", x)
        if node[0] == "call":
            return (node[0], node[1], [Parser._fold(a) for a in node[2]])
        if node[0] == "index":
            return (node[0], node[1], Parser._fold(node[2]))
        if node[0] == "lpdf":
            return (node[0], node[1], Parser._fold(node[2]),
                    [Parser._fold(a) for a in node[3]])
        return node


def parse(code: str):
    tokens = tokenize(code)
    return Parser(tokens, code.split("\n")).parse_program()
