"""Guarded arithmetic script scoring, compiled to dense array ops.

Semantics parity with searchlite-core `query/script.rs`: identifiers are
``_score``, param names, or numeric fast fields; operators ``+ - * /``
and unary negation; 512-char / 128-token caps; shunting-yard compile to
stack instructions. Division by zero or a missing field value drops the
document's score (parity: `script.rs:69-133` returning ``None``).

The evaluator here is DENSE: instructions run over whole ``[n_docs]``
arrays (numpy, or the torch namespace of ``ops/score.py``), with a
``present`` mask carrying the "dropped" state -- this is what lets
script scoring run on the device instead of per-hit host code.
"""

from __future__ import annotations

from dataclasses import dataclass

from searchlite_tpu_torch.errors import QueryError

MAX_SCRIPT_LENGTH = 512
MAX_SCRIPT_TOKENS = 128

_PRECEDENCE = {"+": 1, "-": 1, "*": 2, "/": 2, "neg": 3}


def _tokenize(script: str) -> list:
    tokens: list = []
    i, n = 0, len(script)
    while i < n:
        c = script[i]
        if c.isspace():
            i += 1
            continue
        if c.isdigit() or c == ".":
            j = i
            while j < n and (script[j].isdigit() or script[j] in ".eE" or
                             (script[j] in "+-" and j > i and
                              script[j - 1] in "eE")):
                j += 1
            try:
                tokens.append(("num", float(script[i:j])))
            except ValueError as e:
                raise QueryError(f"invalid number in script: {script[i:j]}") from e
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (script[j].isalnum() or script[j] in "._:"):
                j += 1
            tokens.append(("ident", script[i:j]))
            i = j
            continue
        if c in "+-*/":
            tokens.append(("op", c))
            i += 1
            continue
        if c == "(":
            tokens.append(("lparen", None))
            i += 1
            continue
        if c == ")":
            tokens.append(("rparen", None))
            i += 1
            continue
        raise QueryError(f"invalid character in script: `{c}`")
    return tokens


@dataclass
class CompiledScript:
    instructions: list            # ("const", v) | ("param", v) | ("field", name) | ("score",) | ops
    fields: list[str]

    def evaluate_dense(self, xp, base_score, columns: dict):
        """Evaluate over arrays.

        xp: numpy or the torch namespace; base_score: [n] array; columns: field ->
        (values [n], present [n]).  Returns (score [n], present [n]).
        """
        stack: list = []
        present = xp.ones_like(base_score, dtype=bool)
        for instr in self.instructions:
            op = instr[0]
            if op == "const":
                stack.append(xp.full_like(base_score, instr[1]))
            elif op == "param":
                stack.append(xp.full_like(base_score, instr[1]))
            elif op == "field":
                vals, has = columns[instr[1]]
                present = present & has
                stack.append(vals)
            elif op == "score":
                stack.append(base_score)
            elif op == "neg":
                stack.append(-stack.pop())
            else:
                b = stack.pop()
                a = stack.pop()
                if op == "+":
                    stack.append(a + b)
                elif op == "-":
                    stack.append(a - b)
                elif op == "*":
                    stack.append(a * b)
                else:
                    present = present & (b != 0)
                    stack.append(a / xp.where(b == 0, xp.ones_like(b), b))
        result = stack.pop()
        present = present & xp.isfinite(result)
        return result, present


def compile_script(script: str, params: dict | None, schema) -> CompiledScript:
    if not script.strip():
        raise QueryError("script_score script cannot be empty")
    if len(script) > MAX_SCRIPT_LENGTH:
        raise QueryError(
            f"script_score script length {len(script)} exceeds max "
            f"{MAX_SCRIPT_LENGTH}")
    tokens = _tokenize(script)
    if len(tokens) > MAX_SCRIPT_TOKENS:
        raise QueryError(
            f"script_score script is too large: {len(tokens)} tokens "
            f"(max {MAX_SCRIPT_TOKENS})")
    params = params or {}
    import math

    for name, value in params.items():
        if not math.isfinite(float(value)):
            raise QueryError(f"script_score param `{name}` must be finite")

    # shunting-yard with unary minus support
    output: list = []
    op_stack: list[str] = []
    fields: list[str] = []
    prev_kind = None
    for kind, value in tokens:
        if kind == "num":
            output.append(("const", value))
        elif kind == "ident":
            if value == "_score":
                output.append(("score",))
            elif value in params:
                output.append(("param", float(params[value])))
            else:
                meta = schema.field_meta(value)
                if meta is None or meta.kind != "numeric" or not meta.fast:
                    raise QueryError(
                        f"script_score field `{value}` must be a numeric "
                        "fast field")
                if value not in fields:
                    fields.append(value)
                output.append(("field", value))
        elif kind == "op":
            op = value
            if op == "-" and prev_kind in (None, "op", "lparen"):
                op = "neg"
            elif op == "+" and prev_kind in (None, "op", "lparen"):
                prev_kind = kind
                continue  # unary plus is a no-op
            while op_stack and op_stack[-1] != "(":
                top = op_stack[-1]
                if (_PRECEDENCE[top] > _PRECEDENCE[op]
                        or (_PRECEDENCE[top] == _PRECEDENCE[op]
                            and op != "neg")):
                    output.append((op_stack.pop(),))
                else:
                    break
            op_stack.append(op)
        elif kind == "lparen":
            op_stack.append("(")
        elif kind == "rparen":
            while op_stack and op_stack[-1] != "(":
                output.append((op_stack.pop(),))
            if not op_stack:
                raise QueryError("unbalanced parentheses in script")
            op_stack.pop()
        prev_kind = kind
    while op_stack:
        top = op_stack.pop()
        if top == "(":
            raise QueryError("unbalanced parentheses in script")
        output.append((top,))

    # validate stack discipline
    depth = 0
    for instr in output:
        if instr[0] in ("const", "param", "field", "score"):
            depth += 1
        elif instr[0] == "neg":
            if depth < 1:
                raise QueryError("invalid script expression")
        else:
            if depth < 2:
                raise QueryError("invalid script expression")
            depth -= 1
    if depth != 1:
        raise QueryError("invalid script expression")
    return CompiledScript(instructions=output, fields=fields)
