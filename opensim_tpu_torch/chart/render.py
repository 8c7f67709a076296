"""Helm chart rendering — the port's copy of ``opensim_tpu/chart/render.py``;
parity with ``pkg/chart/chart.go`` (ProcessChart:
load chart dir/tarball, coalesce values, render templates, drop NOTES.txt,
sort by install order).

The environment ships no ``helm`` binary, so this implements the
Go-template/sprig subset real-world charts use: ``{{ .Values.path }}``,
``{{ .Release.* }}``/``{{ .Chart.* }}``, ``$`` root refs, variables
(``{{ $x := ... }}``), ``if/else``, ``range``, ``with``, named templates
(``define`` / ``include`` / ``template`` — collected globally across the
chart and its subcharts, helm's namespace), subchart rendering with value
coalescing (parent overrides + ``global`` + ``dependencies[].condition``
gating), and the common pipeline functions (``quote``, ``default``,
``toYaml``, ``nindent``/``indent``, ``printf``, ``eq``/``and``/``or``,
``trimPrefix``/``trimSuffix``, ``replace``, ``contains``, ``required``,
...). Constructs outside the subset fail loudly naming the template.
If a ``helm`` binary is on PATH it is preferred.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tarfile
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import yaml

# helm InstallOrder (helm.sh/helm/v3 pkg/releaseutil/kind_sorter.go)
INSTALL_ORDER = [
    "Namespace", "NetworkPolicy", "ResourceQuota", "LimitRange",
    "PodSecurityPolicy", "PodDisruptionBudget", "ServiceAccount", "Secret",
    "SecretList", "ConfigMap", "StorageClass", "PersistentVolume",
    "PersistentVolumeClaim", "CustomResourceDefinition", "ClusterRole",
    "ClusterRoleList", "ClusterRoleBinding", "ClusterRoleBindingList",
    "Role", "RoleList", "RoleBinding", "RoleBindingList", "Service",
    "DaemonSet", "Pod", "ReplicationController", "ReplicaSet", "Deployment",
    "HorizontalPodAutoscaler", "StatefulSet", "Job", "CronJob", "Ingress",
    "APIService",
]
_ORDER = {k: i for i, k in enumerate(INSTALL_ORDER)}


class ChartError(ValueError):
    pass


def process_chart(release_name: str, path: str) -> List[str]:
    """Render a chart directory or .tgz into a list of YAML manifests,
    sorted by helm install order (ProcessChart, pkg/chart/chart.go:18-41)."""
    tmpdir = None
    try:
        if os.path.isfile(path) and (path.endswith(".tgz") or path.endswith(".tar.gz")):
            tmpdir = tempfile.mkdtemp(prefix="simon-chart-")
            with tarfile.open(path) as tf:
                tf.extractall(tmpdir, filter="data")
            entries = [os.path.join(tmpdir, e) for e in os.listdir(tmpdir)]
            dirs = [e for e in entries if os.path.isdir(e)]
            path = dirs[0] if dirs else tmpdir
        if shutil.which("helm"):
            out = subprocess.run(
                ["helm", "template", release_name, path],
                capture_output=True, text=True, check=True,
            ).stdout
            docs = _split_docs(out)
        else:
            docs = _render_chart_dir(release_name, path)
        return _sort_manifests(docs)
    finally:
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)


def _split_docs(text: str) -> List[str]:
    return [d.strip() for d in re.split(r"(?m)^---\s*$", text) if d.strip()]


# ---------------------------------------------------------------------------
# chart tree loading (parent + subcharts, value coalescing)
# ---------------------------------------------------------------------------


class _Chart:
    def __init__(self, name: str, meta: dict, values: dict, tpl_dir: str):
        self.name = name
        self.meta = meta
        self.values = values
        self.tpl_dir = tpl_dir


def _deep_merge(base: dict, override: dict) -> dict:
    """helm's CoalesceValues: override wins; nested maps merge."""
    out = dict(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_chart(path: str) -> Tuple[dict, dict]:
    chart_yaml = os.path.join(path, "Chart.yaml")
    if not os.path.isfile(chart_yaml):
        raise ChartError(f"{path}: not a chart (no Chart.yaml)")
    with open(chart_yaml) as f:
        meta = yaml.safe_load(f) or {}
    values = {}
    values_path = os.path.join(path, "values.yaml")
    if os.path.isfile(values_path):
        with open(values_path) as f:
            values = yaml.safe_load(f) or {}
    return meta, values


def _gather_charts(
    path: str, values_override: Optional[dict], parent_globals: Optional[dict]
) -> List[_Chart]:
    """Load a chart and its charts/ subcharts with coalesced values:
    the parent's ``values[<subchart name>]`` overrides the subchart's own
    values.yaml; ``global`` flows down; ``dependencies[].condition`` paths
    evaluated against the PARENT's values gate each subchart (an absent
    condition path keeps the subchart enabled — helm semantics)."""
    meta, own_values = _load_chart(path)
    name = meta.get("name", os.path.basename(path))
    values = _deep_merge(own_values, values_override or {})
    if parent_globals:
        values["global"] = _deep_merge(values.get("global") or {}, parent_globals)
    _validate_values_schema(path, name, values)
    charts = [_Chart(name, meta, values, os.path.join(path, "templates"))]

    conditions: Dict[str, str] = {}
    for dep in meta.get("dependencies") or []:
        if isinstance(dep, dict) and dep.get("name") and dep.get("condition"):
            conditions[str(dep["name"])] = str(dep["condition"])

    charts_dir = os.path.join(path, "charts")
    if os.path.isdir(charts_dir):
        for entry in sorted(os.listdir(charts_dir)):
            sub_path = os.path.join(charts_dir, entry)
            if not os.path.isdir(sub_path) or not os.path.isfile(
                os.path.join(sub_path, "Chart.yaml")
            ):
                continue
            sub_meta, _ = _load_chart(sub_path)
            sub_name = sub_meta.get("name", entry)
            cond = conditions.get(sub_name)
            if cond is not None:
                flag = _lookup(values, cond)
                if flag is not None and not _truthy(flag):
                    continue
            charts.extend(
                _gather_charts(
                    sub_path,
                    values.get(sub_name) if isinstance(values.get(sub_name), dict) else {},
                    values.get("global") or {},
                )
            )
    return charts


def _render_chart_dir(release_name: str, path: str) -> List[str]:
    charts = _gather_charts(path, None, None)

    # pass 1: collect named templates (define blocks) from EVERY template
    # file of every chart — helm's template namespace is global, and
    # helpers conventionally live in _helpers.tpl (collected, not emitted)
    defs: Dict[str, list] = {}
    pending = []  # (chart, fname, tokens) for files that emit output
    for chart in charts:
        if not os.path.isdir(chart.tpl_dir):
            continue
        for root, _dirs, files in os.walk(chart.tpl_dir):
            for fname in sorted(files):
                if not fname.endswith((".yaml", ".yml", ".tpl", ".txt")):
                    continue
                with open(os.path.join(root, fname)) as f:
                    text = f.read()
                try:
                    tokens = _collect_defines(_tokenize(text), defs)
                except ChartError as e:
                    raise ChartError(f"{chart.name}/templates/{fname}: {e}") from None
                if fname == "NOTES.txt" or fname.startswith("_"):
                    continue  # define-collection only
                pending.append((chart, fname, tokens))

    docs: List[str] = []
    for chart, fname, tokens in pending:
        ctx = {
            "Values": chart.values,
            "Release": {"Name": release_name, "Namespace": "default", "Service": "Helm"},
            "Chart": {
                "Name": chart.meta.get("name", ""),
                "Version": chart.meta.get("version", ""),
                "AppVersion": chart.meta.get("appVersion", ""),
            },
            "Capabilities": {
                "KubeVersion": {"Version": "v1.21.0", "Major": "1", "Minor": "21"}
            },
        }
        ctx["__defs__"] = defs
        ctx["__root__"] = ctx  # what $ resolves to (rebound per include arg)
        ctx["__top__"] = ctx  # the file-level context (.Values etc. source)
        ctx["__vars__"] = _Vars()
        try:
            rendered, _ = _render_block(tokens, 0, ctx, stop=set())
        except ChartError as e:
            # fail the whole chart with the offending template named,
            # before any partial output escapes
            raise ChartError(
                f"{chart.name}/templates/{fname}: {e}; "
                "install a `helm` binary on PATH for full template support"
            ) from None
        except Exception as e:  # never a raw traceback without the template name
            raise ChartError(
                f"{chart.name}/templates/{fname}: {type(e).__name__}: {e}"
            ) from e
        docs.extend(_split_docs(rendered))
    return docs


def _validate_values_schema(path: str, chart_name: str, values: dict) -> None:
    """Schema-validate the coalesced values against ``values.schema.json``
    when the chart ships one — chartutil.ValidateAgainstSchema, invoked by
    the installability check the reference performs (pkg/chart/chart.go:18-41
    → action.Install's chartutil.ProcessDependencies/ValidateAgainstSchema).
    The helm-binary path needs none of this: helm validates itself."""
    schema_path = os.path.join(path, "values.schema.json")
    if not os.path.isfile(schema_path):
        return
    import json

    try:
        with open(schema_path) as f:
            schema = json.load(f)
    except ValueError as e:
        raise ChartError(f"{chart_name}: invalid values.schema.json: {e}") from None
    try:
        import jsonschema
        from jsonschema import validators
    except ImportError:
        # A chart that ships a schema MUST be validated against it — helm
        # would refuse to install on violation, so silently rendering here
        # would be a parity divergence. Fail loudly instead of warning.
        raise ChartError(
            f"{chart_name} ships values.schema.json but the `jsonschema` "
            "package is not installed; install it (or a `helm` binary on "
            "PATH) to render this chart"
        ) from None
    try:
        # honor the schema's declared draft like helm does; Draft7 default
        cls = validators.validator_for(schema, default=jsonschema.Draft7Validator)
        cls.check_schema(schema)
        errors = sorted(
            cls(schema).iter_errors(values),
            key=lambda e: list(e.absolute_path),
        )
    except jsonschema.SchemaError as e:
        raise ChartError(
            f"{chart_name}: invalid values.schema.json: {e.message}"
        ) from None
    if errors:
        # helm's wording: "values don't meet the specifications of the
        # schema(s) in the following chart(s):"
        detail = "; ".join(
            f"{'.'.join(str(p) for p in e.absolute_path) or '(root)'}: {e.message}"
            for e in errors[:5]
        )
        raise ChartError(
            f"{chart_name}: values don't meet the specifications of the "
            f"schema(s) in the following chart(s): {detail}"
        )


def _sort_manifests(docs: List[str]) -> List[str]:
    def order(doc: str) -> int:
        try:
            obj = yaml.safe_load(doc)
            return _ORDER.get((obj or {}).get("kind", ""), len(INSTALL_ORDER))
        except yaml.YAMLError:
            return len(INSTALL_ORDER)

    return sorted(docs, key=order)


# ---------------------------------------------------------------------------
# The Go-template subset renderer.
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.S)

_BLOCK_OPENERS = ("if", "range", "with", "define", "block")


def render_template(text: str, ctx: dict) -> str:
    """Render standalone template text (unit-test surface). Collects any
    define blocks in the text itself."""
    ctx = dict(ctx)
    defs = dict(ctx.get("__defs__") or {})
    ctx["__defs__"] = defs
    ctx.setdefault("__root__", ctx)
    ctx.setdefault("__top__", ctx)
    ctx.setdefault("__vars__", _Vars())
    tokens = _collect_defines(_tokenize(text), defs)
    out, _pos = _render_block(tokens, 0, ctx, stop={"end", "else"})
    return out


def _tokenize(text: str):
    """Split into literal / action tokens, applying {{- and -}} whitespace
    trimming to adjacent literals. Comments {{/* ... */}} drop."""
    tokens = []
    last = 0
    for m in _TOKEN.finditer(text):
        lit = text[last : m.start()]
        if m.group(1) == "-":
            lit = lit.rstrip()
        tokens.append(("lit", lit))
        action = m.group(2)
        if not (action.startswith("/*") and action.endswith("*/")):
            tokens.append(("act", action, m.group(3) == "-"))
        else:
            tokens.append(("act", "", m.group(3) == "-"))  # comment: no-op
        last = m.end()
    tokens.append(("lit", text[last:]))
    # apply right-trim to following literal
    for i, t in enumerate(tokens):
        if t[0] == "act" and t[2] and i + 1 < len(tokens) and tokens[i + 1][0] == "lit":
            tokens[i + 1] = ("lit", tokens[i + 1][1].lstrip())
    return tokens


def _first_word(action: str) -> str:
    parts = action.split()
    return parts[0] if parts else ""


def _collect_defines(tokens, defs: Dict[str, list]):
    """Strip {{ define "name" }}...{{ end }} blocks out of the token stream,
    registering their bodies in `defs` (helm's global template namespace).
    Returns the remaining tokens."""
    out = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok[0] == "act" and _first_word(tok[1]) == "define":
            m = re.match(r'define\s+"([^"]+)"', tok[1])
            if not m:
                raise ChartError(f"malformed define: {{{{ {tok[1]} }}}}")
            depth = 1
            j = i + 1
            while j < len(tokens) and depth:
                if tokens[j][0] == "act":
                    w = _first_word(tokens[j][1])
                    if w in _BLOCK_OPENERS:
                        depth += 1
                    elif w == "end":
                        depth -= 1
                j += 1
            if depth:
                raise ChartError(f'unterminated define "{m.group(1)}"')
            defs[m.group(1)] = tokens[i + 1 : j - 1]
            i = j
        else:
            out.append(tok)
            i += 1
    return out


class _Vars:
    """Lexically scoped template variables (Go template semantics):
    ``:=`` declares in the current block scope; ``=`` assigns the nearest
    enclosing declaration (the range-accumulator idiom) and fails loudly if
    none exists."""

    def __init__(self, parent: Optional["_Vars"] = None):
        self.map: Dict[str, Any] = {}
        self.parent = parent

    def get(self, name: str):
        scope = self
        while scope is not None:
            if name in scope.map:
                return scope.map[name]
            scope = scope.parent
        return None

    def has(self, name: str) -> bool:
        scope = self
        while scope is not None:
            if name in scope.map:
                return True
            scope = scope.parent
        return False

    def declare(self, name: str, val: Any) -> None:
        self.map[name] = val

    def assign(self, name: str, val: Any) -> None:
        scope = self
        while scope is not None:
            if name in scope.map:
                scope.map[name] = val
                return
            scope = scope.parent
        raise ChartError(f"assignment to undeclared variable ${name}")


def _child_scope(ctx: dict) -> dict:
    sub = dict(ctx)
    sub["__vars__"] = _Vars(ctx.get("__vars__"))
    return sub


def _scan_block(tokens, start) -> tuple:
    """Locate the matching {{ end }} (and top-level {{ else }}) for a block
    whose opener sits just before `start`, WITHOUT evaluating anything —
    falsy branches must never run their bodies' side effects (required,
    include of absent templates...). Returns (else_pos_or_None, end_pos)."""
    depth = 1
    else_pos = None
    i = start
    while i < len(tokens):
        if tokens[i][0] == "act":
            w = _first_word(tokens[i][1])
            if w in _BLOCK_OPENERS:
                depth += 1
            elif w == "end":
                depth -= 1
                if depth == 0:
                    return else_pos, i
            elif w == "else" and depth == 1 and else_pos is None:
                else_pos = i
        i += 1
    raise ChartError("unterminated block in template")


def _render_block(tokens, pos, ctx, stop) -> tuple:
    """Render until a stop action at this nesting level; returns (text, pos
    of the stop token or len)."""
    parts: List[str] = []
    i = pos
    while i < len(tokens):
        tok = tokens[i]
        if tok[0] == "lit":
            parts.append(tok[1])
            i += 1
            continue
        action = tok[1]
        if not action:  # stripped comment
            i += 1
            continue
        word = _first_word(action)
        if word in stop:
            return "".join(parts), i
        if word in ("define", "block"):
            # define is collected pre-render; block (define+emit in place)
            # stays outside the supported subset: fail loudly
            raise ChartError(f"unsupported template construct: {{{{ {word} }}}}")
        m_assign = re.match(r"\$(\w+)\s*(:?=)\s*(.+)$", action, re.S)
        if word == "if":
            else_pos, end_pos = _scan_block(tokens, i + 1)
            if _truthy(_eval_expr(action[2:].strip(), ctx)):
                body, _ = _render_block(
                    tokens, i + 1, _child_scope(ctx), stop={"else", "end"}
                )
                parts.append(body)
            elif else_pos is not None:
                else_action = tokens[else_pos][1][4:].strip()
                if else_action.startswith("if"):
                    # {{ else if X }}: re-enter as a fresh if-chain sharing
                    # the outer end token; the slice is bounded at end_pos so
                    # nothing after the block can leak into the chain render
                    chain = [("act", else_action, False)] + tokens[
                        else_pos + 1 : end_pos + 1
                    ]
                    else_body, _ = _render_block(chain, 0, ctx, stop={"end"})
                else:
                    else_body, _ = _render_block(
                        tokens, else_pos + 1, _child_scope(ctx), stop={"end"}
                    )
                parts.append(else_body)
            i = end_pos + 1
        elif word == "with":
            else_pos, end_pos = _scan_block(tokens, i + 1)
            if else_pos is not None and tokens[else_pos][1].strip() != "else":
                # Go rejects {{ else if }} after with/range at parse time
                raise ChartError(
                    f"unexpected {{{{ {tokens[else_pos][1]} }}}} in with block"
                )
            val = _eval_expr(action[len("with") :].strip(), ctx)
            if _truthy(val):
                sub = _child_scope(ctx)
                sub["."] = val
                # Go scoping: the with body's dot is the pivot value, so
                # .Values/.Release/... resolve against IT (same rule as
                # range bodies; the else branch keeps the outer dot)
                sub["__scoped_dot__"] = True
                body, _ = _render_block(tokens, i + 1, sub, stop={"else", "end"})
                parts.append(body)
            elif else_pos is not None:
                else_body, _ = _render_block(
                    tokens, else_pos + 1, _child_scope(ctx), stop={"end"}
                )
                parts.append(else_body)
            i = end_pos + 1
        elif word == "range":
            # {{ range .Values.list }} / {{ range $k, $v := .Values.map }}
            else_pos, end_pos = _scan_block(tokens, i + 1)
            if else_pos is not None and tokens[else_pos][1].strip() != "else":
                raise ChartError(
                    f"unexpected {{{{ {tokens[else_pos][1]} }}}} in range block"
                )
            expr = action[len("range") :].strip()
            var_names = []
            if ":=" in expr:
                names, expr = expr.split(":=", 1)
                var_names = [v.strip().lstrip("$") for v in names.split(",")]
                expr = expr.strip()
            coll = _eval_expr(expr, ctx)
            if isinstance(coll, dict):
                # Go templates range maps in key order; YAML permits
                # non-string keys, so compare stringified
                items = sorted(coll.items(), key=lambda kv: str(kv[0]))
            else:
                items = list(enumerate(coll or []))
            if not items and else_pos is not None:
                else_body, _ = _render_block(
                    tokens, else_pos + 1, _child_scope(ctx), stop={"end"}
                )
                parts.append(else_body)
            for k, v in items:
                sub = _child_scope(ctx)
                if var_names:
                    if len(var_names) == 2:
                        sub["__vars__"].declare(var_names[0], k)
                        sub["__vars__"].declare(var_names[1], v)
                    else:
                        sub["__vars__"].declare(var_names[0], v)
                sub["."] = v
                # Go scoping: inside the body the dot IS the item, so
                # .Values/.Release/... no longer reach the chart root
                # (_eval_atom enforces it; $.Values stays available)
                sub["__scoped_dot__"] = True
                body, _ = _render_block(tokens, i + 1, sub, stop={"else", "end"})
                parts.append(body)
            i = end_pos + 1
        elif word == "template":
            args = _split_args(action[len("template") :].strip())
            if not args:
                raise ChartError("template invocation needs a name")
            name = _eval_atom(args[0], ctx)
            arg = _eval_expr(" ".join(args[1:]), ctx) if len(args) > 1 else None
            parts.append(_call_template(str(name), arg, ctx))
            i += 1
        elif m_assign:
            name, op, rhs = m_assign.group(1), m_assign.group(2), m_assign.group(3)
            val = _eval_expr(rhs.strip(), ctx)
            scope = ctx.setdefault("__vars__", _Vars())
            if op == ":=":
                scope.declare(name, val)
            else:  # {{ $x = ... }} updates the enclosing declaration
                scope.assign(name, val)
            i += 1
        elif word == "end":
            return "".join(parts), i
        else:
            val = _eval_expr(action, ctx)
            parts.append("" if val is None else _to_str(val))
            i += 1
    return "".join(parts), i


def _call_template(name: str, arg: Any, ctx: dict):
    """include/template: render a named define with "." AND "$" bound to
    the invocation argument — Go template semantics: $ is documented as the
    starting value of dot for the template being executed, so a helper
    invoked with a non-root argument sees that argument through $, not the
    calling file's root. Caller variables do not leak in (Go scoping); the
    file-level keys (.Values, .Release, ...) stay reachable for the helm
    include idiom."""
    defs = ctx.get("__defs__") or {}
    if name not in defs:
        raise ChartError(f'include of undefined template "{name}"')
    top = ctx.get("__top__") or ctx
    sub = {k: v for k, v in top.items() if not k.startswith("__")}
    sub["__defs__"] = defs
    sub["__top__"] = top
    sub["__root__"] = arg
    sub["__vars__"] = _Vars()
    sub["."] = arg
    out, _ = _render_block(defs[name], 0, sub, stop=set())
    return out


def _truthy(v: Any) -> bool:
    return bool(v)


def _to_str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


# -- expression evaluation ---------------------------------------------------


def _split_top(s: str, sep_ws: bool) -> List[str]:
    """Split at top level: on whitespace (sep_ws) or on '|', respecting
    double quotes, backquotes and parentheses."""
    out: List[str] = []
    cur = []
    depth = 0
    quote = ""
    i = 0
    while i < len(s):
        c = s[i]
        if quote:
            cur.append(c)
            if c == quote and s[i - 1] != "\\":
                quote = ""
        elif c in ('"', "`"):
            quote = c
            cur.append(c)
        elif c == "(":
            depth += 1
            cur.append(c)
        elif c == ")":
            depth -= 1
            cur.append(c)
        elif depth == 0 and ((c.isspace() and sep_ws) or (c == "|" and not sep_ws)):
            if "".join(cur).strip():
                out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
        i += 1
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


def _split_args(s: str) -> List[str]:
    return _split_top(s, sep_ws=True)


def _eval_expr(expr: str, ctx: dict) -> Any:
    """Evaluate a pipeline: `func arg | func2 ...`."""
    stages = _split_top(expr, sep_ws=False)
    if not stages:
        return None
    val = _eval_atom(stages[0], ctx)
    for stage in stages[1:]:
        parts = _split_args(stage)
        fn, args = parts[0], [_eval_atom(a, ctx) for a in parts[1:]]
        val = _apply_fn(fn, args + [val], ctx)
    return val


_FUNCS = {
    "int", "quote", "squote", "default", "toString", "upper", "lower", "not",
    "toYaml", "trunc", "indent", "nindent", "printf", "print", "eq", "ne",
    "lt", "le", "gt", "ge", "and", "or", "trimSuffix", "trimPrefix", "trim",
    "replace", "contains", "hasPrefix", "hasSuffix", "required", "include",
    "len", "add", "sub", "mul", "title", "kindIs", "empty", "coalesce",
    "ternary", "join", "splitList", "first", "last", "get", "index", "dict",
    "list", "toJson", "b64enc", "b64dec", "sha256sum", "hasKey", "keys",
    "sortAlpha", "min", "max", "until", "repeat",
}


def _eval_atom(atom: str, ctx: dict) -> Any:
    atom = atom.strip()
    if atom.startswith("(") and atom.endswith(")"):
        return _eval_expr(atom[1:-1], ctx)
    if atom.startswith('"') and atom.endswith('"') and len(atom) >= 2:
        return atom[1:-1].replace('\\"', '"').replace("\\n", "\n").replace("\\t", "\t")
    if atom.startswith("`") and atom.endswith("`") and len(atom) >= 2:
        return atom[1:-1]
    parts = _split_args(atom)
    if len(parts) > 1:
        fn = parts[0]
        if fn in _FUNCS:
            args = [_eval_atom(a, ctx) for a in parts[1:]]
            return _apply_fn(fn, args, ctx)
        # a call to anything else would silently render as empty — refuse
        raise ChartError(f"unsupported template function: {fn}")
    if re.fullmatch(r"-?\d+", atom):
        return int(atom)
    if re.fullmatch(r"-?\d+\.\d+", atom):
        return float(atom)
    if atom in ("true", "false"):
        return atom == "true"
    if atom in ("nil", "null"):
        return None
    if atom == "$":
        return ctx.get("__root__", ctx)
    if atom.startswith("$."):
        return _lookup(ctx.get("__root__", ctx), atom[2:])
    if atom.startswith("$"):
        name = atom[1:].split(".")[0]
        vars_ = ctx.get("__vars__")
        if vars_ is None or not vars_.has(name):
            # Go fails template execution on an undefined variable; silently
            # rendering None would feed wrong manifests into the simulation
            raise ChartError(f"undefined variable ${name}")
        base = vars_.get(name)
        rest = atom[1 + len(name) :].lstrip(".")
        return _lookup(base, rest) if rest else base
    if atom == ".":
        return ctx.get(".", ctx)
    if atom.startswith("."):
        if _is_root_path(atom) and ctx.get("__scoped_dot__"):
            # helm/Go scoping: inside a {{ range }}/{{ with }} body the dot
            # is the item/pivot — .Values/.Release/... resolve against it,
            # not the chart root ($.Values reaches the root). Go errors on
            # a non-map dot; a map dot follows plain key lookup. Silently
            # resolving from the root rendered manifests helm refuses.
            dot = ctx.get(".", ctx)
            if isinstance(dot, dict):
                return _lookup(dot, atom[1:])
            raise ChartError(
                f"{atom} inside a range/with body resolves against the "
                f"rebound dot ({type(dot).__name__}), not the chart root — "
                f"use ${atom}"
            )
        base = ctx.get(".", ctx) if "." in ctx and not _is_root_path(atom) else ctx
        return _lookup(ctx if _is_root_path(atom) else base, atom[1:])
    return None


_ROOT_KEYS = ("Values", "Release", "Chart", "Capabilities", "Files")


def _is_root_path(atom: str) -> bool:
    return atom.split(".")[1] in _ROOT_KEYS if atom.count(".") >= 1 and len(atom.split(".")) > 1 else False


def _lookup(obj: Any, path: str) -> Any:
    cur = obj
    for part in path.split("."):
        if not part:
            continue
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            cur = getattr(cur, part, None)
        if cur is None:
            return None
    return cur


def _num(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def _num_strict(fn: str, v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        raise ChartError(f"non-numeric operand for {fn}: {v!r}") from None


def _apply_fn(fn: str, args: List[Any], ctx: Optional[dict] = None) -> Any:
    """Pipeline/function application. Piped values arrive as the LAST arg
    (sprig convention: `"x" | trimSuffix "-"` → trimSuffix("-", "x"))."""
    if fn == "int":
        try:
            return int(float(args[-1]))
        except (TypeError, ValueError):
            return 0
    if fn == "quote":
        v = "" if args[-1] is None else _to_str(args[-1])
        return '"%s"' % v.replace("\\", "\\\\").replace('"', '\\"')
    if fn == "squote":
        v = "" if args[-1] is None else _to_str(args[-1])
        return "'%s'" % v.replace("'", "''")
    if fn == "default":
        return args[-1] if args[-1] not in (None, "", 0, False, [], {}) else args[0]
    if fn == "toString":
        return _to_str(args[-1])
    if fn == "upper":
        return str(args[-1]).upper()
    if fn == "lower":
        return str(args[-1]).lower()
    if fn == "title":
        return str(args[-1]).title()
    if fn == "not":
        return not _truthy(args[-1])
    if fn == "toYaml":
        return yaml.safe_dump(args[-1], default_flow_style=False, sort_keys=False).rstrip()
    if fn == "toJson":
        import json

        return json.dumps(args[-1])
    if fn == "trunc":
        n = int(args[0])
        s = str(args[-1])
        return s[:n] if n >= 0 else s[n:]
    if fn == "indent":
        pad = " " * int(args[0])
        return pad + str(args[-1]).replace("\n", "\n" + pad)
    if fn == "nindent":
        pad = " " * int(args[0])
        return "\n" + pad + str(args[-1]).replace("\n", "\n" + pad)
    if fn == "print":
        return "".join(_to_str(a) for a in args)
    if fn == "printf":
        fmt = str(args[0])
        vals = iter(args[1:])
        out = []
        i = 0
        try:
            while i < len(fmt):
                c = fmt[i]
                if c != "%":
                    out.append(c)
                    i += 1
                    continue
                d = fmt[i + 1] if i + 1 < len(fmt) else ""
                if d == "%":
                    out.append("%")
                elif d in ("s", "v"):
                    out.append(_to_str(next(vals)))
                elif d == "q":
                    v = _to_str(next(vals))
                    out.append('"%s"' % v.replace("\\", "\\\\").replace('"', '\\"'))
                elif d == "d":
                    out.append(str(int(_num_strict("printf %d", next(vals)))))
                elif d == "f":
                    out.append("%f" % _num_strict("printf %f", next(vals)))
                else:
                    raise ChartError(f"printf: unsupported directive %{d}")
                i += 2
        except StopIteration:
            raise ChartError(f"printf {fmt!r}: not enough arguments") from None
        return "".join(out)
    if fn == "eq":
        return any(args[0] == b for b in args[1:])
    if fn == "ne":
        return args[0] != args[1]
    if fn == "lt":
        return _num_strict(fn, args[0]) < _num_strict(fn, args[1])
    if fn == "le":
        return _num_strict(fn, args[0]) <= _num_strict(fn, args[1])
    if fn == "gt":
        return _num_strict(fn, args[0]) > _num_strict(fn, args[1])
    if fn == "ge":
        return _num_strict(fn, args[0]) >= _num_strict(fn, args[1])
    if fn == "and":
        for a in args:
            if not _truthy(a):
                return a
        return args[-1]
    if fn == "or":
        for a in args:
            if _truthy(a):
                return a
        return args[-1]
    if fn == "trimSuffix":
        s, suf = str(args[-1]), str(args[0])
        return s[: -len(suf)] if suf and s.endswith(suf) else s
    if fn == "trimPrefix":
        s, pre = str(args[-1]), str(args[0])
        return s[len(pre) :] if pre and s.startswith(pre) else s
    if fn == "trim":
        return str(args[-1]).strip()
    if fn == "replace":
        return str(args[-1]).replace(str(args[0]), str(args[1]))
    if fn == "contains":
        return str(args[0]) in str(args[-1])
    if fn == "hasPrefix":
        return str(args[-1]).startswith(str(args[0]))
    if fn == "hasSuffix":
        return str(args[-1]).endswith(str(args[0]))
    if fn == "required":
        if args[-1] in (None, ""):
            raise ChartError(str(args[0]))
        return args[-1]
    if fn == "include":
        if ctx is None:
            raise ChartError("include outside a template context")
        return _call_template(str(args[0]), args[1] if len(args) > 1 else None, ctx)
    if fn == "len":
        try:
            return len(args[-1])
        except TypeError:
            return 0
    if fn == "add":
        return sum(int(_num(a)) for a in args)
    if fn == "sub":
        return int(_num(args[0])) - int(_num(args[1]))
    if fn == "mul":
        out = 1
        for a in args:
            out *= int(_num(a))
        return out
    if fn == "kindIs":
        kinds = {dict: "map", list: "slice", str: "string", bool: "bool", int: "int", float: "float64"}
        return kinds.get(type(args[-1])) == str(args[0])
    if fn == "empty":
        return not _truthy(args[-1])
    if fn == "coalesce":
        for a in args:
            if _truthy(a):
                return a
        return None
    if fn == "ternary":
        return args[0] if _truthy(args[-1]) else args[1]
    if fn == "join":
        return str(args[0]).join(_to_str(x) for x in (args[-1] or []))
    if fn == "splitList":
        return str(args[-1]).split(str(args[0]))
    if fn == "first":
        return (args[-1] or [None])[0]
    if fn == "last":
        return (args[-1] or [None])[-1]
    if fn in ("get", "index"):
        # direct call: container first (`index .Values.list 1`); piped:
        # container arrives LAST (`.Values.labels | get "app"`)
        if isinstance(args[0], (dict, list, tuple)):
            cur, keys = args[0], args[1:]
        else:
            cur, keys = args[-1], args[:-1]
        for key in keys:
            if isinstance(cur, dict):
                cur = cur.get(key)
            elif isinstance(cur, (list, tuple)):
                try:
                    cur = cur[int(key)]
                except (IndexError, ValueError, TypeError):
                    return None
            else:
                return None
        return cur
    if fn == "dict":
        return {str(args[i]): args[i + 1] for i in range(0, len(args) - 1, 2)}
    if fn == "list":
        return list(args)
    if fn == "b64enc":
        import base64

        v = "" if args[-1] is None else _to_str(args[-1])
        return base64.b64encode(v.encode()).decode()
    if fn == "b64dec":
        import base64

        try:
            return base64.b64decode(str(args[-1])).decode()
        except Exception as e:
            raise ChartError(f"b64dec: {e}") from None
    if fn == "sha256sum":
        import hashlib

        v = "" if args[-1] is None else _to_str(args[-1])
        return hashlib.sha256(v.encode()).hexdigest()
    if fn == "hasKey":
        if len(args) < 2:
            return False
        # direct form: hasKey DICT KEY; piped: DICT arrives last
        d, k = (args[0], args[1]) if isinstance(args[0], dict) else (args[-1], args[0])
        return isinstance(d, dict) and str(k) in d
    if fn == "keys":
        return list(args[-1]) if isinstance(args[-1], dict) else []
    if fn == "sortAlpha":
        return sorted(_to_str(x) for x in (args[-1] or []))
    if fn == "min":
        return min(int(_num(a)) for a in args)
    if fn == "max":
        return max(int(_num(a)) for a in args)
    if fn == "until":
        return list(range(int(_num(args[-1]))))
    if fn == "repeat":
        return str(args[-1]) * int(_num_strict("repeat", args[0]))
    raise ChartError(f"unsupported template function: {fn}")
