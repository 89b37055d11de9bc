"""Generators: ops.yaml -> op wrappers, registry, Tensor-method binding
and typing stub (counterpart of paddle_tpu/codegen/generate.py).

Only the ops the port defines are emitted (``ported``): a kernel-driven
op when ``ops/kernels.py`` defines its kernel, a hand-written op when the
port's module file defines it.  Both are read from the source with
``ast``, so generation imports nothing of the package.  The schema stays
whole: the other ops wait in ``ops.yaml`` for their port.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .schema import OpSpec, load_schema

PKG_DIR = Path(__file__).resolve().parent.parent
GENERATED_DIR = PKG_DIR / "ops" / "generated"
STUB_PATH = PKG_DIR / "Tensor.pyi"

_HEADER = '''\
"""AUTO-GENERATED by `python -m paddle_tpu_torch.codegen` — DO NOT EDIT.
Source of truth: paddle_tpu_torch/ops/ops.yaml
"""
'''


def _module_names(module: str) -> set[str] | None:
    """Top-level names a port module defines (def, class, assignment,
    import), or None when the module file does not exist."""
    rel = module.split(".")
    if rel[0] != PKG_DIR.name:
        return None
    path = PKG_DIR.joinpath(*rel[1:])
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    if not path.exists():
        return None
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def ported(specs: list[OpSpec]) -> list[OpSpec]:
    """The specs the port defines."""
    cache: dict[str, set | None] = {}

    def defines(module, name):
        if module not in cache:
            cache[module] = _module_names(module)
        names = cache[module]
        return names is not None and name in names

    out = []
    for s in specs:
        if s.kernel:
            mod, _, fn = s.kernel.partition(":")
            if defines(mod, fn):
                out.append(s)
        elif defines(s.module, s.name):
            out.append(s)
    return out


def gen_registry(specs: list[OpSpec]) -> str:
    lines = [_HEADER,
             "from paddle_tpu_torch.codegen.schema import OpSpec, ArgSpec",
             "", "",
             "def _build():",
             "    reg = {}"]
    for s in sorted(specs, key=lambda s: s.name):
        args = ", ".join(
            "ArgSpec(%r, %r%s)" % (
                a.name, a.type,
                (", default=%r" % a.default) if a.has_default else "")
            for a in s.args)
        extra = []
        if s.tensor_method:
            extra.append("tensor_method=True")
        if s.aliases:
            extra.append(f"aliases={s.aliases!r}")
        if s.inplace:
            extra.append(f"inplace={s.inplace!r}")
        if not s.differentiable:
            extra.append("differentiable=False")
        if s.kernel:
            extra.append(f"kernel={s.kernel!r}")
        extra_s = (", " + ", ".join(extra)) if extra else ""
        lines.append(
            f"    reg[{s.name!r}] = OpSpec({s.name!r}, {s.module!r}, "
            f"[{args}], returns={s.returns!r}{extra_s})")
    lines += ["    return reg", "", "", "OP_REGISTRY = _build()", ""]
    return "\n".join(lines)


def gen_tensor_methods(specs: list[OpSpec]) -> str:
    lines = [_HEADER,
             "",
             "def bind_tensor_methods(Tensor):",
             '    """Attach the schema-declared method surface onto Tensor."""']
    by_mod: dict[str, list[OpSpec]] = {}
    for s in specs:
        if s.tensor_method or s.aliases:
            by_mod.setdefault(s.module, []).append(s)
    for mod in sorted(by_mod):
        alias = mod.replace("paddle_tpu_torch.", "").replace(".", "_")
        lines.append(f"    import {mod} as {alias}")
        for s in sorted(by_mod[mod], key=lambda s: s.name):
            if s.tensor_method:
                lines.append(f"    Tensor.{s.name} = {alias}.{s.name}")
            for al in s.aliases:
                lines.append(f"    Tensor.{al} = {alias}.{s.name}")
    lines.append("")
    return "\n".join(lines)


_PY_TYPES = {
    "Tensor": "Tensor", "Tensor[]": "list[Tensor]", "DType": "Any",
    "IntArray": "int | list[int]",
    "int": "int", "float": "float", "bool": "bool", "str": "str",
    "list": "list", "int|list": "int | list[int]", "Place": "Any",
    "Scalar": "float", "any": "Any",
}


def gen_stub(specs: list[OpSpec]) -> str:
    lines = ["# AUTO-GENERATED by `python -m paddle_tpu_torch.codegen` — "
             "DO NOT EDIT.",
             "# Typing stub for the Tensor method surface the port has.",
             "from typing import Any",
             "",
             "class Tensor:",
             "    shape: list[int]",
             "    dtype: Any",
             "    ndim: int",
             "    stop_gradient: bool",
             "    grad: 'Tensor | None'",
             "    name: str"]
    for s in sorted(specs, key=lambda s: s.name):
        if not s.tensor_method:
            continue
        params = ["self"]
        for a in s.args[1:]:
            if a.name.startswith("*"):
                params.append(a.name)
                continue
            p = f"{a.name}: {_PY_TYPES.get(a.type, 'Any')}"
            if a.has_default:
                p += " = ..."
            params.append(p)
        ret = "Tensor" if s.returns.startswith("Tensor") else "Any"
        lines.append(f"    def {s.name}({', '.join(params)}) -> {ret}: ...")
    lines.append("")
    return "\n".join(lines)


def gen_wrappers(specs: list[OpSpec]) -> str:
    """Public wrappers for the kernel-driven ops: Tensor arguments go
    through the dispatcher, the others become the kernel's keywords."""
    lines = [_HEADER,
             "import numpy as _np",
             "",
             "from paddle_tpu_torch.core import dispatch as _D",
             "from paddle_tpu_torch.core.tensor import Tensor as _Tensor",
             "", "",
             "def _resolve(path):",
             "    import importlib",
             "    mod, _, fn = path.partition(':')",
             "    return getattr(importlib.import_module(mod), fn)",
             "", ""]
    names = []
    for s in sorted(specs, key=lambda s: s.name):
        if not s.kernel:
            continue
        names.append(s.name)
        sig_parts, tensor_args, attr_args = [], [], []
        list_arg = None
        for a in s.args:
            if a.name == "name":
                sig_parts.append("name=None")
                continue
            sig_parts.append(f"{a.name}={a.default}" if a.has_default
                             else a.name)
            if a.type == "Tensor[]":
                if list_arg is not None:
                    raise SystemExit(f"{s.name}: only one Tensor[] arg "
                                     "supported")
                list_arg = a.name
            elif a.type == "Tensor":
                tensor_args.append(a.name)
            else:
                attr_args.append(a.name)
        if list_arg is not None and tensor_args:
            raise SystemExit(f"{s.name}: Tensor[] cannot mix with scalar "
                             "Tensor args")
        sig = ", ".join(sig_parts)
        req = [a.name for a in s.args
               if a.type == "Tensor" and not a.has_default]
        opt = [a.name for a in s.args
               if a.type == "Tensor" and a.has_default]
        attrs_items = [f"{n!r}: _attr({n})" for n in attr_args
                       if n not in req and n not in opt]
        attrs_items += [f"'_has_{n}': {n} is not None" for n in opt]
        attrs = ", ".join(attrs_items)
        req_t = ", ".join(req) + ("," if len(req) == 1 else "")
        lines.append(f"_k_{s.name} = _resolve({s.kernel!r})")
        lines.append("")
        lines.append("")
        lines.append(f"def {s.name}({sig}):")
        lines.append(f'    """Generated from ops.yaml (kernel {s.kernel}).'
                     '"""')
        if list_arg is not None:
            lines.append(f"    return _D.apply({s.name!r}, _k_{s.name}, "
                         f"tuple({list_arg}), {{{attrs}}})")
        elif opt:
            opt_tuple = ", ".join(opt) + ("," if len(opt) == 1 else "")
            lines.append(f"    _t = ({req_t}) + tuple("
                         f"t for t in ({opt_tuple}) if t is not None)")
            lines.append(f"    return _D.apply({s.name!r}, _k_{s.name}, "
                         f"_t, {{{attrs}}})")
        else:
            lines.append(f"    return _D.apply({s.name!r}, _k_{s.name}, "
                         f"({req_t}), {{{attrs}}})")
        lines.append("")
        lines.append("")
    lines.append("def _attr(v):")
    lines.append("    # lists become tuples; Tensor-valued shape/axis attrs")
    lines.append("    # (legal in the reference API) are read back to host")
    lines.append("    if isinstance(v, (list, tuple)):")
    lines.append("        return tuple(_attr(e) for e in v)")
    lines.append("    if isinstance(v, (_Tensor, _np.ndarray)):")
    lines.append("        return _attr(v.tolist())")
    lines.append("    return v")
    lines.append("")
    lines.append("")
    lines.append(f"__all__ = {names!r}")
    lines.append("")
    return "\n".join(lines)


def targets(specs=None) -> dict:
    """Each generated file's path and the text the yaml gives it."""
    specs = ported(specs if specs is not None else load_schema())
    return {
        GENERATED_DIR / "__init__.py":
            _HEADER + "from .op_registry import OP_REGISTRY  # noqa: F401\n"
            "from .tensor_methods import bind_tensor_methods  # noqa: F401\n"
            "from . import op_wrappers  # noqa: F401\n",
        GENERATED_DIR / "op_registry.py": gen_registry(specs),
        GENERATED_DIR / "tensor_methods.py": gen_tensor_methods(specs),
        GENERATED_DIR / "op_wrappers.py": gen_wrappers(specs),
        STUB_PATH: gen_stub(specs),
    }


def generate_all(check=False):
    """Write the generated files; with check=True, verify the committed
    files match what the yaml would generate.  Returns the number of ops
    emitted."""
    tgt = targets()
    n = len(ported(load_schema()))
    if check:
        stale = [str(p) for p, text in tgt.items()
                 if not p.exists() or p.read_text() != text]
        if stale:
            raise SystemExit(
                f"generated files out of sync with ops.yaml: {stale} "
                "— run `python -m paddle_tpu_torch.codegen`")
        return n
    GENERATED_DIR.mkdir(exist_ok=True)
    for p, text in tgt.items():
        p.write_text(text)
    return n
