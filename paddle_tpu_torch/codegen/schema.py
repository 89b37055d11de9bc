"""Op schema model + YAML loader (counterpart of
paddle_tpu/codegen/schema.py).

One entry per public operator:

- op: add
  module: paddle_tpu_torch.ops.generated.op_wrappers   # where it lives
  args: [x: Tensor, y: Tensor]       # ordered; Tensor / Tensor[] / Scalar /
                                     #   IntArray / DType / int / float /
                                     #   bool / str / list / any (+ "= default")
  returns: Tensor                    # Tensor | Tensor[] | tuple | none
  tensor_method: true                # bound as a Tensor method
  aliases: []                        # extra public names for the same impl
  inplace: add_                      # name of the inplace variant, if any
  differentiable: true               # has a gradient
  kernel: paddle_tpu_torch.ops.kernels:add   # kernel-driven ops only
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

SCHEMA_PATH = Path(__file__).resolve().parent.parent / "ops" / "ops.yaml"


_NO_DEFAULT = "__NO_DEFAULT__"


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    name: str
    type: str = "any"
    default: str = _NO_DEFAULT  # repr() of the default, if any

    @property
    def has_default(self):
        return self.default != _NO_DEFAULT

    def to_yaml(self):
        s = f"{self.name}: {self.type}"
        if self.has_default:
            s += f" = {self.default}"
        return s

    @classmethod
    def from_yaml(cls, s: str) -> "ArgSpec":
        head, _, default = s.partition("=")
        default = default.strip()
        name, _, typ = head.partition(":")
        kw = {"name": name.strip(), "type": (typ.strip() or "any")}
        if default:
            kw["default"] = default
        return cls(**kw)


@dataclasses.dataclass
class OpSpec:
    name: str
    module: str
    args: list[ArgSpec]
    returns: str = "Tensor"
    tensor_method: bool = False
    aliases: list[str] = dataclasses.field(default_factory=list)
    inplace: str | None = None
    differentiable: bool = True
    # kernel-driven ops: "module:function" of the torch kernel; the public
    # wrapper is GENERATED (op_wrappers.py)
    kernel: str | None = None
    backward: str | None = None
    # hand-written exemption: why this op does NOT ride the kernel path
    # (e.g. data-dependent output shape, host-side op, inplace alias)
    composite: str | None = None

    def resolve(self):
        """Import and return the implementing callable."""
        mod = importlib.import_module(self.module)
        return getattr(mod, self.name)

    def to_yaml_dict(self):
        d = {"op": self.name, "module": self.module,
             "args": [a.to_yaml() for a in self.args],
             "returns": self.returns}
        if self.tensor_method:
            d["tensor_method"] = True
        if self.aliases:
            d["aliases"] = list(self.aliases)
        if self.inplace:
            d["inplace"] = self.inplace
        if not self.differentiable:
            d["differentiable"] = False
        if self.kernel:
            d["kernel"] = self.kernel
        if self.backward:
            d["backward"] = self.backward
        if self.composite:
            d["composite"] = self.composite
        return d

    @classmethod
    def from_yaml_dict(cls, d: dict) -> "OpSpec":
        return cls(
            name=d["op"], module=d["module"],
            args=[ArgSpec.from_yaml(a) for a in d.get("args", [])],
            returns=d.get("returns", "Tensor"),
            tensor_method=bool(d.get("tensor_method", False)),
            aliases=list(d.get("aliases", [])),
            inplace=d.get("inplace"),
            differentiable=bool(d.get("differentiable", True)),
            kernel=d.get("kernel"),
            backward=d.get("backward"),
            composite=d.get("composite"),
        )


def load_schema(path: Path | None = None) -> list[OpSpec]:
    path = path or SCHEMA_PATH
    import yaml   # only the generator reads the yaml
    with open(path) as f:
        raw = yaml.safe_load(f)
    return [OpSpec.from_yaml_dict(d) for d in raw]


def dump_schema(specs: list[OpSpec], path: Path | None = None):
    path = path or SCHEMA_PATH
    specs = sorted(specs, key=lambda s: (s.module, s.name))

    # hand-rolled emitter: stable field order + one compact arg per line
    lines = ["# Operator schema — single source of truth for the op surface.",
             "# Regenerate derived code with: python -m paddle_tpu_torch.codegen",
             "# (format mirrors the JAX package's paddle_tpu/ops/ops.yaml, "
             "module and kernel paths rewritten to the port)",
             ""]
    for s in specs:
        lines.append(f"- op: {s.name}")
        lines.append(f"  module: {s.module}")
        if s.args:
            lines.append("  args:")
            for a in s.args:
                lines.append(f"    - \"{a.to_yaml()}\"")
        else:
            lines.append("  args: []")
        lines.append(f"  returns: {s.returns}")
        if s.tensor_method:
            lines.append("  tensor_method: true")
        if s.aliases:
            lines.append(f"  aliases: [{', '.join(s.aliases)}]")
        if s.inplace:
            lines.append(f"  inplace: {s.inplace}")
        if not s.differentiable:
            lines.append("  differentiable: false")
        if s.kernel:
            lines.append(f"  kernel: {s.kernel}")
        if s.backward:
            lines.append(f"  backward: {s.backward}")
        if s.composite:
            lines.append(f"  composite: {json.dumps(s.composite)}")
        lines.append("")
    path.write_text("\n".join(lines))
    return path
