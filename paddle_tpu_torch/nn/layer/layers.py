"""nn.Layer base class (counterpart of paddle_tpu/nn/layer/layers.py):
parameter / buffer / sublayer registries, hooks, state_dict round-trip,
train / eval, to(), astype(), apply().

Parameters and buffers keep their torch storage for life where they can:
``set_state_dict`` copies into it (numpy arrays or Tensors), so an
optimizer or a captured CUDA graph that holds the storage sees the new
values.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterator

import numpy as np
import torch

from ...core.dispatch import to_torch
from ...core.dtype import convert_dtype
from ...core.place import current_torch_device
from ...core.tensor import Parameter, Tensor

__all__ = ["Layer"]


class HookRemoveHelper:
    def __init__(self, hooks, key):
        self._hooks = hooks
        self._key = key

    def remove(self):
        self._hooks.pop(self._key, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = convert_dtype(dtype)
        self._parameters: dict[str, Parameter] = collections.OrderedDict()
        self._buffers: dict[str, Tensor] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._sub_layers: dict[str, "Layer"] = collections.OrderedDict()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # ---- construction helpers ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from ..initializer import Constant, XavierNormal
        from ..initializer.attr import ParamAttr

        dtype = convert_dtype(dtype or self._dtype)
        init = default_initializer
        name = None
        learning_rate = 1.0
        trainable = True
        regularizer = None
        if isinstance(attr, ParamAttr):
            init = attr.initializer or init
            name = attr.name
            learning_rate = attr.learning_rate
            trainable = attr.trainable
            regularizer = attr.regularizer
        elif attr is False:
            return None
        if init is None:
            init = Constant(0.0) if is_bias else XavierNormal()
        data = init(shape, dtype)
        p = Parameter(data, name=name, trainable=trainable)
        p.optimize_attr = {"learning_rate": learning_rate}
        p.regularizer = regularizer
        p.is_bias = is_bias
        return p

    def create_tensor(self, name=None, persistable=False, dtype=None):
        t = Tensor(torch.zeros((), dtype=convert_dtype(
            dtype or self._dtype).torch_dtype, device=current_torch_device()),
            name=name)
        t.persistable = persistable
        return t

    def add_parameter(self, name, parameter):
        if parameter is None:
            self._parameters[name] = None
        else:
            self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # ---- attribute protocol ----
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning parameters")
            params[name] = value
            if buffers is not None:
                buffers.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning sublayers")
            layers[name] = value
        elif params is not None and name in params:
            params[name] = value
        elif layers is not None and name in layers:
            layers[name] = value
        elif buffers is not None and name in buffers:
            buffers[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        extra = []
        for store in ("_parameters", "_buffers", "_sub_layers"):
            extra += list(self.__dict__.get(store, ()))
        return list(super().__dir__()) + extra

    # ---- traversal ----
    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         include_self=True, remove_duplicate=True):
        seen = set()
        for layer_prefix, layer in self.named_sublayers(prefix=prefix, include_self=True):
            if not include_sublayers and layer is not self:
                continue
            for name, p in layer._parameters.items():
                if p is None or (remove_duplicate and id(p) in seen):
                    continue
                seen.add(id(p))
                yield (f"{layer_prefix}.{name}" if layer_prefix else name, p)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for layer_prefix, layer in self.named_sublayers(prefix=prefix, include_self=True):
            if not include_sublayers and layer is not self:
                continue
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{layer_prefix}.{name}" if layer_prefix else name, b)

    def children(self) -> Iterator["Layer"]:
        for _, l in self.named_children():
            yield l

    def named_children(self):
        seen = set()
        for name, l in self._sub_layers.items():
            if l is not None and id(l) not in seen:
                seen.add(id(l))
                yield name, l

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self or prefix == "":
            if id(self) not in layers_set:
                layers_set.add(id(self))
                yield prefix, self
        for name, l in self._sub_layers.items():
            if l is None or id(l) in layers_set:
                continue
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield from l.named_sublayers(prefix=sub_prefix, include_self=True,
                                         layers_set=layers_set)

    def apply(self, fn):
        for l in self.children():
            l.apply(fn)
        fn(self)
        return self

    # ---- mode ----
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    # ---- hooks ----
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # ---- call ----
    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, inputs, outputs)
            if result is not None:
                outputs = result
        return outputs

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, l in self._sub_layers.items():
            mod_str = repr(l)
            mod_str = "\n".join("  " + line for line in mod_str.split("\n"))
            lines.append(f"({name}): {mod_str.strip()}")
        main = self.__class__.__name__
        if not lines:
            return f"{main}({extra})"
        body = "\n".join("  " + l for l in lines)
        return f"{main}(\n{body}\n)"

    # ---- state ----
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None else collections.OrderedDict()
        for name, p in self.named_parameters(include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p
        for name, b in self.named_buffers(include_sublayers=include_sublayers):
            layer, _, leaf = name.rpartition(".")
            owner = self
            if layer:
                for part in layer.split("."):
                    owner = owner._sub_layers[part]
            if leaf in owner._non_persistable_buffer_names:
                continue
            dest[structured_name_prefix + name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        missing, unexpected = [], []
        own = self.state_dict()
        matched = set()
        for key, value in state_dict.items():
            if key not in own:
                unexpected.append(key)
                continue
            target = own[key]
            src = value._data if isinstance(value, Tensor) else \
                to_torch(np.asarray(value), target._data.device)
            if tuple(src.shape) != tuple(target._data.shape):
                raise ValueError(
                    f"shape mismatch for '{key}': loaded {tuple(src.shape)} "
                    f"vs expected {tuple(target._data.shape)}")
            with torch.no_grad():
                target._data.copy_(src)
            matched.add(key)
        missing = [k for k in own if k not in matched]
        return missing, unexpected

    load_dict = set_state_dict

    def to(self, device=None, dtype=None, blocking=None):
        from ...core import place as place_mod
        dev = None
        if device is not None:
            dev = place_mod._parse_device(device).torch_device()
        dt = convert_dtype(dtype) if dtype is not None else None
        for t in list(self.parameters()) + list(self.buffers()):
            arr = t._data
            if dt is not None and arr.is_floating_point():
                arr = arr.to(dt.torch_dtype)
            if dev is not None:
                arr = arr.to(dev)
            if arr is not t._data:
                t._rebind(arr)
        if dt is not None:
            self._dtype = dt
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def half(self):
        return self.to(dtype="float16")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def full_name(self):
        return self._name_scope
