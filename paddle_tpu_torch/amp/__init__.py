"""AMP: auto_cast, decorate and GradScaler (counterpart of
paddle_tpu/amp/__init__.py).

O1 casts each op's float inputs by the white and black lists, inside the
dispatcher (``core/amp_state.py``); O2 casts the model to the low
precision with float32 master weights that the optimizer updates.  The
low-precision dtype defaults to bfloat16.

``GradScaler`` keeps its scale and its good / bad step counters on the
card: unscaling, the finite check, the skipped step (the optimizer masks
its update with the found-inf flag) and the scale schedule are all device
arithmetic, with no host branch, so the same code runs eager and inside a
captured CUDA graph.  ``amp.debugging`` is not ported yet (ROADMAP.md
Queue 1 item 13).
"""
from __future__ import annotations

import torch

from ..core import amp_state
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported", "white_list",
           "black_list"]


def white_list():
    return set(amp_state.WHITE_LIST)


def black_list():
    return set(amp_state.BLACK_LIST)


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True


class auto_cast:
    """Context manager enabling autocast (O1 / O2)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        self.enable = enable
        self.level = level
        self.dtype = convert_dtype(dtype).torch_dtype
        self._custom_white = set(custom_white_list or ())
        self._custom_black = set(custom_black_list or ())

    def __enter__(self):
        self._saved_white = set(amp_state.WHITE_LIST)
        self._saved_black = set(amp_state.BLACK_LIST)
        if self._custom_white:
            amp_state.WHITE_LIST.update(self._custom_white)
            amp_state.BLACK_LIST.difference_update(self._custom_white)
        if self._custom_black:
            amp_state.BLACK_LIST.update(self._custom_black)
            amp_state.WHITE_LIST.difference_update(self._custom_black)
        self._prev = amp_state.enter_autocast(self.enable, self.dtype,
                                              self.level)
        return self

    def __exit__(self, *exc):
        amp_state.restore(self._prev)
        amp_state.WHITE_LIST.clear()
        amp_state.WHITE_LIST.update(self._saved_white)
        amp_state.BLACK_LIST.clear()
        amp_state.BLACK_LIST.update(self._saved_black)
        return False


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="float16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast the model's float parameters to ``dtype`` (norm layers'
    stay float32) and give each a float32 master weight, which the
    optimizer updates."""
    if level not in ("O1", "O2"):
        raise ValueError("level must be O1 or O2")
    dt = convert_dtype(dtype).torch_dtype
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        from ..nn.layer.norm import LayerNorm, _BatchNormBase
        for m in model_list:
            for layer in m.sublayers(include_self=True):
                if isinstance(layer, (_BatchNormBase, LayerNorm)):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p._data.is_floating_point():
                        if getattr(p, "_master_weight", None) is None:
                            p._master_weight = p._data.detach().float() \
                                .clone()
                        p._rebind(p._data.to(dt))
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling, on the card."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._init_scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._state = None        # (scale f32, good i32, bad i32) tensors
        self._found_inf_t = None  # device bool, set by unscale_
        self._unscaled = False

    def _dev_state(self, device=None):
        if self._state is None:
            if device is None:
                from ..core.place import current_torch_device
                device = current_torch_device()
            self._state = (
                torch.full((), self._init_scale, dtype=torch.float32,
                           device=device),
                torch.zeros((), dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.int32, device=device))
        return self._state

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return Tensor(self._dev_state()[0].clone())

    def set_init_loss_scaling(self, v):
        self._init_scale = float(v)
        if self._state is not None:
            self._state[0].fill_(float(v))

    def scale(self, var):
        if not self._enable:
            return var
        scale = self._dev_state(var._data.device)[0]
        return var * Tensor(scale.to(var._data.dtype))

    def unscale_(self, optimizer):
        """Unscale every gradient in place and set the device found-inf
        flag (any non-finite value after unscaling)."""
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        grads = [p._data.grad for p in (optimizer._parameter_list or [])
                 if p._data.grad is not None]
        scale = self._dev_state(grads[0].device if grads else None)[0]
        with torch.no_grad():
            inv = 1.0 / scale
            bad = torch.zeros((), dtype=torch.int32, device=scale.device)
            for g in grads:
                arr = g.float() * inv
                bad = bad + torch.sum(~torch.isfinite(arr)).to(torch.int32)
                g.copy_(arr.to(g.dtype))
            self._found_inf_t = bad > 0

    def step(self, optimizer):
        """Unscale (unless the user has) and step, the update masked where
        the gradients were not finite.  Does not update() the scale."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        optimizer._skip_update_mask = self._found_inf_t
        try:
            optimizer.step()
        finally:
            optimizer._skip_update_mask = None

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    @property
    def _found_inf(self):
        t = self._found_inf_t
        return bool(t) if t is not None else False

    def update(self):
        """The scale schedule, branch-free on the card."""
        self._unscaled = False
        if not (self._enable and self._dynamic):
            self._found_inf_t = None
            return
        scale, good, bad = self._dev_state()
        found = self._found_inf_t
        if found is None:
            found = torch.zeros((), dtype=torch.bool, device=scale.device)
        with torch.no_grad():
            bad1 = torch.where(found, bad + 1, torch.zeros_like(bad))
            good1 = torch.where(found, torch.zeros_like(good), good + 1)
            decr = found & (bad1 >= self._decr_every_n)
            incr = ~found & (good1 >= self._incr_every_n)
            new_scale = torch.where(
                decr, torch.clamp(scale * self._decr_ratio, min=1.0),
                torch.where(incr, scale * self._incr_ratio, scale))
            scale.copy_(new_scale)
            bad.copy_(torch.where(decr, torch.zeros_like(bad1), bad1))
            good.copy_(torch.where(incr, torch.zeros_like(good1), good1))
        self._found_inf_t = None

    def state_dict(self):
        scale, good, bad = self._dev_state()
        return {"scale": float(scale), "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": int(good), "decr_count": int(bad)}

    def load_state_dict(self, state):
        scale, good, bad = self._dev_state()
        scale.fill_(float(state.get("scale", float(scale))))
        good.fill_(int(state.get("incr_count", 0)))
        bad.fill_(int(state.get("decr_count", 0)))
