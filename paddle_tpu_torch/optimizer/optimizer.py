"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py):
accumulators, grad clip, regularization, per-parameter lr, LRScheduler,
AMP O2 master weights and the found-inf skip.

Each update is torch ops with the JAX package's algebra
(``optimizers.py``), run under ``no_grad`` and written back in place into
the parameters' and the slots' storage, so a captured CUDA graph that
holds that storage updates it every replay.  The learning rate, the step
count and the bias corrections are device scalars: eager ``step()``
writes the host values into them first (a fill, no host sync), while
under ``jit.capture_step`` the captured step writes them before each
replay and the graph reads them.  With AMP's found-inf flag set
(``GradScaler.step``) every update is masked on the card, with no host
branch.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from .lr import LRScheduler

__all__ = ["Optimizer"]

_HOST_STATE_MSG = (
    "{} computes host-side per-step state and cannot run under "
    "jit.capture_step; use Adam/AdamW/Adamax/Lamb/SGD/Momentum/ASGD or run "
    "eager")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        self._grad_clip = grad_clip
        if isinstance(weight_decay, (int, float)):
            self._coupled_wd = float(weight_decay)
        else:
            self._coupled_wd = 0.0
            self.regularization = weight_decay
        self._accumulators: dict[int, dict[str, torch.Tensor]] = {}
        self._global_step = 0
        self._scalars = None          # (lr, t) device tensors
        self._captured = False        # jit.capture_step fills the scalars
        self._zero_grads = False      # clear_grad zeroes in place
        self._skip_update_mask = None

    # ---- lr ----
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # ---- device scalars ----
    def _device(self):
        for p in self._parameter_list or []:
            return p._data.device
        return torch.device("cpu")

    def _device_scalars(self):
        """(lr, t): float32 device scalars; t is the step count of the
        update being made."""
        if self._scalars is None:
            dev = self._device()
            self._scalars = (torch.zeros((), dtype=torch.float32, device=dev),
                             torch.zeros((), dtype=torch.float32, device=dev))
        return self._scalars

    def _fill_scalars(self, t):
        lr, tt = self._device_scalars()
        lr.fill_(self.get_lr())
        tt.fill_(float(t))

    # ---- accumulators ----
    def _slot_names(self):
        """Names of per-param state slots, e.g. ('moment1','moment2')."""
        return ()

    def _init_slot(self, name, p):
        # accumulators stay float32 for low-precision params
        d = p._data
        if d.is_floating_point():
            return torch.zeros(d.shape, dtype=torch.float32, device=d.device)
        return torch.zeros_like(d)

    def _state_for(self, p):
        st = self._accumulators.get(id(p))
        if st is None:
            st = {name: self._init_slot(name, p)
                  for name in self._slot_names()}
            self._accumulators[id(p)] = st
        return st

    # ---- the update rule ----
    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        """(new_p, new_state) from torch tensors; lr is a device scalar."""
        raise NotImplementedError

    def _extra_args(self):
        """Host per-step scalars (NAdam, RAdam); None when the optimizer
        has device ones (``_extra_dynamic``) or none."""
        return None

    def _extra_dynamic(self, t):
        """Per-step scalars as functions of the device step count t."""
        return ()

    # ---- step ----
    def _collect_params_grads(self):
        return [(p, p.grad) for p in (self._parameter_list or [])
                if not p.stop_gradient]

    def step(self):
        params_grads = [(p, g) for p, g in self._collect_params_grads()
                        if g is not None]
        if not params_grads:
            self._global_step += 1
            return
        with torch.no_grad():
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            self._global_step += 1
            self._step_group(params_grads)

    def _step_group(self, params_grads):
        host_extra = self._extra_args()
        if host_extra is not None and self._captured:
            raise NotImplementedError(_HOST_STATE_MSG.format(
                type(self).__name__))
        if not self._captured:
            self._fill_scalars(self._global_step)
        lr, t = self._device_scalars()
        extra = host_extra if host_extra is not None else \
            self._extra_dynamic(t)
        mask = self._skip_update_mask
        slot_names = tuple(self._slot_names())
        for p, g in params_grads:
            master = getattr(p, "_master_weight", None)
            arr = master if master is not None else p._data
            gd = g._data
            l1 = self._l1_coeff_for(p)
            if l1:
                gd = gd + l1 * torch.sign(p._data).to(gd.dtype)
            st = self._state_for(p)
            new_p, new_st = self._update_arrays(
                arr, gd, dict(st), lr, self._param_lr(p),
                self._weight_decay_for(p), extra)
            if mask is not None:
                new_p = torch.where(mask, arr, new_p)
                new_st = {n: torch.where(mask, st[n], new_st[n])
                          for n in slot_names}
            arr.copy_(new_p)
            if master is not None:
                # AMP O2: the update ran on the f32 master; the working
                # copy is its low-precision cast
                p._data.copy_(new_p.to(p._data.dtype))
            for n in slot_names:
                st[n].copy_(new_st[n])

    @staticmethod
    def _param_lr(p):
        attr = getattr(p, "optimize_attr", None)
        return float(attr and attr.get("learning_rate", 1.0) or 1.0)

    def _regularizer(self, p):
        reg = getattr(p, "regularizer", None)
        return reg if reg is not None else getattr(self, "regularization",
                                                   None)

    def _weight_decay_for(self, p):
        reg = self._regularizer(p)
        if reg is not None:
            # L1 contributes sign(p) to the grad; only L2 is a decay
            return 0.0 if getattr(reg, "_l1", False) else float(reg._coeff)
        return self._coupled_wd

    def _l1_coeff_for(self, p):
        reg = self._regularizer(p)
        if reg is not None and getattr(reg, "_l1", False):
            return float(reg._coeff)
        return 0.0

    def clear_grad(self, set_to_zero=True):
        for p in (self._parameter_list or []):
            p.clear_grad(set_to_zero=self._zero_grads)

    clear_gradients = clear_grad

    def state_dict(self):
        out = {"global_step": self._global_step}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        for p in self._parameter_list or []:
            st = self._accumulators.get(id(p))
            if st:
                for name, v in st.items():
                    out[f"{p.name}_{name}"] = Tensor(v.clone())
        return out

    def set_state_dict(self, state_dict):
        """Load a state dict; slot values may be Tensors or numpy arrays
        (the JAX package's state dict carried across as numpy)."""
        self._global_step = int(state_dict.get("global_step", 0))
        if isinstance(self._learning_rate, LRScheduler) and \
                "LR_Scheduler" in state_dict:
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        from ..core.dispatch import to_torch
        for p in self._parameter_list or []:
            found = {n: state_dict[f"{p.name}_{n}"]
                     for n in self._slot_names()
                     if f"{p.name}_{n}" in state_dict}
            if not found:
                continue
            st = self._state_for(p)
            for n, v in found.items():
                src = v._data if isinstance(v, Tensor) else \
                    to_torch(v, st[n].device)
                st[n].copy_(src)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None
