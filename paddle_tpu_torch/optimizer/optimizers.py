"""Concrete optimizers (counterpart of paddle_tpu/optimizer/optimizers.py,
whole): SGD, Momentum, Adam, AdamW, Adagrad, Adadelta, Adamax, RMSProp,
Lamb, NAdam, RAdam, ASGD, Rprop, LBFGS.

Each update is the JAX package's algebra in torch ops, term for term
(Optimizer base writes the results back in place).  Bias corrections and
ring indices are functions of the device step count (``_extra_dynamic``);
NAdam's mu-product and RAdam's rectification branch are host state
(``_extra_args``), so those two run eager only.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Adadelta", "Adamax",
           "RMSProp", "Lamb", "NAdam", "RAdam", "ASGD", "Rprop", "LBFGS"]


def _zeros(p):
    return torch.zeros(p._data.shape, dtype=torch.float32,
                       device=p._data.device)


def _bias_corrections(t, *betas):
    """1 - beta ** t in f32 on the card, for the device step count t."""
    return tuple(1.0 - torch.pow(b, t) for b in betas)


def _wd_grad(p, g, wd):
    # L2Decay-style coupled decay: grad += wd * param
    if wd:
        g = g + wd * p.to(g.dtype)
    return g


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        g = _wd_grad(p, g.to(torch.float32), wd)
        new_p = p - (lr * param_lr) * g.to(p.dtype)
        return new_p.to(p.dtype), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _slot_names(self):
        return ("velocity",)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        mu = self._momentum
        g = _wd_grad(p, g.to(torch.float32), wd)
        v = mu * state["velocity"] + g
        if self._nesterov:
            upd = g + mu * v
        else:
            upd = v
        new_p = p - (lr * param_lr) * upd.to(p.dtype)
        return new_p.to(p.dtype), {"velocity": v}

    def _init_slot(self, name, p):
        return _zeros(p)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, use_multi_tensor=False,
                 amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._amsgrad = amsgrad

    def _slot_names(self):
        return ("moment1", "moment2") + (("moment2_max",) if self._amsgrad else ())

    def _init_slot(self, name, p):
        return _zeros(p)

    def _extra_dynamic(self, t):
        return _bias_corrections(t, self._beta1, self._beta2)

    def _decoupled(self):
        return False

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        bc1, bc2 = extra
        gf = g.to(torch.float32)
        pf = p.to(torch.float32)
        step_lr = lr * param_lr
        if wd and not self._decoupled():
            gf = gf + wd * pf
        m = b1 * state["moment1"] + (1 - b1) * gf
        v = b2 * state["moment2"] + (1 - b2) * gf * gf
        m_hat = m / bc1
        if self._amsgrad:
            v_max = torch.maximum(state.get("moment2_max", v), v)
            v_hat = v_max / bc2
        else:
            v_hat = v / bc2
        upd = m_hat / (torch.sqrt(v_hat) + eps)
        if wd and self._decoupled():
            pf = pf * (1.0 - step_lr * wd)
        new_p = pf - step_lr * upd
        new_state = {"moment1": m, "moment2": v}
        if self._amsgrad:
            new_state["moment2_max"] = v_max
        return new_p.to(p.dtype), new_state


class AdamW(Adam):
    """Decoupled weight decay (the reference optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, amsgrad=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._wd_value = float(weight_decay) if isinstance(weight_decay, (int, float)) \
            else float(getattr(weight_decay, "_coeff", 0.0))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled(self):
        return True

    def _weight_decay_for(self, p):
        if self._apply_decay_param_fun is not None and not self._apply_decay_param_fun(p.name):
            return 0.0
        return self._wd_value


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, initial_accumulator_value=0.0,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon = float(epsilon)
        self._init_val = float(initial_accumulator_value)

    def _slot_names(self):
        return ("moment",)

    def _init_slot(self, name, p):
        return torch.full(p._data.shape, self._init_val, dtype=torch.float32,
                          device=p._data.device)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        gf = _wd_grad(p, g.to(torch.float32), wd)
        mom = state["moment"] + gf * gf
        new_p = p.to(torch.float32) - (lr * param_lr) * gf / (torch.sqrt(mom) + self._epsilon)
        return new_p.to(p.dtype), {"moment": mom}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon = float(epsilon)
        self._rho = float(rho)

    def _slot_names(self):
        return ("avg_squared_grad", "avg_squared_update")

    def _init_slot(self, name, p):
        return _zeros(p)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        rho, eps = self._rho, self._epsilon
        gf = _wd_grad(p, g.to(torch.float32), wd)
        asg = rho * state["avg_squared_grad"] + (1 - rho) * gf * gf
        upd = gf * torch.sqrt(state["avg_squared_update"] + eps) / torch.sqrt(asg + eps)
        asu = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        new_p = p.to(torch.float32) - (lr * param_lr) * upd
        return new_p.to(p.dtype), {"avg_squared_grad": asg, "avg_squared_update": asu}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = float(beta1), float(beta2), float(epsilon)

    def _slot_names(self):
        return ("moment", "inf_norm")

    def _init_slot(self, name, p):
        return _zeros(p)

    def _extra_dynamic(self, t):
        return _bias_corrections(t, self._beta1)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        (bc1,) = extra
        gf = _wd_grad(p, g.to(torch.float32), wd)
        m = b1 * state["moment"] + (1 - b1) * gf
        inf = torch.maximum(b2 * state["inf_norm"], torch.abs(gf))
        new_p = p.to(torch.float32) - (lr * param_lr) / bc1 * m / (inf + eps)
        return new_p.to(p.dtype), {"moment": m, "inf_norm": inf}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum = float(momentum)
        self._centered = centered

    def _slot_names(self):
        return ("mean_square", "momentum") + (("mean_grad",) if self._centered else ())

    def _init_slot(self, name, p):
        return _zeros(p)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        rho, eps, mu = self._rho, self._epsilon, self._momentum
        gf = _wd_grad(p, g.to(torch.float32), wd)
        ms = rho * state["mean_square"] + (1 - rho) * gf * gf
        new_state = {"mean_square": ms}
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * gf
            denom = torch.sqrt(ms - mg * mg + eps)
            new_state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + eps)
        mom = mu * state["momentum"] + (lr * param_lr) * gf / denom
        new_state["momentum"] = mom
        new_p = p.to(torch.float32) - mom
        return new_p.to(p.dtype), new_state


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = float(beta1), float(beta2), float(epsilon)
        self._lamb_wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _slot_names(self):
        return ("moment1", "moment2")

    def _init_slot(self, name, p):
        return _zeros(p)

    def _extra_dynamic(self, t):
        return _bias_corrections(t, self._beta1, self._beta2)

    def _weight_decay_for(self, p):
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0
        return self._lamb_wd

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        bc1, bc2 = extra
        gf = g.to(torch.float32)
        pf = p.to(torch.float32)
        m = b1 * state["moment1"] + (1 - b1) * gf
        v = b2 * state["moment2"] + (1 - b2) * gf * gf
        r = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * pf
        w_norm = torch.sqrt(torch.sum(pf * pf))
        r_norm = torch.sqrt(torch.sum(r * r))
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        new_p = pf - (lr * param_lr) * ratio * r
        return new_p.to(p.dtype), {"moment1": m, "moment2": v}


class NAdam(Optimizer):
    """Nesterov-momentum Adam (reference python/paddle/optimizer/nadam.py).

    The mu products are scalars depending only on the step count, so they
    are carried as host floats and fed per step (`_extra_args`) instead of
    per-parameter state."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._psi = float(momentum_decay)
        self._mu_product = 1.0

    def _slot_names(self):
        return ("moment1", "moment2")

    def _init_slot(self, name, p):
        return _zeros(p)

    def _extra_args(self):
        t = self._global_step
        mu_t = self._beta1 * (1.0 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = self._beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        # running product is updated exactly once per step (extra args are
        # computed once per _step_group batch; guard with the step count)
        if getattr(self, "_mu_step", None) != t:
            self._mu_product *= mu_t
            self._mu_step = t
        mp_t = self._mu_product
        mp_t1 = mp_t * mu_t1
        return (mu_t, mu_t1, mp_t, mp_t1, 1.0 - self._beta2 ** t)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        b2, eps = self._beta2, self._epsilon
        mu_t, mu_t1, mp_t, mp_t1, bc2 = extra
        gf = _wd_grad(p, g.to(torch.float32), wd)
        m = self._beta1 * state["moment1"] + (1 - self._beta1) * gf
        v = b2 * state["moment2"] + (1 - b2) * gf * gf
        m_hat = mu_t1 * m / (1.0 - mp_t1) + (1.0 - mu_t) * gf / (1.0 - mp_t)
        v_hat = v / bc2
        new_p = p.to(torch.float32) - lr * param_lr * m_hat / (
            torch.sqrt(v_hat) + eps)
        return new_p.to(p.dtype), {"moment1": m, "moment2": v}

    # the running mu-product is host state the slot system does not carry;
    # without it a checkpoint resume would recompute wrong bias corrections
    def state_dict(self):
        out = super().state_dict()
        out["mu_product"] = self._mu_product
        return out

    def set_state_dict(self, state_dict):
        super().set_state_dict(state_dict)
        self._mu_product = float(state_dict.get("mu_product", 1.0))
        self._mu_step = self._global_step


class RAdam(Optimizer):
    """Rectified Adam (reference python/paddle/optimizer/radam.py): the
    variance rectification term switches on once rho_t > 4; before that the
    update is momentum-only."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _slot_names(self):
        return ("moment1", "moment2")

    def _init_slot(self, name, p):
        return _zeros(p)

    def _extra_args(self):
        t = self._global_step
        b2 = self._beta2
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** t
        rho_t = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
        if rho_t > 4.0:
            r = (((rho_t - 4.0) * (rho_t - 2.0) * rho_inf)
                 / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho_t)) ** 0.5
        else:
            r = 0.0
        return (1.0 - self._beta1 ** t, 1.0 - b2t, r,
                1.0 if rho_t > 4.0 else 0.0)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        bc1, bc2, r, rectified = extra
        gf = _wd_grad(p, g.to(torch.float32), wd)
        m = self._beta1 * state["moment1"] + (1 - self._beta1) * gf
        v = self._beta2 * state["moment2"] + (1 - self._beta2) * gf * gf
        m_hat = m / bc1
        v_hat = torch.sqrt(v / bc2) + self._epsilon
        upd = r * m_hat / v_hat if rectified > 0.5 else m_hat
        new_p = p.to(torch.float32) - lr * param_lr * upd
        return new_p.to(p.dtype), {"moment1": m, "moment2": v}


class ASGD(Optimizer):
    """Averaged SGD over the last `batch_num` gradients (reference
    python/paddle/optimizer/asgd.py: d <- d - ys[i] + g; ys[i] <- g;
    p <- p - lr/n * d, with ys an n-slot gradient ring)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = max(1, int(batch_num))

    def _slot_names(self):
        return ("d", "ys")

    def _init_slot(self, name, p):
        if name == "ys":
            return torch.zeros((self._batch_num,) + tuple(p._data.shape),
                               dtype=torch.float32, device=p._data.device)
        return _zeros(p)

    def _extra_dynamic(self, t):
        # ring index of the gradient being replaced this step
        return (((t.to(torch.int64) - 1) % self._batch_num).reshape(1),)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        (idx,) = extra
        gf = _wd_grad(p, g.to(torch.float32), wd)
        old = torch.index_select(state["ys"], 0, idx)[0]
        d = state["d"] - old + gf
        ys = torch.index_copy(state["ys"], 0, idx, gf[None])
        new_p = p.to(torch.float32) - lr * param_lr * d / self._batch_num
        return new_p.to(p.dtype), {"d": d, "ys": ys}


class Rprop(Optimizer):
    """Resilient backprop (reference python/paddle/optimizer/rprop.py):
    per-element step sizes grown on sign agreement, shrunk on disagreement
    (where the gradient is also zeroed), update = -sign(g) * step."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr0 = float(learning_rate)
        self._lr_min, self._lr_max = (float(v) for v in learning_rate_range)
        self._eta_minus, self._eta_plus = (float(v) for v in etas)

    def _slot_names(self):
        return ("prev_grad", "steps")

    def _init_slot(self, name, p):
        if name == "steps":
            return torch.full(p._data.shape, self._lr0, dtype=torch.float32,
                              device=p._data.device)
        return _zeros(p)

    def _update_arrays(self, p, g, state, lr, param_lr, wd, extra):
        gf = g.to(torch.float32)
        sign = gf * state["prev_grad"]
        steps = torch.where(
            sign > 0, torch.clamp(state["steps"] * self._eta_plus,
                                  max=self._lr_max),
            torch.where(sign < 0,
                        torch.clamp(state["steps"] * self._eta_minus,
                                    min=self._lr_min),
                        state["steps"]))
        gf = torch.where(sign < 0, 0.0, gf)
        new_p = p.to(torch.float32) - torch.sign(gf) * steps
        return new_p.to(p.dtype), {"prev_grad": gf, "steps": steps}


class LBFGS(Optimizer):
    """Limited-memory BFGS with closure re-evaluation (the JAX package's,
    host-driven).  Two-loop recursion over a
    `history_size` window; line search is Armijo backtracking when
    `line_search_fn='strong_wolfe'` is requested (a sufficient-decrease
    subset of strong Wolfe — documented deviation) else a fixed lr step.
    """

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = int(max_iter)
        self._tol_grad = float(tolerance_grad)
        self._tol_change = float(tolerance_change)
        self._history = int(history_size)
        self._line_search = line_search_fn
        self._s: list = []
        self._y: list = []

    def _flat_params(self):
        return torch.cat([p._data.detach().float().reshape(-1)
                          for p in self._parameter_list])

    def _set_flat(self, vec):
        off = 0
        with torch.no_grad():
            for p in self._parameter_list:
                n = p._data.numel()
                p._data.copy_(vec[off:off + n].reshape(p._data.shape))
                off += n

    def _flat_grad(self):
        return torch.cat([
            (torch.zeros(p._data.shape, dtype=torch.float32,
                         device=p._data.device)
             if p.grad is None else p.grad._data.float()).reshape(-1)
            for p in self._parameter_list])

    def _direction(self, grad):
        q = -grad
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure computing the "
                             "loss (reference lbfgs.py contract)")
        loss = closure()
        for _ in range(self._max_iter):
            grad = self._flat_grad()
            if float(torch.max(torch.abs(grad))) <= self._tol_grad:
                break
            d = self._direction(grad)
            x0 = self._flat_params()
            f0 = float(loss.numpy() if hasattr(loss, "numpy") else loss)
            t = self.get_lr()
            gtd = float(torch.dot(grad, d))
            accepted = False
            trials = 8 if self._line_search else 1
            for _ls in range(trials):
                self._set_flat(x0 + t * d)
                self.clear_grad()
                loss = closure()
                f1 = float(loss.numpy() if hasattr(loss, "numpy") else loss)
                if not self._line_search or f1 <= f0 + 1e-4 * t * gtd:
                    accepted = True
                    break
                t *= 0.5
            if not accepted:
                self._set_flat(x0)
                self.clear_grad()
                loss = closure()
                break
            g1 = self._flat_grad()
            s = self._flat_params() - x0
            y = g1 - grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
            if float(torch.max(torch.abs(s))) <= self._tol_change:
                break
        self._global_step += 1
        return loss
